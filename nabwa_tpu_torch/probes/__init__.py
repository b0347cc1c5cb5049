"""Ports of the Pallas micro-benchmarks under `scripts/`, one module per
script, each probe a plain PyTorch version beside its hand-written CUDA
kernel, with the script's entry point:

  probe_pallas     probe 1 `probe_rowload` (kernel C7, csrc/probe_rowload.cu)
                   and probe 5 `probe_dfs_shape` (C10,
                   csrc/probe_dfs_shape.cu), after scripts/probe_pallas.py
  probe_dma        `make`/`main` (C8, csrc/probe_dma.cu), after
                   scripts/probe_dma.py
  probe_dfs_shape  `run` (C9, csrc/probe_dfs_shape.cu), after
                   scripts/probe_dfs_shape.py

The public functions take the JAX scripts' layouts (int32 arrays); a CPU
tensor runs the plain version, a CUDA tensor the kernel.  The entry points
take `--device cuda|cpu` (default cuda) and print the scripts' result
lines, timed with CUDA events on the card.  The scripts' other probes are
not ported yet.
"""

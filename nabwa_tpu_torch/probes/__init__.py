"""Ports of the Pallas micro-benchmarks under `scripts/`, one module per
script, each probe a plain PyTorch version beside its hand-written CUDA
kernel, with the script's entry point:

  probe_pallas     probe 1 `probe_rowload` (kernel C7, csrc/probe_rowload.cu),
                   probes 2 `probe_smem_idx` (C15), 3 `probe_popcount`
                   (C16), 4 `probe_while_scratch` (C17), 4b
                   `probe_while_vector_only` (C18) and 4c
                   `probe_body_scale` (C19), all five in
                   csrc/probe_pallas.cu, and probe 5 `probe_dfs_shape`
                   (C10, csrc/probe_dfs_shape.cu), after
                   scripts/probe_pallas.py
  probe_dma        `make`/`main` (C8, csrc/probe_dma.cu), after
                   scripts/probe_dma.py
  probe_dfs_shape  `run` (C9, csrc/probe_dfs_shape.cu), after
                   scripts/probe_dfs_shape.py
  probe_pallas2    probe A `probe_empty` (C11), B `probe_loads` (C12), C
                   `probe_lane_gather` (C20), D `probe_scalar_push` (C21),
                   E `probe_lanereduce` (C14) and F `probe_pop` (C13), all
                   in csrc/probe_pallas2.cu, after scripts/probe_pallas2.py
  probe_sem        `kernel` (C22, csrc/probe_sem.cu: bulk async copies on
                   mbarriers for the DMA semaphore), K from the
                   environment, after scripts/probe_sem.py
  probe_spill      `make` (C23, csrc/probe_spill.cu: K live values a
                   thread, K a template parameter past the register
                   cap), K and T from the environment, after
                   scripts/probe_spill.py
  probe_colops     `make` (C24, csrc/probe_colops.cu: a chain of T K
                   dependent steps a thread), T and K from the
                   environment, after scripts/probe_colops.py
  probe_pallas3    `p1` and `p1b` (C27, C28, scalar-indexed row
                   copies), `p2` (C31 `native`, C32 `roll`, C33 `subl`:
                   50 rounds of a row or column minimum), `p3` (C29, a
                   gather along the rows), `p4` (C30, a relayout), `p5`
                   (C34, a loop whose trip count hangs on the data), `p6`
                   (C35, a lane sum as a float32 matrix product), `p7`
                   (C25, 200 chained steps) and `p8` (C26, 30 steps
                   against a per-row scalar), all in csrc/probe_pallas3.cu,
                   after scripts/probe_pallas3.py

The public functions take the JAX scripts' layouts (int32 arrays); a CPU
tensor runs the plain version, a CUDA tensor the kernel.  The entry points
take `--device cuda|cpu` (default cuda) and print the scripts' result
lines, timed with CUDA events on the card.  Every probe of the scripts is
ported.
"""

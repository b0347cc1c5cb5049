"""nabwa_tpu_torch — the `bwa aln` and `bwa samse` paths of nabwa_tpu on
PyTorch and hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

The JAX package `nabwa_tpu` stays the reference: every function here is
held against its counterpart there, bit for bit.  The host modules that
never touch JAX (index build and load, FASTQ/.sai I/O, options, the native
C++ engine and samse's host steps) are reused from `nabwa_tpu` by import,
through `host.py`, not copied.

Layout:
  index/    DeviceIndex: the FM-index banks as flat int32 tensors on an
            explicit torch.device
  ops/      occ/cal_width, the gapped DFS, the SA lookup and the banded
            global DP: a plain PyTorch version of each (CPU tensors,
            tests) beside its CUDA kernel (CUDA tensors)
  csrc/     the CUDA sources, built with nvcc for sm_90a at first use
  models/   AlnEngine (tiers, host padding, native drain) and the samse
            workflow
  cli.py    the `aln` and `samse` subcommands

This package imports torch and never jax.
"""

__version__ = "0.1.0"

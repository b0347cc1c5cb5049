"""nabwa_tpu_torch — the `bwa aln`, `bwa samse` and `bwa sampe` paths of
nabwa_tpu on PyTorch and hand-written CUDA kernels for an NVIDIA H100
(sm_90a).

The JAX package `nabwa_tpu` stays the reference: every function here is
held against its counterpart there, bit for bit.  The port imports nothing
of it.  The host modules it needs are copied, laid out as in the JAX
package, each naming the file it was copied from; only the C++ sources
under the repository's `native/` are shared, built by `index/native.py`
into `nabwa_tpu_torch/build/`.

Layout:
  constants.py, options.py, utils/   constants, GapOpt/PeOpt, drand48
  index/    index build and load (native, pack, sa, formats, build),
            BwaIndex and DeviceIndex (the FM-index banks as flat int32
            tensors on an explicit torch.device)
  io/       FASTQ input and the .sai readers and writer
  refmodel/ the stdaln parameters and path helpers, cal_maxdiff
  ops/      occ/cal_width, the gapped DFS, the SA lookup, the banded global
            DP and the local-SW forward lattice: a plain PyTorch version of
            each (CPU tensors, tests) beside its CUDA kernel (CUDA tensors)
  csrc/     the CUDA sources, built with nvcc for sm_90a at first use
  models/   AlnEngine (tiers, host padding, native drain), the samse and
            sampe workflows and their native host steps (post_native)
  cli.py    the `aln`, `samse` and `sampe` subcommands

This package imports torch and never jax.
"""

__version__ = "0.1.0"

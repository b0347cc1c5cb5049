"""nabwa_tpu_torch — nabwa_tpu (every command, colour space included) on
PyTorch and hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

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
  io/       FASTQ and BAM input, the .sai readers and writer, BGZF out
  refmodel/ the stdaln parameters, scalar DPs and path helpers,
            cal_maxdiff, the colour-space decode cs2nt (scalar and
            columnar)
  ops/      occ/cal_width, the gapped DFS, the SA lookup, the banded global
            DP and the local-SW forward lattice: a plain PyTorch version of
            each (CPU tensors, tests) beside its CUDA kernel (CUDA tensors)
  csrc/     the CUDA sources, built with nvcc for sm_90a at first use
  models/   AlnEngine (tiers, host padding, native drain, the hybrid
            host/card split), the samse, sampe, bwasw and bam2bam
            workflows and their native host steps (post_native), stdsw
  parallel/ the chunk scheduler of bam2bam's worker threads, its remote
            workers over TCP (net: Coordinator, worker_main), the
            data-parallel mesh (make_mesh, shard_batch, replicate,
            isize_histogram)
  probes/   ports of the Pallas micro-benchmarks under scripts/ (the row
            gather, the async row fetch, the two DFS-iteration mocks),
            each a plain version beside its CUDA kernel, with the
            scripts' entry points
  cli.py    the subcommands of nabwa_tpu/cli.py
  scripts.py  the xa2multi, qualfa2fq and solid2fastq converters
  entry.py  the single-device step and the data-parallel dry run

This package imports torch and never jax.
"""

__version__ = "0.1.0"

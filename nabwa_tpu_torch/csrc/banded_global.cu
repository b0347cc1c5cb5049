// Kernel C4: batched banded global alignment (aln_global_core,
// stdaln.c:345-525): score, end type and the uint8 traceback lattice of
// samse's gapped refinement (bwa_refine_gapped, bwase.c:356-423).  The
// backtrace walks the lattice on the host.
//
// Replaces nabwa_tpu/ops/dp.py:31 `_banded_global_device`, a jnp lax.scan
// over rows with a cummax for the D chain.
//
// What bounds it on the card: each pair is a chain of L2 dependent rows of
// L1+1 cells, ~40 integer operations a cell, plus one byte of lattice a
// cell written to device memory; the lattice, (L2+1)(L1+1) bytes a pair,
// is what leaves the card.  At samse's shapes (L1 ~ 110, L2 ~ 100) a batch
// of thousands of pairs is a few tens of MB of lattice.
//
// First design: one thread per pair walking its rows left to right in
// one sweep (the D chain is a running max), blocks of 128 threads.  The
// row state (M, I, D) lives in device scratch laid out [3][L1+1][B], so a
// warp's state reads and writes are coalesced; the lattice bytes of a
// thread are contiguous but a warp's are not.

#include <cuda_runtime.h>

#include "dp_global.cuh"

namespace {

__global__ void banded_global_kernel(
    nabwa::DpParams p, const int32_t* __restrict__ s1,
    const int32_t* __restrict__ s2, const int32_t* __restrict__ len1,
    const int32_t* __restrict__ len2, const int32_t* __restrict__ b1,
    const int32_t* __restrict__ b2, int B, int L1, int L2,
    int32_t* __restrict__ scratch, uint8_t* __restrict__ tb,
    int32_t* __restrict__ score, int32_t* __restrict__ ctype) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const size_t plane = ((size_t)L1 + 1) * B;
    nabwa::DpPair q;
    q.s1 = s1 + (size_t)b * (L1 + 1);
    q.s2 = s2 + (size_t)b * (L2 + 1);
    q.len1 = len1[b];
    q.len2 = len2[b];
    q.b1 = b1[b];
    q.b2 = b2[b];
    q.M = scratch + b;
    q.I = scratch + plane + b;
    q.D = scratch + 2 * plane + b;
    q.stride = (size_t)B;
    q.tb = tb + (size_t)b * (L2 + 1) * (L1 + 1);
    nabwa::banded_global_pair(p, L1, L2, q, score + b, ctype + b);
}

}  // namespace

// params: go, ge, gap_end, mat[25] (int32).  s1: int32 [B, L1+1], s2:
// int32 [B, L2+1], len1/len2/b1/b2: int32 [B], scratch: int32
// [3, L1+1, B], tb: uint8 [B, L2+1, L1+1], score/ctype: int32 [B].
// Returns cudaGetLastError().
extern "C" int nabwa_banded_global(const int32_t* params, const void* s1,
                                   const void* s2, const void* len1,
                                   const void* len2, const void* b1,
                                   const void* b2, int B, int L1, int L2,
                                   void* scratch, void* tb, void* score,
                                   void* ctype, void* stream) {
    const nabwa::DpParams p = nabwa::dp_params(params);
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    banded_global_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        p, (const int32_t*)s1, (const int32_t*)s2, (const int32_t*)len1,
        (const int32_t*)len2, (const int32_t*)b1, (const int32_t*)b2, B, L1,
        L2, (int32_t*)scratch, (uint8_t*)tb, (int32_t*)score,
        (int32_t*)ctype);
    return (int)cudaGetLastError();
}

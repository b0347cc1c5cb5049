// Kernel C5: batched forward pass of the local Smith-Waterman alignment
// (aln_local_core, stdaln.c:556-637): the best score and its end cell for
// each (reference window, read) job of sampe's mate rescue
// (bwa_paired_sw1, bwape.c:519-633).  The host runs the short banded
// reverse pass and recovers the path through kernel C4.
//
// Replaces nabwa_tpu/ops/dp.py:404 `_local_fwd_device`, a jnp lax.scan
// over rows with a cummax for the F chain.
//
// What bounds it on the card: each job is a chain of len2 dependent rows
// of len1 cells, 23 integer operations a cell (local_sw.cuh's inner loop,
// loads and stores not counted); the inputs are a few hundred bytes a job
// and the outputs 12 bytes, so the work is integer operations, not bytes.  At rescue shapes (windows of ~6 std + 2 read
// lengths, ~380 bp, against 100 bp reads) a job is ~38,000 cells.
//
// First design: one thread per job walking its rows left to right in one
// sweep (the F chain is a running max), blocks of 128 threads.  The row
// state (h, e) lives in device scratch laid out [2][L1+1][B], so a warp's
// state reads and writes are coalesced; each thread reads its own window
// and read, so those reads are not.  A warp per job over anti-diagonals or
// a striped layout is later work.

#include <cuda_runtime.h>

#include "local_sw.cuh"

namespace {

__global__ void local_fwd_kernel(
    nabwa::LocalParams p, const int32_t* __restrict__ s1,
    const int32_t* __restrict__ s2, const int32_t* __restrict__ len1,
    const int32_t* __restrict__ len2, int B, int L1, int L2,
    int32_t* __restrict__ scratch, int32_t* __restrict__ score,
    int32_t* __restrict__ end_i, int32_t* __restrict__ end_j) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const size_t plane = ((size_t)L1 + 1) * B;
    int l1 = len1[b], l2 = len2[b];
    l1 = l1 < 0 ? 0 : (l1 > L1 ? L1 : l1);
    l2 = l2 < 0 ? 0 : (l2 > L2 ? L2 : l2);
    nabwa::local_fwd_pair(p, s1 + (size_t)b * (L1 + 1), l1,
                          s2 + (size_t)b * (L2 + 1), l2, scratch + b,
                          scratch + plane + b, (size_t)B, score + b,
                          end_i + b, end_j + b);
}

}  // namespace

// params: q, r, mat[25] (int32).  s1: int32 [B, L1+1], s2: int32
// [B, L2+1], len1/len2: int32 [B], scratch: int32 [2, L1+1, B],
// score/end_i/end_j: int32 [B].  Returns cudaGetLastError().
extern "C" int nabwa_local_fwd(const int32_t* params, const void* s1,
                               const void* s2, const void* len1,
                               const void* len2, int B, int L1, int L2,
                               void* scratch, void* score, void* end_i,
                               void* end_j, void* stream) {
    const nabwa::LocalParams p = nabwa::local_params(params);
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    local_fwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        p, (const int32_t*)s1, (const int32_t*)s2, (const int32_t*)len1,
        (const int32_t*)len2, B, L1, L2, (int32_t*)scratch, (int32_t*)score,
        (int32_t*)end_i, (int32_t*)end_j);
    return (int)cudaGetLastError();
}

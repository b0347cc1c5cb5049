// Kernel C6: batched seed extension of bwasw, the forward pass of
// aln_extend_core (stdaln.c:862-970) for every (target window, query
// segment) job of bsw2_extend_left/rght (bwtsw2_aux.c:80-164), many reads'
// jobs in one launch, each with its own initial score g0 and band bw.
//
// Replaces nabwa_tpu/ops/dp.py:264 `_extend_device`, a jnp lax.scan over
// rows that masks a whole padded row per step, with the F chain as a
// cummax.
//
// What bounds it on the card: each job is a chain of up to len2 dependent
// rows whose window holds at most 2 bw + 1 cells (~101 at bwasw's default
// band), 26 integer operations a cell (extend.cuh's inner loop, loads and
// stores not counted); the inputs are ~2 kB a job and the outputs 16
// bytes, so the work is integer operations, not bytes.  At 1 kb reads a
// job is up to ~100,000 window cells.
//
// First design: one thread per job walking each row's window left to right
// (the F chain is a running max), blocks of 128 threads, as C5.  The row
// state (hd, ev) lives in device scratch laid out [2][L1+2][B], so a warp's
// state reads and writes are coalesced where its jobs' windows line up;
// each thread reads its own target and query, so those reads are not.
// Jobs stop at different rows, so a warp runs as long as its longest job.

#include <cuda_runtime.h>

#include "extend.cuh"

namespace {

__global__ void extend_kernel(
    nabwa::ExtendParams p, const int32_t* __restrict__ s1,
    const int32_t* __restrict__ s2, const int32_t* __restrict__ len1,
    const int32_t* __restrict__ len2, const int32_t* __restrict__ g0,
    const int32_t* __restrict__ bw, int B, int L1, int L2,
    int32_t* __restrict__ scratch, int32_t* __restrict__ score,
    int32_t* __restrict__ end_i, int32_t* __restrict__ end_j,
    int32_t* __restrict__ cells) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const size_t plane = ((size_t)L1 + 2) * B;
    int l1 = len1[b], l2 = len2[b];
    l1 = l1 < 0 ? 0 : (l1 > L1 ? L1 : l1);
    l2 = l2 < 0 ? 0 : (l2 > L2 ? L2 : l2);
    nabwa::extend_job(p, s1 + (size_t)b * (L1 + 2), l1,
                      s2 + (size_t)b * (L2 + 1), l2, g0[b], bw[b],
                      scratch + b, scratch + plane + b, (size_t)B, score + b,
                      end_i + b, end_j + b, cells + b);
}

}  // namespace

// params: q, r, mat[25] (int32).  s1: int32 [B, L1+2], s2: int32
// [B, L2+1], len1/len2/g0/bw: int32 [B], scratch: int32 [2, L1+2, B],
// score/end_i/end_j/cells: int32 [B].  Returns cudaGetLastError().
extern "C" int nabwa_extend(const int32_t* params, const void* s1,
                            const void* s2, const void* len1,
                            const void* len2, const void* g0, const void* bw,
                            int B, int L1, int L2, void* scratch, void* score,
                            void* end_i, void* end_j, void* cells,
                            void* stream) {
    const nabwa::ExtendParams p = nabwa::extend_params(params);
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    extend_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        p, (const int32_t*)s1, (const int32_t*)s2, (const int32_t*)len1,
        (const int32_t*)len2, (const int32_t*)g0, (const int32_t*)bw, B, L1,
        L2, (int32_t*)scratch, (int32_t*)score, (int32_t*)end_i,
        (int32_t*)end_j, (int32_t*)cells);
    return (int)cudaGetLastError();
}

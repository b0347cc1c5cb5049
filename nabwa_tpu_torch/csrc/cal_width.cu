// Kernel C2: batched bwt_cal_width (bwtaln.c:52-76), the D(i) width and
// bid planes the DFS prunes on.
//
// Replaces nabwa_tpu/ops/occ.py:141 `cal_width`, a jnp lax.scan over read
// positions that the JAX package runs 4x per batch (read and seed suffix,
// both strands; nabwa_tpu/ops/dfs_pallas.py:1446-1453).
//
// What bounds it on the card: each step of a row needs two occ lookups,
// each a 48 B block read at a data-dependent address, and the next step's
// addresses depend on this step's result.  So a row is a chain of L
// dependent pairs of random reads: latency, not FLOPs or bandwidth.
//
// First design: one thread per (read, strand, main/seed) row, blocks of
// 128 threads.  Latency is hidden only by the number of rows in flight
// (the two lookups of a step are independent and overlap); the
// outputs are written row-major, uncoalesced.

#include <cuda_runtime.h>

#include "occ.cuh"

namespace {

__global__ void cal_width_kernel(nabwa::FmParams p,
                                 const uint32_t* __restrict__ bwt,
                                 const int32_t* __restrict__ queries,
                                 const int32_t* __restrict__ lengths, int B,
                                 int L, int32_t* __restrict__ width,
                                 int32_t* __restrict__ bid) {
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= B) return;
    nabwa::cal_width_row(p, bwt, queries + (size_t)row * L, lengths[row], L,
                         width + (size_t)row * (L + 1),
                         bid + (size_t)row * (L + 1));
}

}  // namespace

// params: l2[5], primary, seq_len (uint32).  Returns cudaGetLastError().
extern "C" int nabwa_cal_width(const uint32_t* params, const void* bwt,
                               const void* queries, const void* lengths,
                               int B, int L, void* width, void* bid,
                               void* stream) {
    const nabwa::FmParams p = nabwa::fm_params(params);
    const int threads = 128;
    int blocks = (B + threads - 1) / threads;
    cal_width_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        p, (const uint32_t*)bwt, (const int32_t*)queries,
        (const int32_t*)lengths, B, L, (int32_t*)width, (int32_t*)bid);
    return (int)cudaGetLastError();
}

extern "C" const char* nabwa_error_string(int rc) {
    return cudaGetErrorString((cudaError_t)rc);
}

// Kernel C3: batched bwt_sa (bwt.c:72-81), suffix-array row -> text
// position, for samse's coordinate step (bwa_cal_pac_pos, bwase.c:156-183).
//
// Replaces nabwa_tpu/ops/sa_lookup.py:34 `_sa_lookup_impl`, a jnp
// while_loop that steps every row of the batch in lockstep until the last
// one reaches a sampled row.
//
// What bounds it on the card: each step is one invPsi, a 4 B read for the
// base and a 48 B Occ block read at a data-dependent address, and the next
// step's address depends on this step's result.  A row is a chain of up to
// sa_intv - 1 dependent random reads: latency, not FLOPs or bandwidth.
//
// First design: one thread per row, blocks of 128 threads.  Rows finish
// after their own step count (no lockstep), and latency is hidden only by
// the number of rows in flight.  The interval test is the C's modulo, so
// any sa_intv works, not only powers of two.

#include <cuda_runtime.h>

#include "occ.cuh"

namespace {

__global__ void sa_lookup_kernel(nabwa::FmParams p,
                                 const uint32_t* __restrict__ bank,
                                 const uint32_t* __restrict__ sa,
                                 uint32_t intv,
                                 const uint32_t* __restrict__ rows, int n,
                                 uint32_t* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = nabwa::sa_lookup_row(p, bank, sa, intv, rows[i]);
}

}  // namespace

// params: l2[5], primary, seq_len (uint32).  bank: one BWT bank (the
// forward or the reverse one of DeviceIndex.bwt_cat); sa: that strand's
// sampled suffix array; rows: uint32 [n], each <= seq_len.  Returns
// cudaGetLastError().
extern "C" int nabwa_sa_lookup(const uint32_t* params, const void* bank,
                               const void* sa, uint32_t intv,
                               const void* rows, int n, void* out,
                               void* stream) {
    const nabwa::FmParams p = nabwa::fm_params(params);
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    sa_lookup_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        p, (const uint32_t*)bank, (const uint32_t*)sa, intv,
        (const uint32_t*)rows, n, (uint32_t*)out);
    return (int)cudaGetLastError();
}

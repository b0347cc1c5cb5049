// Kernel C23: scripts/probe_spill.py, K independent live values a lane.
//
// C23 replaces `make` (:23, pallas_call :45): for each int32 x of the
// input (the script's shapes [64, 1], [1, 128], [8, 128] and [64, 128]),
// K values v_i = x + i; then T rounds of the simultaneous update
// v_i <- (v_i * 3 + 1) ^ (v_{(i+1) mod K} >> 2) (`spill_update`,
// probes.cuh); out = the wrapping int32 sum of the K values, the input's
// shape.  K and T come from the environment in the script (:19-20,
// defaults 24 and 2000).  All arithmetic wraps as jnp's does.
//
// On the TPU the question is vector-register spills: K values of a
// [64, 1] column take 8 vregs each.  On Hopper one thread holds one
// element's K values in registers, so the question becomes how many
// independent int32 values a thread keeps live before ptxas spills past
// its 255 registers, and what a spill costs.  `probe_spill_kernel<K>`
// keeps `int32_t v[K]` in registers, every loop over i fully unrolled (a
// register array needs constant indices); T is a runtime loop.  The
// update goes in place in index order: v_i's neighbour v_{i+1} is still
// the old value when v_i is written, and the old v_0 is saved for
// v_{K-1}'s cross term (without it v_{K-1} would read the new v_0, wrong
// at every K >= 2).  K is a template parameter, instantiated for the set
// in SPILL_KS; any other K is refused (cudaErrorInvalidValue, nothing
// launched).  The set reaches past the register cap, so the ptxas report
// (`-Xptxas -v`) of its largest instantiations shows spill stores and
// loads.
//
// What bounds it: 4 operations a value and round (the multiply, the add,
// the shift and the xor), 4 T K an element, against 8 bytes an element.
// So operations at large K; past the cap, the spilled values' loads and
// stores to local memory (L1) a round; and with the script's few threads
// (at most 8,192, 256 warps: one a scheduler) the dependent latency of a
// value's chain, which K independent chains hide once K is past a few.
// Blocks of 128 threads.

#include <cuda_runtime.h>

#include <cstdint>

#include "probes.cuh"

namespace {

namespace pr = nabwa::probe;

constexpr int SPILL_THREADS = 128;

template <int K>
__global__ void __launch_bounds__(SPILL_THREADS)
probe_spill_kernel(const int32_t* __restrict__ x, int n, int t,
                   int32_t* __restrict__ out) {
    const int e = blockIdx.x * SPILL_THREADS + threadIdx.x;
    if (e >= n) return;
    const int32_t x0 = x[e];
    int32_t v[K];
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = pr::wadd(x0, i);
#pragma unroll 1
    for (int it = 0; it < t; ++it) {
        const int32_t v0 = v[0];
#pragma unroll
        for (int i = 0; i < K - 1; ++i)
            v[i] = pr::spill_update(v[i], v[i + 1]);
        v[K - 1] = pr::spill_update(v[K - 1], v0);
    }
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) acc += (uint32_t)v[i];
    out[e] = (int32_t)acc;
}

}  // namespace

// The instantiated K (nabwa_tpu_torch/probes/probe_spill.py's SPILL_KS
// repeats this list): the script's default 24, the cases 1 and 2, and
// steps that bracket ptxas's 255 registers a thread.  Each K past a few
// dozen adds seconds to nvcc (every loop over i is unrolled), so the set
// is kept to these.
#define SPILL_KS(X) \
    X(1) X(2) X(24) X(64) X(128) X(240) X(248) X(256) X(320)

// x, out: int32 [n]; k one of SPILL_KS; t >= 0 rounds.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for any other k (nothing
// launched).
extern "C" int nabwa_probe_spill(const void* x, int n, int k, int t,
                                 void* out, void* stream) {
    const int blocks = (n + SPILL_THREADS - 1) / SPILL_THREADS;
    switch (k) {
#define SPILL_CASE(K)                                                      \
    case K:                                                                \
        probe_spill_kernel<K><<<blocks, SPILL_THREADS, 0,                  \
                                (cudaStream_t)stream>>>(                   \
            (const int32_t*)x, n, t, (int32_t*)out);                       \
        break;
        SPILL_KS(SPILL_CASE)
#undef SPILL_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

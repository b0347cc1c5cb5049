// Kernel C24: scripts/probe_colops.py, the cost of a dependent integer
// step by shape.
//
// C24 replaces `make` (:23, pallas_call :39): for each int32 of the
// input (the script's shapes [64, 1], [8, 128], [64, 128], [1, 128] and
// [64, 256]), T rounds of K dependent steps v <- (v * 3 + 1) ^ (v >> 2)
// (`colops_step`, probes.cuh), wrapping as jnp's int32 does; out has the
// input's shape.  T and K come from the environment in the script (:19-20,
// defaults 2000 and 64) and are runtime values here.
//
// Every element is one chain of T K dependent steps, each two deep (the
// multiply-add and the shift side by side, then the xor), so one thread
// an element with its value in a register, the K steps unrolled by 4.
// What bounds it is that chain's latency, not the operations (4 a step,
// 4 T K an element) nor the bytes (8 an element): the script's shapes
// give at most 16,384 threads, in blocks of 128 at most one warp per
// scheduler, so nothing hides the chain's latency and the time should be
// nearly flat across shapes.  The script's "ns/op", time over 3 T K,
// then mostly says how many elements run side by side.

#include <cuda_runtime.h>

#include <cstdint>

#include "probes.cuh"

namespace {

namespace pr = nabwa::probe;

constexpr int COLOPS_THREADS = 128;

__global__ void __launch_bounds__(COLOPS_THREADS)
probe_colops_kernel(const int32_t* __restrict__ x, int n, int t, int k,
                    int32_t* __restrict__ out) {
    const int e = blockIdx.x * COLOPS_THREADS + threadIdx.x;
    if (e >= n) return;
    int32_t v = x[e];
#pragma unroll 1
    for (int it = 0; it < t; ++it) {
#pragma unroll 4
        for (int j = 0; j < k; ++j) v = pr::colops_step(v);
    }
    out[e] = v;
}

}  // namespace

// x, out: int32 [n]; t rounds of k steps (either <= 0: out = x).
// Returns cudaGetLastError().
extern "C" int nabwa_probe_colops(const void* x, int n, int t, int k,
                                  void* out, void* stream) {
    const int blocks = (n + COLOPS_THREADS - 1) / COLOPS_THREADS;
    probe_colops_kernel<<<blocks, COLOPS_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, n, t, k, (int32_t*)out);
    return (int)cudaGetLastError();
}

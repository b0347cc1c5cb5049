// Kernels C25 and C26: probes 7 and 8 of scripts/probe_pallas3.py, a
// chain of dependent steps by shape and a per-row scalar broadcast over a
// plane (the DFS's expansion shape).  All values are int32 and wrap as
// jnp's do (probes.cuh).  Probes 1, 1b, 2-6 of the script are not ported
// yet.
//
// C25 replaces `p7` (:202, through `call` :25-31, pallas_call :28): 200
// chained steps v <- (v + i) ^ (v >> 2), i = 0..199 (`p7_step`), on each
// int32 of x ([1, 256], [256, 1], [8, 256] and [8, 512] in the script).
// One thread an element, the 200 steps unrolled (i a constant).  Every
// element is a chain of 200 steps two deep (the add and the shift side
// by side, then the xor); 3 operations a step, 600 an element, against 8
// bytes an element.  At the script's at most 4,096 elements the launch
// and that chain's latency bound it, not the operations.
//
// C26 replaces `p8` (:222, pallas_call :28): for a int32 [256, 1], one
// scalar a row, and b int32 [256, 128], 30 steps v <- where(v > a, v - a,
// v + i), i = 0..29 (`p8_step`), from v = b; out int32 [256, 128].  One
// int4 of a row a thread, so a 128-word row is one warp and its scalar
// one broadcast load (every lane reads the same word), then four
// independent chains a thread, the 30 steps unrolled.  4 operations a
// step (the compare, the subtract, the add, the select), 120 an element,
// against 8 bytes an element and 4 a row: launch-bound at the script's
// shape.  Rows of any width that is a multiple of 4, starting on 16-byte
// boundaries.

#include <cuda_runtime.h>

#include <cstdint>

#include "probes.cuh"

namespace {

namespace pr = nabwa::probe;

constexpr int P7_STEPS = 200;         // scripts/probe_pallas3.py:206
constexpr int P7_THREADS = 128;
constexpr int P8_STEPS = 30;          // scripts/probe_pallas3.py:227
constexpr int P8_THREADS = 128;

__global__ void __launch_bounds__(P7_THREADS)
probe_p7_kernel(const int32_t* __restrict__ x, int n,
                int32_t* __restrict__ out) {
    const int e = blockIdx.x * P7_THREADS + threadIdx.x;
    if (e >= n) return;
    int32_t v = x[e];
#pragma unroll
    for (int i = 0; i < P7_STEPS; ++i) v = pr::p7_step(v, i);
    out[e] = v;
}

__global__ void __launch_bounds__(P8_THREADS)
probe_p8_kernel(const int32_t* __restrict__ a, const int4* __restrict__ b,
                int rows, int quads, int4* __restrict__ out) {
    const int q = blockIdx.x * P8_THREADS + threadIdx.x;
    if (q >= rows * quads) return;
    const int32_t s = a[q / quads];
    int4 v = b[q];
#pragma unroll
    for (int i = 0; i < P8_STEPS; ++i) {
        v.x = pr::p8_step(v.x, s, i);
        v.y = pr::p8_step(v.y, s, i);
        v.z = pr::p8_step(v.z, s, i);
        v.w = pr::p8_step(v.w, s, i);
    }
    out[q] = v;
}

}  // namespace

// x, out: int32 [n].  Returns cudaGetLastError().
extern "C" int nabwa_probe_p7(const void* x, int n, void* out,
                              void* stream) {
    const int blocks = (n + P7_THREADS - 1) / P7_THREADS;
    probe_p7_kernel<<<blocks, P7_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, n, (int32_t*)out);
    return (int)cudaGetLastError();
}

// a: int32 [rows]; b, out: int32 [rows, cols], 16-byte aligned, cols a
// multiple of 4.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for cols not a multiple of 4 (nothing launched).
extern "C" int nabwa_probe_p8(const void* a, const void* b, int rows,
                              int cols, void* out, void* stream) {
    if (cols % 4) return (int)cudaErrorInvalidValue;
    const int quads = cols / 4;
    const int blocks = (rows * quads + P8_THREADS - 1) / P8_THREADS;
    probe_p8_kernel<<<blocks, P8_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)a, (const int4*)b, rows, quads, (int4*)out);
    return (int)cudaGetLastError();
}

// Kernels C25-C30: probes 1, 1b, 3, 4, 7 and 8 of scripts/probe_pallas3.py:
// two scalar-indexed row copies, a gather along the rows, a relayout, a
// chain of dependent steps by shape and a per-row scalar broadcast over a
// plane (the DFS's expansion shape).  All values are int32 and wrap as
// jnp's do (probes.cuh).  Probes 2, 5 and 6 of the script are not ported
// yet.
//
// C27 replaces `p1` (:35, through `call` :25-31, pallas_call :28): 256
// rounds, round k reading r = i[k, 0] and r2 = i[k, 1] (lanes 0 and 1 of
// row k of i int32 [256, 128]) and copying table row t[r] to out row k
// and t[r2] to out row k + 256 (t int32 [4096, 128], out [512, 128]).
// C28 replaces `p1b` (:60): the same copies with r = i[k, 0] and r2 =
// j[k, 0] from two [256, 1] columns.  One kernel serves both, given each
// half's index pointer and its row stride: (i, 128) and (i + 1, 128) for
// p1, (i, 1) and (j, 1) for p1b.  A warp copies one out row: every lane
// loads the same index word (one broadcast), then each lane copies one
// int4 of the 512 B row.  Bound by bytes: the distinct table rows read
// once, the index words (p1's two share one 32 B sector a row) and out;
// no arithmetic beyond the addresses.  The indices are not checked on the
// card: the wrappers' dispatchers refuse any outside [0, rows of t).
//
// C29 replaces `p3` (:123): take_along_axis on axis 0, out[r, c] = x[i[r,
// c], c] for x int32 [128, 128] and i [8, 128] in [0, 128).  A thread an
// out element, one word gathered; bound by bytes (the gathered words, i
// and out), launch-bound at the script's 1,024 elements.  Rows of any
// width; the indices are checked by the dispatcher as C27's are.
//
// C30 replaces `p4` (:140): the relayout out = x[:, :16].reshape(64, 128)
// of x int32 [512, 128], out[r, c] = x[8 r + c / 16, c % 16].  Every out
// row is the first 16 words of 8 rows of x in order, so out's int4 q is
// x's int4 q % 4 of row q / 4 (`relayout_src`); a thread an out int4, an
// int4 load from a 16-byte boundary when x's rows are a multiple of 4
// words.  Bound by bytes (x[:, :16] read once, out written once).  x of
// any rows that are a multiple of 8 and any width from 16 that is a
// multiple of 4.
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
constexpr int COPY_WARPS = 4;         // C27, C28: out rows a block
constexpr int P3_THREADS = 128;
constexpr int P4_THREADS = 128;
constexpr int P4_WIDTH = 16;          // scripts/probe_pallas3.py:142
constexpr int P4_FOLD = 8;            // x rows an out row: 128 / 16

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

// Out row o < 2 n takes table row a[o * sa] (o < n) or b[(o - n) * sb]:
// C27 and C28.  t and out hold `quads` int4 a row.
__global__ void __launch_bounds__(COPY_WARPS * 32)
probe_rowcopy_kernel(const int32_t* __restrict__ a, int sa,
                     const int32_t* __restrict__ b, int sb, int n,
                     const int4* __restrict__ t, int quads,
                     int4* __restrict__ out) {
    const int o = blockIdx.x * COPY_WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (o >= 2 * n) return;
    const int32_t r = o < n ? a[(size_t)o * sa] : b[(size_t)(o - n) * sb];
    const int4* src = t + (size_t)r * quads;
    int4* dst = out + (size_t)o * quads;
    for (int q = lane; q < quads; q += 32) dst[q] = src[q];
}

__global__ void __launch_bounds__(P3_THREADS)
probe_p3_kernel(const int32_t* __restrict__ x, int cols,
                const int32_t* __restrict__ i, int n,
                int32_t* __restrict__ out) {
    const int e = blockIdx.x * P3_THREADS + threadIdx.x;
    if (e >= n) return;
    out[e] = x[(size_t)i[e] * cols + e % cols];
}

__global__ void __launch_bounds__(P4_THREADS)
probe_p4_kernel(const int4* __restrict__ x, int quads, int n,
                int4* __restrict__ out) {
    const int q = blockIdx.x * P4_THREADS + threadIdx.x;
    if (q >= n) return;
    out[q] = x[pr::relayout_src(q, quads)];
}

int rowcopy(const void* a, int sa, const void* b, int sb, int n,
            const void* t, int cols, void* out, void* stream) {
    if (cols % 4) return (int)cudaErrorInvalidValue;
    const int blocks = (2 * n + COPY_WARPS - 1) / COPY_WARPS;
    probe_rowcopy_kernel<<<blocks, COPY_WARPS * 32, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)a, sa, (const int32_t*)b, sb, n, (const int4*)t,
        cols / 4, (int4*)out);
    return (int)cudaGetLastError();
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

// i: int32 [n, i_w], i_w >= 2, its lanes 0 and 1 each row in [0, rows of
// t); t: int32 [rows, cols], out: int32 [2 n, cols], both 16-byte aligned,
// cols a multiple of 4.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for cols not a multiple of 4 (nothing launched).
extern "C" int nabwa_probe_p1(const void* i, int i_w, int n, const void* t,
                              int cols, void* out, void* stream) {
    return rowcopy(i, i_w, (const int32_t*)i + 1, i_w, n, t, cols, out,
                   stream);
}

// i, j: int32 [n] in [0, rows of t); t, out as for nabwa_probe_p1.
extern "C" int nabwa_probe_p1b(const void* i, const void* j, int n,
                               const void* t, int cols, void* out,
                               void* stream) {
    return rowcopy(i, 1, j, 1, n, t, cols, out, stream);
}

// x: int32 [rows, cols]; i, out: int32 [n / cols, cols], i in [0, rows).
// Returns cudaGetLastError().
extern "C" int nabwa_probe_p3(const void* x, int cols, const void* i, int n,
                              void* out, void* stream) {
    const int blocks = (n + P3_THREADS - 1) / P3_THREADS;
    probe_p3_kernel<<<blocks, P3_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, cols, (const int32_t*)i, n, (int32_t*)out);
    return (int)cudaGetLastError();
}

// x: int32 [rows, cols], 16-byte aligned, rows a multiple of 8, cols a
// multiple of 4 and at least 16; out: int32 [rows / 8, 128].  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for other rows or cols
// (nothing launched).
extern "C" int nabwa_probe_p4(const void* x, int rows, int cols, void* out,
                              void* stream) {
    if (rows % P4_FOLD || cols % 4 || cols < P4_WIDTH)
        return (int)cudaErrorInvalidValue;
    const int n = rows / P4_FOLD * (P4_FOLD * P4_WIDTH / 4);
    const int blocks = (n + P4_THREADS - 1) / P4_THREADS;
    probe_p4_kernel<<<blocks, P4_THREADS, 0, (cudaStream_t)stream>>>(
        (const int4*)x, cols / 4, n, (int4*)out);
    return (int)cudaGetLastError();
}

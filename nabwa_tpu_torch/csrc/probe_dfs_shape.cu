// Kernels C9 and C10: the two DFS-iteration mocks, one warp per read.
// Each read holds S slots of a priority stack; each iteration pops, makes
// row loads from a [NROW, 128] int32 table, counts bits in the staged
// rows and pushes up to 9 candidates into free slots.  The result is one
// int32 sum over reads and iterations (int32 wrap-around, as jnp's).
//
// C9 replaces scripts/probe_dfs_shape.py:23 `kernel` (pallas_call at
// :118): BB reads, S slots, ITERS iterations, NROW = 4096 (2 MB).  Per
// iteration: pop the lowest-index slot holding the minimum key, gather its
// four fields and free the slot; load row (e0 ^ e1) and row (e2 ^ e3);
// count each row's masked popcounts (probes.cuh shape_word_count); ten
// rounds of column arithmetic (shape_expand) give candidates a + j, valid
// where bit j of b is 0; push the valid ones into the lowest free slots in
// order (free: key == 0x7FFFFFFF, ranked by an inclusive prefix, which the
// TPU builds with pltpu.roll doublings, :96-102).  acc sums the first
// row's count.
//
// C10 replaces scripts/probe_pallas.py:231 `probe_dfs_shape` (pallas_call
// at :282): BB = 256 reads, S = 128 slots, NROW = 32768 (16 MB), 100
// iterations.  Per iteration: every slot equal to the minimum is popped
// (pm) and its kidx summed (e_k); row kidx[0] into bank 0 and row kidx[1]
// into bank 1; popcounts of lo and lo & hi over bank 0 (c1, c3); the first
// 9 free slots (pool >= 0x40000000) get it * 9 + j; every popped slot is
// freed (0x7FFFFFFF); kidx += c1 + c3 + e_k, masked to NROW - 1.  acc sums
// the minimum.  Bank 1's row is loaded and, as on the TPU, never read: a
// volatile load keeps it.
//
// What bounds them on the card: integer operations.  Counted per read and
// iteration from what the function needs (loads and stores not counted):
//   C9:  per staged row, 6 for its block (word 0's offset: and, shift,
//        add; word 1's word offset: shift, and; the address) and 17 for
//        each of the block's 8 words (the mask: two compares and a
//        select; lo 2, hi 3, lo & hi 1, three popcounts, tot 4, the sum
//        1); the other 120 words add nothing to the count, so none is
//        counted (the kernel still spends about 3 on each to find that
//        out).  Then 16 per slot (min, compare, argmin, pop, free,
//        prefix, nine candidate compares) and 178 per read (gathers, row
//        indices, the expansion's 10 x 8, candidates, prefix, five field
//        writes per candidate): 2 x (6 + 8 x 17) + 16 S + 178 =
//        462 + 16 S;
//   C10: 8 per word of bank 0's row, 11 per slot (min, compare, e_k,
//        free, prefix, push, re-free, kidx update) and 10 per read:
//        1,024 + 11 S + 10.
// The bytes are the inputs read once and the distinct table rows the run
// loads.  Each iteration's work per read is one dependent chain: a warp
// reduction for the pop, two row loads that depend on it, two more
// reductions and the push, so the time is latency, hidden only by the
// warps in flight.
//
// Design: one warp per read, the mapping proposed for C1.  Lane l holds
// slots k * 32 + l (k < S / 32) of each field in registers; the lane-axis
// min and sums are __shfl_xor_sync butterflies, the lowest-index argmin is
// a __ballot_sync per register row, the free-slot prefix __ballot_sync +
// __popc, and a 128-word row is one coalesced 512 B warp load (16 B a
// lane).  Blocks of 2 warps; each block adds its warps' sums with one
// unsigned atomicAdd (wrap-around addition commutes, so the result is
// exact in any order).  S is a multiple of 32 up to 128.

#include <cuda_runtime.h>

#include <cstdint>

#include "probes.cuh"

namespace {

namespace pr = nabwa::probe;

constexpr int WARPS = 2;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int32_t warp_min(int32_t v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ int32_t warp_sum(int32_t v) {
#pragma unroll
    for (int o = 16; o; o >>= 1)
        v = pr::wadd(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// a[k] for a warp-uniform k, without indexing the register array
template <int K>
__device__ __forceinline__ int32_t pick(const int32_t (&a)[K], int k) {
    int32_t v = a[0];
#pragma unroll
    for (int q = 1; q < K; ++q)
        if (q == k) v = a[q];
    return v;
}

__device__ __forceinline__ int4 load_row(const int4* table, int32_t r,
                                         int lane) {
    return table[(size_t)r * 32 + lane];
}

// a row load whose value is never read, as the TPU's bank-1 stage store
// is; ld.volatile is never removed by the compiler
__device__ __forceinline__ void touch_row(const int4* table, int32_t r,
                                          int lane) {
    asm volatile(
        "{\n\t.reg .s32 t<4>;\n\t"
        "ld.volatile.global.v4.s32 {t0, t1, t2, t3}, [%0];\n\t}"
        ::"l"(table + (size_t)r * 32 + lane));
}

// probe_dfs_shape.py:59-73: the count of one staged row, warp-uniform
__device__ __forceinline__ int32_t shape_row_count(int4 x, int lane) {
    const int32_t w0 = __shfl_sync(FULL, x.x, 0);
    const int32_t w1 = __shfl_sync(FULL, x.y, 0);
    const int32_t w = 4 * lane;
    int32_t c = pr::shape_word_count(x.x, w, w0, w1);
    c = pr::wadd(c, pr::shape_word_count(x.y, w + 1, w0, w1));
    c = pr::wadd(c, pr::shape_word_count(x.z, w + 2, w0, w1));
    c = pr::wadd(c, pr::shape_word_count(x.w, w + 3, w0, w1));
    return warp_sum(c);
}

// inclusive rank of each free slot in slot order (k * 32 + lane)
template <int K>
__device__ __forceinline__ void free_ranks(const bool (&fr)[K], int lane,
                                           int (&rank)[K]) {
    const unsigned le = (2u << lane) - 1u;   // this lane and those below
    int base = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const unsigned bf = __ballot_sync(FULL, fr[k]);
        rank[k] = base + __popc(bf & le);
        base += __popc(bf);
    }
}

__device__ __forceinline__ void add_block_sum(uint32_t acc, uint32_t* out) {
    __shared__ uint32_t part[WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        uint32_t s = 0;
        for (int w = 0; w < WARPS; ++w) s += part[w];
        atomicAdd(out, s);
    }
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32)
dfs_shape_kernel(const int32_t* __restrict__ seed, int seed_w,
                 const int4* __restrict__ table, int nrow, int bb, int iters,
                 uint32_t* __restrict__ acc_out) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    uint32_t acc = 0;
    if (b < bb) {
        int32_t key[K], f0[K], f1[K], f2[K], f3[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int32_t s = seed[(size_t)b * seed_w + k * 32 + lane];
            key[k] = s;
            f0[k] = s ^ 12345;
            f1[k] = pr::wadd(s, 7);
            f2[k] = s ^ 999;
            f3[k] = pr::wsub(s, 3);
        }
        for (int it = 0; it < iters; ++it) {
            // pop: the lowest-index slot holding the minimum key
            int32_t m = key[0];
#pragma unroll
            for (int k = 1; k < K; ++k) m = min(m, key[k]);
            const int32_t mk = warp_min(m);
            int kk = 0;
            unsigned bal = 0;
#pragma unroll
            for (int k = K - 1; k >= 0; --k) {
                const unsigned bk = __ballot_sync(FULL, key[k] == mk);
                if (bk) {
                    kk = k;
                    bal = bk;
                }
            }
            const int owner = __ffs(bal) - 1;
            const int32_t e0 = __shfl_sync(FULL, pick(f0, kk), owner);
            const int32_t e1 = __shfl_sync(FULL, pick(f1, kk), owner);
            const int32_t e2 = __shfl_sync(FULL, pick(f2, kk), owner);
            const int32_t e3 = __shfl_sync(FULL, pick(f3, kk), owner);
#pragma unroll
            for (int k = 0; k < K; ++k)
                if (k == kk && lane == owner) key[k] = pr::FREE_KEY;

            // occ: two row loads, their counts
            const int32_t cnt_k = shape_row_count(
                load_row(table, (e0 ^ e1) & (nrow - 1), lane), lane);
            const int32_t cnt_l = shape_row_count(
                load_row(table, (e2 ^ e3) & (nrow - 1), lane), lane);

            int32_t a, bq;
            pr::shape_expand(e0, e1, cnt_k, cnt_l, &a, &bq);

            // push: valid candidate j into the (pref_j + 1)-th free slot
            bool fr[K];
            int rank[K];
#pragma unroll
            for (int k = 0; k < K; ++k) fr[k] = key[k] == pr::FREE_KEY;
            free_ranks(fr, lane, rank);
            int pref = 0;
#pragma unroll
            for (int j = 0; j < 9; ++j) {
                if ((bq >> j) & 1) continue;
                const int32_t c = pr::wadd(a, j);
                ++pref;
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    if (fr[k] && rank[k] == pref) {
                        key[k] = c;
                        f0[k] = c ^ 1;
                        f1[k] = pr::wadd(c, it);
                        f2[k] = pr::wsub(c, 2);
                        f3[k] = pr::wmul(c, 3);
                    }
                }
            }
            acc += (uint32_t)cnt_k;
        }
    }
    add_block_sum(acc, acc_out);
}

__global__ void __launch_bounds__(WARPS * 32)
dfs_pallas_kernel(const int32_t* __restrict__ kin,
                  const int4* __restrict__ table, int nrow, int bb,
                  int iters, uint32_t* __restrict__ acc_out) {
    constexpr int K = 4;   // S = 128 slots; kidx has 128 columns
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    uint32_t acc = 0;
    if (b < bb) {
        int32_t pool[K], kidx[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            pool[k] = (k * 32 + lane) * 3 + b;
            kidx[k] = kin[(size_t)b * 128 + k * 32 + lane];
        }
        for (int it = 0; it < iters; ++it) {
            // pop every slot equal to the minimum, summing its kidx
            int32_t m = pool[0];
#pragma unroll
            for (int k = 1; k < K; ++k) m = min(m, pool[k]);
            const int32_t mk = warp_min(m);
            bool pm[K];
            int32_t ek = 0;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                pm[k] = pool[k] == mk;
                if (pm[k]) ek = pr::wadd(ek, kidx[k]);
            }
            ek = warp_sum(ek);

            // occ: kidx[0] into bank 0, kidx[1] into bank 1
            const int32_t r = __shfl_sync(FULL, kidx[0], 0) & (nrow - 1);
            const int32_t r2 = __shfl_sync(FULL, kidx[0], 1) & (nrow - 1);
            const int4 x = load_row(table, r, lane);
            touch_row(table, r2, lane);
            uint32_t c1 = 0, c3 = 0;
            pr::pallas_word_counts(x.x, &c1, &c3);
            pr::pallas_word_counts(x.y, &c1, &c3);
            pr::pallas_word_counts(x.z, &c1, &c3);
            pr::pallas_word_counts(x.w, &c1, &c3);
            const int32_t s1 = warp_sum((int32_t)c1);
            const int32_t s3 = warp_sum((int32_t)c3);

            // push it * 9 + j into the first 9 free slots, then re-free
            // the popped ones
            bool fr[K];
            int rank[K];
#pragma unroll
            for (int k = 0; k < K; ++k) fr[k] = pool[k] >= 0x40000000;
            free_ranks(fr, lane, rank);
            const int32_t inc = pr::wadd(pr::wadd(s1, s3), ek);
#pragma unroll
            for (int k = 0; k < K; ++k) {
                if (fr[k] && rank[k] <= 9)
                    pool[k] = pr::wadd(pr::wmul(it, 9), rank[k] - 1);
                if (pm[k]) pool[k] = pr::FREE_KEY;
                kidx[k] = pr::wadd(kidx[k], inc) & (nrow - 1);
            }
            acc += (uint32_t)mk;
        }
    }
    add_block_sum(acc, acc_out);
}

}  // namespace

// C9.  seed: int32 [bb, seed_w] (seed_w >= s); table: int32 [nrow, 128],
// nrow a power of two; s: 32, 64, 96 or 128; acc: uint32 [1], zeroed by
// the caller.  Returns cudaGetLastError().
extern "C" int nabwa_probe_dfs_shape(const void* seed, int seed_w,
                                     const void* table, int nrow, int bb,
                                     int s, int iters, void* acc,
                                     void* stream) {
    const int blocks = (bb + WARPS - 1) / WARPS;
    const int32_t* sd = (const int32_t*)seed;
    const int4* tab = (const int4*)table;
    uint32_t* out = (uint32_t*)acc;
    cudaStream_t st = (cudaStream_t)stream;
    switch (s) {
        case 32: dfs_shape_kernel<1><<<blocks, WARPS * 32, 0, st>>>(
                     sd, seed_w, tab, nrow, bb, iters, out); break;
        case 64: dfs_shape_kernel<2><<<blocks, WARPS * 32, 0, st>>>(
                     sd, seed_w, tab, nrow, bb, iters, out); break;
        case 96: dfs_shape_kernel<3><<<blocks, WARPS * 32, 0, st>>>(
                     sd, seed_w, tab, nrow, bb, iters, out); break;
        case 128: dfs_shape_kernel<4><<<blocks, WARPS * 32, 0, st>>>(
                      sd, seed_w, tab, nrow, bb, iters, out); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// C10.  k: int32 [bb, 128]; table: int32 [nrow, 128], nrow a power of
// two; acc: uint32 [1], zeroed by the caller.  Returns cudaGetLastError().
extern "C" int nabwa_probe_dfs_pallas(const void* k, const void* table,
                                      int nrow, int bb, int iters, void* acc,
                                      void* stream) {
    const int blocks = (bb + WARPS - 1) / WARPS;
    dfs_pallas_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)k, (const int4*)table, nrow, bb, iters,
        (uint32_t*)acc);
    return (int)cudaGetLastError();
}

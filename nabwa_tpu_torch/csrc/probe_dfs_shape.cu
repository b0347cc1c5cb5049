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
// warps in flight.  C9's chain, counted from the function: the pop (a
// minimum over a lane's K keys, a warp minimum, a compare and a warp
// minimum of the slot index, a select and a shuffle for the fields), the
// row index and its address, one L2 row load (the two side by side), the
// count (a shuffle of word 0, a lane's masked popcounts and their sum, a
// warp sum), the expansion (one add, then 7 dependent steps a round: the
// compare and its select, the shift and the xor, the and and the add, the
// add-and-minimum), the push (the valid mask, a prefix popcount, its
// compare and sum, the candidate's add and the key's select);
// chip_smoke.py's C9_CHAIN counts them and prices each at the latency the
// stamped form measures.  C10's iteration carries two values, the pool and
// kidx; kidx's path is the longer: slot 0's kidx by a shuffle from lane 0,
// its mask to NROW - 1 and the row's address, one L2 row load, the count
// c3 (the shift, the and of x, x >> 1 and the mask as one three-input
// LOP3, a popcount, the lane's two adds of its four words), a redux.sync,
// the add of s1 + s3 + e_k, then kidx's add and mask: a shuffle, 10
// integer steps, a load and a redux.sync (C10_CHAIN).  The pop (a lane's
// minimum, a redux.sync, the compares, e_k's adds and its redux.sync)
// runs beside the row load and ends before the count does; the pool's own
// path (the pop, the free flags, the ballots' ranks and the push's
// selects) is shorter still.
//
// Design: one warp per read, the mapping proposed for C1.  Lane l holds
// slots k * 32 + l (k < S / 32) of each field in registers, and a
// 128-word row is one coalesced 512 B warp load (16 B a lane).  Blocks of
// 2 warps; each block adds its warps' sums with one unsigned atomicAdd
// (wrap-around addition commutes, so the result is exact in any order).
// S is a multiple of 32 up to 128.  C9 has two forms, one template flag
// apart (`LEAN`):
//   - the witness (the first design): the lane-axis min and sums are
//     __shfl_xor_sync butterflies, the lowest-index argmin a
//     __ballot_sync per register row and __ffs, each row counted word by
//     word (shape_word_count), and the push 9 x K predicated passes, one
//     per candidate over every slot;
//   - the lean form: the min, the argmin (the least slot index holding
//     the minimum) and the two rows' counts are one redux.sync each; both
//     row loads are issued before anything that waits on them, and the
//     pop's bookkeeping (the free flags and each free slot's inclusive
//     rank: K ballots and popcounts) is written to fill their latency;
//     the counts are taken from the blocks' side, 8 lanes a row each
//     counting one word of its 8-word block, fetched by shuffles
//     (block_counts), not 32 lanes masking 128 words; the push is one
//     pass over the slots: lane t works out which candidate the (t + 1)-th
//     free slot takes (push_nth), and each free slot reads it with one
//     shuffle from the lane of its rank (push_lane).
// A second flag (`STAMP`, S = 128 only, off in every timed launch) adds
// clock64 stamps: after each stage of an iteration (the pop, the row
// loads up to the first use of their data, the two counts, the expansion,
// the push) a volatile store of the stage's result (which waits for it)
// and then the clock read, and the stage's cycles go to a side buffer,
// [BB][ITERS][STAGES]; then, per read, the cycles of calibration chains
// (dependent IMADs, C24's step, redux.syncs, shuffles, shared loads) and
// the read's clock64 and %globaltimer spans, [BB][CAL] after them.
//
// C10 (the first design, its reductions one redux.sync each): lane l
// holds slots k * 32 + l of the pool and kidx; the pop compares every
// slot with the warp minimum, the free-slot prefix is K ballots and
// popcounts.

#include <cuda_runtime.h>

#include <cstdint>

#include "probes.cuh"

namespace {

namespace pr = nabwa::probe;

constexpr int WARPS = 2;
constexpr unsigned FULL = 0xFFFFFFFFu;
// the stamped form: an iteration's stages and the calibration words a read
constexpr int STAGES = 5;
constexpr int CAL = 8;
constexpr int CAL_INT_STEPS = 64;     // IMADs, and C24's steps
constexpr int CAL_WARP_STEPS = 32;    // redux.syncs, shuffles, shared loads
constexpr int CHASE = 64;             // the shared loads' ring

// the witness's reductions: five-step butterflies
__device__ __forceinline__ int32_t warp_min_shfl(int32_t v) {
#pragma unroll
    for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ int32_t warp_sum_shfl(int32_t v) {
#pragma unroll
    for (int o = 16; o; o >>= 1)
        v = pr::wadd(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// the lean form's and C10's: one redux.sync each (sm_80 and later); the
// sum wraps as the butterfly's does
__device__ __forceinline__ int32_t warp_min(int32_t v) {
    return __reduce_min_sync(FULL, v);
}

__device__ __forceinline__ int32_t warp_sum(int32_t v) {
    return (int32_t)__reduce_add_sync(FULL, (uint32_t)v);
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

// probe_dfs_shape.py:59-73, the witness's count of one staged row,
// warp-uniform: word by word, summed by a butterfly
__device__ __forceinline__ int32_t shape_row_count(int4 x, int lane) {
    const int32_t w0 = __shfl_sync(FULL, x.x, 0);
    const int32_t w1 = __shfl_sync(FULL, x.y, 0);
    const int32_t w = 4 * lane;
    int32_t c = pr::shape_word_count(x.x, w, w0, w1);
    c = pr::wadd(c, pr::shape_word_count(x.y, w + 1, w0, w1));
    c = pr::wadd(c, pr::shape_word_count(x.z, w + 2, w0, w1));
    c = pr::wadd(c, pr::shape_word_count(x.w, w + 3, w0, w1));
    return warp_sum_shfl(c);
}

// the lean form's counts of both staged rows, from the blocks' side: lanes
// 0-7 count block word lane & 7 of row k, lanes 8-15 of row l, each word
// fetched from the lane that holds it (shape_block_lane) by four shuffles
// a row, one a component; lane 0 packs both rows' block and word offsets
// into one shuffle first.  One redux.sync sums both counts, row l's in the
// high half (a row's is at most 8 x 48).
__device__ __forceinline__ void block_counts(int4 xk, int4 xl, int lane,
                                             int32_t* cnt_k,
                                             int32_t* cnt_l) {
    const int32_t offs = __shfl_sync(
        FULL, (xk.x & 7) | ((xk.y >> 1) & 0x38) | ((xl.x & 7) << 6)
              | ((xl.y << 5) & 0xE00), 0);
    const int i = lane & 7, c = lane & 3, sh = (lane & 8) * 2;
    const int32_t mine = offs >> (sh * 6 / 16);     // this row's 6 bits
    const int src = pr::shape_block_lane(mine, i);
    const int32_t k0 = __shfl_sync(FULL, xk.x, src);
    const int32_t k1 = __shfl_sync(FULL, xk.y, src);
    const int32_t k2 = __shfl_sync(FULL, xk.z, src);
    const int32_t k3 = __shfl_sync(FULL, xk.w, src);
    const int32_t l0 = __shfl_sync(FULL, xl.x, src);
    const int32_t l1 = __shfl_sync(FULL, xl.y, src);
    const int32_t l2 = __shfl_sync(FULL, xl.z, src);
    const int32_t l3 = __shfl_sync(FULL, xl.w, src);
    const int32_t x = sh ? (c == 0 ? l0 : c == 1 ? l1 : c == 2 ? l2 : l3)
                         : (c == 0 ? k0 : c == 1 ? k1 : c == 2 ? k2 : k3);
    const int32_t n = pr::shape_block_count(x, i, (mine >> 3) & 7);
    const uint32_t both = (uint32_t)warp_sum(lane < 16 ? n << sh : 0);
    *cnt_k = (int32_t)(both & 0xFFFFu);
    *cnt_l = (int32_t)(both >> 16);
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

// the stamped form's clock: v's volatile store waits for v, and the clock
// read follows it in one asm block, so that the stamp falls after v
__device__ __forceinline__ long long stamp_after(int32_t v, int32_t* sink) {
    long long t;
    asm volatile("st.volatile.global.s32 [%1], %2;\n\t"
                 "mov.u64 %0, %%clock64;"
                 : "=l"(t) : "l"(sink), "r"(v) : "memory");
    return t;
}

__device__ __forceinline__ long long global_ns() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
    return t;
}

// the calibration chains of the stamped form, each from v: the cycles of
// CAL_INT_STEPS dependent IMADs and of as many of C24's steps, then of
// CAL_WARP_STEPS dependent redux.syncs, shuffles and shared loads (a ring
// of byte offsets in `chase`, entered at an offset taken from v), into
// cal[0..4]; returns the last values, combined
__device__ __forceinline__ int32_t calibrate(int32_t v, int lane,
                                          const int32_t* chase,
                                          int32_t* cal, int32_t* sink) {
    long long t0 = stamp_after(v, sink);
#pragma unroll
    for (int i = 0; i < CAL_INT_STEPS; ++i)
        v = (int32_t)((uint32_t)v * (uint32_t)v + (uint32_t)lane);
    long long t1 = stamp_after(v, sink);
    cal[0] = (int32_t)(t1 - t0);
#pragma unroll
    for (int i = 0; i < CAL_INT_STEPS; ++i) v = pr::colops_step(v);
    t0 = stamp_after(v, sink);
    cal[1] = (int32_t)(t0 - t1);
#pragma unroll
    for (int i = 0; i < CAL_WARP_STEPS; ++i) v = warp_sum(v);
    t1 = stamp_after(v, sink);
    cal[2] = (int32_t)(t1 - t0);
#pragma unroll
    for (int i = 0; i < CAL_WARP_STEPS; ++i)
        v = __shfl_xor_sync(FULL, v, 1);
    t0 = stamp_after(v, sink);
    cal[3] = (int32_t)(t0 - t1);
    int32_t o = v & ((CHASE - 1) * 4);     // a ring offset, after v
#pragma unroll
    for (int i = 0; i < CAL_WARP_STEPS; ++i)
        o = *(const int32_t*)((const char*)chase + o);
    t1 = stamp_after(o, sink);
    cal[4] = (int32_t)(t1 - t0);
    return v ^ o;
}

// C9.  LEAN picks the form (see the header); STAMP adds the stamps, whose
// side buffer `stamps` holds iters * STAGES + CAL words a read.
template <int K, bool LEAN, bool STAMP>
__global__ void __launch_bounds__(WARPS * 32)
dfs_shape_kernel(const int32_t* __restrict__ seed, int seed_w,
                 const int4* __restrict__ table, int nrow, int bb, int iters,
                 uint32_t* __restrict__ acc_out,
                 int32_t* __restrict__ stamps) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    __shared__ int32_t chase[STAMP ? CHASE : 1];
    if (STAMP) {
        if (threadIdx.x < CHASE)
            chase[threadIdx.x] = ((threadIdx.x * 5 + 1) & (CHASE - 1)) * 4;
        __syncthreads();
    }
    uint32_t acc = 0;
    if (b < bb) {
        int32_t* row = STAMP ? stamps + (size_t)b * (iters * STAGES + CAL)
                             : nullptr;
        int32_t* cal = STAMP ? row + (size_t)iters * STAGES : nullptr;
        int32_t* sink = STAMP ? cal + CAL - 1 : nullptr;
        const long long ns0 = STAMP ? global_ns() : 0;
        long long t0 = STAMP ? stamp_after(lane, sink) : 0;
        const long long c0 = t0;
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
            int kk, owner;
            if (LEAN) {
                const int32_t mk = warp_min(m);
                int32_t mine = 32 * K;
#pragma unroll
                for (int k = K - 1; k >= 0; --k)
                    if (key[k] == mk) mine = k * 32 + lane;
                const int32_t slot = warp_min(mine);
                kk = slot >> 5;
                owner = slot & 31;
            } else {
                const int32_t mk = warp_min_shfl(m);
                kk = 0;
                unsigned bal = 0;
#pragma unroll
                for (int k = K - 1; k >= 0; --k) {
                    const unsigned bk = __ballot_sync(FULL, key[k] == mk);
                    if (bk) {
                        kk = k;
                        bal = bk;
                    }
                }
                owner = __ffs(bal) - 1;
            }
            const int32_t e0 = __shfl_sync(FULL, pick(f0, kk), owner);
            const int32_t e1 = __shfl_sync(FULL, pick(f1, kk), owner);
            const int32_t e2 = __shfl_sync(FULL, pick(f2, kk), owner);
            const int32_t e3 = __shfl_sync(FULL, pick(f3, kk), owner);
#pragma unroll
            for (int k = 0; k < K; ++k)
                if (k == kk && lane == owner) key[k] = pr::FREE_KEY;
            long long t1 = 0, t2 = 0, t3 = 0, t4 = 0;
            if (STAMP) t1 = stamp_after(e0 ^ e1 ^ e2 ^ e3, sink);

            // occ: two row loads, issued before anything waits on them
            const int4 xk = load_row(table, (e0 ^ e1) & (nrow - 1), lane);
            const int4 xl = load_row(table, (e2 ^ e3) & (nrow - 1), lane);

            // the lean form's push bookkeeping, which hangs on the pop
            // alone, off the loads' path: the free flags and ranks
            bool fr[K];
            int rank[K];
            if (LEAN) {
#pragma unroll
                for (int k = 0; k < K; ++k) fr[k] = key[k] == pr::FREE_KEY;
                free_ranks(fr, lane, rank);
            }
            if (STAMP) t2 = stamp_after(xk.x ^ xl.x, sink);

            int32_t cnt_k, cnt_l;
            if (LEAN) {
                block_counts(xk, xl, lane, &cnt_k, &cnt_l);
            } else {
                cnt_k = shape_row_count(xk, lane);
                cnt_l = shape_row_count(xl, lane);
            }
            if (STAMP) t3 = stamp_after(cnt_k ^ cnt_l, sink);

            int32_t a, bq;
            pr::shape_expand(e0, e1, cnt_k, cnt_l, &a, &bq);
            if (STAMP) t4 = stamp_after(a ^ bq, sink);

            if (LEAN) {
                // push: the free slot of rank r takes the candidate that
                // lane push_lane(r) worked out, if any (probes.cuh)
                const int32_t nth =
                    pr::push_nth(~(uint32_t)bq & 0x1FFu, lane);
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    const int32_t j =
                        __shfl_sync(FULL, nth, pr::push_lane(rank[k]));
                    if (fr[k] && j < 9) {
                        const int32_t c = pr::wadd(a, j);
                        key[k] = c;
                        f0[k] = c ^ 1;
                        f1[k] = pr::wadd(c, it);
                        f2[k] = pr::wsub(c, 2);
                        f3[k] = pr::wmul(c, 3);
                    }
                }
            } else {
                // push: valid candidate j into the (pref_j + 1)-th free
                // slot
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
            }
            acc += (uint32_t)cnt_k;
            if (STAMP) {
                int32_t all = 0;
#pragma unroll
                for (int k = 0; k < K; ++k)
                    all ^= key[k] ^ f0[k] ^ f1[k] ^ f2[k] ^ f3[k];
                const long long t5 = stamp_after(all, sink);
                // one lane's stores: a store a lane would pick its stage by
                // a divergent branch
                if (lane == 0) {
                    int32_t* at = row + (size_t)it * STAGES;
                    at[0] = (int32_t)(t1 - t0);
                    at[1] = (int32_t)(t2 - t1);
                    at[2] = (int32_t)(t3 - t2);
                    at[3] = (int32_t)(t4 - t3);
                    at[4] = (int32_t)(t5 - t4);
                }
                t0 = t5;
            }
        }
        if (STAMP) {
            const long long c1 = stamp_after((int32_t)acc, sink);
            const long long ns1 = global_ns();
            int32_t c[5];
            const int32_t v = calibrate((int32_t)acc ^ lane, lane, chase, c,
                                        sink);
            if (lane == 0) {
                for (int q = 0; q < 5; ++q) cal[q] = c[q];
                cal[5] = (int32_t)(c1 - c0);
                cal[6] = (int32_t)(ns1 - ns0);
                *sink = v;
            }
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

template <int K, bool LEAN, bool STAMP>
void launch_shape(int blocks, cudaStream_t st, const int32_t* sd, int seed_w,
                  const int4* tab, int nrow, int bb, int iters,
                  uint32_t* out, int32_t* stamps) {
    dfs_shape_kernel<K, LEAN, STAMP><<<blocks, WARPS * 32, 0, st>>>(
        sd, seed_w, tab, nrow, bb, iters, out, stamps);
}

template <bool LEAN>
int launch_form(int s, int blocks, cudaStream_t st, const int32_t* sd,
                int seed_w, const int4* tab, int nrow, int bb, int iters,
                uint32_t* out, int32_t* stamps) {
    if (stamps) {
        if (s != 128) return (int)cudaErrorInvalidValue;
        launch_shape<4, LEAN, true>(blocks, st, sd, seed_w, tab, nrow, bb,
                                    iters, out, stamps);
        return 0;
    }
    switch (s) {
        case 32: launch_shape<1, LEAN, false>(blocks, st, sd, seed_w, tab,
                                              nrow, bb, iters, out, stamps);
                 break;
        case 64: launch_shape<2, LEAN, false>(blocks, st, sd, seed_w, tab,
                                              nrow, bb, iters, out, stamps);
                 break;
        case 96: launch_shape<3, LEAN, false>(blocks, st, sd, seed_w, tab,
                                              nrow, bb, iters, out, stamps);
                 break;
        case 128: launch_shape<4, LEAN, false>(blocks, st, sd, seed_w, tab,
                                               nrow, bb, iters, out, stamps);
                  break;
        default: return (int)cudaErrorInvalidValue;
    }
    return 0;
}

}  // namespace

// C9.  seed: int32 [bb, seed_w] (seed_w >= s); table: int32 [nrow, 128],
// nrow a power of two, 16-byte aligned; s: 32, 64, 96 or 128; lean: 1 the
// lean form, 0 the witness; stamps: null, or int32 [bb, iters * 5 + 8]
// for the stamped form (s 128 only); acc: uint32 [1], zeroed here on the
// stream before the kernel (its blocks add into it).  bb 0 launches no
// kernel.  Returns the first error: cudaErrorInvalidValue for another s
// (nothing done), the memset's, or cudaGetLastError().
extern "C" int nabwa_probe_dfs_shape(const void* seed, int seed_w,
                                     const void* table, int nrow, int bb,
                                     int s, int iters, int lean, void* acc,
                                     void* stamps, void* stream) {
    if (s != 32 && s != 64 && s != 96 && s != 128)
        return (int)cudaErrorInvalidValue;
    if (stamps && s != 128) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t z = cudaMemsetAsync(acc, 0, sizeof(uint32_t), st);
    if (z != cudaSuccess) return (int)z;
    if (bb <= 0) return 0;
    const int blocks = (bb + WARPS - 1) / WARPS;
    const int32_t* sd = (const int32_t*)seed;
    const int4* tab = (const int4*)table;
    uint32_t* out = (uint32_t*)acc;
    int32_t* stp = (int32_t*)stamps;
    const int rc = lean ? launch_form<true>(s, blocks, st, sd, seed_w, tab,
                                            nrow, bb, iters, out, stp)
                        : launch_form<false>(s, blocks, st, sd, seed_w, tab,
                                             nrow, bb, iters, out, stp);
    if (rc) return rc;
    return (int)cudaGetLastError();
}

// C10.  k: int32 [bb, 128]; table: int32 [nrow, 128], nrow a power of
// two, 16-byte aligned; acc: uint32 [1], zeroed here on the stream before
// the kernel.  bb 0 launches no kernel.  Returns the memset's error or
// cudaGetLastError().
extern "C" int nabwa_probe_dfs_pallas(const void* k, const void* table,
                                      int nrow, int bb, int iters, void* acc,
                                      void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t z = cudaMemsetAsync(acc, 0, sizeof(uint32_t), st);
    if (z != cudaSuccess) return (int)z;
    if (bb <= 0) return 0;
    const int blocks = (bb + WARPS - 1) / WARPS;
    dfs_pallas_kernel<<<blocks, WARPS * 32, 0, st>>>(
        (const int32_t*)k, (const int4*)table, nrow, bb, iters,
        (uint32_t*)acc);
    return (int)cudaGetLastError();
}

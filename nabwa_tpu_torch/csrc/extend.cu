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
// job is up to ~100,000 window cells.  bwasw launches most jobs one read
// at a time, so a launch often holds a single job: then nothing but the
// latency of its row chain counts.
//
// Design: a warp per job, so that a row's cells are computed side by side
// and not one after another.  The row state (hd, ev: 2 (L1+2) int32) and
// the target's codes (L1+2 bytes) live in the warp's share of dynamic
// shared memory, and the query's code is fetched a row ahead, so that no
// load from device memory stands on a row's chain.  A row's window goes
// to the 32 lanes, EXTEND_K contiguous cells a lane, in passes of 32
// EXTEND_K cells (one pass at bwasw's band; any band works).  Within a
// row the only chain is F's running max: a lane takes its own max of u,
// the warp an exclusive scan of those with __shfl_up_sync (5 steps),
// carried from pass to pass; hd[i] = h[i-1] takes the left lane's last h
// by shuffle.  Each lane reads and writes only its own cells of the
// state, so one __syncwarp a row orders the rows.  The row's span and best cell are redux.sync minima and
// maxima (the first cell at the maximum: the least index among the lanes
// at the maximum).  Blocks of up to 4 warps, one job each, fewer where
// the state would keep several blocks from sharing an SM; the score
// matrix is staged in shared memory once a block.
//
// A job whose state does not fit in a block's shared memory (L1 above
// ~25,700) keeps it in device memory, contiguous per job ([B, 2, L1+2]):
// the wrapper makes that choice by passing a scratch tensor, and the
// kernel is the same but for where the state lives and the codes are read.

#include <cuda_runtime.h>

#include "extend.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_WARPS = 4;
constexpr int K = nabwa::EXTEND_K;

// a warp's shared memory: hd and ev, then the target's codes as bytes
// (ops/dp.py `extend_smem_bytes` mirrors it)
__host__ __device__ size_t warp_bytes(int L1) {
    return (8 * ((size_t)L1 + 2) + (size_t)L1 + 2 + 15) & ~(size_t)15;
}

template <bool kShared>
__global__ void __launch_bounds__(MAX_WARPS * 32) extend_warp_kernel(
    nabwa::ExtendParams p, const int32_t* __restrict__ s1,
    const int32_t* __restrict__ s2, const int32_t* __restrict__ len1,
    const int32_t* __restrict__ len2, const int32_t* __restrict__ g0,
    const int32_t* __restrict__ bw, int B, int L1, int L2,
    int32_t* __restrict__ scratch, int32_t* __restrict__ score,
    int32_t* __restrict__ end_i, int32_t* __restrict__ end_j,
    int32_t* __restrict__ cells) {
    extern __shared__ __align__(16) uint8_t state_smem[];
    __shared__ int32_t smat[25];
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < 25; ++k) smat[k] = p.mat[k];
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int b = blockIdx.x * (blockDim.x >> 5) + w;
    if (b >= B) return;
    const size_t row = (size_t)L1 + 2;
    int32_t* hd = kShared ? (int32_t*)(state_smem + warp_bytes(L1) * w)
                          : scratch + 2 * row * b;
    int32_t* ev = hd + row;
    // the target's codes: bytes in shared memory, or read where they lie
    uint8_t* s1c = (uint8_t*)(hd + 2 * row);
    const int32_t* s1b = s1 + row * b;
    const int32_t* s2b = s2 + ((size_t)L2 + 1) * b;
    int l1 = len1[b], l2 = len2[b];
    l1 = l1 < 0 ? 0 : (l1 > L1 ? L1 : l1);
    l2 = l2 < 0 ? 0 : (l2 > L2 ? L2 : l2);
    const int32_t bwb = bw[b];
    for (int i = lane; i <= l1 + 1; i += 32) {
        hd[i] = i == 1 ? g0[b] : 0;
        ev[i] = 0;
        if (kShared) s1c[i] = (uint8_t)s1b[i];
    }
    __syncwarp();
    int32_t code = l2 >= 1 ? s2b[1] : 0;     // row j's query code
    int32_t best = 0, bi = 0, bj = 0, n_cells = 0;
    int start = 1, end = 2;
    for (int j = 1; j <= l2; ++j) {
        int sn, en;
        nabwa::extend_window(j, bwb, l1, start, end, &sn, &en);
        if (sn >= en) break;
        const int32_t* sub = smat + 5 * code;
        if (j < l2) code = s2b[j + 1];        // fetched a row ahead
        nabwa::ExtendRowLane red = nabwa::extend_row_lane();
        int32_t t_carry = nabwa::EXTEND_NEGF, h_carry = 0;
        for (int base = sn; base < en; base += 32 * K) {
            int lo;
            const int n = nabwa::extend_lane_cells(base, lane, K, en, &lo);
            nabwa::ExtendChunk<K> c;
            int32_t x = kShared ? nabwa::extend_chunk_load<K>(
                                      p, sub, s1c, hd, ev, lo, n, c)
                                : nabwa::extend_chunk_load<K>(
                                      p, sub, s1b, hd, ev, lo, n, c);
            // inclusive max-scan of the lanes' u maxima, then exclusive
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int32_t y = __shfl_up_sync(FULL, x, d);
                if (lane >= d) x = nabwa::ext_max(x, y);
            }
            int32_t t = __shfl_up_sync(FULL, x, 1);
            t = lane == 0 ? t_carry : nabwa::ext_max(t, t_carry);
            nabwa::extend_chunk_cells<K>(p, sn, lo, n, t, c, red);
            int32_t h_left = __shfl_up_sync(FULL, c.h[K - 1], 1);
            if (lane == 0) h_left = h_carry;
            nabwa::extend_chunk_store<K>(lo, n, en, h_left, c, hd, ev);
            if (base + 32 * K < en) {           // the next pass's carries
                t_carry = nabwa::ext_max(__shfl_sync(FULL, x, 31), t_carry);
                h_carry = __shfl_sync(FULL, c.h[K - 1], 31);
            }
        }
        nabwa::ExtendRowLane all;
        all.first = __reduce_min_sync(FULL, red.first);
        all.last = __reduce_max_sync(FULL, red.last);
        all.best = __reduce_max_sync(FULL, red.best);
        all.arg = __reduce_min_sync(
            FULL, red.best == all.best ? red.arg : 0x7FFFFFFF);
        n_cells += en - sn;
        __syncwarp();                 // the row's writes before its reads
        if (!nabwa::extend_row_end(all, j, &best, &bi, &bj, &start, &end))
            break;
    }
    if (lane == 0) {
        score[b] = best - 1;
        end_i[b] = bi;
        end_j[b] = bj;
        cells[b] = n_cells;
    }
}

// the block's dynamic shared memory cap, set once per process on the
// shared-state kernel (negative: the CUDA error that setting it gave)
int smem_cap() {
    static const int cap = [] {
        int dev = 0, optin = 0;
        cudaFuncAttributes attr = {};
        cudaError_t rc = cudaGetDevice(&dev);
        if (rc == cudaSuccess)
            rc = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (rc == cudaSuccess)
            rc = cudaFuncGetAttributes(&attr, extend_warp_kernel<true>);
        const int bytes = optin - (int)attr.sharedSizeBytes;
        if (rc == cudaSuccess)
            rc = cudaFuncSetAttribute(
                extend_warp_kernel<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        return rc == cudaSuccess ? bytes : -(int)rc;
    }();
    return cap;
}

}  // namespace

// params: q, r, mat[25] (int32).  s1: int32 [B, L1+2], s2: int32
// [B, L2+1], len1/len2/g0/bw: int32 [B], scratch: null to keep each job's
// state in shared memory, else int32 [B, 2, L1+2] in device memory;
// score/end_i/end_j/cells: int32 [B].  Returns cudaGetLastError(), or
// cudaErrorInvalidValue when the state of one job does not fit in shared
// memory and no scratch was given.
extern "C" int nabwa_extend(const int32_t* params, const void* s1,
                            const void* s2, const void* len1,
                            const void* len2, const void* g0, const void* bw,
                            int B, int L1, int L2, void* scratch, void* score,
                            void* end_i, void* end_j, void* cells,
                            void* stream) {
    const nabwa::ExtendParams p = nabwa::extend_params(params);
    const size_t per_warp = warp_bytes(L1);
    int warps = MAX_WARPS;
    size_t smem = 0;
    if (scratch == nullptr) {
        const int cap = smem_cap();
        if (cap < 0) return -cap;
        if (per_warp > (size_t)cap) return (int)cudaErrorInvalidValue;
        while (warps > 1 && warps * per_warp > (size_t)cap / 2) warps >>= 1;
        smem = warps * per_warp;
    }
    const int blocks = (B + warps - 1) / warps;
    const auto kernel = scratch == nullptr ? extend_warp_kernel<true>
                                           : extend_warp_kernel<false>;
    kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
        p, (const int32_t*)s1, (const int32_t*)s2, (const int32_t*)len1,
        (const int32_t*)len2, (const int32_t*)g0, (const int32_t*)bw, B, L1,
        L2, (int32_t*)scratch, (int32_t*)score, (int32_t*)end_i,
        (int32_t*)end_j, (int32_t*)cells);
    return (int)cudaGetLastError();
}

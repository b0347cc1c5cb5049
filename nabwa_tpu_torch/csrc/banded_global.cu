// Kernel C4: batched banded global alignment (aln_global_core,
// stdaln.c:345-525): score, end type and the uint8 traceback lattice of
// samse's gapped refinement (bwa_refine_gapped, bwase.c:356-423), sampe's
// rescue paths and bwasw's cigars.  The backtrace walks the lattice on
// the host.
//
// Replaces nabwa_tpu/ops/dp.py:31 `_banded_global_device`, a jnp lax.scan
// over rows with a cummax for the D chain.
//
// What bounds it on the card: each pair is a chain of len2 dependent rows
// whose band holds the cells the DP needs, ~40 integer operations a cell;
// and the lattice, (L2+1)(L1+1) bytes a pair, every byte written, is what
// leaves the card.  At samse's shapes (L1 ~ 110, L2 ~ 100) a batch of
// thousands of pairs is a few tens of MB of lattice; at bwasw's 1 kb
// cigars ~90 of a row's 1,001 cells lie in the band, and the lattice's
// 268 MB a launch bound it.
//
// Design: a warp per pair, so that a row's cells are computed side by
// side and not one after another.  The previous row's M, I and D (3
// (L1+1) int32) and the reference's codes (bytes) live in the warp's
// share of dynamic shared memory, and the read's code is fetched a row
// ahead, so that no load from device memory stands on a row's chain.
// The columns of a row go to the 32 lanes, DP_K contiguous columns a
// lane, in passes of 32 DP_K.  M and I need only the previous row; the
// left lane's last column (the diagonal, and M for a) comes by
// __shfl_up_sync, so each lane reads and writes only its own columns of
// the state and one __syncwarp a row orders the rows.  D's running max is
// an inclusive max-scan of the lanes' maxima of U (5 shuffles), carried
// from pass to pass.
//
// Which columns: of the two ways to keep 1 kb rows from costing 32 columns
// a lane (a block of warps per pair meeting once a row behind a barrier,
// or a sweep of only the columns whose bits can be nonzero), this kernel
// takes the second.  dp_global.cuh shows that a column outside the hull
// of this row's and the previous row's band, each widened by one to the
// right, has the lattice byte 0 and keeps the state NEG; so a row sweeps
// that hull (one pass at bwasw's cigars) and no barrier is
// needed, while the lattice stays byte-identical with the padded sweep's.
// The whole row goes out from a staging buffer in shared memory: the
// swept bytes are written there (the rest stays 0), placed at the row's
// address mod 16, so that lanes store 16 aligned bytes each (bytes at the
// row's two ends one by one), and the swept bytes are cleared again.
// Rows past len2 and row 0 are the zero buffer copied out.  Blocks of up
// to 4 warps, one pair each; the score matrix is staged once a block.
//
// A pair whose state and row do not fit in a block's shared memory (L1
// above ~16,500) keeps the state in device memory, contiguous per pair
// ([B, 3, L1+1]), and writes its lattice bytes directly: the wrapper
// makes that choice by passing a scratch tensor.

#include <cuda_runtime.h>

#include "dp_global.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_WARPS = 4;
constexpr int K = nabwa::DP_K;

__host__ __device__ size_t round16(size_t n) { return (n + 15) & ~(size_t)15; }

// a warp's shared memory: the state, the staged lattice row, then the
// reference's codes as bytes (ops/dp.py `global_smem_bytes` mirrors it)
__host__ __device__ size_t state_bytes(int L1) {
    return round16(3 * ((size_t)L1 + 1) * sizeof(int32_t));
}

__host__ __device__ size_t stage_bytes(int L1) {
    return round16((size_t)L1 + 1 + 16);
}

__host__ __device__ size_t warp_bytes(int L1) {
    return state_bytes(L1) + stage_bytes(L1) + round16((size_t)L1 + 1);
}

// The row staged at stg[off .. off + n) out to dst (dst - off 16-aligned):
// the whole 16-byte chunks a lane at a time, the bytes of the first and
// the last chunk, where they are partial, one a lane (lanes 0-15 and
// 16-31).
__device__ __forceinline__ void copy_row(const uint8_t* stg, int off,
                                         uint8_t* dst, int n, int lane) {
    uint8_t* base = dst - off;
    const int end = off + n;
    const int first = off ? 1 : 0, last = end >> 4;
    // (not unrolled: unrolled, these short strided loops made ptxas
    // spill)
#pragma unroll 1
    for (int c = first + lane; c < last; c += 32)
        *(uint4*)(base + (c << 4)) = *(const uint4*)(stg + (c << 4));
    const int x = (lane < 16 ? 0 : last << 4) + (lane & 15);
    if (x >= off && x < end && (x < 16 * first || x >= last << 4))
        base[x] = stg[x];
}

template <bool kShared>
__global__ void __launch_bounds__(MAX_WARPS * 32) banded_global_warp_kernel(
    nabwa::DpParams p, const int32_t* __restrict__ s1,
    const int32_t* __restrict__ s2, const int32_t* __restrict__ len1,
    const int32_t* __restrict__ len2, const int32_t* __restrict__ b1,
    const int32_t* __restrict__ b2, int B, int L1, int L2,
    int32_t* __restrict__ scratch, uint8_t* __restrict__ tb,
    int32_t* __restrict__ score, int32_t* __restrict__ ctype) {
    extern __shared__ __align__(16) uint8_t warp_smem[];
    __shared__ int32_t smat[25];
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < 25; ++k) smat[k] = p.mat[k];
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int b = blockIdx.x * (blockDim.x >> 5) + w;
    if (b >= B) return;
    const size_t W = (size_t)L1 + 1;
    uint8_t* mine = warp_smem + warp_bytes(L1) * w;
    int32_t* M = kShared ? (int32_t*)mine : scratch + 3 * W * b;
    int32_t* I = M + W;
    int32_t* D = I + W;
    uint8_t* stg = mine + state_bytes(L1);
    uint8_t* s1c = stg + stage_bytes(L1);
    const int32_t* s1b = s1 + W * b;
    const int32_t* s2b = s2 + ((size_t)L2 + 1) * b;
    uint8_t* tbp = tb + ((size_t)L2 + 1) * W * b;
    const int l1 = len1[b], l2 = len2[b], bb1 = b1[b], bb2 = b2[b];
    // row 0 (stdaln.c:393-399): M[0,0] = 0, D from M[0,0] over 1..b1-1
    for (int i = lane; i <= L1; i += 32) {
        M[i] = i == 0 ? 0 : nabwa::DP_NEG;
        I[i] = nabwa::DP_NEG;
        D[i] = (i >= 1 && i <= bb1 - 1) ? -p.go - p.gend * i : nabwa::DP_NEG;
        if (kShared) s1c[i] = (uint8_t)s1b[i];
    }
    if (kShared) {
        for (size_t x = (size_t)lane * 16; x < stage_bytes(L1); x += 32 * 16)
            *(uint4*)(stg + x) = make_uint4(0, 0, 0, 0);
    }
    __syncwarp();
    int32_t code = l2 >= 1 && L2 >= 1 ? s2b[1] : 0;   // row j's read code
    // the band of the row before (row 0's non-NEG columns)
    int plo = 0, phi = bb1 - 1 > 0 ? bb1 - 1 : 0;
#pragma unroll 1
    for (int j = 0; j <= L2; ++j) {
        uint8_t* dst = tbp + (size_t)j * W;
        const int off = (int)((uintptr_t)dst & 15);
        if (j == 0 || j > l2) {                  // a zero row
            if (kShared) {
                copy_row(stg, off, dst, (int)W, lane);
            } else {
                for (int i = lane; i <= L1; i += 32) dst[i] = 0;
            }
            continue;
        }
        const nabwa::DpRow r = nabwa::dp_row(p, l1, l2, bb1, bb2, j);
        int c0, c1;
        nabwa::dp_sweep(p, L1, r.start, r.end, plo, phi, &c0, &c1);
        plo = r.start;
        phi = r.end;
        const int32_t* sub = smat + 5 * code;
        if (j < l2 && j < L2) code = s2b[j + 1];   // fetched a row ahead
        int32_t pm_c = nabwa::DP_NEG, pi_c = nabwa::DP_NEG,
                pd_c = nabwa::DP_NEG, m_c = nabwa::DP_NEG,
                t_c = nabwa::DP_NEG;
#pragma unroll 1
        for (int base = c0; base <= c1; base += 32 * K) {
            int lo;
            const int n = nabwa::dp_lane_cells(base, lane, K, c1, &lo);
            nabwa::DpChunk<K> c;
            nabwa::dp_chunk_load<K>(M, I, D, lo, n, c);
            int32_t pm = __shfl_up_sync(FULL, c.mp[K - 1], 1);
            int32_t pi = __shfl_up_sync(FULL, c.ip[K - 1], 1);
            int32_t pd = __shfl_up_sync(FULL, c.dp[K - 1], 1);
            if (lane == 0) {
                pm = pm_c;
                pi = pi_c;
                pd = pd_c;
            }
            if (kShared)
                nabwa::dp_chunk_mi<K>(p, r, sub, s1c, lo, n, pm, pi, pd, c);
            else
                nabwa::dp_chunk_mi<K>(p, r, sub, s1b, lo, n, pm, pi, pd, c);
            int32_t m_left = __shfl_up_sync(FULL, c.m[K - 1], 1);
            if (lane == 0) m_left = m_c;
            int32_t x = nabwa::dp_chunk_u<K>(p, r, lo, n, m_left, c);
            // inclusive max-scan of the lanes' U maxima, then exclusive
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int32_t y = __shfl_up_sync(FULL, x, d);
                if (lane >= d) x = nabwa::dp_max(x, y);
            }
            int32_t t = __shfl_up_sync(FULL, x, 1);
            t = lane == 0 ? t_c : nabwa::dp_max(t, t_c);
            nabwa::dp_chunk_d<K>(r, lo, t, c);
            nabwa::dp_chunk_store<K>(lo, n, c, M, I, D);
#pragma unroll
            for (int k = 0; k < K; ++k) {
                if (k < n) {
                    if (kShared)
                        stg[off + lo + k] = (uint8_t)c.bits[k];
                    else
                        dst[lo + k] = (uint8_t)c.bits[k];
                }
            }
            if (base + 32 * K <= c1) {          // the next pass's carries
                pm_c = __shfl_sync(FULL, c.mp[K - 1], 31);
                pi_c = __shfl_sync(FULL, c.ip[K - 1], 31);
                pd_c = __shfl_sync(FULL, c.dp[K - 1], 31);
                m_c = __shfl_sync(FULL, c.m[K - 1], 31);
                t_c = nabwa::dp_max(__shfl_sync(FULL, x, 31), t_c);
            }
        }
        if (kShared) {
            __syncwarp();
            copy_row(stg, off, dst, (int)W, lane);
            __syncwarp();
#pragma unroll 1
            for (int i = c0 + lane; i <= c1; i += 32) stg[off + i] = 0;
        } else {
            for (int i = lane; i <= L1; i += 32)
                if (i < c0 || i > c1) dst[i] = 0;
        }
        __syncwarp();                 // the row's writes before its reads
    }
    if (lane == 0) {
        // the end cell (len2, len1): the state is frozen past row len2
        const int e = l1 < 0 ? 0 : (l1 > L1 ? L1 : l1);
        nabwa::dp_end_cell(M[e], I[e], D[e], score + b, ctype + b);
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
            rc = cudaFuncGetAttributes(&attr,
                                       banded_global_warp_kernel<true>);
        const int bytes = optin - (int)attr.sharedSizeBytes;
        if (rc == cudaSuccess)
            rc = cudaFuncSetAttribute(
                banded_global_warp_kernel<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        return rc == cudaSuccess ? bytes : -(int)rc;
    }();
    return cap;
}

}  // namespace

// params: go, ge, gap_end, mat[25] (int32).  s1: int32 [B, L1+1], s2:
// int32 [B, L2+1], len1/len2/b1/b2: int32 [B], scratch: null to keep each
// pair's state and lattice row in shared memory, else int32 [B, 3, L1+1]
// in device memory; tb: uint8 [B, L2+1, L1+1], score/ctype: int32 [B].
// Returns cudaGetLastError(), or cudaErrorInvalidValue when one pair's
// state and row do not fit in shared memory and no scratch was given.
extern "C" int nabwa_banded_global(const int32_t* params, const void* s1,
                                   const void* s2, const void* len1,
                                   const void* len2, const void* b1,
                                   const void* b2, int B, int L1, int L2,
                                   void* scratch, void* tb, void* score,
                                   void* ctype, void* stream) {
    const nabwa::DpParams p = nabwa::dp_params(params);
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
    const auto kernel = scratch == nullptr ? banded_global_warp_kernel<true>
                                           : banded_global_warp_kernel<false>;
    kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
        p, (const int32_t*)s1, (const int32_t*)s2, (const int32_t*)len1,
        (const int32_t*)len2, (const int32_t*)b1, (const int32_t*)b2, B, L1,
        L2, (int32_t*)scratch, (uint8_t*)tb, (int32_t*)score,
        (int32_t*)ctype);
    return (int)cudaGetLastError();
}

// Kernel C5: batched forward pass of the local Smith-Waterman alignment
// (aln_local_core, stdaln.c:556-637): the best score and its end cell for
// each (reference window, read) job of sampe's mate rescue
// (bwa_paired_sw1, bwape.c:519-633).  The host runs the short banded
// reverse pass and recovers the path through kernel C4.
//
// Replaces nabwa_tpu/ops/dp.py:404 `_local_fwd_device`, a jnp lax.scan
// over rows with a cummax for the F chain.
//
// What bounds it on the card: each job is a chain of len2 dependent rows
// of len1 cells, 23 integer operations a cell (local_sw.cuh's serial inner
// loop, loads and stores not counted); the inputs are a few hundred bytes
// a job and the outputs 12 bytes, so the work is integer operations, not
// bytes.  At rescue shapes (windows of ~6 std + 2 read lengths, ~380 bp,
// against 100 bp reads) a job is ~38,000 cells.
//
// Design: a warp per job, so that a row's cells are computed side by side
// and not one after another.  Lane l owns K contiguous columns of the
// window, [1 + l K, 1 + (l+1) K), and keeps their h and e and its window
// codes (bytes, four a register) in registers for the whole job: no row
// state touches memory.  K is a template parameter, the smallest of 2, 4,
// 8, 16 whose 32 lanes cover the batch's widest window (the launch's L1),
// so windows up to 512 columns take this form.  A row is: hd of
// the lane's first column, the left lane's last h of the row before, by
// one __shfl_up_sync taken before the lane overwrites it; e and the pre-F
// h of the lane's cells; F's running max as an exclusive max-scan of the
// lanes' maxima of u (5 shuffles); h and the lane's best cell.  The read's
// code of the next row is fetched a row ahead and the 5x5 matrix sits in
// shared memory.  At the end one warp reduction takes the largest score
// and, among the lanes at it, the least (j, i): the first row-major cell at
// the maximum, as the serial scan finds it.  Blocks of 4 warps, one job a
// warp.
//
// Wider windows run the same lane functions in passes of 32 LOCAL_K_WIDE
// columns, the row's h and e (and the codes, as bytes) in the warp's share
// of shared memory, or in device memory ([B, 2, L1+1]) when one job's do
// not fit there: the wrapper asks `nabwa_local_form` (local_sw.cuh
// `local_form`) and passes a scratch tensor for the latter.  Each lane
// reads and writes only its own columns of the state, so the rows need no
// barrier; the left neighbour's h of the row before and the scan's carry
// cross from pass to pass through lane 31.

#include <cuda_runtime.h>

#include "local_sw.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 4;
constexpr int KW = nabwa::LOCAL_K_WIDE;

// a lane's window codes in registers, four bytes a word
template <int K>
struct PackedCodes {
    uint32_t w[(K + 3) / 4];
    __host__ __device__ __forceinline__ int32_t operator[](int k) const {
        return (int32_t)((w[k >> 2] >> ((k & 3) * 8)) & 0xFFu);
    }
};

// a job's window codes in the wide form: bytes in shared memory, or the
// int32 input where the state lies in device memory
template <class T>
struct CodesAt {
    const T* p;
    __host__ __device__ __forceinline__ int32_t operator[](int k) const {
        return (int32_t)p[k];
    }
};

__device__ __forceinline__ void stage_matrix(const nabwa::LocalParams& p,
                                             int32_t* smat) {
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < 25; ++k) smat[k] = p.mat[k];
    }
    __syncthreads();
}

// F's carry-in of each lane: the inclusive max-scan of the lanes' u maxima
// x (returned in x), shifted by one lane; lane 0 takes `carry`.
__device__ __forceinline__ int32_t scan_carry(int lane, int32_t& x,
                                              int32_t carry) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(FULL, x, d);
        if (lane >= d) x = nabwa::lsw_max(x, y);
    }
    const int32_t t = __shfl_up_sync(FULL, x, 1);
    return lane == 0 ? carry : nabwa::lsw_max(t, carry);
}

// the warp's answer: the largest score, then the least (j, i) among the
// lanes at it; lane 0 writes it
__device__ __forceinline__ void write_best(int lane, const nabwa::LocalBest& b,
                                           int job, int32_t* score,
                                           int32_t* end_i, int32_t* end_j) {
    const int32_t best = __reduce_max_sync(FULL, b.best);
    const int32_t bj = (int32_t)__reduce_min_sync(
        FULL, b.best == best ? (uint32_t)b.bj : 0xFFFFFFFFu);
    const int32_t bi = (int32_t)__reduce_min_sync(
        FULL, b.best == best && b.bj == bj ? (uint32_t)b.bi : 0xFFFFFFFFu);
    if (lane == 0) {
        score[job] = best;
        end_i[job] = bi;
        end_j[job] = bj;
    }
}

// the register form: the lane's K columns of the window in registers
template <int K>
__global__ void __launch_bounds__(WARPS * 32) local_fwd_warp_kernel(
    nabwa::LocalParams p, const int32_t* __restrict__ s1,
    const int32_t* __restrict__ s2, const int32_t* __restrict__ len1,
    const int32_t* __restrict__ len2, int B, int L1, int L2,
    int32_t* __restrict__ score, int32_t* __restrict__ end_i,
    int32_t* __restrict__ end_j) {
    __shared__ int32_t smat[25];
    stage_matrix(p, smat);
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= B) return;
    int l1 = len1[b], l2 = len2[b];
    l1 = l1 < 0 ? 0 : (l1 > L1 ? L1 : l1);
    l2 = l2 < 0 ? 0 : (l2 > L2 ? L2 : l2);
    const int32_t* s2b = s2 + ((size_t)L2 + 1) * b;
    const int lo = 1 + lane * K;
    const int left = l1 - lane * K;         // window columns from lo on
    const int n = left < 0 ? 0 : (left > K ? K : left);
    PackedCodes<K> code;
    nabwa::LocalChunk<K> c;
#pragma unroll
    for (int k = 0; k < (K + 3) / 4; ++k) code.w[k] = 0;
    const int32_t* s1b = s1 + ((size_t)L1 + 1) * b + lo;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        c.h[k] = c.e[k] = 0;
        if (k < n)
            code.w[k >> 2] |= ((uint32_t)s1b[k] & 0xFFu) << ((k & 3) * 8);
    }
    nabwa::LocalBest best = nabwa::local_best();
    int32_t next = l2 >= 1 ? s2b[1] : 0;      // row j's read code
    for (int j = 1; j <= l2; ++j) {
        const int32_t* sub = smat + 5 * next;
        if (j < l2) next = s2b[j + 1];         // fetched a row ahead
        int32_t hd_in = __shfl_up_sync(FULL, c.h[K - 1], 1);
        if (lane == 0) hd_in = 0;
        int32_t x = nabwa::local_chunk_pre<K>(p, sub, code, lo, n, hd_in, c);
        const int32_t t = scan_carry(lane, x, nabwa::LOCAL_NEGF);
        nabwa::local_chunk_cells<K>(p, j, lo, n, t, c, best);
    }
    write_best(lane, best, b, score, end_i, end_j);
}

// the wide form: the row's h and e in shared or device memory, each row in
// passes of 32 KW columns
template <bool kShared>
__global__ void __launch_bounds__(WARPS * 32) local_fwd_wide_kernel(
    nabwa::LocalParams p, const int32_t* __restrict__ s1,
    const int32_t* __restrict__ s2, const int32_t* __restrict__ len1,
    const int32_t* __restrict__ len2, int B, int L1, int L2,
    int32_t* __restrict__ scratch, int32_t* __restrict__ score,
    int32_t* __restrict__ end_i, int32_t* __restrict__ end_j) {
    extern __shared__ __align__(16) uint8_t state_smem[];
    __shared__ int32_t smat[25];
    stage_matrix(p, smat);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int b = blockIdx.x * (blockDim.x >> 5) + w;
    if (b >= B) return;
    const size_t row = (size_t)L1 + 1;
    int32_t* h = kShared ? (int32_t*)(state_smem
                                      + nabwa::local_wide_bytes(L1) * w)
                         : scratch + 2 * row * b;
    int32_t* e = h + row;
    uint8_t* s1c = (uint8_t*)(h + 2 * row);
    const int32_t* s1b = s1 + row * b;
    const int32_t* s2b = s2 + ((size_t)L2 + 1) * b;
    int l1 = len1[b], l2 = len2[b];
    l1 = l1 < 0 ? 0 : (l1 > L1 ? L1 : l1);
    l2 = l2 < 0 ? 0 : (l2 > L2 ? L2 : l2);
    for (int i = lane; i <= l1; i += 32) {
        h[i] = e[i] = 0;
        if (kShared) s1c[i] = (uint8_t)s1b[i];
    }
    __syncwarp();
    nabwa::LocalBest best = nabwa::local_best();
    int32_t next = l2 >= 1 ? s2b[1] : 0;
    for (int j = 1; j <= l2; ++j) {
        const int32_t* sub = smat + 5 * next;
        if (j < l2) next = s2b[j + 1];
        int32_t t_carry = nabwa::LOCAL_NEGF, hd_carry = 0;
        for (int base = 1; base <= l1; base += 32 * KW) {
            const int lo = base + lane * KW;
            const int left = l1 + 1 - lo;
            const int n = left < 0 ? 0 : (left > KW ? KW : left);
            nabwa::LocalChunk<KW> c;
#pragma unroll
            for (int k = 0; k < KW; ++k) {
                c.h[k] = k < n ? h[lo + k] : 0;
                c.e[k] = k < n ? e[lo + k] : 0;
            }
            // row j-1's h left of the lane's cells, and of the next pass's
            int32_t hd_in = __shfl_up_sync(FULL, c.h[KW - 1], 1);
            if (lane == 0) hd_in = hd_carry;
            hd_carry = __shfl_sync(FULL, c.h[KW - 1], 31);
            int32_t x;
            if (kShared)
                x = nabwa::local_chunk_pre<KW>(
                    p, sub, CodesAt<uint8_t>{s1c + lo}, lo, n, hd_in, c);
            else
                x = nabwa::local_chunk_pre<KW>(
                    p, sub, CodesAt<int32_t>{s1b + lo}, lo, n, hd_in, c);
            const int32_t t = scan_carry(lane, x, t_carry);
            t_carry = nabwa::lsw_max(t_carry, __shfl_sync(FULL, x, 31));
            nabwa::local_chunk_cells<KW>(p, j, lo, n, t, c, best);
#pragma unroll
            for (int k = 0; k < KW; ++k) {
                if (k < n) {
                    h[lo + k] = c.h[k];
                    e[lo + k] = c.e[k];
                }
            }
        }
    }
    write_best(lane, best, b, score, end_i, end_j);
}

// the wide kernel's dynamic shared memory cap, set once per process
// (negative: the CUDA error that setting it gave)
int smem_cap() {
    static const int cap = [] {
        int dev = 0, optin = 0;
        cudaFuncAttributes attr = {};
        cudaError_t rc = cudaGetDevice(&dev);
        if (rc == cudaSuccess)
            rc = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (rc == cudaSuccess)
            rc = cudaFuncGetAttributes(&attr, local_fwd_wide_kernel<true>);
        const int bytes = optin - (int)attr.sharedSizeBytes;
        if (rc == cudaSuccess)
            rc = cudaFuncSetAttribute(
                local_fwd_wide_kernel<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        return rc == cudaSuccess ? bytes : -(int)rc;
    }();
    return cap;
}

template <int K>
void launch_warp(const nabwa::LocalParams& p, const void* s1, const void* s2,
                 const void* len1, const void* len2, int B, int L1, int L2,
                 void* score, void* end_i, void* end_j, cudaStream_t stream) {
    const int blocks = (B + WARPS - 1) / WARPS;
    local_fwd_warp_kernel<K><<<blocks, WARPS * 32, 0, stream>>>(
        p, (const int32_t*)s1, (const int32_t*)s2, (const int32_t*)len1,
        (const int32_t*)len2, B, L1, L2, (int32_t*)score, (int32_t*)end_i,
        (int32_t*)end_j);
}

}  // namespace

// C5's form at L1 columns with at most smem_budget bytes of shared memory
// a warp (local_sw.cuh `local_form`): form[0] LOCAL_REGISTERS,
// LOCAL_SHARED or LOCAL_DEVICE, form[1] the cells a lane.  The caller
// passes nabwa_local_fwd a scratch tensor for LOCAL_DEVICE.
extern "C" int nabwa_local_form(int L1, int smem_budget, int* form) {
    form[0] = nabwa::local_form(L1, smem_budget < 0 ? 0 : smem_budget,
                                form + 1);
    return 0;
}

// params: q, r, mat[25] (int32).  s1: int32 [B, L1+1], s2: int32
// [B, L2+1], len1/len2: int32 [B], score/end_i/end_j: int32 [B].  The form
// follows L1: registers up to 32 LOCAL_K_MAX columns, else the wide form
// with the state in shared memory (scratch null) or in device memory
// (scratch int32 [B, 2, L1+1]).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue when a wide job's state does not fit in shared
// memory and no scratch was given.
extern "C" int nabwa_local_fwd(const int32_t* params, const void* s1,
                               const void* s2, const void* len1,
                               const void* len2, int B, int L1, int L2,
                               void* scratch, void* score, void* end_i,
                               void* end_j, void* stream) {
    const nabwa::LocalParams p = nabwa::local_params(params);
    const cudaStream_t st = (cudaStream_t)stream;
    switch (nabwa::local_lane_k(L1)) {
    case 2:
        launch_warp<2>(p, s1, s2, len1, len2, B, L1, L2, score, end_i, end_j,
                       st);
        return (int)cudaGetLastError();
    case 4:
        launch_warp<4>(p, s1, s2, len1, len2, B, L1, L2, score, end_i, end_j,
                       st);
        return (int)cudaGetLastError();
    case 8:
        launch_warp<8>(p, s1, s2, len1, len2, B, L1, L2, score, end_i, end_j,
                       st);
        return (int)cudaGetLastError();
    case 16:
        launch_warp<16>(p, s1, s2, len1, len2, B, L1, L2, score, end_i,
                        end_j, st);
        return (int)cudaGetLastError();
    default:
        break;
    }
    const size_t per_warp = nabwa::local_wide_bytes(L1);
    int warps = WARPS;
    size_t smem = 0;
    if (scratch == nullptr) {
        const int cap = smem_cap();
        if (cap < 0) return -cap;
        if (per_warp > (size_t)cap) return (int)cudaErrorInvalidValue;
        while (warps > 1 && warps * per_warp > (size_t)cap / 2) warps >>= 1;
        smem = warps * per_warp;
    }
    const int blocks = (B + warps - 1) / warps;
    const auto kernel = scratch == nullptr ? local_fwd_wide_kernel<true>
                                           : local_fwd_wide_kernel<false>;
    kernel<<<blocks, warps * 32, smem, st>>>(
        p, (const int32_t*)s1, (const int32_t*)s2, (const int32_t*)len1,
        (const int32_t*)len2, B, L1, L2, (int32_t*)scratch, (int32_t*)score,
        (int32_t*)end_i, (int32_t*)end_j);
    return (int)cudaGetLastError();
}

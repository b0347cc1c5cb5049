// Kernels C15-C19: probes 2, 3, 4, 4b and 4c of scripts/probe_pallas.py,
// the SMEM-indexed row load, the popcount, the two while-loop carries and
// the 60-op body.  All values are int32 and wrap as jnp's do (probes.cuh).
//
// C15 replaces `probe_smem_idx` (:61, pallas_call :73): out[i] =
// table[idx[i]] for idx int32 [BB] (the TPU kernel's SMEM block) and a
// table of 128-word int32 rows (BB = 256 rows from [4096, 128]).  Bound by
// bytes, as C7 (probe_rowload.cu): the 4 B indices, the distinct rows read
// once and the rows written; no arithmetic.  The geometry is C7's, a warp
// a row, 16 B a lane, blocks of 4 warps, so C15 differs from C7 only where
// the index comes from, which is the probe's question: the block's first
// warp reads the block's indices into shared memory in one coalesced load
// (the SMEM block spec), then `__syncthreads()`, then each warp reads its
// row's index from shared memory (a broadcast) and copies the row.  Every
// index must lie in [0, rows of the table), as for C7; the TPU kernel does
// not check it either.
//
// C16 replaces `probe_popcount` (:91, pallas_call :97): the set bits of
// each int32 of [256, 128], the sign bit included.  Bound by bytes (128 KB
// read, 128 KB written); one popcount a word.  Elementwise, 16 B a thread.
//
// C17 replaces `probe_while_scratch` (:115, pallas_call :136): 50 rounds
// over a pool int32 [256, 128] of: m = each row's minimum; every slot equal
// to it gets + 7; the scalar carry acc += the sum of the 256 minima; the
// result is acc, [1, 1].  C18 replaces `probe_while_vector_only` (:155,
// pallas_call :174): the same rounds with no scalar carry; each row's
// minima are summed into a vector accumulator, so the result [256, 128]
// holds in every column of a row the sum of that row's 50 minima.  Both
// are bound by operations: per slot and round 4 (its part of the row's
// minimum, the compare, the add, the select), per row and round 1 (the
// minimum's add into the carry or the row's sum); the bytes (the pool in,
// C18's result out) come below.  Each has two forms.
// - The grid form (`probe_while_*_grid_kernel`, the probe's route).  A
//   row's minimum, its + 7 update and its sum of minima never read another
//   row; only C17's carry joins the rows, and a sum that wraps mod 2^32 is
//   the same in any order, so it can be taken once, after the rounds.  So
//   a row is one warp, lane l holding slots 4 l .. 4 l + 3 (one int4) in
//   registers, and a round is the lane's minimum, one redux.sync, then
//   `while_lane_round` (probes.cuh): the 4 keys against the minimum and
//   its add into the row's sum.  A row's path is one load and 50 rounds of
//   two minima, a redux.sync, a compare and a select; the 256 warps run
//   side by side over the card.  The warps a block are the launch's
//   argument (the wrappers' are the fastest of those timed, PERF.md).
//   C18's lanes write make_int4(s, s, s, s).  C17's grid is one thread
//   block cluster of 256 / warps blocks (16 at most, past 8 a size the
//   card allows only on request), so that the carry is summed in the same
//   launch, with nothing to zero first and nothing shared with another
//   launch: each warp's lane 0 stores its row's sum into block 0's shared
//   memory (distributed shared memory), the cluster's barrier orders those
//   stores before block 0's first warp reads the 256 sums, adds them and
//   writes out[0].  A block may write into block 0 only once every block
//   of the cluster has started, so a first barrier phase is armed at the
//   start and waited on only after the rounds, off their path.
// - The witness (`probe_while_*_kernel`, the first design): one block of
//   1024 threads holds the whole pool, as the TPU kernel's one core does:
//   a warp has 8 rows and a lane 4 slots of each (one int4 of the row), 32
//   keys in registers.  A round takes the rows in turn: a row's warp-
//   shuffle minimum, then `while_step` on its slots (one minimum live at a
//   time).  C17 then adds the warp's 8 minima (uint32, so it wraps as jnp
//   does), lane 0 stores that partial in shared memory (double-buffered by
//   the round's parity, so one `__syncthreads()` a round suffices), and
//   warp 0 sums the 32 partials into the carry with one warp reduction: a
//   block-wide reduction every round, the probe's question as the script
//   asked it of one core.  C18 keeps each row's sum in registers and has
//   no cross-warp step.  C18's 8 row sums bring it to the 64-register cap
//   of 1024 threads: ptxas keeps two of them in local memory (16 bytes, a
//   load and a store of each a round, from L1), which ran faster than
//   keeping each row's sum in one lane or in shared memory.  Both stay
//   beside the grid forms, timed in the same run: the witnesses' C17 over
//   C18 is the price of 50 block-wide sums on one SM, the grid forms' the
//   price of one sum at the end.
//
// C19 replaces `probe_body_scale` (:193, pallas_call :213): 50 rounds of
// 20 steps over x int32 [256, 128], step j being `body_step` (probes.cuh):
// p = where((p & 7) == j % 8, p + j, p); p ^= p >> 3; p += p << 1.  Bound
// by operations: 8 an element and step (the and, the compare, the add and
// the select; the shift and the xor; the shift and the add), 262,144,000
// in all, against 256 KB of bytes.  Every element is its own chain of
// 1,000 dependent steps, so one thread an element with its value in a
// register, the 20 steps unrolled (j and j % 8 constants), the 50 rounds
// a loop; device memory is read and written once.  Blocks of 128 threads,
// 256 blocks over the 132 SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "probes.cuh"

namespace {

namespace pr = nabwa::probe;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 4;
constexpr int POPC_THREADS = 256;
constexpr int WHILE_ROWS = 256;            // scripts/probe_pallas.py BB
constexpr int WHILE_ITERS = 50;            // its rounds (:122, :169)
constexpr int WHILE_THREADS = 1024;
constexpr int WHILE_WARPS = WHILE_THREADS / 32;
constexpr int ROWS_PER_WARP = WHILE_ROWS / WHILE_WARPS;
constexpr int SLOTS_PER_LANE = 4;          // S = 128, one int4 a lane
static_assert(WHILE_WARPS == 32, "warp 0 sums one partial a lane");
constexpr int WHILE_GRID_MAX_WARPS = 8;    // C18's grid form's largest block
constexpr int WHILE_MAX_CLUSTER = 16;      // C17's grid: one cluster
constexpr int WHILE_PORTABLE_CLUSTER = 8;
constexpr int BODY_THREADS = 128;
constexpr int BODY_ROUNDS = 50;            // scripts/probe_pallas.py:208
constexpr int BODY_STEPS = 20;             // its inner loop (:201)

__global__ void __launch_bounds__(WARPS * 32)
probe_smem_idx_kernel(const int32_t* __restrict__ idx,
                      const int4* __restrict__ table, int bb,
                      int4* __restrict__ out) {
    __shared__ int32_t s_idx[WARPS];
    const int base = blockIdx.x * WARPS;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < WARPS && base + (int)threadIdx.x < bb)
        s_idx[threadIdx.x] = idx[base + threadIdx.x];
    __syncthreads();
    const int row = base + warp;
    if (row >= bb) return;
    const int32_t r = s_idx[warp];
    out[(size_t)row * 32 + lane] = table[(size_t)r * 32 + lane];
}

__global__ void __launch_bounds__(POPC_THREADS)
probe_popcount_kernel(const int32_t* __restrict__ x, long long n,
                      int32_t* __restrict__ out) {
    const long long i =
        4 * ((long long)blockIdx.x * POPC_THREADS + threadIdx.x);
    if (i + 4 <= n) {
        const int4 v = *(const int4*)(x + i);
        int4 o;
        o.x = (int32_t)pr::popcount32(v.x);
        o.y = (int32_t)pr::popcount32(v.y);
        o.z = (int32_t)pr::popcount32(v.z);
        o.w = (int32_t)pr::popcount32(v.w);
        *(int4*)(out + i) = o;
    } else {
        for (long long k = i; k < n; ++k)
            out[k] = (int32_t)pr::popcount32(x[k]);
    }
}

// the warp's 8 rows of the pool: row warp * ROWS_PER_WARP + r, slots
// 4 lane .. 4 lane + 3
__device__ __forceinline__ void load_pool(
        const int4* __restrict__ x, int warp, int lane,
        int32_t key[ROWS_PER_WARP][SLOTS_PER_LANE]) {
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int4 v = x[(size_t)(warp * ROWS_PER_WARP + r) * 32 + lane];
        key[r][0] = v.x;
        key[r][1] = v.y;
        key[r][2] = v.z;
        key[r][3] = v.w;
    }
}

// one round on the warp's rows, row by row (one minimum live at a time):
// the row's minimum m, every slot equal to it + 7, then add(r, m)
template <class Add>
__device__ __forceinline__ void while_round(
        int32_t key[ROWS_PER_WARP][SLOTS_PER_LANE], Add add) {
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int32_t lm = min(min(key[r][0], key[r][1]),
                               min(key[r][2], key[r][3]));
        const int32_t m = __reduce_min_sync(FULL, lm);
#pragma unroll
        for (int k = 0; k < SLOTS_PER_LANE; ++k)
            key[r][k] = pr::while_step(key[r][k], m);
        add(r, m);
    }
}

__global__ void __launch_bounds__(WHILE_THREADS)
probe_while_scratch_kernel(const int4* __restrict__ x,
                           int32_t* __restrict__ out) {
    __shared__ uint32_t partial[2][WHILE_WARPS];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    int32_t key[ROWS_PER_WARP][SLOTS_PER_LANE];
    load_pool(x, warp, lane, key);
    uint32_t acc = 0;
#pragma unroll 1
    for (int it = 0; it < WHILE_ITERS; ++it) {
        uint32_t s = 0;
        while_round(key, [&](int, int32_t m) { s += (uint32_t)m; });
        const int par = it & 1;
        if (lane == 0) partial[par][warp] = s;
        __syncthreads();
        if (warp == 0) acc += __reduce_add_sync(FULL, partial[par][lane]);
    }
    if (threadIdx.x == 0) out[0] = (int32_t)acc;
}

__global__ void __launch_bounds__(WHILE_THREADS)
probe_while_vector_kernel(const int4* __restrict__ x,
                          int4* __restrict__ out) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    int32_t key[ROWS_PER_WARP][SLOTS_PER_LANE];
    load_pool(x, warp, lane, key);
    uint32_t sum[ROWS_PER_WARP] = {};
#pragma unroll 1
    for (int it = 0; it < WHILE_ITERS; ++it)
        while_round(key, [&](int r, int32_t m) { sum[r] += (uint32_t)m; });
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int32_t s = (int32_t)sum[r];
        out[(size_t)(warp * ROWS_PER_WARP + r) * 32 + lane] =
            make_int4(s, s, s, s);
    }
}

// the grid form's row (warp `row` of the grid, lane `lane`): its 50
// rounds with its 4 keys in registers; returns the row's sum of minima
__device__ __forceinline__ uint32_t while_row(const int4* __restrict__ x,
                                              int row, int lane) {
    const int4 v = x[(size_t)row * 32 + lane];
    int32_t k[SLOTS_PER_LANE] = {v.x, v.y, v.z, v.w};
    uint32_t sum = 0;
#pragma unroll
    for (int it = 0; it < WHILE_ITERS; ++it)
        pr::while_lane_round(k, __reduce_min_sync(FULL, pr::while_lane_min(k)),
                             &sum);
    return sum;
}

__global__ void __launch_bounds__(WHILE_GRID_MAX_WARPS * 32)
probe_while_vector_grid_kernel(const int4* __restrict__ x,
                               int4* __restrict__ out) {
    const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    const int32_t s = (int32_t)while_row(x, row, lane);
    out[(size_t)row * 32 + lane] = make_int4(s, s, s, s);
}

// launched as one cluster of gridDim.x blocks covering the 256 rows
__global__ void __launch_bounds__(WHILE_THREADS)
probe_while_scratch_grid_kernel(const int4* __restrict__ x,
                                int32_t* __restrict__ out) {
    namespace cg = cooperative_groups;
    __shared__ uint32_t row_sum[WHILE_ROWS];   // block 0's: every row's sum
    cg::cluster_group cluster = cg::this_cluster();
    const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    const uint32_t s = while_row(x, row, lane);
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if (lane == 0) *cluster.map_shared_rank(row_sum + row, 0) = s;
    cluster.sync();
    if (cluster.block_rank() == 0 && threadIdx.x < 32) {
        uint32_t acc = 0;
#pragma unroll
        for (int r = 0; r < WHILE_ROWS; r += 32) acc += row_sum[r + lane];
        acc = __reduce_add_sync(FULL, acc);
        if (lane == 0) out[0] = (int32_t)acc;
    }
}

__global__ void __launch_bounds__(BODY_THREADS)
probe_body_scale_kernel(const int32_t* __restrict__ x, int n,
                        int32_t* __restrict__ out) {
    const int i = blockIdx.x * BODY_THREADS + threadIdx.x;
    if (i >= n) return;
    int32_t p = x[i];
#pragma unroll 1
    for (int it = 0; it < BODY_ROUNDS; ++it) {
#pragma unroll
        for (int j = 0; j < BODY_STEPS; ++j) p = pr::body_step(p, j);
    }
    out[i] = p;
}

}  // namespace

// idx: int32 [bb] row indices; table: int32 [rows, 128]; out: int32
// [bb, 128].  Returns cudaGetLastError().
extern "C" int nabwa_probe_smem_idx(const void* idx, const void* table,
                                    int bb, void* out, void* stream) {
    const int blocks = (bb + WARPS - 1) / WARPS;
    probe_smem_idx_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const int4*)table, bb, (int4*)out);
    return (int)cudaGetLastError();
}

// x, out: int32 [n], 16-byte aligned.
extern "C" int nabwa_probe_popcount(const void* x, long long n, void* out,
                                    void* stream) {
    const long long per_block = 4LL * POPC_THREADS;
    const int blocks = (int)((n + per_block - 1) / per_block);
    probe_popcount_kernel<<<blocks, POPC_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, n, (int32_t*)out);
    return (int)cudaGetLastError();
}

// C17's grid form: x int32 [256, 128], 16-byte aligned; out: int32 [1];
// `warps` a block, one cluster of 256 / warps blocks (warps 16 or 32).
// The first launch on a device allows the card's non-portable cluster
// sizes (past 8 blocks).
extern "C" int nabwa_probe_while_scratch(const void* x, int warps, void* out,
                                         void* stream) {
    if (warps < 1 || warps > WHILE_WARPS || WHILE_ROWS % warps ||
        WHILE_ROWS / warps > WHILE_MAX_CLUSTER)
        return (int)cudaErrorInvalidValue;
    const int blocks = WHILE_ROWS / warps;
    // the devices (a bit each; past 64, every launch asks again) on which
    // the kernel may take a non-portable cluster size
    static std::atomic<unsigned long long> allowed{0};
    cudaError_t rc;
    if (blocks > WHILE_PORTABLE_CLUSTER) {
        int dev = 0;
        rc = cudaGetDevice(&dev);
        if (rc != cudaSuccess) return (int)rc;
        const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
        if (!(allowed.load(std::memory_order_acquire) & bit)) {
            rc = cudaFuncSetAttribute(
                probe_while_scratch_grid_kernel,
                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (rc != cudaSuccess) return (int)rc;
            allowed.fetch_or(bit, std::memory_order_release);
        }
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(32 * warps);
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = cudaLaunchKernelEx(&cfg, probe_while_scratch_grid_kernel,
                            (const int4*)x, (int32_t*)out);
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
}

// C18's grid form: x, out int32 [256, 128], 16-byte aligned; `warps` a
// block, 1, 2, 4 or 8.
extern "C" int nabwa_probe_while_vector(const void* x, int warps, void* out,
                                        void* stream) {
    if (warps < 1 || warps > WHILE_GRID_MAX_WARPS || WHILE_ROWS % warps)
        return (int)cudaErrorInvalidValue;
    probe_while_vector_grid_kernel<<<WHILE_ROWS / warps, 32 * warps, 0,
                                     (cudaStream_t)stream>>>(
        (const int4*)x, (int4*)out);
    return (int)cudaGetLastError();
}

// C17's witness: x int32 [256, 128], 16-byte aligned; out: int32 [1].
extern "C" int nabwa_probe_while_scratch_witness(const void* x, void* out,
                                                 void* stream) {
    probe_while_scratch_kernel<<<1, WHILE_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        (const int4*)x, (int32_t*)out);
    return (int)cudaGetLastError();
}

// C18's witness: x, out int32 [256, 128], 16-byte aligned.
extern "C" int nabwa_probe_while_vector_witness(const void* x, void* out,
                                                void* stream) {
    probe_while_vector_kernel<<<1, WHILE_THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const int4*)x, (int4*)out);
    return (int)cudaGetLastError();
}

// x, out: int32 [n].
extern "C" int nabwa_probe_body_scale(const void* x, int n, void* out,
                                      void* stream) {
    const int blocks = (n + BODY_THREADS - 1) / BODY_THREADS;
    probe_body_scale_kernel<<<blocks, BODY_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const int32_t*)x, n, (int32_t*)out);
    return (int)cudaGetLastError();
}

// Kernel C8: the async row-fetch probe.  T rounds; each one issues N
// asynchronous copies of one 128-word int32 row (512 B) from a [ROWS,
// 128] table into a stage in shared memory, then waits for all of them.
// The result is out = final + stage[0][0], where final is the register
// LCG's state after the last round in `reg` mode and the seed 1 in the
// other modes, the whole stage, and a witness of every round: rounds[t],
// the int32 wrap-around sum of every word that round t's copies wrote
// (out and the stage see only the last round).
//
// Replaces scripts/probe_dma.py:31 `make` (pallas_call at :101), whose
// copies are TPU DMAs from HBM into VMEM, each started on one DMA
// semaphore and waited on in a second loop.  The row index comes from
//   reg   a scalar LCG in registers (:49-51);
//   vmem  a per-round vector compute, (8, 128) values, read back per
//         copy (:39-42);
//   smem  the same vector, staged by one more async copy into a second
//         buffer and read from there (:43-46);
//   cond  vmem, plus a second copy of row r2 into stage row
//         (i + N) % (2N) under the predicate r2 >= 0 (:59-70), r2 read
//         from the vector's next row (all 8 rows hold the same values).
//
// The TPU kernel's stage has max(N, 8) rows, so its `cond` copies land
// past the stage's end (interpret mode clamps them).  This stage has 2N
// rows, so every `cond` copy has a row of its own; out reads only row 0,
// so out does not depend on it.  Rows no copy wrote are zero.
//
// What bounds it on the card: bytes.  T * N rows of 512 B (twice that in
// `cond`) at pseudo-random rows; the bound counts the distinct rows read
// once, and the stage, out and rounds written once.  At N <= 128 a row is
// one copy of 32 x 16 B, from L2 (ROWS = 100,000 rows, 51.2 MB, about the
// H100's 50 MB L2) or from HBM (ROWS = 4,000,000, 2.05 GB).
//
// Two forms compute the same.
//
// The grid form (`nabwa_probe_dma`) runs the T
// rounds side by side, one block of GRID_THREADS a round (one block at
// T = 0, which copies nothing).  Nothing it returns needs the rounds in
// order: every round writes the same stage rows, so the stage and out
// are the last round's; rounds[t] is a sum over round t's own copies; and
// the only state one round hands the next is the LCG's, which
// `lcg_jump` (probes.cuh) gives for any step count, so copy i of round t
// reads the state t N + i + 1 steps after the seed without any thread
// stepping through another copy's states.
//   - Copies.  cp.async of 16 B a lane (.cg: through L2 only) into the
//     block's shared memory, one copy a warp a step, warp w taking copies
//     w, w + 8, ... (N <= 219 <= 32 x 8: at most one copy a lane of the
//     warp); in `reg` mode lane j of warp w computes the row of the
//     warp's j-th copy by one jump, and the warp reads it by shuffle
//     while it issues.  Then `cp.async.wait_group 0`: the TPU's drain
//     loop.  A 512 B bulk copy (`cp.async.bulk`) a row, completing on an
//     mbarrier, is the closer analogue of a DMA and its semaphore; built
//     and timed beside this route on the same inputs, it queued 1.01 to
//     1.11 times slower (PERF.md), so the copies stay cp.async.
//   - `vmem` / `cond`: each block computes its round's (8, 128) vector
//     into shared memory, four values a thread, as the serial form does.
//     `smem`: each block writes its round's vector into its own region of
//     the global scratch ([T, 1024] words: one region a round, since the
//     blocks run at once) and stages it by one more cp.async.
//   - The witness: each thread sums the words it copied (read back from
//     shared memory after the wait), a warp reduction and a block sum
//     over the 8 warps' give rounds[t], which the block writes itself: no
//     atomics and no zeroed buffer.
//   - The block of round T - 1 writes out and the whole stage, its zero
//     rows included.  The vector's values are floor moduli
//     (pr::dma_vec_row), never negative, so the predicate r2 >= 0 of a
//     `cond` copy always holds: every `cond` row is written in every
//     round, and the last round's rows are the serial form's.  This form
//     relies on that and does not test it.
//   - Shared memory: the round's stage rows (N, or 2N in `cond`) of 512
//     B, the 4 kB vector but in `reg` mode, and the warps' sums: 228,384
//     bytes at N = MAX_N in `cond`.  GRID_THREADS = 256
//     threads: enough warps to issue a round's copies a few at a time,
//     few enough that the jump (about 100 instructions, done by every
//     lane) costs little beside one round's latency.  `unroll` is
//     accepted and does not change the result.
//
// The serial form (`nabwa_probe_dma_serial`) is the probe's witness of a
// serial round's latency (the DFS tier's serial rounds of row fetches):
// one block, as the TPU kernel runs on one core; 1024 threads.  Copy i is
// issued by warp i % 32 as one cp.async of 16 B a lane, all of a round's
// copies are committed as one group, each thread waits for its group
// (cp.async.wait_group 0), and a block barrier ends the round.  Before
// that barrier each thread reads back the 16 B it copied (its own copies
// are complete and visible to it after the wait), sums them, and each
// warp adds its sum to rounds[t] with one atomicAdd, so rounds starts
// zeroed.  In `reg` mode every thread steps the LCG through all N copies,
// as the TPU's scalar core does, and issues its own.  In `vmem`/`cond`
// mode each thread computes one of the vector's 1024 values into shared
// memory; in `smem` mode 256 threads compute 4 values each into the
// global scratch's first 1024 words and copy their own 16 B of it by
// cp.async into the second shared buffer (cp.async reads only from global
// memory).  `unroll` is a template parameter: the issue loop is unrolled
// by 8 (the TPU's unroll=True unrolls it fully; here N is an argument).
//
// Both forms take up to MAX_N copies a round; each kernel instance's
// shared-memory limit is raised once a device (`allow_shm`), not on every
// launch.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "probes.cuh"

namespace {

namespace pr = nabwa::probe;

constexpr int THREADS = 1024;            // the serial form's block
constexpr int NWARPS = THREADS / 32;
constexpr int GRID_THREADS = 256;        // the grid form's block, a round
constexpr int GRID_WARPS = GRID_THREADS / 32;
constexpr int VEC = 8 * 128;             // the (8, 128) index vector
constexpr int ROW = 512;                 // bytes of a table row
constexpr int SHM_LIMIT = 232448;        // the H100's shared memory a block
// probes/probe_dma.py MAX_N: the serial form's 2N rows and two vectors
constexpr int MAX_N = (SHM_LIMIT - 2 * VEC * 4) / (2 * ROW);
static_assert(MAX_N <= 32 * GRID_WARPS, "one copy a lane of a warp");
static_assert(VEC == 4 * GRID_THREADS, "four vector values a thread");
enum Src { REG = 0, VMEM = 1, SMEM = 2, COND = 3 };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
}

__device__ __forceinline__ uint32_t word_sum(int4 v) {
    return (uint32_t)v.x + (uint32_t)v.y + (uint32_t)v.z + (uint32_t)v.w;
}

// where copy i's `cond` row r2 sits in the vector: its next row
__device__ __forceinline__ int cond_at(int i) {
    return ((i / 128 + 1) % 8) * 128 + i % 128;
}

__host__ __device__ constexpr size_t grid_shm(int src, int n) {
    return (size_t)(src == COND ? 2 * n : n) * ROW +
           (src == REG ? 0 : VEC * 4) + GRID_WARPS * 4;
}

constexpr size_t serial_shm(int n) {
    return (size_t)2 * n * ROW + 2 * VEC * sizeof(int32_t);
}

template <int SRC>
__global__ void __launch_bounds__(GRID_THREADS)
probe_dma_grid_kernel(const int4* __restrict__ table, int n_rows, int n,
                      int t_iters, int32_t* __restrict__ scratch,
                      int32_t* __restrict__ out,
                      int4* __restrict__ stage_out,
                      uint32_t* __restrict__ rounds) {
    constexpr bool TWO = SRC == COND;
    extern __shared__ int4 shm[];
    int4* stage = shm;                        // [n or 2n][32] x 16 B
    int32_t* v = (int32_t*)(stage + (size_t)(TWO ? 2 * n : n) * 32);
    uint32_t* sums = (uint32_t*)(v + (SRC == REG ? 0 : VEC));
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int t = blockIdx.x;
    const bool copied = t < t_iters;          // false only at T = 0
    if (copied) {
        if (SRC != REG) {
            int4 vals;
            vals.x = pr::dma_vec_row((4 * tid) & 127, t, n_rows);
            vals.y = pr::dma_vec_row((4 * tid + 1) & 127, t, n_rows);
            vals.z = pr::dma_vec_row((4 * tid + 2) & 127, t, n_rows);
            vals.w = pr::dma_vec_row((4 * tid + 3) & 127, t, n_rows);
            if (SRC == SMEM) {
                int32_t* g = scratch + (size_t)t * VEC + 4 * tid;
                *(int4*)g = vals;
                __threadfence_block();
                cp_async16(v + 4 * tid, g);
                cp_async_wait_all();
            } else {
                ((int4*)v)[tid] = vals;
            }
        }
        __syncthreads();
        int32_t r_lane = 0;
        if (SRC == REG) {
            const int i = warp + GRID_WARPS * lane;
            if (i < n)
                r_lane = pr::lcg_jump(1, (int64_t)t * n + i + 1) % n_rows;
        }
        for (int i = warp, j = 0; i < n; i += GRID_WARPS, ++j) {
            // s >= 0, so C's % is jnp's here
            const int32_t r =
                SRC == REG ? __shfl_sync(~0u, r_lane, j) : v[i];
            cp_async16(stage + (size_t)i * 32 + lane,
                       table + (size_t)r * 32 + lane);
            if (TWO)
                cp_async16(stage + (size_t)(i + n) * 32 + lane,
                           table + (size_t)v[cond_at(i)] * 32 + lane);
        }
        cp_async_wait_all();
        uint32_t w = 0;
        for (int i = warp; i < n; i += GRID_WARPS) {
            w += word_sum(stage[(size_t)i * 32 + lane]);
            if (TWO) w += word_sum(stage[(size_t)(i + n) * 32 + lane]);
        }
#pragma unroll
        for (int o = 16; o; o >>= 1) w += __shfl_xor_sync(~0u, w, o);
        if (lane == 0) sums[warp] = w;
        __syncthreads();
        if (tid == 0) {
            uint32_t s = 0;
#pragma unroll
            for (int k = 0; k < GRID_WARPS; ++k) s += sums[k];
            rounds[t] = s;
        }
    }
    if (t != (t_iters > 0 ? t_iters - 1 : 0)) return;
    if (tid == 0) {
        const int32_t fin =
            SRC == REG ? pr::lcg_jump(1, (int64_t)t_iters * n) : 1;
        out[0] = pr::wadd(fin, copied ? ((const int32_t*)stage)[0] : 0);
    }
    for (int k = tid; k < 2 * n * 32; k += GRID_THREADS) {
        const bool have = copied && (TWO || k < n * 32);
        stage_out[k] = have ? stage[k] : make_int4(0, 0, 0, 0);
    }
}

template <int SRC, bool UNROLL>
__global__ void __launch_bounds__(THREADS)
probe_dma_kernel(const int4* __restrict__ table, int n_rows, int n,
                 int t_iters, int32_t* __restrict__ vec,
                 int32_t* __restrict__ out, int4* __restrict__ stage_out,
                 uint32_t* __restrict__ rounds) {
    extern __shared__ int4 shm[];
    int4* stage = shm;                                   // [2n][32] x 16 B
    int32_t* rowv = (int32_t*)(stage + (size_t)2 * n * 32);   // [VEC]
    int32_t* rows_s = rowv + VEC;                        // [VEC]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    for (int k = tid; k < 2 * n * 32; k += THREADS)
        stage[k] = make_int4(0, 0, 0, 0);
    __syncthreads();
    int32_t seed = 1;
    for (int t = 0; t < t_iters; ++t) {
        if (SRC == VMEM || SRC == COND) {
            rowv[tid] = pr::dma_vec_row(tid & 127, t, n_rows);
            __syncthreads();
        } else if (SRC == SMEM) {
            if (tid < VEC / 4) {
                int4 v;
                v.x = pr::dma_vec_row((4 * tid) & 127, t, n_rows);
                v.y = pr::dma_vec_row((4 * tid + 1) & 127, t, n_rows);
                v.z = pr::dma_vec_row((4 * tid + 2) & 127, t, n_rows);
                v.w = pr::dma_vec_row((4 * tid + 3) & 127, t, n_rows);
                ((int4*)vec)[tid] = v;
                __threadfence_block();
                cp_async16(rows_s + 4 * tid, vec + 4 * tid);
                cp_async_wait_all();
            }
            __syncthreads();
        }
        int32_t s = seed;
#pragma unroll (UNROLL ? 8 : 1)
        for (int i = 0; i < n; ++i) {
            if (SRC == REG) s = pr::lcg_next(s);
            if ((i & (NWARPS - 1)) != warp) continue;
            // s >= 0, so C's % is jnp's here
            const int32_t r = SRC == REG    ? s % n_rows
                              : SRC == SMEM ? rows_s[i]
                                            : rowv[i];
            cp_async16(stage + (size_t)i * 32 + lane,
                       table + (size_t)r * 32 + lane);
            if (SRC == COND) {
                const int32_t r2 = rowv[((i / 128 + 1) % 8) * 128 + i % 128];
                if (r2 >= 0)
                    cp_async16(
                        stage + (size_t)((i + n) % (2 * n)) * 32 + lane,
                        table + (size_t)pr::floor_mod(r2, n_rows) * 32 +
                            lane);
            }
        }
        cp_async_wait_all();
        if (warp < n) {
            uint32_t w = 0;
            for (int i = warp; i < n; i += NWARPS) {
                w += word_sum(stage[(size_t)i * 32 + lane]);
                if (SRC == COND &&
                    rowv[((i / 128 + 1) % 8) * 128 + i % 128] >= 0)
                    w += word_sum(
                        stage[(size_t)((i + n) % (2 * n)) * 32 + lane]);
            }
#pragma unroll
            for (int o = 16; o; o >>= 1) w += __shfl_xor_sync(~0u, w, o);
            if (lane == 0) atomicAdd(rounds + t, w);
        }
        __syncthreads();
        seed = s;
    }
    if (tid == 0) out[0] = pr::wadd(seed, ((const int32_t*)stage)[0]);
    for (int k = tid; k < 2 * n * 32; k += THREADS) stage_out[k] = stage[k];
}

// Raise `kernel`'s dynamic shared memory limit to `bytes` on the current
// device, once a device for each kernel instance (`done` is the
// instance's mask of devices already raised; past 64 devices, every
// launch).
template <typename Kernel>
int allow_shm(Kernel kernel, size_t bytes,
              std::atomic<unsigned long long>& done) {
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return (int)rc;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (done.load(std::memory_order_acquire) & bit) return 0;
    rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return (int)rc;
    done.fetch_or(bit, std::memory_order_release);
    return 0;
}

using Launch = int (*)(const int4*, int, int, int, int32_t*, int32_t*,
                       int4*, uint32_t*, cudaStream_t);

template <int SRC>
int launch_grid(const int4* table, int n_rows, int n, int t_iters,
                int32_t* scratch, int32_t* out, int4* stage,
                uint32_t* rounds, cudaStream_t stream) {
    static std::atomic<unsigned long long> allowed{0};
    auto kernel = probe_dma_grid_kernel<SRC>;
    const int rc = allow_shm(kernel, grid_shm(SRC, MAX_N), allowed);
    if (rc) return rc;
    kernel<<<t_iters > 0 ? t_iters : 1, GRID_THREADS, grid_shm(SRC, n),
             stream>>>(table, n_rows, n, t_iters, scratch, out, stage,
                       rounds);
    return (int)cudaGetLastError();
}

template <int SRC, bool UNROLL>
int launch_serial(const int4* table, int n_rows, int n, int t_iters,
                  int32_t* scratch, int32_t* out, int4* stage,
                  uint32_t* rounds, cudaStream_t stream) {
    static std::atomic<unsigned long long> allowed{0};
    auto kernel = probe_dma_kernel<SRC, UNROLL>;
    const int rc = allow_shm(kernel, serial_shm(MAX_N), allowed);
    if (rc) return rc;
    kernel<<<1, THREADS, serial_shm(n), stream>>>(
        table, n_rows, n, t_iters, scratch, out, stage, rounds);
    return (int)cudaGetLastError();
}

constexpr Launch GRID[4] = {launch_grid<REG>, launch_grid<VMEM>,
                            launch_grid<SMEM>, launch_grid<COND>};
constexpr Launch SERIAL[2][4] = {
    {launch_serial<REG, false>, launch_serial<VMEM, false>,
     launch_serial<SMEM, false>, launch_serial<COND, false>},
    {launch_serial<REG, true>, launch_serial<VMEM, true>,
     launch_serial<SMEM, true>, launch_serial<COND, true>}};

int run(const Launch* forms, const void* table, int n_rows, int n,
        int t_iters, int src, void* scratch, void* out, void* stage,
        void* rounds, void* stream) {
    if (src < 0 || src > 3 || n < 1 || n > MAX_N || t_iters < 0)
        return (int)cudaErrorInvalidValue;
    return forms[src]((const int4*)table, n_rows, n, t_iters,
                      (int32_t*)scratch, (int32_t*)out, (int4*)stage,
                      (uint32_t*)rounds, (cudaStream_t)stream);
}

}  // namespace

// table: int32 [>= n_rows, 128], 16-byte aligned; src: 0 reg, 1 vmem, 2
// smem, 3 cond; scratch: int32 [t_iters, 1024] (smem mode); out: int32
// [1]; stage: int32 [2n, 128]; rounds: int32 [t_iters]; 1 <= n <= MAX_N
// (219).  The grid form; `unroll` is accepted and does not change the
// result.  Returns cudaGetLastError().
extern "C" int nabwa_probe_dma(const void* table, int n_rows, int n,
                               int t_iters, int src, int unroll,
                               void* scratch, void* out, void* stage,
                               void* rounds, void* stream) {
    (void)unroll;
    return run(GRID, table, n_rows, n, t_iters, src, scratch, out, stage,
               rounds, stream);
}

// The serial form, one block; as nabwa_probe_dma but that rounds must be
// zeroed by the caller (the warps add to it) and the scratch's first 1024
// words are the one vector.
extern "C" int nabwa_probe_dma_serial(const void* table, int n_rows, int n,
                                      int t_iters, int src, int unroll,
                                      void* scratch, void* out, void* stage,
                                      void* rounds, void* stream) {
    return run(SERIAL[unroll ? 1 : 0], table, n_rows, n, t_iters, src,
               scratch, out, stage, rounds, stream);
}

// Kernel C8: the async row-fetch probe.  T serial iterations; each one
// issues N asynchronous copies of one 128-word int32 row (512 B) from a
// [ROWS, 128] table into a stage in shared memory, then waits for all of
// them.  The result is out = final + stage[0][0], where final is the
// register LCG's state after the last iteration in `reg` mode and the
// seed 1 in the other modes, the whole stage, and a witness of every
// round: rounds[t], the int32 wrap-around sum of every word that round
// t's copies wrote (out and the stage see only the last round).
//
// Replaces scripts/probe_dma.py:31 `make` (pallas_call at :101), whose
// copies are TPU DMAs from HBM into VMEM, each started on one DMA
// semaphore and waited on in a second loop.  The row index comes from
//   reg   a scalar LCG in registers (:49-51);
//   vmem  a per-iteration vector compute, (8, 128) values, read back per
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
// so out does not depend on it.  The stage starts zeroed.
//
// What bounds it on the card: bytes.  T * N rows of 512 B (twice that in
// `cond`) at pseudo-random rows; the bound counts the distinct rows read
// once, and the stage, out and rounds written once.  At N <= 128 a row is
// one copy of 32 x 16 B, so what the probe measures is the latency of an
// iteration of N fetches in flight, and per copy, from L2 (ROWS = 100,000
// rows, 51.2 MB, about the H100's 50 MB L2) or from HBM (ROWS =
// 4,000,000, 2.05 GB).
//
// Design: one block, as the TPU kernel runs on one core; 1024 threads.
// Copy i is issued by warp i % 32 as one cp.async of 16 B a lane (.cg:
// through L2 only), all of an iteration's copies are committed as one
// group, each thread waits for its group (cp.async.wait_group 0), and a
// block barrier ends the iteration: the TPU's drain loop.  Before that
// barrier each thread reads back the 16 B it copied (its own copies are
// complete and visible to it after the wait), sums them, and each warp
// adds its sum to rounds[t] with one atomicAdd.  In `reg` mode every
// thread steps the LCG through all N copies, as the TPU's scalar core
// does, and issues its own.  In `vmem`/`cond` mode each thread
// computes one of the vector's 1024 values into shared memory; in `smem`
// mode 256 threads compute 4 values each into a global scratch vector
// and copy their own 16 B of it by cp.async into the second shared buffer
// (cp.async reads only from global memory).  `unroll` is a template
// parameter: the issue loop is unrolled by 8 (the TPU's unroll=True
// unrolls it fully; here N is an argument).  A 1-D bulk copy with an
// mbarrier per row would be the closer analog of a DMA and its semaphore.

#include <cuda_runtime.h>

#include <cstdint>

#include "probes.cuh"

namespace {

namespace pr = nabwa::probe;

constexpr int THREADS = 1024;
constexpr int NWARPS = THREADS / 32;
constexpr int VEC = 8 * 128;   // the (8, 128) index vector
enum Src { REG = 0, VMEM = 1, SMEM = 2, COND = 3 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
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

template <int SRC, bool UNROLL>
int launch(const int4* table, int n_rows, int n, int t_iters, int32_t* vec,
           int32_t* out, int4* stage, uint32_t* rounds,
           cudaStream_t stream) {
    const size_t shm = (size_t)2 * n * 512 + 2 * VEC * sizeof(int32_t);
    auto kernel = probe_dma_kernel<SRC, UNROLL>;
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (rc != cudaSuccess) return (int)rc;
    kernel<<<1, THREADS, shm, stream>>>(table, n_rows, n, t_iters, vec, out,
                                        stage, rounds);
    return (int)cudaGetLastError();
}

}  // namespace

// table: int32 [>= n_rows, 128]; src: 0 reg, 1 vmem, 2 smem, 3 cond;
// vec: int32 [1024] scratch (smem mode); out: int32 [1]; stage: int32
// [2n, 128]; rounds: int32 [t_iters], zeroed by the caller.  n * 1024 +
// 8192 bytes of shared memory must fit the block (n <= 219 on the H100).
// Returns cudaGetLastError().
extern "C" int nabwa_probe_dma(const void* table, int n_rows, int n,
                               int t_iters, int src, int unroll, void* vec,
                               void* out, void* stage, void* rounds,
                               void* stream) {
    const int4* tab = (const int4*)table;
    int32_t* v = (int32_t*)vec;
    int32_t* o = (int32_t*)out;
    int4* st = (int4*)stage;
    uint32_t* rd = (uint32_t*)rounds;
    cudaStream_t s = (cudaStream_t)stream;
    switch (src * 2 + (unroll ? 1 : 0)) {
        case 0:
            return launch<REG, false>(tab, n_rows, n, t_iters, v, o, st, rd,
                                  s);
        case 1:
            return launch<REG, true>(tab, n_rows, n, t_iters, v, o, st, rd,
                                  s);
        case 2:
            return launch<VMEM, false>(tab, n_rows, n, t_iters, v, o, st, rd,
                                  s);
        case 3:
            return launch<VMEM, true>(tab, n_rows, n, t_iters, v, o, st, rd,
                                  s);
        case 4:
            return launch<SMEM, false>(tab, n_rows, n, t_iters, v, o, st, rd,
                                  s);
        case 5:
            return launch<SMEM, true>(tab, n_rows, n, t_iters, v, o, st, rd,
                                  s);
        case 6:
            return launch<COND, false>(tab, n_rows, n, t_iters, v, o, st, rd,
                                  s);
        case 7:
            return launch<COND, true>(tab, n_rows, n, t_iters, v, o, st, rd,
                                  s);
        default: return (int)cudaErrorInvalidValue;
    }
}

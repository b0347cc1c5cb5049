// Kernels C11-C14, C20 and C21: probes A, B, E, F, C and D of
// scripts/probe_pallas2.py, the launch, the row loads, the lane
// sum, the pop, the lane gather and the scalar push.  All values are int32
// and wrap as jnp's do (probes.cuh).
//
// C11 replaces `probe_empty` (:38, pallas_call :44): out = x + 1 over an
// [8, 128] array, 1,024 words.  Bound by bytes, 8 KB (2.4 ns at 3.35
// TB/s); one add a word.  The probe exists to time the launch, which is
// microseconds: one block, one int4 a thread.
//
// C12 replaces `probe_loads(unroll)` (:55, pallas_call :67): for i < BB,
// out[i] = table[idx[i, 0]] and out[i + BB] = table[idx[i, 1]], a serial
// loop of two dynamic row loads a body on one TPU core, unrolled once or
// BB times.  The unroll does not change the result.  Bound by bytes: the
// 2 BB index words, the distinct rows read once and the 2 BB rows written
// (0.000156 ms at BB = 256, 3.35 TB/s); no arithmetic.  At BB = 256 that is
// 512 independent row copies of 512 B, so on this card the time is a
// launch and one index load, one row load and one store deep: the grid
// form spreads the copies over the card, LOADS_WARPS warps a block and
// one row a warp a step (`loads_out_row`, probes.cuh; 128 blocks at BB =
// 256), lane 0 reading the row's index and sharing it by shuffle, each
// lane moving one int4 of the row, neighbouring lanes on neighbouring
// addresses; a warp whose row lies past 2 BB stops, which masks the
// ragged edge.  Past LOADS_MAX_BLOCKS blocks the warps walk on, a grid's
// width of rows a step.  The serial forms stay as the probe's witness of
// one load's latency (C3's chain bound): one warp in one block walks the
// BB bodies in order, every lane reading the two indices (a broadcast
// load), then both rows copied with one int4 a lane; rolled (`#pragma
// unroll 1`) each body's index, row and store wait on the last's, and
// unrolled (LOADS_UNROLL bodies at a time, BB a multiple of it) the
// compiler issues many bodies' loads together.  The indices are not
// checked on the card, as in C7 and the TPU kernel: they must lie in [0,
// rows of the table).
//
// C13 replaces `probe_pop` (:182, pallas_call :202): key = x, f = x ^ 21
// over [BB, 256] slots, then 50 rounds of: mk = the row's minimum; every
// slot equal to it adds its f to e1 and is cleared to 0x7FFFFFFF; slot 0
// takes min(slot 0, e1).  Out: key[:, :128]; also the whole final key
// state and each round's mk (the witness, [iters, BB]).  Bound by
// operations: per row, one xor a slot once, then per round 5 a slot (the
// minimum, the compare, the select of f, its add, the clear) and 1 for
// slot 0's minimum; the bytes (x, out, state, witness) come close below.
// One warp per row with 8 slots a lane in registers (slot j * 32 + lane,
// so slot 0 is lane 0's first), the row's minimum and e1's sum are one
// warp reduction each; the rounds are a dependent chain, so the time is
// 50 rounds of reduction latency and the launch.
//
// C14 replaces `probe_lanereduce` (:164, pallas_call :170): out[r, 0] =
// the sum of x[r, :] for x [512, 128], wrapped.  Bound by bytes (x read
// once, out written once, 258 KB, 0.0000789 ms); 127 adds a row.  One
// warp per row, one int4 a lane, four adds and one warp reduction: on the
// card a launch takes the launch floor (2 us queued).  What bounds a call
// is the host: the wrapper's checks, the output's allocation and the
// ctypes call with its cudaLaunchKernel, against one PyTorch call's C++
// path.  The wrapper reads the raw handle of the current stream (building
// a torch.cuda.Stream object for it cost more than the launch), reaches
// the bound library without a lock (ops/_build.py), as every kernel's
// wrapper now does, and allocates with the sizes as arguments, not as a
// tuple (PERF.md has the host split).
//
// C20 replaces `probe_lane_gather` (:86, pallas_call :92): out[r, c] =
// x[r, i[r, c]] over [256, 128], take_along_axis on axis 1.  Bound by
// bytes (x and i read once, out written once, 384 KB); 9 operations an
// output (the shift and the and of its index, four shuffles, three
// selects).  One warp per row: lane l holds columns 4l..4l+3 of x and of i
// (an int4 each); output column c comes from lane i >> 2, so each of the
// four components of the source's int4 is shuffled in and the lane keeps
// the one that i & 3 names: 16 shuffles a lane, no shared memory.  Every
// index must lie in [0, 128): `lane_gather` refuses others before the
// launch; here one outside would take a wrong value (the shuffle's lane
// wraps mod 32), never read outside x.
//
// C21 replaces `probe_scalar_push` (:111, pallas_call :146): five field
// buffers f0..f4 int32 [256, 256] and a top [256, 128], zero; for it <
// 50 and each row i: n = c[i, it & 7] & 3, then for j < n the fields
// `push_fields(c[i, j])` (probes.cuh) go to slot t of row i, t = (t + 1)
// & 255; top[i, 0] = t.  Out: f0[:, :128] + top, so `top` reaches column
// 0 only.  The TPU kernel never writes f0..f4 before the pushes: a slot
// never pushed is undefined there, INT32_MIN in Pallas interpret mode, and
// here INT32_MIN too, so the kernel fills its rows of all five buffers
// with it first (inside its time).  At most 3 pushes a round, 150 in 50
// rounds, so t never reaches 256 and never wraps.  Rows are independent
// (the TPU walks them in turn), so one thread a row, one warp (block) for
// 32 rows: the warp fills its rows' buffers with int4 stores, then each
// lane runs its row's 50 rounds with c[i, 0..7] and t in registers (the
// rounds unrolled, so `it & 7` picks a register), storing each push to
// device memory, then the warp writes out and top row by row, reading f0
// back.  f0..f4 and top are returned whole, as witnesses the output does
// not show.  Bound by bytes: c's 8 columns read, out, f0..f4 and top
// written, 1,581,056 bytes at 256 rows; per row and round 4 operations
// (the and, three compares), per push 6 (four fields, the slot's add and
// mask).

#include <cuda_runtime.h>

#include <cstdint>

#include "probes.cuh"

namespace {

namespace pr = nabwa::probe;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int EMPTY_THREADS = 256;
constexpr int LOADS_UNROLL = 256;       // scripts/probe_pallas2.py BB
constexpr int LOADS_WARPS = 4;          // the grid form's warps a block
constexpr int LOADS_MAX_BLOCKS = 2048;  // then 8,192 rows a step
constexpr int POP_S = 256;
constexpr int POP_PER_LANE = POP_S / 32;
constexpr int POP_OUT = 128;
constexpr int WARPS = 4;
constexpr int GATHER_W = 128;            // x's and i's columns
constexpr int PUSH_S = 256;              // a field buffer's slots (:112)
constexpr int PUSH_FIELDS = 5;
constexpr int PUSH_ROUNDS = 50;          // :141
constexpr int PUSH_OUT = 128;            // out's and top's columns
constexpr int PUSH_COLS = 8;             // c's columns read: it & 7
constexpr int32_t UNWRITTEN = INT32_MIN;
static_assert(PUSH_ROUNDS * 3 < PUSH_S, "t never wraps");

__global__ void __launch_bounds__(EMPTY_THREADS)
probe_empty_kernel(const int32_t* __restrict__ x, long long n,
                   int32_t* __restrict__ out) {
    const long long i =
        4 * ((long long)blockIdx.x * EMPTY_THREADS + threadIdx.x);
    if (i + 4 <= n) {
        int4 v = *(const int4*)(x + i);
        v.x = pr::wadd(v.x, 1);
        v.y = pr::wadd(v.y, 1);
        v.z = pr::wadd(v.z, 1);
        v.w = pr::wadd(v.w, 1);
        *(int4*)(out + i) = v;
    } else {
        for (long long k = i; k < n; ++k) out[k] = pr::wadd(x[k], 1);
    }
}

// one body of the loop: rows idx[i, 0] and idx[i, 1] to out[i], out[i+bb]
__device__ __forceinline__ void load_pair(const int32_t* __restrict__ idx,
                                          int idx_w,
                                          const int4* __restrict__ table,
                                          int bb, int4* __restrict__ out,
                                          int i, int lane) {
    const int32_t r = idx[(size_t)i * idx_w];
    const int32_t r2 = idx[(size_t)i * idx_w + 1];
    out[(size_t)i * 32 + lane] = table[(size_t)r * 32 + lane];
    out[((size_t)i + bb) * 32 + lane] = table[(size_t)r2 * 32 + lane];
}

template <bool UNROLL>
__global__ void __launch_bounds__(32)
probe_loads_serial_kernel(const int32_t* __restrict__ idx, int idx_w,
                          const int4* __restrict__ table, int bb,
                          int4* __restrict__ out) {
    const int lane = threadIdx.x;
    if constexpr (UNROLL) {
#pragma unroll 1
        for (int base = 0; base < bb; base += LOADS_UNROLL) {
#pragma unroll
            for (int j = 0; j < LOADS_UNROLL; ++j)
                load_pair(idx, idx_w, table, bb, out, base + j, lane);
        }
    } else {
#pragma unroll 1
        for (int i = 0; i < bb; ++i)
            load_pair(idx, idx_w, table, bb, out, i, lane);
    }
}

// the grid form: warp `warp` of each block copies rows loads_out_row(...)
// in turn, lane 0 reading the row's index and sharing it by shuffle, then
// one int4 a lane; the loop's row is the same for the whole warp, so the
// warp leaves it together
__global__ void __launch_bounds__(LOADS_WARPS * 32)
probe_loads_kernel(const int32_t* __restrict__ idx, int idx_w,
                   const int4* __restrict__ table, int bb,
                   int4* __restrict__ out) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t rows = 2 * (int64_t)bb;
    for (int step = 0;; ++step) {
        const int64_t r = pr::loads_out_row(blockIdx.x, warp, step,
                                            LOADS_WARPS, gridDim.x);
        if (r >= rows) break;
        int32_t src = 0;
        if (lane == 0) src = idx[pr::loads_idx_at(r, bb, idx_w)];
        src = __shfl_sync(FULL, src, 0);
        out[r * 32 + lane] = table[(size_t)src * 32 + lane];
    }
}

__global__ void __launch_bounds__(WARPS * 32)
probe_pop_kernel(const int32_t* __restrict__ x, int rows, int iters,
                 int32_t* __restrict__ out, int32_t* __restrict__ state,
                 int32_t* __restrict__ witness) {
    const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const int32_t* xr = x + (size_t)row * POP_S;
    int32_t key[POP_PER_LANE], f[POP_PER_LANE];
#pragma unroll
    for (int j = 0; j < POP_PER_LANE; ++j) {
        key[j] = xr[j * 32 + lane];
        f[j] = key[j] ^ 21;
    }
    for (int it = 0; it < iters; ++it) {
        int32_t m = key[0];
#pragma unroll
        for (int j = 1; j < POP_PER_LANE; ++j) m = min(m, key[j]);
        const int32_t mk = __reduce_min_sync(FULL, m);
        uint32_t e = 0;
#pragma unroll
        for (int j = 0; j < POP_PER_LANE; ++j)
            key[j] = pr::pop_take(key[j], f[j], mk, &e);
        const int32_t e1 = (int32_t)__reduce_add_sync(FULL, e);
        if (lane == 0) {
            key[0] = min(key[0], e1);
            witness[(size_t)it * rows + row] = mk;
        }
    }
#pragma unroll
    for (int j = 0; j < POP_PER_LANE; ++j) {
        state[(size_t)row * POP_S + j * 32 + lane] = key[j];
        if (j * 32 < POP_OUT)
            out[(size_t)row * POP_OUT + j * 32 + lane] = key[j];
    }
}

__global__ void __launch_bounds__(WARPS * 32)
probe_lanereduce_kernel(const int4* __restrict__ x, int rows,
                        int32_t* __restrict__ out) {
    const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const int4 v = x[(size_t)row * 32 + lane];
    const uint32_t s = (uint32_t)v.x + (uint32_t)v.y + (uint32_t)v.z
                       + (uint32_t)v.w;
    const uint32_t total = __reduce_add_sync(FULL, s);
    if (lane == 0) out[row] = (int32_t)total;
}

// column c's value for index i (in [0, 128)) of a row whose lane l holds
// columns 4l..4l+3 in v
__device__ __forceinline__ int32_t lane_take(const int4& v, int32_t i) {
    const int src = i >> 2;
    const int32_t a = __shfl_sync(FULL, v.x, src);
    const int32_t b = __shfl_sync(FULL, v.y, src);
    const int32_t c = __shfl_sync(FULL, v.z, src);
    const int32_t d = __shfl_sync(FULL, v.w, src);
    const int q = i & 3;
    return q == 0 ? a : q == 1 ? b : q == 2 ? c : d;
}

__global__ void __launch_bounds__(WARPS * 32)
probe_lane_gather_kernel(const int4* __restrict__ x,
                         const int4* __restrict__ idx, int rows,
                         int4* __restrict__ out) {
    const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;                 // the whole warp
    const size_t at = (size_t)row * (GATHER_W / 4) + lane;
    const int4 v = x[at];
    const int4 i = idx[at];
    int4 o;
    o.x = lane_take(v, i.x);
    o.y = lane_take(v, i.y);
    o.z = lane_take(v, i.z);
    o.w = lane_take(v, i.w);
    out[at] = o;
}

// one warp, rows r0 .. r0 + 31 (those below `rows`); fields: int32 [5,
// rows, 256], read back after the pushes, so not const or __restrict__
__global__ void __launch_bounds__(32)
probe_scalar_push_kernel(const int32_t* __restrict__ c, int rows,
                         int32_t* fields, int4* __restrict__ top,
                         int4* __restrict__ out) {
    const int lane = threadIdx.x;
    const int r0 = blockIdx.x * 32;
    const int nr = min(32, rows - r0);
    const int4 fill = make_int4(UNWRITTEN, UNWRITTEN, UNWRITTEN, UNWRITTEN);
    for (int k = 0; k < PUSH_FIELDS; ++k) {
        int4* f = (int4*)(fields + ((size_t)k * rows + r0) * PUSH_S);
        for (int w = lane; w < nr * (PUSH_S / 4); w += 32) f[w] = fill;
    }
    __syncwarp();
    int32_t t = 0;
    if (lane < nr) {
        const int row = r0 + lane;
        int32_t cr[PUSH_COLS];
#pragma unroll
        for (int j = 0; j < PUSH_COLS; ++j)
            cr[j] = c[(size_t)row * GATHER_W + j];
        int32_t* f = fields + (size_t)row * PUSH_S;
        const size_t plane = (size_t)rows * PUSH_S;
#pragma unroll
        for (int it = 0; it < PUSH_ROUNDS; ++it) {
            const int32_t n = cr[it & 7] & 3;
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                if (j < n) {
#pragma unroll
                    for (int k = 0; k < PUSH_FIELDS; ++k)
                        f[k * plane + t] = pr::push_fields(cr[j], k);
                    t = (t + 1) & (PUSH_S - 1);
                }
            }
        }
    }
    __syncwarp();
    for (int r = 0; r < nr; ++r) {
        const int32_t tr = __shfl_sync(FULL, t, r);
        const size_t row = (size_t)(r0 + r);
        const size_t at = row * (PUSH_OUT / 4) + lane;
        int4 v = ((const int4*)(fields + row * PUSH_S))[lane];
        int4 tv = make_int4(0, 0, 0, 0);
        if (lane == 0) {
            v.x = pr::wadd(v.x, tr);
            tv.x = tr;
        }
        out[at] = v;
        top[at] = tv;
    }
}

}  // namespace

// x, out: int32 [n], 16-byte aligned.  Returns cudaGetLastError().
extern "C" int nabwa_probe_empty(const void* x, long long n, void* out,
                                 void* stream) {
    const long long per_block = 4LL * EMPTY_THREADS;
    const int blocks = (int)((n + per_block - 1) / per_block);
    probe_empty_kernel<<<blocks, EMPTY_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, n, (int32_t*)out);
    return (int)cudaGetLastError();
}

// idx: int32 [bb, idx_w] (columns 0 and 1 read); table: int32 [rows, 128];
// out: int32 [2 bb, 128], all 16-byte aligned; the grid form.
extern "C" int nabwa_probe_loads(const void* idx, int idx_w,
                                 const void* table, int bb, void* out,
                                 void* stream) {
    const int blocks = pr::loads_blocks(bb, LOADS_WARPS, LOADS_MAX_BLOCKS);
    if (blocks > 0)
        probe_loads_kernel<<<blocks, LOADS_WARPS * 32, 0,
                             (cudaStream_t)stream>>>(
            (const int32_t*)idx, idx_w, (const int4*)table, bb, (int4*)out);
    return (int)cudaGetLastError();
}

// The serial forms, one warp walking the loop: as nabwa_probe_loads, and
// unroll: 0 rolled, else LOADS_UNROLL bodies at a time (bb a multiple of
// it).
extern "C" int nabwa_probe_loads_serial(const void* idx, int idx_w,
                                        const void* table, int bb,
                                        int unroll, void* out,
                                        void* stream) {
    if (unroll)
        probe_loads_serial_kernel<true><<<1, 32, 0, (cudaStream_t)stream>>>(
            (const int32_t*)idx, idx_w, (const int4*)table, bb,
            (int4*)out);
    else
        probe_loads_serial_kernel<false><<<1, 32, 0, (cudaStream_t)stream>>>(
            (const int32_t*)idx, idx_w, (const int4*)table, bb,
            (int4*)out);
    return (int)cudaGetLastError();
}

// x: int32 [rows, 256]; out: int32 [rows, 128]; state: int32 [rows, 256];
// witness: int32 [iters, rows].
extern "C" int nabwa_probe_pop(const void* x, int rows, int iters,
                               void* out, void* state, void* witness,
                               void* stream) {
    const int blocks = (rows + WARPS - 1) / WARPS;
    probe_pop_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, rows, iters, (int32_t*)out, (int32_t*)state,
        (int32_t*)witness);
    return (int)cudaGetLastError();
}

// x: int32 [rows, 128]; out: int32 [rows].
extern "C" int nabwa_probe_lanereduce(const void* x, int rows, void* out,
                                      void* stream) {
    const int blocks = (rows + WARPS - 1) / WARPS;
    probe_lanereduce_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int4*)x, rows, (int32_t*)out);
    return (int)cudaGetLastError();
}

// x, idx, out: int32 [rows, 128], 16-byte aligned; every idx in [0, 128).
extern "C" int nabwa_probe_lane_gather(const void* x, const void* idx,
                                       int rows, void* out, void* stream) {
    const int blocks = (rows + WARPS - 1) / WARPS;
    probe_lane_gather_kernel<<<blocks, WARPS * 32, 0,
                               (cudaStream_t)stream>>>(
        (const int4*)x, (const int4*)idx, rows, (int4*)out);
    return (int)cudaGetLastError();
}

// c: int32 [rows, 128]; fields: int32 [5, rows, 256]; top, out: int32
// [rows, 128]; all 16-byte aligned.
extern "C" int nabwa_probe_scalar_push(const void* c, int rows, void* fields,
                                       void* top, void* out, void* stream) {
    const int blocks = (rows + 31) / 32;
    probe_scalar_push_kernel<<<blocks, 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)c, rows, (int32_t*)fields, (int4*)top, (int4*)out);
    return (int)cudaGetLastError();
}

// Kernels C25-C35: the nine probes of scripts/probe_pallas3.py: two
// scalar-indexed row copies, a gather along the rows, a relayout, a chain
// of dependent steps by shape, a per-row scalar broadcast over a plane (the
// DFS's expansion shape), row and column minima in three ways, a loop
// whose trip count hangs on the data, and a lane sum as a matrix product.
// All int32 values wrap as jnp's do (probes.cuh).
//
// C27 replaces `p1` (:35, through `call` :25-31, pallas_call :28): 256
// rounds, round k reading r = i[k, 0] and r2 = i[k, 1] (lanes 0 and 1 of
// row k of i int32 [256, 128]) and copying table row t[r] to out row k
// and t[r2] to out row k + 256 (t int32 [4096, 128], out [512, 128]).
// C28 replaces `p1b` (scripts/probe_pallas3.py:60): the same copies with
// r = i[k, 0] and r2 = j[k, 0] from two [256, 1] columns.  One kernel
// serves both, given each half's index pointer and its row stride: (i,
// 128) and (i + 1, 128) for p1, (i, 1) and (j, 1) for p1b.  A warp copies
// one out row: every lane loads the same index word (one broadcast), then
// each lane copies one int4 of the 512 B row.  Its bytes (the distinct
// table rows read once, the index words, out; p1's two index words share
// one 32 B sector a row) take 0.000152 ms at the HBM rate, and there is
// no arithmetic beyond the addresses.  The indices are not checked on the
// card: the wrappers' dispatchers refuse any outside [0, rows of t).
//
// C29 replaces `p3` (scripts/probe_pallas3.py:123): take_along_axis on
// axis 0, out[r, c] = x[i[r, c], c] for x int32 [128, 128] and i [8, 128]
// in [0, 128).  A thread an out element, one word gathered; its bytes
// (the gathered words, i and out) take 0.00000364 ms.  Rows of any width;
// the indices are checked by the dispatcher as C27's are.
//
// At the script's shapes neither C28 nor C29 is bound by its bytes: both
// queue at the card's launch floor (an index load, then the dependent
// row or word), and what a call costs beyond it is the host's launch
// path.  That path is what their wrappers redesign, not these bodies:
// one check pass over all of a launch's inputs (`common.cuda_inputs`)
// reads each tensor's device index and data pointer once, the launch
// reuses them, the stream's handle comes from that index, and the output
// is allocated in PyTorch's cheapest form.
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
//
// C31, C32 and C33 replace `p2` (:86, pallas_call :28), in its three kinds:
// 50 rounds of v <- v + m over x int32 [256, 128] (wrapping: at the
// script's inputs the minima turn negative within the 50 rounds), m the
// minimum of v's row (`native`, C31; `roll`, C32) or of its column
// (`subl`, C33), broadcast back over it.
// - C31 and C32: every row evolves on its own, so a warp holds a row in
//   registers, lane L words L, L + 32, L + 64 and L + 96.  C31 takes the
//   row minimum the card's own way: the minimum of the lane's four words,
//   then one `__reduce_min_sync` (redux.sync, sm_80 and later) over the
//   warp; blocks of 4 rows.  C32 takes it the script's way (:98-99): seven
//   steps m <- min(m, roll(m, sh)) for sh = 64, 32, ..., 1, word c of the
//   rotated row taken from word `roll_src`(c, sh) = (c - sh) mod 128, as
//   np.roll.  In this layout word L + 32 k's source sits in lane (L - sh)
//   mod 32, the same for every k, and in register (q + k) mod 4, q the
//   register of word L's source.  C32 has two forms:
//   - the lane form (`probe_p2_roll_kernel`, the probe's route): sh 64 and
//     32 keep every source in the lane, and after their two minima the
//     lane's four registers hold one value (`p2_lane_min`, probes.cuh).
//     So each later step, sh 16 .. 1, is one shuffle from lane
//     `p2_roll_lane`(L, sh) = (L - sh) mod 32 and one minimum on that
//     value: still the script's rotation, exact for any input, because
//     the registers agree by construction.  Its path a round: two minima,
//     five of a shuffle and a minimum, the add.  P2_WARPS rows a block,
//     as C31 and the witness: 1, 2 and 4 rows a block ran within 2 % of
//     one another (PERF.md).
//   - the witness (`probe_p2_row_kernel<P2_ROLL>`, the first design): each
//     step rotates the whole row literally, shuffling the four registers
//     from that lane (none for sh 64 and 32) and picking among them by a
//     per-lane register index (`pick4`), which nvcc turns into branches on
//     which the warp's lanes diverge: 239 warp instructions a round (17
//     shuffles, 20 selects in 20 branch regions), against the lane form's
//     16 (two minima, five shuffles and minima, four adds).  It answers
//     what a literal rotation of the row costs.
//   Every form ends a round with every lane's m the row minimum, added to
//   each word.
// - C33: each column evolves on its own, but its minimum crosses all 256
//   rows, which lie in different warps.  A block of 8 warps holds 32
//   columns (lane L column L of the block's group), warp w rows w + 8 j, j
//   < 32, in registers; each round a thread takes the minimum of its 32
//   rows, the 8 warps meet in shared memory behind a block barrier, and
//   each thread takes the minimum of the 8 partial minima of its column.
//   The partials alternate between two buffers, so one barrier a round
//   suffices: a warp can write a round's buffer only after every warp has
//   passed the barrier of the round before, and so has read the buffer
//   written two rounds back.
// Operations a word and round: the row or column minimum's share (about
// one minimum) and the add, 2; C32's lane form 3 (a lane's 3 minima of its
// four words, 5 minima after the shuffles and 4 adds, 12 for 4 words), its
// witness 8 (the seven minima and the add).  Bound by bytes at the
// script's shape (x read once, out written once, 256 KB), but 50 dependent
// rounds, each a warp reduction (C31, C32) or a barrier (C33), keep every
// kernel far above that bound.
//
// C34 replaces `p5` (:156): from s = x int32 [256, 128], 50 outer rounds,
// each reading n = (s[0, 0] & 3) + 1 (`p5_trips`) and then running n inner
// rounds s <- s + j, j = 0..n-1 (wrapping).  One add a word and inner
// round (126 inner rounds at one seed of the script's inputs).  Two forms.
// - The grid form (`probe_p5_grid_kernel`, the probe's route): every word
//   gets the same adds, so s[0, 0] alone decides the trip counts, and a
//   thread that holds s[0, 0]'s first value can follow it by the same adds
//   without seeing any other word.  So a thread of a grid loads x[0, 0]
//   and one int4 of s (16 B, the last thread also the tail of a word count
//   that is not a multiple of 4), and runs the 50 outer rounds on its own
//   (`p5_words`): each reads its trip count from its copy of s[0, 0] and
//   adds j to the copy and to its 4 words for each inner round.  The loop
//   keeps its data-dependent trip count, the same in every thread, so no
//   lane diverges.  No shared memory, no barrier, no cap on the words.  Its
//   path is one load and the copy's 226 dependent integer steps (an add an
//   inner round; the and and the add of each outer round's count).
// - The witness (`probe_p5_kernel`, the first design): one block of 1024
//   threads keeps s, 128 KB, in dynamic shared memory (above the default
//   48 KB, so the launcher raises the block's limit first, and returns the
//   error if the card refuses) as the script keeps it in VMEM scratch:
//   each outer round, after a barrier, every thread reads s[0, 0], and
//   after a second barrier (so that thread 0 adds to s[0, 0] only once
//   every thread has read it) adds j to its 32 words for each inner round.
//   It answers the script's question as it ran, a barrier-bound loop on
//   one core: not the card's bytes or adds bound it but its one SM's
//   shared memory, whose 128 bytes a clock take ~2,048 clocks to read and
//   write s once an inner round.  s of at most P5_MAX_BYTES.
//
// C35 replaces `p6` (:183): x int32 [512, 128] cast to float32 times w
// float32 [128, 8] (ones in the script) -> float32 [512, 8].  Each out
// element sums its K products with w's column in index order, `__fmul_rn`
// and `__fadd_rn` so that nvcc does not contract them into FMAs
// (`p6_step`, probes.cuh): the result equals the plain version's bit for
// bit for any w, and is exact at the script's inputs (x < 99, w = 1: every
// sum below 2^24).  Tensor cores cannot keep that order and are not used.
// 2 K float32 operations an out element (1 M at the script's shape)
// against 282,624 bytes: at this size the launch and each element's chain
// of K dependent adds bound it, not the bytes or the operations.  The
// staged form (`probe_p6_kernel`): a block of 4 x 8 threads a 4-row,
// 8-column tile of out (128 blocks at the script's shape, about one an
// SM), thread t its element (t / 8, t % 8).  Over K in tiles of P6_K = 128
// words (the script's K: one tile), the block stages its 4 rows of x, read
// as int4 and converted once, and its 8 columns of w, read as float4 and
// stored transposed, into shared memory behind one barrier, each thread's
// loads all issued before its stores (`p6_stage`, probes.cuh); then each
// thread runs its products and adds over the tile fully unrolled
// (`p6_dot`), so that every shared load issues ahead of the chain of adds
// and only that chain is left.  A tile past the end of K stages zeros past
// it, whose products (+0) leave the sums as they are; x of a depth that
// is not a multiple of 4, or w of a width that is not, is read a word at
// a time.  Any [R, K] x [K, N] whose grid of ceil(R / 4) ceil(N / 8)
// blocks fits a launch.

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
constexpr int P2_ROUNDS = 50;         // scripts/probe_pallas3.py:106
constexpr int P2_COLS = 128;          // C31, C32: a row's words, 4 a lane
constexpr int P2_WARPS = 4;           // C31, C32: rows a block
constexpr int P2_ROWS = 256;          // C33: x's rows (:110)
constexpr int P2_COL_WARPS = 8;       // C33: warps a block
constexpr int P2_COL_WORDS = P2_ROWS / P2_COL_WARPS;   // C33: rows a thread
constexpr int P5_ROUNDS = 50;         // scripts/probe_pallas3.py:169
constexpr int P5_THREADS = 1024;      // the witness's block
constexpr int P5_GRID_THREADS = 128;  // the grid form's blocks
constexpr int P5_MAX_BYTES = 232448;  // an H100 block's shared memory
constexpr int P6_K = 128;             // C35: K a staged tile (:191)
constexpr int P6_THREADS = pr::P6_ROWS * pr::P6_COLS;
constexpr int P6_PITCH = P6_K + pr::P6_PAD;
constexpr unsigned FULL = 0xFFFFFFFFu;

enum P2Kind { P2_NATIVE = 0, P2_ROLL = 1, P2_SUBL = 2 };
static_assert(P2_ROWS % P2_COL_WARPS == 0, "C33's rows a warp");

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

// t[i mod 4], without indexing a register array by a runtime value
__device__ __forceinline__ int32_t pick4(const int32_t (&t)[4], int i) {
    i &= 3;
    return i == 0 ? t[0] : i == 1 ? t[1] : i == 2 ? t[2] : t[3];
}

// m <- min(m, roll(m, sh)) over a row held a warp, lane L words L + 32 k
// in m[k] (C32)
template <int SH>
__device__ __forceinline__ void roll_min(int32_t (&m)[4], int lane) {
    const int src = pr::roll_src(lane, SH, P2_COLS);   // word L's source
    int32_t t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        t[k] = SH % 32 ? __shfl_sync(FULL, m[k], src & 31) : m[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = min(m[k], pick4(t, (src >> 5) + k));
}

// C31 (KIND P2_NATIVE) and C32 (P2_ROLL): a warp a 128-word row
template <int KIND>
__global__ void __launch_bounds__(P2_WARPS * 32)
probe_p2_row_kernel(const int32_t* __restrict__ x, int rows,
                    int32_t* __restrict__ out) {
    const int row = blockIdx.x * P2_WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;                  // the whole warp
    const size_t base = (size_t)row * P2_COLS + lane;
    int32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = x[base + 32 * k];
    for (int it = 0; it < P2_ROUNDS; ++it) {
        int32_t m[4];
        if (KIND == P2_NATIVE) {
            const int32_t mn = __reduce_min_sync(
                FULL, min(min(v[0], v[1]), min(v[2], v[3])));
#pragma unroll
            for (int k = 0; k < 4; ++k) m[k] = mn;
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) m[k] = v[k];
            roll_min<64>(m, lane);
            roll_min<32>(m, lane);
            roll_min<16>(m, lane);
            roll_min<8>(m, lane);
            roll_min<4>(m, lane);
            roll_min<2>(m, lane);
            roll_min<1>(m, lane);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = pr::wadd(v[k], m[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) out[base + 32 * k] = v[k];
}

// min(m, roll(m, sh)) for sh < 32 once a lane's four registers agree:
// one value from lane (L - sh) mod 32 (C32's lane form)
template <int SH>
__device__ __forceinline__ int32_t lane_roll_min(int32_t m, int lane) {
    return min(m, __shfl_sync(FULL, m, pr::p2_roll_lane(lane, SH)));
}

// C32's lane form: a warp a 128-word row, P2_WARPS rows a block
__global__ void __launch_bounds__(P2_WARPS * 32)
probe_p2_roll_kernel(const int32_t* __restrict__ x, int rows,
                     int32_t* __restrict__ out) {
    const int row = blockIdx.x * P2_WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;                  // the whole warp
    const size_t base = (size_t)row * P2_COLS + lane;
    int32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = x[base + 32 * k];
    for (int it = 0; it < P2_ROUNDS; ++it) {
        int32_t m = pr::p2_lane_min(v);       // sh 64, 32
        m = lane_roll_min<16>(m, lane);
        m = lane_roll_min<8>(m, lane);
        m = lane_roll_min<4>(m, lane);
        m = lane_roll_min<2>(m, lane);
        m = lane_roll_min<1>(m, lane);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = pr::wadd(v[k], m);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) out[base + 32 * k] = v[k];
}

// C33: a block 32 columns of a 256-row x, warp w rows w + 8 j
__global__ void __launch_bounds__(P2_COL_WARPS * 32)
probe_p2_subl_kernel(const int32_t* __restrict__ x, int cols,
                     int32_t* __restrict__ out) {
    __shared__ int32_t part[2][P2_COL_WARPS][32];
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int32_t* src = x + (size_t)w * cols + blockIdx.x * 32 + lane;
    int32_t* dst = out + (size_t)w * cols + blockIdx.x * 32 + lane;
    const size_t step = (size_t)P2_COL_WARPS * cols;
    int32_t v[P2_COL_WORDS];
#pragma unroll
    for (int j = 0; j < P2_COL_WORDS; ++j) v[j] = src[j * step];
    for (int it = 0; it < P2_ROUNDS; ++it) {
        int32_t m = v[0];
#pragma unroll
        for (int j = 1; j < P2_COL_WORDS; ++j) m = min(m, v[j]);
        part[it & 1][w][lane] = m;
        __syncthreads();
#pragma unroll
        for (int u = 0; u < P2_COL_WARPS; ++u)
            m = min(m, part[it & 1][u][lane]);
#pragma unroll
        for (int j = 0; j < P2_COL_WORDS; ++j) v[j] = pr::wadd(v[j], m);
    }
#pragma unroll
    for (int j = 0; j < P2_COL_WORDS; ++j) dst[j * step] = v[j];
}

// C34's witness: one block, s of n words in dynamic shared memory
__global__ void __launch_bounds__(P5_THREADS)
probe_p5_kernel(const int32_t* __restrict__ x, int n,
                int32_t* __restrict__ out) {
    extern __shared__ int32_t s[];
    for (int e = threadIdx.x; e < n; e += P5_THREADS) s[e] = x[e];
    for (int it = 0; it < P5_ROUNDS; ++it) {
        __syncthreads();                      // s[0] of the round before
        const int32_t trips = pr::p5_trips(s[0]);
        __syncthreads();                      // read by all before it moves
        for (int j = 0; j < trips; ++j)
            for (int e = threadIdx.x; e < n; e += P5_THREADS)
                s[e] = pr::wadd(s[e], j);
    }
    for (int e = threadIdx.x; e < n; e += P5_THREADS) out[e] = s[e];
}

// C34's grid form: thread q holds words 4 q .. 4 q + 3 of s (those below
// n), read as one int4 where all four are
__global__ void __launch_bounds__(P5_GRID_THREADS)
probe_p5_grid_kernel(const int32_t* __restrict__ x, long long n,
                     int32_t* __restrict__ out) {
    const long long q = (long long)blockIdx.x * P5_GRID_THREADS + threadIdx.x;
    const long long at = 4 * q;
    if (at >= n) return;
    const bool whole = at + 4 <= n;
    int32_t w[4];
    if (whole) {
        const int4 v = reinterpret_cast<const int4*>(x)[q];
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = at + k < n ? x[at + k] : 0;
    }
    pr::p5_words(x[0], P5_ROUNDS, w, 4);
    if (whole) {
        reinterpret_cast<int4*>(out)[q] = make_int4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (at + k < n) out[at + k] = w[k];
    }
}

// C35's staged form: block b the out tile at p6_origin(b, col_blocks), x
// [rows, depth] times w [depth, width]
__global__ void __launch_bounds__(P6_THREADS)
probe_p6_kernel(const int32_t* __restrict__ x, const float* __restrict__ w,
                int rows, int depth, int width, int col_blocks,
                float* __restrict__ out) {
    __shared__ __align__(16) float xs[pr::P6_ROWS * P6_PITCH];
    __shared__ __align__(16) float ws[pr::P6_COLS * P6_PITCH];
    const int t = threadIdx.x;
    const int r = t / pr::P6_COLS, c = t % pr::P6_COLS;
    int64_t r0, c0;
    pr::p6_origin(blockIdx.x, col_blocks, &r0, &c0);
    const float* a = xs + r * P6_PITCH;
    const float* b = ws + c * P6_PITCH;
    float acc = 0.0f;
    for (int k0 = 0; k0 < depth; k0 += P6_K) {
        if (k0) __syncthreads();              // the last tile read by all
        pr::p6_stage<P6_K, P6_THREADS>(x, w, rows, depth, width, r0, c0, k0,
                                       min(P6_K, depth - k0), t, P6_PITCH,
                                       xs, ws);
        __syncthreads();
        acc = pr::p6_dot<P6_K>(acc, a, b);
    }
    if (r0 + r < rows && c0 + c < width)
        out[(r0 + r) * width + c0 + c] = acc;
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

// x, out: int32 [rows, cols], kind 0 (`native`, C31) or 1 (`roll`, C32's
// lane form) with cols 128, or 2 (`subl`, C33) with rows 256 and cols a
// multiple of 32.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for another kind or shape (nothing launched).
extern "C" int nabwa_probe_p2(const void* x, int rows, int cols, int kind,
                              void* out, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (kind == P2_SUBL) {
        if (rows != P2_ROWS || cols % 32) return (int)cudaErrorInvalidValue;
        probe_p2_subl_kernel<<<cols / 32, P2_COL_WARPS * 32, 0, st>>>(
            (const int32_t*)x, cols, (int32_t*)out);
        return (int)cudaGetLastError();
    }
    if ((kind != P2_NATIVE && kind != P2_ROLL) || cols != P2_COLS)
        return (int)cudaErrorInvalidValue;
    const int blocks = (rows + P2_WARPS - 1) / P2_WARPS;
    if (kind == P2_ROLL)
        probe_p2_roll_kernel<<<blocks, P2_WARPS * 32, 0, st>>>(
            (const int32_t*)x, rows, (int32_t*)out);
    else
        probe_p2_row_kernel<P2_NATIVE><<<blocks, P2_WARPS * 32, 0, st>>>(
            (const int32_t*)x, rows, (int32_t*)out);
    return (int)cudaGetLastError();
}

// C32's witness.  x, out: int32 [rows, 128].  Returns cudaGetLastError().
extern "C" int nabwa_probe_p2_roll_witness(const void* x, int rows,
                                           void* out, void* stream) {
    probe_p2_row_kernel<P2_ROLL><<<(rows + P2_WARPS - 1) / P2_WARPS,
                                   P2_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, rows, (int32_t*)out);
    return (int)cudaGetLastError();
}

// x, out: int32 [n], 16-byte aligned, n > 0.  Returns cudaGetLastError();
// cudaErrorInvalidValue for n <= 0 (nothing launched).
extern "C" int nabwa_probe_p5(const void* x, long long n, void* out,
                              void* stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    const long long blocks =
        ((n + 3) / 4 + P5_GRID_THREADS - 1) / P5_GRID_THREADS;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    probe_p5_grid_kernel<<<(unsigned)blocks, P5_GRID_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)x, n, (int32_t*)out);
    return (int)cudaGetLastError();
}

// C34's witness.  x, out: int32 [n], 0 < n <= P5_MAX_BYTES / 4.  Returns
// the error of raising the block's shared memory limit to 4 n bytes, else
// cudaGetLastError(); cudaErrorInvalidValue for another n (nothing
// launched).
extern "C" int nabwa_probe_p5_witness(const void* x, int n, void* out,
                                      void* stream) {
    if (n <= 0 || n > P5_MAX_BYTES / 4) return (int)cudaErrorInvalidValue;
    const int bytes = n * 4;
    const cudaError_t rc = cudaFuncSetAttribute(
        probe_p5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return (int)rc;
    probe_p5_kernel<<<1, P5_THREADS, bytes, (cudaStream_t)stream>>>(
        (const int32_t*)x, n, (int32_t*)out);
    return (int)cudaGetLastError();
}

// x: int32 [rows, depth], w: float32 [depth, width], both 16-byte
// aligned; out: float32 [rows, width].  Returns cudaGetLastError(), or
// cudaErrorInvalidValue where the ceil(rows / 4) ceil(width / 8) blocks
// do not fit a launch (nothing launched).
extern "C" int nabwa_probe_p6(const void* x, const void* w, int rows,
                              int depth, int width, void* out,
                              void* stream) {
    const long long col_blocks =
        ((long long)width + pr::P6_COLS - 1) / pr::P6_COLS;
    const long long blocks =
        ((long long)rows + pr::P6_ROWS - 1) / pr::P6_ROWS * col_blocks;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    probe_p6_kernel<<<(unsigned)blocks, P6_THREADS, 0,
                      (cudaStream_t)stream>>>(
        (const int32_t*)x, (const float*)w, rows, depth, width,
        (int)col_blocks, (float*)out);
    return (int)cudaGetLastError();
}

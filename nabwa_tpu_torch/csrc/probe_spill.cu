// Kernel C23: scripts/probe_spill.py, K independent live values a lane.
//
// C23 replaces `make` (:23, pallas_call :45): for each int32 x of the
// input (the script's shapes [64, 1], [1, 128], [8, 128] and [64, 128]),
// K values v_i = x + i; then T rounds of the simultaneous update
// v_i <- (v_i * 3 + 1) ^ (v_{(i+1) mod K} >> 2) (`spill_update`,
// probes.cuh); out = the wrapping int32 sum of the K values, the input's
// shape.  K and T come from the environment in the script (:19-20,
// defaults 24 and 2000).  All arithmetic wraps as jnp's does.
//
// What bounds it: 4 operations a value and round (the multiply, the add,
// the shift and the xor), 4 T K an element, against 8 bytes an element;
// of the instructions, the shift and the xor go to the ALU pipe (16
// lanes a scheduler), v * 3 + 1 to an IMAD.  At the script's few elements
// (at most 8,192) no form fills the card's 528 schedulers with one
// element a thread.
//
// Two forms.
//
// The lane form (`probe_spill_lane_kernel<M>`, the probe's route) spreads
// one element over a group of L lanes (L a power of two, at most 8), lane
// l holding v_{l M} .. v_{l M + M - 1} in registers, M = K / L.  A round,
// a lane needs one value it does not hold: the old first value of the
// next lane of its group, one `__shfl_sync` of width L (the group's last
// lane reads the first's: the wrap v_{K-1} <- v_0; a one-lane group reads
// its own v_0, with no shuffle).  It then updates its M values in index
// order (`spill_lane_round`).  The sum is a lane's, then log2 L xor
// shuffles over the group.  So an element's 3 K instructions a round are split
// over L lanes: at the small shapes a warp's serial round is M values,
// not K, and at [64, 128] the 512 warps of L = 2 give nearly every
// scheduler one, whose 12 independent values keep it issuing.  A round's dependent path is a value's update, and a
// shuffle every M rounds; the T loop is unrolled by 4, so its counter
// costs little beside M = 3 values.  ptxas keeps v * 3 + 1 on one IMAD
// (the FMA pipe) and the ALU pipe at two instructions a value, the
// shift and the xor.  M is the template parameter (SPILL_MS), L a
// run-time argument; the wrapper picks L from K and the element count
// (`default_lanes`: wide groups while the card has schedulers to spare,
// narrower once every scheduler holds a warp) and may ask for another
// whose M is built.
//
// The witness (`probe_spill_kernel<K>`, the first design) keeps one
// element's K values in one thread's registers.  That is the script's
// question on this card: how many independent int32 values a thread keeps
// live before ptxas spills past its 255 registers, and what a spill costs.
// Every loop over i is fully unrolled (a register array needs constant
// indices); T is a runtime loop.  The update goes in place in index
// order, the old v_0 saved for v_{K-1}'s cross term (without it v_{K-1}
// would read the new v_0, wrong at every K >= 2).  K is a template
// parameter, instantiated for SPILL_KS, which reaches past the register
// cap, so the ptxas report (`-Xptxas -v`) of its largest instantiations
// shows spill stores and loads.  With one warp a scheduler at most, its
// time is one warp's K values a round, at every shape.
//
// Any other K (or L, or M) is refused (cudaErrorInvalidValue, nothing
// launched).  Blocks of 128 threads.

#include <cuda_runtime.h>

#include <cstdint>

#include "probes.cuh"

namespace {

namespace pr = nabwa::probe;

constexpr int SPILL_THREADS = 128;
constexpr unsigned FULL = 0xFFFFFFFFu;

template <int K>
__global__ void __launch_bounds__(SPILL_THREADS)
probe_spill_kernel(const int32_t* __restrict__ x, int n, int t,
                   int32_t* __restrict__ out) {
    const int e = blockIdx.x * SPILL_THREADS + threadIdx.x;
    if (e >= n) return;
    const int32_t x0 = x[e];
    int32_t v[K];
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = pr::wadd(x0, i);
#pragma unroll 1
    for (int it = 0; it < t; ++it) {
        const int32_t v0 = v[0];
#pragma unroll
        for (int i = 0; i < K - 1; ++i)
            v[i] = pr::spill_update(v[i], v[i + 1]);
        v[K - 1] = pr::spill_update(v[K - 1], v0);
    }
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) acc += (uint32_t)v[i];
    out[e] = (int32_t)acc;
}

// The lane form: element e = thread / lanes, lane l = thread % lanes of
// its group, M values a lane.  Every thread of the grid runs the rounds
// (the shuffles take the whole warp); a group past n computes on 0 and
// stores nothing.
template <int M>
__global__ void __launch_bounds__(SPILL_THREADS)
probe_spill_lane_kernel(const int32_t* __restrict__ x, int n, int t,
                        int lanes, int32_t* __restrict__ out) {
    const int g = blockIdx.x * SPILL_THREADS + threadIdx.x;
    const int shift = __ffs(lanes) - 1;
    const int e = g >> shift;
    const int l = g & (lanes - 1);
    const bool live = e < n;
    const int32_t x0 = live ? x[e] : 0;
    int32_t v[M];
    pr::spill_lane_init(x0, l, M, v);
    const int src = pr::spill_next_lane(l, lanes);
    if (lanes == 1) {                 // the lane holds the wrap's v_0
#pragma unroll 4
        for (int it = 0; it < t; ++it) pr::spill_lane_round(v, M, v[0]);
    } else {
#pragma unroll 4
        for (int it = 0; it < t; ++it)
            pr::spill_lane_round(v, M, __shfl_sync(FULL, v[0], src, lanes));
    }
    uint32_t acc = pr::spill_lane_sum(v, M);
    for (int d = lanes >> 1; d; d >>= 1)
        acc += __shfl_xor_sync(FULL, acc, d, lanes);
    if (live && l == 0) out[e] = (int32_t)acc;
}

}  // namespace

// The witness's instantiated K (nabwa_tpu_torch/probes/probe_spill.py's
// SPILL_KS repeats this list): the script's default 24, the cases 1 and
// 2, and steps that bracket ptxas's 255 registers a thread.  Each K past
// a few dozen adds seconds to nvcc (every loop over i is unrolled), so
// the set is kept to these.
#define SPILL_KS(X) \
    X(1) X(2) X(24) X(64) X(128) X(240) X(248) X(256) X(320)

// The lane form's instantiated M, values a lane (probe_spill.py's
// SPILL_MS repeats this list): K / L for each K of SPILL_KS at the L the
// wrapper may pick (K 1 and 2 in one lane; 24 over 8, 4 or 2; 64 and 128
// over 8 or 4, and 64 over 2; 240-320 over 8).
#define SPILL_MS(X) \
    X(1) X(2) X(3) X(6) X(12) X(8) X(16) X(32) X(30) X(31) X(40)

// x, out: int32 [n]; k one of SPILL_KS; t >= 0 rounds.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for any other k (nothing
// launched).
extern "C" int nabwa_probe_spill_witness(const void* x, int n, int k, int t,
                                         void* out, void* stream) {
    const int blocks = (n + SPILL_THREADS - 1) / SPILL_THREADS;
    switch (k) {
#define SPILL_CASE(K)                                                      \
    case K:                                                                \
        probe_spill_kernel<K><<<blocks, SPILL_THREADS, 0,                  \
                                (cudaStream_t)stream>>>(                   \
            (const int32_t*)x, n, t, (int32_t*)out);                       \
        break;
        SPILL_KS(SPILL_CASE)
#undef SPILL_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// x, out: int32 [n], n lanes < 2^31; k >= 1 values an element over
// groups of `lanes` lanes (1, 2, 4 or 8, dividing k, k / lanes one of
// SPILL_MS); t >= 0 rounds.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for any other k or lanes (nothing launched).
extern "C" int nabwa_probe_spill(const void* x, int n, int k, int lanes,
                                 int t, void* out, void* stream) {
    if (k < 1 || (lanes != 1 && lanes != 2 && lanes != 4 && lanes != 8)
        || k % lanes || (long long)n * lanes > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    const int threads = n * lanes;
    const int blocks = (threads + SPILL_THREADS - 1) / SPILL_THREADS;
    switch (k / lanes) {
#define SPILL_LANE_CASE(M)                                                 \
    case M:                                                                \
        probe_spill_lane_kernel<M><<<blocks, SPILL_THREADS, 0,             \
                                     (cudaStream_t)stream>>>(              \
            (const int32_t*)x, n, t, lanes, (int32_t*)out);                \
        break;
        SPILL_MS(SPILL_LANE_CASE)
#undef SPILL_LANE_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

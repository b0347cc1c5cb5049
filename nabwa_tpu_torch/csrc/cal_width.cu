// Kernel C2: batched bwt_cal_width (bwtaln.c:52-76), the D(i) width and
// bid planes the DFS prunes on.
//
// Replaces nabwa_tpu/ops/occ.py:141 `cal_width`, a jnp lax.scan over read
// positions that the JAX package runs 4x per batch (read and seed suffix,
// both strands; nabwa_tpu/ops/dfs_pallas.py:1446-1453) inside one jit.
//
// What bounds it on the card: each step of a row needs two occ lookups,
// each a 48 B block read at a data-dependent address, and the next step's
// addresses depend on this step's result.  So a row is a chain of L
// dependent pairs of random reads: latency, not FLOPs or bandwidth.
//
// Design: a group of G = 8 lanes per row (occ.cuh CAL_WIDTH_GROUP), and
// one launch for all the planes of a batch (blockIdx.y picks the plane:
// reads and seed suffixes, each strand on its own bank).  Half the group
// counts base c at k-1 and half at l, each lane loading 16 B of the block
// (the counters, or 4 of its 8 bwt words) and popcounting only base c in
// its words (occ.cuh `occ_lane_part`); a shuffle reduction within the
// half sums the parts, two shuffles hand both counts to every lane, and
// each lane moves the interval itself (all lanes of a group hold the same
// k, l and bid).  So a step's chain is one 16 B load, a few popcounts and
// four shuffles, where one thread did six 16 B loads and 48 popcounts in
// turn.  The code of the next step is fetched a step ahead; lane i mod G
// writes column i.  A block of 128 threads serves 128 / G rows.

#include <cuda_runtime.h>

#include "occ.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_PLANES = 4;
constexpr int G = nabwa::CAL_WIDTH_GROUP;
constexpr int H = nabwa::CAL_WIDTH_HALF;

// one plane: the rows' bank, queries and outputs
struct Plane {
    const uint32_t* bank;
    const int32_t* q;       // row r at q + r * q_stride, L codes
    const int32_t* len;     // [B]
    int32_t* w;             // row r at w + r * out_stride, L + 1 values
    int32_t* b;
    uint32_t primary;
    int q_stride, out_stride, L;
};

struct Planes {
    Plane p[MAX_PLANES];
};

// plane y of the launch, each field read at a constant offset
__device__ __forceinline__ Plane plane_of(const Planes& ps, int y) {
    switch (y) {
    case 0: return ps.p[0];
    case 1: return ps.p[1];
    case 2: return ps.p[2];
    default: return ps.p[3];
    }
}

__global__ void __launch_bounds__(THREADS) cal_width_group_kernel(
    nabwa::FmParams p, Planes ps, int B) {
    const Plane pl = plane_of(ps, blockIdx.y);
    const int row = blockIdx.x * (THREADS / G) + threadIdx.x / G;
    if (row >= B) return;
    const int lane = threadIdx.x & 31, g = lane % G;
    const unsigned gmask = ((1u << G) - 1u) << (lane - g);
    const int side = g / H, sub = g % H;
    const int L = pl.L, len = pl.len[row];
    const int32_t* q = pl.q + (size_t)row * pl.q_stride;
    int32_t* wo = pl.w + (size_t)row * pl.out_stride;
    int32_t* bo = pl.b + (size_t)row * pl.out_stride;
    uint32_t k = 0, l = p.seq_len;
    int32_t cur = 0;
    int c = 0 < len && 0 < L ? q[0] : 4;
    for (int i = 0; i < L; ++i) {
        const int ci = c;
        if (i + 1 < len && i + 1 < L) c = q[i + 1];   // a step ahead
        uint32_t part = 0;
        if (nabwa::cal_width_looks_up(i, len, ci))
            part = nabwa::occ_lane_part(pl.bank, pl.primary,
                                        side ? l : k - 1u, (uint32_t)ci, sub);
#pragma unroll
        for (int d = 1; d < H; d <<= 1)
            part += __shfl_xor_sync(gmask, part, d, G);
        const uint32_t ok = __shfl_sync(gmask, part, 0, G);
        const uint32_t ol = __shfl_sync(gmask, part, H, G);
        nabwa::cal_width_advance(p, i, len, ci, ok, ol, &k, &l, &cur);
        if (i % G == g)
            nabwa::cal_width_column(i, len, L, k, l, cur, wo + i, bo + i);
    }
    if (L % G == g) nabwa::cal_width_column(L, len, L, k, l, cur, wo + L,
                                            bo + L);
}

int launch_planes(const nabwa::FmParams& p, const Planes& ps, int n_planes,
                  int B, void* stream) {
    if (B == 0 || n_planes == 0) return 0;
    const dim3 grid((B + THREADS / G - 1) / (THREADS / G), n_planes);
    cal_width_group_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        p, ps, B);
    return (int)cudaGetLastError();
}

}  // namespace

// One plane.  params: l2[5], primary, seq_len (uint32); queries: int32
// [B, L]; lengths: int32 [B]; width/bid: int32 [B, L+1].  Returns
// cudaGetLastError().
extern "C" int nabwa_cal_width(const uint32_t* params, const void* bwt,
                               const void* queries, const void* lengths,
                               int B, int L, void* width, void* bid,
                               void* stream) {
    const nabwa::FmParams p = nabwa::fm_params(params);
    Planes ps = {};
    ps.p[0] = Plane{(const uint32_t*)bwt, (const int32_t*)queries,
                    (const int32_t*)lengths, (int32_t*)width, (int32_t*)bid,
                    p.primary, L, L + 1, L};
    return launch_planes(p, ps, 1, B, stream);
}

// The four planes of a batch in one launch.  params: l2[5], primary_fwd,
// primary_rev, seq_len (uint32); bwt_fwd/bwt_rev: the strands' banks;
// seqs: int32 [B, 2, L], seed_seqs: int32 [B, 2, SL], lengths and
// seed_lengths: int32 [B]; widths/bids: int32 [B, 2, L+1], seed_widths/
// seed_bids: int32 [B, 2, SL+1]; strand s of each on bank s.  Returns
// cudaGetLastError().
extern "C" int nabwa_cal_width_planes(
    const uint32_t* params, const void* bwt_fwd, const void* bwt_rev,
    const void* seqs, const void* lengths, const void* seed_seqs,
    const void* seed_lengths, int B, int L, int SL, void* widths,
    void* bids, void* seed_widths, void* seed_bids, void* stream) {
    nabwa::FmParams p;
    for (int j = 0; j < 5; ++j) p.l2[j] = params[j];
    p.primary = params[5];
    p.seq_len = params[7];
    const uint32_t* banks[2] = {(const uint32_t*)bwt_fwd,
                                (const uint32_t*)bwt_rev};
    const uint32_t prims[2] = {params[5], params[6]};
    Planes ps = {};
    for (int s = 0; s < 2; ++s) {
        ps.p[s] = Plane{banks[s], (const int32_t*)seqs + (size_t)s * L,
                        (const int32_t*)lengths,
                        (int32_t*)widths + (size_t)s * (L + 1),
                        (int32_t*)bids + (size_t)s * (L + 1), prims[s],
                        2 * L, 2 * (L + 1), L};
        ps.p[2 + s] = Plane{banks[s],
                            (const int32_t*)seed_seqs + (size_t)s * SL,
                            (const int32_t*)seed_lengths,
                            (int32_t*)seed_widths + (size_t)s * (SL + 1),
                            (int32_t*)seed_bids + (size_t)s * (SL + 1),
                            prims[s], 2 * SL, 2 * (SL + 1), SL};
    }
    return launch_planes(p, ps, 4, B, stream);
}

extern "C" const char* nabwa_error_string(int rc) {
    return cudaGetErrorString((cudaError_t)rc);
}

// Kernel C1: the bounded gapped DFS over the FM-index (bwt_match_gap,
// bwtgap.c:104-266) for a batch of reads.
//
// Replaces the Pallas kernel nabwa_tpu/ops/dfs_pallas.py:1253
// `dfs_pallas_call` (body `make_kernel`, :162-1242), entered from
// `aln_device_step_pallas` (:1438).  Its semantics are those of the jnp
// lockstep engine nabwa_tpu/ops/dfs.py:103-575 and its plain PyTorch port
// nabwa_tpu_torch/ops/dfs.py, column for column in the packed [B, 4H+5]
// result, with two exceptions: `fin` and `iters` are this kernel's own
// per-read telemetry, equal to the serial `nabwa::dfs_read`'s.
//
// What bounds it on the card: every DFS step of a read makes two occ4
// lookups, each a 48 B block read at an address that depends on the
// previous step (k, l), so a read is a chain of dependent random reads
// into a table of 2 x 24 MB at 64 Mbp (about the size of the 50 MB L2).
// Latency, not FLOPs or bandwidth, sets the time per step; everything else
// a step does must stay off that chain.
//
// Design: a warp per read (dfs_warp.cuh), blocks of up to 4 warps, fewer
// when a small batch would leave SMs idle; each warp runs its own loop to
// its own end, with no block-wide barrier.  The read's state -- the
// priority stack (key, info, cnt, k, l per slot), the two mutable
// width/bid planes, the seed planes, the read's codes and the hit list --
// lives in the warp's share of dynamic shared memory (9,248 B at S=256,
// L=128, H=32; 26,144 B at the retry tier's S=1024, H=128), copied in with
// strided lane loads.  A pop is the lanes' scan of their share of the live
// slots, a redux.sync minimum and a ballot for the lane holding it; the
// (k-1, l) occ4 pair's two blocks are loaded by two lanes at once as soon
// as the popped entry is known and counted after the checks and the
// expansion's set-up, so those run under the loads' latency; the nine
// candidates are built by nine lanes without a branch on their index and
// compacted by ballot rank; the gap shadow and the tandem-repeat test run
// over the lanes.  So a step's chain is one L2 round trip plus a few
// hundred warp-uniform instructions, where the thread-per-read form
// scanned up to S keys in device memory one load after another.
// (Prefetching the pushed candidates' occ blocks into L1 was measured and
// made the launch slower.)
//
// A read whose state does not fit in a block's shared memory (very wide
// reads or a very large stack) keeps it in device memory, in the wrapper's
// scratch ([B] x the same layout): the wrapper makes that choice by
// passing the scratch, and the kernel is the same but for where the state
// lives.

#include <cuda_runtime.h>

#include "dfs_warp.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_WARPS = 4;

// The warp as dfs_read_warp's W: 32 lanes and the intrinsics.  The host
// branches only let the host pass compile; the kernel alone calls these.
struct CudaWarp {
    int lane;

    template <class T>
    struct Val {
        T v;
        NABWA_HD T& operator[](int) { return v; }
        NABWA_HD const T& operator[](int) const { return v; }
    };

    NABWA_HD int lanes() const { return 32; }

    template <class F>
    NABWA_HD void each(F f) const {
        f(lane);
    }

    NABWA_HD int32_t min(const Val<int32_t>& x) const {
#if defined(__CUDA_ARCH__)
        return __reduce_min_sync(FULL, x.v);
#else
        return x.v;
#endif
    }

    NABWA_HD int sum(const Val<int>& x) const {
#if defined(__CUDA_ARCH__)
        return __reduce_add_sync(FULL, x.v);
#else
        return x.v;
#endif
    }

    NABWA_HD bool any(const Val<bool>& x) const {
#if defined(__CUDA_ARCH__)
        return __any_sync(FULL, x.v);
#else
        return x.v;
#endif
    }

    NABWA_HD uint32_t ballot(const Val<bool>& x) const {
#if defined(__CUDA_ARCH__)
        return __ballot_sync(FULL, x.v);
#else
        return x.v ? 1u : 0u;
#endif
    }

    NABWA_HD int first_lane(uint32_t mask) const {
#if defined(__CUDA_ARCH__)
        return __ffs(mask) - 1;
#else
        return __builtin_ffs(mask) - 1;
#endif
    }

    NABWA_HD int shfl(const Val<int>& x, int src) const {
#if defined(__CUDA_ARCH__)
        return __shfl_sync(FULL, x.v, src);
#else
        return x.v;
#endif
    }

    NABWA_HD void sync() const {
#if defined(__CUDA_ARCH__)
        __syncwarp();
#endif
    }

    // One lane's share of an occ4 pair: lane 0's block at k, lane 1's at l,
    // and the block's row.
    struct OccLoad {
        nabwa::Block b;
        uint32_t kk;
        bool none;            // k == NEG1: counts nothing
    };

    // The pair's block loads, issued: lane 0 at k, lane 1 at l
    NABWA_HD OccLoad occ_load(const uint32_t* bank, uint32_t prim, uint32_t k,
                              uint32_t l) const {
        OccLoad o;
        const uint32_t q = lane == 0 ? k : l;
        o.none = q == nabwa::NEG1;
        o.kk = q >= prim ? q - 1 : q;
        if (lane < 2 && !o.none) nabwa::load_block(bank, o.kk, &o.b);
        return o;
    }

    // The pair's counts from its loaded blocks, to every lane
    NABWA_HD void occ_count(const OccLoad& o, uint32_t ck4[4],
                            uint32_t cl4[4]) const {
#if defined(__CUDA_ARCH__)
        uint32_t c[4] = {0, 0, 0, 0};
        if (lane < 2 && !o.none) nabwa::occ4_block(o.b, o.kk, c);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            ck4[q] = __shfl_sync(FULL, c[q], 0);
            cl4[q] = __shfl_sync(FULL, c[q], 1);
        }
#endif
    }
};

template <bool kShared>
__global__ void __launch_bounds__(MAX_WARPS * 32) dfs_warp_kernel(
    nabwa::DfsParams p, const uint32_t* __restrict__ bwt_cat,
    const int32_t* __restrict__ seqs, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ widths, const int32_t* __restrict__ bids,
    const int32_t* __restrict__ seed_widths,
    const int32_t* __restrict__ seed_bids,
    const int32_t* __restrict__ has_seed,
    const int32_t* __restrict__ max_diff, int32_t* __restrict__ scratch,
    int32_t* __restrict__ out, int B) {
    extern __shared__ __align__(16) int32_t state_smem[];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int b = blockIdx.x * (blockDim.x >> 5) + w;
    if (b >= B) return;
    const size_t words = nabwa::dfs_state_bytes(p) / 4;
    int32_t* st = kShared ? state_smem + words * w : scratch + words * b;
    nabwa::dfs_read_warp(
        CudaWarp{lane}, p, bwt_cat,
        nabwa::warp_io(p, seqs, lengths, widths, bids, seed_widths,
                       seed_bids, has_seed, max_diff, st, out, b));
}

int sm_count() {
    static const int n = [] {
        int dev = 0, count = 0;
        if (cudaGetDevice(&dev) != cudaSuccess
            || cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                      dev) != cudaSuccess)
            return 1;
        return count;
    }();
    return n;
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
            rc = cudaFuncGetAttributes(&attr, dfs_warp_kernel<true>);
        const int bytes = optin - (int)attr.sharedSizeBytes;
        if (rc == cudaSuccess)
            rc = cudaFuncSetAttribute(
                dfs_warp_kernel<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        return rc == cudaSuccess ? bytes : -(int)rc;
    }();
    return cap;
}

// Warps a block (one read each) and blocks of a launch of B reads, and its
// dynamic shared memory: 4 warps a block, halved while the blocks would
// not cover the SMs or (shared form) would not fit in a block's shared
// memory.  Returns a CUDA error, cudaErrorInvalidValue when one read's
// state does not fit in shared memory.
int launch_shape(const nabwa::DfsParams& p, int B, bool shared, int* warps,
                 int* blocks, size_t* smem) {
    const size_t per_warp = nabwa::dfs_state_bytes(p);
    const int sms = sm_count();
    int n = MAX_WARPS;
    while (n > 1 && (B + n - 1) / n < sms) n >>= 1;
    *smem = 0;
    if (shared) {
        const int cap = smem_cap();
        if (cap < 0) return -cap;
        if (per_warp > (size_t)cap) return (int)cudaErrorInvalidValue;
        while (n > 1 && n * per_warp > (size_t)cap) n >>= 1;
        *smem = n * per_warp;
    }
    *warps = n;
    *blocks = (B + n - 1) / n;
    return 0;
}

}  // namespace

// The shape a launch of B reads takes (shared: the state in shared
// memory): shape[0] warps a block, shape[1] blocks, shape[2] dynamic
// shared bytes a block.  Returns 0 or a CUDA error, as nabwa_dfs would.
extern "C" int nabwa_dfs_shape(const uint32_t* params, int B, int shared,
                               int* shape) {
    size_t smem = 0;
    const int rc = launch_shape(nabwa::dfs_params(params), B, shared != 0,
                                shape, shape + 1, &smem);
    shape[2] = (int)smem;
    return rc;
}

// params: the N_PARAMS uint32 words of DfsParams, in field order.
// scratch: null to keep each read's state in shared memory, else int32
// [B, dfs_state_bytes / 4] in device memory.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue when one read's state does not fit in shared
// memory and no scratch was given.
extern "C" int nabwa_dfs(const uint32_t* params, const void* bwt_cat,
                         const void* seqs, const void* lengths,
                         const void* widths, const void* bids,
                         const void* seed_widths, const void* seed_bids,
                         const void* has_seed, const void* max_diff,
                         void* scratch, void* out, int B, void* stream) {
    const nabwa::DfsParams p = nabwa::dfs_params(params);
    int warps = 0, blocks = 0;
    size_t smem = 0;
    const int rc = launch_shape(p, B, scratch == nullptr, &warps, &blocks,
                                &smem);
    if (rc != 0) return rc;
    const auto kernel = scratch == nullptr ? dfs_warp_kernel<true>
                                           : dfs_warp_kernel<false>;
    kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
        p, (const uint32_t*)bwt_cat, (const int32_t*)seqs,
        (const int32_t*)lengths, (const int32_t*)widths,
        (const int32_t*)bids, (const int32_t*)seed_widths,
        (const int32_t*)seed_bids, (const int32_t*)has_seed,
        (const int32_t*)max_diff, (int32_t*)scratch, (int32_t*)out, B);
    return (int)cudaGetLastError();
}

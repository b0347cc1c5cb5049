// Kernel C1: the bounded gapped DFS over the FM-index (bwt_match_gap,
// bwtgap.c:104-266) for a batch of reads.
//
// Replaces the Pallas kernel nabwa_tpu/ops/dfs_pallas.py:1253
// `dfs_pallas_call` (body `make_kernel`, :162-1242), entered from
// `aln_device_step_pallas` (:1438).  Its semantics are those of the jnp
// lockstep engine nabwa_tpu/ops/dfs.py:103-575 and its plain PyTorch port
// nabwa_tpu_torch/ops/dfs.py, column for column in the packed [B, 4H+5]
// result, with two exceptions: `fin` and `iters` are this kernel's own
// per-read telemetry.
//
// What bounds it on the card: every DFS step of a read makes two occ4
// lookups, each a 48 B block read at an address that depends on the
// previous step (k, l), so a read is a chain of dependent random reads
// into a table of 2 x 24 MB at 64 Mbp (about the size of the 50 MB L2).
// Latency, not FLOPs or bandwidth, sets the time per step.
//
// First design: one thread per read, blocks of 128 threads.  Latency is
// hidden only by the number of reads in flight.  Each read keeps its
// priority stack and its two mutable width/bid planes in global-memory
// scratch that the wrapper allocates ([B, 5, S] slots, [2, B, 2, L+1]
// planes).  The stack is a compact array of (key, info, cnt, k, l): a pop
// scans the live entries for the minimum key, which is the C's pop order
// (lowest score, LIFO within a score) because key = score << 16 |
// 0xFFFF - seq.  Slot positions never affect the result, only the count of
// live entries, so the overflow rules match the jnp slot pool exactly.
// The per-read iteration cap equals the lockstep engine's global count,
// since a read is live in every lockstep iteration until it finishes.
//
// The per-read search (dfs_read.cuh) is NABWA_HD, so a host compiler
// builds the same source for the CPU tests.

#include <cuda_runtime.h>

#include "dfs_read.cuh"

namespace {

using nabwa::DfsParams;

__global__ void __launch_bounds__(128)
dfs_kernel(DfsParams p, const uint32_t* __restrict__ bwt_cat,
           const int32_t* __restrict__ seqs,
           const int32_t* __restrict__ lengths,
           const int32_t* __restrict__ widths,
           const int32_t* __restrict__ bids,
           const int32_t* __restrict__ seed_widths,
           const int32_t* __restrict__ seed_bids,
           const int32_t* __restrict__ has_seed,
           const int32_t* __restrict__ max_diff, int32_t* slots,
           int32_t* planes, int32_t* out, int B) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    nabwa::dfs_read(p, bwt_cat,
                    nabwa::read_io(p, seqs, lengths, widths, bids,
                                   seed_widths, seed_bids, has_seed,
                                   max_diff, slots, planes, out, b, B));
}

}  // namespace

// params: the N_PARAMS uint32 words of DfsParams, in field order.
// Returns cudaGetLastError().
extern "C" int nabwa_dfs(const uint32_t* params, const void* bwt_cat,
                         const void* seqs, const void* lengths,
                         const void* widths, const void* bids,
                         const void* seed_widths, const void* seed_bids,
                         const void* has_seed, const void* max_diff,
                         void* slots, void* planes, void* out, int B,
                         void* stream) {
    DfsParams p = nabwa::dfs_params(params);
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    dfs_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        p, (const uint32_t*)bwt_cat, (const int32_t*)seqs,
        (const int32_t*)lengths, (const int32_t*)widths,
        (const int32_t*)bids, (const int32_t*)seed_widths,
        (const int32_t*)seed_bids, (const int32_t*)has_seed,
        (const int32_t*)max_diff, (int32_t*)slots, (int32_t*)planes,
        (int32_t*)out, B);
    return (int)cudaGetLastError();
}

// Kernel C7: the row gather of the first Pallas probe, out[i] =
// table[idx[i]] for idx int32 [BB, 1] and a table of 128-word int32 rows
// (probe 1: BB = 256 rows from a [4096, 128] table, 2 MB).
//
// Replaces scripts/probe_pallas.py:31 `probe_rowload` (pallas_call at
// :43), a fori_loop of dynamic-sublane row loads from a VMEM-resident
// table on one TPU core.
//
// What bounds it on the card: bytes.  Each row is a 4 B index read, then
// a 512 B row read that depends on it, then a 512 B row written; no
// arithmetic.  The bound counts the index, the distinct rows gathered
// once and the output.  At 256 rows the work is one dependent load chain
// per row, so the card's time is latency (the index, then the row from L2
// or HBM) and the launch, far above the bytes' time.
//
// Design: one warp per row, 16 B a lane, so a row is one coalesced 512 B
// load and one 512 B store; blocks of 4 warps.  Every lane reads the index
// (one broadcast load).  The index must lie in [0, rows of the table): the
// TPU kernel does not check it either, and the port's entry point makes it
// in range.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 4;

__global__ void __launch_bounds__(WARPS * 32)
probe_rowload_kernel(const int32_t* __restrict__ idx,
                     const int4* __restrict__ table, int bb,
                     int4* __restrict__ out) {
    const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= bb) return;
    const int32_t r = idx[row];
    out[(size_t)row * 32 + lane] = table[(size_t)r * 32 + lane];
}

}  // namespace

// idx: int32 [bb] row indices; table: int32 [rows, 128]; out: int32
// [bb, 128].  Returns cudaGetLastError().
extern "C" int nabwa_probe_rowload(const void* idx, const void* table,
                                   int bb, void* out, void* stream) {
    const int blocks = (bb + WARPS - 1) / WARPS;
    probe_rowload_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)idx, (const int4*)table, bb, (int4*)out);
    return (int)cudaGetLastError();
}

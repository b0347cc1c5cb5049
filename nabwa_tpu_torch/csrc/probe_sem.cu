// Kernel C22: scripts/probe_sem.py, the DMA semaphore's count per [1, 128]
// int32 copy.
//
// C22 replaces `kernel` (:20, pallas_call :33): K (1..16) async copies of
// table rows 0..K-1 into a [16, 128] int32 stage, all on one DMA
// semaphore; out[0] = the semaphore read right after the K issues; then K
// waits of one copy each (128), out[1 + k] = the semaphore after wait k.
// out[K + 1] is never written: undefined on the TPU, INT32_MIN in Pallas
// interpret mode, and INT32_MIN here.  Interpret mode lands every copy at
// its issue, so there out = [128 K, 128 (K - 1), ..., 0, INT32_MIN]; on
// real hardware a read right after the issue sees only the copies that
// have landed, which is the probe's question.
//
// Hopper's counterpart of a DMA semaphore is a bulk async copy
// (cp.async.bulk, the TMA's copy of contiguous bytes) that reports to an
// mbarrier in shared memory.  One warp; the stage lives in shared memory,
// filled with INT32_MIN by the warp, then a fence.proxy.async so those
// generic-proxy stores are ordered before the copies' async-proxy writes.
// One mbarrier a copy (arrival count 1): lane 0 arms barrier k with
// arrive.expect_tx of 512 bytes and issues the 512-byte copy of table row
// k to stage row k, completing on it.  An mbarrier has no readable byte
// count, so the "semaphore" is 128 x (barriers whose phase 0 has
// completed, by the non-blocking test_wait.parity) - 128 x (waits done),
// which is what the TPU's counter means.  Each wait spins until that is
// at least 128 and takes 128 (or traps after ~1 s, so a fault fails the
// launch loudly instead of hanging the card).  After the last wait every
// copy has landed: every lane acquires each barrier and the warp copies
// the stage out, a witness of the copies.  Bound by bytes: K rows read,
// the stage (8 KB) and K + 2 words written; no arithmetic to speak of.
// The table must start on a 16-byte boundary (the bulk copy's rule).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SEM_ROWS = 16;           // scripts/probe_sem.py:32, :38
constexpr int ROW_WORDS = 128;
constexpr uint32_t ROW_BYTES = ROW_WORDS * 4;
constexpr int32_t SEM_UNIT = 128;      // the count of one [1, 128] copy
constexpr int32_t UNWRITTEN = INT32_MIN;
// the waits trap after ~1 s at the H100's clocks instead of hanging
constexpr long long SPIN_CYCLES = 1LL << 31;

__device__ __forceinline__ uint32_t smem(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// whether barrier `bar`'s phase 0 has completed (does not block; acquires
// what the copy wrote when it has)
__device__ __forceinline__ bool landed(uint32_t bar) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar) : "memory");
    return done != 0;
}

__device__ __forceinline__ int32_t sem_read(const uint64_t* bars, int k,
                                            int waits) {
    int n = 0;
    for (int i = 0; i < k; ++i) n += landed(smem(&bars[i]));
    return SEM_UNIT * (n - waits);
}

__global__ void __launch_bounds__(32)
probe_sem_kernel(const int32_t* __restrict__ table, int k,
                 int32_t* __restrict__ out, int4* __restrict__ stage_out) {
    __shared__ __align__(128) int4 stage[SEM_ROWS * ROW_WORDS / 4];
    __shared__ __align__(8) uint64_t bars[SEM_ROWS];
    const int lane = threadIdx.x;
    const int4 fill = make_int4(UNWRITTEN, UNWRITTEN, UNWRITTEN, UNWRITTEN);
    for (int w = lane; w < SEM_ROWS * ROW_WORDS / 4; w += 32) stage[w] = fill;
    if (lane == 0) {
        for (int i = 0; i < k; ++i)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                         :: "r"(smem(&bars[i])) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // this lane's fill before the copies' async-proxy writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) {
        for (int i = 0; i < k; ++i) {
            const uint32_t bar = smem(&bars[i]);
            asm volatile(
                "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                :: "r"(bar), "r"(ROW_BYTES) : "memory");
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                "::bytes [%0], [%1], %2, [%3];"
                :: "r"(smem(&stage[i * ROW_WORDS / 4])),
                   "l"(table + (size_t)i * ROW_WORDS), "r"(ROW_BYTES),
                   "r"(bar)
                : "memory");
        }
        out[0] = sem_read(bars, k, 0);
        const long long t0 = clock64();
        for (int w = 1; w <= k; ++w) {
            while (sem_read(bars, k, w - 1) < SEM_UNIT)
                if (clock64() - t0 > SPIN_CYCLES) __trap();
            out[w] = sem_read(bars, k, w);
        }
        out[k + 1] = UNWRITTEN;
    }
    __syncwarp();
    for (int i = 0; i < k; ++i)
        while (!landed(smem(&bars[i]))) {
        }
    for (int w = lane; w < SEM_ROWS * ROW_WORDS / 4; w += 32)
        stage_out[w] = stage[w];
}

}  // namespace

// table: int32 [16, 128], 16-byte aligned; k in 1..16; out: int32 [k + 2];
// stage: int32 [16, 128].  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for k outside 1..16 (nothing launched).
extern "C" int nabwa_probe_sem(const void* table, int k, void* out,
                               void* stage, void* stream) {
    if (k < 1 || k > SEM_ROWS) return (int)cudaErrorInvalidValue;
    probe_sem_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)table, k, (int32_t*)out, (int4*)stage);
    return (int)cudaGetLastError();
}

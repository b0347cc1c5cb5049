// Kernel C3: batched bwt_sa (bwt.c:72-81), suffix-array row -> text
// position, for the coordinate steps of samse, sampe, bam2bam and bwasw
// (bwa_cal_pac_pos, bwase.c:156-183).
//
// Replaces nabwa_tpu/ops/sa_lookup.py:34 `_sa_lookup_impl`, a jnp
// while_loop that steps every row of the batch in lockstep until the last
// one reaches a sampled row.
//
// What bounds it on the card: each step is one invPsi, a 48 B Occ block
// read at a data-dependent address, and the next step's address depends
// on this step's result.  bwt_sa samples the suffix array by row, so the
// number of steps a row takes to a sampled row is about geometric with
// mean sa_intv, unbounded by it: at sa_intv 32, 16k rows give a mean of
// ~32 steps and a longest chain of ~300.  A launch takes as long as its
// slowest row's chain of dependent loads, not as long as its bytes.
//
// Design: the shortest chain a step can have (sa_walk.cuh).  One load of
// the row's block (three 16 B pieces issued together), the base read from
// the block's own word, only that base counted, l2[c] + counter[c] picked
// from sums made before c is known, and the interval tested without a
// division (a mask for powers of two, a multiply-high reciprocal
// otherwise: one instantiation each).  A thread a row, blocks of 128
// threads; each row stops at its own sampled row.  Both strands in one
// launch: rows [0, n0) walk strand 0's bank and sample, rows [n0, n)
// strand 1's, so their slowest chains overlap.  (A group of 4 lanes a
// row, each loading one 16 B piece, the base's lane handing c to the
// others and two shuffles summing the parts, was slower on the H100:
// ~0.41 us a step against 0.36; PERF.md gives both.)

#include <cuda_runtime.h>

#include "sa_walk.cuh"

namespace {

constexpr int THREADS = 128;

struct Launch {
    nabwa::SaStrand s[2];
    uint32_t l2[4];
    const uint32_t* rows;
    uint32_t* out;
    int n, n0;
};

__device__ __forceinline__ nabwa::SaStrand strand_of(const Launch& a,
                                                     int i) {
    return i < a.n0 ? a.s[0] : a.s[1];
}

template <class Intv>
__global__ void __launch_bounds__(THREADS) sa_thread_kernel(Launch a,
                                                            Intv iv) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= a.n) return;
    const nabwa::SaStrand s = strand_of(a, i);
    const uint32_t l2[4] = {a.l2[0], a.l2[1], a.l2[2], a.l2[3]};
    a.out[i] = nabwa::sa_walk_row(s, l2, iv, a.rows[i]);
}

template <class Intv>
int launch(const Launch& a, const Intv& iv, cudaStream_t st) {
    sa_thread_kernel<Intv><<<(a.n + THREADS - 1) / THREADS, THREADS, 0,
                             st>>>(a, iv);
    return (int)cudaGetLastError();
}

}  // namespace

// params: l2[0..3], primary0, primary1 (uint32).  Rows [0, n0) of `rows`
// (uint32 [n], each <= seq_len) walk bank0 with sample sa0 and `$` row
// primary0, rows [n0, n) bank1, sa1, primary1; out: uint32 [n].  intv in
// [1, 2^31).  Returns cudaGetLastError().
extern "C" int nabwa_sa_lookup(const uint32_t* params, const void* bank0,
                               const void* bank1, const void* sa0,
                               const void* sa1, uint32_t intv,
                               const void* rows, int n, int n0, void* out,
                               void* stream) {
    if (n == 0) return 0;
    Launch a;
    a.s[0] = nabwa::SaStrand{(const uint32_t*)bank0, (const uint32_t*)sa0,
                             params[4]};
    a.s[1] = nabwa::SaStrand{(const uint32_t*)bank1, (const uint32_t*)sa1,
                             params[5]};
    for (int j = 0; j < 4; ++j) a.l2[j] = params[j];
    a.rows = (const uint32_t*)rows;
    a.out = (uint32_t*)out;
    a.n = n;
    a.n0 = n0;
    const cudaStream_t st = (cudaStream_t)stream;
    if (nabwa::is_pow2(intv))
        return launch(a, nabwa::intv_pow2(intv), st);
    return launch(a, nabwa::intv_magic(intv), st);
}

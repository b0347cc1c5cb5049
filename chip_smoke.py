#!/usr/bin/env python3
"""On-card smoke run of nabwa_tpu_torch, the `aln`, `samse`, `sampe`,
`bwasw` and `bam2bam` paths, the hybrid split, the data-parallel mesh,
the probes, the `index` CLI, bam2bam's remote workers and colour space on
one NVIDIA GPU.

    python3 chip_smoke.py [--glen BP] [--reads N] [--pairs N] [--batch B]
                          [--retry-stack S] [--long-reads N] [--profile]

Run from the root of a checkout.  It imports the port (`nabwa_tpu_torch`),
`tests/genomes.py` and the standard library, never the JAX package.
Phases, any failure exits non-zero:

1. the card's name and power limit (nvidia-smi) and the nvcc build of the
   kernels from csrc/ (seconds, ptxas register report); the run fails if
   ptxas reports a spill in either form of C1, C4 or C6 (the state in
   shared or in device memory), in C2, in C3 (either interval test) or
   in any form of C5 (the register form at each K, the wide form's two),
   or a stack frame in C3;
2. kernel C2 (csrc/cal_width.cu) against the plain PyTorch cal_width on
   CUDA tensors: the first 2048 reads of the main path, the four planes
   (both strands, the reads and their seed suffixes) in one launch, 8
   lanes a row, exact against four plain calls and timed, and one plane
   alone; then C2's edge launches
   (`check_cal_width_edges`, numpy seed CW_EDGE_SEED): rows with N codes,
   all N, length 0, 1 and L, seed lengths 0 and SL, B = 1 and 0, exact;
3. kernel C1 (csrc/dfs.cu) against the plain PyTorch DFS on CUDA tensors,
   with the engine's own batch inputs and statics: the same 2048 reads at
   the tier-0 settings, then the reads tier 0 flagged at the retry
   settings; exact on every column but the kernel's own telemetry (fin,
   iters), each read's state in shared memory and forced into device
   memory (all columns equal across the two); blocks, warps a block,
   shared bytes a warp, the slowest
   read's iterations and us an iteration, each form's time.  Then C1's
   edge launches (`check_dfs_edges`, `dfs_edge_data`), exact against the
   plain DFS in both forms: a read of all N and one of length 0, a slot
   pool of 2, a hit list of 1, one iteration, max_entries 3, gapped reads
   whose hits repeat an interval, nonstop, loggap and no-gap-extension
   modes, a 20 bp seed, a read that runs the 16-bit sequence counter out,
   a 7,150 bp read whose state only device memory holds, and B = 1 and 0;
4. the aln path at the bench's size: a 64 Mbp random genome (seed 99)
   indexed by the port's host build, 32768 x 100 bp reads at 1 % error
   (seed 100).  After a warm-up batch the engine's card-only route
   (`host_frac=0`) is timed, with host seconds per part of `run_chunk`,
   and at most 20 % of its reads may fall through to the host.  Then the
   hybrid split on a fresh engine, warmed as bench.py warms it (a
   device-only chunk of one slice, a second of four for the clean rate,
   one hybrid chunk of four): the median of 3 timed hybrid `run_chunk`s
   on the 32768 reads, each with the card's share (`n_dev`, which must
   be above 0), both rate EMAs, the planned host share, the card share's
   overflow drained on the host and the seconds per part; C1 and C2 must
   have launched, once each a slice.  The split's constants re-derived:
   the device route's seconds on a one-slice chunk of 64 reads (the fixed
   per-chunk cost, beside `AlnEngine.DEV_LAT`), the card-only route's
   tier-0 rate and the host engine's rate (beside `DEV_RATE0` and
   `HOST_RATE0`).  Then, with every launch count at 0, `python -m
   nabwa_tpu_torch aln --device cuda` runs in-process, through the
   hybrid by default, and once more in a process of its own whose
   kernels build cold into an empty directory, as in a new checkout, on
   the bench reads twice over in two chunks: C1 and C2 must launch in
   each chunk, so the first chunk's window has not benched the card.
   Every `.sai` must be byte-identical to the shared host engine's
   (native/dfsgap.cpp), and every kernel must have launched.  The
   host-drained reads and the hybrid's host share are solved by that same
   host engine, so for them the comparison holds the host engine against
   itself;
5. kernel C3 (csrc/sa_lookup.cu) against the plain PyTorch sa_lookup and
   the native host walk on every SA row samse asks for on phase 4's
   `.sai`, both strands in one launch, exact, timed beside each strand
   alone, the two one-strand launches in turn and strand 1's rows twice
   on one bank; the rows' step counts and the longest row alone, its
   time a step.  Then C3's edge launches (`check_sa_edges`, numpy seed
   SA_EDGE_SEED): rows 0, primary and its neighbours, seq_len and sampled
   rows on both strands, one row, either strand empty, none, and the
   banks walked at sa_intv 24 and 1, exact;
6. a gapped read set on the same genome (32768 x 100 bp, 1 % error, a
   1-base indel in half the reads, seed 101) aligned by the host engine;
   kernel C4 (csrc/banded_global.cu) against the plain PyTorch DP on the
   first device batch of its samse refine jobs: score, end type and the
   whole traceback lattice, exact;
7. samse on both read sets, on the card (C3, C4) and on the host reference
   route (native SA walk and DP): byte-identical SAM, reads/s and host
   seconds per part of each; every C4 launch of the card runs replayed
   against the plain DP, exact (`samse_launches_checked`,
   `samse_total_ms`);
8. the CLI chain on the gapped reads, every launch count at 0 before each
   command: `aln --device cuda` (its `.sai` equal to the host engine's,
   C1 and C2 launched), then `samse --device cuda` (its SAM equal to the
   host reference route's, C3 and C4 launched);
9. a paired read set on the same genome: 32768 pairs x 100 bp, insert
   size 300 +- 30, 1 % substitutions and 10 % broken mates (half with
   every second base of read 2 replaced, half with read 2 moved far; the
   pair model of tests/test_sampe.py, seed 102), of which the last 1/64
   are mates only the rescue places (read 2 with three seed substitutions
   against its true place and an exact copy on a decoy contig of the
   genome, as tests/test_torch_sampe.py builds them); both ends aligned
   by the host engine;
10. sampe on that set, on the host reference route (native SA walk,
   local SW and DP) and on the card (C3, C4, C5), recording the arguments
   of every C5 and C4 launch of the card run: pairs/s and host seconds
   per part of each;
11. kernel C5 (csrc/local_fwd.cu) against the plain PyTorch local-SW
   forward pass, and C4 against its plain DP, on every launch recorded in
   phase 10: the rescue's forward rounds (each launch's jobs, L1, L2,
   C5's form and time logged), its path recovery (per-pair bands
   doubled on retry, gap_end -1) and any refine batch; every output
   exact.  C5's edge launches (`check_local_edges`, numpy seed
   LOCAL_EDGE_SEED), exact: one in each form (the register form at K 2,
   4, 8, 16, the wide form at L1 600, 1024, 1025 and 2000 in shared
   memory, 2000 again forced into device memory, 30,000 in device
   memory), windows of 1 and 33 columns, no positive cell, ties in one
   row and in two rows, a job whose answer the E chain's gate decides;
   and K 2, 4 and 8 timed against K=16 on the same jobs
   (`local_form_ms`).  Then the two routes'
   SAM must be byte-identical, and the rescue must have placed (XT:A:M)
   at least half as many mates as were built for it;
12. the CLI chain on the pairs, every launch count at 0 before each
   command: `aln --device cuda` on each end (each `.sai` equal to the host
   engine's, C1 and C2 launched), then `sampe --device cuda` (its SAM
   equal to the host reference route's, C3, C4 and C5 launched);
13. a long-read set on the same genome: 384 x 1000 bp reads of the model
   of tests/test_bwasw.py (3 % substitutions, an indel in half the reads,
   chimeric tails, a run of N in a tenth, either strand; seed 103);
14. bwasw on that set, on the host reference route (the native
   whole-batch driver, one thread per core) and on the card (C3, C4, C6),
   recording the arguments of every C6, C4 and C3 launch of the card run:
   reads/s and host seconds per part of each.  Then every recorded launch
   against its plain version: C6's score, end cell and window cells, C4's
   score, end type and whole lattice at 1 kb lengths, C3's positions, all
   exact; and the two routes' SAM byte-identical.  C6's launches made
   inside stage B (`_replay`: a read with N bases, a few jobs) are the
   single-read launches, the rest the batched ones: each set's summed
   time, and the widest single-read launch timed alone (`single_ms`,
   `single_queued_ms`).  Then C4's and C6's edge launches (`check_dp_edges`,
   numpy seed DP_EDGE_SEED), exact against the plain versions: C6 at one
   job of bwasw's widest window (L1 1250, L2 969) and one whose window is
   its whole target, bands wider than a pass of 32 x 4 cells, windows
   narrower than the lanes, len2 0 and 1, rows tied at their maximum, and
   a job of L1 30,000 whose state the wrapper keeps in device memory; C4
   at b2 == len2, per-pair bands with gap_end -1, rows wider than a pass
   with wide and narrow bands, len2 0 and 1, ties, b1 and b2 drawn freely,
   go < 0, and L1 18,000 (state in device memory); and bwasw's largest C4
   and C6 launches again with their state forced into device memory.  The
   run fails if ptxas reports a spill in either kernel;
15. the bwasw CLI with every launch count at 0: `bwasw --device cuda` (its
   SAM equal to the host reference route's, C3, C4 and C6 launched);
16. bam2bam on an unaligned BAM (built with the port's io/bam.py) of
   phase 9's pairs as read group rg1, a quarter as many pairs more at
   insert size 500 +- 50 (seed 104) as rg2 and as many reads of the
   gapped set as rg1 singletons: on the host reference route at one
   worker, and on the card at one and at four worker threads sharing one
   engine, recording every C1-C5 launch of both card runs (each C5
   launch's L1 and form logged).  The three BAMs
   must be byte-identical, the four-worker run must launch each kernel as
   often and with the same shapes as the one-worker run, at most 20 % of
   the one-worker run's aligned reads may drain to the host, every C3
   (both strands a launch), C4 and C5 launch of that run must equal its
   plain version (and its
   smallest tier-0 C1 launch and largest four-plane C2 launch theirs, as
   in phases 2-3), and the rescue must place at least half of the
   rescue-only mates;
17. the bam2bam CLI with every launch count at 0: `bam2bam --device cuda`
   (its BAM equal to the host reference route's, C1-C5 launched);
18. the probes (nabwa_tpu_torch/probes/), inputs made with numpy from a
   fixed seed: kernel C7 (csrc/probe_rowload.cu) at probe 1's 256 rows of
   a [4096, 128] table (also both ends of the table and repeats, and the
   index off a 16-byte boundary, which it reads as int32; indices out of
   range, int64, [BB, 2] and [1, BB] indices, transposed and misaligned
   tables and an input on another card where the machine has two are
   refused, none launched; queued at C20_ROWS rows), beside
   torch.index_select; C8 (csrc/probe_dma.cu)
   at T=64 for N 64 and 128, unroll on and off, every `src`, on tables of
   100,000 and 4,000,000 rows, out, the whole stage and each round's
   witness: its grid form (one block a round of cp.async copies) timed
   warm, queued, on the host's clock beside torch.index_select of the same T N rows, and with
   L2 flushed before each launch, its serial form (one block, the rounds
   in order, the witness of a round's latency) timed warm, queued and
   cold, and both at the edges (`check_dma_edges`: T 0, 1 and 1,000, N 1
   and MAX_N, n_rows 1, a table longer than n_rows); C9
   (csrc/probe_dfs_shape.cu) at 256 x 128 x 200 and 2048 x 128 x 200 in
   both forms, the lean one and the witness (the first design), each
   exact, timed and queued, and each stamped once (`check_dfs_shape`:
   the stage split, the calibration latencies and the SM clock), and
   both at S 32, 64 and 96 (256 reads, 200 iterations); C10 at probe
   5's 256 x 128 x 100, timed and queued (before all of them the launch path,
   `check_launch_path`: `stream_of` is the current stream, default and
   side, C14, C29, C28, C27, C20, C7, C15, C8 and C11 exact on a side
   stream, C14's, C29's, C20's, C7's and C8's launch counts exact over
   COUNT_THREADS threads, C8's and C11's refusals before any launch, and
   its host split, `launch_split`: each step of C14's, C11's, C29's,
   C28's, C27's, C20's, C7's, C15's and C8's wrappers as they stand over
   SPLIT_CALLS calls, the host's clock and one
   synchronize, beside torch.sum, `x + 1`, torch.gather and
   torch.index_select); C11-C14
   (csrc/probe_pallas2.cu) at scripts/probe_pallas2.py's shapes: C11 x +
   1 on [8, 128]; C12's 2 x 256 row loads from a [32768, 128] table, the grid form
   (either unroll; also on index_cases' four index sets, idx 2 and 3
   columns wide, BB 0, 1, 257 and 5,001, seed LOADS_EDGE_SEED) and the
   serial forms, one warp, rolled and unrolled (`serial_*`); C11, C12
   and C14 timed by CUDA events, queued and by the host's clock
   (LAUNCH_REPS calls, one synchronize), each beside its library call;
   C13's 50 pop rounds on [256, 256] (out, the whole final key and each
   round's minimum, on the script's input, on forced ties and on sums
   that wrap); C14's lane sum of [512, 128];
   C15-C18 (csrc/probe_pallas.cu) at scripts/probe_pallas.py's shapes:
   C15 probe 2's 256 rows of a [4096, 128] table with the indices staged
   in shared memory (also both ends of the table and repeats, and the
   index off a 16-byte boundary; refused as C7's but for the index's
   shapes; queued at C20_ROWS rows), C16 probe
   3's popcount of [256, 128] (also every int32, INT32_MIN, -1 and
   INT32_MAX), C17 and C18 probes 4 and 4b, 50 rounds over a [256, 128]
   pool with a scalar and a vector carry (on the script's values, within
   8 of both ends of int32 and on heavy ties), with `us_per_iter`; C19
   (csrc/probe_pallas.cu) probe 4c's 50 x 20 steps over [256, 128] (also
   near both int32 ends and on every residue mod 8), with `us_per_iter`;
   C20 and C21 (csrc/probe_pallas2.cu) probe C's lane gather of [256,
   128] (also indices all 0, all 127, a permutation of each row, x at
   +-(2^31 - 1); indices out of range, misaligned, int64 and transposed
   inputs and one on another card where the machine has two are refused,
   none launched; queued at C20_ROWS rows) beside torch.gather,
   and probe D's 50 rounds of pushes into five [256, 256] buffers (out,
   the five buffers and top, on the script's input, near both int32 ends,
   3 pushes a round and none); C22 (csrc/probe_sem.cu) scripts/
   probe_sem.py at K 1, 4 and 16, every launch held to the plain version
   as far as the card's timing allows (the stage exactly, out[K] = 0 and
   out[K + 1] = INT32_MIN; out[w] = 128 (landed - w), the copies landed
   by read w never fewer than w, more than K or falling with w) and
   out[0], the copies landed when it read, counted over the timed
   launches; the others exact against their plain versions.  C23
   (csrc/probe_spill.cu) scripts/probe_spill.py at its K=24, T=2000 on its
   four shapes in both forms, the lane form (the probe's route; also at
   SPILL_LANES lanes a group) and the witness, queued in turns, then both
   at [64, 128] for every K the witness is built for, the witness with its
   registers and spill bytes from the build's ptxas report (the run fails
   unless some K spills, and if any instantiation of the lane form spills
   or takes a stack frame; `ptxas_from_cache` says whether the report
   came from this run's nvcc or from the one kept beside the library); C24
   (csrc/probe_colops.cu) scripts/probe_colops.py at its T=2000, K=64 on
   its five shapes, and at T=3 for K 1-3 and 5-7 (its K loop's unrolling
   by 4 leaves every remainder); C25 and
   C26 (csrc/probe_pallas3.cu) probes 7 and 8 of scripts/probe_pallas3.py
   at their shapes; each exact at the scripts' inputs and at seeded
   random int32 with values within 8 of both ends (C26 also with negative
   and tied scalars); C27-C30 (csrc/probe_pallas3.cu) probes 1, 1b, 3 and
   4 of that script at its shapes, exact at its inputs and, over int32
   tables, at indices on both ends of the table, four repeated rows and
   one row everywhere (C29 also a permutation of each column, C30 int32
   edges); indices out of range and misaligned inputs are refused on the
   card, and by C27, C28 and C29 also int64, non-contiguous and
   transposed inputs and one on another card where the machine has two,
   none launched; C27 and C28 also queued at C28_ROW_PAIRS row pairs,
   C7's, C15's, C20's and C27-C29's `queued_ms` over C11's
   (`queued_over_c11`);
   C31-C35 (csrc/probe_pallas3.cu, `check_reductions`) probes 2
   (C31 `native`, C32 `roll`, C33 `subl`), 5 and 6 of that script at its
   shapes: C31-C34 exact at its inputs and at int32 edges (C31-C33 values
   within 8 of both ends with each row's or column's minimum repeated, and
   values within 8 of INT32_MAX; C32 in both forms, the lane form and the
   witness, queued in turns, with both forms' ptxas; C34 in both forms, the
   grid form and the witness, a negative s[0, 0] and values near INT32_MAX
   that wrap, the grid form also at P5_GRID_SHAPES, queued in turns), C35
   bit for bit at its inputs, at a random float32 w, at x over int32 and
   at P6_TAIL_SHAPES; misaligned and wrong-shape inputs, and C35's inputs
   past a launch's blocks, are refused on the card with nothing launched.
   Then each probe's entry
   point (`python -m
   nabwa_tpu_torch.probes.probe_pallas`, `.probe_dma`, `.probe_dfs_shape`,
   `.probe_pallas2`, `.probe_sem` at K=4, `.probe_spill` and
   `.probe_colops` at their scripts' default K and T, `.probe_pallas3`,
   `--device cuda`, the scripts' default arguments) once in a process of
   its own, the eight side by side, every launch counter starting at 0;
   its result lines are logged and each of C7-C35 must have launched.
19. the data-parallel mesh (`nabwa_tpu_torch/parallel/mesh.py`, with every
   launch count at 0): `entry.dryrun_multichip` over every visible card
   and over a two-shard mesh naming cuda:0 twice, so that the shard-and-
   join code runs the kernels (the sharded step with C3 on the best hits
   and the insert-size histogram equal to one device's, and bam2bam on
   two read groups, 4 workers, chunk 128, with the engine on the mesh,
   its BAM equal to the single-device BAM record for record); then
   `AlnEngine(mesh=)` on that two-shard mesh over phase 4's reads, its
   `.sai` byte-identical to the host engine's.  C1, C2 and C3 must have
   launched.  With one card no measurement across cards exists, and the
   run says so.
20. `python -m nabwa_tpu_torch index` in a process of its own on the
   cell's FASTA (SA-IS, as the in-process build): its eight files must
   equal the in-process build's, and its seconds are logged.  Then, with
   every launch count at 0, the bam2bam CLI of phase 17's input as a
   coordinator with no local worker (`-t 0 -p` a free port,
   NABWA_LEASE_S=NET_LEASE_S) and NET_WORKERS `worker --device cuda -t
   NET_WORKER_THREADS` processes (`WORKER_DRIVER`: each prints its chunks
   and its C1-C5 launches) on the one card.  The first worker that holds
   a chunk after the coordinator has taken a result of its own is
   stopped, and killed if it still holds the chunk once any result it
   had sent is in.  The phase fails unless the BAM equals phase 17's but
   for the @PG command line, each worker ran a chunk, the survivors
   launched C1 and C2, a chunk was resent and every process ended; its
   records/s stand beside phase 17's.
21. colour space (`colour_phase`): `python -m nabwa_tpu_torch index -c` in
   a process of its own on the cell's FASTA (its `.nt.pac/.ann/.amb`
   equal to phase 4's `.pac/.ann/.amb`, its `.pac/.ann/.amb` to
   `pac2cspac`'s of them, its seconds); COLOUR_READS colour reads of 50
   colours (2 % colour errors, a `.` in a tenth, a 1-base indel in the
   fragment of a tenth, seed 105) and COLOUR_PAIRS pairs in the SOLiD
   orientation (insert 300 +- 30, seed 106, the last COLOUR_RESCUE with a
   mate only the rescue places, taken from phase 9's decoy contig).  With
   every launch count at 0: `aln -c` through the CLI (the hybrid), its
   `.sai` equal to the host engine's; samse and sampe (BWA_PET_SOLID,
   cs2nt against the `.nt` pac) on the host reference route and on the
   card, byte-identical SAM, reads/s, pairs/s and host seconds per part
   (`cs2nt` on its own).  C1 and C2 must launch in aln -c, C3 and C4 in
   both, C5 in sampe, and C4 in the second refine round (against the
   `.nt` pac); MIN_PROPER of the ends must come out properly paired and
   the rescue must place a mate.  One of aln -c's C1 launches and every
   C2-C5 launch of the phase are held to their plain versions (exact).
Phase 4's CLI run, phase 12's chain, phases 15 and 17, phase 19, phase
20 (the coordinator's launches and the surviving workers') and phase
21's aln -c, samse and sampe card runs are the main paths, phase 18's entry points the probes' path: their launch counts,
summed, are the `launches` of the kernels line.  NABWA_FORCE_NATIVE,
NABWA_HOST_FRAC and NABWA_DEV_SHARE choose routes by hand: the run fails
at its start if any of them is set.  Every aln CLI run (phases 4, 8,
12), the hybrid's timed runs, the mesh engine's run and the bam2bam CLI
run must launch C2 once for each C1 launch.
With --profile, torch.profiler runs over one more aln run after phase 4's
timed run and over one more bwasw card run after phase 14: the card's
busy share and the device time of each kernel.

Every kernel's `bound_ms` is the least time the card could take for the
same work on this run's inputs: the larger of the bytes it must move over
HBM_BYTES_PER_S and its integer operations over INT_OPS_PER_S (see
`bound`); `bound_int32_ms` the larger of the same bytes' time and the
int32 instructions' time by pipe: those only the integer ALU pipe runs
over INT32_OPS_PER_S, all of them over ISSUE_PER_S (`Work`).  No single
PyTorch call computes
any of C1-C6, C8-C10, C13, C17-C19 or C21-C26, so `library_ms` is null
for each (`library_why` says why for the probes); C7's, C12's, C15's,
C27's and C28's is torch.index_select, C11's `x + 1`, C14's torch.sum
into int32, C16's torch.bitwise_count where the card's torch has it,
C20's and C29's torch.gather, C30's the copy `x[:, :16].reshape(64,
128)` makes, C35's torch.matmul of the cast x and w (with the cast, and
on a cast made beforehand as `library_precast_ms`); none computes C31-C34
(`library_why`).  Beside `ms` (CUDA events over
back-to-back launches, which wait on the host's enqueue when it is the
slower), C7 and C11-C35 carry
`queued_ms`, the same launches queued behind a sleeping kernel (the
card's own time a launch), every probe with a library call
`library_queued_ms`, and C7, C11, C12, C14, C15, C20 and C27-C29
`wall_ms` and `library_wall_ms`, the host's clock a call; C7, C11, C14,
C15, C20 and C27-C29 carry `host_split`.
The probes' bounds count their table rows once (the distinct rows the
run reads) and their operations as the header of each .cu file counts
them.
C4's and C5's `ms` and `plain_ms` are those of the largest launch of
sampe's card run; C4's on samse's refine
batch of phase 6 stand beside them as `samse_refine_*`, and C4's and
C3's on bwasw's largest launch as `bwasw_*`.  C6's are those of the
largest launch of bwasw's card run, its bound counted from the window
cells that launch computed; C4's bound counts the cells inside each
pair's band and the whole lattice's bytes.  `total_ms` (C6) and
`bwasw_total_ms` (C4, C3) sum the device time of every launch of the
bwasw card run, each timed once as it is replayed; C6's `total_ms` splits
into `batched_total_ms` and `single_total_ms` (stage B's single-read
launches, `single_launches` of them), and `single_ms` / `single_queued_ms`
time the widest of those alone (`single_shape`: jobs, L1, L2); C4's and
C6's `device_state_ms` (C4's `bwasw_device_state_ms`) time the largest
launch with its state forced into device memory, `ptxas` holds both
kernels' registers, static shared memory and spills, `edge_launches` the
shapes of the edge launches checked; the `bam2bam_*` fields
of C2-C5 are those of bam2bam's one-worker card run (C1's
`bam2bam_err` of its replayed launch), and `bam2bam_launches` of every
kernel its count in phase 17; `colour_launches` is each kernel's count
in phase 21's main-path runs and `colour_err` (C1-C5), `colour_ms`,
`colour_plain_ms` and `colour_total_ms` (C2-C5) those of its checks.  C2's `ms` is phase 2's four-plane launch,
8 lanes a row (`form`), `ms_per_plane` a quarter of it and
`single_plane_ms` the one-plane launch of the reads' strand 0; its bound
counts two Occ blocks a position of each plane.  C5's `form` is its timed
launch's, `launch_forms` and `bam2bam_launch_forms` each recorded
launch's [jobs, L1, L2, form, K, ms], `bam2bam_smallest` the smallest of
bam2bam's launches timed alone (`us_per_row`: its ms over its L2 rows)
and `form_ms` K 2, 4 and 8 against K=16 on the same jobs
(`local_form_ms`).  C2's and C5's `ptxas` hold each instantiation's
registers and spills and `edge_launches` the shapes of their edge
launches.  C3's `ms` is phase 5's launch of samse's rows of both strands
(`rows_by_strand`), beside `strand_ms`, `pair_ms` and `same_bank_ms`;
`max_steps`, `mean_steps` and `total_steps` count its rows' invPsi steps
(`bwasw_max_steps`, `bam2bam_max_steps` those of the largest launch
there), `lone_us_per_step` is the longest row's launch alone over its
steps, `lone_chain_ms` max_steps times that, and `chain_bound_ms`
max_steps times C12's serial load (phase 18's `serial_ns_per_load`): a
chain of one dependent load a step.  Its bound counts one Occ block a step;
`ptxas` holds both interval tests' registers, stack and spills.  C9's
`ms`, `queued_ms` and `us_per_iter` are its lean form's at 256 reads,
`witness_*` the witness's (`queued_ms_turns` each queued reading);
`shapes` holds both reads counts with each form's stamped `split`
(`stages`: median, p90 and share of each stage; `iteration`;
`latency_cycles` of a dependent IMAD, C24's step, a redux.sync, a
shuffle and a shared load; `sm_clock_ghz`; `stamped_ms`) and
nvidia-smi's `clocks.sm` beside; `chain_bound_ms` of C9, C23, C24, C25
and C34 prices each one's dependent path (`chain_steps`) at those
latencies and C12's serial load (`chain_bounds`).  C23's and C34's `ms`,
`queued_ms` and `launches` are their new forms' (C23's lane form at
`lanes` lanes a group, C34's grid form), `witness_*` the first design's,
kept beside as the witness; C23's `shapes` and `k_sweep` hold both,
`lane_ptxas` the lane form's registers by M, and C34's
`witness_smem_ceiling_ms` its witness's one-SM shared-memory ceiling.

Data and the index are cached under the temp directory.  The last two
lines of standard output are the card line and
{"ok": true, "device": {...}}; the line before them holds the kernels'
launch counts, errors, times and bounds.  Nothing is printed on standard
output before the run has passed, and nothing at all without a CUDA device
or outside a checkout.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
MAX_HOST_SHARE = 0.20
CHECK_B = 2048
# one pair in RESCUE_SHARE of phase 9's set is a mate only the rescue places
RESCUE_SHARE = 64
# bam2bam's second read group and its singletons: one in BAM_SHARE as many
# as phase 9's pairs each
BAM_SHARE = 4
# NVIDIA H100 SXM datasheet figures: HBM bandwidth,
# and the float32 rate outside the tensor cores, the sheet's only 32-bit
# non-tensor rate, taken for int32 operations too.  Hopper has half as many
# int32 lanes as float32 lanes, so the operations bound is optimistic.
# the engine's route knobs: the run measures the routes the engine chooses
ROUTE_ENV = ("NABWA_FORCE_NATIVE", "NABWA_HOST_FRAC", "NABWA_DEV_SHARE")
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
# int32 work, counted by pipe (`Work`, `bound_int32_ms`): the integer ALU
# pipe, 16 lanes a scheduler, 64 an SM a clock, x 132 SMs x the 1.98 GHz
# boost clock, 16.7e12/s, runs logic, shifts, compares, selects and
# min/max; every instruction also takes one of the 4 schedulers' issue
# slots, 32 lanes each, 128 an SM a clock, 33.5e12/s.  Adds, subtracts,
# multiplies, left shifts and moves count only towards issue, since IMAD
# can take them on the float pipe.  The rates are an inference from the
# data sheet and the CUDA guide's throughput table, not a published peak.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ISSUE_PER_S = 132 * 128 * 1.98e9


class Work:
    """Integer work of a launch, counted three ways: `ops`, the operations
    as the comment at the top of each kernel's .cu file counts them (for
    `bound_ms`); `alu`, the fewest instructions only the integer ALU pipe
    can run; `issue`, the fewest instructions in all.  Both instruction
    counts take the inner loop as the source writes it (loads, stores and
    loop control not counted), one instruction for an operation unless
    one Hopper instruction does several: LOP3 any logic of three inputs,
    IADD3 two adds, IMAD a multiply and an add, VIADDMNMX an add and a
    min or max, VIMNMX3 a max of three, ISETP a compare and-ed with a
    predicate; a select that keeps one side is a predicated move (issue
    only); popcounts, shuffles and votes count towards issue only."""

    __slots__ = ("ops", "alu", "issue")

    def __init__(self, ops, alu, issue):
        self.ops, self.alu, self.issue = ops, alu, issue

    def __add__(self, other):
        return Work(self.ops + other.ops, self.alu + other.alu,
                    self.issue + other.issue)

    def __mul__(self, n):
        return Work(self.ops * n, self.alu * n, self.issue * n)

    __rmul__ = __mul__


# integer work per unit: each kernel's inner loop, as the comment at the
# top of its .cu file counts the operations, and (alu, issue) as `Work`
# counts its instructions
# csrc/local_sw.cuh, one cell of the sweep: the two gated maxima of E
# (compare, VIADDMNMX), the diagonal's add and max with 0 and with E
# (VIMNMX3), F's VIADDMNMX, h's VIMNMX3, hcut's VIADDMNMX, the best
# cell's compare and two predicated moves
OPS_LOCAL_CELL = Work(23, 7, 12)
# csrc/dp_global.cuh, one cell of the band: three compares of the
# diagonal and its VIMNMX3, the band's two compares, the end's and i_ok's,
# from_m's compare and I's VIADDMNMX, D's gate and running max, dt's
# compare, the lattice byte's LOP3 (14); and 17 adds, subtracts and moves
OPS_GLOBAL_CELL = Work(40, 14, 31)
# csrc/extend.cuh, one cell of a row's window: h0's compare, five maxima
# (hpre, F's VIADDMNMX, h's VIMNMX3, hc's and ev's VIADDMNMX), hcut's,
# the three compares of the row's span and best (10); 6 adds and moves
OPS_EXTEND_CELL = Work(26, 10, 16)
# one Occ block's count, 8 words of: the word's mask, a shift, three LOP3
# (lo, hi, lo & hi) on the ALU pipe; three popcounts and 1.5 adds (IADD3)
OPS_OCC_BLOCK = Work(40, 40, 76)
OCC_BLOCK_BYTES = 48      # bwt.h:61-68, 4 counters + 8 words
# the probe mocks' operations per read and iteration, as the header of
# csrc/probe_dfs_shape.cu counts them.  C9: per staged row (its block
# offset), per word of the row's 8-word block, per slot, per read; two
# rows a read.  C10: per word of bank 0's row, per slot, per read.
OPS_SHAPE = (Work(6, 3, 5), Work(17, 6, 13), Work(16, 11, 16),
             Work(178, 70, 149))
OPS_PALLAS = (Work(8, 3, 7), Work(11, 5, 10), Work(10, 2, 7))
# C9's chain: one iteration's least dependent path, counted from the
# function (the header of csrc/probe_dfs_shape.cu) in dependent integer
# steps, warp reductions, shuffles and L2 row loads (the two side by
# side).  The pop: a lane's minimum of 4 keys (2), a reduction, the
# compare, select and 2-level minimum of the slot index held (3), a
# reduction, its register row and lane (1), the fields' select (2) and a
# shuffle: 8; the row index and its address (2); a load; the count: a
# shuffle of words 0 and 1, the block test (2), the word's mask (1), the
# and (1), a popcount (1), a lane's sum (2), a reduction: 7; the
# expansion: its first add and 10 rounds of 7 (the compare and its
# select, the shift and the xor, the and and the add, the add-and-
# minimum): 71; the push: the valid mask (1), a prefix's and and popcount
# (2), its compare (1) and the sum over 9 (2), the candidate's add (1)
# and the key's select (1): 8.  chain_bounds prices the steps.
C9_CHAIN = {"int": 8 + 2 + 7 + 71 + 8, "redux": 3, "shfl": 2, "load": 1}
# C10's chain an iteration, through kidx (the header of
# csrc/probe_dfs_shape.cu): slot 0's kidx by a shuffle, its mask and the
# row's address (2), an L2 row load, the count c3 (the shift, a LOP3, a
# popcount, the lane's two adds: 5), a redux.sync, the add of s1 + s3 +
# e_k (1), kidx's add and mask (2)
C10_CHAIN = {"int": 2 + 5 + 1 + 2, "redux": 1, "shfl": 1, "load": 1}
# The chains of C13, C17-C19, C21 and C31-C33 a round, step or push,
# counted from each function as its kernel's header counts it; a launch's
# path is a load, then these (`chain_bounds`).  C17 and C18: the lane's
# minimum of its 4 keys (2), a redux.sync, the compare and the select
# (2).  C13: a lane's minimum of its 8 slots (3), a redux.sync, the
# compare (1), f's select (1), the lane's sum of 8 (3), a redux.sync, slot
# 0's minimum (1).  C19: the and, the compare, the select of p + j, the
# shift, the xor and p * 3.  C21, a push of its busiest row: t's add and
# mask.  C31: the lane's minimum of 4 words (2), a redux.sync, the add.
# C32's lane form: the two in-lane minima (sh 64, 32), five of a shuffle
# and the minimum, the add; its witness: two minima whose registers are
# known, five of a shuffle, its register's select and the minimum, the
# add (P2_ROLL_WITNESS_CHAIN).  C33: a
# thread's minimum of its 32 rows (5), the partials' shared load, their
# minimum of 8 (3), the add.  (C33's barrier and C17's cluster barrier
# and remote store are not priced: no latency of theirs is measured.)
WHILE_CHAIN = {"int": 4, "redux": 1}
POP_CHAIN = {"int": 9, "redux": 2}
BODY_CHAIN = {"int": 6}
PUSH_CHAIN = {"int": 2}
P2_CHAIN = {"native": {"int": 3, "redux": 1}, "roll": {"int": 8, "shfl": 5},
            "subl": {"int": 9, "lds": 1}}
P2_ROLL_WITNESS_CHAIN = {"int": 13, "shfl": 5}
# C17's and C18's witnesses: warp instructions every warp issues a round,
# counted in the SASS of their loop bodies (`compare.py c17 . DIR`, its
# `sass_loops`): C18's 111; C17's 140 less the 14 of the carry's add
# that only warp 0 runs (left out, so the ceiling stays a lower bound).
# The 32 warps of the one SM share its 4 schedulers.
WHILE_WITNESS_ISSUE = {"probe_while_scratch": 126, "probe_while_vector": 111}
# C11 and C16: an add, a popcount a word; C14: an add (IADD3, two a
# instruction)
OPS_ONE = Work(1, 0, 1)
OPS_SUM = Work(1, 0, 0.5)
# C13 (csrc/probe_pallas2.cu): per slot once (the xor), per slot and round
# (7 minima for 8 slots a lane, the compare; the add and the clear
# predicated), per row and round (slot 0's minimum)
OPS_POP = (Work(1, 1, 1), Work(5, 1.875, 3.875), Work(1, 1, 1))
# C17 and C18 (csrc/probe_pallas.cu): per slot and round (3 minima for 4
# slots a lane, the compare, the predicated add), per row and round
OPS_WHILE = (Work(4, 1.75, 2.75), Work(1, 0, 1))
# C19 (csrc/probe_pallas.cu): per element and step, the LOP3 of the
# select's test, the shift, the xor; the predicated add and p * 3
OPS_BODY = Work(8, 3, 5)
# C20 (csrc/probe_pallas2.cu): per output element, the shift and a
# predicate of i & 3; four shuffles, two more selects
OPS_GATHER = Work(9, 2, 8)
# C21 (csrc/probe_pallas2.cu): per row and round (the and, three
# compares), per push (the xor and the mask; three fields and the add)
OPS_PUSH = (Work(4, 4, 4), Work(6, 2, 6))
# C23 (csrc/probe_spill.cu) per value and round, C24 (csrc/probe_colops.cu)
# per step: IMAD, the shift, the xor; C25 (csrc/probe_pallas3.cu) per
# element and step: the add, the shift, the xor; C26: the compare, two
# predicated adds
OPS_SPILL = Work(4, 2, 3)
OPS_COLOPS = Work(4, 2, 3)
OPS_P7 = Work(3, 2, 3)
OPS_P8 = Work(4, 1, 3)
# csrc/probe_pallas3.cu per word and round: C31 the row minimum's share and
# the add (2 operations); the in-lane minimum of four words, 0.75 a word,
# on the ALU pipe, its redux.sync (0.25) and the add on issue.  C32's lane
# form a lane's 3 minima of its four words, 5 after the shuffles and 4
# adds, 12 for 4 words (3); VIMNMX and VIMNMX3 and the 5 minima on the ALU
# pipe (7 / 4), with the 5 shuffles and the adds on issue (16 / 4).  Its
# witness seven minima and the add (8); of its seven steps five shuffle, a
# shuffle and at least one select a word each (issue).  C33: the column
# minimum's share and the add (2); 31 minima for a thread's 32 rows and 8
# over the partials, 39 / 32 a word.  C34 per word and inner round: the
# add.  C35 per product of an out element: the float32 multiply and add
# (2), with the conversion (issue only)
OPS_P2 = {"native": Work(2, 0.75, 2.0), "roll": Work(3, 7 / 4, 4),
          "subl": Work(2, 39 / 32, 2 + 39 / 32)}
OPS_P2_ROLL_WITNESS = Work(8, 7, 18)
OPS_P5 = Work(1, 0, 1)
OPS_P6 = Work(2, 0, 3)
SPILL_SWEEP_SHAPE = (64, 128)     # C23's K sweep, at the script's T
SPILL_LANES = (2, 4, 8)           # the lane form's groups tried at K 24
# C34's grid form past the witness's shared memory, and at a word count
# that is not a multiple of 4 (16,383)
P5_GRID_SHAPES = ((512, 128), (129, 127))
# C35 at [R, K] x [K, N] past the script's shape: a tile's tail of K (130,
# 260), K not a multiple of 4 (130, 37), N not a multiple of 4 (5, 17) or
# leaving half a block's columns (12), R leaving a block's rows, two whole
# tiles (256), K 0
P6_TAIL_SHAPES = ((7, 130, 5), (9, 260, 12), (6, 256, 16), (13, 37, 17),
                  (4, 0, 8))
SMEM_BYTES_PER_CLOCK = 128        # one SM's shared memory
ROW_BYTES = 512               # one 128-word int32 table row
I32_MIN, I32_MAX = -2**31, 2**31 - 1
# a sleep on the card long enough for the host to enqueue 200 launches
# behind it (queued_ms): ~50 ms at the H100's clocks
QUEUE_SLEEP_CYCLES = 100_000_000
PROBE_SEED = 18
DP_EDGE_SEED = 21
DFS_EDGE_SEED = 22
LOCAL_EDGE_SEED = 23
CW_EDGE_SEED = 24
SA_EDGE_SEED = 25
LOADS_EDGE_SEED = 26
# calls a step of a wrapper is timed over in the host split (launch_split),
# and the back-to-back launches C11's, C12's and C14's ms and wall_ms and
# their library calls' are timed over
SPLIT_CALLS = 10_000
LAUNCH_REPS = 1000
# threads launching C14 (and C29) together, and calls each, for the
# launch count
COUNT_THREADS, COUNT_CALLS = 4, 250
# C28's row pairs a launch, queued, to take its launch floor apart
C28_ROW_PAIRS = (1, 16, 256)
# rows of C20's x and i it is queued at, one launch each (and of C7's and
# C15's index)
C20_ROWS = (1, 16, 256)
# C1's edge launches: the retry tier's slot pool and hit list (tier 0's
# pool of 256 overflows on every gapped edge read), at most 100,000 steps
DFS_EDGE_STATICS = dict(stack_cap=1024, hits_cap=128, max_iters=100000)
# check_sa_lookup's figures that go into C3's kernels entry
SA_FIELDS = ("max_steps", "mean_steps", "total_steps", "strand_ms",
             "pair_ms", "same_bank_ms", "lone_ms", "lone_us_per_step")
# check_dfs's figures that go into C1's kernels entry, for each tier
DFS_FIELDS = ("slowest_iters", "us_per_iter", "warps", "blocks",
              "smem_bytes_per_warp", "shared_ms", "device_ms")
DMA_T = 64                    # scripts/probe_dma.py:28
DMA_ROWS = (100_000, 4_000_000)
L2_FLUSH_BYTES = 256 << 20    # five times the H100's 50 MB L2
SEM_K = 4                     # scripts/probe_sem.py's default K
# the probes' entry points, each run once in a process of its own with the
# scripts' default arguments and its own environment (none of ROWS, T and
# K but these), and the launch counter of each probe kernel
PROBE_ENTRIES = {"probe_pallas": {}, "probe_dma": {}, "probe_dfs_shape": {},
                 "probe_pallas2": {}, "probe_sem": {"K": str(SEM_K)},
                 "probe_spill": {}, "probe_colops": {}, "probe_pallas3": {}}
PROBE_COUNT = """\
import importlib, json, sys
from nabwa_tpu_torch.probes import (probe_colops, probe_dfs_shape, probe_dma,
                                    probe_pallas, probe_pallas2,
                                    probe_pallas3, probe_sem, probe_spill)
mod = importlib.import_module("nabwa_tpu_torch.probes." + sys.argv[1])
rc = mod.main(sys.argv[2:])
print(json.dumps({"probe_rowload": probe_pallas.launches_rowload,
                  "probe_dma": probe_dma.launches,
                  "probe_dma_serial": probe_dma.launches_serial,
                  "probe_dfs_shape": probe_dfs_shape.launches,
                  "probe_pallas_dfs_shape": probe_pallas.launches_dfs_shape,
                  "probe_empty": probe_pallas2.launches_empty,
                  "probe_loads": probe_pallas2.launches_loads,
                  "probe_pop": probe_pallas2.launches_pop,
                  "probe_lanereduce": probe_pallas2.launches_lanereduce,
                  "probe_smem_idx": probe_pallas.launches_smem_idx,
                  "probe_popcount": probe_pallas.launches_popcount,
                  "probe_while_scratch": probe_pallas.launches_while_scratch,
                  "probe_while_vector": probe_pallas.launches_while_vector,
                  "probe_body_scale": probe_pallas.launches_body_scale,
                  "probe_lane_gather": probe_pallas2.launches_lane_gather,
                  "probe_scalar_push": probe_pallas2.launches_scalar_push,
                  "probe_sem": probe_sem.launches,
                  "probe_spill": probe_spill.launches,
                  "probe_colops": probe_colops.launches,
                  "probe_p7": probe_pallas3.launches_p7,
                  "probe_p8": probe_pallas3.launches_p8,
                  "probe_p1": probe_pallas3.launches_p1,
                  "probe_p1b": probe_pallas3.launches_p1b,
                  "probe_p3": probe_pallas3.launches_p3,
                  "probe_p4": probe_pallas3.launches_p4,
                  "probe_p2_native": probe_pallas3.launches_p2_native,
                  "probe_p2_roll": probe_pallas3.launches_p2_roll,
                  "probe_p2_subl": probe_pallas3.launches_p2_subl,
                  "probe_p5": probe_pallas3.launches_p5,
                  "probe_p6": probe_pallas3.launches_p6}))
sys.exit(rc)
"""


def bound(n_bytes, work=0):
    """(bound_ms, bound_by, bound_int32_ms) of a launch that moves n_bytes
    and does `work` (a `Work`, 0 for none): the larger of the bytes'
    time at the HBM rate and the operations' time at the integer rate, and
    which of the two it is; then the largest of the same bytes' time, the
    ALU instructions' time at INT32_OPS_PER_S and all instructions' time
    at ISSUE_PER_S."""
    work = work or Work(0, 0, 0)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = work.ops / INT_OPS_PER_S * 1e3
    t_int32 = max(t_bytes, work.alu / INT32_OPS_PER_S * 1e3,
                  work.issue / ISSUE_PER_S * 1e3)
    if t_bytes >= t_ops:
        return t_bytes, "bytes", t_int32
    return t_ops, "operations", t_int32


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def as_tuple(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def io_bytes(args, out):
    """Bytes of a launch's tensor inputs and of its outputs."""
    import torch
    return nbytes(*(a for a in args if isinstance(a, torch.Tensor)),
                  *as_tuple(out))


def band_cells(args):
    """Cells inside C4's band, summed over a launch's pairs: the cells the
    DP needs (a cell outside the band only carries traceback bits of NEG
    comparisons, counted in the lattice's bytes).  args: (s1, len1, s2,
    len2, b1, b2, ...); row j of a pair spans [start, min(j + b1 - 1,
    len1)] as in banded_global_plain."""
    import torch
    len1, len2, b1, b2 = (t.long()[:, None]
                          for t in (args[1], args[3], args[4], args[5]))
    j = torch.arange(1, args[2].shape[1], device=args[2].device)[None, :]
    tmp_end = torch.where(b2 < len2, b2, len2 - 1)
    whole = (j <= tmp_end) | ((j == len2) & (b2 == len2))
    start = torch.where(whole, 0, j - b2 + 1)
    n = (torch.minimum(j + b1 - 1, len1) - start + 1).clamp(min=0)
    return int(torch.where(j <= len2, n, 0).sum())


def log(msg):
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def card_line():
    res = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps launches (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps, tries=3):
    """Mean device milliseconds a launch of fn() over reps launches queued
    behind a sleeping kernel (CUDA events): the card's time back to back,
    without the host's enqueue between launches.  A reading counts only if
    the sleep outlasted the host's enqueue of the launches; where it did
    not (a busy host), the launches are drained and queued again behind a
    sleep twice as long, and the run fails if that happens in all of
    `tries` tries."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    slept = torch.cuda.Event(enable_timing=True)
    cycles = QUEUE_SLEEP_CYCLES
    for _ in range(tries):
        torch.cuda._sleep(cycles)
        slept.record()
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        done = slept.query()
        torch.cuda.synchronize()
        if not done:
            return start.elapsed_time(end) / reps
        log(f"queued_ms: the sleep of {cycles} cycles ended within the "
            f"{host_ms:.3f} ms the host took to enqueue {reps} launches")
        cycles *= 2
    fail(f"queued_ms: in {tries} tries the sleep ended before the host "
         f"had enqueued {reps} launches")


def wall_ms(fn, reps):
    """Mean host milliseconds a call of fn() over reps calls and one
    synchronize: the enqueue rate, or the device's where it is slower."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def cold_ms(fn, reps, flush):
    """Mean device milliseconds of fn() over reps launches, each timed
    alone (CUDA events) after `flush`, a buffer larger than the L2 cache,
    is rewritten: the launch finds none of its data in L2."""
    import torch
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        ev0.record()
        fn()
        ev1.record()
        torch.cuda.synchronize()
        total += ev0.elapsed_time(ev1)
    return total / reps


def make_pairs(genome, n_pairs, n_rescue, read_len, isize_mean, isize_std,
               seed, err_rate, frac_broken):
    """FASTQ text of both ends, a decoy contig's FASTA text and the rescue
    mates' true places, drawn in bulk with numpy.  The first n_pairs - n_rescue pairs follow the pair
    model of tests/test_sampe.py:18-49 (FR pairs, substitutions in both
    reads, a fraction of broken mates: half with every second base of read
    2 replaced, half with read 2 moved far).  The last n_rescue pairs are
    mates that only the rescue places, built as tests/test_torch_sampe.py
    builds them: read 2 carries three substitutions in its 32-base seed
    against its true place (more than aln's -k 2 allows) and an exact copy
    on the decoy contig, so aln maps it there and the rescue finds it
    beside read 1 (XT:A:M).  Returns (the two ends' FASTQ text, the decoy's
    FASTA text, (t, cols)): each rescue mate's copy on the decoy is the
    reverse complement of the genome's bases from t on, with substitutions
    at its columns cols (sorted, below 32)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.arange(256, dtype=np.uint8)
    comp[bases] = np.frombuffer(b"TGCA", np.uint8)
    code = np.zeros(256, dtype=np.int64)
    code[bases] = np.arange(4)
    n, col = n_pairs, np.arange(read_len)
    isize = np.maximum(rng.normal(isize_mean, isize_std, n).astype(np.int64),
                       read_len + 10)
    start = (rng.random(n) * (len(g) - isize - 1)).astype(np.int64)
    r1 = g[start[:, None] + col]
    r2 = comp[g[(start + isize - read_len)[:, None] + col]][:, ::-1].copy()
    for r in (r1, r2):
        err = rng.random(r.shape) < err_rate
        r[err] = bases[rng.integers(0, 4, int(err.sum()))]
    broken = (rng.random(n) < frac_broken) & (np.arange(n) < n - n_rescue)
    scrambled = broken & (rng.random(n) < 0.5)
    far = broken & ~scrambled
    odd = np.ix_(np.nonzero(scrambled)[0], col[0::2])
    r2[odd] = bases[rng.integers(0, 4, r2[odd].shape)]
    at = rng.integers(0, len(g) - read_len, int(far.sum()))
    r2[far] = g[at[:, None] + col]
    resc = np.arange(n - n_rescue, n)[:, None]
    seed_col = np.argsort(rng.random((n_rescue, 32)), axis=1)[:, :3]
    r2[resc, seed_col] = bases[(code[r2[resc, seed_col]]
                                + rng.integers(1, 4, seed_col.shape)) % 4]
    spacer = bases[rng.integers(0, 4, (n_rescue + 1, 150))]
    decoy = np.concatenate([np.concatenate([spacer[:-1], r2[resc[:, 0]]],
                                           1).reshape(-1), spacer[-1]])
    decoy_fa = b">decoy\n" + b"".join(decoy[i:i + 70].tobytes() + b"\n"
                                      for i in range(0, len(decoy), 70))
    quals = (33 + rng.integers(25, 40, (2, n, read_len))).astype(np.uint8)
    out = []
    for end, r in ((1, r1), (2, r2)):
        rows, q = r.tobytes(), quals[end - 1].tobytes()
        out.append(b"".join(
            b"@pair%d/%d\n%s\n+\n%s\n" % (i, end,
                                           rows[i * read_len:(i + 1)
                                                * read_len],
                                           q[i * read_len:(i + 1) * read_len])
            for i in range(n)))
    t = (start + isize - read_len)[n - n_rescue:]
    return out, decoy_fa, (t, np.sort(seed_col, axis=1))


def phase9_pairs_args(genome, n_pairs):
    """make_pairs' arguments for phase 9's pairs (and its decoy contig)."""
    return (genome, n_pairs, n_pairs // RESCUE_SHARE, 100, 300, 30, 102,
            0.01, 0.10)


def make_long_reads(genome_seq, n_reads, read_len, seed, err=0.02,
                    indel=0.3, chimera=0.1, with_n=0.1):
    """FASTQ text of long reads, the model of tests/test_bwasw.py:13-45
    (copied): substitutions, one indel of 1-7 bases, a chimeric 150-base
    tail, a run of three N, either strand."""
    import numpy as np
    from tests import genomes
    comp = dict(zip(b"ACGT", b"TGCA"))
    rng = np.random.default_rng(seed)
    g = np.frombuffer(genome_seq, dtype=np.uint8)
    out = []
    for i in range(n_reads):
        start = int(rng.integers(0, len(g) - read_len))
        r = bytearray(g[start:start + read_len].tobytes())
        for j in range(len(r)):
            p = rng.random()
            if p < err:
                r[j] = genomes.BASES[int(rng.integers(0, 4))]
        if rng.random() < indel:
            pos = int(rng.integers(20, len(r) - 20))
            ln = int(rng.integers(1, 8))
            if rng.random() < 0.5:
                del r[pos:pos + ln]
            else:
                ins = bytes(genomes.BASES[int(rng.integers(0, 4))]
                            for _ in range(ln))
                r[pos:pos] = ins
        if rng.random() < chimera:
            far = int(rng.integers(0, len(g) - 200))
            r[-150:] = g[far:far + 150].tobytes()
        if rng.random() < with_n:
            pos = int(rng.integers(0, len(r) - 5))
            r[pos:pos + 3] = b"NNN"
        if rng.random() < 0.5:
            r = bytearray(comp.get(b, b) for b in reversed(r))
        qual = bytes([33 + int(q) for q in rng.integers(15, 40, len(r))])
        out.append(b"@lr%d\n%s\n+\n%s\n" % (i, bytes(r), qual))
    return b"".join(out)


# `aln --device cuda` through the CLI in a fresh process: the kernels
# build cold into the directory argv[1], the CLI reads chunks of argv[2]
# reads, and C1's and C2's launches are counted in each chunk
ALN_FRESH = """\
import json, pathlib, sys
from nabwa_tpu_torch import cli
from nabwa_tpu_torch.models import aln as maln
from nabwa_tpu_torch.ops import _build, dfs_cuda, occ
build = pathlib.Path(sys.argv[1])
_build.BUILD_DIR = build
for name in ("LIB_PATH", "_HASH_PATH", "_LOG_PATH"):
    setattr(_build, name, build / getattr(_build, name).name)
cli.READ_CHUNK = int(sys.argv[2])
chunks = []
run_chunk = maln.AlnEngine.run_chunk
def counted(self, reads, *args, **kw):
    before = dfs_cuda.launches, occ.launches
    out = run_chunk(self, reads, *args, **kw)
    chunks.append({"reads": len(reads), "dfs": dfs_cuda.launches - before[0],
                   "cal_width": occ.launches - before[1],
                   "dev_rate": self.dev_rate, "host_rate": self.host_rate,
                   "tier0_reads": self.tier0_reads,
                   "hybrid_host_reads": self.hybrid_host_reads})
    return out
maln.AlnEngine.run_chunk = counted
rc = cli.main(sys.argv[3:])
print(json.dumps({"rc": rc, "build_seconds": _build.build_seconds,
                  "chunks": chunks, "dfs": dfs_cuda.launches,
                  "cal_width": occ.launches}))
sys.exit(rc)
"""


# `worker --device cuda` through the CLI in a process of its own for phase
# 20's networked bam2bam: the chunks it runs of each pass and its launches
# of C1-C5, printed on its last line of standard output
WORKER_DRIVER = """\
import json, sys
from nabwa_tpu_torch import cli
from nabwa_tpu_torch.models import bam2bam as b2b
from nabwa_tpu_torch.ops import dfs_cuda, dp, occ, sa_lookup
chunks = {1: 0, 2: 0}
def counted(phase, work):
    def run(*args, **kw):
        out = work(*args, **kw)
        chunks[phase] += 1
        return out
    return run
b2b.pass1_work = counted(1, b2b.pass1_work)
b2b.pass2_work = counted(2, b2b.pass2_work)
rc = cli.main(sys.argv[1:])
print(json.dumps({"rc": rc, "pass1_chunks": chunks[1],
                  "pass2_chunks": chunks[2], "dfs": dfs_cuda.launches,
                  "cal_width": occ.launches, "sa_lookup": sa_lookup.launches,
                  "banded_global": dp.launches,
                  "local_fwd": dp.launches_local}))
sys.exit(rc)
"""
# phase 20's lease: a chunk of a killed worker re-issues after this long
NET_LEASE_S = 15
NET_WORKERS = 2
NET_WORKER_THREADS = 3


def make_data(glen, n_reads, n_pairs, n_long):
    """Genome, index, the bench reads, the gapped reads, the read pairs,
    the long reads and bam2bam's second read group (cached by size and
    seed): a random contig of glen bp (seed 99) and the decoy contig of the
    pairs; 100 bp reads from the random contig at 1 % substitutions, seed
    100, the same with a 1-base indel in half the reads, seed 101, pairs
    of 100 bp reads, insert size 300 +- 30, 1 % substitutions, 10 % broken
    mates and 1/64 of the pairs rescued from the decoy, seed 102, n_long
    reads of 1000 bp of the long-read model at 3 % substitutions and an
    indel in half, seed 103, and n_pairs / 4 more pairs at insert size
    500 +- 50, seed 104."""
    from nabwa_tpu_torch.index.build import build_index
    from tests import genomes
    work = pathlib.Path(tempfile.gettempdir()) / \
        f"nabwa_torch_smoke_{glen}_{n_pairs}"
    work.mkdir(parents=True, exist_ok=True)
    fa = work / "g.fa"
    fqs = {work / f"r{n_reads}.fq": dict(seed=100),
           work / f"r{n_reads}_gapped.fq": dict(seed=101, indel_rate=0.5)}
    pe = [work / f"p{n_pairs}_{end}.fq" for end in (1, 2)]
    pe2 = [work / f"p{n_pairs}_rg2_{end}.fq" for end in (1, 2)]
    lr = work / f"lr{n_long}.fq"
    if not (work / "g.fa.rsa").exists() or \
            not all(p.exists() for p in [*fqs, *pe, *pe2, lr]):
        t0 = time.perf_counter()
        text, seqs = genomes.random_genome(glen, seed=99)
        pairs, decoy, _ = make_pairs(*phase9_pairs_args(seqs[0], n_pairs))
        for path, fq in zip(pe, pairs):
            path.write_bytes(fq)
        pairs2, _, _ = make_pairs(seqs[0], n_pairs // BAM_SHARE, 0, 100,
                                  500, 50, 104, 0.01, 0.10)
        for path, fq in zip(pe2, pairs2):
            path.write_bytes(fq)
        if not (work / "g.fa.rsa").exists():
            fa.write_bytes(text + decoy)
            # SA-IS at every size: the same index as the blockwise
            # incremental construction, built faster when memory is
            # plentiful
            os.environ.setdefault("NABWA_BWT_INC", "0")
            build_index(str(fa))
        for fq, kw in fqs.items():
            fq.write_bytes(genomes.sample_reads(seqs[0], n_reads, 100,
                                                err_rate=0.01, **kw))
        lr.write_bytes(make_long_reads(seqs[0], n_long, 1000, 103, err=0.03,
                                       indel=0.5))
        log(f"genome + index + reads + pairs + long reads: "
            f"{time.perf_counter() - t0:.1f} s")
    return (fa, *fqs, *pe, lr, *pe2)


def index_cli(fa, work):
    """`python -m nabwa_tpu_torch index` in a process of its own on the
    cell's FASTA (the builder the in-process build used: SA-IS,
    NABWA_BWT_INC=0), into `work`; its eight files must equal the
    in-process build's.  Returns its seconds."""
    prefix = work / "cli_index"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "nabwa_tpu_torch", "index", "-p", str(prefix),
         str(fa)], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, NABWA_BWT_INC="0"))
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"the index CLI exited with {res.returncode}: "
             f"{res.stderr[-2000:]}")
    for ext in (".pac", ".rpac", ".ann", ".amb", ".bwt", ".rbwt", ".sa",
                ".rsa"):
        got = pathlib.Path(str(prefix) + ext)
        if got.read_bytes() != pathlib.Path(str(fa) + ext).read_bytes():
            fail(f"the index CLI's {ext} differs from the in-process build")
    log(f"index CLI on the {fa.stat().st_size}-byte FASTA: {seconds:.2f} s "
        "end to end, its eight files equal to the in-process build's")
    for made in work.glob("cli_index.*"):
        made.unlink()
    return seconds


# phase 21: colour reads of SOLiD 4's length (in colours), their count, the
# colour pairs, how many of them have a mate only the rescue places, and
# the share of pairs that must come out properly paired
COLOUR_LEN = 50
COLOUR_READS = 16384
COLOUR_PAIRS = 8192
COLOUR_RESCUE = 512
MIN_PROPER = 0.80
COLOUR_READ_SEED = 105
COLOUR_PAIR_SEED = 106


def colour_fastq(tag, cols, quals, end=None):
    """FASTQ text of colour reads written as solid2fastq writes them (ACGT
    for colours 0-3, N for a `.`): cols int [n, L] (4 is a `.`), quals
    their ASCII qualities."""
    import numpy as np
    n, L = cols.shape
    rows = np.frombuffer(b"ACGTN", dtype=np.uint8)[cols].tobytes()
    q = np.ascontiguousarray(quals, dtype=np.uint8).tobytes()
    suffix = b"" if end is None else b"/%d" % end
    return b"".join(b"@%s%d%s\n%s\n+\n%s\n" % (
        tag, i, suffix, rows[i * L:(i + 1) * L], q[i * L:(i + 1) * L])
        for i in range(n))


def colours_of(nt, rng, err, dot):
    """The colours of nucleotide rows nt (int [n, L + 1], codes 0-3; a
    colour is the XOR of its two bases' codes), with colour errors at rate
    err and a `.` in a share dot of the rows, and their qualities."""
    import numpy as np
    cols = nt[:, :-1] ^ nt[:, 1:]
    hit = rng.random(cols.shape) < err
    cols = np.where(hit, (cols + rng.integers(1, 4, cols.shape)) % 4, cols)
    rows = np.nonzero(rng.random(len(cols)) < dot)[0]
    cols[rows, rng.integers(0, cols.shape[1], len(rows))] = 4
    quals = (33 + rng.integers(20, 40, cols.shape)).astype(np.uint8)
    return cols, quals


def make_colour_data(fa, glen, n_pairs9, work):
    """Phase 21's colour reads and pairs, drawn in bulk with numpy from the
    cell's random contig: COLOUR_READS reads of COLOUR_LEN colours, either
    strand, 2 % colour errors, a `.` in a tenth and a 1-base indel in the
    fragment of a tenth (seed COLOUR_READ_SEED); COLOUR_PAIRS pairs in the
    SOLiD orientation (F3/R3: both ends on one strand, end 2 right of end 1
    on the forward strand), insert 300 +- 30, 2 % colour errors and a `.`
    in a twentieth (seed COLOUR_PAIR_SEED).  The last COLOUR_RESCUE pairs
    (at most as many as phase 9 has rescue mates) take their end 2 from
    phase 9's decoy contig: the colours of a rescue mate's decoy copy from
    just past its first substitution, which carry three or four colour
    mismatches in the seed against the mate's true place (more than aln's
    -k 2 allows) and none on the decoy, so aln maps them there and only
    the rescue places them beside end 1.  Returns the read file and the
    two pair files."""
    import numpy as np
    from nabwa_tpu_torch.index.pack import read_pac, restore_ann_amb
    fq = work / "colour.fq"
    pe = [work / f"colour_p{end}.fq" for end in (1, 2)]
    if fq.exists() and all(p.exists() for p in pe):
        return fq, pe
    t0 = time.perf_counter()
    L = COLOUR_LEN
    col = np.arange(L + 1)
    codes = read_pac(str(fa) + ".pac")
    g = codes[:glen]

    def revcomp(nt):
        return 3 - nt[:, ::-1]

    rng = np.random.default_rng(COLOUR_READ_SEED)
    n = COLOUR_READS
    start = rng.integers(0, glen - L - 3, n)
    j = rng.integers(L // 3, 2 * L // 3, n)[:, None]
    kind = rng.random(n)[:, None]
    dele, ins = kind < 0.05, (kind >= 0.05) & (kind < 0.1)
    idx = start[:, None] + col + (dele & (col >= j)) - (ins & (col > j))
    nt = g[idx].astype(np.int64)
    nt = np.where(ins & (col == j), rng.integers(0, 4, (n, 1)), nt)
    nt = np.where(rng.random((n, 1)) < 0.5, revcomp(nt), nt)
    fq.write_bytes(colour_fastq(b"cs", *colours_of(nt, rng, 0.02, 0.1)))

    rng = np.random.default_rng(COLOUR_PAIR_SEED)
    n = COLOUR_PAIRS
    isz = np.maximum(rng.normal(300, 30, n).astype(np.int64), L + 11)
    start = rng.integers(0, glen - int(isz.max()) - 1, n)
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[g].tobytes()
    _, _, (t, cols9) = make_pairs(*phase9_pairs_args(genome, n_pairs9))
    del genome
    n_r = min(COLOUR_RESCUE, len(t))
    u = cols9[:n_r, 0] + 1
    # a rescue mate's copy on the decoy is the reverse complement of the
    # genome's bases t..t+99; its columns u..u+L are those of the bases
    # from t + 99 - u - L on
    start[n - n_r:] = t[:n_r] + 99 - u - L
    left = g[start[:, None] + col].astype(np.int64)
    right = g[(start + isz - L - 1)[:, None] + col].astype(np.int64)
    rev = rng.random((n, 1)) < 0.5
    rev[n - n_r:] = True
    ends = [np.where(rev, revcomp(right), left),
            np.where(rev, revcomp(left), right)]
    decoy = [a.offset for a in restore_ann_amb(str(fa)).anns
             if a.name == "decoy"][0]
    # the decoy holds a 150 bp spacer and the 100 bp mate per rescue pair
    at = decoy + np.arange(n_r) * 250 + 150 + u
    ends[1][n - n_r:] = codes[at[:, None] + col]
    for end, nt in zip((1, 2), ends):
        cols, quals = colours_of(nt, rng, 0.02, 0.05)
        if end == 2:
            cols[n - n_r:] = nt[n - n_r:, :-1] ^ nt[n - n_r:, 1:]
        pe[end - 1].write_bytes(colour_fastq(b"cpair", cols, quals, end))
    log(f"colour reads and pairs: {time.perf_counter() - t0:.1f} s")
    return fq, pe


def colour_index(fa, work):
    """`python -m nabwa_tpu_torch index -c` in a process of its own on the
    cell's FASTA (SA-IS, as phase 4's build): its `.nt.pac`, `.nt.ann` and
    `.nt.amb` must equal phase 4's `.pac`, `.ann` and `.amb`, and its
    `.pac`, `.ann` and `.amb` those `pac2cspac` writes from phase 4's
    files.  Returns (the colour index's prefix, the CLI's seconds)."""
    from nabwa_tpu_torch.index.pack import pac2cspac
    prefix = work / "cs"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "nabwa_tpu_torch", "index", "-c", "-p",
         str(prefix), str(fa)], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, NABWA_BWT_INC="0"))
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"index -c exited with {res.returncode}: {res.stderr[-2000:]}")
    pac2cspac(str(fa), str(work / "cs_check"))
    for ext in (".pac", ".ann", ".amb"):
        nt = pathlib.Path(f"{prefix}.nt{ext}").read_bytes()
        if nt != pathlib.Path(f"{fa}{ext}").read_bytes():
            fail(f"index -c's .nt{ext} differs from phase 4's {ext}")
        if pathlib.Path(f"{prefix}{ext}").read_bytes() != \
                pathlib.Path(f"{work / 'cs_check'}{ext}").read_bytes():
            fail(f"index -c's {ext} differs from pac2cspac's")
    log(f"index -c on the {fa.stat().st_size}-byte FASTA: {seconds:.2f} s "
        "end to end; its .nt files equal phase 4's, its colour .pac, .ann "
        "and .amb pac2cspac's")
    return prefix, seconds


def colour_routes(label, module, call, n, zero, launched):
    """A colour-space chunk, `call(host_reference)` -> SAM bytes, on the
    host reference route and on the card, every launch count at 0 before
    each: identical SAM.  `module` is models.samse or models.sampe, whose
    `seconds` are read; n reads or pairs give the rate.  Returns ({route:
    (SAM, rate, seconds per part)}, the card run's launch counts, its C3,
    C4 and C5 launches recorded, and the C4 launches of its second refine
    round, the one against the `.nt` pac)."""
    import torch
    from nabwa_tpu_torch.models import samse as msamse
    from nabwa_tpu_torch.ops import dp
    from nabwa_tpu_torch.ops import sa_lookup as sl
    refine = msamse.refine_jobs
    second = [0]

    def counted_refine(*args, **kw):
        before = dp.launches
        refine(*args, **kw)
        if kw.get("is_end_correct", True) is False:
            second[0] += dp.launches - before

    out, recorded = {}, {}
    for route in ("reference", "cuda"):
        module.seconds = dict.fromkeys(module.seconds, 0.0)
        msamse.refine_jobs = counted_refine
        restore = [lambda: setattr(msamse, "refine_jobs", refine)]
        if route == "cuda":
            for name, mod, fn in (("sa_lookup", sl, "sa_lookup_both_cuda"),
                                  ("banded_global", dp, "banded_global_cuda"),
                                  ("local_fwd", dp, "local_fwd_cuda")):
                recorded[name], undo = record(mod, fn)
                restore.append(undo)
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            blob = call(route == "reference")
        finally:
            for undo in restore:
                undo()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launched()
        parts = dict(module.seconds)
        parts["rest"] = dt - sum(parts.values())
        out[route] = (blob, n / dt, parts)
        log(f"{label}, {route}: {n / dt:.1f}/s ({dt:.3f} s); host seconds "
            f"per part {parts}; launches {counts}")
    if out["cuda"][0] != out["reference"][0]:
        fail(f"{label}: the SAM on the card differs from the host reference "
             f"route's")
    return out, counts, recorded, second[0]


def colour_phase(fa, glen, n_pairs9, tmp, zero, launched):
    """Phase 21, colour space: `index -c` (`colour_index`), the colour
    reads and pairs (`make_colour_data`), `aln -c` through the CLI (the
    hybrid) with every launch count at 0 and C1 and C2 recorded, its
    `.sai` equal to the host engine's; then samse and sampe
    (BWA_PET_SOLID, the `.nt` pac for cs2nt) on the card and on the host
    reference route (`colour_routes`), the host engine's `.sai` of each
    read set.  Returns (the phase's figures, the main path's launch counts
    [aln -c, samse, sampe], the recorded launches {kernel: [...]})."""
    import numpy as np
    import torch
    from nabwa_tpu_torch import cli as port_cli
    from nabwa_tpu_torch.constants import BWA_MODE_COMPREAD, BWA_PET_SOLID
    from nabwa_tpu_torch.index.fmindex import BwaIndex
    from nabwa_tpu_torch.index.pack import read_pac
    from nabwa_tpu_torch.models import aln as maln
    from nabwa_tpu_torch.models import sampe as msampe
    from nabwa_tpu_torch.models import samse as msamse
    from nabwa_tpu_torch.ops import dfs_cuda, occ
    from nabwa_tpu_torch.options import GapOpt, PeOpt
    from nabwa_tpu_torch.utils.rand48 import Rand48
    work = tmp / "nabwa_torch_smoke_colour"
    work.mkdir(exist_ok=True)
    prefix, index_s = colour_index(fa, work)
    fq, (fq1, fq2) = make_colour_data(fa, glen, n_pairs9, work)
    opt = GapOpt()
    opt.mode &= ~BWA_MODE_COMPREAD
    idx = BwaIndex.load(str(prefix))
    ntpac = read_pac(f"{prefix}.nt.pac")
    reads = port_cli.open_reads(str(fq), opt.mode)(COLOUR_READS, 0)
    pairs = tuple(port_cli.open_reads(str(f), opt.mode)(COLOUR_PAIRS, 0)
                  for f in (fq1, fq2))
    if len(reads) != COLOUR_READS or any(len(p) != COLOUR_PAIRS
                                         for p in pairs):
        fail(f"read {len(reads)} colour reads and {[len(p) for p in pairs]} "
             f"pairs")
    want, host_s = native_reference(idx, reads, opt)
    log(f"host native engine, colour reads: {len(reads) / host_s:.1f} "
        f"reads/s")

    # aln -c through the CLI, C1 and C2 recorded
    sai = work / "colour.sai"
    sai.unlink(missing_ok=True)
    recorded, restore = {}, []
    for name, mod, fn in (("dfs", dfs_cuda, "dfs_match_gap_cuda"),
                          ("cal_width", occ, "cal_width_planes_cuda")):
        recorded[name], undo = record(mod, fn)
        restore.append(undo)
    zero()
    t0 = time.perf_counter()
    try:
        rc = port_cli.main(["aln", "--device", "cuda", "-c", str(prefix),
                            str(fq), "-f", str(sai)])
    finally:
        for undo in restore:
            undo()
    torch.cuda.synchronize()
    aln_s = time.perf_counter() - t0
    aln_counts = launched()
    log(f"CLI aln -c --device cuda (the hybrid): rc {rc}, {aln_s:.2f} s end "
        f"to end (index load included); launches {aln_counts}")
    if rc != 0 or sai.read_bytes() != want:
        fail(f"CLI aln -c: rc {rc}, or its .sai differs from the host "
             f"native engine's")
    for name in ("dfs", "cal_width"):
        if aln_counts[name] <= 0:
            fail(f"kernel {name} was not launched by aln -c")
    one_c2_per_c1("CLI aln -c", aln_counts)

    eng = maln.AlnEngine(idx, opt, "cuda")
    seed = idx.bns.seed
    se_runs, se_counts, se_rec, se_second = colour_routes(
        "samse, colour reads", msamse,
        lambda hr: msamse.samse_bytes(eng, reads, sai_columns(want), opt,
                                      rng=Rand48(seed), ntpac=ntpac,
                                      host_reference=hr),
        len(reads), zero, launched)
    sais = [sai_columns(native_reference(idx, p, opt)[0]) for p in pairs]
    popt = PeOpt()
    popt.type = BWA_PET_SOLID
    pe_runs, pe_counts, pe_rec, pe_second = colour_routes(
        "sampe, colour pairs", msampe,
        lambda hr: msampe.sampe_bytes(eng, pairs, tuple(sais), opt, popt,
                                      Rand48(seed), ntpac=ntpac,
                                      host_reference=hr)[0],
        COLOUR_PAIRS, zero, launched)
    for name in ("sa_lookup", "banded_global"):
        if se_counts[name] <= 0 or pe_counts[name] <= 0:
            fail(f"kernel {name} was not launched by colour samse and sampe")
    if pe_counts["local_fwd"] <= 0:
        fail("kernel local_fwd was not launched by colour sampe")
    if se_second + pe_second <= 0:
        fail("the second refine round (against the .nt pac) launched C4 no "
             "time")
    sam = pe_runs["cuda"][0]
    flags = np.array([int(ln.split(b"\t", 2)[1]) for ln in sam.splitlines()])
    proper = float((flags & 2 != 0).mean())
    rescued = sam.count(b"XT:A:M")
    n_r = min(COLOUR_RESCUE, n_pairs9 // RESCUE_SHARE)
    log(f"colour sampe: {100 * proper:.2f} % of the ends properly paired, "
        f"{rescued} mates placed by the rescue ({n_r} pairs built for it); "
        f"second refine round C4 launches: samse {se_second}, sampe "
        f"{pe_second}")
    if proper < MIN_PROPER:
        fail(f"colour sampe paired {100 * proper:.1f} % of the ends "
             f"properly, below {100 * MIN_PROPER:.0f} %")
    if rescued < 1:
        fail("colour sampe's rescue placed no mate")
    for rec in (se_rec, pe_rec):
        for name, calls in rec.items():
            recorded.setdefault(name, []).extend(calls)
    figures = {
        "index_c_seconds": index_s, "aln_c_cli_seconds": aln_s,
        "aln_c_launches": aln_counts,
        "host_native_reads_per_sec": len(reads) / host_s,
        "samse": {route: {"reads_per_sec": r[1], "seconds": r[2]}
                  for route, r in se_runs.items()},
        "sampe": {route: {"pairs_per_sec": r[1], "seconds": r[2]}
                  for route, r in pe_runs.items()},
        "samse_launches": se_counts, "sampe_launches": pe_counts,
        "second_round_c4_launches": se_second + pe_second,
        "proper_share": proper, "mate_rescued": rescued,
        "pairs_built_for_rescue": n_r,
        "reads": COLOUR_READS, "pairs": COLOUR_PAIRS}
    return figures, [aln_counts, se_counts, pe_counts], recorded


def bam_sections(path):
    """(header text without the @PG line's CL field, the records' bytes) of
    a BAM: two runs of one input whose command lines differ."""
    from nabwa_tpu_torch.io import bam as pbam
    raw = pbam.bgzf_decompress(path.read_bytes())

    def i32(off):
        return int.from_bytes(raw[off:off + 4], "little", signed=True)
    l_text = i32(4)
    text = raw[8:8 + l_text].decode("latin1")
    off = 12 + l_text
    for _ in range(i32(8 + l_text)):
        off += 8 + i32(off)
    lines = [ln.split("\tCL:")[0] if ln.startswith("@PG") else ln
             for ln in text.split("\n")]
    return "\n".join(lines), raw[off:]


def net_bam2bam(fa, in_bam, n_records, want, zero, launched):
    """Phase 20: the bam2bam CLI as a coordinator with no local worker
    (`-t 0 -p` a free port, NABWA_LEASE_S=NET_LEASE_S) and NET_WORKERS
    `worker --device cuda -t NET_WORKER_THREADS` processes (WORKER_DRIVER)
    on the same card; the first worker the coordinator has taken a result
    from while it holds another chunk is stopped, and killed if it still
    holds it once any result it had sent is in.  The BAM must equal `want`
    (phase 17's, but for the @PG command line), each worker must have run
    a chunk, the survivors C1 and C2, the resends must be one or more, and
    every process must end.  Returns the run's figures."""
    import signal
    import socket
    from nabwa_tpu_torch import cli as port_cli
    from nabwa_tpu_torch.models import bam2bam as b2b
    from nabwa_tpu_torch.parallel import net

    coords = []

    class Seen(net.Coordinator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            coords.append(self)

    def tally(pid):
        if not coords:
            return 0, 0
        with coords[0].lock:
            for (_, wpid), t in coords[0].workers.items():
                if wpid == pid:
                    return t["accepted"], len(t["held"])
        return 0, 0

    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    tmp = pathlib.Path(tempfile.gettempdir())
    out = tmp / "nabwa_torch_smoke_net.bam"
    out.unlink(missing_ok=True)
    result = {}

    def coordinator():
        try:
            result["rc"] = port_cli.main(
                ["bam2bam", "--device", "cuda", "-t", "0", "-p", str(port),
                 "-g", str(fa), "-f", str(out), str(in_bam)])
        except (Exception, SystemExit) as e:    # reported by fail() below
            result["error"] = repr(e)

    real = net.Coordinator
    net.Coordinator = Seen
    os.environ["NABWA_LEASE_S"] = str(NET_LEASE_S)
    procs, logs = [], []
    killed = None
    try:
        zero()
        t0 = time.perf_counter()
        th = threading.Thread(target=coordinator, daemon=True)
        th.start()
        for i in range(NET_WORKERS):
            logs.append((tmp / f"nabwa_torch_smoke_w{i}.out",
                         tmp / f"nabwa_torch_smoke_w{i}.err"))
            # files, not pipes: a worker whose pipe fills stops mid-chunk
            with open(logs[-1][0], "w") as o, open(logs[-1][1], "w") as e:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", WORKER_DRIVER, "worker",
                     "--device", "cuda", "-p", str(port), "-t",
                     str(NET_WORKER_THREADS), "--idle-timeout", "120"],
                    cwd=ROOT, stdout=o, stderr=e))
        while th.is_alive():
            if time.perf_counter() - t0 > 600:
                fail("the networked bam2bam did not end within 600 s")
            time.sleep(0.01)
            for p in procs:
                if killed is not None or p.poll() is not None:
                    continue
                if all(tally(p.pid)):
                    p.send_signal(signal.SIGSTOP)
                    time.sleep(0.5)
                    if tally(p.pid)[1]:
                        p.kill()
                        killed = p
                    else:
                        p.send_signal(signal.SIGCONT)
        seconds = time.perf_counter() - t0
        coord_counts = launched()
        ends = [p.wait(timeout=120) for p in procs]
    finally:
        net.Coordinator = real
        os.environ.pop("NABWA_LEASE_S", None)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if result.get("rc") != 0:
        fail(f"the networked bam2bam coordinator failed: {result}")
    if killed is None:
        fail("no worker held a chunk after a result of its own: none killed")
    workers = []
    for p, end, (out_log, err_log) in zip(procs, ends, logs):
        if p is killed:
            accepted = tally(p.pid)[0]
            workers.append({"killed": True, "rc": end,
                            "accepted_results": accepted})
            if end != -signal.SIGKILL or accepted < 1:
                fail(f"the killed worker ended with {end} after {accepted} "
                     "results")
            continue
        lines = out_log.read_text().splitlines()
        if end != 0 or not lines:
            fail(f"a worker exited with {end}: "
                 f"{err_log.read_text()[-2000:]}")
        got = json.loads(lines[-1])
        got["accepted_results"] = tally(p.pid)[0]
        workers.append(got)
        if got["pass1_chunks"] + got["pass2_chunks"] < 1:
            fail(f"a surviving worker ran no chunk: {got}")
        for name in ("dfs", "cal_width"):
            if got[name] <= 0:
                fail(f"kernel {name} was not launched in the surviving "
                     f"worker: {got}")
    resends = (b2b.telemetry["pass1_resends"]
               + b2b.telemetry["pass2_resends"])
    if resends < 1:
        fail(f"no chunk was resent after the kill: {b2b.telemetry}")
    if bam_sections(out) != bam_sections(want):
        fail("the networked bam2bam BAM differs from phase 17's")
    counts = dict(coord_counts)
    for w in workers:
        for name in counts:
            counts[name] += w.get(name, 0)
    run = {"seconds": seconds, "records_per_sec": n_records / seconds,
           "lease_s": NET_LEASE_S, "workers": workers,
           "worker_threads": NET_WORKER_THREADS,
           "telemetry": dict(b2b.telemetry),
           "coordinator_launches": coord_counts, "launches": counts}
    log(f"networked bam2bam (-t 0 -p, {NET_WORKERS} cuda workers, one "
        f"killed): {seconds:.2f} s end to end, "
        f"{run['records_per_sec']:.1f} records/s (the kill's {NET_LEASE_S} s "
        f"lease and the workers' start included); telemetry "
        f"{b2b.telemetry}; workers {workers}; coordinator launches "
        f"{coord_counts}")
    return run


def planes_bound(args, out):
    """(bound_ms, bound_by, bound_int32_ms) of a four-plane C2 launch on
    (bwt_fwd, bwt_rev, l2, primary_fwd, primary_rev, seq_len, seqs,
    lengths, seed_seqs, seed_lengths): its inputs and outputs and two Occ
    blocks a read position of each plane (the counts at k-1 and l)."""
    steps = 2 * int(args[7].long().sum()) + 2 * int(args[9].long().sum())
    return bound(nbytes(*args[6:10], *out) + 2 * OCC_BLOCK_BYTES * steps,
                 2 * OPS_OCC_BLOCK * steps)


def check_cal_width(eng, inputs):
    """C2 against the plain version on the first CHECK_B reads of the main
    path: the four-plane launch (reads and seed suffixes, both strands),
    exact against four plain calls, and the one-plane launch of the reads'
    strand 0 against one.  Returns a dict: max |err|, the four-plane
    launch's ms (`ms`) and a plane's share (`ms_per_plane`), the one-plane
    launch's ms (`single_plane_ms`, the shape of the earlier one thread a
    row kernel's timing), the four plain calls' ms and the bound."""
    import torch
    from nabwa_tpu_torch.ops import occ
    ix = eng.dev
    args = (ix.bwt_fwd, ix.bwt_rev, ix.l2, ix.primary_fwd, ix.primary_rev,
            ix.seq_len, inputs["seqs"], inputs["lengths"],
            inputs["seed_seqs"], inputs["seed_lengths"])
    t0 = time.perf_counter()
    want = occ.cal_width_planes_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    worst = 0
    got = occ.cal_width_planes_cuda(*args)
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, want)):
        worst = max(worst, exact(f"C2 four planes, output {k}", g, w))
    ms = cuda_ms(lambda: occ.cal_width_planes_cuda(*args), 20)
    q = inputs["seqs"][:, 0, :].contiguous()
    one = (ix.bwt_fwd, ix.l2, ix.primary_fwd, ix.seq_len, q,
           inputs["lengths"])
    for g, w in zip(occ.cal_width_cuda(*one), occ.cal_width_plain(*one)):
        worst = max(worst, exact("C2 one plane", g, w))
    single_ms = cuda_ms(lambda: occ.cal_width_cuda(*one), 20)
    bnd = planes_bound(args, want)
    log(f"C2 cal_width: {q.shape[0]} reads, four planes (L={q.shape[1]}, "
        f"SL={inputs['seed_seqs'].shape[2]}) in one launch, exact: "
        f"{ms:.4f} ms, {ms / 4:.4f} a plane; one plane {tuple(q.shape)} "
        f"{single_ms:.4f} ms; plain {plain_ms:.2f} ms for the four; bound "
        f"{bnd[0]:.5f} ms ({bnd[1]})")
    return {"err": worst, "ms": ms, "ms_per_plane": ms / 4,
            "single_plane_ms": single_ms, "plain_ms": plain_ms,
            "bound": bnd}


def check_cal_width_edges(eng):
    """C2's edge launches (numpy seed CW_EDGE_SEED) on the main path's
    index, exact against the plain version: four planes whose rows hold N
    codes (restarts), length 0, 1 and L (and seed lengths 0 and SL), and
    one-plane launches of a single row and of none.  Returns {label:
    shape}."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.ops import occ
    ix = eng.dev
    dev = ix.bwt_cat.device
    rng = np.random.default_rng(CW_EDGE_SEED)
    B, L, SL = 96, 128, 32
    seqs = rng.integers(0, 4, size=(B, 2, L))
    seqs[rng.random((B, 2, L)) < 0.03] = 4              # N codes
    seqs[:8, :, 40] = 4
    seqs[8:12] = 4                                       # all N
    lengths = rng.integers(0, L + 1, size=B)
    lengths[:6] = (0, 1, L, L, L - 1, 0)
    seed_seqs = seqs[:, :, :SL].copy()
    seed_lengths = np.where(rng.random(B) < 0.5, SL, 0)
    seed_lengths[:3] = (0, SL, 1)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    args = (ix.bwt_fwd, ix.bwt_rev, ix.l2, ix.primary_fwd, ix.primary_rev,
            ix.seq_len, put(seqs), put(lengths), put(seed_seqs),
            put(seed_lengths))
    want = occ.cal_width_planes_plain(*args)
    checked = {}
    got = occ.cal_width_planes_cuda(*args)
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, want)):
        exact(f"C2 edge planes, output {k}", g, w)
    checked["planes"] = [B, L, SL]
    for n in (1, 0):
        one = (ix.bwt_rev, ix.l2, ix.primary_rev, ix.seq_len,
               args[6][:n, 1, :].contiguous(), args[7][:n])
        got = occ.cal_width_cuda(*one)
        torch.cuda.synchronize()
        for k, (g, w) in enumerate(zip(got, occ.cal_width_plain(*one))):
            exact(f"C2 edge B={n}, output {k}", g, w)
        checked[f"one_plane_B{n}"] = [n, L]
    log(f"C2 cal_width: {len(checked)} edge launches exact ({checked})")
    return checked


class dfs_device_state:
    """A `with` block in which C1's wrapper keeps every read's state in
    device memory (`dfs_cuda.SMEM_STATE_BYTES` 0), unless `on` is false."""

    def __init__(self, on=True):
        self.on = on

    def __enter__(self):
        from nabwa_tpu_torch.ops import dfs_cuda
        self.keep = dfs_cuda.SMEM_STATE_BYTES
        if self.on:
            dfs_cuda.SMEM_STATE_BYTES = 0

    def __exit__(self, *exc):
        from nabwa_tpu_torch.ops import dfs_cuda
        dfs_cuda.SMEM_STATE_BYTES = self.keep


def dfs_planes(ix, seqs, lens, seed_seqs, seed_lens, cal_width_planes):
    """widths, bids, seed widths, seed bids of a batch by
    `cal_width_planes` (occ's four-plane function, kernel or plain)."""
    return list(cal_width_planes(ix.bwt_fwd, ix.bwt_rev, ix.l2,
                                 ix.primary_fwd, ix.primary_rev, ix.seq_len,
                                 seqs, lens, seed_seqs, seed_lens))


def dfs_shape(args, statics, device_state):
    """(warps a block, blocks, shared bytes a warp) of C1's launch on
    `args`, as the wrapper would make it."""
    from nabwa_tpu_torch.ops import dfs_cuda
    B, _, L = args[6].shape
    S, H, SL1 = statics["stack_cap"], statics["hits_cap"], args[10].shape[2]
    per_read = dfs_cuda.dfs_smem_bytes(S, H, L, SL1)
    shared = (not device_state) and per_read <= dfs_cuda.SMEM_STATE_BYTES
    params = dfs_cuda.param_words(*args[1:6], L, SL1, **statics)
    warps, blocks, _ = dfs_cuda.launch_shape(params, B, shared)
    return warps, blocks, per_read if shared else 0


def check_dfs(eng, inputs, statics, tier):
    """C1 against the plain DFS on one batch of the engine's own inputs.
    The width planes come from the plain cal_width, so C1 is checked on
    its own.  The kernel runs with each read's state in shared memory and
    forced into device memory: the first 4H+3 columns equal the plain
    version's, and all 4H+5 equal across the forms.  Returns a dict: max
    |err|, kernel ms (the wrapper's choice of form), plain ms, flagged
    rows, the bound, pops, the slowest read's iterations and us an
    iteration, the launch shape, and ms in each form (timed shared,
    device, device, shared, so a drift falls on both).  The bound counts
    the inputs and output and, for every pop the reads took, one 2occ4
    (two Occ blocks)."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.ops import dfs, dfs_cuda, occ
    ix = eng.dev
    seqs, lens = inputs["seqs"], inputs["lengths"]
    B, _, L = seqs.shape
    planes = dfs_planes(ix, seqs, lens, inputs["seed_seqs"],
                        inputs["seed_lengths"], occ.cal_width_planes_plain)
    args = (ix.bwt_cat, ix.rev_word_offset, ix.primary_fwd, ix.primary_rev,
            ix.l2, ix.seq_len, seqs, lens, *planes, inputs["has_seed"],
            inputs["max_diff"])
    kern = dfs_cuda.dfs_match_gap_cuda(*args, **statics)
    t0 = time.perf_counter()
    plain = dfs.dfs_match_gap_plain(*args, **statics)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    H, S = statics["hits_cap"], statics["stack_cap"]
    cap = statics["max_iters"]
    diff = (kern[:, :4 * H + 3].long() - plain[:, :4 * H + 3].long()).abs()
    worst = int(diff.max())
    if worst != 0:
        bad = np.nonzero(diff.any(1).cpu().numpy())[0][:5]
        fail(f"dfs kernel disagrees with the plain version, {tier} "
             f"(rows {bad})")
    ms = cuda_ms(lambda: dfs_cuda.dfs_match_gap_cuda(*args, **statics), 3)
    forms = {"shared_ms": 0.0, "device_ms": 0.0}
    for form in ("shared", "device", "device", "shared"):
        with dfs_device_state(form == "device"):
            got = dfs_cuda.dfs_match_gap_cuda(*args, **statics)
            t = cuda_ms(lambda: dfs_cuda.dfs_match_gap_cuda(*args, **statics),
                        3)
        exact(f"C1 {tier}, {form} state", got, kern)
        forms[f"{form}_ms"] += t / 2
    k = kern.cpu().numpy()
    flagged = np.nonzero(k[:, 4 * H + 2])[0]
    iters = k[:, 4 * H + 4]
    pops = int(iters.astype(np.int64).sum())
    bnd = bound(nbytes(seqs, lens, *planes, inputs["has_seed"],
                       inputs["max_diff"], kern)
                + 2 * OCC_BLOCK_BYTES * pops, 2 * OPS_OCC_BLOCK * pops)
    hits_full = int((k[flagged, 4 * H] >= H).sum())
    at_cap = int((iters[flagged] >= cap).sum())
    slowest = int(iters.max())
    warps, blocks, per_warp = dfs_shape(args, statics, False)
    log(f"C1 dfs, {tier}: {B} reads (L={L}, S={S}, H={H}, max_iters={cap}), "
        f"max |err| {worst} over hits/n_aln/hw/overflow, all columns equal "
        f"in both state forms; {len(flagged)} "
        f"flagged ({hits_full} hit list full, {at_cap} iteration cap, "
        f"{len(flagged) - hits_full - at_cap} slot pool or seq counter); "
        f"most iterations of a read {slowest}, {pops} in all; "
        f"{blocks} blocks x {warps} warps, {per_warp} shared bytes a warp; "
        f"kernel {ms:.4f} ms ({ms * 1e3 / max(slowest, 1):.4f} us an "
        f"iteration of the slowest read), {forms}; plain {plain_ms:.1f} ms; "
        f"bound {bnd[0]:.5f} ms ({bnd[1]})")
    return {"err": worst, "ms": ms, "plain_ms": plain_ms, "flagged": flagged,
            "bound": bnd, "pops": pops, "slowest_iters": slowest,
            "us_per_iter": ms * 1e3 / max(slowest, 1), "warps": warps,
            "blocks": blocks, "smem_bytes_per_warp": per_warp, **forms}


def check_dfs_edges(dev):
    """C1's edge launches (`dfs_edge_data`) against the plain DFS on the
    card: each case in both state forms (the first 4H+3 columns exact
    against the plain version, all 4H+5 equal across the forms), then the
    defaults' first read alone (B = 1) and none (B = 0).  Returns ({label:
    [B, L, S, H, shared bytes a warp (0: device memory)]}, seconds: the
    edge index's build and load ("index"), and each launch's plain
    version and its two card launches ({label: {"plain", "card"}}))."""
    import numpy as np
    import torch
    from nabwa_tpu_torch import cli as port_cli
    from nabwa_tpu_torch.index.build import build_index
    from nabwa_tpu_torch.index.fmindex import BwaIndex, DeviceIndex
    from nabwa_tpu_torch.models import aln as maln
    from nabwa_tpu_torch.ops import dfs, dfs_cuda, occ
    from nabwa_tpu_torch.options import GapOpt
    fasta, cases = dfs_edge_data()
    checked, seconds = {}, {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        fa = pathlib.Path(tmp) / "edge.fa"
        fa.write_bytes(fasta)
        build_index(str(fa))
        ix = DeviceIndex.from_host(BwaIndex.load(str(fa)), dev)
        seconds["index"] = time.perf_counter() - t0
        fq_path = pathlib.Path(tmp) / "edge.fq"
        for label, (fq, zero, opt_kw, st_kw) in cases.items():
            opt = GapOpt(**opt_kw)
            fq_path.write_bytes(fq)
            reads = port_cli.open_reads(str(fq_path), opt.mode)(1 << 20, 0)
            lens = reads.clip_lens().astype(np.int32)
            maxdiff, local = maln.batch_options(opt, lens)
            lens[list(zero)] = 0
            inputs = maln.batch_inputs(reads, lens, maxdiff, local,
                                       int(lens.max()), dev)
            statics = {**maln.dfs_statics(local, **DFS_EDGE_STATICS),
                       **st_kw}
            planes = dfs_planes(ix, inputs["seqs"], inputs["lengths"],
                                inputs["seed_seqs"], inputs["seed_lengths"],
                                occ.cal_width_planes)
            args = (ix.bwt_cat, ix.rev_word_offset, ix.primary_fwd,
                    ix.primary_rev, ix.l2, ix.seq_len, inputs["seqs"],
                    inputs["lengths"], *planes, inputs["has_seed"],
                    inputs["max_diff"])
            n = 4 * statics["hits_cap"] + 3
            runs = [args]
            if label == "defaults":
                runs += [tuple(a[:m] if isinstance(a, torch.Tensor)
                               and a.dim() and a.shape[0] == len(lens)
                               else a for a in args) for m in (1, 0)]
            for run in runs:
                t0 = time.perf_counter()
                plain = dfs.dfs_match_gap_plain(*run, **statics)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got = dfs_cuda.dfs_match_gap_cuda(*run, **statics)
                with dfs_device_state():
                    got_dev = dfs_cuda.dfs_match_gap_cuda(*run, **statics)
                torch.cuda.synchronize()
                B = int(run[6].shape[0])
                name = label if B == len(lens) else f"{label}_B{B}"
                seconds[name] = {"plain": t1 - t0,
                                 "card": time.perf_counter() - t1}
                exact(f"C1 edge {name}", got[:, :n], plain[:, :n])
                exact(f"C1 edge {name}, device state", got_dev, got)
                warps, blocks, per_warp = (dfs_shape(run, statics, False)
                                           if B else (0, 0, 0))
                checked[name] = [B, int(run[6].shape[2]),
                                 statics["stack_cap"], statics["hits_cap"],
                                 per_warp]
            if label == "wide_device" and checked[label][4]:
                fail("C1 edge wide_device: its state fits in shared memory")
    log(f"C1 dfs: {len(checked)} edge launches exact in both state forms "
        f"({checked}); seconds {seconds}")
    return checked, seconds


def native_reference(idx, reads, opt):
    """The .sai of the shared host engine (native/dfsgap.cpp)."""
    from nabwa_tpu_torch.index import native
    from nabwa_tpu_torch.models.aln import batch_options
    maxdiff, local = batch_options(opt, reads.clip_lens().astype("int32"))
    t0 = time.perf_counter()
    res = native.dfs_match_gap_native(
        idx.fwd.bwt, idx.fwd.primary, idx.rev.bwt, idx.rev.primary,
        idx.fwd.l2, idx.fwd.seq_len, reads, maxdiff, local)
    dt = time.perf_counter() - t0
    return opt.pack() + native_block(res), dt


def hybrid_runs(idx, opt, reads, want, args, zero, launched):
    """Phase 4's hybrid split on a fresh engine, warmed as bench.py:77-84
    warms it: a device-only chunk of one slice (kept out of the rate EMA),
    a second of four slices (the clean card rate), one hybrid chunk of
    four.  Then 3 timed hybrid `run_chunk`s on all the reads, every launch
    count at 0 before the first: each `.sai` byte-identical to the host
    engine's, the card's share above 0, C1 and C2 launched once each a
    slice.  Returns the runs and the median."""
    import torch
    from nabwa_tpu_torch.models import aln as maln
    B = args.batch
    eng = maln.AlnEngine(idx, opt, "cuda", retry_stack_cap=args.retry_stack,
                         retry_hits_cap=args.retry_stack // 8, host_frac=0)
    eng.run_chunk(reads[:B], device_batch=B)
    eng.run_chunk(reads[:4 * B], device_batch=B)
    warm_rates = (eng.dev_rate, eng.host_rate)
    eng.host_frac = 0.5
    eng.run_chunk(reads[:4 * B], device_batch=B)
    zero()
    runs = []
    for _ in range(3):
        eng.tier0_reads = eng.retry_reads = eng.host_drain_reads = 0
        eng.hybrid_host_reads = 0
        eng.seconds = dict.fromkeys(eng.seconds, 0.0)
        before = (eng.dev_rate, eng.host_rate)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run_chunk(reads, device_batch=B)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if opt.pack() + native_block(res) != want:
            fail("hybrid .sai differs from the host native engine's")
        n_dev = eng.tier0_reads + eng.host_drain_reads
        if n_dev <= 0 or eng.retry_reads:
            fail(f"the hybrid gave the card {n_dev} reads (retry tier "
                 f"{eng.retry_reads})")
        runs.append({
            "reads_per_sec": len(reads) / dt, "seconds": dt,
            "n_dev": n_dev, "dev_rate_before": before[0],
            "host_rate_before": before[1], "dev_rate": eng.dev_rate,
            "host_rate": eng.host_rate,
            "planned_host_share": eng.hybrid_host_reads / len(reads),
            "overflow_drain_reads": eng.host_drain_reads,
            "overflow_share": eng.host_drain_reads / len(reads),
            "part_seconds": dict(eng.seconds)})
        log(f"hybrid run: {len(reads) / dt:.1f} reads/s ({dt:.3f} s); "
            f"n_dev {n_dev} of {len(reads)} (planned host share "
            f"{100 * eng.hybrid_host_reads / len(reads):.2f} %), overflow "
            f"drained on the host {eng.host_drain_reads}; rate EMAs "
            f"{before} -> ({eng.dev_rate:.1f}, {eng.host_rate:.1f}); "
            f"seconds per part {eng.seconds}")
    counts = launched()
    for name in ("dfs", "cal_width"):
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched by the hybrid")
    one_c2_per_c1("hybrid runs", counts)
    med = sorted(runs, key=lambda r: r["reads_per_sec"])[1]
    log(f"hybrid: median {med['reads_per_sec']:.1f} reads/s over 3 runs; "
        f"launches {counts}")
    return {"reads_per_sec": med["reads_per_sec"], "median": med,
            "runs": runs, "warm_rates": warm_rates, "launches": counts,
            "batch": B}


def fresh_cli_aln(fa, fq, n_reads, want, header):
    """`aln --device cuda` through the CLI in a process of its own
    (`ALN_FRESH`) whose kernels build cold into an empty directory, as in
    a new checkout, on the bench reads twice over in two chunks: the
    `.sai` must be the host engine's records twice over, and C1 and C2
    must launch in each chunk, so a first hybrid window that held the
    build has not benched the card.  Returns the process's summary."""
    with tempfile.TemporaryDirectory(prefix="nabwa_fresh_aln_") as tmp:
        work = pathlib.Path(tmp)
        twice = work / "twice.fq"
        body = fq.read_bytes()
        twice.write_bytes(body + (b"" if body.endswith(b"\n") else b"\n")
                          + body)
        out = work / "twice.sai"
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", ALN_FRESH, str(work / "build"),
             str(n_reads), "aln", "--device", "cuda", str(fa), str(twice),
             "-f", str(out)], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        seconds = time.perf_counter() - t0
        lines = res.stdout.splitlines()
        if res.returncode != 0 or not lines:
            fail(f"the fresh CLI aln exited with {res.returncode}: "
                 f"{res.stderr[-2000:]}")
        got = json.loads(lines[-1])
        if out.read_bytes() != want + want[header:]:
            fail("the fresh CLI aln's .sai differs from the host native "
                 "engine's")
    if got["build_seconds"] is None:
        fail("the fresh CLI aln did not build its kernels")
    if len(got["chunks"]) != 2:
        fail(f"the fresh CLI aln ran {len(got['chunks'])} chunks, not 2")
    for i, chunk in enumerate(got["chunks"]):
        for name in ("dfs", "cal_width"):
            if chunk[name] <= 0:
                fail(f"kernel {name} was not launched in chunk {i} of the "
                     f"fresh CLI aln: {got['chunks']}")
    one_c2_per_c1("fresh CLI aln", got)
    got["seconds"] = seconds
    log(f"fresh CLI aln --device cuda: {seconds:.2f} s end to end (kernel "
        f"build {got['build_seconds']:.2f} s, index load included); per "
        f"chunk {got['chunks']}")
    return got


def split_constants(idx, opt, reads, args, card_rate, host_rate):
    """The split's constants re-derived on this host: the device route's
    seconds on a one-slice chunk of 64 reads (the fixed per-chunk cost,
    `DEV_LAT`), and on a chunk of one full slice, each the median of 7
    after one warm call, on a fresh engine; the starting rates are the
    card-only route's tier-0 rate (its rate EMA after the timed run) and
    the host engine's on every core (`DEV_RATE0`, `HOST_RATE0`)."""
    import torch
    from nabwa_tpu_torch.models import aln as maln
    eng = maln.AlnEngine(idx, opt, "cuda", host_frac=0)
    out = {}
    for label, n in (("dev_lat", 64), ("one_slice", args.batch)):
        times = []
        for _ in range(8):
            before = eng.seconds["hybrid_device"]
            eng.run_hybrid(reads[:n], device_batch=n, n_dev=n)
            torch.cuda.synchronize()
            times.append(eng.seconds["hybrid_device"] - before)
        out[f"{label}_s"] = sorted(times[1:])[3]
    out.update(card_rate=card_rate, host_rate=host_rate,
               code_dev_lat=maln.AlnEngine.DEV_LAT,
               code_dev_rate0=maln.AlnEngine.DEV_RATE0,
               code_host_rate0=maln.AlnEngine.HOST_RATE0)
    log(f"split constants: DEV_LAT measured {out['dev_lat_s']:.5f} s (a "
        f"one-slice chunk of 64 reads; one slice of {args.batch} "
        f"{out['one_slice_s']:.5f} s), code {maln.AlnEngine.DEV_LAT}; "
        f"card-only tier-0 rate {card_rate:.1f} reads/s, code DEV_RATE0 "
        f"{maln.AlnEngine.DEV_RATE0}; host engine {host_rate:.1f} reads/s "
        f"({os.cpu_count()} cores), code HOST_RATE0 "
        f"{maln.AlnEngine.HOST_RATE0}")
    return out


def mesh_phase(idx, opt, reads, want, args, zero, launched):
    """Phase 19: `entry.dryrun_multichip` over every visible card and over
    a two-shard mesh naming cuda:0 twice, then `AlnEngine(mesh=)` on that
    mesh over phase 4's reads (its `.sai` equal to the host engine's, C2
    launched once a C1 launch).  Returns the summary and the launch counts
    of the whole phase."""
    import torch
    from nabwa_tpu_torch import entry
    from nabwa_tpu_torch.models import aln as maln
    from nabwa_tpu_torch.parallel.mesh import make_mesh
    n_cards = torch.cuda.device_count()
    out = {"cards": n_cards}
    zero()
    try:
        out["dryrun_cards"] = entry.dryrun_multichip(n_cards, "cuda")
        out["dryrun_two_shards"] = entry.dryrun_multichip(2, "cuda:0")
    except AssertionError as e:
        fail(f"dryrun_multichip: {e}")
    counts = launched()
    zero()
    mesh = make_mesh(2, "cuda:0")
    eng = maln.AlnEngine(idx, opt, mesh=mesh, retry_stack_cap=args.retry_stack,
                         retry_hits_cap=args.retry_stack // 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run_chunk(reads, device_batch=args.batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if opt.pack() + native_block(res) != want:
        fail("the mesh engine's .sai differs from the host native engine's")
    eng_counts = launched()
    one_c2_per_c1("mesh engine", eng_counts)
    out["engine"] = {"mesh": [str(d) for d in mesh],
                     "reads_per_sec": len(reads) / dt, "seconds": dt,
                     "tier0_reads": eng.tier0_reads,
                     "retry_reads": eng.retry_reads,
                     "host_drain_reads": eng.host_drain_reads,
                     "part_seconds": dict(eng.seconds),
                     "launches": eng_counts}
    log(f"mesh engine on {out['engine']['mesh']}: {len(reads) / dt:.1f} "
        f"reads/s, .sai byte-identical; tiers {eng.tier0_reads} / "
        f"{eng.retry_reads} / {eng.host_drain_reads}; launches {eng_counts}")
    if n_cards == 1:
        log("no measurement across cards exists: this host has one card")
    out["across_cards_measured"] = n_cards > 1
    return out, {k: counts[k] + eng_counts[k] for k in counts}


def native_block(results):
    """The `.sai` records of a chunk's [(alns, hw), ...] results."""
    from nabwa_tpu_torch.io.sai import pack_aln_block
    return pack_aln_block([alns for alns, _ in results])


def sai_columns(sai_bytes):
    """The per-read alignments of a `.sai` as the CLI reads them
    (columnar)."""
    from nabwa_tpu_torch.io.sai import read_sai_columnar
    path = pathlib.Path(tempfile.gettempdir()) / "nabwa_torch_smoke_cols.sai"
    path.write_bytes(sai_bytes)
    return read_sai_columnar(str(path))[1]


def sa_steps(args):
    """invPsi steps each row of a C3 launch takes (int64 [n]); args are a
    one-strand launch's (bwt, l2, primary, seq_len, sa, sa_intv, rows) or
    a both-strand launch's (banks, l2, primaries, seq_len, sas, sa_intv,
    rows, n0)."""
    import torch
    from nabwa_tpu_torch.ops import sa_lookup as sl
    if len(args) == 7:
        return sl.sa_walk_steps(*args[:4], args[5], args[6])
    banks, l2, prims, seq_len, _, intv, rows, n0 = args
    return torch.cat([sl.sa_walk_steps(banks[a], l2, prims[a], seq_len,
                                       intv, part)
                      for a, part in enumerate((rows[:n0], rows[n0:]))])


def sa_walk_bound(args):
    """C3's bound on a launch's args (see `sa_steps`): its rows and
    positions, and one Occ block read and counted for every invPsi step
    its rows take."""
    steps = int(sa_steps(args).sum())
    return bound(12 * args[6].shape[0] + OCC_BLOCK_BYTES * steps,
                 OPS_OCC_BLOCK * steps)


def check_sa_lookup(eng, idx, reads, sai_bytes):
    """C3 on every SA row samse asks for on this `.sai`: the rows of both
    strands in one launch, exact against the plain version and the native
    host walk.  Timed (CUDA events) beside each strand's rows alone
    (`strand_ms`), the two one-strand launches in turn (`pair_ms`, the
    path's shape before both went into one launch) and as many rows all on
    strand 1's bank (`same_bank_ms`: strand 1's rows twice, so the rows
    walk one 24 MB bank where the both-strand launch walks two).  The
    launch's rows' step counts (`max_steps`, `mean_steps`), and the
    longest row alone: its card time a step (`lone_us_per_step`, queued
    behind a sleeping kernel).  The bound counts the rows and positions
    and one Occ block for every invPsi step."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.models import samse as msamse
    from nabwa_tpu_torch.ops import sa_lookup as sl
    from nabwa_tpu_torch.utils.rand48 import Rand48
    ch = msamse.select(reads, sai_columns(sai_bytes), 3,
                       Rand48(idx.bns.seed))
    ix = eng.dev
    rows = [np.zeros(0, dtype=np.uint32)] * 2
    for a, _, _, r in msamse.sa_requests(ch):
        rows[a] = r
    n0 = len(rows[0])
    banks, sas = (ix.bwt_rev, ix.bwt_fwd), (ix.sa_rev, ix.sa_fwd)
    prims = (ix.primary_rev, ix.primary_fwd)

    def both_args(r, n_first):
        return (banks, ix.l2, prims, ix.seq_len, sas, ix.sa_intv,
                torch.from_numpy(np.ascontiguousarray(r).view(np.int32))
                .to(eng.device), n_first)

    args = both_args(np.concatenate(rows), n0)
    alone = [both_args(rows[0], n0), both_args(rows[1], 0)]
    same = both_args(np.concatenate([rows[1], rows[1]]), 0)
    t0 = time.perf_counter()
    plain = sl.sa_lookup_both_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    nat = np.concatenate(msamse.sa_rows_both_native(idx, rows))
    worst = max(exact("C3 samse's rows against the native walk", plain,
                      torch.from_numpy(nat.view(np.int32)).to(plain.device)),
                exact("C3 samse's rows", sl.sa_lookup_both_cuda(*args),
                      plain))
    exact("C3 strand 1's rows twice", sl.sa_lookup_both_cuda(*same),
          torch.cat([plain[n0:], plain[n0:]]))
    ms = cuda_ms(lambda: sl.sa_lookup_both_cuda(*args), 20)
    strand_ms = [cuda_ms(lambda: sl.sa_lookup_both_cuda(*alone[a]), 20)
                 for a in (0, 1)]
    pair_ms = cuda_ms(lambda: [sl.sa_lookup_both_cuda(*alone[a])
                               for a in (0, 1)], 20)
    same_ms = cuda_ms(lambda: sl.sa_lookup_both_cuda(*same), 20)
    steps = sa_steps(args)
    i = int(steps.argmax())
    lone = both_args(np.concatenate(rows)[i:i + 1], 1 if i < n0 else 0)
    exact("C3 the longest row alone", sl.sa_lookup_both_cuda(*lone),
          plain[i:i + 1])
    lone_ms = queued_ms(lambda: sl.sa_lookup_both_cuda(*lone), 20)
    bnd = sa_walk_bound(args)
    out = {"err": worst, "ms": ms, "plain_ms": plain_ms,
           "rows": [len(r) for r in rows], "bound": bnd,
           "max_steps": int(steps.max()),
           "mean_steps": float(steps.double().mean()),
           "total_steps": int(steps.sum()), "strand_ms": strand_ms,
           "pair_ms": pair_ms, "same_bank_ms": same_ms, "lone_ms": lone_ms,
           "lone_us_per_step": lone_ms * 1e3 / int(steps[i])}
    log(f"C3 sa_lookup: {len(rows[0])} + {len(rows[1])} SA rows of samse "
        f"on the bench .sai (strands 0, 1) in one launch, exact against "
        f"the plain version and the native walk: {ms:.4f} ms; each strand "
        f"alone {strand_ms}, the two in turn {pair_ms:.4f}, strand 1's "
        f"rows twice {same_ms:.4f}; steps max {out['max_steps']}, mean "
        f"{out['mean_steps']:.2f}; the longest row alone {lone_ms:.4f} ms, "
        f"{out['lone_us_per_step']:.4f} us a step; plain {plain_ms:.2f} "
        f"ms; bound {bnd[0]:.5f} ms ({bnd[1]})")
    return out


def check_sa_edges(eng):
    """C3's edge launches (numpy seed SA_EDGE_SEED) on the main path's
    banks, exact against the plain version: rows 0, 1,
    primary and its neighbours, seq_len and sampled rows on both strands
    with random rows; a single row, and launches whose strand 0 or
    strand 1 holds no row, or none at all; and the same banks walked at
    sa_intv 24 (the multiply-high instantiation) and 1 (every row
    sampled), on samples made up for them.  Returns {label: rows}."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.ops import sa_lookup as sl
    ix = eng.dev
    dev = ix.bwt_cat.device
    rng = np.random.default_rng(SA_EDGE_SEED)
    n, intv = ix.seq_len, ix.sa_intv
    banks, sas = (ix.bwt_rev, ix.bwt_fwd), (ix.sa_rev, ix.sa_fwd)
    prims = (ix.primary_rev, ix.primary_fwd)

    def strand_rows(a, size):
        p = prims[a]
        edge = [0, 1, n - 1, n, p, p - 1, p + 1, intv, 2 * intv, intv + 1,
                n - n % intv]
        return np.concatenate([edge, rng.integers(0, n + 1, size=size)])

    def put(r):
        return torch.from_numpy(np.asarray(r, np.uint32).view(np.int32)).to(
            dev)

    r0, r1 = strand_rows(0, 2000), strand_rows(1, 2000)
    cases = {"both": (np.concatenate([r0, r1]), len(r0)),
             "one row": (r1[4:5], 0), "strand 0 only": (r0, len(r0)),
             "strand 1 only": (r1, 0), "none": (r0[:0], 0)}
    checked = {}
    for label, (r, n0) in cases.items():
        args = (banks, ix.l2, prims, n, sas, intv, put(r), n0)
        exact(f"C3 edge {label}", sl.sa_lookup_both_cuda(*args),
              sl.sa_lookup_both_plain(*args))
        checked[label] = len(r)
    for d in (24, 1):
        made = [torch.from_numpy(rng.integers(
            0, 1 << 32, size=n // d + 1, dtype=np.uint64).astype(
                np.uint32).view(np.int32)).to(dev) for _ in range(2)]
        r = np.concatenate([r0[:11], r0[11:400], r1[:11], r1[11:400]])
        args = (banks, ix.l2, prims, n, tuple(made), d, put(r), 400)
        exact(f"C3 edge sa_intv {d}", sl.sa_lookup_both_cuda(*args),
              sl.sa_lookup_both_plain(*args))
        checked[f"sa_intv {d}"] = len(r)
    log(f"C3 sa_lookup: {len(checked)} edge launches exact ({checked})")
    return checked


def check_banded_global(eng, idx, reads, sai_bytes, opt):
    """C4 against the plain version on the first device batch of the
    refine jobs samse makes on this `.sai`: score, ctype and the whole
    traceback lattice.  The bound counts the inputs, the lattice and the
    cells of each pair's band."""
    import torch
    from nabwa_tpu_torch.models import samse as msamse
    from nabwa_tpu_torch.ops import dp
    from nabwa_tpu_torch.refmodel.stdaln_scalar import ALN_PARAM_BWA
    from nabwa_tpu_torch.utils.rand48 import Rand48
    ch = msamse.select(reads, sai_columns(sai_bytes), 3,
                       Rand48(idx.bns.seed))
    msamse.sa_coords(eng, ch, host_reference=True)
    msamse.approx_mapq(ch, opt)
    jobs = msamse.gapped_jobs(ch)
    pairs = msamse.refine_pairs(jobs, idx.pac, idx.bns.l_pac)
    pairs = [p for p in pairs if len(p[0]) and len(p[1])][:dp.MAX_PAIRS]
    if not pairs:
        fail("the gapped read set gave no refine jobs")
    ap = ALN_PARAM_BWA
    args = dp.pack_pairs(pairs, [ap.band_width] * len(pairs), eng.device)
    kw = dict(mat=ap.matrix, go=ap.gap_open, ge=ap.gap_ext, gend=ap.gap_end)
    kern = dp.banded_global_cuda(**args, **kw)
    t0 = time.perf_counter()
    plain = dp.banded_global_plain(**args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    worst = max(int((k.long() - p.long()).abs().max())
                for k, p in zip(kern, plain))
    ms = cuda_ms(lambda: dp.banded_global_cuda(**args, **kw), 5)
    tb = kern[2]
    bnd = bound(nbytes(*args.values(), *kern),
                OPS_GLOBAL_CELL * band_cells(tuple(args.values())))
    t0 = time.perf_counter()
    tb.cpu()
    copy_ms = (time.perf_counter() - t0) * 1e3
    log(f"C4 banded_global: {len(jobs)} refine jobs, first batch {len(pairs)}"
        f" pairs at L1={args['s1'].shape[1] - 1}, L2={args['s2'].shape[1] - 1}"
        f"; max |err| {worst} over score, ctype and {tb.numel()} lattice "
        f"bytes; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; lattice copy "
        f"to the host {copy_ms:.2f} ms; bound {bnd[0]:.5f} ms ({bnd[1]})")
    if worst != 0:
        fail("banded_global kernel disagrees with the plain version")
    return worst, ms, plain_ms, len(jobs), tb.numel(), copy_ms, bnd


def samse_routes(eng, idx, reads, sai_bytes, opt, label):
    """samse on the card and on the host reference route: identical SAM
    bytes; reads/s and part seconds of each, and under "banded_global" the
    arguments of every C4 launch of the card run."""
    import torch
    from nabwa_tpu_torch.models import samse as msamse
    from nabwa_tpu_torch.ops import dp
    from nabwa_tpu_torch.utils.rand48 import Rand48
    per_read = sai_columns(sai_bytes)
    out = {}
    for route in ("reference", "cuda"):
        msamse.seconds = dict.fromkeys(msamse.seconds, 0.0)
        undo = None
        if route == "cuda":
            out["banded_global"], undo = record(dp, "banded_global_cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            blob = msamse.samse_bytes(eng, reads, per_read, opt,
                                      rng=Rand48(idx.bns.seed),
                                      host_reference=route == "reference")
        finally:
            if undo:
                undo()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        parts = dict(msamse.seconds)
        parts["rest"] = dt - sum(parts.values())
        out[route] = (blob, len(reads) / dt, parts)
        log(f"samse {label}, {route}: {len(reads) / dt:.1f} reads/s "
            f"({dt:.3f} s); host seconds per part {parts}")
    if out["cuda"][0] != out["reference"][0]:
        fail(f"samse SAM on the card differs from the host reference "
             f"route's ({label})")
    return out


def record(module, name):
    """Replace module.name by a wrapper that appends each call's (args,
    kwargs) to a list and calls through.  Returns (the list, a function
    that puts the original back).  Worker threads may launch at once: the
    list grows under a lock, in the order the launches happen."""
    fn, calls = getattr(module, name), []
    lock = threading.Lock()

    def wrapper(*args, **kw):
        with lock:
            calls.append((args, kw))
        return fn(*args, **kw)

    setattr(module, name, wrapper)
    return calls, lambda: setattr(module, name, fn)


def check_launches(label, calls, kernel, plain, size, bound_of):
    """A kernel against its plain version on launches recorded from the
    main path, every output exact on each.  Each launch is timed once
    with CUDA events as it is replayed, and `total_ms` sums those: the
    kernel's device time over the path.  The largest launch by
    `size(args)` is timed again over 5 launches (`ms`) beside its plain
    version (`plain_ms`), and its bound is `bound_of(args, outputs)`.
    Returns a dict of those, max |err| (`err`), each launch's time in
    order (`times`), and the largest launch's `args` and plain outputs
    (`out`)."""
    import torch
    worst, total_ms, n_rows, timed, times = 0, 0.0, 0, None, []
    big = max(calls, key=lambda c: size(c[0]))
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    for call in calls:
        args, kw = call
        ev0.record()
        kern = as_tuple(kernel(*args, **kw))
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
        total_ms += times[-1]
        t0 = time.perf_counter()
        out = as_tuple(plain(*args, **kw))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        worst = max([worst] + [int((k.long() - p.long()).abs().max())
                               for k, p in zip(kern, out)])
        n_rows += out[0].shape[0]
        if call is big:
            timed = (plain_ms, out)
    args, kw = big
    ms = cuda_ms(lambda: kernel(*args, **kw), 5)
    bnd = bound_of(args, timed[1])
    shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
    log(f"{label}: max |err| {worst} over every output of {len(calls)} "
        f"launches ({n_rows} rows), {total_ms:.3f} ms of kernel in all; "
        f"largest {timed[1][0].shape[0]} rows, inputs {shapes}, {kw}: "
        f"kernel {ms:.4f} ms, plain {timed[0]:.2f} ms; bound "
        f"{bnd[0]:.5f} ms ({bnd[1]})")
    if worst != 0:
        fail(f"{label}: the kernel disagrees with the plain version")
    return {"err": worst, "ms": ms, "plain_ms": timed[0],
            "total_ms": total_ms, "times": times, "bound": bnd,
            "args": args, "kw": kw, "out": timed[1]}


def replay_dfs(label, calls):
    """C1 against the plain DFS on one recorded launch: the smallest of
    the tier-0 launches (the lowest max_iters), so the plain run stays
    short.  The hits, n_aln, hw and overflow columns must agree exactly,
    as in `check_dfs`.  Returns max |err|."""
    import torch
    from nabwa_tpu_torch.ops import dfs, dfs_cuda
    tier0 = min(kw["max_iters"] for _, kw in calls)
    args, kw = min((c for c in calls if c[1]["max_iters"] == tier0),
                   key=lambda c: c[0][6].shape[0])
    kern = dfs_cuda.dfs_match_gap_cuda(*args, **kw)
    t0 = time.perf_counter()
    plain = dfs.dfs_match_gap_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    H = kw["hits_cap"]
    worst = int((kern[:, :4 * H + 3].long()
                 - plain[:, :4 * H + 3].long()).abs().max())
    log(f"{label}: {kern.shape[0]} reads (L={args[6].shape[2]}, "
        f"max_iters={tier0}), max |err| {worst} over hits/n_aln/hw/"
        f"overflow; plain {plain_ms:.2f} ms")
    if worst != 0:
        fail(f"{label}: the kernel disagrees with the plain version")
    return worst


def sampe_routes(eng, idx, pairs, sais, opt, popt):
    """sampe on the host reference route and on the card: pairs/s, part
    seconds and the card route's launches of C3, C4 and C5, with the
    arguments of each C5 and C4 launch recorded ({"local_fwd": [...],
    "banded_global": [...]})."""
    import torch
    from nabwa_tpu_torch.models import sampe as msampe
    from nabwa_tpu_torch.ops import dp
    from nabwa_tpu_torch.ops import sa_lookup as sl
    from nabwa_tpu_torch.utils.rand48 import Rand48
    out, recorded = {}, {}
    for route in ("reference", "cuda"):
        msampe.seconds = dict.fromkeys(msampe.seconds, 0.0)
        sl.launches = dp.launches = dp.launches_local = 0
        restore = []
        if route == "cuda":
            for name, fn in (("local_fwd", "local_fwd_cuda"),
                             ("banded_global", "banded_global_cuda")):
                recorded[name], undo = record(dp, fn)
                restore.append(undo)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            blob, ii = msampe.sampe_bytes(eng, pairs, sais, opt, popt,
                                          Rand48(idx.bns.seed),
                                          host_reference=route == "reference")
        finally:
            for undo in restore:
                undo()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        parts = dict(msampe.seconds)
        parts["rest"] = dt - sum(parts.values())
        rescue = sum(v for k, v in parts.items()
                     if k.startswith("rescue_"))
        counts = {"sa_lookup": sl.launches, "banded_global": dp.launches,
                  "local_fwd": dp.launches_local}
        out[route] = (blob, len(pairs[0]) / dt, parts, rescue / dt, counts)
        log(f"sampe, {route}: {len(pairs[0]) / dt:.1f} pairs/s ({dt:.3f} "
            f"s; insert size {ii.avg:.2f} +- {ii.std:.2f}); rescue "
            f"{100 * rescue / dt:.1f} % of the time; host seconds per part "
            f"{parts}; launches {counts}")
    return out, recorded


def bwasw_routes(eng, idx, reads, opt):
    """bwasw on the host reference route and on the card: reads/s, part
    seconds and the card route's launches of C3, C4 and C6, with the
    arguments of each C6, C4 and C3 launch recorded ({"extend": [...],
    "banded_global": [...], "sa_lookup": [...]}), and under "replay" the
    range of C6 launches made inside stage B (`_replay`), the single-read
    ones."""
    import torch
    from nabwa_tpu_torch.models import bwasw as mbw
    from nabwa_tpu_torch.ops import dp
    from nabwa_tpu_torch.ops import sa_lookup as sl
    from nabwa_tpu_torch.utils.rand48 import Rand48
    out, recorded = {}, {}
    for route in ("reference", "cuda"):
        mbw.seconds = dict.fromkeys(mbw.seconds, 0.0)
        sl.launches = dp.launches = dp.launches_extend = 0
        restore = []
        if route == "cuda":
            for name, mod, fn in (("extend", dp, "extend_cuda"),
                                  ("banded_global", dp,
                                   "banded_global_cuda"),
                                  ("sa_lookup", sl, "sa_lookup_cuda")):
                recorded[name], undo = record(mod, fn)
                restore.append(undo)
            replay = mbw._replay

            def marked(*a, **kw):
                n0 = len(recorded["extend"])
                try:
                    return replay(*a, **kw)
                finally:
                    recorded["replay"] = range(n0, len(recorded["extend"]))

            mbw._replay = marked
            restore.append(lambda: setattr(mbw, "_replay", replay))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            body = mbw.bwasw_bytes(idx, reads, opt, eng, Rand48(11),
                                   host_reference=route == "reference",
                                   threads=os.cpu_count())
        finally:
            for undo in restore:
                undo()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        parts = {k: v for k, v in mbw.seconds.items() if v}
        parts["rest"] = dt - sum(parts.values())
        counts = {"sa_lookup": sl.launches, "banded_global": dp.launches,
                  "extend": dp.launches_extend}
        out[route] = (body, len(reads) / dt, parts, counts)
        log(f"bwasw, {route}: {len(reads) / dt:.2f} reads/s ({dt:.3f} s); "
            f"host seconds per part {parts}; launches {counts}")
    return out, recorded


def unaligned_bam(path, groups):
    """An unaligned BAM written with the port's io/bam.py, as
    tests/test_bam2bam.py lays it out: groups = [(read group, FASTQ paths,
    number of records per path)], a pair of paths giving interleaved FR
    pairs (flags 0x4d/0x8d), one path singletons (0x4); every record
    carries RG:Z.  The sequence bytes are packed with numpy."""
    import numpy as np
    from nabwa_tpu_torch.io import bam as pbam
    nt16 = np.full(256, 15, dtype=np.uint8)
    for i, c in enumerate(pbam.NT16_STR):
        nt16[ord(c)] = i
    recs = []
    for rg, paths, n in groups:
        tag = b"RGZ" + rg.encode() + b"\x00"
        ends = []
        for fq in paths:
            lines = fq.read_bytes().split(b"\n")[:4 * n]
            names = [ln[1:].split(b"/")[0] + b"\x00" for ln in lines[0::4]]
            seqs, quals = lines[1::4], lines[3::4]
            ends.append((names, seqs, quals))
        paired = len(paths) == 2
        flags = ((pbam.BAM_FPAIRED | pbam.BAM_FREAD1 | pbam.BAM_FUNMAP | 8,
                  pbam.BAM_FPAIRED | pbam.BAM_FREAD2 | pbam.BAM_FUNMAP | 8)
                 if paired else (pbam.BAM_FUNMAP,))
        for i in range(n):
            for (names, seqs, quals), flag in zip(ends, flags):
                codes = nt16[np.frombuffer(seqs[i], dtype=np.uint8)]
                if len(codes) & 1:
                    codes = np.append(codes, 0)
                r = pbam.BamRec()
                r.flag, r.bin = flag, 0
                r.l_qname, r.l_qseq = len(names[i]), len(seqs[i])
                r.data = bytearray(
                    names[i] + ((codes[0::2] << 4) | codes[1::2]).tobytes()
                    + (np.frombuffer(quals[i], np.uint8) - 33).tobytes()
                    + tag)
                recs.append(r)
    pbam.make_bam(str(path), [], recs, text="@HD\tVN:1.4\n" + "".join(
        f"@RG\tID:{rg}\tSM:s{rg}\n" for rg, _, _ in groups))
    return len(recs)


def launch_signatures(calls):
    """A multiset of launches: each launch's tensor shapes and static
    arguments, whichever thread made it."""
    import collections
    import torch
    return collections.Counter(
        (tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else None
               for a in args), tuple(sorted((k, str(v)) for k, v in
                                            kw.items())))
        for args, kw in calls)


def bam2bam_routes(eng, idx, in_bam, n_records, argv, opt, popt, out_dir):
    """bam2bam on the host reference route at one worker, then on the card
    at one and at four workers, each run's launches of C1-C5 counted and,
    on the card, recorded.  Returns ({label: (BAM bytes, records/s, stage
    seconds, pass-2 part seconds, rescue counters, launch counts, engine
    tiers)}, {label: {kernel: recorded launches}})."""
    import torch
    from nabwa_tpu_torch.models import bam2bam as mb2b
    from nabwa_tpu_torch.ops import dfs_cuda, dp, occ
    from nabwa_tpu_torch.ops import sa_lookup as sl
    from nabwa_tpu_torch.utils.rand48 import Rand48
    wrapped = (("dfs", dfs_cuda, "dfs_match_gap_cuda"),
               ("cal_width", occ, "cal_width_planes_cuda"),
               ("sa_lookup", sl, "sa_lookup_both_cuda"),
               ("banded_global", dp, "banded_global_cuda"),
               ("local_fwd", dp, "local_fwd_cuda"))
    runs, recorded = {}, {}
    for label, kw in (("reference", dict(host_reference=True)),
                      ("cuda t1", {}), ("cuda t4", dict(n_workers=4))):
        occ.launches = dfs_cuda.launches = sl.launches = 0
        dp.launches = dp.launches_local = dp.launches_extend = 0
        eng.tier0_reads = eng.retry_reads = eng.host_drain_reads = 0
        eng.seconds = dict.fromkeys(eng.seconds, 0.0)
        mb2b.pass2_seconds.update(dict.fromkeys(mb2b.pass2_seconds, 0.0))
        restore = []
        if label != "reference":
            recorded[label] = {}
            for name, mod, fn in wrapped:
                recorded[label][name], undo = record(mod, fn)
                restore.append(undo)
        out = out_dir / f"nabwa_torch_smoke_b2b_{label.replace(' ', '_')}.bam"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            counters = mb2b.bam2bam(eng, str(in_bam), str(out), opt, popt,
                                    Rand48(idx.bns.seed), argv=argv, **kw)
        finally:
            for undo in restore:
                undo()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {"dfs": dfs_cuda.launches, "cal_width": occ.launches,
                  "sa_lookup": sl.launches, "banded_global": dp.launches,
                  "local_fwd": dp.launches_local}
        tiers = {"tier0": eng.tier0_reads, "retry": eng.retry_reads,
                 "host_drain": eng.host_drain_reads,
                 "seconds": dict(eng.seconds)}
        runs[label] = (out.read_bytes(), n_records / dt, dict(mb2b.seconds),
                       {k: v for k, v in mb2b.pass2_seconds.items() if v},
                       counters, counts, tiers)
        log(f"bam2bam, {label}: {n_records / dt:.1f} records/s ({dt:.3f} s "
            f"for {n_records} records); stage seconds {mb2b.seconds}; "
            f"pass-2 parts summed over workers {runs[label][3]}; rescue "
            f"{counters}; launches {counts}; engine {tiers}")
    return runs, recorded


def one_c2_per_c1(label, counts):
    """The aln engine launches C2 once for each C1 launch (the batch's four
    width planes in one launch); fails otherwise."""
    if counts["cal_width"] != counts["dfs"]:
        fail(f"{label}: C2 launched {counts['cal_width']} times for "
             f"{counts['dfs']} C1 launches")


def exact(label, got, want):
    """max |got - want| of two int tensors; fails unless they are equal."""
    if got.shape != want.shape:
        fail(f"{label}: shape {tuple(got.shape)} against the plain "
             f"version's {tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err:
        fail(f"{label}: kernel differs from its plain version (max |err| "
             f"{err})")
    return err


def distinct_rows(*rows):
    """Distinct table rows among index tensors (None skipped)."""
    import torch
    return int(torch.unique(torch.cat(
        [r.reshape(-1).long().cpu() for r in rows if r is not None])).numel())


def refused(label, fn):
    """Fails unless fn() raises ValueError (a wrapper's refusal, before
    any launch)."""
    try:
        fn()
    except ValueError:
        return
    fail(f"{label} was not refused")


def index_cases(rng, rows, shape):
    """{case: int indices in [0, rows) of `shape`}: drawn as the script draws,
    row 0 and the last row at two of every three places, four rows
    repeated, one row everywhere."""
    import numpy as np
    ends = rng.randint(0, rows, shape)
    ends.reshape(-1)[0::3] = 0
    ends.reshape(-1)[1::3] = rows - 1
    return {"script": rng.randint(0, rows, shape), "ends": ends,
            "repeats": rng.randint(0, 4, shape) * (rows // 4) + 7,
            "same": np.full(shape, rows // 2)}


def skewed(t):
    """A copy of t on its device that starts 4 bytes past a 16-byte
    boundary."""
    import torch
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = base[1:].view(t.shape)
    view.copy_(t)
    return view


def other_device(dev):
    """A CUDA device other than dev, or None on a one-card machine."""
    import torch
    for k in range(torch.cuda.device_count()):
        if k != dev.index:
            return torch.device("cuda", k)
    return None


def launch_split(dev, calls=SPLIT_CALLS):
    """The host's microseconds a call of each step of kernel C14's, C11's,
    C29's, C28's, C27's, C20's, C7's, C15's and C8's wrappers as they stand
    (the steps of each one's chosen launch path), of each wrapper whole and
    of the PyTorch call that computes the same (`wall_ms` over `calls`
    calls after a warm-up, one synchronize at the end), with the port's
    helpers (`compare.py launch` runs this over another checkout's; a step
    whose helper that checkout lacks is None).  `helpers`: `loop` an empty
    call (inside every other figure), `lib`, `stream_of`, `check` and
    `count` (the launch counter's locked add) as the wrappers call them,
    and beside them a `torch.cuda.Stream` built for the handle
    (`stream_object`), the raw handle (`stream_raw`), a lock taken and
    left (`lock`), a ctypes call into the library that touches no CUDA
    API (`ctypes_host`, `nabwa_local_form`) and PyTorch's own launch of
    a kernel that does nothing (`torch_launch`, torch.cuda._sleep(0)).
    Per kernel: the input checks, `checks` (C14: `cuda_input` and the
    width) or `cuda_inputs` (one pass over all of them; C7's and C15's
    index at 4-byte alignment, C7's `[BB, 1]` test run inside it; null
    on a checkout without the pass) and `shape` (the shape tests); the
    allocation of its output (`new_empty_args`, `new_empty` with the sizes
    as arguments, or C11's `empty_like`); `stream_raw` (from the device
    index); `data_ptr` (each tensor's pointer read once); `launch` (the
    ctypes call on pointers read beforehand, whose C function launches the
    kernel and reads cudaGetLastError); `check`; `count`; `wrapper` and
    `library`.  C29, C28, C27 and C20 at phase 18's shapes; C7 and C15
    (`probe_rowload`, `probe_smem_idx`) at idx [256, 1] and [256] rows of
    a [4096, 128] table, `library` torch.index_select on the index (C7's
    column taken beforehand); C11 (`probe_empty`) at x [8, 128], `library`
    `x + 1`; C8 (`probe_dma`) at the script's default (100,000 rows, N
    128, T 64, `reg`, unroll off), also `check_args` (`_check`) and
    `views` (out, rounds and the stage cut from its one buffer, an
    `as_strided` each), `launch` the grid form's `nabwa_probe_dma`,
    `wrapper` `dma_cuda`, `library` torch.index_select of the T N rows the
    copies read, the rows made beforehand: the bytes' yardstick, not the
    same function."""
    import torch
    from nabwa_tpu_torch.ops import _build
    from nabwa_tpu_torch.probes import common
    from nabwa_tpu_torch.probes import probe_dma as pdma
    from nabwa_tpu_torch.probes import probe_pallas as pp
    from nabwa_tpu_torch.probes import probe_pallas2 as pp2
    from nabwa_tpu_torch.probes import probe_pallas3 as p3
    lib = _build.lib()
    lock = threading.Lock()
    i32 = torch.int32
    x = torch.zeros(pp2.REDUCE_SHAPE, dtype=i32, device=dev)
    x1 = torch.zeros(pp2.EMPTY_SHAPE, dtype=i32, device=dev)
    rows, n1 = x.shape[0], x1.numel()
    out, out1 = torch.empty((rows, 1), dtype=i32,
                            device=dev), torch.empty_like(x1)
    st = _build.stream_of(x)
    form = torch.zeros(2, dtype=i32)
    # C29: x [128, 128], i [8, 128]; C28: i and j [256, 1], t [4096, 128]
    gx = torch.randint(0, 99, p3.P3_X, dtype=i32, device=dev)
    gi = torch.randint(0, p3.P3_X[0], p3.P3_I, dtype=i32, device=dev)
    gi_long, g_out = gi.long(), torch.empty_like(gi)
    m, c = gi.shape
    nrow, cols = p3.P1_TABLE
    ri, rj = (torch.randint(0, nrow, (p3.P1_ROUNDS, 1), dtype=i32,
                            device=dev) for _ in range(2))
    rt = torch.randint(0, 99, p3.P1_TABLE, dtype=i32, device=dev)
    flat = torch.cat((ri[:, 0], rj[:, 0]))
    n = ri.shape[0]
    r_out = rt.new_empty(2 * n, cols)
    # C27: i [256, 128], its lanes 0 and 1 indexing C28's t; C20: x and
    # i [256, 128]
    pi = torch.randint(0, nrow, (p3.P1_ROUNDS, cols), dtype=i32, device=dev)
    pn, width = pi.shape
    p_flat = pi[:, :2].t().reshape(-1).contiguous()
    p_out = rt.new_empty(2 * pn, cols)
    lx = torch.randint(0, 99, (pp2.BB, pp2.GATHER_W), dtype=i32, device=dev)
    li = torch.randint(0, pp2.GATHER_W, lx.shape, dtype=i32, device=dev)
    li_long, l_out = li.long(), torch.empty_like(lx)
    lrows = lx.shape[0]
    gp = [t.data_ptr() for t in (gx, gi, g_out)]
    rp = [t.data_ptr() for t in (ri, rj, rt, r_out)]
    qp = [t.data_ptr() for t in (pi, rt, p_out)]
    lp = [t.data_ptr() for t in (lx, li, l_out)]
    # C7: idx [256, 1] rows of a [4096, 128] table; C15: idx [256]
    wi = torch.randint(0, pp.ROWLOAD_NROW, (pp.ROWLOAD_BB, 1), dtype=i32,
                       device=dev)
    wt = torch.randint(0, 99, (pp.ROWLOAD_NROW, 128), dtype=i32, device=dev)
    w_col, si = wi[:, 0], wi[:, 0].contiguous()
    bb = wi.shape[0]
    w_out = wt.new_empty(bb, 128)
    wp = [t.data_ptr() for t in (wi, wt, w_out)]
    sp = [t.data_ptr() for t in (si, wt, w_out)]
    # C8 at the script's default: 100,000 rows, N 128, T 64, reg, unroll
    # off; the buffer of the one allocation (stage, out, rounds) and the
    # old path's four, and the T N rows its copies read
    d_rows, d_n, d_t = DMA_ROWS[0], 128, DMA_T
    dt = torch.arange(d_rows * 128, dtype=i32, device=dev).view(d_rows, 128)
    d_words = 2 * d_n * 128
    d_buf = dt.new_empty(d_words + 1 + d_t)
    d_scratch = torch.empty(d_t * 1024, dtype=i32, device=dev)
    d_base = d_buf.data_ptr()
    dp = [dt.data_ptr(), d_scratch.data_ptr(), d_base + 4 * d_words,
          d_base, d_base + 4 * d_words + 4]
    d_flat = pdma.copy_rows(d_n, d_t, d_rows, "reg")[0].reshape(-1).to(dev)
    multi = getattr(common, "cuda_inputs", None)
    # the six-element spec (an alignment and a follow-on check) came with
    # `_one_column`
    one_col = getattr(pp, "_one_column", None)
    index = dev.index
    saved = (pp2.launches_lanereduce, pp2.launches_empty, p3.launches_p3,
             p3.launches_p1b, p3.launches_p1, pp2.launches_lane_gather,
             pp.launches_rowload, pp.launches_smem_idx, pdma.launches)

    def count():
        with _build.count_lock:
            pp2.launches_lanereduce += 1

    def count_p3():
        with _build.count_lock:
            p3.launches_p3 += 1

    def count_p1b():
        with _build.count_lock:
            p3.launches_p1b += 1

    def count_p1():
        with _build.count_lock:
            p3.launches_p1 += 1

    def count_lane_gather():
        with _build.count_lock:
            pp2.launches_lane_gather += 1

    def count_rowload():
        with _build.count_lock:
            pp.launches_rowload += 1

    def count_smem_idx():
        with _build.count_lock:
            pp.launches_smem_idx += 1

    def count_empty():
        with _build.count_lock:
            pp2.launches_empty += 1

    def count_dma():
        with _build.count_lock:
            pdma.launches += 1

    def taken():
        with lock:
            pass

    steps = {
        "helpers": {
            "loop": lambda: None, "lib": _build.lib,
            "stream_of": lambda: _build.stream_of(x),
            "check": lambda: _build.check(0, "launch"), "count": count,
            "stream_object": lambda: torch.cuda.current_stream(
                dev).cuda_stream,
            "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(
                dev.index),
            "lock": taken,
            "ctypes_host": lambda: lib.nabwa_local_form(
                100, 1 << 14, form.data_ptr()),
            "torch_launch": lambda: torch.cuda._sleep(0)},
        "probe_lanereduce": {
            "checks": lambda: (common.cuda_input(x, "x", 2),
                               x.shape[1] != 128),
            "new_empty_args": lambda: x.new_empty(rows, 1),
            "launch": lambda: lib.nabwa_probe_lanereduce(
                x.data_ptr(), rows, out.data_ptr(), st),
            "wrapper": lambda: pp2.lanereduce_cuda(x),
            "library": lambda: torch.sum(x, dim=1, keepdim=True,
                                         dtype=torch.int32)},
        "probe_empty": {
            "empty_like": lambda: torch.empty_like(x1),
            "cuda_inputs": multi and (lambda: multi((x1, "x", x1.dim(),
                                                     i32))),
            "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(index),
            "data_ptr": lambda: (x1.data_ptr(), out1.data_ptr()),
            "launch": lambda: lib.nabwa_probe_empty(
                x1.data_ptr(), n1, out1.data_ptr(), st),
            "check": lambda: _build.check(0, "probe_empty kernel launch"),
            "count": count_empty,
            "wrapper": lambda: pp2.empty_cuda(x1),
            "library": lambda: x1 + 1},
        "probe_dma": {
            "check_args": lambda: pdma._check(d_n, d_t, d_rows, "reg"),
            "cuda_inputs": multi and (lambda: multi((dt, "tab", 2, i32))),
            "shape": lambda: dt.shape[1] != 128 or dt.shape[0] < d_rows,
            "new_empty_args": lambda: dt.new_empty(d_words + 1 + d_t),
            "views": lambda: (d_buf.as_strided((1, 1), (1, 1), d_words),
                              d_buf.as_strided((d_t,), (1,), d_words + 1),
                              d_buf.as_strided((2 * d_n, 128), (128, 1))),
            "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(index),
            "data_ptr": lambda: (dt.data_ptr(), d_buf.data_ptr()),
            "launch": lambda: lib.nabwa_probe_dma(
                dp[0], d_rows, d_n, d_t, 0, 0, dp[1], dp[2], dp[3], dp[4],
                st),
            "check": lambda: _build.check(0, "nabwa_probe_dma kernel launch"),
            "count": count_dma,
            "wrapper": lambda: pdma.dma_cuda(dt, d_n, d_t, d_rows, "reg",
                                             False),
            "library": lambda: torch.index_select(dt, 0, d_flat)},
        "probe_p3": {
            "cuda_inputs": multi and (lambda: multi((gx, "x", 2, i32),
                                                    (gi, "i", 2, i32))),
            "shape": lambda: gi.shape[1] != gx.shape[1],
            "new_empty_args": lambda: gi.new_empty(m, c),
            "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(index),
            "data_ptr": lambda: (gx.data_ptr(), gi.data_ptr(),
                                 g_out.data_ptr()),
            "launch": lambda: lib.nabwa_probe_p3(gp[0], c, gp[1], m * c,
                                                 gp[2], st),
            "check": lambda: _build.check(0, "probe_p3 kernel launch"),
            "count": count_p3,
            "wrapper": lambda: p3.p3_cuda(gx, gi),
            "library": lambda: torch.gather(gx, 0, gi_long)},
        "probe_p1b": {
            "cuda_inputs": multi and (lambda: multi(
                (ri, "i", 2, i32), (rj, "j", 2, i32), (rt, "t", 2, i32))),
            "shape": lambda: (rt.shape[1] % 4, ri.shape[1] != 1
                              or rj.shape != ri.shape),
            "new_empty_args": lambda: rt.new_empty(2 * n, cols),
            "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(index),
            "data_ptr": lambda: (ri.data_ptr(), rj.data_ptr(),
                                 rt.data_ptr(), r_out.data_ptr()),
            "launch": lambda: lib.nabwa_probe_p1b(rp[0], rp[1], n, rp[2],
                                                  cols, rp[3], st),
            "check": lambda: _build.check(0, "probe_p1b kernel launch"),
            "count": count_p1b,
            "wrapper": lambda: p3.p1b_cuda(ri, rj, rt),
            "library": lambda: torch.index_select(rt, 0, flat)},
        "probe_p1": {
            "cuda_inputs": multi and (lambda: multi((pi, "i", 2, i32),
                                                    (rt, "t", 2, i32))),
            "shape": lambda: (rt.shape[1] % 4, pi.shape[1] < 2),
            "new_empty_args": lambda: rt.new_empty(2 * pn, cols),
            "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(index),
            "data_ptr": lambda: (pi.data_ptr(), rt.data_ptr(),
                                 p_out.data_ptr()),
            "launch": lambda: lib.nabwa_probe_p1(qp[0], width, pn, qp[1],
                                                 cols, qp[2], st),
            "check": lambda: _build.check(0, "probe_p1 kernel launch"),
            "count": count_p1,
            "wrapper": lambda: p3.p1_cuda(pi, rt),
            "library": lambda: torch.index_select(rt, 0, p_flat)},
        "probe_lane_gather": {
            "cuda_inputs": multi and (lambda: multi((lx, "x", 2, i32),
                                                    (li, "i", 2, i32))),
            "shape": lambda: (lx.shape[1] != pp2.GATHER_W
                              or li.shape != lx.shape),
            "new_empty_args": lambda: lx.new_empty(lrows, pp2.GATHER_W),
            "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(index),
            "data_ptr": lambda: (lx.data_ptr(), li.data_ptr(),
                                 l_out.data_ptr()),
            "launch": lambda: lib.nabwa_probe_lane_gather(
                lp[0], lp[1], lrows, lp[2], st),
            "check": lambda: _build.check(0,
                                          "probe_lane_gather kernel launch"),
            "count": count_lane_gather,
            "wrapper": lambda: pp2.lane_gather_cuda(lx, li),
            "library": lambda: torch.gather(lx, 1, li_long)},
        "probe_rowload": {
            "cuda_inputs": one_col and (lambda: multi(
                (wi, "idx", 2, i32, 4, one_col), (wt, "table", 2, i32))),
            "shape": lambda: (wi.shape[1] != 1, wt.shape[1] != 128),
            "new_empty_args": lambda: wt.new_empty(bb, 128),
            "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(index),
            "data_ptr": lambda: (wi.data_ptr(), wt.data_ptr(),
                                 w_out.data_ptr()),
            "launch": lambda: lib.nabwa_probe_rowload(wp[0], wp[1], bb,
                                                      wp[2], st),
            "check": lambda: _build.check(
                0, "nabwa_probe_rowload kernel launch"),
            "count": count_rowload,
            "wrapper": lambda: pp.rowload_cuda(wi, wt),
            "library": lambda: torch.index_select(wt, 0, w_col)},
        "probe_smem_idx": {
            "cuda_inputs": one_col and (lambda: multi(
                (si, "idx", 1, i32, 4, None), (wt, "table", 2, i32))),
            "shape": lambda: wt.shape[1] != 128,
            "new_empty_args": lambda: wt.new_empty(bb, 128),
            "stream_raw": lambda: torch._C._cuda_getCurrentRawStream(index),
            "data_ptr": lambda: (si.data_ptr(), wt.data_ptr(),
                                 w_out.data_ptr()),
            "launch": lambda: lib.nabwa_probe_smem_idx(sp[0], sp[1], bb,
                                                       sp[2], st),
            "check": lambda: _build.check(
                0, "nabwa_probe_smem_idx kernel launch"),
            "count": count_smem_idx,
            "wrapper": lambda: pp.smem_idx_cuda(si, wt),
            "library": lambda: torch.index_select(wt, 0, si)}}
    split = {part: {name: None if fn is None else wall_ms(fn, calls) * 1e3
                    for name, fn in fns.items()}
             for part, fns in steps.items()}
    (pp2.launches_lanereduce, pp2.launches_empty, p3.launches_p3,
     p3.launches_p1b, p3.launches_p1, pp2.launches_lane_gather,
     pp.launches_rowload, pp.launches_smem_idx, pdma.launches) = saved
    split["calls"] = calls
    return split


def check_launch_path(dev):
    """The shared launch path keeps its meaning: `stream_of` gives
    PyTorch's current stream on the default stream and on a side stream,
    C14, C29, C28, C27, C20, C7, C15, C8's grid form, C11 and both forms
    of C23 (at T 3), C34, C17 and C18 launched under a side stream are
    exact there (all but C14 take the handle from the device index their
    one check pass read), C14's, C29's, C20's, C7's, C8's, C23's, C34's,
    C17's and C18's launch counts (both forms of the last four) are exact
    when COUNT_THREADS threads launch together, and C8's wrappers and
    C11's refuse, before any launch, what their checks refuse
    (`check_dma_empty_refusals`)."""
    import torch
    from nabwa_tpu_torch.ops import _build
    from nabwa_tpu_torch.probes import probe_dma as pdma
    from nabwa_tpu_torch.probes import probe_pallas as pp
    from nabwa_tpu_torch.probes import probe_pallas2 as pp2
    from nabwa_tpu_torch.probes import probe_pallas3 as p3
    from nabwa_tpu_torch.probes import probe_spill as ps
    x = torch.randint(-2**31, 2**31 - 1, pp2.REDUCE_SHAPE,
                      dtype=torch.int32, device=dev)
    gx = torch.randint(-2**31, 2**31 - 1, p3.P3_X, dtype=torch.int32,
                       device=dev)
    gi = torch.randint(0, p3.P3_X[0], p3.P3_I, dtype=torch.int32,
                       device=dev)
    ri, rj = (torch.randint(0, p3.P1_TABLE[0], (p3.P1_ROUNDS, 1),
                            dtype=torch.int32, device=dev) for _ in range(2))
    rt = torch.randint(-2**31, 2**31 - 1, p3.P1_TABLE, dtype=torch.int32,
                       device=dev)
    pi = torch.randint(0, p3.P1_TABLE[0], (p3.P1_ROUNDS, p3.P1_TABLE[1]),
                       dtype=torch.int32, device=dev)
    lx = torch.randint(-2**31, 2**31 - 1, (pp2.BB, pp2.GATHER_W),
                       dtype=torch.int32, device=dev)
    li = torch.randint(0, pp2.GATHER_W, lx.shape, dtype=torch.int32,
                       device=dev)
    wi = torch.randint(0, pp.ROWLOAD_NROW, (pp.ROWLOAD_BB, 1),
                       dtype=torch.int32, device=dev)
    wt = torch.randint(-2**31, 2**31 - 1, (pp.ROWLOAD_NROW, 128),
                       dtype=torch.int32, device=dev)
    si = wi[:, 0].flip(0).contiguous()
    # C8 at N 128, T 64 over a 4,096-row table, `reg` and `cond`; C11's x
    dma_rows = 4096
    dmt = torch.randint(-2**31, 2**31 - 1, (dma_rows, 128), dtype=torch.int32,
                        device=dev)
    ex = torch.randint(-2**31, 2**31 - 1, pp2.EMPTY_SHAPE, dtype=torch.int32,
                       device=dev)
    # C23 at [64, 128], K 24, T 3; C34 at the script's [256, 128]
    sx = torch.randint(-2**31, 2**31 - 1, SPILL_SWEEP_SHAPE,
                       dtype=torch.int32, device=dev)
    px = torch.randint(-2**31, 2**31 - 1, p3.P5_X, dtype=torch.int32,
                       device=dev)
    # C17 and C18 at the script's [256, 128]
    wx = torch.randint(-2**31, 2**31 - 1, (pp.WHILE_BB, pp.WHILE_S),
                       dtype=torch.int32, device=dev)
    whiles = {"C17's grid form": (pp.while_scratch_cuda,
                                  "launches_while_scratch"),
              "C17's witness": (pp.while_scratch_witness_cuda,
                                "launches_while_scratch_witness"),
              "C18's grid form": (pp.while_vector_cuda,
                                  "launches_while_vector"),
              "C18's witness": (pp.while_vector_witness_cuda,
                                "launches_while_vector_witness")}
    side = torch.cuda.Stream(dev)
    if _build.stream_of(x) != torch.cuda.current_stream(dev).cuda_stream:
        fail("stream_of differs from the current stream")
    with torch.cuda.stream(side):
        if _build.stream_of(x) != side.cuda_stream:
            fail("stream_of differs from the current side stream")
        side.wait_stream(torch.cuda.default_stream(dev))
        got = (pp2.lanereduce_cuda(x), p3.p3_cuda(gx, gi),
               p3.p1b_cuda(ri, rj, rt), p3.p1_cuda(pi, rt),
               pp2.lane_gather_cuda(lx, li), pp.rowload_cuda(wi, wt),
               pp.smem_idx_cuda(si, wt),
               *(pdma.dma_cuda(dmt, 128, DMA_T, dma_rows, src, False)
                 for src in ("reg", "cond")), pp2.empty_cuda(ex),
               ps.spill_cuda(sx, ps.DEFAULT_K, 3),
               ps.spill_witness_cuda(sx, ps.DEFAULT_K, 3),
               p3.p5_cuda(px), p3.p5_witness_cuda(px),
               *(fn(wx) for fn, _ in whiles.values()))
    side.synchronize()
    exact("C14 on a side stream", got[0], pp2.lanereduce_plain(x))
    exact("C29 on a side stream", got[1], p3.p3_plain(gx, gi))
    exact("C28 on a side stream", got[2], p3.p1b_plain(ri, rj, rt))
    exact("C27 on a side stream", got[3], p3.p1_plain(pi, rt))
    exact("C20 on a side stream", got[4], pp2.lane_gather_plain(lx, li))
    exact("C7 on a side stream", got[5], pp.rowload_plain(wi, wt))
    exact("C15 on a side stream", got[6], pp.smem_idx_plain(si, wt))
    for src, res in zip(("reg", "cond"), got[7:9]):
        for part, g, w in zip(("out", "stage", "rounds"), res,
                              pdma.dma_plain(dmt, 128, DMA_T, dma_rows,
                                             src)):
            exact(f"C8 {src} {part} on a side stream", g, w)
    exact("C11 on a side stream", got[9], pp2.empty_plain(ex))
    for form, g in zip(("lane", "witness"), got[10:12]):
        exact(f"C23 {form} on a side stream", g,
              ps.spill_plain(sx, ps.DEFAULT_K, 3))
    for form, g in zip(("grid", "witness"), got[12:14]):
        exact(f"C34 {form} on a side stream", g, p3.p5_plain(px))
    for label, g in zip(whiles, got[14:]):
        exact(f"{label} on a side stream", g,
              (pp.while_scratch_plain if label.startswith("C17")
               else pp.while_vector_plain)(wx))
    for label, mod, name, fn in (
            ("C14", pp2, "launches_lanereduce",
             lambda: pp2.lanereduce_cuda(x)),
            ("C29", p3, "launches_p3", lambda: p3.p3_cuda(gx, gi)),
            ("C20", pp2, "launches_lane_gather",
             lambda: pp2.lane_gather_cuda(lx, li)),
            ("C7", pp, "launches_rowload",
             lambda: pp.rowload_cuda(wi, wt)),
            ("C8", pdma, "launches",
             lambda: pdma.dma_cuda(dmt, 128, DMA_T, dma_rows, "reg",
                                   False)),
            ("C23's lane form", ps, "launches",
             lambda: ps.spill_cuda(sx, ps.DEFAULT_K, 3)),
            ("C23's witness", ps, "launches_witness",
             lambda: ps.spill_witness_cuda(sx, ps.DEFAULT_K, 3)),
            ("C34's grid form", p3, "launches_p5", lambda: p3.p5_cuda(px)),
            ("C34's witness", p3, "launches_p5_witness",
             lambda: p3.p5_witness_cuda(px)),
            *((label, pp, name, lambda fn=fn: fn(wx))
              for label, (fn, name) in whiles.items())):
        before = getattr(mod, name)

        def launch():
            for _ in range(COUNT_CALLS):
                fn()
        threads = [threading.Thread(target=launch)
                   for _ in range(COUNT_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize(dev)
        rose = getattr(mod, name) - before
        if rose != COUNT_THREADS * COUNT_CALLS:
            fail(f"{label}'s count rose by {rose} over "
                 f"{COUNT_THREADS * COUNT_CALLS} launches from "
                 f"{COUNT_THREADS} threads")
    check_dma_empty_refusals(dmt, ex)
    log(f"launch path: stream_of is the current stream (default and side), "
        f"C14, C29, C28, C27, C20, C7, C15, C8, C11, C23, C34, C17 and C18 "
        f"exact on a side stream, C14's, C29's, C20's, C7's, C8's, C23's, "
        f"C34's, C17's and C18's counts exact over "
        f"{COUNT_THREADS} threads x {COUNT_CALLS} launches, C8's and C11's "
        f"refusals before any launch")


def check_dma_empty_refusals(tab, x):
    """C8's wrappers (the grid form, the serial form) and
    C11's refuse, each before any launch (every count unchanged), CUDA
    inputs their checks do not take: for C8 an int64, transposed,
    non-contiguous, misaligned or 1-D table, one under n_rows rows or not
    128 wide, a bad src, N 0 and MAX_N + 1, T -1; for C11 an int64,
    transposed, non-contiguous or misaligned x.  tab: int32 [rows, 128]
    on the card, x: int32 [8, 128]."""
    from nabwa_tpu_torch.probes import probe_dma as pdma
    from nabwa_tpu_torch.probes import probe_pallas2 as pp2
    rows = tab.shape[0]
    forms = {"grid": pdma.dma_cuda, "serial": pdma.dma_serial_cuda}
    wide = tab.new_zeros(rows, 132)
    bad = [("int64 table", tab.long(), 128, 4, rows, "reg"),
           ("transposed table", tab.t().contiguous().t(), 128, 4, rows,
            "reg"),
           ("non-contiguous table", wide[:, 4:], 128, 4, rows, "reg"),
           ("misaligned table", skewed(tab), 128, 4, rows, "reg"),
           ("1-D table", tab.view(-1), 128, 4, rows, "reg"),
           ("table under n_rows rows", tab, 128, 4, rows + 1, "reg"),
           ("table not 128 wide", wide, 128, 4, rows, "reg"),
           ("src", tab, 128, 4, rows, "hbm"),
           ("N 0", tab, 0, 4, rows, "vmem"),
           ("N MAX_N + 1", tab, pdma.MAX_N + 1, 4, rows, "cond"),
           ("T -1", tab, 128, -1, rows, "smem")]
    before = (pdma.launches, pdma.launches_serial, pp2.launches_empty)
    for name, fn in forms.items():
        for what, t, n, it, n_rows, src in bad:
            refused(f"C8 {name} {what}",
                    lambda: fn(t, n, it, n_rows, src, False))
    xw = x.new_zeros(8, 132)
    for what, xx in (("int64", x.long()), ("transposed", x.t()),
                     ("non-contiguous", xw[:, 4:]),
                     ("misaligned", skewed(x))):
        refused(f"C11 {what} x", lambda: pp2.empty_cuda(xx))
    if (pdma.launches, pdma.launches_serial, pp2.launches_empty) != before:
        fail("C8 or C11 launched on an input its wrapper refused")


def gather_refused(label, gather, mod, count, idx_t, tab_t, other, more):
    """C7's or C15's dispatcher `gather` refuses, before any launch (the
    count `mod.<count>` unchanged): indices NROW and -1, an int64 index, a
    transposed and a misaligned table, the index or the table on `other`
    (a second card, where there is one), and the (label, idx, table)
    inputs of `more`."""
    before = getattr(mod, count)
    nrow = tab_t.shape[0]
    for bad in (nrow, -1):
        wrong = idx_t.clone()
        wrong[3] = bad
        refused(f"{label} index {bad}", lambda: gather(wrong, tab_t))
    cases = [("int64 index", idx_t.long(), tab_t),
             ("transposed table", idx_t, tab_t.t().contiguous().t()),
             ("misaligned table", idx_t, skewed(tab_t)), *more]
    if other is not None:
        cases += [(f"index on {other}", idx_t.to(other), tab_t),
                  (f"table on {other}", idx_t, tab_t.to(other))]
    for what, i, t in cases:
        refused(f"{label} {what}", lambda: gather(i, t))
    if getattr(mod, count) != before:
        fail(f"{label} launched on an input its wrapper refused")


def gather_by_rows(cuda, idx_t, tab_t):
    """{k: queued_ms of C7's or C15's wrapper `cuda` on the first k rows of
    idx_t} for k in C20_ROWS: the launch and the index load before each
    row, beside the rows' bytes."""
    by_rows = {}
    for k in C20_ROWS:
        ik = idx_t[:k]
        by_rows[k] = queued_ms(lambda: cuda(ik, tab_t), 200)
    return by_rows


def launch_times(fn, lib_fn):
    """ms (CUDA events over LAUNCH_REPS launches back to back), queued_ms
    and wall_ms (the host's clock) of fn, and the same of lib_fn, the
    library call beside it."""
    return {"ms": cuda_ms(fn, LAUNCH_REPS),
            "queued_ms": queued_ms(fn, 200),
            "wall_ms": wall_ms(fn, LAUNCH_REPS),
            "library_ms": cuda_ms(lib_fn, LAUNCH_REPS),
            "library_queued_ms": queued_ms(lib_fn, 200),
            "library_wall_ms": wall_ms(lib_fn, LAUNCH_REPS)}


def check_dma_edges(dev):
    """C8's grid form and its serial form exact against the
    plain version (out, stage, rounds) in every mode at its edges: T 0
    (one block, no copies), 1 and 1,000 (past one wave of 132 blocks) at
    N 128; N 1 and MAX_N at T 64; n_rows 1 (a one-row table); a table of
    100,000 rows read as 1,000.  Returns {"max_abs_err", "cases"}."""
    import torch
    from nabwa_tpu_torch.probes import probe_dma as pdma
    big = torch.arange(DMA_ROWS[0] * 128, dtype=torch.int32,
                       device=dev).view(DMA_ROWS[0], 128)
    one = big[:1].contiguous()
    cases = {"t0": (big, 128, 0, DMA_ROWS[0]),
             "t1": (big, 128, 1, DMA_ROWS[0]),
             "t1000": (big, 128, 1000, DMA_ROWS[0]),
             "n1": (big, 1, DMA_T, DMA_ROWS[0]),
             "n_max": (big, pdma.MAX_N, DMA_T, DMA_ROWS[0]),
             "n_rows1": (one, 128, DMA_T, 1),
             "more_rows": (big, 128, DMA_T, 1000)}
    worst = 0
    for name, (tab, n, t, n_rows) in cases.items():
        for src in pdma.SRCS:
            want = pdma.dma_plain(tab, n, t, n_rows, src)
            for form, got in (
                    ("grid", pdma.dma_cuda(tab, n, t, n_rows, src, False)),
                    ("serial", pdma.dma_serial_cuda(tab, n, t, n_rows, src,
                                                    False))):
                for part, g, w in zip(("out", "stage", "rounds"), got,
                                      want):
                    worst = max(worst, exact(
                        f"C8 edge {name} {src} {form} {part}", g, w))
        log(f"C8 edge {name} (N {n}, T {t}, n_rows {n_rows}, table rows "
            f"{tab.shape[0]}): exact in every mode, grid and serial")
    return {"max_abs_err": worst, "cases": {
        name: {"n": n, "t": t, "n_rows": n_rows, "table_rows": tab.shape[0]}
        for name, (tab, n, t, n_rows) in cases.items()}}


def chain_bounds(probes):
    """`chain_bound_ms` of C9, C10, C13, C17-C19, C21, C23-C25 and C31-C35:
    the least dependent path of a launch, counted from the function (each
    kernel's header), each step priced at the latency C9's stamped launch
    measured (`latency_cycles` at its `sm_clock_ghz`: an IMAD for an
    integer step and for an fp32 add or multiply, both on the FMA pipe; a
    redux.sync, a shuffle, a shared load) and a load at C12's serial load
    (`serial_ns_per_load`); the path's steps go beside it (`chain_steps`).
    C24: T K steps of an element, each an IMAD beside a shift, then the
    xor; C23: T rounds of the same (both forms); C25: 200 steps of an add
    beside a shift, then the xor; C34 (both forms): the load of s[0, 0],
    then its 226 dependent integer steps, an add an inner round and an and
    and an add an outer round's trip count.  A load, then: C17 and C18
    (both forms of each) 50 rounds of WHILE_CHAIN, C17's carry a shared
    load and a redux.sync more; C13 50 rounds of POP_CHAIN; C19 1,000
    steps of BODY_CHAIN; C21 PUSH_CHAIN for each push of its busiest row
    (`max_row_pushes`), then f0's read back at a shared load's latency (an
    L1 hit at best) and the add of top; C31-C33 50 rounds of P2_CHAIN
    (C32's lane form; its witness's path, P2_ROLL_WITNESS_CHAIN, as
    `witness_chain_bound_ms`); C10 100 iterations of C10_CHAIN; C35 an out
    element's first conversion and product, then its K fp32 adds in index
    order.  C10, C32 (both forms) and C35 get their queued time over the
    chain (`queued_over_chain`).  C34's witness also gets its one SM's
    shared-memory ceiling (`witness_smem_ceiling_ms`): s read and written
    once an inner round at 128 bytes a clock of that SM clock; C17's and
    C18's witnesses their one SM's issue ceiling
    (`witness_issue_ceiling_ms`): WHILE_WITNESS_ISSUE warp instructions a
    warp and round, 32 warps over 4 schedulers, one instruction a clock
    each."""
    from nabwa_tpu_torch.probes import probe_pallas as pp
    from nabwa_tpu_torch.probes import probe_pallas2 as pp2
    from nabwa_tpu_torch.probes import probe_pallas3 as p3
    c9 = probes["probe_dfs_shape"]
    lat, ghz = c9["latency_cycles"], c9["sm_clock_ghz"]
    load_ns = probes["probe_loads"]["serial_ns_per_load"]
    price = {"int": lat["imad"] / ghz, "fp32": lat["imad"] / ghz,
             "redux": lat["redux"] / ghz, "shfl": lat["shfl"] / ghz,
             "lds": lat["lds"] / ghz, "load": load_ns}
    colops, spill = probes["probe_colops"], probes["probe_spill"]
    p5 = probes["probe_p5"]

    def path(steps, n, **more):
        """A load, then `steps` n times, then `more`."""
        out = {k: v * n for k, v in steps.items()}
        out["load"] = out.get("load", 0) + 1
        for k, v in more.items():
            out[k] = out.get(k, 0) + v
        return out
    iters = pp.WHILE_ITERS
    chains = {
        "probe_dfs_shape": {k: v * c9["iters"] for k, v in C9_CHAIN.items()},
        "probe_pallas_dfs_shape": path(C10_CHAIN, pp.DFS_ITERS),
        "probe_colops": {"int": 2 * colops["t"] * colops["k"]},
        "probe_spill": {"int": 2 * spill["t"]},
        "probe_p7": {"int": 2 * p3.P7_STEPS},
        "probe_p5": {"load": 1, "int": p5["inner_rounds"]
                     + 2 * p3.P5_ROUNDS},
        "probe_while_scratch": path(WHILE_CHAIN, iters, redux=1, lds=1),
        "probe_while_vector": path(WHILE_CHAIN, iters),
        "probe_pop": path(POP_CHAIN, pp2.POP_ITERS),
        "probe_body_scale": path(BODY_CHAIN,
                                 pp.BODY_ROUNDS * pp.BODY_STEPS),
        "probe_scalar_push": path(
            PUSH_CHAIN, probes["probe_scalar_push"]["max_row_pushes"],
            int=1, lds=1),
        **{f"probe_p2_{kind}": path(steps, p3.P2_ROUNDS)
           for kind, steps in P2_CHAIN.items()},
        "probe_p6": {"load": 1, "fp32": 2 + p3.P6_X[1]}}
    def ms(steps):
        return sum(n * price[k] for k, n in steps.items()) * 1e-6
    for name, steps in chains.items():
        probes[name].update(chain_bound_ms=ms(steps), chain_steps=steps)
    steps = path(P2_ROLL_WITNESS_CHAIN, p3.P2_ROUNDS)
    roll = probes["probe_p2_roll"]
    roll.update(witness_chain_bound_ms=ms(steps), witness_chain_steps=steps)
    for e in (roll, probes["probe_p6"], probes["probe_pallas_dfs_shape"]):
        e["queued_over_chain"] = e["queued_ms"] / e["chain_bound_ms"]
    roll["witness_queued_over_chain"] = (roll["witness_queued_ms"]
                                         / roll["witness_chain_bound_ms"])
    p5["witness_smem_ceiling_ms"] = (
        p5["inner_rounds"] * 2 * 4 * p5["words"] / SMEM_BYTES_PER_CLOCK
        / ghz * 1e-6)
    for name, per_warp in WHILE_WITNESS_ISSUE.items():
        e = probes[name]
        e["witness_issue_ceiling_ms"] = (iters * per_warp * 32 / 4 / ghz
                                         * 1e-6)
        e["queued_over_chain"] = e["queued_ms"] / e["chain_bound_ms"]
        e["witness_queued_over_chain"] = (e["witness_queued_ms"]
                                          / e["chain_bound_ms"])
    c9["chain_ns_per_iter"] = c9["chain_bound_ms"] * 1e6 / c9["iters"]
    for sh in c9["shapes"]:
        sh["queued_over_chain"] = sh["queued_ms"] / c9["chain_bound_ms"]
        sh["witness_queued_over_chain"] = (sh["witness_queued_ms"]
                                           / c9["chain_bound_ms"])


def sm_clocks():
    """The card's SM clock and its maximum as nvidia-smi reads them now."""
    res = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip() if res.returncode == 0 else None


def stage_split(stages, cal):
    """C9's stamped launch taken apart: each stage's median and p90 cycles
    over every read and iteration, and its share of the summed cycles;
    the iteration's (the five stages') median and p90; the calibration
    chains' cycles a step (median over reads); the SM clock in GHz from
    each read's clock64 and %globaltimer spans (median)."""
    import numpy as np
    from nabwa_tpu_torch.probes import probe_dfs_shape as pds
    st = stages.cpu().numpy().astype(np.int64)
    cw = cal.cpu().numpy().astype(np.int64)
    it = st.sum(axis=2)
    total = int(st.sum())
    out = {"stages": {
        name: {"median": float(np.median(st[:, :, i])),
               "p90": float(np.percentile(st[:, :, i], 90)),
               "share": int(st[:, :, i].sum()) / total}
        for i, name in enumerate(pds.STAGES)},
        "iteration": {"median": float(np.median(it)),
                      "p90": float(np.percentile(it, 90))}}
    names = list(pds.CAL)
    out["latency_cycles"] = {
        k: float(np.median(cw[:, names.index(k)])) / n
        for k, n in pds.CAL_STEPS.items()}
    out["sm_clock_ghz"] = float(np.median(cw[:, names.index("cycles")]
                                          / cw[:, names.index("ns")]))
    return out


def check_dfs_shape(dev, rng):
    """Kernel C9 (scripts/probe_dfs_shape.py, S 128, 200 iterations) at the
    script's 256 reads and at C1's batch of 2,048: the lean form
    (`run_cuda`) and the witness (`run_witness_cuda`), each exact against
    one plain call, timed back to back (`ms`) and queued, in turns
    (witness, lean, lean, witness); each stamped (`run_stamped_cuda`,
    exact too) and taken apart (`stage_split`), nvidia-smi's SM clock read
    beside; then both forms exact at S 32, 64 and 96 (256 reads).  Returns
    C9's fields of the kernels line (`chain_bounds` adds its chain)."""
    import torch
    from nabwa_tpu_torch.probes import common
    from nabwa_tpu_torch.probes import probe_dfs_shape as pds
    forms = {"lean": pds.run_cuda, "witness": pds.run_witness_cuda}
    table = rng.randint(0, 1 << 30, (pds.NROW, 128))
    shapes, worst = [], 0
    for bb in (256, 2048):
        s, iters = 128, 200
        seed = rng.randint(0, 1 << 20, (bb, 128))
        seed_t, tab_t = common.tensors(dev, seed, table)
        touched = []
        plain_ms, want = once_ms(
            lambda: pds.run_plain(seed_t, tab_t, s, iters, touched))
        row, word, slot, read = OPS_SHAPE
        bnd = bound(4 * seed.size + ROW_BYTES * distinct_rows(*touched) + 4,
                    bb * iters * (2 * (row + 8 * word) + s * slot + read))
        sh = {"bb": bb, "s": s, "iters": iters, "plain_ms": plain_ms,
              "bound_ms": bnd[0], "bound_by": bnd[1],
              "bound_int32_ms": bnd[2], "split": {}}
        for form, run in forms.items():
            worst = max(worst, exact(f"C9 probe_dfs_shape {form} BB={bb}",
                                     run(seed_t, tab_t, s, iters), want))
            acc, stages, cal = pds.run_stamped_cuda(seed_t, tab_t, s, iters,
                                                    form == "lean")
            worst = max(worst, exact(
                f"C9 probe_dfs_shape {form} stamped BB={bb}", acc, want))
            sh["split"][form] = stage_split(stages, cal)
            sh["split"][form]["stamped_ms"] = cuda_ms(
                lambda: pds.run_stamped_cuda(seed_t, tab_t, s, iters,
                                             form == "lean"), 3)
        sh["nvidia_smi_clocks"] = sm_clocks()
        queued = {form: [] for form in forms}
        for form in ("witness", "lean", "lean", "witness"):
            queued[form].append(queued_ms(
                lambda: forms[form](seed_t, tab_t, s, iters), 20))
        for form, run in forms.items():
            pre = "" if form == "lean" else "witness_"
            ms = cuda_ms(lambda: run(seed_t, tab_t, s, iters), 20)
            q = sum(queued[form]) / 2
            sh.update({f"{pre}ms": ms, f"{pre}queued_ms": q,
                       f"{pre}queued_ms_turns": queued[form],
                       f"{pre}us_per_iter": ms * 1e3 / iters,
                       f"{pre}queued_us_per_iter": q * 1e3 / iters})
        sh["m_lane_iters_per_s"] = bb / (sh["ms"] / 1e3 / iters) / 1e6
        shapes.append(sh)
        log(f"C9 probe_dfs_shape BB={bb}: both forms exact; {sh}")
    # the other slot counts, each a kernel of its own (S / 32 registers a
    # field a lane)
    for s in (32, 64, 96):
        seed = rng.randint(0, 1 << 20, (256, 128))
        seed_t, tab_t = common.tensors(dev, seed, table)
        want = pds.run_plain(seed_t, tab_t, s, 200)
        for form, run in forms.items():
            worst = max(worst, exact(
                f"C9 probe_dfs_shape {form} BB=256 S={s}",
                run(seed_t, tab_t, s, 200), want))
        log(f"C9 probe_dfs_shape BB=256 S={s} ITERS=200: both forms exact")
    head = {k: v for k, v in shapes[0].items() if k != "split"}
    return dict(
        head, max_abs_err=worst, library_ms=None,
        library_why="none: a pop, row loads and pushes per read, iterated",
        shapes=shapes, exact_s=[32, 64, 96, 128],
        witness_launches=pds.launches_witness,
        stamped_launches=pds.launches_stamped,
        latency_cycles=shapes[0]["split"]["witness"]["latency_cycles"],
        sm_clock_ghz=shapes[0]["split"]["witness"]["sm_clock_ghz"])


def check_probes(dev, split):
    """Phase 18: kernels C7-C22 against their plain versions on the card, at
    the probes' shapes, inputs made with numpy from PROBE_SEED; `split` is
    `launch_split`'s, whose parts go into C11's, C14's and C20's entries.
    Returns
    {kernel name: fields of its kernels-line entry but `launches`}."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.ops import _build
    from nabwa_tpu_torch.probes import common
    from nabwa_tpu_torch.probes import probe_dfs_shape as pds
    from nabwa_tpu_torch.probes import probe_dma as pdma
    from nabwa_tpu_torch.probes import probe_pallas as pp
    from nabwa_tpu_torch.probes import probe_pallas2 as pp2
    from nabwa_tpu_torch.probes import probe_sem as psem
    rng = np.random.RandomState(PROBE_SEED)
    out = {}

    # C7: probe 1's row gather, 256 rows of a [4096, 128] table; the
    # script's indices, then both ends of the table and repeats, and the
    # script's indices off a 16-byte boundary (read as int32, accepted)
    nrow = pp.ROWLOAD_NROW
    idx = rng.randint(0, nrow, (pp.ROWLOAD_BB, 1))
    edge = idx.copy()
    edge[:4, 0] = (0, nrow - 1, 0, nrow - 1)
    edge[100:140, 0] = 7
    table = np.arange(nrow * 128).reshape(nrow, 128) % 9973
    idx_t, edge_t, tab_t = common.tensors(dev, idx, edge, table)
    err = max(exact("C7 probe_rowload", pp.rowload(idx_t, tab_t),
                    pp.rowload_plain(idx_t, tab_t)),
              exact("C7 probe_rowload edges", pp.rowload(edge_t, tab_t),
                    pp.rowload_plain(edge_t, tab_t)),
              exact("C7 probe_rowload misaligned index",
                    pp.rowload(skewed(idx_t), tab_t),
                    pp.rowload_plain(idx_t, tab_t)))
    other = other_device(dev)
    gather_refused("C7", pp.rowload, pp, "launches_rowload", idx_t, tab_t,
                   other, [("index [BB, 2]",
                            torch.cat((idx_t, idx_t), 1), tab_t),
                           ("transposed index ([1, BB])", idx_t.t(),
                            tab_t)])
    lib_idx = idx_t[:, 0]
    n_rows = distinct_rows(idx_t)
    bnd = bound(4 * len(idx) + ROW_BYTES * (n_rows + len(idx)), 0)
    out["probe_rowload"] = {
        "max_abs_err": err,
        **launch_times(lambda: pp.rowload_cuda(idx_t, tab_t),
                       lambda: torch.index_select(tab_t, 0, lib_idx)),
        "plain_ms": cuda_ms(lambda: pp.rowload_plain(idx_t, tab_t), 200),
        "bound_ms": bnd[0], "bound_by": bnd[1], "bound_int32_ms": bnd[2],
        "library_call": "torch.index_select(table, 0, idx[:, 0]), the "
                        "column taken beforehand",
        "rows": len(idx), "distinct_rows": n_rows,
        "exact_inputs": ["script", "edges", "misaligned_index"],
        "queued_ms_by_rows": gather_by_rows(pp.rowload_cuda, idx_t, tab_t),
        "other_device_refused": other is not None,
        "host_split": {"helpers": split["helpers"],
                       "steps": split["probe_rowload"],
                       "calls": split["calls"]}}
    log(f"C7 probe_rowload: exact; {out['probe_rowload']}")

    # C8: T=64 rounds of N row copies, every mode, two table sizes.  The
    # grid form (dma_cuda, one block a round, its copies by cp.async) exact
    # against the plain version (out, stage, rounds), timed back to back,
    # queued and on the host's clock beside the gather of the same T N
    # rows (torch.index_select, the rows made beforehand: the bytes'
    # yardstick, not the same function), and L2-cold (flushed before each
    # launch); the serial form (dma_serial_cuda, one block, the rounds in
    # order) exact and timed as the witness of a serial round's latency.
    # The grid form's time a copy is queued_us_per_copy, the card's own
    # time over T N copies made side by side: a rate, not a copy's
    # latency, which serial_us_per_iter gives a round.  Then the edges of
    # both forms (check_dma_edges)
    configs, worst = [], 0
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    for rows in DMA_ROWS:
        tab = torch.arange(rows * 128, dtype=torch.int32,
                           device=dev).view(rows, 128)
        for n in (64, 128):
            for unroll in (False, True):
                for src in pdma.SRCS:
                    label = (f"C8 probe_dma rows={rows} N={n} "
                             f"unroll={unroll} src={src}")
                    forms = {
                        "grid": lambda: pdma.dma_cuda(tab, n, DMA_T, rows,
                                                      src, unroll),
                        "serial": lambda: pdma.dma_serial_cuda(
                            tab, n, DMA_T, rows, src, unroll)}
                    want = pdma.dma_plain(tab, n, DMA_T, rows, src)
                    for form, fn in forms.items():
                        for part, g, w in zip(("out", "stage", "rounds"),
                                              fn(), want):
                            worst = max(worst, exact(
                                f"{label} {form} {part}", g, w))
                    r1, r2, _ = pdma.copy_rows(n, DMA_T, rows, src)
                    flat = torch.cat([r.reshape(-1) for r in (r1, r2)
                                      if r is not None]).to(dev)
                    bnd = bound(ROW_BYTES * (distinct_rows(r1, r2) + 2 * n)
                                + 4 + 4 * DMA_T, 0)
                    times = launch_times(
                        forms["grid"],
                        lambda: torch.index_select(tab, 0, flat))
                    ms = times["ms"]
                    serial_ms = cuda_ms(forms["serial"], 10)
                    configs.append({
                        "rows": rows, "n": n, "unroll": unroll, "src": src,
                        "ms": ms, "queued_ms": times["queued_ms"],
                        "wall_ms": times["wall_ms"],
                        "plain_ms": cuda_ms(lambda: pdma.dma_plain(
                            tab, n, DMA_T, rows, src), 2),
                        "bound_ms": bnd[0], "bound_by": bnd[1],
                        "bound_int32_ms": bnd[2],
                        "queued_us_per_copy":
                            times["queued_ms"] * 1e3 / DMA_T / n,
                        "cold_ms": cold_ms(forms["grid"], 5, flush),
                        "gather_ms": times["library_ms"],
                        "gather_queued_ms": times["library_queued_ms"],
                        "gather_wall_ms": times["library_wall_ms"],
                        "gather_rows": flat.numel(),
                        "serial_ms": serial_ms,
                        "serial_queued_ms": queued_ms(forms["serial"], 10),
                        "serial_us_per_iter": serial_ms * 1e3 / DMA_T,
                        "serial_cold_ms": cold_ms(forms["serial"], 3,
                                                  flush)})
                    log(f"{label}: exact (grid, serial); "
                        f"{configs[-1]}")
        del tab
    edges = check_dma_edges(dev)
    # the script's own default: ROWS=100000, N=128, unroll off, reg
    main_cfg = next(c for c in configs if c["rows"] == DMA_ROWS[0]
                    and c["n"] == 128 and not c["unroll"]
                    and c["src"] == "reg")
    out["probe_dma"] = {
        **main_cfg, "max_abs_err": max(worst, edges["max_abs_err"]),
        "library_ms": None,
        "library_why": "none: one PyTorch call does not compute out, the "
                       "stage and the rounds' witness",
        "gather_why": "torch.index_select(tab, 0, rows) over the T N rows "
                      "the copies read, the rows made beforehand: the "
                      "bytes' yardstick, not the same function",
        "t": DMA_T, "configs": configs,
        "edges": edges["cases"],
        "host_split": {"helpers": split["helpers"],
                       "steps": split["probe_dma"],
                       "calls": split["calls"]}}

    # C9: scripts/probe_dfs_shape.py at its default and at C1's batch, both
    # forms and their stamped split (check_dfs_shape)
    out["probe_dfs_shape"] = check_dfs_shape(dev, rng)

    # C10: probe 5, 100 iterations, 256 reads of 128 slots, a 16 MB table
    k = rng.randint(0, pp.DFS_NROW, (pp.DFS_BB, 128))
    table = rng.randint(0, 1 << 30, (pp.DFS_NROW, 128))
    k_t, tab_t = common.tensors(dev, k, table)
    touched = []
    err = exact("C10 probe_pallas_dfs_shape", pp.dfs_shape_cuda(k_t, tab_t),
                pp.dfs_shape_plain(k_t, tab_t, touched=touched))
    word, slot, read = OPS_PALLAS
    bnd = bound(4 * k.size + ROW_BYTES * distinct_rows(*touched) + 4,
                pp.DFS_BB * pp.DFS_ITERS
                * (128 * word + pp.DFS_S * slot + read))
    ms = cuda_ms(lambda: pp.dfs_shape_cuda(k_t, tab_t), 20)
    queued = queued_ms(lambda: pp.dfs_shape_cuda(k_t, tab_t), 20)
    out["probe_pallas_dfs_shape"] = {
        "max_abs_err": err, "ms": ms, "queued_ms": queued,
        "queued_us_per_iter": queued * 1e3 / pp.DFS_ITERS,
        "plain_ms": once_ms(lambda: pp.dfs_shape_plain(k_t, tab_t))[0],
        "bound_ms": bnd[0], "bound_by": bnd[1],
        "bound_int32_ms": bnd[2], "library_ms": None,
        "library_why": "none: a pop, row loads and pushes per read, iterated",
        "us_per_iter": ms * 1e3 / pp.DFS_ITERS,
        "bb": pp.DFS_BB, "s": pp.DFS_S, "iters": pp.DFS_ITERS}
    log(f"C10 probe_pallas_dfs_shape: exact; "
        f"{out['probe_pallas_dfs_shape']}")

    # C11: probe A, x + 1 over [8, 128]: a launch and little else, timed
    # on the card (events, and queued) and on the host's clock, beside the
    # library's
    x = rng.randint(I32_MIN, I32_MAX + 1, pp2.EMPTY_SHAPE)
    x[0, :4] = (I32_MAX, I32_MIN, -1, 0)
    x_t, = common.tensors(dev, x)
    err = exact("C11 probe_empty", pp2.empty_cuda(x_t), pp2.empty_plain(x_t))
    bnd = bound(2 * nbytes(x_t), OPS_ONE * x_t.numel())
    out["probe_empty"] = {
        "max_abs_err": err,
        **launch_times(lambda: pp2.empty_cuda(x_t), lambda: x_t + 1),
        "plain_ms": cuda_ms(lambda: pp2.empty_plain(x_t), 200),
        "bound_ms": bnd[0], "bound_by": bnd[1], "bound_int32_ms": bnd[2],
        "library_call": "x + 1",
        "host_split": {"helpers": split["helpers"],
                       "steps": split["probe_empty"],
                       "calls": split["calls"]}}
    log(f"C11 probe_empty: exact; {out['probe_empty']}")

    # C12: probe B, 2 x 256 row loads from a 16 MB table.  The grid form
    # (loads_cuda, either unroll) exact on the script's inputs and on
    # index_cases' (the table's first and last rows, four rows repeated,
    # one row throughout), idx 2 and 3 columns wide, and BB 0, 1, 257 (not
    # a multiple of a block's 4 rows) and 5,001 (past the grid's 2,048
    # blocks, so its warps take two steps); the serial forms
    # (loads_serial_cuda, one warp) exact and timed as the witness of one
    # load's latency (`serial_*`, C3's chain bound)
    idx = rng.randint(0, pp2.NROW, (pp2.BB, 128))
    table = rng.randint(0, 1 << 30, (pp2.NROW, 128))
    idx_t, tab_t = common.tensors(dev, idx, table)
    want = pp2.loads_plain(idx_t, tab_t)
    err = 0
    for unroll in (1, pp2.LOADS_UNROLL):
        err = max(err, exact(f"C12 probe_loads unroll={unroll}",
                             pp2.loads_cuda(idx_t, tab_t, unroll), want))
    erng = np.random.RandomState(LOADS_EDGE_SEED)
    cases = index_cases(erng, pp2.NROW, (pp2.BB, 128))
    cases.update({"width2": idx[:, :2], "width3": idx[:, :3],
                  "bb0": idx[:0], "bb1": idx[:1],
                  "bb257": erng.randint(0, pp2.NROW, (257, 5)),
                  "bb5001": erng.randint(0, pp2.NROW, (5001, 2))})
    for name, case in cases.items():
        c_t, = common.tensors(dev, case)
        for unroll in (1, pp2.LOADS_UNROLL):
            if unroll == 1 or len(case) % pp2.LOADS_UNROLL == 0:
                err = max(err, exact(
                    f"C12 probe_loads {name} unroll={unroll}",
                    pp2.loads_cuda(c_t, tab_t, unroll),
                    pp2.loads_plain(c_t, tab_t)))
    log(f"C12 probe_loads: exact on the script's inputs and {list(cases)}")
    flat = idx_t[:, :2].t().reshape(-1).contiguous()
    n_rows = distinct_rows(flat)
    bnd = bound(4 * flat.numel() + ROW_BYTES * (n_rows + flat.numel()), 0)
    serial = {}
    for unroll, tag in ((1, "serial"), (pp2.LOADS_UNROLL,
                                        "serial_unrolled")):
        err = max(err, exact(f"C12 probe_loads serial unroll={unroll}",
                             pp2.loads_serial_cuda(idx_t, tab_t, unroll),
                             want))
        def launch():
            pp2.loads_serial_cuda(idx_t, tab_t, unroll)
        ms = cuda_ms(launch, 200)
        serial.update({f"{tag}_ms": ms,
                       f"{tag}_ns_per_load": ms * 1e6 / flat.numel(),
                       f"{tag}_queued_ms": queued_ms(launch, 200)})
    times = launch_times(lambda: pp2.loads_cuda(idx_t, tab_t),
                         lambda: torch.index_select(tab_t, 0, flat))
    out["probe_loads"] = {
        "max_abs_err": err, **times,
        "plain_ms": cuda_ms(lambda: pp2.loads_plain(idx_t, tab_t), 200),
        "bound_ms": bnd[0], "bound_by": bnd[1], "bound_int32_ms": bnd[2],
        "library_call": "torch.index_select(table, 0, "
                        "idx[:, :2].t().reshape(-1))",
        "ns_per_load": times["ms"] * 1e6 / flat.numel(),
        **serial, "loads": flat.numel(), "distinct_rows": n_rows,
        "exact_inputs": ["script"] + list(cases)}
    log(f"C12 probe_loads: exact; {out['probe_loads']}")

    # C13: probe F, 50 pop rounds over 256 rows of 256 slots; out, the
    # whole final key and each round's minimum, on the script's input, on
    # forced ties and on tied sums past int32
    shape = (pp2.BB, pp2.POP_S)
    inputs = {"script": rng.randint(0, 1 << 20, shape),
              "ties": rng.randint(0, 8, shape),
              "wrap": np.where(rng.rand(*shape) < 0.5,
                               I32_MAX - rng.randint(0, 8, shape),
                               I32_MIN + rng.randint(0, 8, shape))}
    worst = 0
    for name, x in inputs.items():
        x_t, = common.tensors(dev, x)
        got, want = pp2.pop_cuda(x_t), pp2.pop_plain(x_t)
        for part, g, w in zip(("out", "key", "witness"), got, want):
            worst = max(worst, exact(f"C13 probe_pop {name} {part}", g, w))
        log(f"C13 probe_pop {name}: exact")
    x_t, = common.tensors(dev, inputs["script"])
    slot, round_slot, round_row = OPS_POP
    bnd = bound(nbytes(x_t, *got),
                x_t.numel() * slot + pp2.BB * pp2.POP_ITERS
                * (pp2.POP_S * round_slot + round_row))
    ms = cuda_ms(lambda: pp2.pop_cuda(x_t), 200)
    out["probe_pop"] = {
        "max_abs_err": worst, "ms": ms,
        "plain_ms": cuda_ms(lambda: pp2.pop_plain(x_t), 5),
        "bound_ms": bnd[0], "bound_by": bnd[1],
        "bound_int32_ms": bnd[2], "library_ms": None,
        "library_why": "none: 50 dependent rounds of a minimum, tie "
                       "extraction and feedback",
        "us_per_iter": ms * 1e3 / pp2.POP_ITERS,
        "queued_ms": queued_ms(lambda: pp2.pop_cuda(x_t), 200),
        "exact_inputs": list(inputs)}
    log(f"C13 probe_pop: exact; {out['probe_pop']}")

    # C14: probe E, the lane sum of [512, 128], on the script's values and
    # on values near both ends of int32
    x = rng.randint(0, 99, pp2.REDUCE_SHAPE)
    edge = np.where(rng.rand(*pp2.REDUCE_SHAPE) < 0.5,
                    I32_MAX - rng.randint(0, 1000, pp2.REDUCE_SHAPE),
                    I32_MIN + rng.randint(0, 1000, pp2.REDUCE_SHAPE))
    x_t, edge_t = common.tensors(dev, x, edge)
    err = max(exact("C14 probe_lanereduce", pp2.lanereduce_cuda(x_t),
                    pp2.lanereduce_plain(x_t)),
              exact("C14 probe_lanereduce wrap", pp2.lanereduce_cuda(edge_t),
                    pp2.lanereduce_plain(edge_t)))
    rows, width = pp2.REDUCE_SHAPE
    bnd = bound(nbytes(x_t) + 4 * rows, OPS_SUM * (rows * (width - 1)))
    out["probe_lanereduce"] = {
        "max_abs_err": err,
        **launch_times(lambda: pp2.lanereduce_cuda(x_t),
                       lambda: torch.sum(x_t, dim=1, keepdim=True,
                                         dtype=torch.int32)),
        "plain_ms": cuda_ms(lambda: pp2.lanereduce_plain(x_t), 200),
        "bound_ms": bnd[0], "bound_by": bnd[1], "bound_int32_ms": bnd[2],
        "library_call": "torch.sum(x, dim=1, keepdim=True, "
                        "dtype=torch.int32)",
        "host_split": {"helpers": split["helpers"],
                       "steps": split["probe_lanereduce"],
                       "calls": split["calls"]}}
    log(f"C14 probe_lanereduce: exact; {out['probe_lanereduce']}")

    # C15: probe 2, C7's gather with each block's indices staged in shared
    # memory; the script's indices, then both ends of the table and
    # repeats, and the script's indices off a 16-byte boundary
    nrow = pp.ROWLOAD_NROW
    idx = rng.randint(0, nrow, pp.ROWLOAD_BB)
    edge = idx.copy()
    edge[:4] = (0, nrow - 1, 0, nrow - 1)
    edge[100:140] = 7
    table = np.arange(nrow * 128).reshape(nrow, 128) % 9973
    idx_t, edge_t, tab_t = common.tensors(dev, idx, edge, table)
    err = max(exact("C15 probe_smem_idx", pp.smem_idx(idx_t, tab_t),
                    pp.smem_idx_plain(idx_t, tab_t)),
              exact("C15 probe_smem_idx edges", pp.smem_idx(edge_t, tab_t),
                    pp.smem_idx_plain(edge_t, tab_t)),
              exact("C15 probe_smem_idx misaligned index",
                    pp.smem_idx(skewed(idx_t), tab_t),
                    pp.smem_idx_plain(idx_t, tab_t)))
    other = other_device(dev)
    gather_refused("C15", pp.smem_idx, pp, "launches_smem_idx", idx_t,
                   tab_t, other, [])
    n_rows = distinct_rows(idx_t)
    bnd = bound(4 * len(idx) + ROW_BYTES * (n_rows + len(idx)), 0)
    out["probe_smem_idx"] = {
        "max_abs_err": err,
        **launch_times(lambda: pp.smem_idx_cuda(idx_t, tab_t),
                       lambda: torch.index_select(tab_t, 0, idx_t)),
        "plain_ms": cuda_ms(lambda: pp.smem_idx_plain(idx_t, tab_t), 200),
        "bound_ms": bnd[0], "bound_by": bnd[1], "bound_int32_ms": bnd[2],
        "library_call": "torch.index_select(table, 0, idx)",
        "rows": len(idx), "distinct_rows": n_rows,
        "exact_inputs": ["script", "edges", "misaligned_index"],
        "queued_ms_by_rows": gather_by_rows(pp.smem_idx_cuda, idx_t, tab_t),
        "other_device_refused": other is not None,
        "host_split": {"helpers": split["helpers"],
                       "steps": split["probe_smem_idx"],
                       "calls": split["calls"]}}
    log(f"C15 probe_smem_idx: exact; {out['probe_smem_idx']}")

    # C16: probe 3, the popcount of [256, 128]; the script's values lie in
    # [0, 2^30), so also every int32 and the ends
    x = rng.randint(0, 1 << 30, pp.POPCOUNT_SHAPE)
    edge = rng.randint(I32_MIN, I32_MAX + 1, pp.POPCOUNT_SHAPE)
    edge[0, :8] = (I32_MIN, -1, I32_MAX, 0, 1, -2, I32_MIN + 1, 1 << 30)
    x_t, edge_t = common.tensors(dev, x, edge)
    err = max(exact("C16 probe_popcount", pp.popcount_cuda(x_t),
                    pp.popcount_plain(x_t)),
              exact("C16 probe_popcount edges", pp.popcount_cuda(edge_t),
                    pp.popcount_plain(edge_t)))
    bnd = bound(2 * nbytes(x_t), OPS_ONE * x_t.numel())
    lib_fn = getattr(torch, "bitwise_count", None)
    lib = ({"library_ms": cuda_ms(lambda: lib_fn(x_t), 200),
            "library_queued_ms": queued_ms(lambda: lib_fn(x_t), 200),
            "library_call": "torch.bitwise_count(x)"} if lib_fn else
           {"library_ms": None,
            "library_why": f"none: torch {torch.__version__} has no "
                           f"popcount (torch.bitwise_count)"})
    out["probe_popcount"] = {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: pp.popcount_cuda(x_t), 200),
        "plain_ms": cuda_ms(lambda: pp.popcount_plain(x_t), 200),
        "bound_ms": bnd[0], "bound_by": bnd[1],
        "bound_int32_ms": bnd[2], **lib,
        "queued_ms": queued_ms(lambda: pp.popcount_cuda(x_t), 200)}
    log(f"C16 probe_popcount: exact; {out['probe_popcount']}")

    # C17, C18: probes 4 and 4b, 50 rounds over a [256, 128] pool, both
    # forms of each, the grid form (the probe's route) and the one-block
    # witness: on the script's values, within 8 of both ends of int32 (+ 7
    # wraps, the sums wrap), all INT32_MAX - 3, heavy ties, and values from
    # 2^30, whose every row sum and C17's carry wrap many times (drawn
    # from a generator of their own, so that the later probes' inputs stay
    # as they were); queued in turns (witness, grid, grid, witness)
    pool = (pp.WHILE_BB, pp.WHILE_S)
    inputs = {"script": rng.randint(0, 1000, pool),
              "near_max": I32_MAX - rng.randint(0, 8, pool),
              "near_min": I32_MIN + rng.randint(0, 8, pool),
              "all_max_minus_3": np.full(pool, I32_MAX - 3),
              "ties": rng.randint(0, 8, pool),
              "wraps": (1 << 30) + np.random.RandomState(
                  PROBE_SEED + 17).randint(0, 1000, pool)}
    forms = {kern: {"grid": getattr(pp, kern + "_cuda"),
                    "witness": getattr(pp, kern + "_witness_cuda")}
             for kern in ("while_scratch", "while_vector")}
    worst = dict.fromkeys(forms, 0)
    for name, x in inputs.items():
        x_t, = common.tensors(dev, x)
        for kern, fns in forms.items():
            want = getattr(pp, kern + "_plain")(x_t)
            for form, fn in fns.items():
                worst[kern] = max(worst[kern], exact(
                    f"probe_{kern} {form} {name}", fn(x_t), want))
        log(f"C17, C18 on {name}: both forms exact")
    wraps = inputs["wraps"].astype(np.int64)
    if wraps.min() * pp.WHILE_ITERS * pp.WHILE_BB < 1000 * 2**32:
        fail("C17's wrapping input does not wrap its carry 1,000 times")
    x_t, = common.tensors(dev, inputs["script"])
    slot, row = OPS_WHILE
    n_ops = pp.WHILE_ITERS * pp.WHILE_BB * (pp.WHILE_S * slot + row)
    for kern, label, out_bytes, tag, warps in (
            ("while_scratch", "C17", 4, "probe_while_scratch",
             pp.WHILE_SCRATCH_WARPS),
            ("while_vector", "C18", nbytes(x_t), "probe_while_vector",
             pp.WHILE_VECTOR_WARPS)):
        fns = forms[kern]
        bnd = bound(nbytes(x_t) + out_bytes, n_ops)
        queued = {form: [] for form in fns}
        for form in ("witness", "grid", "grid", "witness"):
            queued[form].append(queued_ms(lambda: fns[form](x_t), 200))
        q, wq = (sum(queued[form]) / 2 for form in ("grid", "witness"))
        ms, wms = (cuda_ms(lambda: fns[form](x_t), 200)
                   for form in ("grid", "witness"))
        report = grid_witness_ptxas(_build.build_log, tag)
        if sorted(report) != ["grid", "witness"] or any(
                "registers" not in v for v in report.values()):
            fail(f"{label}: no ptxas report for both forms: {report}")
        grid, wit = report["grid"], report["witness"]
        if grid["spill_store_bytes"] or grid["spill_load_bytes"] or \
                grid["stack_bytes"]:
            fail(f"{label}'s grid form spills or keeps a stack frame: "
                 f"{grid}")
        # C18's witness keeps two of its eight row sums in local memory
        known = 16 if kern == "while_vector" else 0
        if max(wit["spill_store_bytes"], wit["spill_load_bytes"]) > known:
            fail(f"{label}'s witness spills more than {known} bytes: {wit}")
        out["probe_" + kern] = {
            "max_abs_err": worst[kern], "ms": ms,
            "plain_ms": cuda_ms(lambda: getattr(pp, kern + "_plain")(x_t),
                                5),
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "bound_int32_ms": bnd[2], "library_ms": None,
            "library_why": "none: 50 dependent rounds of a row minimum and "
                           "update",
            "queued_ms": q, "queued_ms_turns": queued["grid"],
            "us_per_iter": ms * 1e3 / pp.WHILE_ITERS,
            "queued_us_per_iter": q * 1e3 / pp.WHILE_ITERS,
            "warps_a_block": warps, "blocks": pp.WHILE_BB // warps,
            "witness_ms": wms, "witness_queued_ms": wq,
            "witness_queued_ms_turns": queued["witness"],
            "witness_queued_us_per_iter": wq * 1e3 / pp.WHILE_ITERS,
            "witness_over_grid_queued": wq / q,
            "witness_launches": getattr(pp, f"launches_{kern}_witness"),
            "ptxas": report, "ptxas_from_cache": _build.build_seconds is None,
            "exact_inputs": list(inputs)}
        log(f"{label} probe_{kern}: both forms exact; "
            f"{out['probe_' + kern]}")
    c17, c18 = out["probe_while_scratch"], out["probe_while_vector"]
    c17["carry_over_c18_queued"] = c17["queued_ms"] / c18["queued_ms"]
    c17["witness_carry_over_c18_queued"] = (c17["witness_queued_ms"]
                                            / c18["witness_queued_ms"])

    # C19: probe 4c, 50 x 20 elementwise steps over [256, 128], on the
    # script's values, near both ends of int32 and on every residue mod 8
    shape = pp.BODY_SHAPE
    inputs = {"script": rng.randint(0, 1000, shape),
              "near_max": I32_MAX - rng.randint(0, 64, shape),
              "near_min": I32_MIN + rng.randint(0, 64, shape),
              "small": rng.randint(-8, 8, shape)}
    err = 0
    for name, x in inputs.items():
        x_t, = common.tensors(dev, x)
        err = max(err, exact(f"C19 probe_body_scale {name}",
                             pp.body_scale_cuda(x_t),
                             pp.body_scale_plain(x_t)))
    x_t, = common.tensors(dev, inputs["script"])
    bnd = bound(2 * nbytes(x_t),
                OPS_BODY * pp.BODY_ROUNDS * pp.BODY_STEPS * x_t.numel())
    ms = cuda_ms(lambda: pp.body_scale_cuda(x_t), 200)
    queued = queued_ms(lambda: pp.body_scale_cuda(x_t), 200)
    out["probe_body_scale"] = {
        "max_abs_err": err, "ms": ms,
        "plain_ms": cuda_ms(lambda: pp.body_scale_plain(x_t), 3),
        "bound_ms": bnd[0], "bound_by": bnd[1],
        "bound_int32_ms": bnd[2], "library_ms": None,
        "library_why": "none: 1,000 dependent elementwise steps with a "
                       "data-dependent select",
        "queued_ms": queued, "us_per_iter": ms * 1e3 / pp.BODY_ROUNDS,
        "queued_us_per_iter": queued * 1e3 / pp.BODY_ROUNDS,
        "exact_inputs": list(inputs)}
    log(f"C19 probe_body_scale: exact; {out['probe_body_scale']}")

    # C20: probe C, the lane gather of [256, 128]: the script's inputs,
    # then indices all 0, all 127 and a permutation of each row with x at
    # +-(2^31 - 1); an index out of range is refused
    shape = (pp2.BB, pp2.GATHER_W)
    x = rng.randint(0, 99, shape)
    edge_x = rng.randint(I32_MIN, I32_MAX + 1, shape)
    edge_x[:, 0], edge_x[:, -1] = I32_MAX, -I32_MAX
    inputs = {"script": (x, rng.randint(0, pp2.GATHER_W, shape)),
              "zeros": (edge_x, np.zeros(shape)),
              "last": (edge_x, np.full(shape, pp2.GATHER_W - 1)),
              "perm": (edge_x, np.stack([rng.permutation(pp2.GATHER_W)
                                         for _ in range(pp2.BB)]))}
    err = 0
    for name, (xs, idx) in inputs.items():
        x_t, i_t = common.tensors(dev, xs, idx)
        err = max(err, exact(f"C20 probe_lane_gather {name}",
                             pp2.lane_gather(x_t, i_t),
                             pp2.lane_gather_plain(x_t, i_t)))
    x_t, i_t = common.tensors(dev, *inputs["script"])
    before = pp2.launches_lane_gather
    for r, c, v in ((3, 9, pp2.GATHER_W), (5, 17, -1)):
        bad = i_t.clone()
        bad[r, c] = v
        refused(f"C20 index {v}", lambda: pp2.lane_gather(x_t, bad))
    refused("C20 misaligned x", lambda: pp2.lane_gather(skewed(x_t), i_t))
    refused("C20 misaligned index",
            lambda: pp2.lane_gather(x_t, skewed(i_t)))
    refused("C20 int64 index", lambda: pp2.lane_gather(x_t, i_t.long()))
    refused("C20 transposed x",
            lambda: pp2.lane_gather(x_t.t().contiguous().t(), i_t))
    refused("C20 transposed index",
            lambda: pp2.lane_gather(x_t, i_t.t().contiguous().t()))
    other = other_device(dev)
    if other is not None:
        refused(f"C20 index on {other}",
                lambda: pp2.lane_gather(x_t, i_t.to(other)))
    if pp2.launches_lane_gather != before:
        fail("C20 launched on an input its wrapper refused")
    # queued at 1, 16 and 256 rows: the launch floor beside the rows' work
    by_rows = {}
    for k in C20_ROWS:
        xk, ik = x_t[:k], i_t[:k]
        by_rows[k] = queued_ms(lambda: pp2.lane_gather_cuda(xk, ik), 200)
    i_long = i_t.long()
    bnd = bound(3 * nbytes(x_t), OPS_GATHER * x_t.numel())
    out["probe_lane_gather"] = {
        "max_abs_err": err,
        **launch_times(lambda: pp2.lane_gather_cuda(x_t, i_t),
                       lambda: torch.gather(x_t, 1, i_long)),
        "plain_ms": cuda_ms(lambda: pp2.lane_gather_plain(x_t, i_t), 200),
        "bound_ms": bnd[0], "bound_by": bnd[1], "bound_int32_ms": bnd[2],
        "library_call": "torch.gather(x, 1, i.long()), the int64 index "
                        "made once beforehand",
        "exact_inputs": list(inputs), "queued_ms_by_rows": by_rows,
        "other_device_refused": other is not None,
        "host_split": {"helpers": split["helpers"],
                       "steps": split["probe_lane_gather"],
                       "calls": split["calls"]}}
    log(f"C20 probe_lane_gather: exact; {out['probe_lane_gather']}")

    # C21: probe D, 50 rounds of up to three 5-field pushes a row into
    # [256, 256] buffers; out, the five buffers and top, on the script's
    # input, near both int32 ends (the fields wrap), 3 pushes a round and
    # none
    shape = (pp2.BB, pp2.PUSH_OUT)
    c = rng.randint(0, 1 << 20, shape)
    near_max = I32_MAX - rng.randint(0, 1 << 10, shape)
    near_max[::2, 0] = I32_MAX                          # v + 1 wraps
    near_min = I32_MIN + rng.randint(0, 1 << 10, shape)
    near_min[::2, 1] = I32_MIN + rng.randint(0, 7, pp2.BB // 2)  # v - 7
    inputs = {"script": c, "near_max": near_max, "near_min": near_min,
              "all_three": np.where(np.arange(128) < 8, c | 3, c),
              "none": np.where(np.arange(128) < 8, c & ~3, c)}
    err = 0
    for name, cs in inputs.items():
        c_t, = common.tensors(dev, cs)
        got, want = pp2.scalar_push_cuda(c_t), pp2.scalar_push_plain(c_t)
        for part, g, w in zip(("out", "fields", "top"), got, want):
            err = max(err, exact(f"C21 probe_scalar_push {name} {part}", g,
                                 w))
        log(f"C21 probe_scalar_push {name}: exact, "
            f"{int(want[2][:, 0].sum())} pushes")
    c_t, = common.tensors(dev, inputs["script"])
    res = pp2.scalar_push_cuda(c_t)
    pushes = int(res[2][:, 0].long().sum())
    row_round, push = OPS_PUSH
    bnd = bound(pp2.BB * 8 * 4 + nbytes(*res),
                pp2.BB * pp2.PUSH_ROUNDS * row_round + pushes * push)
    ms = cuda_ms(lambda: pp2.scalar_push_cuda(c_t), 200)
    queued = queued_ms(lambda: pp2.scalar_push_cuda(c_t), 200)
    out["probe_scalar_push"] = {
        "max_abs_err": err, "ms": ms,
        "plain_ms": cuda_ms(lambda: pp2.scalar_push_plain(c_t), 3),
        "bound_ms": bnd[0], "bound_by": bnd[1],
        "bound_int32_ms": bnd[2], "library_ms": None,
        "library_why": "none: serial pushes at data-dependent slots, row "
                       "by row",
        "queued_ms": queued, "us_per_iter": ms * 1e3 / pp2.PUSH_ROUNDS,
        "queued_us_per_iter": queued * 1e3 / pp2.PUSH_ROUNDS,
        "pushes": pushes, "max_row_pushes": int(res[2][:, 0].max()),
        "exact_inputs": list(inputs)}
    log(f"C21 probe_scalar_push: exact; {out['probe_scalar_push']}")

    # C22: scripts/probe_sem.py at K 1, 4 and 16 on its table.  Every
    # launch below is held to the plain version as far as the card's
    # timing allows, and out[0] (128 x the copies landed when it read) is
    # counted over them; a misaligned table is refused
    table = np.arange(psem.SEM_ROWS * psem.ROW_WORDS).reshape(
        psem.SEM_ROWS, psem.ROW_WORDS)
    tab_t, = common.tensors(dev, table)
    refused("C22 misaligned table", lambda: psem.sem_cuda(skewed(tab_t),
                                                          SEM_K))

    def check_sem(k, runs):
        """Hold each (out, stage) of `runs` at K=k to the plain version.
        Returns (max |err| of the stage and out[K:], which must be exact;
        max |out[:K] - plain| over the runs, which timing sets; {copies
        landed at out[0]: launches})."""
        want_out, want_stage = psem.sem_plain(tab_t, k)
        outs = torch.stack([o for o, _ in runs]).cpu()
        err = 0
        for _, stage in runs:
            err = max(err, exact(f"C22 probe_sem K={k} stage", stage,
                                 want_stage))
        err = max(err, exact(f"C22 probe_sem K={k} out[K:]", outs[:, k:],
                             want_out[k:].cpu().expand(len(runs), 2)))
        head = outs[:, :k].long()
        # copies landed at each read: out[w] = 128 (landed - w); never
        # fewer than the waits done, never more than K, never falling
        landed = head // psem.SEM_UNIT + torch.arange(k)
        if ((head % psem.SEM_UNIT != 0).any()
                or (landed < torch.arange(k)).any() or (landed > k).any()
                or (landed.diff(dim=1) < 0).any()):
            fail(f"C22 probe_sem K={k}: out outside its bounds: "
                 f"{outs[:4].tolist()} ...")
        diff = int((head - want_out[:k].cpu().long()).abs().max())
        seen = torch.unique(landed[:, 0], return_counts=True)
        return err, diff, {int(a): int(b) for a, b in zip(*seen)}

    checked = {}
    for k in (1, 16):
        checked[k] = check_sem(k, [psem.sem_cuda(tab_t, k)
                                   for _ in range(200)])
    runs, queued_runs = [], []
    ms = cuda_ms(lambda: runs.append(psem.sem_cuda(tab_t, SEM_K)), 200)
    queued = queued_ms(lambda: queued_runs.append(
        psem.sem_cuda(tab_t, SEM_K)), 200)
    checked[SEM_K] = check_sem(SEM_K, runs)
    checked_queued = check_sem(SEM_K, queued_runs)
    # K rows read; out and the 16-row stage written
    bnd = bound(SEM_K * ROW_BYTES + 4 * (SEM_K + 2)
                + psem.SEM_ROWS * ROW_BYTES, 0)
    out["probe_sem"] = {
        "max_abs_err": max(c[0] for c in (*checked.values(),
                                          checked_queued)),
        "max_abs_err_of": "the stage and out[K:] at K 1, 4 and 16; "
                          "out[:K] depends on timing (out_head_max_abs_diff)",
        "out_head_max_abs_diff": {str(k): c[1] for k, c in checked.items()},
        "ms": ms,
        "plain_ms": cuda_ms(lambda: psem.sem_plain(tab_t, SEM_K), 200),
        "bound_ms": bnd[0], "bound_by": bnd[1],
        "bound_int32_ms": bnd[2], "library_ms": None,
        "library_why": "none: no PyTorch call issues async copies and "
                       "reads how many have landed",
        "queued_ms": queued, "k": SEM_K,
        "out0_landed": {str(k): c[2] for k, c in checked.items()},
        "out0_landed_queued": checked_queued[2],
        "checked": "stage and out[K:] exact; out[w] = 128 (landed - w) "
                   "with the copies landed between w and K, never falling"}
    log(f"C22 probe_sem: within bounds; {out['probe_sem']}")
    return out


def once_ms(fn):
    """(device milliseconds of one call of fn() by CUDA events, with no
    warm-up, its result): for plain versions that take seconds a call."""
    import torch
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    r = fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1), r


def int32_mixed(rng, shape):
    """Seeded random int32 over the whole range, its first values within 8
    of INT32_MAX and of INT32_MIN, 0 and -1 (as many as fit)."""
    import numpy as np
    x = rng.randint(I32_MIN, I32_MAX + 1, shape, dtype=np.int64)
    edges = ([I32_MAX - d for d in range(8)] + [I32_MIN + d for d in range(8)]
             + [0, -1])
    flat = x.reshape(-1)
    flat[:min(len(flat), len(edges))] = edges[:len(flat)]
    return x


def ptxas_report(log_text, key_of):
    """{key: registers, static shared memory, stack frame and spill bytes}
    of the kernels in the build's ptxas report for which key_of(mangled
    name) is not None."""
    report, key = {}, None
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            key = key_of(ln.split("'")[1])
        elif key is not None and "bytes spill stores" in ln:
            stack, stores, loads = (int(part.split()[0])
                                    for part in ln.split(","))
            report.setdefault(key, {}).update(
                stack_bytes=stack, spill_store_bytes=stores,
                spill_load_bytes=loads)
        elif key is not None and "Used" in ln and "registers" in ln:
            entry = report.setdefault(key, {})
            entry["registers"] = int(ln.split("Used")[1].split()[0])
            if "bytes smem" in ln:
                entry["static_smem_bytes"] = int(
                    ln.split("bytes smem")[0].split(",")[-1].split()[0])
            key = None
    return report


def spill_ptxas(log_text, tag="probe_spill_kernelILi"):
    """The ptxas report of the instantiations of C23's witness, keyed by
    K (or of the kernel whose mangled name holds `tag`, keyed by its
    integer template argument)."""
    return ptxas_report(log_text, lambda name: int(
        name.split(tag)[1].split("E")[0]) if tag in name else None)


def spill_lane_ptxas(log_text):
    """The ptxas report of the instantiations of C23's lane form, keyed
    by M, its values a lane."""
    return spill_ptxas(log_text, "probe_spill_lane_kernelILi")


def kernel_ptxas(log_text, tag):
    """The ptxas report of the two instantiations of the kernel whose
    mangled name holds `tag`: "shared" (`<true>`, the state in shared
    memory) and "device" (`<false>`)."""
    return ptxas_report(log_text, lambda name: (
        "shared" if tag + "ILb1E" in name
        else "device" if tag + "ILb0E" in name else None))


def grid_witness_ptxas(log_text, tag):
    """The ptxas report of the two forms of C17, C18 or C34, whose kernels'
    mangled names hold `tag`: "grid" (`<tag>_grid_kernel`) and "witness"
    (`<tag>_kernel`)."""
    return ptxas_report(log_text, lambda name: (
        "grid" if tag + "_grid_kernel" in name
        else "witness" if tag + "_kernel" in name else None))


def ext_matrix(a, b):
    """bwasw's 5x5 score matrix at match a, mismatch -b (N scores -b)."""
    import numpy as np
    m = np.full((5, 5), -b, dtype=np.int64)
    for i in range(4):
        m[i, i] = a
    return m


def mutated(rng, seq, err):
    """seq with substitutions, insertions and deletions at rate err each."""
    import numpy as np
    out = []
    for c in seq:
        r = rng.random()
        if r < err:
            continue
        if r < 2 * err:
            out.append(int(rng.integers(0, 4)))
        out.append(int((c + rng.integers(1, 4)) % 4) if rng.random() < err
                   else int(c))
    return np.array(out or [int(seq[0])], dtype=np.uint8)


def extend_edges(rng, dev):
    """C6's edge launches: {label: (args, kw)} for `dp.extend_cuda`."""
    import numpy as np
    from nabwa_tpu_torch.ops import dp

    def rand(n, alph=4):
        return rng.integers(0, alph, int(n)).astype(np.uint8)

    def launch(jobs, g0s, bws, a=1, b=3, q=5, r=2):
        return (dp.pack_extend(jobs, g0s, bws, dev),
                dict(mat=ext_matrix(a, b), go=q, ge=r))

    cases = {}
    tgt = rand(1250)
    cases["single_bwasw_widest"] = launch([(tgt, mutated(rng, tgt[:969],
                                                         0.02))], [40], [50])
    tgt = rand(700)
    cases["single_whole_target"] = launch([(tgt, mutated(rng, tgt[:400],
                                                         0.03))], [30], [800])
    jobs = []
    for _ in range(9):
        tgt = rand(rng.integers(60, 500))
        jobs.append((tgt, mutated(rng, tgt[:int(rng.integers(20, len(tgt)))],
                                  0.04)))
    g0s = [int(g) for g in rng.integers(1, 40, len(jobs))]
    cases["wide_band"] = launch(jobs, g0s, [130, 200, 333, 129, 128, 127,
                                            300, 150, 257])
    cases["narrow_window"] = launch(jobs, g0s, [0, 1, 2, 3, 5, 8, 13, 15, 1])
    args, kw = launch(jobs, g0s, [50] * len(jobs))
    args["len2"][[1, 3]] = 0
    args["len2"][[2, 4, 6]] = 1
    cases["len2_0_1"] = (args, kw)
    jobs = []
    for _ in range(96):
        alph = int(rng.integers(2, 4))
        jobs.append((rand(rng.integers(2, 40), alph),
                     rand(rng.integers(1, 30), alph)))
    cases["tied_best"] = launch(jobs, [int(g) for g in rng.integers(
        1, 12, len(jobs))], [int(b) for b in rng.integers(1, 40, len(jobs))],
        2, 1, 2, 1)
    big = rand(30000)
    cases["device_state_L1_30000"] = launch(
        [(big, mutated(rng, big[:200], 0.02)), (big[:90], rand(60))],
        [25, 8], [50, 50])
    return cases


def global_edges(rng, dev):
    """C4's edge launches: {label: (args, kw)} for `dp.banded_global_cuda`."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.ops import dp
    from nabwa_tpu_torch.refmodel.stdaln_scalar import ALN_SM_MAQ
    # stdaln.c's aln_sm_blast: +1 / -3, N -2
    blast = np.full((5, 5), -3, dtype=np.int64)
    np.fill_diagonal(blast, 1)
    blast[4, :] = blast[:, 4] = -2

    def rand(n, alph=4):
        return rng.integers(0, alph, int(n)).astype(np.uint8)

    def pairs_of(n, lo, hi, err):
        out = []
        for _ in range(n):
            ref = rand(rng.integers(lo, hi))
            out.append((ref, mutated(rng, ref, err)))
        return out

    def launch(pairs, bws, mat, go, ge, gend):
        return (dp.pack_pairs(pairs, bws, dev),
                dict(mat=np.asarray(mat), go=go, ge=ge, gend=gend))

    cases = {}
    short = pairs_of(10, 3, 40, 0.05)
    cases["b2_eq_len2"] = launch(short, [40] * 10, ALN_SM_MAQ, 26, 9, 5)
    mid = pairs_of(20, 5, 90, 0.04)
    cases["sampe_bands_gap_end_-1"] = launch(
        mid, [1 + (i * 7) % 23 for i in range(20)], ALN_SM_MAQ, 26, 9, -1)
    wide = []
    for _ in range(6):
        ref = rand(rng.integers(150, 420))
        wide.append((ref, mutated(rng, ref[:int(rng.integers(100, len(ref)))],
                                  0.03)))
    cases["wide_rows"] = launch(wide, [300, 150, 200, 129, 256, 400],
                                blast, 5, 2, 2)
    cases["narrow_band"] = launch(wide, [1, 2, 3, 5, 8, 13], blast,
                                  5, 2, 2)
    args, kw = launch(mid[:10], [13] * 10, ALN_SM_MAQ, 26, 9, 5)
    args["len2"][[0, 4]] = 0
    args["len2"][[2, 5, 7]] = 1
    args["b2"] = torch.minimum(args["b2"], args["len2"])
    cases["len2_0_1"] = (args, kw)
    ties = []
    for period in (1, 2, 3):
        ref = np.tile(np.arange(period, dtype=np.uint8) % 4, 60)[:90]
        ties += [(ref, ref[:60].copy()), (ref[:50], ref[1:81].copy()),
                 (ref, np.roll(ref, 1)[:70].copy())]
    cases["ties"] = launch(ties, [10] * len(ties),
                           np.where(np.eye(5, dtype=bool), 1, -1), 1, 1, 1)
    args, kw = launch(mid, [13] * 20, blast, 5, 2, 2)
    for key, n in (("b1", args["len1"]), ("b2", args["len2"])):
        args[key] = torch.as_tensor(rng.integers(0, n.cpu().numpy() + 3),
                                    dtype=torch.int32, device=dev)
    cases["odd_bands"] = (args, kw)
    cases["go_negative"] = launch(mid[:8], [13] * 8, ALN_SM_MAQ, -3, 2, 1)
    big = rand(18000)
    cases["device_state_L1_18000"] = launch(
        [(big, mutated(rng, big[:100], 0.03)), (big[:80], rand(70))],
        [50, 50], blast, 5, 2, 2)
    return cases


def local_edges(rng, dev):
    """C5's edge launches: {label: (args, kw)} for `dp.local_fwd_cuda`, one
    launch in each form (the register form at K 2, 4, 8 and 16, the
    wide form with the row in shared and in device memory) and jobs with
    no positive cell, ties in one row and in two rows, and a job the E
    chain's gate decides."""
    import numpy as np
    from nabwa_tpu_torch.ops import dp
    from nabwa_tpu_torch.refmodel.stdaln_scalar import ALN_SM_MAQ

    def rand(n):
        return rng.integers(0, 4, int(n)).astype(np.uint8)

    def jobs_upto(width, n=12):
        out = []
        for t in range(n):
            ref = rand(width if t < 2 else rng.integers(1, width + 1))
            if t % 3 == 2:
                read = rng.integers(0, 5, int(rng.integers(1, 60)))
                out.append((ref, read.astype(np.uint8)))
                continue
            rl = int(rng.integers(1, min(len(ref), 120) + 1))
            start = int(rng.integers(0, len(ref) - rl + 1))
            out.append((ref, mutated(rng, ref[start:start + rl], 0.03)))
        return out

    def launch(jobs):
        return (dp.pack_local(jobs, dev),
                dict(mat=np.asarray(ALN_SM_MAQ), go=26, ge=9))

    cases = {f"L1_{w}": launch(jobs_upto(w))
             for w in (1, 33, 64, 65, 128, 200, 380, 600, 1024, 1025, 2000)}
    big = rand(30000)
    cases["device_state_L1_30000"] = launch(
        [(big, mutated(rng, big[20000:20100], 0.03)), (big[:900], rand(40))])
    x, y = rand(10), rand(10)
    gap, ns = np.full(30, 4, np.uint8), np.full(10, 4, np.uint8)
    cases["no_positive_and_ties"] = launch(
        [(np.zeros(90, np.uint8), np.ones(30, np.uint8)),
         (np.full(40, 4, np.uint8), rand(12)),
         (np.concatenate([x, gap, x]), x.copy()),
         (np.concatenate([x, gap, x, gap, x]), x.copy()),
         (np.concatenate([y, gap, x]), np.concatenate([x, ns, y]))])
    # a job whose answer the E chain's gate decides (h[j-1][i] == q + r,
    # e[j-1][i] > r) at stdaln.c's aln_sm_blast, +1 / -3, N -2, q 5, r 2
    blast = np.full((5, 5), -3, dtype=np.int64)
    np.fill_diagonal(blast, 1)
    blast[4, :] = blast[:, 4] = -2
    a = np.array([3, 1, 0, 2, 2, 0, 0, 3, 1, 0, 2, 1, 0, 3, 0, 2, 0, 1, 3,
                  0, 1, 0, 2, 3, 2, 1, 1, 1, 0], np.uint8)
    b = np.array([3, 1, 0, 2, 2, 0, 0, 3, 1, 0, 2, 1, 0, 3, 3, 2, 0, 2, 0,
                  1, 3, 0, 1, 0, 2, 3, 2, 1, 1], np.uint8)
    cases["e_gate_blast"] = (dp.pack_local([(a, b)], dev),
                             dict(mat=blast, go=5, ge=2))
    return cases


def check_local_edges(dev):
    """C5's edge launches (`local_edges`, numpy seed LOCAL_EDGE_SEED)
    against the plain version on the card, every output exact, each in
    the form its L1 picks (and the widest register-form launch and a wide
    one again with the row forced into device memory).  Returns {label:
    [B, L1, L2, form, K]}."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.ops import dp
    rng = np.random.default_rng(LOCAL_EDGE_SEED)
    checked = {}
    for label, (args, kw) in local_edges(rng, dev).items():
        want = dp.local_fwd_plain(**args, **kw)
        got = dp.local_fwd_cuda(**args, **kw)
        torch.cuda.synchronize()
        for k, (g, w) in enumerate(zip(got, want)):
            exact(f"C5 edge {label}, output {k}", g, w)
        L1 = int(args["s1"].shape[1] - 1)
        form, K = dp.local_form(L1)
        if label.startswith("device_state") != (form == "device"):
            fail(f"C5 edge {label}: its row lies in {form} memory")
        checked[label] = [int(args["s1"].shape[0]), L1,
                          int(args["s2"].shape[1] - 1), form, K]
        if label == "L1_2000":
            keep = dp.SMEM_STATE_BYTES
            dp.SMEM_STATE_BYTES = 0
            try:
                got = dp.local_fwd_cuda(**args, **kw)
                torch.cuda.synchronize()
            finally:
                dp.SMEM_STATE_BYTES = keep
            for k, (g, w) in enumerate(zip(got, want)):
                exact(f"C5 edge {label} in device memory, output {k}", g, w)
            checked[label + "_device"] = checked[label][:3] + ["device", K]
    forms = sorted({tuple(v[3:]) for v in checked.values()})
    log(f"C5 local_fwd: {len(checked)} edge launches exact, forms {forms} "
        f"({checked})")
    want = [("device", 16), ("registers", 2), ("registers", 4),
            ("registers", 8), ("registers", 16),
            ("shared", 16)]
    if forms != want:
        fail(f"C5 edge launches took the forms {forms}, not {want}")
    return checked, local_form_ms(dev)


def local_form_ms(dev):
    """C5's register forms of K 2, 4 and 8 against K=16, the form their
    launches would take without them: the edge launches of those K
    (LOCAL_EDGE_SEED) again with their windows padded to 512 columns.  The
    jobs and their answers are the same (columns past a job's len1 are
    never computed); each launch exact and timed over 20.  Returns {label:
    {"own": [form, K, ms], "padded": [form, K, ms]}}."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.ops import dp
    rng = np.random.default_rng(LOCAL_EDGE_SEED)
    out = {}
    for label, (args, kw) in local_edges(rng, dev).items():
        L1 = int(args["s1"].shape[1] - 1)
        form, K = dp.local_form(L1)
        if form != "registers" or K == 16:
            continue
        s1 = args["s1"]
        pad = torch.full((s1.shape[0], 512 - L1), 4, dtype=s1.dtype,
                         device=s1.device)
        wide = dict(args, s1=torch.cat([s1, pad], 1).contiguous())
        want = dp.local_fwd_plain(**args, **kw)
        row = {}
        for name, a in (("own", args), ("padded", wide)):
            got = dp.local_fwd_cuda(**a, **kw)
            torch.cuda.synchronize()
            for k, (g, w) in enumerate(zip(got, want)):
                exact(f"C5 {label} {name}, output {k}", g, w)
            ms = cuda_ms(lambda: dp.local_fwd_cuda(**a, **kw), 20)
            row[name] = [*dp.local_form(int(a["s1"].shape[1] - 1)), ms]
        out[label] = row
    log(f"C5 local_fwd, K 2, 4 and 8 against K=16 (the same jobs, windows "
        f"padded to 512 columns): {out}")
    return out


def local_launch_forms(calls, times):
    """Each recorded C5 launch's jobs, L1, L2, (form, K) and ms (`times`,
    as `check_launches` replayed it)."""
    from nabwa_tpu_torch.ops import dp
    out = []
    for (args, _), ms in zip(calls, times):
        L1 = int(args[0].shape[1] - 1)
        out.append([int(args[0].shape[0]), L1, int(args[2].shape[1] - 1),
                    *dp.local_form(L1), ms])
    return out


def time_smallest_local(calls):
    """bam2bam's smallest recorded C5 launch (fewest jobs) timed over 20:
    a few hundred jobs hold one warp a job on fewer than 132 SMs' worth of
    blocks, so the launch lasts one warp's chain of L2 rows.  Returns
    {"shape": [jobs, L1, L2], "ms", "us_per_row"}."""
    from nabwa_tpu_torch.ops import dp
    args, kw = min(calls, key=lambda c: c[0][0].shape[0])
    ms = cuda_ms(lambda: dp.local_fwd_cuda(*args, **kw), 20)
    shape = [int(args[0].shape[0]), int(args[0].shape[1] - 1),
             int(args[2].shape[1] - 1)]
    out = {"shape": shape, "ms": ms, "us_per_row": ms * 1e3 / shape[2]}
    log(f"C5 local_fwd, bam2bam's smallest launch alone: {out}")
    return out


def form_ptxas(log_text):
    """The ptxas report of C2's kernel and C3's and C5's instantiations:
    {"cal_width": {"G8"}, "sa_lookup": {"pow2", "magic"}, "local_fwd":
    {"K2" ... "K16", "shared", "device"}}; C2 has one kernel, 8 lanes a
    row, C3 one a thread a row, by interval test."""
    def c2(name):
        return "G8" if "cal_width_group_kernel" in name else None

    def c3(name):
        if "sa_thread_kernel" not in name:
            return None
        return "pow2" if "IntvPow2" in name else "magic"

    def c5(name):
        tag = "local_fwd_warp_kernelILi"
        if tag in name:
            return f"K{name.split(tag)[1].split('E')[0]}"
        return ("shared" if "local_fwd_wide_kernelILb1E" in name
                else "device" if "local_fwd_wide_kernelILb0E" in name
                else None)

    return {"cal_width": ptxas_report(log_text, c2),
            "sa_lookup": ptxas_report(log_text, c3),
            "local_fwd": ptxas_report(log_text, c5)}


def dfs_edge_data():
    """C1's edge cases, shared with tests/test_torch_dfs.py: (genome FASTA
    bytes, {label: (reads as FASTQ bytes, rows whose length is set to 0,
    GapOpt fields, DFS statics that differ from DFS_EDGE_STATICS)}).

    The genome (20 kbp, numpy seed DFS_EDGE_SEED) holds a 400 bp segment
    twice (the copies differ in one base), homopolymer runs of 6 and
    dinucleotide repeats of 6 units.  The 60 bp "gapped" reads carry a
    1-base deletion or insertion inside a run or a 2-base deletion inside a
    repeat
    (equal-scoring gap placements, whose hits repeat an interval: the
    tandem-repeat test), half reverse complemented; three lie in the
    repeated segment (one on both copies, one on the base that differs:
    two hits, and one without that base: a deletion of a different base on
    each copy, two equal hits whose order the candidates' order sets), one
    has two Ns, one is all N and the last is given length 0.  On them: the
    defaults, a slot pool of 2, a hit list of 1, one iteration, max_entries
    3, nonstop, loggap, no gap extension mode (-e), a 20 bp seed.  A 26 bp
    random read at max_diff 8 runs the 16-bit sequence counter out before
    its 52,192-slot pool fills.  A 7,150 bp read among eight gapped reads
    (no seed) makes L 7,168: one read's state is more than a block's shared
    memory, so the kernel keeps it in device memory."""
    import numpy as np
    rng = np.random.default_rng(DFS_EDGE_SEED)
    g = rng.integers(0, 4, 20000).astype(np.uint8)
    g[12000:12400] = g[2000:2400]
    # the copies differ in one base, one of the two an A (the first
    # deletion candidate)
    g[12130] = 1 if g[2130] == 0 else 0
    runs, reps = [], []
    for k in range(4):
        runs.append((4000 + 500 * k, k))
        g[4000 + 500 * k:4006 + 500 * k] = k
        reps.append(8000 + 500 * k)
        g[8000 + 500 * k:8012 + 500 * k] = np.tile([k, (k + 1) % 4], 6)
    letters = np.frombuffer(b"ACGTN", dtype=np.uint8)
    text = letters[g].tobytes()
    fasta = b">edge\n" + b"".join(text[i:i + 70] + b"\n"
                                   for i in range(0, len(text), 70))

    def rc(codes):
        return (3 - codes[::-1]).astype(np.uint8)

    reads = []
    for j, (at, k) in enumerate(runs):
        s = at - 27
        dele = np.concatenate([g[s:at + 2], g[at + 3:s + 61]])
        ins = np.concatenate([g[s:at + 3], [k], g[at + 3:s + 59]])
        reads += [dele, rc(ins)] if j % 2 else [rc(dele), ins]
    for j, at in enumerate(reps[:3]):
        s = at - 25
        dele = np.concatenate([g[s:at + 4], g[at + 6:s + 62]])
        reads.append(rc(dele) if j % 2 else dele)
    reads += [g[2100:2160], rc(g[2200:2260]),
              np.concatenate([g[2100:2130], g[2131:2161]])]
    two_n = g[6000:6060].copy()
    two_n[[20, 41]] = 4
    reads += [two_n, np.full(60, 4, dtype=np.uint8), g[7000:7060]]

    def fastq(rs):
        return b"".join(b"@e%d\n%s\n+\n%s\n" % (
            i, letters[r].tobytes(), b"I" * len(r))
            for i, r in enumerate(rs))

    gapped = fastq(reads)
    zero = (len(reads) - 1,)
    counter = fastq([np.random.default_rng(1826).integers(
        0, 4, (16, 26)).astype(np.uint8)[12]])
    wide = fastq([g[100:7250]] + reads[:8])
    gape, nonstop, loggap = 0x01, 0x10, 0x04
    mode = gape | 0x02
    return fasta, {
        "defaults": (gapped, zero, {}, {}),
        "pool_S2": (gapped, zero, {}, {"stack_cap": 2}),
        "hits_H1": (gapped, zero, {}, {"hits_cap": 1}),
        "iters_1": (gapped, zero, {}, {"max_iters": 1}),
        "max_entries_3": (gapped, zero, {"max_entries": 3}, {}),
        "nonstop": (gapped, zero, {"mode": mode | nonstop}, {}),
        "loggap": (gapped, zero, {"mode": mode | loggap}, {}),
        "no_gape": (gapped, zero, {"mode": mode & ~gape, "max_gape": 2},
                    {}),
        "seed_20": (gapped, zero, {"seed_len": 20, "max_seed_diff": 1}, {}),
        "counter_end": (counter, (), {"fnr": -1.0, "max_diff": 8},
                        {"stack_cap": 52192, "max_iters": 100000}),
        "wide_device": (wide, (), {"fnr": -1.0, "max_diff": 2,
                                   "seed_len": 0x7FFFFFFF}, {}),
    }


def check_dp_edges(dev):
    """C4's and C6's edge launches against their plain versions on the
    card, every output exact.  Returns {kernel: {label: shape}}."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.ops import dp
    rng = np.random.default_rng(DP_EDGE_SEED)
    checked = {}
    for name, cases, kernel, plain, wide in (
            ("extend", extend_edges(rng, dev), dp.extend_cuda,
             dp.extend_plain, dp.extend_smem_bytes),
            ("banded_global", global_edges(rng, dev), dp.banded_global_cuda,
             dp.banded_global_plain, dp.global_smem_bytes)):
        checked[name] = {}
        for label, (args, kw) in cases.items():
            got = as_tuple(kernel(**args, **kw))
            want = as_tuple(plain(**args, **kw))
            torch.cuda.synchronize()
            for k, (g, w) in enumerate(zip(got, want)):
                exact(f"{name} edge {label}, output {k}", g, w)
            L1 = args["s1"].shape[1] - (2 if name == "extend" else 1)
            in_shared = wide(L1) <= dp.SMEM_STATE_BYTES
            if label.startswith("device_state") == in_shared:
                fail(f"{name} edge {label}: state in "
                     f"{'shared' if in_shared else 'device'} memory")
            checked[name][label] = [int(args["s1"].shape[0]), L1,
                                    int(args["s2"].shape[1] - 1)]
        log(f"{name}: {len(cases)} edge launches exact "
            f"({checked[name]})")
    return checked


def forced_device_state(label, kernel, args, kw, want):
    """A recorded launch again with the wrapper told that no state fits in
    shared memory: the kernel keeps it in device memory; every output must
    equal `want` (the plain version's on the same launch)."""
    import torch
    from nabwa_tpu_torch.ops import dp
    keep = dp.SMEM_STATE_BYTES
    dp.SMEM_STATE_BYTES = 0
    try:
        got = as_tuple(kernel(*args, **kw))
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: kernel(*args, **kw), 3)
    finally:
        dp.SMEM_STATE_BYTES = keep
    for k, (g, w) in enumerate(zip(got, want)):
        exact(f"{label} with its state in device memory, output {k}", g, w)
    log(f"{label}: exact with its state in device memory, {ms:.4f} ms")
    return ms


def check_chains(dev, split):
    """Phase 18, kernels C23-C30 against their plain versions on the card,
    exact, at the scripts' shapes and inputs and at seeded random and int32
    edge inputs; C23 also over every K it is built for, C27-C29 at edge
    indices (`check_copies`, given `split`).  Returns {kernel name: fields
    of its kernels-line entry but `launches`}."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.ops import _build
    from nabwa_tpu_torch.probes import common
    from nabwa_tpu_torch.probes import probe_colops as pc
    from nabwa_tpu_torch.probes import probe_pallas3 as p3
    from nabwa_tpu_torch.probes import probe_spill as ps
    rng = np.random.RandomState(PROBE_SEED + 1)
    out = {}
    why = "none: no single PyTorch call computes a chain of dependent steps"

    # C23: scripts/probe_spill.py at its defaults (K=24, T=2000) on its four
    # shapes in both forms, the lane form (`spill_cuda`, the probe's route)
    # and the witness (`spill_witness_cuda`), each exact on the script's
    # zeros and on random and edge inputs (the lane form also at L 2, 4 and
    # 8), queued in turns (witness, lane, lane, witness) and at each L;
    # then every K the witness is built for at [64, 128] in both forms,
    # with ptxas's registers and spills: the witness's (the run fails
    # unless some K spills) and the lane form's (the run fails if any of
    # its instantiations spills or takes a stack frame)
    k, t = ps.DEFAULT_K, ps.DEFAULT_T
    forms = {"lane": ps.spill_cuda, "witness": ps.spill_witness_cuda}
    err, shapes = 0, {}
    for shape in ps.SHAPES:
        for name, x in (("script", np.zeros(shape)),
                        ("mixed", int32_mixed(rng, shape))):
            x_t, = common.tensors(dev, x)
            want = ps.spill_plain(x_t, k, t)
            for form, fn in forms.items():
                err = max(err, exact(f"C23 probe_spill {form} {shape} {name}",
                                     fn(x_t, k, t), want))
            for n in SPILL_LANES:
                err = max(err, exact(f"C23 probe_spill L={n} {shape} {name}",
                                     ps.spill_cuda(x_t, k, t, n), want))
        x_t, = common.tensors(dev, np.zeros(shape))
        sh = {"lanes": ps.default_lanes(k, x_t.numel())}
        queued = {form: [] for form in forms}
        for form in ("witness", "lane", "lane", "witness"):
            queued[form].append(queued_ms(
                lambda: forms[form](x_t, k, t), 20))
        for form, fn in forms.items():
            pre = "" if form == "lane" else "witness_"
            ms = cuda_ms(lambda: fn(x_t, k, t), 20)
            q = sum(queued[form]) / 2
            sh.update({f"{pre}ms": ms, f"{pre}queued_ms": q,
                       f"{pre}queued_ms_turns": queued[form],
                       f"{pre}us_per_iter": ms * 1e3 / t,
                       f"{pre}queued_us_per_iter": q * 1e3 / t})
        sh["queued_ms_by_lanes"] = {
            str(n): queued_ms(lambda: ps.spill_cuda(x_t, k, t, n), 20)
            for n in SPILL_LANES}
        shapes[str(shape)] = sh
        log(f"C23 probe_spill {shape}: both forms exact; {sh}")
    report = spill_ptxas(_build.build_log)
    missing = [kk for kk in ps.SPILL_KS if "registers" not in
               report.get(kk, {})]
    if missing:
        fail(f"C23: no ptxas report for K {missing}")
    lane_report = spill_lane_ptxas(_build.build_log)
    missing = [m for m in ps.SPILL_MS if "registers" not in
               lane_report.get(m, {})]
    if missing:
        fail(f"C23's lane form: no ptxas report for M {missing}")
    heavy = {m: r for m, r in lane_report.items()
             if r["stack_bytes"] or r["spill_store_bytes"]
             or r["spill_load_bytes"]}
    if heavy:
        fail(f"C23's lane form spills or takes a stack frame: {heavy}")
    sweep = {}
    x_t, = common.tensors(dev, int32_mixed(rng, SPILL_SWEEP_SHAPE))
    for kk in ps.SPILL_KS:
        want = ps.spill_plain(x_t, kk, t)
        e = max(exact(f"C23 probe_spill {form} K={kk}", fn(x_t, kk, t), want)
                for form, fn in forms.items())
        err = max(err, e)
        sw = {"lanes": ps.default_lanes(kk, x_t.numel())}
        for form, fn in forms.items():
            pre = "" if form == "lane" else "witness_"
            queued = queued_ms(lambda: fn(x_t, kk, t), 10)
            sw.update({f"{pre}ms": cuda_ms(lambda: fn(x_t, kk, t), 10),
                       f"{pre}queued_ms": queued,
                       f"{pre}queued_us_per_round": queued * 1e3 / t})
        sweep[str(kk)] = dict(
            sw, bound_int32_ms=bound(2 * nbytes(x_t),
                                     OPS_SPILL * t * kk * x_t.numel())[2],
            max_abs_err=e, **report[kk])
        log(f"C23 K={kk}: {sweep[str(kk)]}")
    spilled = [kk for kk in ps.SPILL_KS if report[kk]["spill_store_bytes"]]
    if not spilled:
        fail("C23: no K spills; the set does not reach past the register "
             "cap")
    x_t, = common.tensors(dev, np.zeros(SPILL_SWEEP_SHAPE))
    bnd = bound(2 * nbytes(x_t), OPS_SPILL * t * k * x_t.numel())
    head = shapes[str(SPILL_SWEEP_SHAPE)]
    out["probe_spill"] = {
        "max_abs_err": err, "ms": head["ms"],
        "plain_ms": cuda_ms(lambda: ps.spill_plain(x_t, k, t), 2),
        "bound_ms": bnd[0], "bound_by": bnd[1],
        "bound_int32_ms": bnd[2], "library_ms": None,
        "library_why": why, "queued_ms": head["queued_ms"],
        "lanes": head["lanes"], "witness_ms": head["witness_ms"],
        "witness_queued_ms": head["witness_queued_ms"],
        "shape": list(SPILL_SWEEP_SHAPE), "k": k, "t": t, "shapes": shapes,
        "k_sweep": sweep, "first_k_spilling": spilled[0],
        "lane_ptxas": {str(m): r for m, r in sorted(lane_report.items())},
        "witness_launches": ps.launches_witness,
        "ptxas_from_cache": _build.build_seconds is None}
    log(f"C23 probe_spill: both forms exact; first spill at K={spilled[0]}; "
        f"{ {n: v for n, v in out['probe_spill'].items() if n != 'k_sweep'} }")

    # C24: scripts/probe_colops.py at its defaults (T=2000, K=64) on its
    # five shapes; the plain version takes ~0.9M small launches a call, so
    # it runs once, timed, on every checked input flattened into one tensor
    # (the steps are elementwise; their launches, not the elements, take
    # its time)
    t, k = pc.DEFAULT_T, pc.DEFAULT_K
    shapes, kern, rest = {}, [], []
    for shape in pc.SHAPES:
        for name, x in (("script", np.zeros(shape)),
                        ("mixed", int32_mixed(rng, shape))):
            x_t, = common.tensors(dev, x)
            kern.append(pc.colops_cuda(x_t, t, k).reshape(-1))
            rest.append(x_t.reshape(-1))
        x_t, = common.tensors(dev, np.zeros(shape))
        ms = cuda_ms(lambda: pc.colops_cuda(x_t, t, k), 10)
        queued = queued_ms(lambda: pc.colops_cuda(x_t, t, k), 10)
        shapes[str(shape)] = {"ms": ms, "queued_ms": queued,
                              "queued_ns_per_op": queued * 1e6 / (t * k * 3)}
    flat = torch.cat(rest)
    plain_ms, want = once_ms(lambda: pc.colops_plain(flat, t, k))
    err = exact("C24 probe_colops, every shape's inputs", torch.cat(kern),
                want)
    # the K loop is unrolled by 4: every remainder of K mod 4, at T=3
    x_t, = common.tensors(dev, int32_mixed(rng, (8, 128)))
    for kk in (1, 2, 3, 5, 6, 7):
        err = max(err, exact(f"C24 probe_colops (8, 128) K={kk} T=3",
                             pc.colops_cuda(x_t, 3, kk),
                             pc.colops_plain(x_t, 3, kk)))
    x_t, = common.tensors(dev, np.zeros(SPILL_SWEEP_SHAPE))
    bnd = bound(2 * nbytes(x_t), OPS_COLOPS * t * k * x_t.numel())
    q = {n: v["queued_ms"] for n, v in shapes.items()}
    out["probe_colops"] = {
        "max_abs_err": err, "ms": shapes[str(SPILL_SWEEP_SHAPE)]["ms"],
        "plain_ms": plain_ms, "plain_calls_timed": 1,
        "plain_elements": flat.numel(),
        "bound_ms": bnd[0], "bound_by": bnd[1],
        "bound_int32_ms": bnd[2], "library_ms": None,
        "library_why": why,
        "queued_ms": shapes[str(SPILL_SWEEP_SHAPE)]["queued_ms"],
        "shape": list(SPILL_SWEEP_SHAPE), "t": t, "k": k, "shapes": shapes,
        "widest_over_narrowest": q["(64, 256)"] / q["(64, 1)"]}
    log(f"C24 probe_colops: exact; {out['probe_colops']}")

    # C25: probe 7's 200 chained steps at its four shapes, on the script's
    # values and on random and edge inputs
    err, shapes = 0, {}
    for shape in p3.P7_SHAPES:
        for name, x in (("script", rng.randint(0, 99, shape)),
                        ("mixed", int32_mixed(rng, shape))):
            x_t, = common.tensors(dev, x)
            err = max(err, exact(f"C25 probe_p7 {shape} {name}",
                                 p3.p7_cuda(x_t), p3.p7_plain(x_t)))
        x_t, = common.tensors(dev, rng.randint(0, 99, shape))
        shapes[str(shape)] = {
            "ms": cuda_ms(lambda: p3.p7_cuda(x_t), 200),
            "queued_ms": queued_ms(lambda: p3.p7_cuda(x_t), 200)}
    big = str(p3.P7_SHAPES[-1])
    bnd = bound(2 * nbytes(x_t), OPS_P7 * p3.P7_STEPS * x_t.numel())
    out["probe_p7"] = {
        "max_abs_err": err, "ms": shapes[big]["ms"],
        "plain_ms": cuda_ms(lambda: p3.p7_plain(x_t), 3),
        "bound_ms": bnd[0], "bound_by": bnd[1],
        "bound_int32_ms": bnd[2], "library_ms": None,
        "library_why": why, "queued_ms": shapes[big]["queued_ms"],
        "shape": list(p3.P7_SHAPES[-1]), "shapes": shapes}
    log(f"C25 probe_p7: exact; {out['probe_p7']}")

    # C26: probe 8's 30 column-broadcast steps on [256, 128], on the
    # script's values, then a near both int32 ends, negative (v - a wraps)
    # and equal to plane values (ties), the plane over all of int32
    a = rng.randint(1, 99, (p3.P8_ROWS, 1))
    b = rng.randint(0, 99, (p3.P8_ROWS, p3.P8_COLS))
    edge_a = int32_mixed(rng, (p3.P8_ROWS, 1))
    edge_b = int32_mixed(rng, (p3.P8_ROWS, p3.P8_COLS))
    edge_b[:, 16:20] = edge_a
    err = 0
    for name, (aa, bb) in (("script", (a, b)), ("edges", (edge_a, edge_b))):
        a_t, b_t = common.tensors(dev, aa, bb)
        err = max(err, exact(f"C26 probe_p8 {name}", p3.p8_cuda(a_t, b_t),
                             p3.p8_plain(a_t, b_t)))
    a_t, b_t = common.tensors(dev, a, b)
    bnd = bound(nbytes(a_t) + 2 * nbytes(b_t),
                OPS_P8 * p3.P8_STEPS * b_t.numel())
    out["probe_p8"] = {
        "max_abs_err": err, "ms": cuda_ms(lambda: p3.p8_cuda(a_t, b_t), 200),
        "plain_ms": cuda_ms(lambda: p3.p8_plain(a_t, b_t), 20),
        "bound_ms": bnd[0], "bound_by": bnd[1],
        "bound_int32_ms": bnd[2], "library_ms": None,
        "library_why": why,
        "queued_ms": queued_ms(lambda: p3.p8_cuda(a_t, b_t), 200)}
    log(f"C26 probe_p8: exact; {out['probe_p8']}")
    out.update(check_copies(dev, rng, split))
    return out


def check_copies(dev, rng, split):
    """Phase 18, kernels C27-C30 (probes 1, 1b, 3 and 4 of
    scripts/probe_pallas3.py) against their plain versions on the card,
    exact, at the script's shapes: its inputs, then int32 tables at the
    indices of `index_cases` (C29 also a permutation of each column, C30
    int32 edges); out-of-range and misaligned inputs refused, and for
    C27, C28 and C29 also int64, non-contiguous and transposed inputs and
    (where the machine has a second card) an input on another device, none
    of them launched.  C27, C28 and C29 carry `launch_times` and their
    parts of `split` (`launch_split`), C27 and C28 `queued_ms` at 1, 16
    and 256 row pairs.  Returns {kernel name: fields of its kernels-line
    entry but `launches`}."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.probes import common
    from nabwa_tpu_torch.probes import probe_pallas3 as p3
    out = {}
    nrow, cols = p3.P1_TABLE
    table = rng.randint(0, 99, p3.P1_TABLE)
    edge_t = int32_mixed(rng, p3.P1_TABLE)

    # C27: probe 1, out rows k and k + 256 from lanes 0 and 1 of index row
    # k; the script's table for its indices, an int32 table for the rest
    err, cases = 0, index_cases(rng, nrow, (p3.P1_ROUNDS, cols))
    for name, idx in cases.items():
        i_t, t_t = common.tensors(dev, idx, table if name == "script"
                                  else edge_t)
        err = max(err, exact(f"C27 probe_p1 {name}", p3.p1(i_t, t_t),
                             p3.p1_plain(i_t, t_t)))
    i_t, t_t = common.tensors(dev, cases["script"], table)
    for col, bad in ((0, -1), (1, nrow)):
        wrong = i_t.clone()
        wrong[3, col] = bad
        refused(f"C27 index {bad} in lane {col}", lambda: p3.p1(wrong, t_t))
    before = p3.launches_p1
    refused("C27 misaligned table", lambda: p3.p1(i_t, skewed(t_t)))
    refused("C27 misaligned indices", lambda: p3.p1(skewed(i_t), t_t))
    refused("C27 int64 indices", lambda: p3.p1(i_t.long(), t_t))
    refused("C27 transposed indices",
            lambda: p3.p1(i_t.t().contiguous().t(), t_t))
    refused("C27 transposed table",
            lambda: p3.p1(i_t, t_t.t().contiguous().t()))
    refused("C27 one lane", lambda: p3.p1(i_t[:, :1].contiguous(), t_t))
    other = other_device(dev)
    if other is not None:
        refused(f"C27 table on {other}", lambda: p3.p1(i_t, t_t.to(other)))
    if p3.launches_p1 != before:
        fail("C27 launched on an input its wrapper refused")
    # queued at 1, 16 and 256 rounds (row pairs), as C28 below
    by_rows = {}
    for k in C28_ROW_PAIRS:
        ik = i_t[:k]
        by_rows[k] = queued_ms(lambda: p3.p1_cuda(ik, t_t), 200)
    flat = i_t[:, :2].t().reshape(-1).contiguous()
    n_rows = distinct_rows(flat)
    # bytes: each distinct row read once, one 32 B sector of index words a
    # round (lanes 0 and 1 share it), out written; Work 0, no arithmetic
    # beyond the addresses
    bnd = bound(ROW_BYTES * (n_rows + flat.numel()) + 32 * p3.P1_ROUNDS,
                0)
    out["probe_p1"] = {
        "max_abs_err": err,
        **launch_times(lambda: p3.p1_cuda(i_t, t_t),
                       lambda: torch.index_select(t_t, 0, flat)),
        "plain_ms": cuda_ms(lambda: p3.p1_plain(i_t, t_t), 3),
        "bound_ms": bnd[0], "bound_by": bnd[1], "bound_int32_ms": bnd[2],
        "library_call": "torch.index_select(t, 0, i[:, :2].t().reshape(-1))"
                        ", the index made once beforehand",
        "rows": flat.numel(), "distinct_rows": n_rows,
        "exact_inputs": list(cases), "queued_ms_by_row_pairs": by_rows,
        "other_device_refused": other is not None,
        "host_split": {"helpers": split["helpers"],
                       "steps": split["probe_p1"], "calls": split["calls"]}}
    log(f"C27 probe_p1: exact; {out['probe_p1']}")

    # C28: probe 1b, the same copies with the indices in two columns
    err = 0
    cases = index_cases(rng, nrow, (p3.P1_ROUNDS, 1))
    j_cases = index_cases(rng, nrow, (p3.P1_ROUNDS, 1))
    for name, idx in cases.items():
        i_t, j_t, t_t = common.tensors(dev, idx, j_cases[name][::-1],
                                       table if name == "script" else edge_t)
        err = max(err, exact(f"C28 probe_p1b {name}", p3.p1b(i_t, j_t, t_t),
                             p3.p1b_plain(i_t, j_t, t_t)))
    i_t, j_t, t_t = common.tensors(dev, cases["script"], j_cases["script"],
                                   table)
    before = p3.launches_p1b
    wrong = j_t.clone()
    wrong[7, 0] = nrow
    refused("C28 index out of range", lambda: p3.p1b(i_t, wrong, t_t))
    refused("C28 misaligned table", lambda: p3.p1b(i_t, j_t, skewed(t_t)))
    refused("C28 misaligned index", lambda: p3.p1b(i_t, skewed(j_t), t_t))
    refused("C28 int64 index", lambda: p3.p1b(i_t, j_t.long(), t_t))
    wide = torch.cat((i_t, j_t), 1)
    refused("C28 non-contiguous index (a column of [n, 2])",
            lambda: p3.p1b(i_t, wide[:, 1:], t_t))
    refused("C28 transposed index ([1, n])",
            lambda: p3.p1b(i_t.t(), j_t, t_t))
    refused("C28 transposed table",
            lambda: p3.p1b(i_t, j_t, t_t.t().contiguous().t()))
    if other is not None:
        refused(f"C28 index on {other}",
                lambda: p3.p1b(i_t, j_t.to(other), t_t))
    if p3.launches_p1b != before:
        fail("C28 launched on an input its wrapper refused")
    # C28 taken apart on the card: queued at 1, 16 and 256 row pairs of
    # one table, so the chain of a launch, an index load and the row it
    # names shows beside the bytes
    by_rows = {}
    for k in C28_ROW_PAIRS:
        ik, jk = i_t[:k], j_t[:k]
        by_rows[k] = queued_ms(lambda: p3.p1b_cuda(ik, jk, t_t), 200)
    flat = torch.cat((i_t[:, 0], j_t[:, 0]))
    n_rows = distinct_rows(flat)
    # bytes: each distinct row read once, the index words, out; Work 0
    bnd = bound(ROW_BYTES * (n_rows + flat.numel()) + nbytes(flat), 0)
    out["probe_p1b"] = {
        "max_abs_err": err,
        **launch_times(lambda: p3.p1b_cuda(i_t, j_t, t_t),
                       lambda: torch.index_select(t_t, 0, flat)),
        "plain_ms": cuda_ms(lambda: p3.p1b_plain(i_t, j_t, t_t), 3),
        "bound_ms": bnd[0], "bound_by": bnd[1], "bound_int32_ms": bnd[2],
        "library_call": "torch.index_select(t, 0, torch.cat((i[:, 0], "
                        "j[:, 0]))), the index made once beforehand",
        "rows": flat.numel(), "distinct_rows": n_rows,
        "exact_inputs": list(cases), "queued_ms_by_row_pairs": by_rows,
        "other_device_refused": other is not None,
        "host_split": {"helpers": split["helpers"],
                       "steps": split["probe_p1b"], "calls": split["calls"]}}
    log(f"C28 probe_p1b: exact; {out['probe_p1b']}")

    # C29: probe 3, out[r, c] = x[i[r, c], c]; x over int32 but for the
    # script's input, and a permutation of each column of a [128, 128] i
    rows, width = p3.P3_X
    cases = index_cases(rng, rows, p3.P3_I)
    cases["perm"] = np.stack([rng.permutation(rows) for _ in range(width)],
                             1)
    x = rng.randint(0, 99, p3.P3_X)
    edge_x = int32_mixed(rng, p3.P3_X)
    err = 0
    for name, idx in cases.items():
        x_t, i_t = common.tensors(dev, x if name == "script" else edge_x,
                                  idx)
        err = max(err, exact(f"C29 probe_p3 {name}", p3.p3(x_t, i_t),
                             p3.p3_plain(x_t, i_t)))
    x_t, i_t = common.tensors(dev, x, cases["script"])
    before = p3.launches_p3
    for bad in (-1, rows):
        wrong = i_t.clone()
        wrong[2, 9] = bad
        refused(f"C29 index {bad}", lambda: p3.p3(x_t, wrong))
    refused("C29 misaligned x", lambda: p3.p3(skewed(x_t), i_t))
    refused("C29 misaligned index", lambda: p3.p3(x_t, skewed(i_t)))
    refused("C29 int64 index", lambda: p3.p3(x_t, i_t.long()))
    refused("C29 transposed index",
            lambda: p3.p3(x_t, i_t.t().contiguous().t()))
    refused("C29 transposed x", lambda: p3.p3(x_t.t(), i_t))
    if other is not None:
        refused(f"C29 index on {other}", lambda: p3.p3(x_t, i_t.to(other)))
    if p3.launches_p3 != before:
        fail("C29 launched on an input its wrapper refused")
    i_long = i_t.long()
    cells = int(torch.unique(i_long * width + torch.arange(
        width, device=dev)).numel())
    # bytes: each distinct gathered word read once, i, out; Work 0
    bnd = bound(4 * cells + 2 * nbytes(i_t), 0)
    out["probe_p3"] = {
        "max_abs_err": err,
        **launch_times(lambda: p3.p3_cuda(x_t, i_t),
                       lambda: torch.gather(x_t, 0, i_long)),
        "plain_ms": cuda_ms(lambda: p3.p3_plain(x_t, i_t), 200),
        "bound_ms": bnd[0], "bound_by": bnd[1], "bound_int32_ms": bnd[2],
        "library_call": "torch.gather(x, 0, i.long()), the int64 index "
                        "made once beforehand",
        "distinct_words": cells, "exact_inputs": list(cases),
        "other_device_refused": other is not None,
        "host_split": {"helpers": split["helpers"],
                       "steps": split["probe_p3"], "calls": split["calls"]}}
    log(f"C29 probe_p3: exact; {out['probe_p3']}")

    # C30: probe 4, x[:, :16].reshape(64, 128), on the script's values and
    # over int32 with the edges in every row's first 16 words
    x = rng.randint(0, 99, p3.P4_X)
    edge_x = int32_mixed(rng, p3.P4_X)
    edge_x[:, :16] = int32_mixed(rng, (1, 16))
    err = 0
    for name, xs in (("script", x), ("edges", edge_x)):
        x_t, = common.tensors(dev, xs)
        err = max(err, exact(f"C30 probe_p4 {name}", p3.p4(x_t),
                             p3.p4_plain(x_t)))
    x_t, = common.tensors(dev, x)
    refused("C30 misaligned x", lambda: p3.p4(skewed(x_t)))
    res = p3.p4_plain(x_t)
    # bytes: x[:, :16] read once, out written once; Work 0
    bnd = bound(2 * nbytes(res), 0)
    out["probe_p4"] = {
        "max_abs_err": err, "ms": cuda_ms(lambda: p3.p4_cuda(x_t), 200),
        "plain_ms": cuda_ms(lambda: p3.p4_plain(x_t), 200),
        "bound_ms": bnd[0], "bound_by": bnd[1], "bound_int32_ms": bnd[2],
        "library_ms": cuda_ms(lambda: x_t[:, :16].reshape(64, 128), 200),
        "library_queued_ms": queued_ms(
            lambda: x_t[:, :16].reshape(64, 128), 200),
        "library_call": "x[:, :16].reshape(64, 128), a copy (the slice is "
                        "not contiguous)",
        "queued_ms": queued_ms(lambda: p3.p4_cuda(x_t), 200),
        "exact_inputs": ["script", "edges"]}
    log(f"C30 probe_p4: exact; {out['probe_p4']}")
    return out


def with_ties(rng, x, axis):
    """x with the minimum of each row (axis 1) or column (axis 0) copied to
    three more of its places."""
    y = x.T if axis == 0 else x                # a view
    for r in range(len(y)):
        others = [c for c in range(y.shape[1]) if y[r, c] != y[r].min()]
        y[r, rng.choice(others, 3, replace=False)] = y[r].min()
    return x


def check_reductions(dev):
    """Phase 18, kernels C31-C35 (probes 2, 5 and 6 of
    scripts/probe_pallas3.py) against their plain versions on the card, at
    the script's shapes: C31-C34 exact at its inputs and at int32 edges
    (C32 and C34 in both forms), C35 bit for bit at its inputs, at a
    random float32 w and at x over all of int32, and at shapes whose K, N
    and R leave tails; misaligned and wrong-shape inputs refused with
    nothing launched.  Returns {kernel name: fields of its kernels-line
    entry but `launches`}."""
    import numpy as np
    import torch
    from nabwa_tpu_torch.ops import _build
    from nabwa_tpu_torch.probes import common
    from nabwa_tpu_torch.probes import probe_pallas3 as p3
    rng = np.random.RandomState(PROBE_SEED + 2)
    out = {}
    why = ("none: 50 dependent rounds of a {} and an add over the whole "
           "array; no single PyTorch call iterates them")

    def counts():
        return (p3.launches_p2_native, p3.launches_p2_roll,
                p3.launches_p2_roll_witness, p3.launches_p2_subl,
                p3.launches_p6)

    # C31-C33: probe 2 on the script's input, then over int32 with the
    # edges in every row and each row's (C33: column's) minimum repeated,
    # then every value within 8 of INT32_MAX (the first sums wrap); C32 in
    # both forms, the lane form (`p2_cuda`, the probe's route) and the
    # witness (`p2_roll_witness_cuda`), queued in turns (witness, lane,
    # lane, witness)
    x = rng.randint(0, 1 << 20, p3.P2_X)
    high = I32_MAX - rng.randint(0, 8, p3.P2_X)
    for kind, tie_axis, what in (("native", 1, "row minimum"),
                                 ("roll", 1, "row minimum by rotations"),
                                 ("subl", 0, "column minimum")):
        edge = int32_mixed(rng, p3.P2_X)
        ends = int32_mixed(rng, (16,))
        edge[:, :16] = [rng.permutation(ends) for _ in range(len(edge))]
        cases = {"script": x, "edges": with_ties(rng, edge, tie_axis),
                 "high": high}
        fns = {"": lambda x: p3.p2(x, kind)}
        if kind == "roll":
            fns["witness"] = p3.p2_roll_witness_cuda
        err = 0
        for name, xs in cases.items():
            x_t, = common.tensors(dev, xs)
            want = p3.p2_plain(x_t, kind)
            for form, fn in fns.items():
                err = max(err, exact(f"probe_p2 {kind} {form} {name}",
                                     fn(x_t), want))
        x_t, = common.tensors(dev, x)
        before = counts()
        wrong = x_t[:128].contiguous() if kind == "subl" else \
            x_t[:, :64].contiguous()
        for form, fn in fns.items():
            refused(f"probe_p2 {kind} {form} misaligned x",
                    lambda: fn(skewed(x_t)))
            refused(f"probe_p2 {kind} {form} shape {tuple(wrong.shape)}",
                    lambda: fn(wrong))
        if counts() != before:
            fail(f"probe_p2 {kind}: a refusal launched a kernel")
        bnd = bound(2 * nbytes(x_t),
                    OPS_P2[kind] * p3.P2_ROUNDS * x_t.numel())
        turns = {form: [] for form in fns}
        calls = {"": lambda: p3.p2_cuda(x_t, kind),
                "witness": lambda: p3.p2_roll_witness_cuda(x_t)}
        for form in ("witness", "", "", "witness") if kind == "roll" \
                else ("",):
            turns[form].append(queued_ms(calls[form], 200))
        queued = sum(turns[""]) / len(turns[""])
        e = out[f"probe_p2_{kind}"] = {
            "max_abs_err": err,
            "ms": cuda_ms(lambda: p3.p2_cuda(x_t, kind), 200),
            "plain_ms": cuda_ms(lambda: p3.p2_plain(x_t, kind), 3),
            "bound_ms": bnd[0], "bound_by": bnd[1], "bound_int32_ms": bnd[2],
            "library_ms": None,
            "library_why": why.format(what),
            "queued_ms": queued,
            "queued_us_per_round": queued * 1e3 / p3.P2_ROUNDS,
            "exact_inputs": list(cases)}
        if kind == "roll":
            wq = sum(turns["witness"]) / 2
            report = ptxas_report(_build.build_log, lambda name: (
                "lane" if "probe_p2_roll_kernel" in name
                else "witness" if "probe_p2_row_kernelILi1E" in name
                else None))
            if sorted(report) != ["lane", "witness"] or any(
                    "registers" not in v for v in report.values()):
                fail(f"C32: no ptxas report for both forms: {report}")
            if any(report["lane"][k] for k in (
                    "spill_store_bytes", "spill_load_bytes", "stack_bytes")):
                fail(f"C32's lane form spills or keeps a stack frame: "
                     f"{report['lane']}")
            e.update(
                queued_ms_turns=turns[""],
                witness_ms=cuda_ms(lambda: p3.p2_roll_witness_cuda(x_t), 200),
                witness_queued_ms=wq, witness_queued_ms_turns=turns["witness"],
                witness_queued_us_per_round=wq * 1e3 / p3.P2_ROUNDS,
                witness_over_lane_queued=wq / queued,
                witness_bound_int32_ms=bound(
                    2 * nbytes(x_t), OPS_P2_ROLL_WITNESS * p3.P2_ROUNDS
                    * x_t.numel())[2],
                witness_launches=p3.launches_p2_roll_witness,
                ptxas=report)
        log(f"probe_p2 {kind}: exact; {e}")

    # C34: probe 5 in both forms, the grid form (`p5_cuda`, the probe's
    # route) and the witness (`p5_witness_cuda`), on the script's input,
    # then s[0, 0] negative with the rest near both int32 ends, then every
    # value near INT32_MAX and s[0, 0] wrapping in its first rounds; the
    # grid form also at [512, 128] (past the witness's shared memory,
    # which it refuses) and at a word count that is not a multiple of its
    # int4; both queued in turns (witness, grid, grid, witness)
    forms = {"grid": p3.p5_cuda, "witness": p3.p5_witness_cuda}
    x = rng.randint(0, 1 << 20, p3.P5_X)
    neg = I32_MAX - rng.randint(0, 8, p3.P5_X)
    neg[1::2] = I32_MIN + rng.randint(0, 8, neg[1::2].shape)
    neg[0, 0] = -5
    wraps = I32_MAX - rng.randint(0, 8, p3.P5_X)
    wraps[0, 0] = I32_MAX - 2
    err = 0
    for name, xs in (("script", x), ("negative", neg), ("wraps", wraps)):
        x_t, = common.tensors(dev, xs)
        want = p3.p5_plain(x_t)
        for form, fn in forms.items():
            err = max(err, exact(f"C34 probe_p5 {form} {name}", fn(x_t),
                                 want))
    for shape in P5_GRID_SHAPES:
        x_t, = common.tensors(dev, int32_mixed(rng, shape))
        err = max(err, exact(f"C34 probe_p5 grid {shape}", p3.p5_cuda(x_t),
                             p3.p5_plain(x_t)))
    x_t, = common.tensors(dev, x)
    for form, fn in forms.items():
        refused(f"C34 {form} misaligned x", lambda: fn(skewed(x_t)))
    refused("C34 witness, s past a block's shared memory",
            lambda: p3.p5_witness_cuda(torch.zeros(
                (512, 128), dtype=torch.int32, device=dev)))
    trips = p3.p5_trips(int(x[0, 0]))
    inner = sum(trips)
    bnd = bound(2 * nbytes(x_t), OPS_P5 * inner * x_t.numel())
    queued = {form: [] for form in forms}
    for form in ("witness", "grid", "grid", "witness"):
        queued[form].append(queued_ms(lambda: forms[form](x_t), 100))
    q, wq = (sum(queued[form]) / 2 for form in ("grid", "witness"))
    out["probe_p5"] = {
        "max_abs_err": err, "ms": cuda_ms(lambda: p3.p5_cuda(x_t), 100),
        "plain_ms": cuda_ms(lambda: p3.p5_plain(x_t), 3),
        "bound_ms": bnd[0], "bound_by": bnd[1], "bound_int32_ms": bnd[2],
        "library_ms": None,
        "library_why": "none: 50 outer rounds whose inner trip count "
                       "hangs on s[0, 0], each inner round an add over the "
                       "whole array; no single PyTorch call iterates them",
        "queued_ms": q, "queued_ms_turns": queued["grid"],
        "queued_us_per_inner_round": q * 1e3 / inner,
        "witness_ms": cuda_ms(lambda: p3.p5_witness_cuda(x_t), 100),
        "witness_queued_ms": wq, "witness_queued_ms_turns":
            queued["witness"],
        "witness_queued_us_per_inner_round": wq * 1e3 / inner,
        "witness_launches": p3.launches_p5_witness,
        "ptxas": grid_witness_ptxas(_build.build_log, "probe_p5"),
        "inner_rounds": inner, "trips": trips, "words": x_t.numel(),
        "exact_inputs": ["script", "negative", "wraps"],
        "grid_exact_shapes": [list(sh) for sh in P5_GRID_SHAPES]}
    log(f"C34 probe_p5: both forms exact; {out['probe_p5']}")

    # C35: probe 6 on the script's inputs (w of ones), then a random
    # float32 w, then x over all of int32 with it; bit for bit; then at
    # shapes whose K leaves a tile's tail or is not a multiple of 4, whose N
    # leaves a block's columns or is not a multiple of 4, whose R leaves a
    # block's rows, and K 0
    x = rng.randint(0, 99, p3.P6_X)
    ones = np.ones(p3.P6_W, dtype=np.float32)
    w_rand = rng.standard_normal(p3.P6_W).astype(np.float32)
    err, lib_err = 0.0, 0.0
    cases = [("script", x, ones), ("random_w", x, w_rand),
             ("int32_x", int32_mixed(rng, p3.P6_X), w_rand)]
    for r, k, n in P6_TAIL_SHAPES:
        cases.append((f"{r}x{k}x{n}", int32_mixed(rng, (r, k)),
                      rng.standard_normal((k, n)).astype(np.float32)))
    for name, xs, ws in cases:
        x_t, = common.tensors(dev, xs)
        w_t = torch.from_numpy(ws).to(dev)
        got, want = p3.p6(x_t, w_t), p3.p6_plain(x_t, w_t)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"C35 probe_p6 {name}: kernel differs from its plain "
                 f"version in some bit (max |err| "
                 f"{float((got - want).abs().max())})")
        if got.numel():
            err = max(err, float((got - want).abs().max()))
        if name in ("random_w", "int32_x"):
            lib_err = max(lib_err, float(
                (torch.matmul(x_t.float(), w_t) - got).abs().max()))
    x_t, = common.tensors(dev, x)
    w_t = torch.from_numpy(ones).to(dev)
    got = p3.p6_cuda(x_t, w_t).cpu().numpy()
    if not np.array_equal(got[:, 0], x.sum(1)):
        fail("C35 probe_p6: column 0 is not x's row sums")
    before = counts()
    refused("C35 misaligned x", lambda: p3.p6(skewed(x_t), w_t))
    refused("C35 int32 w", lambda: p3.p6(x_t, w_t.int()))
    refused("C35 w of another depth", lambda: p3.p6(x_t, w_t[:64].clone()))
    refused("C35 more blocks than a launch takes", lambda: p3.p6(
        torch.zeros((2**33, 0), dtype=torch.int32, device=dev),
        torch.zeros((0, 8), dtype=torch.float32, device=dev)))
    if counts() != before:
        fail("C35: a refusal launched a kernel")
    report = ptxas_report(_build.build_log, lambda name: (
        "staged" if "probe_p6_kernel" in name else None))
    if "registers" not in report.get("staged", {}) or any(
            report["staged"][k] for k in ("spill_store_bytes",
                                          "spill_load_bytes", "stack_bytes")):
        fail(f"C35: no ptxas report, or it spills: {report}")
    xf = x_t.float()
    # bytes: x, w and out once each
    bnd = bound(nbytes(x_t, w_t) + 4 * x_t.shape[0] * w_t.shape[1],
                OPS_P6 * x_t.numel() * w_t.shape[1])
    out["probe_p6"] = {
        "max_abs_err": err, "ms": cuda_ms(lambda: p3.p6_cuda(x_t, w_t), 200),
        "plain_ms": cuda_ms(lambda: p3.p6_plain(x_t, w_t), 3),
        "bound_ms": bnd[0], "bound_by": bnd[1], "bound_int32_ms": bnd[2],
        "library_ms": cuda_ms(lambda: torch.matmul(x_t.float(), w_t), 200),
        "library_queued_ms": queued_ms(
            lambda: torch.matmul(x_t.float(), w_t), 200),
        "library_call": "torch.matmul(x.float(), w), the cast included",
        "library_precast_ms": cuda_ms(lambda: torch.matmul(xf, w_t), 200),
        "library_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "library_max_abs_diff": lib_err,
        "queued_ms": queued_ms(lambda: p3.p6_cuda(x_t, w_t), 200),
        "blocks": p3.p6_blocks(*got.shape), "ptxas": report["staged"],
        "exact_inputs": [name for name, *_ in cases]}
    log(f"C35 probe_p6: bit for bit; {out['probe_p6']}")
    return out


def run_probe_entries():
    """Each probe entry point once with `--device cuda`, in a process of
    its own (every launch counter starts at 0) with its environment of
    PROBE_ENTRIES: probe_sem at K=SEM_K, probe_spill and probe_colops at
    their scripts' default K and T.  The processes run side by side (each
    spends most of its ~10 s starting PyTorch and the card; the times the
    entries print are then taken beside the others'); every one is ended
    before this returns or fails.  Returns ({kernel: launches summed over
    the runs}, {entry: its printed lines})."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("ROWS", "T", "K")}
    counts, printed = {}, {}
    t0 = time.perf_counter()
    procs = {}
    try:
        for name, extra in PROBE_ENTRIES.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", PROBE_COUNT, name, "--device",
                 "cuda"], cwd=ROOT, env={**base, **extra},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            lines = out.splitlines()
            if proc.returncode != 0 or not lines:
                fail(f"python -m nabwa_tpu_torch.probes.{name} --device "
                     f"cuda exited with {proc.returncode}: {err[-2000:]}")
            printed[name] = lines[:-1]
            for key, v in json.loads(lines[-1]).items():
                counts[key] = counts.get(key, 0) + v
            log(f"probes.{name} --device cuda (done "
                f"{time.perf_counter() - t0:.1f} s after the entries "
                f"started, launches {lines[-1]}):")
            for ln in lines[:-1]:
                log("    " + ln)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for key, v in counts.items():
        if v <= 0:
            fail(f"kernel {key} was not launched by its probe's entry point")
    return counts, printed


def profile_run(label, fn):
    """torch.profiler over one call of fn: busy share and per-kernel device
    time, or None where the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_dev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    top = sorted(on_dev, key=lambda e: -dev_us(e))[:6]
    rows = {e.key[:48]: {"count": e.count, "ms": dev_us(e) / 1e3}
            for e in top}
    if not on_dev:
        log(f"profiler, {label}: no device time seen (not measured)")
        return None
    log(f"profiler, {label}: {wall:.3f} s wall under the profiler, device "
        f"busy {busy_ms:.1f} ms ({100 * busy_ms / 1e3 / wall:.1f} %); {rows}")
    return {"wall_s": wall, "busy_ms": busy_ms,
            "busy_share": busy_ms / 1e3 / wall, "top": rows}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--glen", type=int, default=64_000_000)
    ap.add_argument("--reads", type=int, default=32768)
    ap.add_argument("--pairs", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=2048,
                    help="device batch of the timed engine run")
    ap.add_argument("--retry-stack", type=int, default=1024,
                    help="retry-tier slot pool of the timed engine run; "
                    "its hit list is an eighth of it, as at the default")
    # 384 keeps the whole run inside 900 s
    ap.add_argument("--long-reads", type=int, default=384,
                    help="1 kb reads of the bwasw phases")
    ap.add_argument("--profile", action="store_true",
                    help="run torch.profiler over one more engine run and "
                    "one more bwasw card run")
    args = ap.parse_args()
    if not (ROOT / "nabwa_tpu_torch" / "csrc").is_dir() or \
            not (ROOT / "native").is_dir():
        fail("chip_smoke.py must run from a checkout of the repository")
    for name in ROUTE_ENV:
        if os.environ.get(name) is not None:
            fail(f"{name} is set: it chooses the engine's routes by hand")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    torch.cuda.set_device(0)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t_start = time.perf_counter()
    phase_seconds = {}

    def phase_mark(name):
        """Log the run's seconds so far as phase `name` starts."""
        phase_seconds[name] = time.perf_counter() - t_start
        log(f"phase {name} starts at {phase_seconds[name]:.1f} s")

    import numpy as np
    from nabwa_tpu_torch import cli as port_cli
    from nabwa_tpu_torch.index.fmindex import BwaIndex
    from nabwa_tpu_torch.io import fastq
    from nabwa_tpu_torch.models import aln as maln
    from nabwa_tpu_torch.models.samse import sam_header
    from nabwa_tpu_torch.options import GapOpt, PeOpt
    from nabwa_tpu_torch.ops import _build, dfs_cuda, dp, occ
    from nabwa_tpu_torch.ops import sa_lookup as sl
    from nabwa_tpu_torch.utils.rand48 import Rand48

    # phase 1: build the kernels from the checkout's sources
    t0 = time.perf_counter()
    _build.lib()
    nvcc_s = _build.build_seconds or 0.0
    log(f"kernel library {_build.LIB_PATH.relative_to(ROOT)}: nvcc "
        f"{nvcc_s:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    for ln in _build.build_log.splitlines():
        if "registers" in ln or "spill" in ln:
            log("ptxas: " + ln.strip())
    dp_ptxas = {name: kernel_ptxas(_build.build_log, tag) for name, tag in (
        ("extend", "extend_warp_kernel"),
        ("banded_global", "banded_global_warp_kernel"),
        ("dfs", "dfs_warp_kernel"))}
    for name, rep in dp_ptxas.items():
        log(f"ptxas, {name}: {rep}")
        if sorted(rep) != ["device", "shared"] or any(
                "registers" not in v for v in rep.values()):
            fail(f"no ptxas report for both forms of {name}")
        if any(v["spill_store_bytes"] or v["spill_load_bytes"]
               for v in rep.values()):
            fail(f"{name} spills registers: {rep}")
    forms_ptxas = form_ptxas(_build.build_log)
    for name, keys in (("cal_width", ["G8"]),
                       ("sa_lookup", ["magic", "pow2"]),
                       ("local_fwd", ["K16", "K2", "K4", "K8",
                                      "device", "shared"])):
        rep = forms_ptxas[name]
        log(f"ptxas, {name}: {rep}")
        if sorted(rep) != keys or any("registers" not in v
                                      for v in rep.values()):
            fail(f"no ptxas report for every form of {name}: {sorted(rep)}")
        if any(v["spill_store_bytes"] or v["spill_load_bytes"]
               for v in rep.values()):
            fail(f"{name} spills registers: {rep}")
    if any(v["stack_bytes"] for v in forms_ptxas["sa_lookup"].values()):
        fail(f"C3 keeps a stack frame: {forms_ptxas['sa_lookup']}")

    fa, fq, fq_gapped, fq1, fq2, fq_long, fq2_1, fq2_2 = make_data(
        args.glen, args.reads, args.pairs, args.long_reads)
    opt = GapOpt()
    idx = BwaIndex.load(str(fa))
    reads = port_cli.open_reads(str(fq), opt.mode)(args.reads, 0)
    if len(reads) != args.reads:
        fail(f"read {len(reads)} reads, expected {args.reads}")
    eng = maln.AlnEngine(idx, opt, "cuda", retry_stack_cap=args.retry_stack,
                         retry_hits_cap=args.retry_stack // 8, host_frac=0)

    phase_mark("2-3")
    # phases 2-3: kernels against their plain versions on the card, on the
    # engine's own inputs for the first CHECK_B reads of the chunk
    lens = reads.clip_lens().astype(np.int32)
    maxdiff, local = maln.batch_options(opt, lens)
    max_len = int(lens.max())
    part = reads[:CHECK_B]
    inputs = maln.batch_inputs(part, lens[:CHECK_B], maxdiff[:CHECK_B],
                               local, max_len, eng.device)
    # each check's seconds (`phase23_seconds`), to find what to cut
    phase23 = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        res = fn(*a)
        phase23[name] = time.perf_counter() - t0
        return res
    cw = timed("cal_width", check_cal_width, eng, inputs)
    cw_edges = timed("cal_width_edges", check_cal_width_edges, eng)
    tier0 = timed("tier0", check_dfs, eng, inputs, maln.dfs_statics(
        local, eng.stack_cap, eng.hits_cap, eng.tier0_max_iters), "tier 0")
    # the retry tier's settings on the reads tier 0 flagged (all of the
    # batch where it flagged none)
    flagged = tier0["flagged"]
    redo = flagged if len(flagged) else np.arange(len(part))
    again = maln.batch_inputs([part[int(i)] for i in redo], lens[redo],
                              maxdiff[redo], local, max_len, eng.device)
    retry = timed("retry", check_dfs, eng, again, maln.dfs_statics(
        local, eng.retry_stack_cap, eng.retry_hits_cap, eng.max_iters),
        "retry tier")
    dfs_edges, phase23["dfs_edges"] = check_dfs_edges(
        torch.device("cuda", 0))
    log(f"phases 2-3, seconds: {phase23}")

    phase_mark("4")
    # phase 4: the aln path at full size
    want, host_s = native_reference(idx, reads, opt)
    log(f"host native engine: {len(reads) / host_s:.1f} reads/s "
        f"({os.cpu_count()} cores)")
    eng.run_chunk(reads[:args.batch], device_batch=args.batch)   # warm-up
    eng.tier0_reads = eng.retry_reads = eng.host_drain_reads = 0
    eng.seconds = dict.fromkeys(eng.seconds, 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run_chunk(reads, device_batch=args.batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = opt.pack() + native_block(res)
    host_share = eng.host_drain_reads / len(reads)
    parts = dict(eng.seconds, rest=dt - sum(eng.seconds.values()))
    log(f"aln on the card: {len(reads) / dt:.1f} reads/s ({dt:.3f} s for "
        f"{len(reads)} reads, batch {args.batch}, retry pool "
        f"{eng.retry_stack_cap}); finished on tier 0 {eng.tier0_reads}, "
        f"retry {eng.retry_reads}, host {eng.host_drain_reads} "
        f"({100 * host_share:.2f} %); host seconds per part {parts}")
    if got != want:
        fail("engine .sai differs from the host native engine's")
    if host_share > MAX_HOST_SHARE:
        fail(f"{100 * host_share:.1f} % of reads drained on the host")
    prof = (profile_run("aln", lambda: eng.run_chunk(
        reads, device_batch=args.batch)) if args.profile else None)

    def zero():
        occ.launches = dfs_cuda.launches = sl.launches = 0
        dp.launches = dp.launches_local = dp.launches_extend = 0

    def launched():
        return {"dfs": dfs_cuda.launches, "cal_width": occ.launches,
                "sa_lookup": sl.launches, "banded_global": dp.launches,
                "local_fwd": dp.launches_local,
                "extend": dp.launches_extend}

    # the hybrid split on a fresh engine, then the split's constants
    hybrid = hybrid_runs(idx, opt, reads, want, args, zero, launched)
    consts = split_constants(idx, opt, reads, args, eng.dev_rate,
                             len(reads) / host_s)

    tmp = pathlib.Path(tempfile.gettempdir())
    out = tmp / "nabwa_torch_smoke.sai"
    out.unlink(missing_ok=True)
    zero()
    t0 = time.perf_counter()
    rc = port_cli.main(["aln", "--device", "cuda", str(fa), str(fq),
                        "-f", str(out)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = launched()
    main_counts = [counts]
    log(f"CLI aln --device cuda (the hybrid): rc {rc}, {cli_s:.2f} s end to "
        f"end (index load included); launches {counts}")
    if rc != 0:
        fail(f"the port's aln CLI exited with {rc}")
    if out.read_bytes() != want:
        fail("CLI .sai differs from the host native engine's")
    for name in ("dfs", "cal_width"):
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the aln path")
    one_c2_per_c1("CLI aln", counts)
    fresh = fresh_cli_aln(fa, fq, len(reads), want, len(opt.pack()))
    main_counts.append({k: fresh.get(k, 0) for k in counts})

    phase_mark("5-6")
    # phases 5-6: C3 on the SA rows samse asks for on the bench .sai, and
    # its edge launches; the gapped read set's .sai from the host engine,
    # and C4 on its jobs
    sa = check_sa_lookup(eng, idx, reads, want)
    sa_edges = check_sa_edges(eng)
    reads_g = port_cli.open_reads(str(fq_gapped), opt.mode)(args.reads, 0)
    want_g, host_g_s = native_reference(idx, reads_g, opt)
    log(f"host native engine, gapped reads: {len(reads_g) / host_g_s:.1f} "
        f"reads/s")
    dp_err, dp_ms, dp_plain, n_jobs, tb_bytes, tb_copy_ms, dp_bound = \
        check_banded_global(eng, idx, reads_g, want_g, opt)

    def dp_size(a):
        return a[0].numel() * a[2].shape[1]

    def global_bound(a, out):
        return bound(io_bytes(a, out), OPS_GLOBAL_CELL * band_cells(a))

    def local_bound(a, out):
        return bound(io_bytes(a, out), OPS_LOCAL_CELL * int(
            (a[1].long() * a[3].long()).sum()))

    phase_mark("7")
    # phase 7: samse at full size, on the card and on the host reference
    # route, for both read sets; every C4 launch of the card runs replayed
    # against the plain DP
    se_bench = samse_routes(eng, idx, reads, want, opt, "bench reads")
    se_gap = samse_routes(eng, idx, reads_g, want_g, opt, "gapped reads")
    if not se_gap["banded_global"]:
        fail("the card run of samse on the gapped reads launched C4 no time")
    se_dp = check_launches(
        "C4 banded_global, samse's refine launches",
        se_bench.pop("banded_global") + se_gap.pop("banded_global"),
        dp.banded_global_cuda, dp.banded_global_plain, dp_size,
        global_bound)

    phase_mark("8")
    # phase 8: the CLI chain on the gapped reads, every launch count at 0
    # before each command: aln (C1, C2), then samse (C3, C4)
    sai_g = tmp / "nabwa_torch_smoke_g.sai"
    sam_g = tmp / "nabwa_torch_smoke.sam"
    sai_g.unlink(missing_ok=True)
    sam_g.unlink(missing_ok=True)
    zero()
    rc = port_cli.main(["aln", "--device", "cuda", str(fa), str(fq_gapped),
                        "-f", str(sai_g)])
    torch.cuda.synchronize()
    aln_g_counts = launched()
    if rc != 0 or sai_g.read_bytes() != want_g:
        fail(f"CLI aln on the gapped reads: rc {rc}, or its .sai differs "
             f"from the host native engine's")
    zero()
    t0 = time.perf_counter()
    rc = port_cli.main(["samse", "--device", "cuda", str(fa), str(sai_g),
                        str(fq_gapped), "-f", str(sam_g)])
    torch.cuda.synchronize()
    samse_cli_s = time.perf_counter() - t0
    se_counts = launched()
    log(f"CLI chain on the gapped reads: aln launches {aln_g_counts}; "
        f"samse --device cuda rc {rc}, {samse_cli_s:.2f} s end to end "
        f"(index load included), launches {se_counts}")
    if rc != 0:
        fail(f"the port's samse CLI exited with {rc}")
    if sam_g.read_bytes() != (sam_header(idx.bns).encode()
                              + se_gap["reference"][0]):
        fail("CLI SAM differs from the host reference route's")
    for name in ("dfs", "cal_width"):
        if aln_g_counts[name] <= 0:
            fail(f"kernel {name} was not launched by the CLI aln")
    one_c2_per_c1("CLI aln on the gapped reads", aln_g_counts)
    for name in ("sa_lookup", "banded_global"):
        if se_counts[name] <= 0:
            fail(f"kernel {name} was not launched on the samse path")

    phase_mark("9")
    # phase 9: the pair set, both ends aligned by the host engine
    popt = PeOpt()
    pairs = tuple(port_cli.open_reads(str(f), opt.mode)(args.pairs, 0)
                  for f in (fq1, fq2))
    if any(len(r) != args.pairs for r in pairs):
        fail(f"read {[len(r) for r in pairs]} pairs, expected {args.pairs}")
    want_pe = [native_reference(idx, r, opt)[0] for r in pairs]
    sais = tuple(sai_columns(w) for w in want_pe)

    phase_mark("10")
    # phase 10: sampe on the host reference route and on the card, the
    # card route's C5 and C4 launches recorded
    pe_runs, rec = sampe_routes(eng, idx, pairs, sais, opt, popt)

    phase_mark("11")
    # phase 11: C5 and C4 against their plain versions on every launch of
    # that card run (the rescue's forward rounds; its path recovery with
    # per-pair bands and gap_end -1, and any refine batch), then the SAMs
    if not rec["local_fwd"] or not rec["banded_global"]:
        fail(f"the card run of sampe launched C5 {len(rec['local_fwd'])} "
             f"and C4 {len(rec['banded_global'])} times")
    lf = check_launches(
        "C5 local_fwd, sampe's rescue rounds", rec["local_fwd"],
        dp.local_fwd_cuda, dp.local_fwd_plain, dp_size, local_bound)
    lf_forms = local_launch_forms(rec["local_fwd"], lf["times"])
    log(f"C5 local_fwd, sampe's launches [jobs, L1, L2, form, K, ms]: "
        f"{lf_forms}")
    lf_edges, lf_form_ms = check_local_edges(torch.device("cuda", 0))
    pdp = check_launches(
        "C4 banded_global, sampe's rescue paths and refine",
        rec["banded_global"], dp.banded_global_cuda, dp.banded_global_plain,
        dp_size, global_bound)
    if pe_runs["cuda"][0] != pe_runs["reference"][0]:
        fail("sampe SAM on the card differs from the host reference route's")
    n_rescue = args.pairs // RESCUE_SHARE
    rescued = pe_runs["cuda"][0].count(b"XT:A:M")
    log(f"sampe: {rescued} mates placed by the rescue ({n_rescue} pairs "
        f"built for it)")
    if rescued < n_rescue // 2:
        fail(f"the rescue placed {rescued} mates, fewer than half of the "
             f"{n_rescue} built for it")

    phase_mark("12")
    # phase 12: the slice's main path, the CLI chain on the pairs, every
    # launch count at 0 before each command: aln on each end (C1, C2),
    # then sampe (C3, C4, C5)
    pe_sai = [tmp / f"nabwa_torch_smoke_p{end}.sai" for end in (1, 2)]
    pe_sam = tmp / "nabwa_torch_smoke_pe.sam"
    for path, fqp, w in zip(pe_sai, (fq1, fq2), want_pe):
        path.unlink(missing_ok=True)
        zero()
        rc = port_cli.main(["aln", "--device", "cuda", str(fa), str(fqp),
                            "-f", str(path)])
        torch.cuda.synchronize()
        main_counts.append(launched())
        if rc != 0 or path.read_bytes() != w:
            fail(f"CLI aln on {fqp.name}: rc {rc}, or its .sai differs from "
                 f"the host native engine's")
        for name in ("dfs", "cal_width"):
            if main_counts[-1][name] <= 0:
                fail(f"kernel {name} was not launched by the CLI aln")
        one_c2_per_c1(f"CLI aln on {fqp.name}", main_counts[-1])
    pe_sam.unlink(missing_ok=True)
    zero()
    t0 = time.perf_counter()
    rc = port_cli.main(["sampe", "--device", "cuda", str(fa),
                        *map(str, pe_sai), str(fq1), str(fq2), "-f",
                        str(pe_sam)])
    torch.cuda.synchronize()
    sampe_cli_s = time.perf_counter() - t0
    pe_counts = launched()
    main_counts.append(pe_counts)
    log(f"CLI chain on the pairs: aln launches {main_counts[-3:-1]}; sampe "
        f"--device cuda rc {rc}, {sampe_cli_s:.2f} s end to end (index "
        f"load included), launches {pe_counts}")
    if rc != 0:
        fail(f"the port's sampe CLI exited with {rc}")
    if pe_sam.read_bytes() != (sam_header(idx.bns).encode()
                               + pe_runs["reference"][0]):
        fail("CLI sampe SAM differs from the host reference route's")
    for name in ("sa_lookup", "banded_global", "local_fwd"):
        if pe_counts[name] <= 0:
            fail(f"kernel {name} was not launched on the sampe path")

    phase_mark("13")
    # phase 13: the long reads
    from nabwa_tpu_torch.models import bwasw as mbw
    lreads = [(name, seq.decode(), qual.decode() if qual else None)
              for name, _, seq, qual in fastq.iter_fastq(str(fq_long))]
    if len(lreads) != args.long_reads:
        fail(f"read {len(lreads)} long reads, expected {args.long_reads}")
    bopt = mbw.Bsw2Opt()

    phase_mark("14")
    # phase 14: bwasw on the host reference route and on the card, the
    # card route's C6, C4 and C3 launches recorded and replayed against
    # their plain versions, then the SAMs
    sw_runs, sw_rec = bwasw_routes(eng, idx, lreads, bopt)
    for name in ("extend", "banded_global", "sa_lookup"):
        if not sw_rec[name]:
            fail(f"the card run of bwasw launched {name} no time")
    ext = check_launches(
        "C6 extend, bwasw's launches", sw_rec["extend"], dp.extend_cuda,
        dp.extend_plain, dp_size,
        lambda a, out: bound(io_bytes(a, out), OPS_EXTEND_CELL * int(
            out[3].long().sum())))
    sw_dp = check_launches(
        "C4 banded_global, bwasw's cigars", sw_rec["banded_global"],
        dp.banded_global_cuda, dp.banded_global_plain, dp_size,
        global_bound)
    sw_sa = check_launches(
        "C3 sa_lookup, bwasw's launches", sw_rec["sa_lookup"],
        sl.sa_lookup_cuda, sl.sa_lookup_plain, lambda a: a[6].shape[0],
        lambda a, _: sa_walk_bound(a))
    sw_sa["max_steps"] = int(sa_steps(sw_sa["args"]).max())
    if sw_runs["cuda"][0] != sw_runs["reference"][0]:
        fail("bwasw SAM on the card differs from the host reference route's")
    # C6's time split into the batched launches (stages A and A2) and the
    # single-read ones (stage B); the widest single-read launch alone
    single = sw_rec["replay"]
    ext["single_total_ms"] = sum(ext["times"][i] for i in single)
    ext["batched_total_ms"] = ext["total_ms"] - ext["single_total_ms"]
    ext["single_launches"] = len(single)
    if single:
        args1, kw1 = max((sw_rec["extend"][i] for i in single),
                         key=lambda c: (c[0][0].shape[1], c[0][2].shape[1]))
        ext["single_ms"] = cuda_ms(lambda: dp.extend_cuda(*args1, **kw1), 20)
        ext["single_queued_ms"] = queued_ms(
            lambda: dp.extend_cuda(*args1, **kw1), 20)
        ext["single_shape"] = [int(args1[0].shape[0]),
                               int(args1[0].shape[1] - 2),
                               int(args1[2].shape[1] - 1)]
        ext["single_cells"] = int(dp.extend_cuda(*args1, **kw1)[3].sum())
        log(f"C6: {len(single)} single-read launches "
            f"{ext['single_total_ms']:.3f} ms, the rest "
            f"{ext['batched_total_ms']:.3f} ms; widest single-read launch "
            f"{ext['single_shape']} (jobs, L1, L2), {ext['single_cells']} "
            f"window cells: {ext['single_ms']:.4f} ms, queued "
            f"{ext['single_queued_ms']:.4f} ms")
    # the largest C6 and C4 launches with their state in device memory,
    # then the edge launches
    ext["device_state_ms"] = forced_device_state(
        "C6, bwasw's largest launch", dp.extend_cuda, ext["args"],
        ext["kw"], ext["out"])
    sw_dp["device_state_ms"] = forced_device_state(
        "C4, bwasw's largest launch", dp.banded_global_cuda, sw_dp["args"],
        sw_dp["kw"], sw_dp["out"])
    edges = check_dp_edges(torch.device("cuda", 0))
    sw_prof = (profile_run("bwasw", lambda: mbw.bwasw_bytes(
        idx, lreads, bopt, eng, Rand48(11))) if args.profile else None)
    sw_jobs = sum(int(c[0][0].shape[0]) for c in sw_rec["extend"])
    n_amb = sum("N" in s for _, s, _ in lreads)
    log(f"bwasw: {len(sw_rec['extend'])} C6 launches ({sw_jobs} jobs), "
        f"{len(sw_rec['banded_global'])} C4, {len(sw_rec['sa_lookup'])} C3; "
        f"{n_amb} reads with N bases")

    phase_mark("15")
    # phase 15: the bwasw CLI, every launch count at 0
    sw_sam = tmp / "nabwa_torch_smoke_sw.sam"
    sw_sam.unlink(missing_ok=True)
    zero()
    t0 = time.perf_counter()
    rc = port_cli.main(["bwasw", "--device", "cuda", str(fa), str(fq_long),
                        "-f", str(sw_sam)])
    torch.cuda.synchronize()
    bwasw_cli_s = time.perf_counter() - t0
    sw_counts = launched()
    main_counts.append(sw_counts)
    log(f"CLI bwasw --device cuda: rc {rc}, {bwasw_cli_s:.2f} s end to end "
        f"(index load included), launches {sw_counts}")
    if rc != 0:
        fail(f"the port's bwasw CLI exited with {rc}")
    if sw_sam.read_bytes() != (mbw.sam_sq(idx.bns)
                               + sw_runs["reference"][0]):
        fail("CLI bwasw SAM differs from the host reference route's")
    for name in ("sa_lookup", "banded_global", "extend"):
        if sw_counts[name] <= 0:
            fail(f"kernel {name} was not launched on the bwasw path")
    phase_mark("16")
    # phase 16: bam2bam on an unaligned BAM of phase 9's pairs (read group
    # rg1, with the rescue-only mates), a quarter as many pairs more at
    # insert size 500 +- 50 (rg2) and as many reads of the gapped set as
    # rg1 singletons: the host reference route, and the card at one and at
    # four workers on one engine, all three BAMs byte-identical, the card
    # run's C3, C4 and C5 launches replayed against their plain versions
    from nabwa_tpu_torch.io import bam as pbam
    in_bam = tmp / "nabwa_torch_smoke_in.bam"
    cli_bam = tmp / "nabwa_torch_smoke_cli.bam"
    n_more = args.pairs // BAM_SHARE
    t0 = time.perf_counter()
    n_records = unaligned_bam(in_bam, [("rg1", (fq1, fq2), args.pairs),
                                       ("rg2", (fq2_1, fq2_2), n_more),
                                       ("rg1", (fq_gapped,), n_more)])
    log(f"unaligned BAM: {n_records} records, "
        f"{in_bam.stat().st_size} bytes, {time.perf_counter() - t0:.1f} s")
    b2b_argv = ["bam2bam", "-g", str(fa), "-f", str(cli_bam), str(in_bam)]
    b2b_runs, b2b_rec = bam2bam_routes(eng, idx, in_bam, n_records,
                                       b2b_argv, opt, popt, tmp)
    for label in ("cuda t1", "cuda t4"):
        if b2b_runs[label][0] != b2b_runs["reference"][0]:
            fail(f"bam2bam BAM on the card ({label}) differs from the host "
                 f"reference route's")
    t1_rec, t4_rec = b2b_rec["cuda t1"], b2b_rec["cuda t4"]
    for name in t1_rec:
        if not t1_rec[name]:
            fail(f"the card run of bam2bam launched {name} no time")
        if (b2b_runs["cuda t4"][5][name] != b2b_runs["cuda t1"][5][name]
                or launch_signatures(t4_rec[name])
                != launch_signatures(t1_rec[name])):
            fail(f"bam2bam at four workers launched {name} otherwise than "
                 f"at one")
    del b2b_rec["cuda t4"], t4_rec
    tiers = b2b_runs["cuda t1"][6]
    b2b_host_share = tiers["host_drain"] / max(
        1, tiers["tier0"] + tiers["retry"] + tiers["host_drain"])
    log(f"bam2bam on the card: {100 * b2b_host_share:.2f} % of the aligned "
        f"reads drained on the host")
    if b2b_host_share > MAX_HOST_SHARE:
        fail(f"bam2bam drained {100 * b2b_host_share:.1f} % of its reads "
             f"on the host")
    b2b_dfs_err = replay_dfs("C1 dfs, one of bam2bam's launches",
                             t1_rec["dfs"])
    b2b_cw = check_launches(
        "C2 cal_width, bam2bam's largest four-plane launch",
        [max(t1_rec["cal_width"], key=lambda c: c[0][6].numel())],
        occ.cal_width_planes_cuda, occ.cal_width_planes_plain,
        lambda a: a[6].numel(), planes_bound)
    b2b_sa = check_launches(
        "C3 sa_lookup, bam2bam's launches (both strands each)",
        t1_rec["sa_lookup"], sl.sa_lookup_both_cuda,
        sl.sa_lookup_both_plain, lambda a: a[6].shape[0],
        lambda a, _: sa_walk_bound(a))
    b2b_sa["max_steps"] = int(sa_steps(b2b_sa["args"]).max())
    b2b_dp = check_launches(
        "C4 banded_global, bam2bam's rescue paths and refine",
        t1_rec["banded_global"], dp.banded_global_cuda,
        dp.banded_global_plain, dp_size, global_bound)
    b2b_lf = check_launches(
        "C5 local_fwd, bam2bam's rescue rounds", t1_rec["local_fwd"],
        dp.local_fwd_cuda, dp.local_fwd_plain, dp_size, local_bound)
    b2b_lf_forms = local_launch_forms(t1_rec["local_fwd"], b2b_lf["times"])
    log(f"C5 local_fwd, bam2bam's launches [jobs, L1, L2, form, K, ms]: "
        f"{b2b_lf_forms}")
    b2b_lf_small = time_smallest_local(t1_rec["local_fwd"])
    b2b_rescued = pbam.bgzf_decompress(b2b_runs["cuda t1"][0]).count(
        b"XTAM")
    log(f"bam2bam: {b2b_rescued} records placed by the rescue (XT:A:M; "
        f"{n_rescue} pairs built for it); tallies "
        f"{b2b_runs['cuda t1'][4]}")
    if b2b_rescued < n_rescue // 2:
        fail(f"bam2bam's rescue placed {b2b_rescued} mates, fewer than half "
             f"of the {n_rescue} built for it")
    del t1_rec, b2b_rec

    phase_mark("17")
    # phase 17: the bam2bam CLI with every launch count at 0
    cli_bam.unlink(missing_ok=True)
    zero()
    t0 = time.perf_counter()
    rc = port_cli.main(["bam2bam", "--device", "cuda", *b2b_argv[1:]])
    torch.cuda.synchronize()
    b2b_cli_s = time.perf_counter() - t0
    b2b_counts = launched()
    main_counts.append(b2b_counts)
    log(f"CLI bam2bam --device cuda: rc {rc}, {b2b_cli_s:.2f} s end to end "
        f"(index load included), {n_records / b2b_cli_s:.1f} records/s; "
        f"launches {b2b_counts}")
    if rc != 0:
        fail(f"the port's bam2bam CLI exited with {rc}")
    if cli_bam.read_bytes() != b2b_runs["reference"][0]:
        fail("CLI bam2bam BAM differs from the host reference route's")
    for name in ("dfs", "cal_width", "sa_lookup", "banded_global",
                 "local_fwd"):
        if b2b_counts[name] <= 0:
            fail(f"kernel {name} was not launched on the bam2bam path")
    one_c2_per_c1("CLI bam2bam", b2b_counts)

    phase_mark("18")
    # phase 18: the launch path's meaning and its host split (each step
    # of C14's, C11's, C29's, C28's, C27's, C20's, C7's, C15's and C8's
    # wrappers beside their library calls), the probes, C7-C35 against
    # their plain versions on the card, then each probe's entry point in a
    # process of its own
    dev0 = torch.device("cuda", 0)
    check_launch_path(dev0)
    split = launch_split(dev0)
    log(f"host split, us a call over {split['calls']} calls: {split}")
    probes = check_probes(dev0, split)
    t0 = time.perf_counter()
    probes.update(check_chains(dev0, split))
    log(f"C23-C30 checked in {time.perf_counter() - t0:.1f} s")
    # C28, C29, C27, C20, C7, C15 against the floor
    for k in ("probe_p1b", "probe_p3", "probe_p1", "probe_lane_gather",
              "probe_rowload", "probe_smem_idx"):
        probes[k]["queued_over_c11"] = (probes[k]["queued_ms"]
                                        / probes["probe_empty"]["queued_ms"])
    t0 = time.perf_counter()
    probes.update(check_reductions(torch.device("cuda", 0)))
    log(f"C31-C35 checked in {time.perf_counter() - t0:.1f} s")
    chain_bounds(probes)
    log("chain bounds, ms: " + ", ".join(
        f"{k} {v['chain_bound_ms']:.5f}" for k, v in probes.items()
        if "chain_bound_ms" in v))
    probe_counts, probe_lines = run_probe_entries()
    # C8's serial witness, launched by probe_dma's entry beside the grid
    # form, is listed in C8's entry as C12's serial forms are in C12's
    probes["probe_dma"]["serial_launches"] = probe_counts.pop(
        "probe_dma_serial")
    phase18_s = time.perf_counter() - t_start - phase_seconds["18"]
    log(f"phase 18 took {phase18_s:.1f} s")

    phase_mark("19")
    # phase 19: the data-parallel mesh, every launch count at 0
    mesh_run, mesh_counts = mesh_phase(idx, opt, reads, want, args, zero,
                                       launched)
    main_counts.append(mesh_counts)
    log(f"phase 19 launches {mesh_counts}")
    for name in ("dfs", "cal_width", "sa_lookup"):
        if mesh_counts[name] <= 0:
            fail(f"kernel {name} was not launched on the mesh")
    mesh_run["launches"] = mesh_counts

    phase_mark("20")
    # phase 20: the index CLI, and bam2bam as a coordinator with worker
    # processes on the card, every launch count at 0
    index_cli_s = index_cli(fa, tmp)
    net_run = net_bam2bam(fa, in_bam, n_records, cli_bam, zero, launched)
    main_counts.append(net_run["launches"])
    log(f"bam2bam records/s: networked {net_run['records_per_sec']:.1f}, "
        f"phase 17's one engine {n_records / b2b_cli_s:.1f}")

    phase_mark("21")
    # phase 21: colour space, `index -c`, then `aln -c`, samse and sampe
    # (BWA_PET_SOLID) every launch count at 0, and each C1-C5 launch they
    # made against its plain version (C1 on one, as in phase 16)
    colour, colour_counts, crec = colour_phase(fa, args.glen, args.pairs,
                                               tmp, zero, launched)
    main_counts.extend(colour_counts)
    cs_dfs_err = replay_dfs("C1 dfs, one of aln -c's launches", crec["dfs"])
    cs_cw = check_launches(
        "C2 cal_width, aln -c's launches", crec["cal_width"],
        occ.cal_width_planes_cuda, occ.cal_width_planes_plain,
        lambda a: a[6].numel(), planes_bound)
    cs_sa = check_launches(
        "C3 sa_lookup, colour samse's and sampe's launches",
        crec["sa_lookup"], sl.sa_lookup_both_cuda, sl.sa_lookup_both_plain,
        lambda a: a[6].shape[0], lambda a, _: sa_walk_bound(a))
    cs_dp = check_launches(
        "C4 banded_global, colour samse's and sampe's launches (both "
        "refine rounds and the rescue's paths)", crec["banded_global"],
        dp.banded_global_cuda, dp.banded_global_plain, dp_size,
        global_bound)
    cs_lf = check_launches(
        "C5 local_fwd, colour sampe's rescue rounds", crec["local_fwd"],
        dp.local_fwd_cuda, dp.local_fwd_plain, dp_size, local_bound)
    del crec
    colour_checks = {"dfs": {"err": cs_dfs_err}, "cal_width": cs_cw,
                     "sa_lookup": cs_sa, "banded_global": cs_dp,
                     "local_fwd": cs_lf}
    colour_launches = {k: sum(c[k] for c in colour_counts)
                       for k in colour_counts[0]}

    launches = {k: sum(c[k] for c in main_counts) for k in main_counts[0]}
    launches.update(probe_counts)

    def entry(name, source, replaces, err, ms, plain_ms, bnd, **extra):
        chk = colour_checks.get(name, {})
        return {"name": name, "route": "cuda",
                "source": f"nabwa_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(err, chk.get("err", 0)), "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "bound_int32_ms": bnd[2], "library_ms": None,
                "colour_launches": colour_launches[name],
                **{f"colour_{k}": chk[k] for k in ("err", "ms", "plain_ms",
                                                    "total_ms") if k in chk},
                **extra}

    def b2b_fields(chk, n_cli):
        """A kernel's numbers on bam2bam's card run (phase 16) and its
        launches in the CLI run (phase 17)."""
        return {"bam2bam_launches": n_cli, "bam2bam_err": chk["err"],
                "bam2bam_ms": chk["ms"], "bam2bam_plain_ms": chk["plain_ms"],
                "bam2bam_total_ms": chk["total_ms"],
                "bam2bam_bound_ms": chk["bound"][0],
                "bam2bam_bound_by": chk["bound"][1],
                "bam2bam_bound_int32_ms": chk["bound"][2]}

    kernels = [
        entry("dfs", "dfs.cu", "nabwa_tpu/ops/dfs_pallas.py:1253",
              max(tier0["err"], retry["err"], b2b_dfs_err), tier0["ms"],
              tier0["plain_ms"], tier0["bound"], pops=tier0["pops"],
              **{f"tier0_{key}": tier0[key] for key in DFS_FIELDS},
              retry_ms=retry["ms"], retry_plain_ms=retry["plain_ms"],
              retry_bound_ms=retry["bound"][0], retry_pops=retry["pops"],
              **{f"retry_{key}": retry[key] for key in DFS_FIELDS},
              retry_reads=len(redo), aln_cli_launches=counts["dfs"],
              bam2bam_launches=b2b_counts["dfs"], bam2bam_err=b2b_dfs_err,
              ptxas=dp_ptxas["dfs"], edge_launches=dfs_edges),
        entry("cal_width", "cal_width.cu", "nabwa_tpu/ops/occ.py:141",
              max(cw["err"], b2b_cw["err"]), cw["ms"], cw["plain_ms"],
              cw["bound"], form="G=8", planes=4,
              ms_per_plane=cw["ms_per_plane"],
              single_plane_ms=cw["single_plane_ms"],
              ptxas=forms_ptxas["cal_width"], edge_launches=cw_edges,
              aln_cli_launches=counts["cal_width"],
              **b2b_fields(b2b_cw, b2b_counts["cal_width"])),
        entry("sa_lookup", "sa_lookup.cu", "nabwa_tpu/ops/sa_lookup.py:34",
              max(sa["err"], sw_sa["err"], b2b_sa["err"]), sa["ms"],
              sa["plain_ms"], sa["bound"], rows_by_strand=sa["rows"],
              **{key: sa[key] for key in SA_FIELDS},
              chain_bound_ms=(sa["max_steps"] * 1e-6
                              * probes["probe_loads"]["serial_ns_per_load"]),
              lone_chain_ms=sa["max_steps"] * 1e-3 * sa["lone_us_per_step"],
              ptxas=forms_ptxas["sa_lookup"],
              edge_launches=sa_edges,
              samse_cli_launches=se_counts["sa_lookup"],
              bwasw_launches=sw_counts["sa_lookup"],
              bwasw_launches_checked=len(sw_rec["sa_lookup"]),
              bwasw_rows=int(sw_sa["args"][6].shape[0]),
              bwasw_ms=sw_sa["ms"], bwasw_plain_ms=sw_sa["plain_ms"],
              bwasw_total_ms=sw_sa["total_ms"],
              bwasw_bound_ms=sw_sa["bound"][0],
              bwasw_bound_by=sw_sa["bound"][1],
              bwasw_bound_int32_ms=sw_sa["bound"][2],
              bwasw_max_steps=sw_sa["max_steps"],
              bam2bam_max_steps=b2b_sa["max_steps"],
              **b2b_fields(b2b_sa, b2b_counts["sa_lookup"])),
        entry("banded_global", "banded_global.cu", "nabwa_tpu/ops/dp.py:31",
              max(pdp["err"], dp_err, se_dp["err"], sw_dp["err"],
                  b2b_dp["err"]),
              pdp["ms"], pdp["plain_ms"], pdp["bound"],
              launches_checked=len(rec["banded_global"]),
              samse_launches_checked=len(se_dp["times"]),
              samse_total_ms=se_dp["total_ms"],
              timed_pairs=pdp["args"][0].shape[0],
              samse_refine_jobs=n_jobs, samse_refine_ms=dp_ms,
              samse_refine_plain_ms=dp_plain,
              samse_refine_bound_ms=dp_bound[0],
              samse_refine_bound_int32_ms=dp_bound[2],
              lattice_bytes=tb_bytes, lattice_copy_ms=tb_copy_ms,
              samse_cli_launches=se_counts["banded_global"],
              bwasw_launches=sw_counts["banded_global"],
              bwasw_launches_checked=len(sw_rec["banded_global"]),
              bwasw_pairs=int(sw_dp["args"][0].shape[0]),
              bwasw_L1=int(sw_dp["args"][0].shape[1] - 1),
              bwasw_L2=int(sw_dp["args"][2].shape[1] - 1),
              bwasw_band_cells=band_cells(sw_dp["args"]),
              bwasw_ms=sw_dp["ms"], bwasw_plain_ms=sw_dp["plain_ms"],
              bwasw_total_ms=sw_dp["total_ms"],
              bwasw_bound_ms=sw_dp["bound"][0],
              bwasw_bound_by=sw_dp["bound"][1],
              bwasw_bound_int32_ms=sw_dp["bound"][2],
              bwasw_device_state_ms=sw_dp["device_state_ms"],
              smem_bytes_per_warp_bwasw=dp.global_smem_bytes(
                  int(sw_dp["args"][0].shape[1] - 1)),
              ptxas=dp_ptxas["banded_global"],
              edge_launches=edges["banded_global"],
              **b2b_fields(b2b_dp, b2b_counts["banded_global"])),
        entry("local_fwd", "local_fwd.cu", "nabwa_tpu/ops/dp.py:404",
              max(lf["err"], b2b_lf["err"]), lf["ms"], lf["plain_ms"],
              lf["bound"],
              launches_checked=len(rec["local_fwd"]),
              rescue_jobs=[int(a[0].shape[0]) for a, _ in rec["local_fwd"]],
              timed_cells=int((lf["args"][1].long()
                               * lf["args"][3].long()).sum()),
              form="K={1} ({0})".format(
                  *dp.local_form(int(lf["args"][0].shape[1] - 1))),
              launch_forms=lf_forms, bam2bam_launch_forms=b2b_lf_forms,
              bam2bam_smallest=b2b_lf_small, form_ms=lf_form_ms,
              ptxas=forms_ptxas["local_fwd"], edge_launches=lf_edges,
              **b2b_fields(b2b_lf, b2b_counts["local_fwd"])),
        entry("extend", "extend.cu", "nabwa_tpu/ops/dp.py:264",
              ext["err"], ext["ms"], ext["plain_ms"], ext["bound"],
              launches_checked=len(sw_rec["extend"]),
              jobs_checked=sw_jobs, total_ms=ext["total_ms"],
              timed_jobs=int(ext["args"][0].shape[0]),
              timed_L1=int(ext["args"][0].shape[1] - 2),
              timed_L2=int(ext["args"][2].shape[1] - 1),
              timed_cells=int(ext["out"][3].long().sum()),
              batched_total_ms=ext["batched_total_ms"],
              single_total_ms=ext["single_total_ms"],
              single_launches=ext["single_launches"],
              single_ms=ext.get("single_ms"),
              single_queued_ms=ext.get("single_queued_ms"),
              single_shape=ext.get("single_shape"),
              single_cells=ext.get("single_cells"),
              device_state_ms=ext["device_state_ms"],
              smem_bytes_per_warp=dp.extend_smem_bytes(
                  int(ext["args"][0].shape[1] - 2)),
              ptxas=dp_ptxas["extend"], edge_launches=edges["extend"]),
    ]
    for name, source, replaces in (
            ("probe_rowload", "probe_rowload.cu",
             "scripts/probe_pallas.py:43"),
            ("probe_dma", "probe_dma.cu", "scripts/probe_dma.py:101"),
            ("probe_dfs_shape", "probe_dfs_shape.cu",
             "scripts/probe_dfs_shape.py:118"),
            ("probe_pallas_dfs_shape", "probe_dfs_shape.cu",
             "scripts/probe_pallas.py:282"),
            ("probe_empty", "probe_pallas2.cu",
             "scripts/probe_pallas2.py:44"),
            ("probe_loads", "probe_pallas2.cu",
             "scripts/probe_pallas2.py:67"),
            ("probe_pop", "probe_pallas2.cu",
             "scripts/probe_pallas2.py:202"),
            ("probe_lanereduce", "probe_pallas2.cu",
             "scripts/probe_pallas2.py:170"),
            ("probe_smem_idx", "probe_pallas.cu",
             "scripts/probe_pallas.py:73"),
            ("probe_popcount", "probe_pallas.cu",
             "scripts/probe_pallas.py:97"),
            ("probe_while_scratch", "probe_pallas.cu",
             "scripts/probe_pallas.py:136"),
            ("probe_while_vector", "probe_pallas.cu",
             "scripts/probe_pallas.py:174"),
            ("probe_body_scale", "probe_pallas.cu",
             "scripts/probe_pallas.py:213"),
            ("probe_lane_gather", "probe_pallas2.cu",
             "scripts/probe_pallas2.py:92"),
            ("probe_scalar_push", "probe_pallas2.cu",
             "scripts/probe_pallas2.py:146"),
            ("probe_sem", "probe_sem.cu", "scripts/probe_sem.py:33"),
            ("probe_spill", "probe_spill.cu", "scripts/probe_spill.py:45"),
            ("probe_colops", "probe_colops.cu",
             "scripts/probe_colops.py:39"),
            ("probe_p7", "probe_pallas3.cu", "scripts/probe_pallas3.py:202"),
            ("probe_p8", "probe_pallas3.cu",
             "scripts/probe_pallas3.py:222"),
            ("probe_p1", "probe_pallas3.cu", "scripts/probe_pallas3.py:35"),
            ("probe_p1b", "probe_pallas3.cu", "scripts/probe_pallas3.py:60"),
            ("probe_p3", "probe_pallas3.cu",
             "scripts/probe_pallas3.py:123"),
            ("probe_p4", "probe_pallas3.cu",
             "scripts/probe_pallas3.py:140"),
            ("probe_p2_native", "probe_pallas3.cu",
             "scripts/probe_pallas3.py:86"),
            ("probe_p2_roll", "probe_pallas3.cu",
             "scripts/probe_pallas3.py:86"),
            ("probe_p2_subl", "probe_pallas3.cu",
             "scripts/probe_pallas3.py:86"),
            ("probe_p5", "probe_pallas3.cu",
             "scripts/probe_pallas3.py:156"),
            ("probe_p6", "probe_pallas3.cu",
             "scripts/probe_pallas3.py:183")):
        e = probes[name]
        if "queued_ms" in e:
            # the ranking of ROADMAP B.2: launches x (queued - the larger
            # of the bounds)
            e["larger_bound_ms"] = max(e["bound_ms"],
                                       e.get("bound_int32_ms") or 0,
                                       e.get("chain_bound_ms") or 0)
            e["launches_x_gap_ms"] = launches[name] * (
                e["queued_ms"] - e["larger_bound_ms"])
        kernels.append({"name": name, "route": "cuda",
                        "source": f"nabwa_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": launches[name],
                        **e})
    samse = {label: {route: {"reads_per_sec": r[1], "seconds": r[2]}
                     for route, r in runs.items()}
             for label, runs in (("bench", se_bench), ("gapped", se_gap))}
    sampe = {route: {"pairs_per_sec": r[1], "seconds": r[2],
                     "rescue_share": r[3], "launches": r[4]}
             for route, r in pe_runs.items()}
    sampe.update(pairs=args.pairs, pairs_built_for_rescue=n_rescue,
                 cli_seconds=sampe_cli_s, mate_rescued=rescued)
    bwasw = {route: {"reads_per_sec": r[1], "seconds": r[2],
                     "launches": r[3]} for route, r in sw_runs.items()}
    bwasw.update(reads=len(lreads), reads_with_n=n_amb,
                 cli_seconds=bwasw_cli_s, cli_launches=sw_counts,
                 profile=sw_prof)
    bam2bam = {label: {"records_per_sec": r[1], "stage_seconds": r[2],
                       "pass2_part_seconds": r[3], "rescue": r[4],
                       "launches": r[5], "engine": r[6]}
               for label, r in b2b_runs.items()}
    bam2bam.update(records=n_records, mate_rescued=b2b_rescued,
                   host_drain_share=b2b_host_share,
                   cli_seconds=b2b_cli_s, cli_launches=b2b_counts,
                   networked=net_run)
    total_s = time.perf_counter() - t_start
    log(f"all phases passed in {total_s:.1f} s (phase 18 {phase18_s:.1f} s)")
    print(json.dumps({"kernels": kernels, "aln_reads_per_sec": len(reads) / dt,
                      "host_drain_share": host_share,
                      "tier0_reads": eng.tier0_reads,
                      "retry_reads": eng.retry_reads,
                      "host_drain_reads": eng.host_drain_reads,
                      "run_chunk_seconds": parts,
                      "host_native_reads_per_sec": len(reads) / host_s,
                      "hybrid": hybrid, "split_constants": consts,
                      "mesh": mesh_run,
                      "cli_seconds": cli_s, "fresh_cli_aln": fresh,
                      "profile": prof,
                      "samse": samse, "samse_cli_seconds": samse_cli_s,
                      "gapped_aln_launches": aln_g_counts,
                      "sampe": sampe, "bwasw": bwasw, "bam2bam": bam2bam,
                      "probe_lines": probe_lines,
                      "index_cli_seconds": index_cli_s,
                      "colour": colour,
                      "phase_start_seconds": phase_seconds,
                      "phase23_seconds": phase23,
                      "phase18_seconds": phase18_s,
                      "total_seconds": total_s}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

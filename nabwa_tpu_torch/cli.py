"""Command line of the port: `aln`, `samse`, `sampe`, `bwasw` and
`bam2bam` on a torch device.

Usage:  python -m nabwa_tpu_torch aln [--device cuda|cpu] [aln options]
            <prefix> <reads.fq|reads.bam> [-f out.sai]
        python -m nabwa_tpu_torch samse [--device cuda|cpu] [-n N]
            [-f out.sam] [-r RG] <prefix> <in.sai> <reads.fq>
        python -m nabwa_tpu_torch sampe [--device cuda|cpu] [-a -o -n -N
            -c -f -r -s -A -P] <prefix> <1.sai> <2.sai> <1.fq> <2.fq>
        python -m nabwa_tpu_torch bwasw [--device cuda|cpu] [-a -b -q -r
            -t -w -z -s -N -c -m -H -f] <prefix> <reads.fq>
            (also as `bwtsw2` and `dbwtsw`)
        python -m nabwa_tpu_torch bam2bam [--device cuda|cpu] -g <prefix>
            [options] [-f out.bam] <in.bam>

The options, the read input (FASTQ, or BAM with `aln -b -0 -1 -2`) and
the `.sai`, SAM and BAM output are those of `nabwa_tpu aln`, `samse`,
`sampe`, `bwasw` and `bam2bam` (nabwa_tpu/cli.py:222-625); the argument
parser, option handling, read opener, `-f` recovery, @RG parsing and the
bam2bam `.sai` sideload are copied from there.  Colour-space
`samse`/`sampe` and bam2bam's remote workers (`-p`) are not ported and exit
with an error.  The device is explicit: `--device cuda` (the default)
needs a CUDA device and exits with an error without one; `--device cpu`
runs the plain PyTorch versions.  Every other subcommand of `nabwa_tpu` is
not ported yet and exits non-zero.
"""

import argparse
import struct
import sys

import numpy as np
import torch

from .constants import (BWA_AVG_ERR, BWA_MODE_BAM, BWA_MODE_BAM_READ1,
                        BWA_MODE_BAM_READ2, BWA_MODE_BAM_SE, BWA_MODE_CFY,
                        BWA_MODE_COMPREAD, BWA_MODE_GAPE, BWA_MODE_IL13,
                        BWA_MODE_LOGGAP, BWA_MODE_NONSTOP, READ_CHUNK)
from .index.fmindex import BwaIndex
from .io import fastq
from .io.bam import BamReader
from .io.sai import pack_aln_block, read_sai_columnar, read_sai_tuples
from .options import GAP_OPT_SIZE, GapOpt, PeOpt
from .utils.files import final_rename
from .utils.rand48 import Rand48

# the subcommands of nabwa_tpu/cli.py:760-782
COMMANDS = ("index", "aln", "samse", "sampe", "bwasw", "bam2bam", "worker",
            "xa2multi", "qualfa2fq", "solid2fastq", "fa2pac", "pac_rev",
            "pac2bwt", "pac2cspac", "pac2bwtgen", "bwtupdate", "bwt2sa", "sw",
            "stdsw", "bwtsw2", "dbwtsw")


def _split_device(argv, cmd):
    """Pull `--device X` / `--device=X` out of argv."""
    device, rest, it = "cuda", [], iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
            if device is None:
                raise SystemExit(f"[{cmd}] --device needs a value")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return device, rest


def _device(device, cmd):
    """The torch device to run on, or None (after an error message) when
    it is not usable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"[{cmd}] error: no CUDA device is available (use --device "
              "cpu to run the plain PyTorch versions)", file=sys.stderr)
        return None
    if dev.type not in ("cuda", "cpu"):
        print(f"[{cmd}] error: unsupported device {device}", file=sys.stderr)
        return None
    return dev


# --- helpers copied from nabwa_tpu/cli.py ---

def parse_aln_args(argv):
    ap = argparse.ArgumentParser(prog="aln")
    ap.add_argument("-n", dest="n", default=None)
    ap.add_argument("-o", dest="max_gapo", type=int, default=None)
    ap.add_argument("-e", dest="max_gape", type=int, default=-1)
    ap.add_argument("-i", dest="indel_end_skip", type=int, default=None)
    ap.add_argument("-d", dest="max_del_occ", type=int, default=None)
    ap.add_argument("-l", dest="seed_len", type=int, default=None)
    ap.add_argument("-k", dest="max_seed_diff", type=int, default=None)
    ap.add_argument("-m", dest="max_entries", type=int, default=None)
    ap.add_argument("-t", dest="n_threads", type=int, default=None)
    ap.add_argument("-M", dest="s_mm", type=int, default=None)
    ap.add_argument("-O", dest="s_gapo", type=int, default=None)
    ap.add_argument("-E", dest="s_gape", type=int, default=None)
    ap.add_argument("-R", dest="max_top2", type=int, default=None)
    ap.add_argument("-q", dest="trim_qual", type=int, default=None)
    ap.add_argument("-B", dest="barcode_len", type=int, default=0)
    ap.add_argument("-L", dest="loggap", action="store_true")
    ap.add_argument("-N", dest="nonstop", action="store_true")
    ap.add_argument("-I", dest="il13", action="store_true")
    ap.add_argument("-Y", dest="cfy", action="store_true")
    ap.add_argument("-c", dest="color", action="store_true")
    ap.add_argument("-b", dest="bam", action="store_true")
    ap.add_argument("-0", dest="bam_se", action="store_true")
    ap.add_argument("-1", dest="bam_r1", action="store_true")
    ap.add_argument("-2", dest="bam_r2", action="store_true")
    ap.add_argument("-f", dest="out", default=None)
    ap.add_argument("prefix")
    ap.add_argument("reads")
    return ap.parse_args(argv)


def apply_aln_cli_opts(args, opt):
    """Apply the explicitly given options onto `opt` (which may hold
    options recovered from a checkpoint header): every explicit option
    wins over the recovered value (bwtaln.c:330)."""
    if args.n is not None:
        if "." in args.n:
            opt.fnr = float(args.n)
            opt.max_diff = -1
        else:
            opt.max_diff = int(args.n)
            opt.fnr = -1.0
    for name in ("max_gapo", "indel_end_skip", "max_del_occ", "seed_len",
                 "max_seed_diff", "max_entries", "n_threads", "s_mm",
                 "s_gapo", "s_gape", "max_top2", "trim_qual"):
        v = getattr(args, name)
        if v is not None:
            setattr(opt, name, v)
    if args.max_gape > 0:
        opt.max_gape = args.max_gape
        opt.mode &= ~BWA_MODE_GAPE
    if args.loggap:
        opt.mode |= BWA_MODE_LOGGAP
    if args.nonstop:
        opt.mode |= BWA_MODE_NONSTOP
        opt.max_top2 = 0x7FFFFFFF
    if args.il13:
        opt.mode |= BWA_MODE_IL13
    if args.cfy:
        opt.mode |= BWA_MODE_CFY
    if args.color:   # colour space: no complement (bwtaln.c:327)
        opt.mode &= ~BWA_MODE_COMPREAD
    if args.bam:     # BAM input selection (bwtaln.c:332-335)
        opt.mode |= BWA_MODE_BAM
    if args.bam_se:
        opt.mode |= BWA_MODE_BAM_SE
    if args.bam_r1:
        opt.mode |= BWA_MODE_BAM_READ1
    if args.bam_r2:
        opt.mode |= BWA_MODE_BAM_READ2
    if args.barcode_len:
        opt.mode |= args.barcode_len << 24
    return opt


def open_reads(path, mode):
    """bwa_open_reads (bwtaln.c:164-176): a pull(n, trim_qual) closure over
    FASTQ/FASTA (the native slab parse where it accepts the file, the
    generic reader otherwise) or, with BWA_MODE_BAM, a BAM stream with the
    -0/-1/-2 mask."""
    if mode & BWA_MODE_BAM:
        which = ((4 if mode & BWA_MODE_BAM_SE else 0)
                 | (1 if mode & BWA_MODE_BAM_READ1 else 0)
                 | (2 if mode & BWA_MODE_BAM_READ2 else 0)) or 7
        reader = BamReader(path)
        return lambda n, tq: fastq.read_bam_batch(reader, n, which,
                                                  mode=mode, trim_qual=tq)
    col = fastq.ColumnarFastq.open(path, mode)
    if col is not None:
        state = {}

        def pull(n, tq):
            if "it" not in state:
                r = col.pull(n, tq)
                if r is not None:
                    return r
                state["it"] = fastq.iter_fastq(path)
            return fastq.read_fastq_batch(state["it"], n, mode=mode,
                                          trim_qual=tq)
        return pull
    it = fastq.iter_fastq(path)
    return lambda n, tq: fastq.read_fastq_batch(it, n, mode=mode,
                                                trim_qual=tq)


def attempt_recovery(fn):
    """attempt_recovery (bwtaln.c:259-297): scan an existing .sai, truncate
    to the last complete record and restore the checkpointed options.
    Returns (file, n_records_to_skip, recovered_opt_or_None,
    header_needed); on resume the header on disk is kept."""
    try:
        f = open(fn, "rb")
    except FileNotFoundError:
        return open(fn, "wb"), 0, None, True
    hdr = f.read(GAP_OPT_SIZE)
    if len(hdr) < GAP_OPT_SIZE:
        f.close()
        return open(fn, "wb"), 0, None, True
    print(f"[aln] {fn} exists, attempting recovery.", file=sys.stderr)
    opt = GapOpt.unpack(hdr)
    skip = 0
    last_good = f.tell()
    while True:
        last_good = f.tell()
        n = f.read(4)
        if len(n) < 4:
            break
        (naln,) = struct.unpack("<i", n)
        if naln < 0:
            break       # a corrupt count is not a complete record
        body = f.read(16 * naln)
        if len(body) < 16 * naln:
            break
        skip += 1
    f.close()
    out = open(fn, "rb+")
    out.seek(last_good)
    out.truncate()
    print(f"[aln] {skip} records up to position {last_good}.",
          file=sys.stderr)
    return out, skip, opt, False


def parse_rg(rg):
    """bwa_set_rg (bwase.c:635-652): (the @RG line, its ID) or (None,
    None)."""
    if rg is None:
        return None, None
    if not rg.startswith("@RG"):
        raise SystemExit("[samse/sampe] malformed @RG line")
    line = rg.replace("\\t", "\t").replace("\\n", "\n").replace("\\r", "\r")
    idp = line.find("\tID:")
    if idp < 0:
        raise SystemExit("[samse/sampe] malformed @RG line")
    idp += 4
    end = idp
    while end < len(line) and line[end] not in "\t\n":
        end += 1
    return line, line[idp:end]


def read_sai(path):
    """(GapOpt, per-read alignments) of a .sai, columnar where the native
    scan takes it."""
    opt, per_read = read_sai_columnar(path)
    if per_read is None:
        opt, per_read = read_sai_tuples(path)
    return opt, per_read


def _colour_refused(opt, cmd):
    if opt.mode & BWA_MODE_COMPREAD:
        return False
    print(f"[{cmd}] error: colour-space reads are not yet ported to "
          "nabwa_tpu_torch", file=sys.stderr)
    return True


# --- subcommands ---

def cmd_aln(argv):
    device, argv = _split_device(argv, "aln")
    dev = _device(device, "aln")
    if dev is None:
        return 2
    args = parse_aln_args(argv)
    from .models.aln import AlnEngine

    opt = GapOpt()
    skip = 0
    header_needed = True
    if args.out:
        out, skip, rec_opt, header_needed = attempt_recovery(args.out)
        if rec_opt is not None:
            opt = rec_opt
    else:
        out = sys.stdout.buffer
    # recovered checkpoint options first, explicit CLI options on top
    apply_aln_cli_opts(args, opt)
    eng = AlnEngine(BwaIndex.load(args.prefix), opt, dev)
    if header_needed:
        out.write(opt.pack())
    pull = open_reads(args.reads, opt.mode)
    while skip > 0:
        n = len(pull(min(skip, READ_CHUNK), opt.trim_qual))
        if n == 0:
            raise SystemExit("[aln] EOF while skipping done work.")
        skip -= n
    tot = 0
    while True:
        reads = pull(READ_CHUNK, opt.trim_qual)
        if not reads:
            break
        results = eng.run_chunk(reads)
        out.write(pack_aln_block([alns for alns, _ in results]))
        tot += len(reads)
        print(f"[aln] {tot} sequences processed", file=sys.stderr)
    if args.out:
        out.close()
        final_rename("aln", args.out)
    return 0


def cmd_samse(argv):
    device, argv = _split_device(argv, "samse")
    dev = _device(device, "samse")
    if dev is None:
        return 2
    ap = argparse.ArgumentParser(prog="samse")
    ap.add_argument("-n", dest="n_occ", type=int, default=3)
    ap.add_argument("-f", dest="out", default=None)
    ap.add_argument("-r", dest="rg", default=None)
    ap.add_argument("prefix")
    ap.add_argument("sai")
    ap.add_argument("reads")
    args = ap.parse_args(argv)
    from .models.aln import AlnEngine
    from .models.samse import sam_header, samse_bytes

    opt, per_read = read_sai(args.sai)
    if _colour_refused(opt, "samse"):
        return 1
    idx = BwaIndex.load(args.prefix)
    eng = AlnEngine(idx, opt, dev)
    rng = Rand48(idx.bns.seed)
    rg_line, rg_id = parse_rg(args.rg)
    out = open(args.out, "wb") if args.out else sys.stdout.buffer
    out.write(sam_header(idx.bns, rg_line=rg_line).encode())
    pull = open_reads(args.reads, opt.mode)
    off = 0
    while True:
        reads = pull(READ_CHUNK, opt.trim_qual)
        if not reads:
            break
        alns = per_read[off:off + len(reads)]
        off += len(reads)
        out.write(samse_bytes(eng, reads, alns, opt, n_occ=args.n_occ,
                              rng=rng, rg_id=rg_id))
    if args.out:
        out.close()
        final_rename("samse", args.out)
    else:
        out.flush()
    return 0


def cmd_sampe(argv):
    device, argv = _split_device(argv, "sampe")
    dev = _device(device, "sampe")
    if dev is None:
        return 2
    ap = argparse.ArgumentParser(prog="sampe")
    ap.add_argument("-a", dest="max_isize", type=int, default=None)
    ap.add_argument("-o", dest="max_occ", type=int, default=None)
    ap.add_argument("-n", dest="n_multi", type=int, default=None)
    ap.add_argument("-N", dest="N_multi", type=int, default=None)
    ap.add_argument("-c", dest="ap_prior", type=float, default=None)
    ap.add_argument("-f", dest="out", default=None)
    ap.add_argument("-r", dest="rg", default=None)
    ap.add_argument("-s", dest="no_sw", action="store_true")
    ap.add_argument("-A", dest="force_isize", action="store_true")
    ap.add_argument("-P", dest="preload", action="store_true")
    ap.add_argument("prefix")
    ap.add_argument("sai1")
    ap.add_argument("sai2")
    ap.add_argument("fq1")
    ap.add_argument("fq2")
    args = ap.parse_args(argv)
    from .models.aln import AlnEngine
    from .models.samse import sam_header
    from .models.sampe import sampe_bytes

    popt = PeOpt()
    for name in ("max_isize", "max_occ", "n_multi", "N_multi", "ap_prior"):
        v = getattr(args, name)
        if v is not None:
            setattr(popt, name, v)
    if args.no_sw:
        popt.is_sw = 0
    if args.force_isize:
        popt.force_isize = 1

    opt0, per_read0 = read_sai(args.sai1)
    opt, per_read1 = read_sai(args.sai2)
    if _colour_refused(opt, "sampe"):
        return 1
    idx = BwaIndex.load(args.prefix)
    eng = AlnEngine(idx, opt, dev)
    rng = Rand48(idx.bns.seed)
    rg_line, rg_id = parse_rg(args.rg)
    out = open(args.out, "wb") if args.out else sys.stdout.buffer
    out.write(sam_header(idx.bns, rg_line=rg_line).encode())
    pull0 = open_reads(args.fq1, opt0.mode)
    pull1 = open_reads(args.fq2, opt.mode)
    off = 0
    last_ii = None
    memo = {}         # wide SA intervals -> positions, across chunks
    while True:
        reads0 = pull0(READ_CHUNK, opt0.trim_qual)
        if not reads0:
            break
        reads1 = pull1(READ_CHUNK, opt.trim_qual)
        n = len(reads0)
        alns = (per_read0[off:off + n], per_read1[off:off + n])
        off += n
        blob, last_ii = sampe_bytes(eng, (reads0, reads1), alns, opt, popt,
                                    rng, rg_id=rg_id, last_ii=last_ii,
                                    pos_memo=memo)
        out.write(blob)
    if args.out:
        out.close()
        final_rename("sampe", args.out)
    else:
        out.flush()
    return 0


def cmd_bwasw(argv):
    device, argv = _split_device(argv, "bwasw")
    dev = _device(device, "bwasw")
    if dev is None:
        return 2
    ap = argparse.ArgumentParser(prog="bwasw")
    ap.add_argument("-a", dest="a", type=int, default=None)
    ap.add_argument("-b", dest="b", type=int, default=None)
    ap.add_argument("-q", dest="q", type=int, default=None)
    ap.add_argument("-r", dest="r", type=int, default=None)
    ap.add_argument("-t", dest="t", type=int, default=None)
    ap.add_argument("-w", dest="bw", type=int, default=None)
    ap.add_argument("-z", dest="z", type=int, default=None)
    ap.add_argument("-s", dest="is_", type=int, default=None)
    ap.add_argument("-N", dest="t_seeds", type=int, default=None)
    ap.add_argument("-c", dest="coef", type=float, default=None)
    ap.add_argument("-m", dest="mask_level", type=float, default=None)
    ap.add_argument("-H", dest="hard_clip", action="store_true")
    ap.add_argument("-f", dest="out", default=None)
    ap.add_argument("prefix")
    ap.add_argument("reads")
    args = ap.parse_args(argv)
    from .models.aln import AlnEngine
    from .models.bwasw import Bsw2Opt, bwasw_bytes, sam_sq

    opt = Bsw2Opt()
    for name in ("a", "b", "q", "r", "t", "bw", "z", "is_", "t_seeds",
                 "coef"):
        v = getattr(args, name)
        if v is not None:
            setattr(opt, name, v)
    if args.mask_level is not None:
        opt.mask_level = np.float32(args.mask_level)
    if args.hard_clip:
        opt.hard_clip = 1
    opt.qr = opt.q + opt.r
    idx = BwaIndex.load(args.prefix)
    eng = AlnEngine(idx, GapOpt(), dev)
    reads = [(name, seq.decode(), qual.decode() if qual else None)
             for name, _, seq, qual in fastq.iter_fastq(args.reads)]
    body = bwasw_bytes(idx, reads, opt, eng, Rand48(11))
    out = open(args.out, "wb") if args.out else sys.stdout.buffer
    out.write(sam_sq(idx.bns) + body)
    if args.out:
        out.close()
        final_rename("bwasw", args.out)
    else:
        out.flush()
    return 0


def cmd_bam2bam(argv):
    """bwa_bam_to_bam's option surface (bam2bam.c:1942-2077, getopt string
    g:n:o:e:i:d:l:k:LR:m:t:NM:O:E:q:f:C:D:a:sc:h:H:Ap:0:1:2: plus the
    long-only options), as nabwa_tpu/cli.py:462-625 parses it.  `-p`
    (remote workers) is not ported and exits with an error."""
    device, argv = _split_device(argv, "bam2bam")
    dev = _device(device, "bam2bam")
    if dev is None:
        return 2
    ap = argparse.ArgumentParser(prog="bam2bam", add_help=False)
    ap.add_argument("-g", "--genome", dest="prefix", required=True)
    ap.add_argument("-f", "--output", dest="out", default=None)
    # gap_opt_t options
    ap.add_argument("-n", "--num-diff", dest="n", default=None)
    ap.add_argument("-o", "--max-gap-open", dest="max_gapo", type=int,
                    default=None)
    ap.add_argument("-e", "--max-gap-extensions", dest="max_gape",
                    type=int, default=-1)
    ap.add_argument("-i", "--indel-near-end", dest="indel_end_skip",
                    type=int, default=None)
    ap.add_argument("-d", "--deletion-occurences", dest="max_del_occ",
                    type=int, default=None)
    ap.add_argument("-l", "--seed-length", dest="seed_len", type=int,
                    default=None)
    ap.add_argument("-k", "--seed-mismatches", dest="max_seed_diff",
                    type=int, default=None)
    ap.add_argument("-M", "--mismatch-penalty", dest="s_mm", type=int,
                    default=None)
    ap.add_argument("-O", "--gap-open-penalty", dest="s_gapo", type=int,
                    default=None)
    ap.add_argument("-E", "--gap-extension-penalty", dest="s_gape",
                    type=int, default=None)
    ap.add_argument("-m", "--queue-size", dest="max_entries", type=int,
                    default=None)
    ap.add_argument("-R", "--max-best-hits", dest="max_top2", type=int,
                    default=None)
    ap.add_argument("-q", "--trim-quality", dest="trim_qual", type=int,
                    default=None)
    ap.add_argument("-L", "--log-gap-penalty", dest="loggap",
                    action="store_true")
    ap.add_argument("-N", "--non-iterative", dest="nonstop",
                    action="store_true")
    # pe_opt_t options
    ap.add_argument("-a", "--max-insert-size", dest="max_isize", type=int,
                    default=None)
    ap.add_argument("-C", "--max-occurences", dest="max_occ", type=int,
                    default=None)
    ap.add_argument("-D", "--max-occurences-se", dest="max_occ_se",
                    type=int, default=None)
    ap.add_argument("-h", "--max-hits", dest="n_multi", type=int,
                    default=None)
    ap.add_argument("-H", "--max-discordant-hits", dest="N_multi",
                    type=int, default=None)
    ap.add_argument("-c", "--chimeric-rate", dest="ap_prior", type=float,
                    default=None)
    ap.add_argument("-s", "--disable-sw", dest="no_sw",
                    action="store_true")
    ap.add_argument("-A", "--disable-isize-estimate", dest="force_isize",
                    action="store_true")
    # runtime / distribution
    ap.add_argument("-p", "--listen-port", dest="port", type=int,
                    default=None)
    ap.add_argument("-t", "--num-threads", dest="threads", type=int,
                    default=1)
    ap.add_argument("-0", dest="sai0", default=None)
    ap.add_argument("-1", dest="sai1", default=None)
    ap.add_argument("-2", dest="sai2", default=None)
    ap.add_argument("--only-aligned", action="store_true")
    ap.add_argument("--broken-input", action="store_true")
    ap.add_argument("--skip-duplicates", action="store_true")
    ap.add_argument("--drop-aligned", action="store_true")
    ap.add_argument("--debug-bam", action="store_true")
    ap.add_argument("--temp-dir", dest="temp_dir", default="/var/tmp")
    ap.add_argument("in_bam")
    args = ap.parse_args(argv)
    if args.port is not None:
        print("[bam2bam] error: remote workers (-p) are not yet ported to "
              "nabwa_tpu_torch", file=sys.stderr)
        return 1
    from .models.aln import AlnEngine
    from .models.bam2bam import bam2bam
    from .refmodel.aln_scalar import cal_maxdiff

    opt = GapOpt()
    popt = PeOpt()
    if args.n is not None:
        if "." in args.n:
            opt.fnr = float(args.n)
            opt.max_diff = -1
        else:
            opt.max_diff = int(args.n)
            opt.fnr = -1.0
    for name in ("max_gapo", "indel_end_skip", "max_del_occ", "seed_len",
                 "max_seed_diff", "max_entries", "s_mm", "s_gapo",
                 "s_gape", "max_top2", "trim_qual"):
        v = getattr(args, name)
        if v is not None:
            setattr(opt, name, v)
    if args.max_gape > 0:
        opt.max_gape = args.max_gape
        opt.mode &= ~BWA_MODE_GAPE
    if args.loggap:
        opt.mode |= BWA_MODE_LOGGAP
    if args.nonstop:
        opt.mode |= BWA_MODE_NONSTOP
        opt.max_top2 = 0x7FFFFFFF
    opt.n_threads = args.threads
    for name in ("max_isize", "max_occ", "max_occ_se", "n_multi",
                 "N_multi", "ap_prior"):
        v = getattr(args, name)
        if v is not None:
            setattr(popt, name, v)
    if args.no_sw:
        popt.is_sw = 0
    if args.force_isize:
        popt.force_isize = 1

    # .sai sideload streams: recover checkpointed options from the first
    # header, require the others to match (bwa_bam_open, bwaseqio.c:35-61)
    sai_streams = None
    recovered = False
    for c, fn in enumerate((args.sai0, args.sai1, args.sai2)):
        if fn is None:
            continue
        f = open(fn, "rb")
        hdr = f.read(GAP_OPT_SIZE)
        if len(hdr) < GAP_OPT_SIZE:
            f.close()
            continue
        sopt = GapOpt.unpack(hdr)
        sopt.n_threads = opt.n_threads
        if recovered:
            sopt.mode = opt.mode
            if sopt.pack() != opt.pack():
                raise SystemExit(
                    '[bwa_bam_open] options from sai file "%s" conflict '
                    "with others." % fn)
            print('[bwa_bam_open] options from sai file "%s" match.' % fn,
                  file=sys.stderr)
        else:
            print('[bwa_bam_open] recovered options from sai file "%s".'
                  % fn, file=sys.stderr)
            opt = sopt
            recovered = True
        sai_streams = sai_streams or {}
        sai_streams[c] = f

    if opt.fnr > 0.0:
        k = 0
        for i in range(17, 251):
            l = cal_maxdiff(i, BWA_AVG_ERR, opt.fnr)
            if l != k:
                print(f"[bwa_aln] {i}bp reads: max_diff = {l}",
                      file=sys.stderr)
            k = l

    idx = BwaIndex.load(args.prefix)
    eng = AlnEngine(idx, opt, dev)
    bam2bam(eng, args.in_bam, args.out or "/dev/stdout", opt, popt,
            Rand48(idx.bns.seed), argv=["bam2bam"] + argv,
            only_aligned=args.only_aligned, broken_input=args.broken_input,
            skip_duplicates=args.skip_duplicates,
            drop_aligned=args.drop_aligned, debug_bam=args.debug_bam,
            n_workers=args.threads, sai_streams=sai_streams,
            tmp_dir=args.temp_dir)
    final_rename("bam2bam", args.out)
    return 0


_PORTED = {"aln": cmd_aln, "samse": cmd_samse, "sampe": cmd_sampe,
           "bwasw": cmd_bwasw, "bwtsw2": cmd_bwasw, "dbwtsw": cmd_bwasw,
           "bam2bam": cmd_bam2bam}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in _PORTED:
        return _PORTED[argv[0]](argv[1:])
    if argv and argv[0] in COMMANDS:
        print(f"[{argv[0]}] not yet ported to nabwa_tpu_torch",
              file=sys.stderr)
        return 1
    print("Program: nabwa_tpu_torch (the aln, samse, sampe, bwasw and "
          "bam2bam paths on PyTorch + CUDA)\n"
          "Usage:   python -m nabwa_tpu_torch aln [--device cuda|cpu] "
          "[options] <prefix> <reads>\n"
          "         python -m nabwa_tpu_torch samse [--device cuda|cpu] "
          "[options] <prefix> <in.sai> <reads>\n"
          "         python -m nabwa_tpu_torch sampe [--device cuda|cpu] "
          "[options] <prefix> <1.sai> <2.sai> <1.fq> <2.fq>\n"
          "         python -m nabwa_tpu_torch bwasw [--device cuda|cpu] "
          "[options] <prefix> <reads>\n"
          "         python -m nabwa_tpu_torch bam2bam [--device cuda|cpu] "
          "-g <prefix> [options] <in.bam>",
          file=sys.stderr)
    return 1

"""Command line of the port: `aln` and `samse` on a torch device.

Usage:  python -m nabwa_tpu_torch aln [--device cuda|cpu] [aln options]
            <prefix> <reads.fq> [-f out.sai]
        python -m nabwa_tpu_torch samse [--device cuda|cpu] [-n N]
            [-f out.sam] [-r RG] <prefix> <in.sai> <reads.fq>

The options, the read input and the `.sai` and SAM output are those of
`nabwa_tpu aln` and `samse` (nabwa_tpu/cli.py:222-313), whose argument
parser, option handling, read opener, `-f` recovery and @RG parsing are
reused (`host`).  The device is explicit: `--device cuda` (the default)
needs a CUDA device and exits with an error without one; `--device cpu`
runs the plain PyTorch versions.  Every other subcommand is not ported
yet and exits non-zero.
"""

import argparse
import sys

import torch

from . import host


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


def cmd_aln(argv):
    device, argv = _split_device(argv, "aln")
    dev = _device(device, "aln")
    if dev is None:
        return 2
    args = host.parse_aln_args(argv)
    from .models.aln import AlnEngine

    opt = host.GapOpt()
    skip = 0
    header_needed = True
    if args.out:
        out, skip, rec_opt, header_needed = host.attempt_recovery(
            args.out)
        if rec_opt is not None:
            opt = rec_opt
    else:
        out = sys.stdout.buffer
    # recovered checkpoint options first, explicit CLI options on top
    host.apply_aln_cli_opts(args, opt)
    eng = AlnEngine(host.BwaIndex.load(args.prefix), opt, dev)
    if header_needed:
        out.write(opt.pack())
    pull = host.open_reads(args.reads, opt.mode)
    while skip > 0:
        n = len(pull(min(skip, host.READ_CHUNK), opt.trim_qual))
        if n == 0:
            raise SystemExit("[aln] EOF while skipping done work.")
        skip -= n
    tot = 0
    while True:
        reads = pull(host.READ_CHUNK, opt.trim_qual)
        if not reads:
            break
        results = eng.run_chunk(reads)
        out.write(host.sai_block(results))
        tot += len(reads)
        print(f"[aln] {tot} sequences processed", file=sys.stderr)
    if args.out:
        out.close()
        host.final_rename("aln", args.out)
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
    from .models.samse import samse_bytes

    opt, per_read = host.read_sai_columnar(args.sai)
    if per_read is None:
        opt, per_read = host.read_sai_tuples(args.sai)
    if not opt.mode & host.BWA_MODE_COMPREAD:
        print("[samse] error: colour-space reads are not yet ported to "
              "nabwa_tpu_torch", file=sys.stderr)
        return 1
    idx = host.BwaIndex.load(args.prefix)
    eng = AlnEngine(idx, opt, dev)
    rng = host.Rand48(idx.bns.seed)
    rg_line, rg_id = host.parse_rg(args.rg)
    out = open(args.out, "wb") if args.out else sys.stdout.buffer
    out.write(host.sam_header(idx.bns, rg_line=rg_line).encode())
    pull = host.open_reads(args.reads, opt.mode)
    off = 0
    while True:
        reads = pull(host.READ_CHUNK, opt.trim_qual)
        if not reads:
            break
        alns = per_read[off:off + len(reads)]
        off += len(reads)
        out.write(samse_bytes(eng, reads, alns, opt, n_occ=args.n_occ,
                              rng=rng, rg_id=rg_id))
    if args.out:
        out.close()
        host.final_rename("samse", args.out)
    else:
        out.flush()
    return 0


_PORTED = {"aln": cmd_aln, "samse": cmd_samse}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in _PORTED:
        return _PORTED[argv[0]](argv[1:])
    if argv and argv[0] in host.COMMANDS:
        print(f"[{argv[0]}] not yet ported to nabwa_tpu_torch",
              file=sys.stderr)
        return 1
    print("Program: nabwa_tpu_torch (the aln and samse paths on PyTorch + "
          "CUDA)\n"
          "Usage:   python -m nabwa_tpu_torch aln [--device cuda|cpu] "
          "[options] <prefix> <reads>\n"
          "         python -m nabwa_tpu_torch samse [--device cuda|cpu] "
          "[options] <prefix> <in.sai> <reads>", file=sys.stderr)
    return 1

"""Command line of the port: `aln` on a torch device.

Usage:  python -m nabwa_tpu_torch aln [--device cuda|cpu] [aln options]
            <prefix> <reads.fq> [-f out.sai]

The options, the read input and the `.sai` output are those of
`nabwa_tpu aln` (nabwa_tpu/cli.py:222-263), whose argument parser, option
handling, read opener and `-f` recovery are reused (`host`).  The device is
explicit: `--device cuda` (the default) needs a CUDA device and exits with
an error without one; `--device cpu` runs the plain PyTorch versions.
Every other subcommand is not ported yet and exits non-zero.
"""

import sys

import torch

from . import host


def _split_device(argv):
    """Pull `--device X` / `--device=X` out of argv."""
    device, rest, it = "cuda", [], iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
            if device is None:
                raise SystemExit("[aln] --device needs a value")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return device, rest


def cmd_aln(argv):
    device, argv = _split_device(argv)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("[aln] error: no CUDA device is available (use --device cpu "
              "to run the plain PyTorch versions)", file=sys.stderr)
        return 2
    if dev.type not in ("cuda", "cpu"):
        print(f"[aln] error: unsupported device {device}", file=sys.stderr)
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


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "aln":
        return cmd_aln(argv[1:])
    if argv and argv[0] in host.COMMANDS:
        print(f"[{argv[0]}] not yet ported to nabwa_tpu_torch",
              file=sys.stderr)
        return 1
    print("Program: nabwa_tpu_torch (the aln path on PyTorch + CUDA)\n"
          "Usage:   python -m nabwa_tpu_torch aln [--device cuda|cpu] "
          "[options] <prefix> <reads>", file=sys.stderr)
    return 1

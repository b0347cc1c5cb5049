"""`index` pipeline: FASTA → the eight reference-compatible index files
(.pac .rpac .ann .amb .bwt .rbwt .sa .rsa), mirroring bwa_index
(bwtindex.c:42-192).  The port's copy of nabwa_tpu/index/build.py."""

import os

import numpy as np

from . import formats
from . import native
from . import pack as packmod
from . import sa as samod
from ..constants import SA_INTERVAL

# Above this length the blockwise incremental builder replaces SA-IS, as
# the reference switches `-a is` to `-a bwtsw` at 50 Mbp
# (bwtindex.c:107,176): the full suffix array does not fit in sane RAM at
# genome scale (8+ B/char against ~0.65 B/char).
BWT_INC_THRESHOLD = 50_000_000


def _use_inc(n):
    """NABWA_BWT_INC=1/0 forces the builder; unset, the size decides."""
    env = os.environ.get("NABWA_BWT_INC")
    if env is None:
        return n > BWT_INC_THRESHOLD
    v = env.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("", "0", "false", "no", "off"):
        return False
    raise ValueError(f"NABWA_BWT_INC={env!r} not understood (use 0/1)")


def _build_one(codes, prefix, ext_bwt, ext_sa, sa_intv):
    if _use_inc(len(codes)):
        block = int(os.environ.get("NABWA_BWT_INC_BLOCK", "0"))
        bwt, primary = native.bwt_inc_native(codes, block)
        counts = np.zeros(4, dtype=np.int64)
        CH = 1 << 26
        for lo in range(0, len(codes), CH):
            counts += np.bincount(codes[lo:lo + CH], minlength=4)[:4]
        l2 = np.zeros(5, dtype=np.uint32)
        l2[1:] = np.cumsum(counts)
        words = samod.pack_bwt_words(bwt)
        inter = samod.interleave_occ(words, bwt, len(codes))
        del bwt, words
        formats.write_bwt(str(prefix) + ext_bwt, primary, l2, inter)
        # no suffix array on this path: the sampled SA comes from the
        # invPsi walk over the finished BWT (bwtsw2 -> bwt2sa,
        # bwtmisc.c:154-176)
        sa_samp = samod.cal_sa_from_bwt(inter, primary, l2, len(codes),
                                        sa_intv)
        formats.write_sa(str(prefix) + ext_sa, primary, l2, sa_samp,
                         len(codes), sa_intv)
        return
    # the suffix array (8 B/char) is freed before the interleave staging
    bwt, primary, l2, sa_samp = samod.bwt_and_sample_from_codes(
        codes, sa_intv)
    words = samod.pack_bwt_words(bwt)
    inter = samod.interleave_occ(words, bwt, len(codes))
    del bwt, words
    formats.write_bwt(str(prefix) + ext_bwt, primary, l2, inter)
    formats.write_sa(str(prefix) + ext_sa, primary, l2, sa_samp,
                     len(codes), sa_intv)


def build_index(fa_path, prefix=None, sa_intv=SA_INTERVAL, color=False):
    """Build all index files of `fa_path` at `prefix` (default: the FASTA
    path).  Returns the BntSeq metadata.

    color=True mirrors `bwa index -c` (bwtindex.c:86-102): the FASTA
    packs to prefix.nt.{pac,ann,amb}, pac2cspac derives the color-space
    pac (+ copied ann/amb) at `prefix`, and the BWT chain runs on the
    color sequence."""
    if prefix is None:
        prefix = fa_path
    if color:
        nt_prefix = str(prefix) + ".nt"
        packmod.fasta_to_pac(fa_path, nt_prefix)
        bns, codes = packmod.pac2cspac(nt_prefix, prefix)
    else:
        bns, codes = packmod.fasta_to_pac(fa_path, prefix)
    if bns.l_pac > 0xFFFFFFFF:
        raise ValueError("references over 4GB not supported (bwtint_t is "
                         "uint32, bwtindex.c:103-105)")
    big = bns.l_pac > BWT_INC_THRESHOLD
    if big:
        # big genomes: the read_pac memmap instead of the anonymous codes,
        # and never both strands' codes at once
        del codes
        codes = packmod.read_pac(str(prefix) + ".pac")
    _build_one(codes, prefix, ".bwt", ".sa", sa_intv)
    del codes
    rcodes = packmod.reverse_pac(prefix, as_memmap=big)
    _build_one(rcodes, prefix, ".rbwt", ".rsa", sa_intv)
    return bns

"""FM-index containers: the host-side load of the eight reference-format
files (`FmIndex`, `BwaIndex`, the port's copies of the classes in
nabwa_tpu/index/fmindex.py) and the index on a torch device
(`DeviceIndex`).

`DeviceIndex` is the counterpart of `BwaIndex.device_arrays` and
`nabwa_tpu.models.aln.AlnEngine._device_init`.  Both BWT banks keep the
reference's interleaved 12-word (48 B) Occ block layout (bwt.h:61-68):
4 checkpoint counters + 8 words of 2-bit bases per 128 bases, so one occ4
query reads 48 contiguous bytes.  They are stored as ONE flat int32 tensor,
forward bank then reverse bank, the layout `native/dfsgap.cpp` reads; the
reverse bank starts at word `rev_word_offset`.  A bank's last block may
be short on disk; each bank is padded with zero words to whole blocks, so
every block read stays inside the tensor and each bank starts on a 48 B
boundary (the CUDA kernels read a block as three 16 B loads).  The padding
words lie past the bank's last base and are never counted.

Positions (primary, seq_len, k, l) and the L2 counts are uint32 values.
They are kept as Python ints here (the kernels take them by value); the
tensors hold int32 bit patterns of uint32 words.
"""

import dataclasses

import numpy as np
import torch

from . import formats
from . import pack as packmod


@dataclasses.dataclass
class FmIndex:
    """One search direction (forward or reverse BWT) as host numpy arrays."""

    primary: int
    l2: np.ndarray        # [5] uint32 cumulative counts
    bwt: np.ndarray       # interleaved uint32 words
    sa: np.ndarray        # sampled SA, sa[0] == 0xFFFFFFFF
    sa_intv: int
    seq_len: int

    @classmethod
    def load(cls, prefix, reverse=False):
        ext_bwt = ".rbwt" if reverse else ".bwt"
        ext_sa = ".rsa" if reverse else ".sa"
        primary, l2, bwt, seq_len = formats.read_bwt(str(prefix) + ext_bwt)
        sa, sa_intv, sa_primary, sa_seq_len = formats.read_sa(
            str(prefix) + ext_sa)
        if sa_primary != primary or sa_seq_len != seq_len:
            raise ValueError(f"{prefix}: SA and BWT files disagree")
        return cls(primary=primary, l2=l2, bwt=bwt, sa=sa, sa_intv=sa_intv,
                   seq_len=seq_len)


@dataclasses.dataclass
class BwaIndex:
    """The full index: both FM directions, the unpacked reference and its
    metadata, what `bwa aln` + `samse/sampe` load (bwtaln.c:189-193,
    bwape.c:695-701)."""

    fwd: FmIndex
    rev: FmIndex
    pac: np.ndarray       # base codes (unpacked uint8), length l_pac
    bns: object           # pack.BntSeq

    @classmethod
    def load(cls, prefix):
        fwd = FmIndex.load(prefix, reverse=False)
        rev = FmIndex.load(prefix, reverse=True)
        pac = packmod.read_pac(str(prefix) + ".pac")
        bns = packmod.restore_ann_amb(prefix)
        if len(pac) != bns.l_pac or fwd.seq_len != bns.l_pac:
            raise ValueError(f"{prefix}: .pac, .ann and .bwt lengths differ")
        return cls(fwd=fwd, rev=rev, pac=pac, bns=bns)


def _u32(v):
    return int(v) & 0xFFFFFFFF


@dataclasses.dataclass
class DeviceIndex:
    device: torch.device
    bwt_cat: torch.Tensor      # int32 [Wf + Wr]: forward then reverse bank
    rev_word_offset: int       # first word of the reverse bank
    l2: tuple                  # the 5 cumulative base counts (uint32)
    primary_fwd: int
    primary_rev: int
    seq_len: int
    sa_fwd: torch.Tensor       # int32 sampled suffix arrays (uint32 bits)
    sa_rev: torch.Tensor
    sa_intv: int

    @classmethod
    def from_host(cls, index, device):
        """Place the numpy arrays of a loaded `BwaIndex` on
        `device` (an explicit torch.device or device string)."""
        device = torch.device(device)
        fwd, rev = index.fwd, index.rev
        if not np.array_equal(fwd.l2, rev.l2):
            raise ValueError("forward and reverse L2 counts differ")
        if fwd.seq_len != rev.seq_len:
            raise ValueError("forward and reverse lengths differ")

        def whole_blocks(words):
            out = np.zeros(-(-len(words) // 12) * 12, dtype=np.uint32)
            out[:len(words)] = words
            return out

        fwd_words = whole_blocks(fwd.bwt)
        cat = np.concatenate([fwd_words, whole_blocks(rev.bwt)])

        def put(a):
            a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
            return torch.from_numpy(a.copy()).to(device)

        return cls(
            device=device,
            bwt_cat=put(cat),
            rev_word_offset=len(fwd_words),
            l2=tuple(_u32(v) for v in fwd.l2[:5]),
            primary_fwd=_u32(fwd.primary),
            primary_rev=_u32(rev.primary),
            seq_len=_u32(fwd.seq_len),
            sa_fwd=put(fwd.sa),
            sa_rev=put(rev.sa),
            sa_intv=int(fwd.sa_intv),
        )

    @property
    def bwt_fwd(self):
        return self.bwt_cat[:self.rev_word_offset]

    @property
    def bwt_rev(self):
        return self.bwt_cat[self.rev_word_offset:]

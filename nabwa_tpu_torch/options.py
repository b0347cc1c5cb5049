"""Option dataclasses with field-for-field parity to the reference's POD
config structs: the port's copy of nabwa_tpu/options.py.

gap_opt_t (bwtaln.h:143-153, defaults gap_init_opt bwtaln.c:19-35) and
pe_opt_t (bwtaln.h:158-164, defaults bwa_init_pe_opt bwape.c:27-41) are the
reference's entire configuration state; they are memcpy'd raw into `.sai`
headers (bwtaln.c:387) and over the wire to workers (bam2bam.c:1260-1263).
We keep the exact binary layout so our `.sai` files interoperate with the
reference's and vice versa.
"""

import dataclasses
import struct

from . import constants as C

# struct gap_opt_t layout (little-endian, natural alignment, no padding):
#   int s_mm, s_gapo, s_gape, mode, indel_end_skip, max_del_occ, max_entries;
#   float fnr;
#   int max_diff, max_gapo, max_gape, max_seed_diff, seed_len, n_threads,
#       max_top2, trim_qual;
_GAP_OPT_FMT = "<7if8i"
GAP_OPT_SIZE = struct.calcsize(_GAP_OPT_FMT)  # 64 bytes


@dataclasses.dataclass
class GapOpt:
    """Search options (gap_opt_t parity)."""

    s_mm: int = 3
    s_gapo: int = 11
    s_gape: int = 4
    mode: int = C.BWA_MODE_GAPE | C.BWA_MODE_COMPREAD
    indel_end_skip: int = 5
    max_del_occ: int = 10
    max_entries: int = 2000000
    fnr: float = 0.04
    max_diff: int = -1
    max_gapo: int = 1
    max_gape: int = 6
    max_seed_diff: int = 2
    seed_len: int = 32
    n_threads: int = 1
    max_top2: int = 30
    trim_qual: int = 0

    def pack(self) -> bytes:
        return struct.pack(
            _GAP_OPT_FMT, self.s_mm, self.s_gapo, self.s_gape, self.mode,
            self.indel_end_skip, self.max_del_occ, self.max_entries, self.fnr,
            self.max_diff, self.max_gapo, self.max_gape, self.max_seed_diff,
            self.seed_len, self.n_threads, self.max_top2, self.trim_qual)

    @classmethod
    def unpack(cls, data: bytes) -> "GapOpt":
        vals = struct.unpack(_GAP_OPT_FMT, data[:GAP_OPT_SIZE])
        return cls(*vals)

    @property
    def barcode_len(self) -> int:
        return (self.mode >> 24) & 0xFF


# struct pe_opt_t layout:
#   int max_isize, force_isize, max_occ, max_occ_se, n_multi, N_multi,
#       type, is_sw, is_preload;
#   double ap_prior;   (8-byte aligned -> 4 bytes padding after is_preload)
_PE_OPT_FMT = "<9i4xd"
PE_OPT_SIZE = struct.calcsize(_PE_OPT_FMT)  # 48 bytes


@dataclasses.dataclass
class PeOpt:
    """Paired-end options (pe_opt_t parity, defaults bwape.c:27-41)."""

    max_isize: int = 500
    force_isize: int = 0
    max_occ: int = 100000
    max_occ_se: int = 3
    n_multi: int = 3
    N_multi: int = 10
    type: int = C.BWA_PET_STD
    is_sw: int = 1
    is_preload: int = 0
    ap_prior: float = 1e-5

    def pack(self) -> bytes:
        return struct.pack(
            _PE_OPT_FMT, self.max_isize, self.force_isize, self.max_occ,
            self.max_occ_se, self.n_multi, self.N_multi, self.type,
            self.is_sw, self.is_preload, self.ap_prior)

    @classmethod
    def unpack(cls, data: bytes) -> "PeOpt":
        vals = struct.unpack(_PE_OPT_FMT, data[:PE_OPT_SIZE])
        return cls(*vals)

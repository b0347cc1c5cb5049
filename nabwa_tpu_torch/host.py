"""The host modules the port shares with `nabwa_tpu`, in one place.

None of them imports jax: the index build and loader, the read opener and
`aln` argument handling of the CLI, the `.sai` writer and readers, options
and constants, the aln and stdaln scalar references, the native C++
engine (native/*.cpp), drand48, and the host steps of `samse` (hit
selection, mapQ, MD/NM, trim correction and SAM emission in
`nabwa_tpu.models.post_native` and `nabwa_tpu.models.samse`).  Every other
module of the port, and every script that drives it, reaches the JAX
package's code through this module only.
"""

from nabwa_tpu import cli as _cli
from nabwa_tpu.constants import (BWA_AVG_ERR, BWA_MODE_COMPREAD,  # noqa: F401
                                 BWA_MODE_GAPE, BWA_MODE_LOGGAP,
                                 BWA_MODE_NONSTOP, BWA_TYPE_NO_MATCH,
                                 READ_CHUNK, STATE_D, STATE_I, STATE_M)
from nabwa_tpu.index import native  # noqa: F401
from nabwa_tpu.index.build import build_index  # noqa: F401
from nabwa_tpu.index.fmindex import BwaIndex  # noqa: F401
from nabwa_tpu.io import sai
from nabwa_tpu.io.fastq import ReadBatch  # noqa: F401
from nabwa_tpu.io.sai import (AlnColumn, read_sai_columnar,  # noqa: F401
                              read_sai_tuples)
from nabwa_tpu.models import post_native as _pn
from nabwa_tpu.models import samse as _se
from nabwa_tpu.models.post_native import (  # noqa: F401
    F_C1, F_C2, F_CLIP_LEN, F_FULL_LEN, F_LEN, F_MAPQ, F_NGE, F_NGO, F_NMM,
    F_POS, F_SA, F_SEQ_Q, F_STRAND, F_TYPE, NF)
from nabwa_tpu.options import GapOpt  # noqa: F401
from nabwa_tpu.refmodel.aln_scalar import cal_maxdiff  # noqa: F401
from nabwa_tpu.refmodel.stdaln_scalar import (  # noqa: F401
    ALN_PARAM_BWA, FROM_D, FROM_I, FROM_M, MINOR_INF)
from nabwa_tpu.utils.files import final_rename  # noqa: F401
from nabwa_tpu.utils.rand48 import Rand48  # noqa: F401

COMMANDS = _cli.COMMANDS
parse_aln_args = _cli._parse_aln_args
apply_aln_cli_opts = _cli._apply_aln_cli_opts
attempt_recovery = _cli._attempt_recovery
open_reads = _cli._open_reads
parse_rg = _cli._parse_rg

# samse's host steps (nabwa_tpu/models/post_native.py, models/samse.py)
pack_recs = _pn._pack_recs
flat = _pn._flat
bns_emit_arrays = _pn._bns_emit_arrays
maxdiff_for = _pn._maxdiff_for
post_threads = _pn._post_threads
G_LOG_N = _se.G_LOG_N
SeqState = _se.SeqState
refine_window = _se.refine_window
refine_gapped_core = _se.refine_gapped_core
correct_trimmed = _se.correct_trimmed
sam_header = _se.sam_header


def sai_block(results):
    """One `.sai` block of a chunk's [(alns, hw), ...] results."""
    return sai.pack_aln_block([alns for alns, _ in results])

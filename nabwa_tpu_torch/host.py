"""The host modules the port shares with `nabwa_tpu`, in one place.

None of them imports jax: the index build and loader, the read opener and
`aln` argument handling of the CLI, the `.sai` writer, options and
constants, the aln scalar reference and the native C++ engine
(native/dfsgap.cpp).  Every other module of the port, and every script
that drives it, reaches the JAX package's code through this module only.
"""

from nabwa_tpu import cli as _cli
from nabwa_tpu.constants import (BWA_AVG_ERR, BWA_MODE_GAPE,  # noqa: F401
                                 BWA_MODE_LOGGAP, BWA_MODE_NONSTOP,
                                 READ_CHUNK, STATE_D, STATE_I, STATE_M)
from nabwa_tpu.index import native  # noqa: F401
from nabwa_tpu.index.build import build_index  # noqa: F401
from nabwa_tpu.index.fmindex import BwaIndex  # noqa: F401
from nabwa_tpu.io import sai
from nabwa_tpu.options import GapOpt  # noqa: F401
from nabwa_tpu.refmodel.aln_scalar import cal_maxdiff  # noqa: F401
from nabwa_tpu.utils.files import final_rename  # noqa: F401

COMMANDS = _cli.COMMANDS
parse_aln_args = _cli._parse_aln_args
apply_aln_cli_opts = _cli._apply_aln_cli_opts
attempt_recovery = _cli._attempt_recovery
open_reads = _cli._open_reads


def sai_block(results):
    """One `.sai` block of a chunk's [(alns, hw), ...] results."""
    return sai.pack_aln_block([alns for alns, _ in results])

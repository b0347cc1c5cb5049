"""Output-file discipline helpers: the port's copy of
nabwa_tpu/utils/files.py.

final_rename ports the reference's atomic-output convention (utils.c:159-173):
the caller passes `-f out.ext_` (any number of trailing underscores); on clean
completion the trailing underscores are stripped by a rename, so a crash
leaves a visibly-incomplete `out.ext_` and recovery logic never runs against
a finished file.  A name without trailing underscores is left untouched.
"""

import os
import sys


def final_rename(tag, ofile):
    """Strip trailing '_' from ofile by renaming, like utils.c:159-173."""
    if not ofile:
        return
    nfile = ofile.rstrip("_")
    if nfile and nfile != ofile and not nfile.endswith("/"):
        print(f"[{tag}] finished, renaming {ofile} to {nfile}.",
              file=sys.stderr)
        os.rename(ofile, nfile)

"""`cal_maxdiff`, the port's copy from nabwa_tpu/refmodel/aln_scalar.py (the
scalar aln driver itself is not copied)."""

import math


def cal_maxdiff(l, err, thres):
    """bwa_cal_maxdiff (bwtaln.c:37-49)."""
    elambda = math.exp(-l * err)
    esum = elambda
    y = 1.0
    x = 1
    for k in range(1, 1000):
        y *= l * err
        x *= k
        esum += elambda * y / x
        if 1.0 - esum < thres:
            return k
    return 2

"""Exact reimplementation of the POSIX rand48 LCG family: the port's copy of
nabwa_tpu/utils/rand48.py.

BWA's output is deterministic because every sampling decision draws from
drand48/lrand48 seeded with the genome seed (reference: srand48(bns->seed)
at bwase.c:669, bwape.c:681; N-fill uses lrand48()&3 after srand48(11),
bntseq.c:181-182,225).  Bit-identical SAM therefore requires a bit-identical
generator *and* an identical call sequence.

POSIX semantics: X_{n+1} = (a * X_n + c) mod 2**48 with a = 0x5DEECE66D,
c = 0xB.  srand48(s) sets X = (s << 16) | 0x330E.  lrand48 returns the high
31 bits; drand48 returns X / 2**48 as an IEEE double (exact: 48 bits fit in
a double mantissa plus implicit bit... 48 <= 53 so no rounding).
"""

import numpy as np

_A = 0x5DEECE66D
_C = 0xB
_MASK = (1 << 48) - 1


class Rand48:
    """Sequential POSIX rand48 state (one instance per logical stream)."""

    __slots__ = ("x",)

    def __init__(self, seed=None):
        self.x = 0
        if seed is not None:
            self.srand48(seed)

    def srand48(self, seed):
        self.x = (((seed & 0xFFFFFFFF) << 16) | 0x330E) & _MASK

    def _step(self):
        self.x = (_A * self.x + _C) & _MASK
        return self.x

    def lrand48(self):
        return self._step() >> 17

    def drand48(self):
        return self._step() / float(1 << 48)

    def lrand48_array(self, n):
        """n sequential lrand48 draws, vectorized via LCG jumping.

        The affine map f(x) = a*x + c composes; f^(2^t) is computed by
        squaring, and each output index is filled by binary decomposition.
        O(n log n) numpy work instead of an O(n) Python loop — needed for
        the N-fill of mammal-scale genomes (~10^8 draws).
        """
        if n == 0:
            return np.empty(0, dtype=np.uint64)
        # xs[j] = state after (j+1) steps from current state
        xs = np.empty(n, dtype=np.uint64)
        mask = np.uint64(_MASK)
        with np.errstate(over="ignore"):  # mod-2^64 wraparound is intended
            a_pow = np.uint64(_A)      # multiplier of f^(2^t)
            c_pow = np.uint64(_C)      # offset of f^(2^t)
            xs[0] = (a_pow * np.uint64(self.x) + c_pow) & mask
            filled = 1
            while filled < n:
                take = min(filled, n - filled)
                # f^(filled) applied to xs[0:take] fills xs[filled:...]
                xs[filled:filled + take] = (a_pow * xs[:take] + c_pow) & mask
                # compose f^(filled) with itself -> f^(2*filled)
                c_pow = (a_pow * c_pow + c_pow) & mask
                a_pow = (a_pow * a_pow) & mask
                filled *= 2
        self.x = int(xs[n - 1])
        return xs >> np.uint64(17)

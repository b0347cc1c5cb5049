"""Exact port of klib ksort.h's ks_introsort / ks_ksmall (ksort.h:68-258):
the port's copy of nabwa_tpu/utils/ksort.py.

bwasw's hit processing sorts structs with non-stable introsort and then
makes tie-dependent decisions (duplicate masking, the drand48 top pick in
bsw2_resolve_query_overlaps), so the exact permutation — including how ties
land — is part of the output contract.  `lt` is the strict __sort_lt.
"""


def _insertsort(a, lt, s, t):
    for i in range(s + 1, t):
        j = i
        while j > s and lt(a[j], a[j - 1]):
            a[j], a[j - 1] = a[j - 1], a[j]
            j -= 1


def _combsort(a, lt, off, n):
    shrink = 1.2473309501039786540366528676643
    gap = n
    while True:
        if gap > 2:
            gap = int(gap / shrink)
            if gap in (9, 10):
                gap = 11
        do_swap = False
        for i in range(off, off + n - gap):
            j = i + gap
            if lt(a[j], a[i]):
                a[i], a[j] = a[j], a[i]
                do_swap = True
        if not (do_swap or gap > 2):
            break
    if gap != 1:
        _insertsort(a, lt, off, off + n)


def introsort(a, lt):
    """In-place ks_introsort on list a."""
    n = len(a)
    if n < 1:
        return
    if n == 2:
        if lt(a[1], a[0]):
            a[0], a[1] = a[1], a[0]
        return
    d = 2
    while (1 << d) < n:
        d += 1
    stack = []
    s, t = 0, n - 1
    d <<= 1
    while True:
        if s < t:
            d -= 1
            if d == 0:
                _combsort(a, lt, s, t - s + 1)
                t = s
                continue
            i, j = s, t
            k = i + ((j - i) >> 1) + 1
            if lt(a[k], a[i]):
                if lt(a[k], a[j]):
                    k = j
            else:
                k = i if lt(a[j], a[i]) else j
            rp = a[k]
            if k != t:
                a[k], a[t] = a[t], a[k]
            while True:
                i += 1
                while lt(a[i], rp):
                    i += 1
                j -= 1
                while i <= j and lt(rp, a[j]):
                    j -= 1
                if j <= i:
                    break
                a[i], a[j] = a[j], a[i]
            a[i], a[t] = a[t], a[i]
            if i - s > t - i:
                if i - s > 16:
                    stack.append((s, i - 1, d))
                s = i + 1 if t - i > 16 else t
            else:
                if t - i > 16:
                    stack.append((i + 1, t, d))
                t = i - 1 if i - s > 16 else s
        else:
            if not stack:
                _insertsort(a, lt, 0, n)
                return
            s, t, d = stack.pop()


def ksmall(a, kk, lt):
    """ks_ksmall: kk-th smallest; PARTIALLY REORDERS a (like the C)."""
    low, high = 0, len(a) - 1
    k = kk
    while True:
        if high <= low:
            return a[k]
        if high == low + 1:
            if lt(a[high], a[low]):
                a[low], a[high] = a[high], a[low]
            return a[k]
        mid = low + (high - low) // 2
        if lt(a[high], a[mid]):
            a[mid], a[high] = a[high], a[mid]
        if lt(a[high], a[low]):
            a[low], a[high] = a[high], a[low]
        if lt(a[low], a[mid]):
            a[mid], a[low] = a[low], a[mid]
        a[mid], a[low + 1] = a[low + 1], a[mid]
        ll = low + 1
        hh = high
        while True:
            ll += 1
            while lt(a[ll], a[low]):
                ll += 1
            hh -= 1
            while lt(a[low], a[hh]):
                hh -= 1
            if hh < ll:
                break
            a[ll], a[hh] = a[hh], a[ll]
        a[low], a[hh] = a[hh], a[low]
        if hh <= k:
            low = ll
        if hh >= k:
            high = hh - 1


def heapadjust(i, n, l, lt):
    """ks_heapadjust (max-heap wrt lt)."""
    k = i
    tmp = l[i]
    while True:
        k = (k << 1) + 1
        if k >= n:
            break
        if k != n - 1 and lt(l[k], l[k + 1]):
            k += 1
        if lt(l[k], tmp):
            break
        l[i] = l[k]
        i = k
    l[i] = tmp

"""Device mesh and sharding helpers: the port's counterpart of
nabwa_tpu/parallel/mesh.py:17-54, with the same names.

The parallelism model is the JAX package's (and the reference's, SURVEY
§2.9): pure data parallelism over reads.  A mesh is its `dp` axis, an
ordered tuple of torch devices; read batches are split over it in
contiguous shards, the FM-index is replicated once per distinct device,
and the only reduction across devices is the per-read-group insert-size
histogram at the phase barrier (the reference's PUB/SUB isize broadcast,
bam2bam.c:1856-1870), summed onto the mesh's first device.

A mesh may name one device more than once: its shards then run in turn
there, which is how the CPU tests and a one-card host run a mesh.
"""

import contextlib

import numpy as np
import torch


def make_mesh(n_devices=None, device="cuda"):
    """The `dp` axis as an ordered tuple of torch devices.

    device "cuda" (no index): the visible cards in order, every one unless
    n_devices says otherwise; a count above the cards names them again in
    turn.  A device with an index ("cuda:0") or "cpu": that one device,
    n_devices times (once by default)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible")
        n = count if n_devices is None else int(n_devices)
        devs = tuple(torch.device("cuda", i % count) for i in range(n))
    else:
        n = 1 if n_devices is None else int(n_devices)
        devs = (dev,) * n
    if not devs:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return devs


def on_device(device):
    """A context with `device` as the current CUDA device (the kernels
    launch on the current device), or nothing for another device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_bounds(n, n_shards):
    """[(start, stop)] of the contiguous shards of n rows over n_shards:
    ceil(n / n_shards) rows each, so the last is shorter or empty."""
    size = -(-n // n_shards)
    return [(min(i * size, n), min((i + 1) * size, n))
            for i in range(n_shards)]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(torch.as_tensor(tree) if isinstance(tree, np.ndarray)
              else tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def shard_batch(mesh, tree):
    """Split the leading dimension of every array in `tree` (a tensor, a
    numpy array, or dicts, lists and tuples of them) into contiguous
    shards, one per mesh entry.  Returns a list: entry i is `tree` with
    each leaf's shard i on mesh[i]."""
    rows = {len(x) for x in _leaves(tree)}
    if len(rows) != 1:
        raise ValueError(f"shard_batch: leading dimensions differ: {rows}")
    n = rows.pop()
    return [_tree_map(lambda x, a=a, b=b, d=d: x[a:b].to(d), tree)
            for d, (a, b) in zip(mesh, shard_bounds(n, len(mesh)))]


def per_device(mesh, make):
    """{device: make(device)} for each distinct device of the mesh, in the
    mesh's order: one FM-index, or one copy of anything, per device."""
    return {d: make(d) for d in dict.fromkeys(mesh)}


def replicate(mesh, tree):
    """One copy of `tree` per distinct device of the mesh.  Returns a
    tuple aligned with the mesh: entries that name the same device share
    its one copy."""
    copies = per_device(mesh, lambda d: _tree_map(lambda x: x.to(d), tree))
    return tuple(copies[d] for d in mesh)


def _histogram(positions0, positions1, lengths0, lengths1, mapq0, mapq1,
               n_bins):
    p0, p1, l0, l1, q0, q1 = (t.long() for t in (
        positions0, positions1, lengths0, lengths1, mapq0, mapq1))
    good = (q0 >= 20) & (q1 >= 20)
    x = torch.where(p0 < p1, p1 + l1 - p0, p0 + l0 - p1)
    x = x[good & (x < n_bins)]
    return torch.bincount(x, minlength=n_bins)


def isize_histogram(positions0, positions1, lengths0, lengths1, mapq0,
                    mapq1, n_bins=100000, mesh=None):
    """The insert-size histogram of the pairs (the streaming per-RG
    histogram of insert_size.c:50-173 as a bincount,
    nabwa_tpu/parallel/mesh.py:39-54): a pair counts when both mates have
    mapQ >= 20, at its insert size, or in bin 0 at n_bins and above; bin 0
    is the discard bucket and is zeroed (isizes < 4 are never stored,
    insert_size.c:39-41).  Insert sizes are non-negative.

    Each argument holds one value a pair (a tensor or a numpy array).
    With a mesh the pairs are sharded over it, each shard's bincount runs
    on its own device and the shards' histograms are summed onto mesh[0]
    (the psum the JAX package's jit inserts); without one, it runs on the
    first argument's device.  Returns int32 [n_bins]."""
    args = (positions0, positions1, lengths0, lengths1, mapq0, mapq1)
    if mesh is None:
        mesh = (torch.as_tensor(positions0).device,)
    hist = torch.zeros(n_bins, dtype=torch.int64, device=mesh[0])
    for shard in shard_batch(mesh, args):
        hist += _histogram(*shard, n_bins).to(mesh[0])
    hist[0] = 0
    return hist.to(torch.int32)

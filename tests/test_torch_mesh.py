"""The port's data-parallel mesh on the CPU (`nabwa_tpu_torch/parallel/
mesh.py`, `AlnEngine(mesh=)`, `nabwa_tpu_torch/entry.py`).

- `make_mesh`, `shard_batch`, `per_device` and `replicate`: the mesh's order, the
  shards' order and sizes (a last shard that is shorter or empty), one
  copy per distinct device.
- `isize_histogram` equal to `nabwa_tpu.parallel.mesh.isize_histogram` on
  numpy inputs from 3 seeds, with insert sizes at n_bins and mapQ at
  19 / 20, whole and sharded over 3 CPU entries.
- `AlnEngine(mesh=)` with 1, 2, 3 and 8 CPU shards: `run_chunk` equal to
  the single-device engine's, with `per_read_semantics` too, and the
  `.sai` bytes equal to `nabwa_tpu aln`'s (tests/test_torch_aln.py's
  96-read fixture; small tiers, so the retry tier and the host drain run
  under the mesh).
- The twin of tests/test_bam2bam_dist.py::test_mesh_dp_matches_single_device:
  an 8-shard mesh, 2 workers, chunk 32, on the `dist` set of
  tests/test_torch_bam2bam.py: the BAM equals the single-device one.
- `entry.dryrun_multichip` at 2 CPU shards (at a small size), and
  `entry.entry` against __graft_entry__.py's step.
Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from nabwa_tpu.parallel import mesh as jmesh
from nabwa_tpu_torch import entry
from nabwa_tpu_torch.index.fmindex import BwaIndex
from nabwa_tpu_torch.io import fastq, sai
from nabwa_tpu_torch.models.aln import AlnEngine
from nabwa_tpu_torch.options import GapOpt
from nabwa_tpu_torch.parallel import mesh as pmesh

from .test_torch_aln import data  # noqa: F401  (the 96-read fixture)
from .test_torch_bam2bam import _port_b2b, made, sequential  # noqa: F401

CPU = torch.device("cpu")
TIERS = dict(stack_cap=12, retry_stack_cap=40, tier0_max_iters=60,
             max_iters=100000)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (see tests/test_torch_extend.py): the plain
    versions are loops of small tensor ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- make_mesh, shard_batch, replicate ---

def test_make_mesh_cpu():
    assert pmesh.make_mesh(device="cpu") == (CPU,)
    assert pmesh.make_mesh(3, "cpu") == (CPU,) * 3
    two = pmesh.make_mesh(2, "cuda:0")
    assert two == (torch.device("cuda", 0),) * 2
    with pytest.raises(ValueError):
        pmesh.make_mesh(0, "cpu")


def test_make_mesh_cards(monkeypatch):
    """Every visible card in order unless told otherwise; more entries
    than cards name them again in turn."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", i) for i in (0, 1)]
    assert pmesh.make_mesh() == tuple(cards)
    assert pmesh.make_mesh(1) == (cards[0],)
    assert pmesh.make_mesh(3) == (cards[0], cards[1], cards[0])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError):
        pmesh.make_mesh()


@pytest.mark.parametrize("n,shards,sizes", [
    (10, 3, [4, 4, 2]), (9, 3, [3, 3, 3]), (8, 3, [3, 3, 2]),
    (4, 3, [2, 2, 0]), (5, 8, [1, 1, 1, 1, 1, 0, 0, 0]), (0, 2, [0, 0]),
    (7, 1, [7])])
def test_shard_batch_order_and_sizes(n, shards, sizes):
    mesh = pmesh.make_mesh(shards, "cpu")
    a = torch.arange(n * 3, dtype=torch.int32).reshape(n, 3)
    b = np.arange(n, dtype=np.int64)
    out = pmesh.shard_batch(mesh, {"a": a, "pair": (b, a[:, 0])})
    assert len(out) == shards
    assert [len(s["a"]) for s in out] == sizes
    assert [len(s["pair"][0]) for s in out] == sizes
    assert torch.equal(torch.cat([s["a"] for s in out]), a)
    assert torch.equal(torch.cat([s["pair"][0] for s in out]),
                       torch.from_numpy(b))
    assert all(isinstance(s["pair"], tuple) for s in out)
    with pytest.raises(ValueError):
        pmesh.shard_batch(mesh, (a, np.zeros(n + 1)))


def test_per_device_makes_one_each():
    """`per_device` calls its constructor once per distinct device, in
    the mesh's order (the engine and the dry run build their FM-index
    copies through it)."""
    mesh = (CPU, torch.device("meta"), CPU, torch.device("meta"))
    made = []
    out = pmesh.per_device(mesh, lambda d: made.append(d) or str(d))
    assert made == [CPU, torch.device("meta")]
    assert out == {CPU: "cpu", torch.device("meta"): "meta"}


def test_replicate_one_copy_per_device():
    mesh = (CPU, torch.device("meta"), CPU)
    x = torch.arange(6)
    copies = pmesh.replicate(mesh, {"x": x, "y": [x]})
    assert copies[0] is copies[2]
    assert copies[1]["x"].device.type == "meta"
    assert torch.equal(copies[0]["x"], x) and torch.equal(copies[0]["y"][0],
                                                          x)


# --- isize_histogram ---

def _pairs_for_hist(seed, n=600, n_bins=1000):
    rng = np.random.default_rng(seed)
    p0 = rng.integers(0, 50_000, n).astype(np.int32)
    l0 = rng.integers(20, 120, n).astype(np.int32)
    l1 = rng.integers(20, 120, n).astype(np.int32)
    isz = rng.integers(0, n_bins + 3, n)
    # insert sizes at n_bins - 1, n_bins, n_bins + 1 and below 4
    isz[:6] = [n_bins - 1, n_bins, n_bins + 1, 0, 2, 3]
    left = rng.random(n) < 0.5
    p1 = np.where(left, p0 + isz - l1, p0 - isz + l0).astype(np.int32)
    p1 = np.maximum(p1, 0)
    q0 = rng.choice([0, 19, 20, 21, 37, 60], n).astype(np.int32)
    q1 = rng.choice([0, 19, 20, 21, 37, 60], n).astype(np.int32)
    return p0, p1, l0, l1, q0, q1


@pytest.mark.parametrize("seed", [31, 32, 33])
@pytest.mark.parametrize("shards", [None, 3])
def test_isize_histogram_matches_jax(seed, shards):
    args = _pairs_for_hist(seed)
    want = np.asarray(jmesh.isize_histogram(*args, n_bins=1000))
    mesh = None if shards is None else pmesh.make_mesh(shards, "cpu")
    got = pmesh.isize_histogram(*args, n_bins=1000, mesh=mesh)
    assert got.dtype == torch.int32 and got.device == CPU
    assert np.array_equal(got.numpy(), want)
    assert want.sum() > 0 and want[0] == 0


# --- AlnEngine(mesh=) ---

def _reads(d):
    return fastq.read_fastq_batch(fastq.iter_fastq(str(d / "r.fq")), 1000)


@pytest.fixture(scope="module")
def single(data):  # noqa: F811
    d, _ = data
    eng = AlnEngine(BwaIndex.load(str(d / "g.fa")), GapOpt(), "cpu",
                    **TIERS)
    return {per_read: eng.run_chunk(_reads(d), device_batch=64,
                                    per_read_semantics=per_read)
            for per_read in (False, True)}


@pytest.mark.parametrize("per_read", [False, True],
                         ids=["batch", "per_read"])
@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_engine_on_mesh_matches_single_device(data, single, shards,  # noqa
                                              per_read):
    d, want = data
    mesh = pmesh.make_mesh(shards, "cpu")
    eng = AlnEngine(BwaIndex.load(str(d / "g.fa")), GapOpt(), mesh=mesh,
                    **TIERS)
    assert eng.device == CPU and eng.mesh == mesh
    assert len(eng._ix) == 1
    res = eng.run_chunk(_reads(d), device_batch=64,
                        per_read_semantics=per_read)
    assert res == single[per_read]
    assert GapOpt().pack() + sai.pack_aln_block([a for a, _ in res]) == want
    assert eng.tier0_reads > 0 and eng.retry_reads > 0
    assert eng.tier0_reads + eng.retry_reads + eng.host_drain_reads == 96
    assert eng.hybrid_host_reads == 0


def test_mesh_turns_the_hybrid_off(data):  # noqa: F811
    d, _ = data
    eng = AlnEngine(BwaIndex.load(str(d / "g.fa")), GapOpt(),
                    mesh=pmesh.make_mesh(2, "cpu"))
    with pytest.raises(ValueError):
        eng.run_hybrid(_reads(d))
    with pytest.raises(ValueError):
        AlnEngine(BwaIndex.load(str(d / "g.fa")), GapOpt(), "meta",
                  mesh=pmesh.make_mesh(2, "cpu"))


def test_mesh_bam2bam_matches_single_device(made, sequential,  # noqa: F811
                                            tmp_path):
    """8 shards, 2 workers, chunk 32 on the `dist` set: the BAM bytes
    equal the sequential single-device run's.  Tier 0 is capped at 32
    iterations without a retry tier (the reads it flags go to the
    bit-exact host drain), so the case stays quick."""
    d = made("dist")
    eng = AlnEngine(BwaIndex.load(str(d / "g.fa")), GapOpt(),
                    mesh=pmesh.make_mesh(8, "cpu"), retry_stack_cap=256,
                    max_iters=32)
    got = _port_b2b(d, tmp_path / "mesh.bam", engine=eng, n_workers=2,
                    chunk_size=32)
    assert got == sequential
    assert eng.tier0_reads > 0


# --- entry.py ---

def test_dryrun_multichip_two_cpu_shards():
    out = entry.dryrun_multichip(2, "cpu", n_pairs=32, glen=20_000,
                                 chunk_size=16, n_workers=2)
    assert out["devices"] == ["cpu", "cpu"]
    assert out["alignments"] > 0 and out["hist_total"] > 0
    assert out["records"] == 64 and out["read_groups"] == 2


def test_entry_step_matches_jax():
    """The port's single-device step on the CPU against the JAX package's
    (__graft_entry__.py's `entry`, jitted on the CPU)."""
    import jax
    import __graft_entry__ as graft
    fn, args = entry.entry("cpu")
    jfn, jargs = graft.entry()
    got = [t.numpy() for t in fn(*args)]
    want = [np.asarray(x) for x in jax.jit(jfn)(*jargs)]
    assert np.array_equal(args[0].numpy(), jargs[1])
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[0].sum() > 0

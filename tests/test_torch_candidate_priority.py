"""The lsh and hybrid plans' candidate priority (``ops.candidate_priority``).

On the CPU: the plain version (``ref.candidate_priority_ref``) through
``stages.candidate_priorities`` against the JAX package's
``candidate_priorities`` at its edge cases (an external query, a query with
the table mask off, a query every column excludes, padding columns, lakes
whose width is not a multiple of 4), its priorities bit for bit against a
float32 restatement of the formula, the wrapper's argument checks, and the
executor's column norms kept across batches. On a card (``gpu`` marker):
``csrc/candidate_priority.cu`` equal to the plain version (``torch.equal``)
over kind x C x Q, inputs off 16-byte alignment, and one launch a pruned
batch through the executor. The JAX stage comes from a fixture of the CPU
tests; the ``gpu`` tests hold the kernel against the plain PyTorch version
only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.device import hashes_to_torch
from repro_torch.exec import stages
from repro_torch.exec.executor import Executor
from repro_torch.exec.plan import Planner, PlannerConfig
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.candidate_priority import candidate_priority_cuda
from repro_torch.kernels.lsh_probe import PAD_CORPUS

N_PAD = 3               # padding columns at the end of every lake here
F = 5                   # profile width of the CPU cases


# ---------------------------------------------------------------------------
# on the CPU: the plain version against the JAX stage
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_stage():
    from repro.exec import stages as jstages
    import jax.numpy as jnp
    return jstages, jnp


def _keyed_inputs(q: int, c: int, case: str, seed: int):
    """Band keys, profiles and column metadata for one edge case, as numpy
    arrays: (zq, qkeys, z, ckeys, cids, tids, tq, qid). Keys from a small
    range, so hits are frequent; profiles in multiples of 1/2 in [-2, 2], so
    the proxy's sums are exact in float32 in any order; the last N_PAD
    columns are padding (id -1, the corpus sentinel key); query 0 is external
    (qid -1), query 1 has the table mask off. ``all_excluded``: one table,
    and the last query excludes it."""
    r = np.random.default_rng(seed)
    qkeys = r.integers(0, 40, (q, 6)).astype(np.uint32)
    ckeys = r.integers(0, 40, (c, 6)).astype(np.uint32)
    zq = (r.integers(-4, 5, (q, F)) / 2).astype(np.float32)
    z = (r.integers(-4, 5, (c, F)) / 2).astype(np.float32)
    cids = np.arange(c, dtype=np.int64)
    cids[-N_PAD:] = -1
    ckeys[-N_PAD:] = PAD_CORPUS
    tids = (np.zeros(c) if case == "all_excluded" else np.arange(c) // 8).astype(np.int64)
    qid = r.choice(c - N_PAD, q, replace=False).astype(np.int64)
    qid[0] = -1
    tq = tids[np.maximum(qid, 0)]
    tq[1] = -1
    if case == "all_excluded":
        tq[:-1] = -1
        tq[-1] = 0
    return zq, qkeys, z, ckeys, cids, tids, tq, qid


def _port_priorities(kind, zq, qkeys, z, ckeys, cids, tids, tq, qid, znorm=None):
    return stages.candidate_priorities(
        kind, torch.from_numpy(zq), hashes_to_torch(qkeys, "cpu"), torch.from_numpy(z),
        hashes_to_torch(ckeys, "cpu"), *map(torch.from_numpy, (cids, tids, tq, qid)),
        znorm=znorm)


# (case, C): one table excluded by the last query; widths that are not a
# multiple of 4; a multiple of 4
EDGE_CASES = [("all_excluded", 70), ("ragged", 61), ("ragged", 97), ("tables", 64)]


@pytest.mark.parametrize("case,c", EDGE_CASES)
@pytest.mark.parametrize("kind", ["lsh", "hybrid"])
def test_plain_version_matches_the_jax_stage(jax_stage, case, c, kind):
    jstages, jnp = jax_stage
    args = _keyed_inputs(4, c, case, seed=c + len(kind))
    zq, qkeys, z, ckeys, cids, tids, tq, qid = args
    want = np.asarray(jstages.candidate_priorities(
        kind, jnp.asarray(zq), jnp.asarray(qkeys), jnp.asarray(z), jnp.asarray(ckeys),
        *(jnp.asarray(a.astype(np.int32)) for a in (cids, tids, tq, qid))))
    got = _port_priorities(kind, *args).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    if case == "all_excluded":
        assert np.isneginf(got[-1]).all()
    assert np.isneginf(got[:, -N_PAD:]).all()


def _formula(hit, g, znorm, cids, tids, tq, qid):
    """The priority restated element by element in numpy float32."""
    q, c = hit.shape
    prio = np.empty((q, c), np.float32)
    one, four = np.float32(1.0), np.float32(ref.LSH_PRIORITY_BOOST)
    for i in range(q):
        for j in range(c):
            excl = cids[j] < 0 or cids[j] == qid[i] or (tq[i] >= 0 and tids[j] == tq[i])
            if g is None:
                v = np.float32(0.0) if hit[i, j] > 0 else np.float32(-np.inf)
            else:
                p = g[i, j] - znorm[j]
                v = np.float32(hit[i, j]) * four + p / (one + np.abs(p))
            prio[i, j] = -np.inf if excl else v
    return prio


@pytest.mark.parametrize("case,c", EDGE_CASES)
@pytest.mark.parametrize("kind", ["lsh", "hybrid"])
def test_plain_version_bits_match_the_formula(case, c, kind):
    zq, qkeys, z, ckeys, cids, tids, tq, qid = _keyed_inputs(5, c, case, seed=3 * c)
    r = np.random.default_rng(c)
    hit = ops.lsh_probe(hashes_to_torch(qkeys, "cpu"), hashes_to_torch(ckeys, "cpu"))
    # real-valued proxies of the fill's magnitude, not only exact ones
    g = (r.normal(size=(5, c)) * 60).astype(np.float32) if kind == "hybrid" else None
    zn = r.uniform(0, 80, c).astype(np.float32) if kind == "hybrid" else None
    as_t = lambda a: None if a is None else torch.from_numpy(a)
    got = ops.candidate_priority(hit, as_t(g), as_t(zn),
                                 *map(torch.from_numpy, (cids, tids, tq, qid)))
    want = _formula(hit.numpy(), g, zn, cids, tids, tq, qid)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def _host_args(q=3, c=40):
    r = np.random.default_rng(0)
    tids = torch.arange(c) // 8
    qid = torch.tensor([-1, 5, 17])[:q]
    return dict(hit=torch.from_numpy((r.random((q, c)) < 0.1).astype(np.int32)),
                g=torch.from_numpy(r.normal(size=(q, c)).astype(np.float32)),
                znorm=torch.from_numpy(r.uniform(0, 9, c).astype(np.float32)),
                cids=torch.arange(c), tids=tids, tq=tids[qid.clamp(min=0)], qid=qid)


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view of the same shape that is not contiguous."""
    return torch.stack([t, t], -1)[..., 0]


BAD_ARGS = {
    "hit int64": (dict(hit=lambda a: a.to(torch.int64)), "hit must be torch.int32"),
    "hit 1-D": (dict(hit=lambda a: a[0]), "hit must be 2-D"),
    "hit strided": (dict(hit=_strided), "hit must be contiguous"),
    "g float64": (dict(g=lambda a: a.double()), "g must be torch.float32"),
    "g shape": (dict(g=lambda a: a[:, 1:]), "g has shape"),
    "g strided": (dict(g=_strided), "g must be contiguous"),
    "g device": (dict(g=lambda a: a.to("meta")), "g is on meta"),
    "g alone": (dict(znorm=lambda a: None), "g and znorm come together"),
    "znorm alone": (dict(g=lambda a: None), "g and znorm come together"),
    "znorm shape": (dict(znorm=lambda a: a[1:]), "znorm has shape"),
    "znorm float64": (dict(znorm=lambda a: a.double()), "znorm must be torch.float32"),
    "cids int32": (dict(cids=lambda a: a.to(torch.int32)), "cids must be torch.int64"),
    "tids shape": (dict(tids=lambda a: a[1:]), "tids has shape"),
    "tids strided": (dict(tids=_strided), "tids must be contiguous"),
    "tq shape": (dict(tq=lambda a: a[:2]), "tq has shape"),
    "qid int32": (dict(qid=lambda a: a.to(torch.int32)), "qid must be torch.int64"),
}


@pytest.mark.parametrize("bad", list(BAD_ARGS))
def test_wrapper_checks_its_arguments(bad):
    edits, message = BAD_ARGS[bad]
    args = _host_args()
    for name, edit in edits.items():
        args[name] = edit(args[name])
    with pytest.raises(ValueError, match=message):
        ops.candidate_priority(**args)


def test_wrapper_checks_the_card_and_takes_lsh_and_empty_batches():
    with pytest.raises(ValueError, match="hit must be a CUDA tensor"):
        candidate_priority_cuda(**_host_args())
    prio = ops.candidate_priority(**dict(_host_args(), g=None, znorm=None))
    assert prio.dtype == torch.float32 and prio.shape == (3, 40)
    assert set(prio.unique().tolist()) <= {0.0, float("-inf")}
    assert ops.candidate_priority(**_host_args(q=0)).shape == (0, 40)
    with pytest.raises(ValueError, match="unknown candidate kind"):
        stages.candidate_priorities("tiered", *(None,) * 8)


def _lake(c: int, seed: int):
    """(z, w, gbdt, tids, keys) of a small fp32 lake for the executor."""
    r = np.random.default_rng(seed)
    z = r.normal(size=(c, 21)).astype(np.float32)
    w = r.integers(0, 2 ** 32 - 1, (c, 11), dtype=np.uint64).astype(np.uint32)
    gbdt = (r.integers(0, 23, (4, 3)).astype(np.int32), r.normal(size=(4, 3)).astype(np.float32),
            r.normal(size=(4, 8)).astype(np.float32), 0.0)
    keys = r.integers(0, 50, (c, 64)).astype(np.uint32)
    return z, w, gbdt, np.arange(c, dtype=np.int32) // 8, keys


def _pruned_batch(ex, z, w, tids, keys, q: int, kind: str):
    plan = Planner(PlannerConfig(k=10)).plan(n_columns=z.shape[0], n_queries=q, mode="lsh")
    plan = dataclasses.replace(plan, candidates=kind)
    qids = np.arange(0, z.shape[0], z.shape[0] // q)[:q].astype(np.int32)
    return ex.execute(plan, z[qids], w[qids], tids[qids], qids, keys[qids])


def test_executor_keeps_the_column_norms(monkeypatch):
    """The hybrid plan computes the lake's norms once, on its first batch,
    and reuses them; the lsh plan needs none; the answers equal those of a
    stage that computes the norms itself."""
    z, w, gbdt, tids, keys = _lake(700, seed=2)
    ex = Executor(z, w, gbdt, table_ids=tids, band_keys=keys, device="cpu")
    calls = []
    norms = stages.column_norms
    monkeypatch.setattr(stages, "column_norms", lambda a: calls.append(1) or norms(a))
    _pruned_batch(ex, z, w, tids, keys, 8, "lsh")
    assert calls == [] and ex._znorm is None
    first = _pruned_batch(ex, z, w, tids, keys, 8, "hybrid")
    second = _pruned_batch(ex, z, w, tids, keys, 8, "hybrid")
    assert len(calls) == 1
    assert torch.equal(ex._znorm, norms(torch.from_numpy(z)))
    for a, b in zip(first, second):
        assert np.array_equal(a, b)
    monkeypatch.setattr(stages, "column_norms", norms)
    qz = torch.from_numpy(z[:8])
    cids = torch.arange(700)
    t = torch.from_numpy(tids.astype(np.int64))
    kept = stages.candidate_priorities("hybrid", qz, hashes_to_torch(keys[:8], "cpu"),
                                       torch.from_numpy(z), hashes_to_torch(keys, "cpu"),
                                       cids, t, t[:8], cids[:8], znorm=ex._znorm)
    own = stages.candidate_priorities("hybrid", qz, hashes_to_torch(keys[:8], "cpu"),
                                      torch.from_numpy(z), hashes_to_torch(keys, "cpu"),
                                      cids, t, t[:8], cids[:8])
    assert torch.equal(kept.view(torch.int32), own.view(torch.int32))
    ex.close()
    assert ex._znorm is None


# ---------------------------------------------------------------------------
# on a card: the kernel against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _device_args(q: int, c: int, seed: int, dev, *, one_table: bool = False):
    """(hit, g, znorm, cids, tids, tq, qid) drawn on ``dev``: 0/1 hits at 3%,
    g of scale 60 and norms in [0, 80) (the fill's magnitudes), N_PAD padding
    columns at the end, tables of 8 columns (or one table that the last query
    excludes), query 0 external, query 1 with the table mask off."""
    gen = torch.Generator(dev).manual_seed(seed)
    hit = (torch.rand((q, c), generator=gen, device=dev) < 0.03).to(torch.int32)
    g = torch.randn((q, c), generator=gen, device=dev) * 60
    zn = torch.rand((c,), generator=gen, device=dev) * 80
    cids = torch.arange(c, device=dev)
    cids[-N_PAD:] = -1
    tids = torch.zeros(c, dtype=torch.int64, device=dev) if one_table else cids.clamp(min=0) // 8
    qid = torch.randint(0, c - N_PAD, (q,), generator=gen, device=dev)
    qid[0] = -1
    tq = tids[qid.clamp(min=0)]
    if one_table:
        tq.fill_(-1)
        tq[-1] = 0
    elif q > 1:
        tq[1] = -1
    return hit, g, zn, cids, tids, tq, qid


def _equal_to_plain(args, kind: str) -> torch.Tensor:
    hit, g, zn, *rest = args
    if kind == "lsh":
        g = zn = None
    want = ref.candidate_priority_ref(hit, g, zn, *rest)
    got = ops.candidate_priority(hit, None if g is None else g.clone(), zn, *rest)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("c", [97, 4096, 4099, 1_048_576])
@pytest.mark.parametrize("q", [1, 5, 256])
@pytest.mark.parametrize("kind", ["lsh", "hybrid"])
def test_kernel_matches_plain(cuda, c, q, kind):
    _equal_to_plain(_device_args(q, c, seed=q * c, dev=cuda), kind)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [97, 4096])
@pytest.mark.parametrize("kind", ["lsh", "hybrid"])
def test_kernel_query_every_column_excludes(cuda, c, kind):
    got = _equal_to_plain(_device_args(5, c, seed=c, dev=cuda, one_table=True), kind)
    assert bool(torch.isneginf(got[-1]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("offset", ["hit", "g", "znorm"])
def test_kernel_takes_inputs_off_16_byte_alignment(cuda, offset):
    """A contiguous view 4 bytes off alignment leaves the 16-byte path for
    the one-column one."""
    args = list(_device_args(5, 4096, seed=9, dev=cuda))
    i = ("hit", "g", "znorm").index(offset)
    buf = torch.empty(args[i].numel() + 1, dtype=args[i].dtype, device=cuda)
    args[i] = buf[1:].view(args[i].shape).copy_(args[i])
    _equal_to_plain(tuple(args), "hybrid")


@pytest.mark.gpu
def test_kernel_writes_over_g(cuda):
    hit, g, zn, *rest = _device_args(5, 4096, seed=5, dev=cuda)
    assert ops.candidate_priority(hit, g, zn, *rest).data_ptr() == g.data_ptr()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["lsh", "hybrid"])
def test_one_launch_a_pruned_batch(cuda, kind):
    z, w, gbdt, tids, keys = _lake(5000, seed=4)
    ex = Executor(z, w, gbdt, table_ids=tids, band_keys=keys, device=cuda)
    for _ in range(2):
        before = _build.launch_counts["candidate_priority"]
        _pruned_batch(ex, z, w, tids, keys, 8, kind)
        assert _build.launch_counts["candidate_priority"] - before == 1

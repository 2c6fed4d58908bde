"""The tiered coarse pass's survivor priority and counts (``ops.coarse_priority``).

On the CPU: the plain version (``ref.coarse_priority_ref``) through
``stages.tiered_survivors`` against the JAX package's ``tiered_survivors`` at
its edge cases (a query every column excludes, ragged last blocks, a lake
narrower than a block, padding columns, no proxy), its priorities bit for bit
against a float32 restatement of the formula, and the wrapper's argument
checks. On a card (``gpu`` marker): ``csrc/coarse_priority.cu`` equal to the
plain version (``torch.equal`` on the priorities and both counts) over
block_c x C x Q x proxy, and one launch a tiered batch through the executor.
The JAX stage comes from a fixture of the CPU tests; the ``gpu`` tests hold the
kernel against the plain PyTorch version only.
"""
import numpy as np
import pytest
import torch

from repro_torch.device import hashes_to_torch
from repro_torch.exec import stages
from repro_torch.exec.executor import Executor
from repro_torch.exec.plan import Planner, PlannerConfig
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.coarse_priority import coarse_priority_cuda
from repro_torch.kernels.lsh_probe import PAD_CORPUS

N_PAD = 3               # padding columns at the end of every lake here


# ---------------------------------------------------------------------------
# on the CPU: the plain version against the JAX stage
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_stage():
    from repro.exec import stages as jstages
    import jax.numpy as jnp
    return jstages, jnp


def _keyed_inputs(q: int, c: int, case: str, seed: int):
    """Coarse keys and column metadata for one edge case, as numpy arrays:
    (qc, cc, cids, tids, tq, qid, proxy). Keys from a small range, so hits
    are frequent; the last N_PAD columns are padding (id -1, the corpus
    sentinel key); query 0 is external (qid -1), query 1 has the table mask
    off. ``all_excluded``: one table, and the last query excludes it."""
    r = np.random.default_rng(seed)
    qc = r.integers(0, 40, (q, 6)).astype(np.uint32)
    cc = r.integers(0, 40, (c, 6)).astype(np.uint32)
    cids = np.arange(c, dtype=np.int64)
    cids[-N_PAD:] = -1
    cc[-N_PAD:] = PAD_CORPUS
    tids = (np.zeros(c) if case == "all_excluded" else np.arange(c) // 8).astype(np.int64)
    qid = r.choice(c - N_PAD, q, replace=False).astype(np.int64)
    qid[0] = -1
    tq = tids[np.maximum(qid, 0)]
    tq[1] = -1
    if case == "all_excluded":
        tq[:-1] = -1
        tq[-1] = 0
    proxy = (r.normal(size=(q, c)) * 4).astype(np.float32)
    return qc, cc, cids, tids, tq, qid, proxy


# (case, C, block_c): one table excluded by the last query; ragged last
# blocks of 7 and 32; a lake narrower than one block; blocks of one column
EDGE_CASES = [("all_excluded", 70, 32), ("ragged", 61, 7), ("ragged", 97, 32),
              ("narrow", 20, 32), ("single", 40, 1)]


@pytest.mark.parametrize("case,c,block_c", EDGE_CASES)
@pytest.mark.parametrize("with_proxy", [True, False])
def test_plain_version_matches_the_jax_stage(jax_stage, case, c, block_c, with_proxy):
    jstages, jnp = jax_stage
    qc, cc, cids, tids, tq, qid, proxy = _keyed_inputs(4, c, case, seed=c + block_c)
    # the whole row as the budget: every position's order is compared
    jout = jstages.tiered_survivors(
        *map(jnp.asarray, (qc, cc, cids.astype(np.int32), tids.astype(np.int32),
                           tq.astype(np.int32), qid.astype(np.int32))),
        survivor_budget=c, block_c=block_c,
        proxy=jnp.asarray(proxy) if with_proxy else None)
    tout = stages.tiered_survivors(
        hashes_to_torch(qc, "cpu"), hashes_to_torch(cc, "cpu"),
        *map(torch.from_numpy, (cids, tids, tq, qid)), survivor_budget=c, block_c=block_c,
        proxy=torch.from_numpy(proxy) if with_proxy else None)
    for name, j, t in zip(("pos", "valid", "n_hits", "n_survivors"), jout, tout):
        assert np.array_equal(t.numpy(), np.asarray(j)), name
    if case == "all_excluded":
        assert not tout[1][-1].any() and int(tout[2][-1]) == int(tout[3][-1]) == 0


def _formula(hit, proxy, cids, tids, tq, qid, block_c: int):
    """The priority and counts restated element by element in numpy float32."""
    q, c = hit.shape
    prio = np.empty((q, c), np.float32)
    n_hits, n_surv = np.zeros(q, np.int64), np.zeros(q, np.int64)
    one, four = np.float32(1.0), np.float32(ref.LSH_PRIORITY_BOOST)
    for i in range(q):
        for j in range(c):
            b0 = j // block_c * block_c
            block_hit = bool((hit[i, b0:b0 + block_c] > 0).any())
            excl = cids[j] < 0 or cids[j] == qid[i] or (tq[i] >= 0 and tids[j] == tq[i])
            h = np.float32(hit[i, j])
            if proxy is None:
                v = (one if block_hit else np.float32(-np.inf)) + h
            else:
                p = proxy[i, j]
                v = ((four if block_hit else np.float32(0.0)) + h) + p / (one + np.abs(p))
            prio[i, j] = -np.inf if excl else v
            n_hits[i] += hit[i, j] > 0 and not excl
            n_surv[i] += block_hit and not excl
    return prio, n_hits, n_surv


@pytest.mark.parametrize("case,c,block_c", EDGE_CASES)
@pytest.mark.parametrize("with_proxy", [True, False])
def test_plain_version_bits_match_the_formula(case, c, block_c, with_proxy):
    qc, cc, cids, tids, tq, qid, proxy = _keyed_inputs(5, c, case, seed=3 * c + block_c)
    hit = ops.lsh_probe(hashes_to_torch(qc, "cpu"), hashes_to_torch(cc, "cpu"))
    args = (hit, torch.from_numpy(proxy) if with_proxy else None,
            *map(torch.from_numpy, (cids, tids, tq, qid)))
    prio, n_hits, n_surv = ops.coarse_priority(*args, block_c)
    want = _formula(hit.numpy(), proxy if with_proxy else None, cids, tids, tq, qid, block_c)
    assert np.array_equal(prio.numpy().view(np.uint32), want[0].view(np.uint32))
    assert np.array_equal(n_hits.numpy(), want[1]) and np.array_equal(n_surv.numpy(), want[2])


def _host_args(q=3, c=40):
    r = np.random.default_rng(0)
    tids = torch.arange(c) // 8
    qid = torch.tensor([-1, 5, 17])[:q]
    return dict(hit=torch.from_numpy((r.random((q, c)) < 0.1).astype(np.int32)),
                proxy=torch.from_numpy(r.normal(size=(q, c)).astype(np.float32)),
                cids=torch.arange(c), tids=tids, tq=tids[qid.clamp(min=0)], qid=qid)


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view of the same shape that is not contiguous."""
    return torch.stack([t, t], -1)[..., 0]


BAD_ARGS = {
    "hit int64": (dict(hit=lambda a: a.to(torch.int64)), "hit must be torch.int32"),
    "hit 1-D": (dict(hit=lambda a: a[0]), "hit must be 2-D"),
    "hit strided": (dict(hit=_strided), "hit must be contiguous"),
    "proxy float64": (dict(proxy=lambda a: a.double()), "proxy must be torch.float32"),
    "proxy shape": (dict(proxy=lambda a: a[:, 1:]), "proxy has shape"),
    "proxy strided": (dict(proxy=_strided), "proxy must be contiguous"),
    "proxy device": (dict(proxy=lambda a: a.to("meta")), "proxy is on meta"),
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
        ops.coarse_priority(**args, block_c=32)


def test_wrapper_checks_block_c_and_the_card():
    with pytest.raises(ValueError, match="block_c must be >= 1"):
        ops.coarse_priority(**_host_args(), block_c=0)
    with pytest.raises(ValueError, match="hit must be a CUDA tensor"):
        coarse_priority_cuda(**_host_args(), block_c=32)
    # the plain version takes no proxy, and empty batches
    prio, n_hits, n_surv = ops.coarse_priority(**dict(_host_args(), proxy=None), block_c=32)
    assert prio.dtype == torch.float32 and n_hits.dtype == n_surv.dtype == torch.int64
    prio, n_hits, _ = ops.coarse_priority(**_host_args(q=0), block_c=32)
    assert prio.shape == (0, 40) and n_hits.shape == (0,)


# ---------------------------------------------------------------------------
# on a card: the kernel against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _device_args(q: int, c: int, seed: int, dev, *, one_table: bool = False):
    """(hit, proxy, cids, tids, tq, qid) drawn on ``dev``: 0/1 hits at 3%,
    a proxy of scale 4, N_PAD padding columns at the end, tables of 8
    columns (or one table that the last query excludes), query 0 external,
    query 1 with the table mask off."""
    g = torch.Generator(dev).manual_seed(seed)
    hit = (torch.rand((q, c), generator=g, device=dev) < 0.03).to(torch.int32)
    proxy = torch.randn((q, c), generator=g, device=dev) * 4
    cids = torch.arange(c, device=dev)
    cids[-N_PAD:] = -1
    tids = torch.zeros(c, dtype=torch.int64, device=dev) if one_table else cids.clamp(min=0) // 8
    qid = torch.randint(0, c - N_PAD, (q,), generator=g, device=dev)
    qid[0] = -1
    tq = tids[qid.clamp(min=0)]
    if one_table:
        tq.fill_(-1)
        tq[-1] = 0
    elif q > 1:
        tq[1] = -1
    return hit, proxy, cids, tids, tq, qid


def _equal_to_plain(args, block_c: int) -> None:
    got = ops.coarse_priority(*args, block_c)
    want = ref.coarse_priority_ref(*args, block_c)
    torch.cuda.synchronize()
    for name, a, b in zip(("prio", "n_hits", "n_survivors"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("block_c", [32, 7])
@pytest.mark.parametrize("c", [97, 4096, 1_048_576])
@pytest.mark.parametrize("q", [1, 5, 256])
@pytest.mark.parametrize("with_proxy", [True, False])
def test_kernel_matches_plain(cuda, block_c, c, q, with_proxy):
    hit, proxy, *rest = _device_args(q, c, seed=q * c + block_c, dev=cuda)
    _equal_to_plain((hit, proxy if with_proxy else None, *rest), block_c)


@pytest.mark.gpu
@pytest.mark.parametrize("block_c", [32, 7])
@pytest.mark.parametrize("c", [97, 4096])
@pytest.mark.parametrize("with_proxy", [True, False])
def test_kernel_query_every_column_excludes(cuda, block_c, c, with_proxy):
    hit, proxy, *rest = _device_args(5, c, seed=c, dev=cuda, one_table=True)
    args = (hit, proxy if with_proxy else None, *rest)
    _equal_to_plain(args, block_c)
    prio, n_hits, n_surv = ops.coarse_priority(*args, block_c)
    assert bool(torch.isneginf(prio[-1]).all()) and int(n_hits[-1]) == int(n_surv[-1]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("offset", ["hit", "proxy"])
def test_kernel_takes_inputs_off_16_byte_alignment(cuda, offset):
    """A contiguous view 4 bytes off alignment leaves the 16-byte fast path
    for the general one, with block_c 32."""
    args = list(_device_args(5, 4096, seed=9, dev=cuda))
    i = 0 if offset == "hit" else 1
    buf = torch.empty(args[i].numel() + 1, dtype=args[i].dtype, device=cuda)
    args[i] = buf[1:].view(args[i].shape).copy_(args[i])
    _equal_to_plain(tuple(args), 32)


@pytest.mark.gpu
def test_one_launch_a_tiered_batch(cuda):
    r = np.random.default_rng(4)
    c, q = 5000, 8
    z = r.normal(size=(c, 21)).astype(np.float32)
    w = r.integers(0, 2 ** 32 - 1, (c, 11), dtype=np.uint64).astype(np.uint32)
    gbdt = (r.integers(0, 23, (4, 3)).astype(np.int32), r.normal(size=(4, 3)).astype(np.float32),
            r.normal(size=(4, 8)).astype(np.float32), 0.0)
    keys = r.integers(0, 50, (c, 64)).astype(np.uint32)
    coarse = r.integers(0, 50, (c, 16)).astype(np.uint32)
    tids = np.arange(c, dtype=np.int32) // 8
    ex = Executor(z, w, gbdt, table_ids=tids, band_keys=keys, coarse_keys=coarse,
                  profile_dtype="int8", device=cuda)
    plan = Planner(PlannerConfig(k=10)).plan(n_columns=c, n_queries=q, mode="tiered")
    qids = np.arange(0, c, c // q)[:q].astype(np.int32)
    before = _build.launch_counts["coarse_priority"]
    ex.execute(plan, z[qids], w[qids], tids[qids], qids, keys[qids], coarse[qids])
    assert _build.launch_counts["coarse_priority"] - before == 1

"""The port's top-k against ``jax.lax.top_k``: ``stages.topk_stable`` and its
plain version on seeded rows with ties, signed zeros, NaNs with payloads and
infinities; every top-k site of the discovery stages on the two inputs
where the earlier stable sort parted from JAX; the MoE router's gradient
through the gathered weights; the zero-query exact metrics; and, on a card
(``gpu`` marker), ``csrc/topk.cu`` bit-equal to ``ref.topk_ref`` at the
shapes of ``chip_smoke.py``'s phase 2 and under two host threads."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import pair
from repro.core import sketches as jsketches
from repro.exec import stages as jstages
from repro.exec.executor import _rescore_exact as jax_rescore_exact
from repro.models.moe import moe_ffn_local as jax_moe
from repro_torch.core import sketches
from repro_torch.core.predictor import gbdt_to_torch
from repro_torch.device import hashes_to_torch
from repro_torch.exec import stages
from repro_torch.exec.executor import _rescore_exact
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.topk import SORT_MAX, topk_cuda, topk_plan
from repro_torch.models.moe import moe_ffn_local

CPU = torch.device("cpu")
MOE_REL = 1e-5
# float32 bit patterns the rows draw from: signed zeros, infinities, quiet
# and signalling NaNs of both signs with payloads, and a few ordinary values
_SPECIAL = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                     0xFFC00000, 0x7FC00001, 0xFFC00005, 0x7F800001, 0xFF800003,
                     0x3F800000, 0xBF800000, 0x3F000000, 0x00000001, 0x80000001],
                    dtype=np.uint32).view(np.float32)
# ROADMAP §3's two rows: where the stable sort of the earlier port parted
# from jax.lax.top_k, and JAX's ids
SIGNED_ZEROS = (np.array([-0.0, 0.0, 0.5, -0.0, 0.0], np.float32), 3, [2, 1, 4])
SIGNED_NANS = (np.array([1.0, np.nan, -np.nan], np.float32), 3, [1, 0, 2])


def _rows(r: int, n: int, seed: int) -> np.ndarray:
    """(r, n) float32: per row one of ordinary draws, few distinct values
    (heavy ties), the special patterns, or a mix of all three."""
    g = np.random.default_rng(seed)
    out = np.empty((r, n), np.float32)
    for i in range(r):
        kind = i % 4
        if kind == 0:
            out[i] = g.normal(size=n)
        elif kind == 1:
            out[i] = g.choice(np.array([0.25, -1.0, 3.0], np.float32), n)
        elif kind == 2:
            out[i] = g.choice(_SPECIAL, n)
        else:
            out[i] = np.where(g.random(n) < 0.5, g.choice(_SPECIAL, n),
                              g.integers(-2, 3, n).astype(np.float32))
    return out


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _merged_ids(s: np.ndarray, pos, base: int) -> list:
    """The merge's ids of positions ``pos``: ``base + pos``, -1 where the
    score is not finite (a NaN slot comes back as padding)."""
    return [base + int(i) if np.isfinite(s[i]) else -1 for i in pos]


def _jax_top_k(x: np.ndarray, k: int):
    v, i = jax.lax.top_k(jnp.asarray(x), k)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("r,n,k", [(6, 40, 1), (6, 40, 40), (5, 33, 10), (4, 1, 1),
                                   (0, 7, 3), (3, 300, 128), (2, 5000, 17), (2, 5000, 5000)])
def test_topk_stable_matches_jax_top_k(r, n, k):
    """Ids and value bits of ``jax.lax.top_k``: total order over the bit
    patterns, ties to the lower index; k = 1 and k = N, one column, zero
    rows, and rows long enough for the kernel's select plan."""
    x = _rows(r, n, seed=r * 1000 + n + k)
    want_v, want_i = _jax_top_k(x, k)
    got_v, got_i = stages.topk_stable(torch.from_numpy(x), k)
    assert got_i.dtype == torch.int64 and tuple(got_i.shape) == (r, k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(_bits(got_v.numpy()), _bits(want_v))
    # the CPU path of the public entry point is the plain version
    assert torch.equal(ops.topk(torch.from_numpy(x), k), ref.topk_ref(torch.from_numpy(x), k))


def test_topk_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="float32"):
        ops.topk(torch.zeros(2, 3, dtype=torch.float64), 1)
    with pytest.raises(ValueError, match="0 <= k"):
        ops.topk(torch.zeros(2, 3), 4)


def test_topk_on_meta_allocates_the_kernels_buffers():
    """On meta (the dry run's traces) the positions come back shaped, and
    the kernel's scratch is allocated and freed, as its plan says."""
    from repro_torch.launch.dryrun import LiveBytes
    x = torch.empty((64, 100_000), device="meta")
    live = LiveBytes()
    with live:
        start = live.mark()
        pos = ops.topk(x, 10)
    plan = topk_plan(64, 100_000, 10)
    size = {name: int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
            for name, (shape, dt, _) in plan.buffers.items()}
    assert pos.device.type == "meta" and tuple(pos.shape) == (64, 10)
    assert pos.dtype == torch.int64
    assert live.peak - start == sum(size.values()) and live.live - start == size["pos"]


@pytest.mark.parametrize("r,n,k,regime", [(0, 9, 3, "none"), (3, 9, 0, "none"),
                                          (4608, 8, 2, "warp"), (64, 100_000, 10, "warp"),
                                          (64, 4_194_304, 100, "warp"),
                                          (3, SORT_MAX, SORT_MAX, "sort"),
                                          (64, 100_000, 4096, "select"),
                                          (64, 100_000, 8192, "select"),
                                          (3, 100_003, 100_003, "select")])
def test_topk_plan_allocations(r, n, k, regime):
    """The kernel's plan: its positions first, then its scratch, from the
    shape alone (the dry run counts the same buffers)."""
    plan = topk_plan(r, n, k)
    assert plan.regime == regime
    assert plan.buffers["pos"] == ((r, k), torch.int64, False)
    length = n
    for slices, slice_len in plan.passes:       # each pass's slices cover its input
        assert slices * slice_len >= length > (slices - 1) * slice_len
        length = slices * k
    if regime == "warp":
        assert plan.passes[-1][0] == 1
        want = {"pos"} | {"cand", "cand2"}.intersection(
            ("cand", "cand2")[:len(plan.passes) - 1])
        assert set(plan.buffers) == want
    if regime == "select":
        p = 1 << (k - 1).bit_length()           # the k words are sorted at p
        assert plan.p == p
        assert set(plan.buffers) == {"pos", "state", "hist", "cand"} | (
            {"cand2"} if p > SORT_MAX else set())
        assert plan.buffers["state"][2] and plan.buffers["hist"][0] == (r, plan.passes[0][0], 256)
        assert plan.buffers["cand"][0] == (r, k)
        if p > SORT_MAX:
            assert plan.buffers["cand2"][0] == (r, p)
    if regime == "sort":
        assert plan.p == 1 << (n - 1).bit_length() and set(plan.buffers) == {"pos"}


# ---------------------------------------------------------------------------
# the top-k sites against their JAX counterparts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [SIGNED_ZEROS, SIGNED_NANS], ids=["zeros", "nans"])
def test_merge_and_gather_match_jax(case):
    s, k, ids = case
    cids = np.arange(100, 100 + s.shape[0], dtype=np.int32)
    jsc, jids = jstages.merge_topk(jnp.asarray(s[None]), jnp.asarray(cids), k)
    sc, tids = stages.merge_topk(torch.from_numpy(s[None]), torch.from_numpy(cids.astype(np.int64)),
                                 k)
    assert np.asarray(jids)[0].tolist() == _merged_ids(s, ids, 100)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(_bits(sc.numpy()), _bits(jsc))
    np.testing.assert_array_equal(_bits(sc[0].numpy()), _bits(s[ids]))
    jpos, jvalid = jstages.gather_candidates(jnp.asarray(s[None]), k)
    pos, valid = stages.gather_candidates(torch.from_numpy(s[None]), k)
    assert pos[0].tolist() == ids
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("case", [SIGNED_ZEROS, SIGNED_NANS], ids=["zeros", "nans"])
@pytest.mark.parametrize("shards", [1, 2])
def test_merge_topk_sharded_matches_jax(case, shards):
    """JAX's merge over its tiled all_gathers (``vmap`` with a named axis
    stands in for the mesh) against the port's over the same tiles."""
    s, k, ids = case
    n = s.shape[0]
    cut = np.array_split(np.arange(n), shards)
    width = max(len(c) for c in cut)
    ts = np.full((shards, 2, width), -np.inf, np.float32)
    ti = np.full((shards, 2, width), -1, np.int32)
    for d, c in enumerate(cut):
        ts[d, :, :len(c)], ti[d, :, :len(c)] = s[c], c
    merge = jax.vmap(lambda a, b: jstages.merge_topk_sharded(a, b, k, ("data",)),
                     axis_name="data")
    jsc, jids = merge(jnp.asarray(ts), jnp.asarray(ti))
    tiles = [(torch.from_numpy(ts[d]), torch.from_numpy(ti[d].astype(np.int64)),
              torch.full((2,), len(cut[d]))) for d in range(shards)]
    sc, tids, n_scored = stages.merge_topk_sharded(tiles, k, (shards,), CPU)
    if shards == 1:         # split tiles pad with -inf, which outranks -NaN
        assert tids[0].tolist() == _merged_ids(s, ids, 0)
        np.testing.assert_array_equal(_bits(sc[0].numpy()), _bits(s[ids]))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids)[0])
    np.testing.assert_array_equal(_bits(sc.numpy()), _bits(np.asarray(jsc)[0]))
    assert n_scored.tolist() == [n, n]


@pytest.mark.parametrize("case", [SIGNED_ZEROS, SIGNED_NANS], ids=["zeros", "nans"])
def test_rescore_exact_matches_jax_on_signed_scores(case):
    """A depth-2 tree on the first two distance features gives each
    candidate the case's score exactly (base -0.0 plus its leaf), in both
    packages; the re-rank must order them as jax.lax.top_k does."""
    s, k, ids = case
    n = s.shape[0]
    leaf_of, leaves = {}, []
    for v in _bits(s):
        leaf_of.setdefault(int(v), len(leaf_of))
    leaves = np.zeros(4, np.uint32)
    for v, j in leaf_of.items():
        leaves[j] = v
    idx = np.array([leaf_of[int(v)] for v in _bits(s)])
    zq = np.zeros((1, 21), np.float32)
    zg = np.zeros((1, n, 21), np.float32)
    zg[0, :, 0], zg[0, :, 1] = idx & 1, idx >> 1
    wq = np.zeros((1, 11), np.uint32)
    wg = np.zeros((1, n, 11), np.uint32)
    g = (np.array([[0, 1]], np.int32), np.full((1, 2), 0.5, np.float32),
         leaves.view(np.float32)[None], float(np.float32(-0.0)))
    sc_scan = np.zeros((1, n), np.float32)
    cids = np.arange(200, 200 + n, dtype=np.int32)[None]
    jsc, jids = jax_rescore_exact(*map(jnp.asarray, (zq, wq, zg, wg)),
                                  tuple(map(jnp.asarray, g)), jnp.asarray(sc_scan),
                                  jnp.asarray(cids), k=k)
    sc, tids = _rescore_exact(torch.from_numpy(zq), hashes_to_torch(wq, "cpu"),
                              torch.from_numpy(zg), hashes_to_torch(wg, "cpu"),
                              gbdt_to_torch(g, "cpu"), torch.from_numpy(sc_scan),
                              torch.from_numpy(cids.astype(np.int64)), k)
    np.testing.assert_array_equal(_bits(np.asarray(jsc)), _bits(s[ids])[None])
    assert tids[0].tolist() == _merged_ids(s, ids, 200)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(_bits(sc.numpy()), _bits(np.asarray(jsc)))


def test_moe_router_gradient_through_the_gathered_weights_matches_jax():
    """The router's gradient flows through ``top_w`` (the values gathered at
    the top-k positions) as it does through JAX's ``top_k`` values."""
    jcfg, jparams, tcfg, model = pair("mixtral-8x22b")
    pm = jax.tree.map(lambda a: a[0], jparams["blocks"]["mlp"])
    r = np.random.default_rng(3)
    x = r.normal(size=(16, tcfg.d_model)).astype(np.float32)
    ct = r.normal(size=(16, tcfg.d_model)).astype(np.float32)
    want = jax.grad(lambda router: jnp.sum(
        jax_moe({**pm, "router": router}, jcfg, jnp.asarray(x), model_axis=None) * ct))(
        pm["router"])
    mlp = model.blocks[0].mlp
    mlp.router.requires_grad_(True)
    (moe_ffn_local(mlp, tcfg, torch.from_numpy(x)) * torch.from_numpy(ct)).sum().backward()
    got = mlp.router.grad.detach().numpy()
    want = np.asarray(want)
    # each entry sums T·d_model products in each package's float32 order,
    # and a few entries cancel to ~1e-3 of the largest: held at max |diff|
    # / max |grad|, tests/test_torch_dist.py's bound for the sharded MoE
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() / np.abs(want).max() < MOE_REL


# ---------------------------------------------------------------------------
# the zero-query exact metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 5])
def test_batch_exact_metrics_with_zero_queries_matches_jax(n):
    g = np.random.default_rng(n)
    kq = 4
    cv = np.sort(g.integers(0, 50, (n, kq)).astype(np.uint32), axis=1)
    cc = g.integers(1, 4, (n, kq)).astype(np.float32)
    card, rows = np.full(n, kq, np.int32), np.full(n, 9, np.int32)
    qv, qc = np.zeros((0, kq), np.uint32), np.zeros((0, kq), np.float32)
    qcard, qrows = np.zeros(0, np.int32), np.zeros(0, np.int32)
    want = jsketches.batch_exact_metrics(*map(jnp.asarray, (qv, qc, qcard, qrows,
                                                            cv, cc, card, rows)))
    got = sketches.batch_exact_metrics(
        hashes_to_torch(qv, "cpu"), torch.from_numpy(qc), torch.from_numpy(qcard),
        torch.from_numpy(qrows), hashes_to_torch(cv, "cpu"), torch.from_numpy(cc),
        torch.from_numpy(card), torch.from_numpy(rows))
    assert set(got) == set(want) == {"j_multi", "k", "jaccard", "containment"}
    for name, w in want.items():
        assert got[name].dtype == torch.float32 and tuple(got[name].shape) == (0, n)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the kernel on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_rows(r: int, n: int, kind: str, seed: int, dev) -> torch.Tensor:
    """chip_smoke.py's phase-2 rows: random, all equal, three-valued, all
    -inf, or the special patterns mixed with small integers."""
    g = np.random.default_rng(seed)
    if kind == "random":
        x = g.normal(size=(r, n)).astype(np.float32)
    elif kind == "equal":
        x = np.full((r, n), 0.75, np.float32)
    elif kind == "three":
        x = g.choice(np.array([0.0, -1.0, 2.0], np.float32), (r, n))
    elif kind == "neg_inf":
        x = np.full((r, n), -np.inf, np.float32)
    else:
        x = np.where(g.random((r, n)) < 0.5, g.choice(_SPECIAL, (r, n)),
                     g.integers(-2, 3, (r, n)).astype(np.float32))
    return torch.from_numpy(x).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [0, 1, 3, 64])
@pytest.mark.parametrize("n", [1, 2, 31, 33, 1000, 100_003])
def test_topk_kernel_equals_plain(cuda, r, n):
    """Positions (and so value bits) equal the plain version's at every k of
    phase 2 that fits the row, on every kind of row; a launch is counted
    exactly where one runs."""
    for kind in ("random", "equal", "three", "neg_inf", "special"):
        x = _card_rows(r, n, kind, seed=r * 7 + n, dev=cuda)
        for k in sorted({0, 1, 10, 40, 128, 2048, 4096, 8192, n}):
            if k > n:
                continue
            before = _build.launch_counts["topk"]
            got = topk_cuda(x, k)
            torch.cuda.synchronize()
            assert _build.launch_counts["topk"] - before == (1 if r and k else 0)
            want = ref.topk_ref(x, k)
            assert torch.equal(got, want), (kind, r, n, k)
            assert torch.equal(x.gather(1, got).view(torch.int32),
                               x.gather(1, want).view(torch.int32))


@pytest.mark.gpu
def test_topk_kernel_at_lsh_ties_and_long_rows(cuda):
    """The lsh stage's rows (a few 0.0 hits, every other column -inf) at the
    budget gathers' k, and positions past 2^22 in a 4.2M-column row."""
    g = np.random.default_rng(5)
    x = np.full((4, 100_000), -np.inf, np.float32)
    for i in range(4):
        x[i, g.choice(100_000, 37 * i, replace=False)] = 0.0
    x = torch.from_numpy(x).to(cuda)
    for k in (10, 2048, 4096, 8192):
        assert torch.equal(topk_cuda(x, k), ref.topk_ref(x, k))
    y = torch.randn(2, 4_194_304, device=cuda)
    y[:, -5:] = 1e6
    assert torch.equal(topk_cuda(y, 100), ref.topk_ref(y, 100))
    # rows in ascending and descending order: every word, or none after the
    # first k, enters the warp regime's list
    z = torch.arange(100_000, dtype=torch.float32, device=cuda).repeat(3, 1)
    z[1] = -z[1]
    z[2] = z[2] % 7
    for k in (1, 10, 100, 128, 129):
        assert torch.equal(topk_cuda(z, k), ref.topk_ref(z, k))


@pytest.mark.gpu
def test_topk_kernel_under_two_threads(cuda):
    """Two host threads calling the kernel at once, each on its own rows,
    get the plain positions every time: the scratch is per call."""
    xs = [_card_rows(64, 100_000, kind, seed=i, dev=cuda) for i, kind in
          enumerate(("random", "three"))]
    want = [ref.topk_ref(x, 40) for x in xs]
    errors = []

    def run(i):
        for _ in range(50):
            if not torch.equal(topk_cuda(xs[i], 40), want[i]):
                errors.append(i)
        torch.cuda.synchronize()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors


def test_dry_run_counts_the_kernels_allocations(tmp_path, monkeypatch):
    """The discovery cell's merge transient comes from the kernel's plan: a
    larger scratch in the plan raises the cell's temp bytes past it."""
    from repro_torch.launch import dryrun
    from repro_torch.kernels import topk as ktopk

    def cell():
        return dryrun.run_cell("freyja-discovery", "query", "single", out_dir=str(tmp_path),
                               mesh_override="4x1")["memory"]["temp_bytes"]

    base = cell()
    extra, plain_plan = 1 << 34, ktopk.topk_plan

    def padded(r, n, k):
        plan = plain_plan(r, n, k)
        return dataclasses.replace(plan, buffers={
            **plan.buffers, "spare": ((extra,), torch.int8, False)})

    monkeypatch.setattr(ktopk, "topk_plan", padded)
    assert base < extra < cell()

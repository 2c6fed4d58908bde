"""The port's model path against the JAX package on the CPU: the plain
versions of the profile_distance, gbdt_infer and quality_cdf kernels, the
quality metrics, the training pairs, the two-stage scorer, the two entry
points (``launch.discover``, ``launch.train_quality``), and the
``DiscoveryIndex`` / empty-``rank`` repairs."""
import dataclasses
import importlib.util
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.discover as jax_discover
from repro.core import GBDTConfig as JGBDTConfig
from repro.core import DiscoveryIndex as JDiscoveryIndex
from repro.core import generate_lake as jax_generate_lake
from repro.core import quality as jquality
from repro.core import rank as jax_rank
from repro.core import train_quality_model as jax_train
from repro.core.predictor import exact_jk as jax_exact_jk
from repro.core.predictor import pairwise_distances as jax_pairwise_distances
from repro.core.predictor import predict_scores_ref as jax_predict_scores_ref
from repro.kernels import ops as jops
from repro.kernels import ref as jax_ref
from repro.kernels.gbdt_infer import gbdt_infer_pallas
from repro.kernels.profile_distance import profile_distance_pallas
from repro_torch.convert import gbdt_from_jax, profiles_from_jax
from repro_torch.core import features as FT
from repro_torch.core import lakegen, quality
from repro_torch.core.discovery import DiscoveryIndex, rank
from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.predictor import (JoinQualityModel, gbdt_to_torch, label_pairs,
                                        predict_scores)
from repro_torch.core.profiles import lake_profiles
from repro_torch.device import hashes_to_torch
from repro_torch.kernels import ops, ref
from repro_torch.launch import discover as port_discover
from repro_torch.launch import train_quality as port_train_quality
from test_torch_discovery import SMALL_LAKE

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples", "train_quality_model.py")


def _gbdt(t, d, f, seed=0):
    r = np.random.default_rng(seed)
    return (r.integers(0, f, (t, d)).astype(np.int32),
            r.normal(size=(t, d)).astype(np.float32),
            r.normal(size=(t, 2 ** d)).astype(np.float32),
            float(np.float32(r.normal())))


# ---------------------------------------------------------------------------
# plain versions of the three kernels against the Pallas kernels
# (the shapes and tolerances of tests/test_kernels.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,n", [(1, 1), (3, 50), (8, 256), (11, 513)])
def test_profile_distance_matches_pallas(q, n):
    r = np.random.default_rng(q * 1000 + n)
    zq = r.normal(size=(q, FT.F_NUM)).astype(np.float32)
    zc = r.normal(size=(n, FT.F_NUM)).astype(np.float32)
    wq = r.integers(0, 30, (q, FT.F_WORDS)).astype(np.uint32)
    wc = r.integers(0, 30, (n, FT.F_WORDS)).astype(np.uint32)
    wq[0, :3] = FT.HASH_SENTINEL
    wc[::4, FT.FIRST_WORD] = wq[0, FT.FIRST_WORD]          # first-word hits
    want = profile_distance_pallas(*map(jnp.asarray, (zq, wq, zc, wc)),
                                   block_q=4, block_n=64, interpret=True)
    args = (torch.from_numpy(zq), hashes_to_torch(wq, "cpu"),
            torch.from_numpy(zc), hashes_to_torch(wc, "cpu"))
    got = ops.profile_distance(*args)
    assert got.shape == (q, n, FT.F_DIST)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert torch.equal(got, ref.profile_distance_ref(*args))


@pytest.mark.parametrize("n", [1, 7, 128, 1000, 4096])
@pytest.mark.parametrize("t,d", [(1, 1), (50, 5), (13, 6)])
def test_gbdt_infer_matches_pallas(n, t, d):
    r = np.random.default_rng(n + t)
    x = r.normal(size=(n, FT.F_DIST)).astype(np.float32)
    g = _gbdt(t, d, FT.F_DIST)
    x[::3, g[0][0, 0]] = g[1][0, 0]                       # features at a threshold
    want = gbdt_infer_pallas(*map(jnp.asarray, (x, *g[:3])), base=g[3],
                             block_n=256, interpret=True)
    got = ops.gbdt_infer(torch.from_numpy(x), gbdt_to_torch(g, "cpu"))
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# (N, F, T, D) of the adversarial ensembles: the distance tensor's width,
# an even width (the kernel's padded pitch), a narrow one, the deep (50, 8)
GBDT_ADVERSARIAL = [(1000, 23, 50, 5), (777, 24, 50, 8), (300, 5, 13, 6), (129, 23, 2, 1)]


def adversarial_rows(seed, n, f, t, d):
    """Rows and an ensemble that punish a flipped leaf: thresholds drawn
    from the rows' own values, 0.0 and -0.0; rows at 0.0, -0.0 and NaN; every
    third row exactly at one threshold, and that (feature, threshold) pair
    repeated in every third tree. Returns (x (n, f) f32, (feats, thrs,
    leaves, base)) as numpy."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, f)).astype(np.float32)
    x[::4] = np.round(x[::4], 1)                          # coarse values: ties
    x[1::6, ::2] = -0.0
    x[2::6, ::3] = 0.0
    x[5::7, 1::4] = np.nan
    feats = r.integers(0, f, (t, d)).astype(np.int32)
    pool = np.concatenate([np.float32([0.0, -0.0]), r.choice(x[np.isfinite(x)], 64)])
    thrs = r.choice(pool, (t, d)).astype(np.float32)
    feats[1::3, 0], thrs[1::3, 0] = feats[0, 0], thrs[0, 0]
    x[::3, feats[0, 0]] = thrs[0, 0]
    leaves = r.normal(size=(t, 1 << d)).astype(np.float32)
    return x, (feats, thrs, leaves, float(np.float32(r.normal())))


@pytest.mark.parametrize("n,f,t,d", GBDT_ADVERSARIAL)
def test_gbdt_infer_plain_matches_jax_oracle_on_adversarial_ensembles(n, f, t, d):
    """The kernel's plain version (which the CUDA kernel must equal bit for
    bit) against the JAX oracle at tests/test_kernels.py's tolerances, on
    ties, signed zeros and NaN features."""
    x, g = adversarial_rows(n + t, n, f, t, d)
    want = jax_ref.gbdt_infer_ref(*map(jnp.asarray, (x, *g[:3])), g[3])
    got = ops.gbdt_infer(torch.from_numpy(x), gbdt_to_torch(g, "cpu"))
    assert got.shape == (n,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(5,), (64,), (1000,), (7, 13)])
@pytest.mark.parametrize("s", [0.0, 0.25, 0.5])
def test_quality_cdf_matches_pallas(shape, s):
    r = np.random.default_rng(len(shape) * 100 + int(s * 4))
    j = r.uniform(0, 0.5, shape).astype(np.float32)
    k = r.uniform(0, 1, shape).astype(np.float32)
    want = jops.quality_cdf(j, k, strictness=s)
    p = quality.QualityParams()
    got = ops.quality_cdf(torch.from_numpy(j), torch.from_numpy(k), p.mu_j + s, p.sigma_j,
                          p.mu_k, p.sigma_k, p.lo, p.hi)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_quality_cdf_keeps_nan_and_clamps():
    """NaN passes the clamp (as torch.clamp and jnp.clip let it); values
    outside [lo, hi] clamp to 0 and 1."""
    j = torch.tensor([float("nan"), -1.0, 2.0, 0.3])
    k = torch.tensor([0.5, 0.5, 2.0, float("nan")])
    got = quality.continuous_quality(j, k)
    want = np.asarray(jquality.continuous_quality(jnp.asarray(j.numpy()),
                                                  jnp.asarray(k.numpy())))
    assert np.isnan(got.numpy()[[0, 3]]).all() and np.isnan(want[[0, 3]]).all()
    assert got[1] == 0.0 and got[2] == 1.0
    np.testing.assert_allclose(got[1:3].numpy(), want[1:3], atol=1e-6)


# ---------------------------------------------------------------------------
# the quality metrics
# ---------------------------------------------------------------------------

def test_metric_parameters_match():
    assert quality.STRICTNESS == jquality.STRICTNESS
    assert quality.DEFAULT_STRICTNESS == jquality.DEFAULT_STRICTNESS
    assert (dataclasses.asdict(quality.QualityParams())
            == dataclasses.asdict(jquality.QualityParams()))


def test_set_metrics_match():
    r = np.random.default_rng(3)
    n_a, n_b = r.integers(0, 500, 200), r.integers(0, 500, 200)
    card_a, card_b = r.integers(0, 300, 200), r.integers(0, 300, 200)
    inter = np.minimum(n_a, n_b) // 2
    inter_set = np.minimum(card_a, card_b) // 3
    n_a[:3] = n_b[:3] = card_a[:3] = card_b[:3] = 0       # empty columns
    t, j = (lambda a: torch.from_numpy(a.astype(np.int32))), jnp.asarray
    for got, want in [
        (quality.multiset_jaccard(t(inter), t(n_a), t(n_b)),
         jquality.multiset_jaccard(j(inter), j(n_a), j(n_b))),
        (quality.cardinality_proportion(t(card_a), t(card_b)),
         jquality.cardinality_proportion(j(card_a), j(card_b))),
        (quality.containment(t(inter_set), t(card_a)),
         jquality.containment(j(inter_set), j(card_a))),
        (quality.set_jaccard(t(inter_set), t(card_a), t(card_b)),
         jquality.set_jaccard(j(inter_set), j(card_a), j(card_b))),
    ]:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("levels", [2, 4, 6])
def test_discrete_quality_matches(levels):
    js = np.linspace(0, 0.5, 41, dtype=np.float32)
    ks = np.linspace(0, 1, 37, dtype=np.float32)
    got = quality.discrete_quality(torch.from_numpy(js)[:, None],
                                   torch.from_numpy(ks)[None, :], levels)
    want = jquality.discrete_quality(jnp.asarray(js)[:, None], jnp.asarray(ks)[None, :],
                                     levels)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("strictness", [0.0, 0.25, 0.5])
@pytest.mark.parametrize("params", [
    {}, dict(mu_k=0.3, sigma_j=0.25, sigma_k=0.2), dict(lo=0.1, hi=0.9)])
def test_continuous_quality_matches(strictness, params):
    r = np.random.default_rng(7)
    j = r.uniform(0, 0.5, (30, 40)).astype(np.float32)
    k = r.uniform(0, 1, (30, 40)).astype(np.float32)
    got = quality.continuous_quality(torch.from_numpy(j), torch.from_numpy(k), strictness,
                                     quality.QualityParams(**params))
    want = jquality.continuous_quality(jnp.asarray(j), jnp.asarray(k), strictness,
                                       jquality.QualityParams(**params))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_fit_truncated_gaussian_matches():
    r = np.random.default_rng(0)
    samples = np.clip(r.normal(0.4, 0.25, 3000), 0, 1)
    mus, sigmas = np.linspace(0.2, 0.6, 9), np.linspace(0.1, 0.4, 7)
    got = quality.fit_truncated_gaussian(samples, mus, sigmas)
    want = jquality.fit_truncated_gaussian(samples, mus, sigmas)
    assert (got["mu"], got["sigma"]) == (want["mu"], want["sigma"])
    assert got["w1"] == pytest.approx(want["w1"], abs=1e-6)


# ---------------------------------------------------------------------------
# training pairs and the two-stage scorer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_lake():
    return lakegen.generate_lake(lakegen.LakeSpec(**SMALL_LAKE))


@pytest.fixture(scope="module")
def jax_model(small_lake):
    return jax_train([small_lake], JGBDTConfig(n_trees=20, depth=4), n_query=48)


@pytest.mark.parametrize("strictness", [0.0, 0.25])
def test_label_pairs_match(small_lake, small_profiles, port_lake, strictness):
    qids = np.asarray([0, 5, 33, 120, 160])
    d, y = label_pairs(port_lake, profiles_from_jax(small_profiles), qids, strictness,
                       device="cpu")
    j, k = jax_exact_jk(small_lake, qids)
    want_y = jquality.continuous_quality(jnp.asarray(j), jnp.asarray(k), strictness)
    want_d = jax_pairwise_distances(small_profiles, qids)
    assert d.shape == (len(qids), small_lake.n_columns, FT.F_DIST)
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d), atol=1e-6, rtol=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-6, rtol=0)


def test_predict_scores_matches_ref_and_fused(small_profiles, jax_model):
    qids = np.arange(6)
    prof = profiles_from_jax(small_profiles)
    model = JoinQualityModel(gbdt=gbdt_from_jax(jax_model.gbdt))
    got = predict_scores(model, prof, qids, device="cpu")
    want = jax_predict_scores_ref(jax_model, small_profiles, qids)
    assert got.shape == (len(qids), prof.n_columns) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    z = torch.from_numpy(prof.zscored.astype(np.float32))
    w = hashes_to_torch(prof.words, "cpu")
    fused = ops.fused_score(z[qids], w[qids], z, w,
                            gbdt_to_torch(model.gbdt.astuple(), "cpu"))
    np.testing.assert_allclose(got, fused.numpy(), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the entry points against the JAX package's
# ---------------------------------------------------------------------------

def _run(monkeypatch, capsys, main, argv):
    monkeypatch.setattr(sys, "argv", argv)
    main()
    return capsys.readouterr().out


def _results(out: str):
    """The lines of a run that do not depend on timing."""
    p_at = re.findall(r"P@\s*(\d+) = ([0-9.]+)", out)
    names = [line for line in out.splitlines() if line.startswith("  q=")]
    return p_at, names


@pytest.mark.parametrize("model_from", ["trained", "loaded"])
def test_discover_matches_jax_entry_point(monkeypatch, capsys, tmp_path, jax_model,
                                          model_from):
    args = ["--tables", "12", "--domains", "5", "--queries", "6", "--k", "5"]
    if model_from == "loaded":
        jax_model.save(str(tmp_path / "m.npz"))
        args += ["--model", str(tmp_path / "m.npz")]
    else:
        args += ["--save-model", str(tmp_path / "saved.npz")]
    want = _run(monkeypatch, capsys, jax_discover.main, ["discover", *args])
    got = _run(monkeypatch, capsys, port_discover.main,
               ["discover", *args, "--device", "cpu"])
    p_at, names = _results(got)
    assert p_at and len(names) == 3
    assert (p_at, names) == _results(want)
    if model_from == "trained":
        saved = JoinQualityModel.load(str(tmp_path / "saved.npz"))
        assert saved.gbdt.n_trees == 50 and saved.gbdt.depth == 5


def _shrunk(generate):
    """``generate_lake`` at a quarter of the tables and half the domains."""
    def gen(spec):
        return generate(dataclasses.replace(spec, n_tables=spec.n_tables // 4,
                                            n_domains=spec.n_domains // 2))
    return gen


def test_train_quality_matches_jax_example(monkeypatch, capsys, tmp_path):
    spec = importlib.util.spec_from_file_location("train_quality_model_example", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    monkeypatch.setattr(example, "generate_lake", _shrunk(jax_generate_lake))
    monkeypatch.setattr(port_train_quality, "generate_lake",
                        _shrunk(lakegen.generate_lake))
    monkeypatch.chdir(tmp_path)
    want = _run(monkeypatch, capsys, example.main, ["train_quality_model.py"])
    got = _run(monkeypatch, capsys, port_train_quality.main,
               ["train_quality", "--device", "cpu", "--out", "port/model.npz"])
    p_at, _ = _results(got)
    assert [k for k, _ in p_at] == ["1", "3", "5", "10"]
    assert p_at == _results(want)[0]
    r2 = lambda out: float(re.search(r"R² = ([0-9.]+)", out).group(1))
    assert r2(got) == pytest.approx(r2(want), abs=2e-3)
    port, jax_m = (JoinQualityModel.load(p) for p in ("port/model.npz",
                                                      "artifacts/quality_model.npz"))
    assert np.array_equal(port.gbdt.feats, jax_m.gbdt.feats)
    np.testing.assert_allclose(port.gbdt.leaves, jax_m.gbdt.leaves, atol=1e-5)


# ---------------------------------------------------------------------------
# repairs: the DiscoveryIndex fields and rank over an empty index
# ---------------------------------------------------------------------------

def _tiny_model():
    return JoinQualityModel(gbdt=GBDTParams(*_gbdt(2, 2, FT.F_DIST)[:3], base=0.0))


def test_discovery_index_fields_match_jax():
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(DiscoveryIndex) == fields(JDiscoveryIndex)
    prof = lake_profiles(np.zeros((2, FT.F_NUM), np.float32),
                         np.zeros((2, FT.F_WORDS), np.uint32), np.ones((2,), np.int32))
    index = DiscoveryIndex(prof, _tiny_model(), ["a", "b"], np.asarray([0, 1]))
    assert index.names == ["a", "b"] and list(index.table_ids) == [0, 1]


def test_rank_on_an_empty_index_matches_jax():
    numeric = np.zeros((0, FT.F_NUM), np.float32)
    words = np.zeros((0, FT.F_WORDS), np.uint32)
    prof = lake_profiles(numeric, words, np.zeros((0,), np.int32))
    model = _tiny_model()
    got = rank(DiscoveryIndex(prof, model), np.asarray([0, 1]), k=3, device="cpu")
    want = jax_rank(JDiscoveryIndex(prof, model), np.asarray([0, 1]), k=3)
    for g, w in zip(got, want):
        assert g.shape == (2, 3) and g.dtype == np.asarray(w).dtype
        assert np.array_equal(g, np.asarray(w))
    assert np.isneginf(got[0]).all() and (got[1] == -1).all()

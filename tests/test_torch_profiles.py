"""The port's ingest side against the JAX package on the CPU: numpy copies
(hashing, lake generation, sketches), profiles, MinHash signing, LSH band
keys and the exact label metrics."""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.lakegen as jlakegen
from repro.core import ingest as jingest
from repro.core import quality as jquality
from repro.core.profiles import profile_lake as jax_profile_lake
from repro.core.sketches import batch_exact_metrics as jax_exact_metrics
from repro.service import catalog as jcatalog
from repro.service import lsh as jlsh
from repro_torch.core import ingest, lakegen, quality
from repro_torch.core.profiles import profile_lake
from repro_torch.core.sketches import batch_exact_metrics
from repro_torch.device import hashes_to_torch
from repro_torch.service import catalog, lsh

# numeric profile slots: float32 sums taken in another order than XLA's
NUM_RTOL, NUM_ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def scaled_lakes():
    spec = dict(n_columns=2000, seed=3)
    return (jlakegen.generate_scaled_lake(jlakegen.ScaledLakeSpec(**spec)),
            lakegen.generate_scaled_lake(lakegen.ScaledLakeSpec(**spec)))


def test_hashing_is_bit_identical():
    cells = ["", "a", "Paris", "São Paulo", "x" * 300, "42", "  padded  "]
    for s in cells:
        assert ingest.hash64(s) == jingest.hash64(s)
    h = np.array([jingest.hash64(s) for s in cells] + [np.uint64(0xFFFFFFFF)],
                 np.uint64)
    assert np.array_equal(ingest.fold32(h), jingest.fold32(h))
    cols = [("a", ["x", None, "y y", "x", ""]), ("b", ["1", "2", float("nan")])]
    jb, js = jingest.ingest_string_columns(cols, row_budget=4)
    tb, ts = ingest.ingest_string_columns(cols, row_budget=4)
    for f in ("values32", "char_len", "word_cnt", "n_rows", "table_ids"):
        assert np.array_equal(getattr(tb, f), getattr(jb, f)), f
    for a, b in zip(ts, js):
        assert np.array_equal(a.values, b.values) and np.array_equal(a.counts, b.counts)


def test_lake_generators_are_identical(scaled_lakes):
    spec = dict(n_domains=5, n_tables=8, row_budget=256, seed=11)
    jl = jlakegen.generate_lake(jlakegen.LakeSpec(**spec))
    tl = lakegen.generate_lake(lakegen.LakeSpec(**spec))
    for f in ("values32", "char_len", "word_cnt", "n_rows", "table_ids"):
        assert np.array_equal(getattr(tl.batch, f), getattr(jl.batch, f)), f
    for f in ("values", "counts", "card", "n_rows"):
        assert np.array_equal(getattr(tl.packed, f), getattr(jl.packed, f)), f
    assert np.array_equal(tl.domain, jl.domain) and np.array_equal(tl.gran, jl.gran)
    js, ts = scaled_lakes
    assert np.array_equal(ts.batch.values32, js.batch.values32)
    assert np.array_equal(ts.group, js.group) and np.array_equal(ts.tier, js.tier)
    assert np.array_equal(lakegen.select_scaled_queries(ts, 9),
                          jlakegen.select_scaled_queries(js, 9))
    assert np.array_equal(lakegen.select_queries(tl, 5), jlakegen.select_queries(jl, 5))


def _assert_profiles_match(got, want):
    assert np.array_equal(got.words, want.words)
    np.testing.assert_allclose(got.numeric, want.numeric, rtol=NUM_RTOL, atol=NUM_ATOL)
    np.testing.assert_allclose(got.mean, want.mean, rtol=NUM_RTOL, atol=NUM_ATOL)
    np.testing.assert_allclose(got.std, want.std, rtol=NUM_RTOL, atol=NUM_ATOL)
    assert np.array_equal(got.n_rows, want.n_rows)


def test_profile_lake_small_lake(small_lake, small_profiles):
    _assert_profiles_match(profile_lake(small_lake.batch, device="cpu"), small_profiles)


def test_profile_lake_scaled_lake(scaled_lakes):
    js, ts = scaled_lakes
    _assert_profiles_match(profile_lake(ts.batch, chunk=512, device="cpu"),
                           jax_profile_lake(js.batch))


def test_profile_words_break_count_ties_by_smaller_hash():
    """Equal counts keep the smaller hash first, as jax.lax.top_k does."""
    vals = np.array([[9, 7, 7, 5, 5, 3, 8, 1, 2, 4, 6, 10, 11, 9] + [0xFFFFFFFF] * 2],
                    np.uint32)
    batch = jingest.ColumnBatch(values32=vals, char_len=np.ones(vals.shape, np.float32),
                                word_cnt=np.ones(vals.shape, np.float32),
                                n_rows=np.array([14], np.int32), names=["c"],
                                table_ids=np.zeros(1, np.int32))
    got = profile_lake(batch, device="cpu")
    assert np.array_equal(got.words, jax_profile_lake(batch).words)
    assert list(got.words[0, :3]) == [5, 7, 9]


@pytest.mark.parametrize("source,cols,n_perm", [("scaled", slice(0, 37), 128),
                                                ("small", slice(3, 20), 64)])
def test_profile_and_sign_matches(small_lake, scaled_lakes, source, cols, n_perm):
    batch = scaled_lakes[1].batch if source == "scaled" else small_lake.batch
    idx = np.arange(batch.n_columns)[cols]
    sub = dataclasses.replace(batch, values32=batch.values32[idx],
                              char_len=batch.char_len[idx],
                              word_cnt=batch.word_cnt[idx], n_rows=batch.n_rows[idx],
                              names=[batch.names[i] for i in idx],
                              table_ids=batch.table_ids[idx])
    jn, jw, js = jcatalog.profile_and_sign(sub, n_perm=n_perm, seed=0)
    tn, tw, ts = catalog.profile_and_sign(sub, n_perm=n_perm, seed=0, chunk=16,
                                          device="cpu")
    assert ts.dtype == np.uint32 and tw.dtype == np.uint32
    assert np.array_equal(ts, js)
    assert np.array_equal(tw, jw)
    np.testing.assert_allclose(tn, jn, rtol=NUM_RTOL, atol=NUM_ATOL)


@pytest.mark.parametrize("p,b", [(128, 64), (128, 48), (64, 16), (7, 3), (32, 32)])
def test_band_keys_byte_identical(p, b):
    rng = np.random.default_rng(p * b)
    sigs = rng.integers(0, 2 ** 32, (50, p), dtype=np.uint64).astype(np.uint32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # remainder-fold notice
        got = lsh.band_keys(sigs, b)
        want = jlsh.band_keys(sigs, b)
        idx = lsh.LSHIndex.build(sigs, lsh.LSHConfig(n_bands=b))
    assert got.dtype == np.uint32
    assert np.array_equal(got, want)
    assert np.array_equal(idx.keys, want)
    hits = idx.hit_mask(idx.query_keys(sigs[:4]), device="cpu")
    assert (hits.numpy()[np.arange(4), np.arange(4)] == 1).all()


def test_continuous_quality_matches():
    rng = np.random.default_rng(0)
    j = rng.uniform(0, 0.5, 1000).astype(np.float32)
    k = rng.uniform(0, 1, 1000).astype(np.float32)
    for s in (0.0, 0.25, 0.5):
        want = np.asarray(jquality.continuous_quality(jnp.asarray(j), jnp.asarray(k), s))
        got = quality.continuous_quality(torch.from_numpy(j), torch.from_numpy(k), s)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_batch_exact_metrics_matches(small_lake):
    p = small_lake.packed
    q, c = np.arange(0, 12), np.arange(5, small_lake.n_columns)
    want = jax_exact_metrics(*(jnp.asarray(a[q]) for a in (p.values, p.counts, p.card, p.n_rows)),
                             *(jnp.asarray(a[c]) for a in (p.values, p.counts, p.card, p.n_rows)))
    t = lambda a, i: torch.from_numpy(np.asarray(a[i]))
    got = batch_exact_metrics(hashes_to_torch(p.values[q], "cpu"), t(p.counts, q),
                              t(p.card, q), t(p.n_rows, q),
                              hashes_to_torch(p.values[c], "cpu"), t(p.counts, c),
                              t(p.card, c), t(p.n_rows, c))
    for key in ("j_multi", "k", "jaccard", "containment"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)

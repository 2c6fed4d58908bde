"""The port's kernels: plain versions against the JAX package's Pallas kernels
(interpret mode) and oracles on the CPU, and the CUDA kernels against their
plain versions on a card (``gpu`` marker; skipped on a host without one)."""
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.exec import stages as jstages
from repro.kernels.lsh_probe import lsh_probe_gathered_pallas, lsh_probe_pallas
from repro.kernels.minhash import make_permutations as jax_make_permutations
from repro.kernels.minhash import minhash_pallas
from repro.kernels.profile_distance import dequantize as jax_dequantize
from repro.kernels.profile_distance import fused_score_pallas, fused_score_q_pallas
from repro.kernels import ref as jax_ref
from repro_torch.core import features as FT
from repro_torch.device import from_bits, hashes_to_numpy, hashes_to_torch, to_bits
from repro_torch.kernels import ops, ref
from repro_torch.kernels.lsh_probe import (PAD_CORPUS, PAD_QUERY, lsh_probe_cuda,
                                           lsh_probe_gathered_cuda)
from repro_torch.kernels.minhash import make_permutations
from repro_torch.kernels.profile_distance import quantize_profiles
from test_torch_model import GBDT_ADVERSARIAL, adversarial_rows

# scores: the tolerances of tests/test_kernels.py (float32 GBDT sums)
RTOL, ATOL = 1e-4, 1e-5


def _gbdt(t, d, seed):
    r = np.random.default_rng(seed)
    return (r.integers(0, FT.F_DIST, (t, d)).astype(np.int32),
            r.normal(size=(t, d)).astype(np.float32),
            r.normal(size=(t, 2 ** d)).astype(np.float32),
            float(np.float32(r.normal())))


def _profiles(r, lead, n_words=9):
    z = r.normal(size=(*lead, FT.F_NUM)).astype(np.float32)
    w = r.integers(0, n_words, (*lead, FT.F_WORDS)).astype(np.uint32)
    w.reshape(-1, FT.F_WORDS)[::3, :4] = FT.HASH_SENTINEL   # sentinel slots
    return z, w


def _torch_gbdt(g, device="cpu"):
    feats, thrs, leaves, base = g
    return (torch.from_numpy(feats).to(device), torch.from_numpy(thrs).to(device),
            torch.from_numpy(leaves).to(device), base)


def _torch_inputs(zq, wq, zc, wc, device="cpu"):
    return (torch.from_numpy(zq).to(device), hashes_to_torch(wq, device),
            torch.from_numpy(zc).to(device), hashes_to_torch(wc, device))


@pytest.mark.parametrize("q,n,t,d", [(2, 64, 10, 4), (5, 300, 50, 5),
                                     (3, 17, 13, 6)])
def test_fused_score_shared_matches_pallas(q, n, t, d):
    r = np.random.default_rng(q * 1000 + n)
    zq, wq = _profiles(r, (q,))
    zc, wc = _profiles(r, (n,))
    g = _gbdt(t, d, seed=t)
    want = fused_score_pallas(*map(jnp.asarray, (zq, wq, zc, wc)),
                              *map(jnp.asarray, g[:3]), base=g[3],
                              block_q=4, block_n=128, interpret=True)
    got = ref.fused_score_ref(*_torch_inputs(zq, wq, zc, wc), *_torch_gbdt(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the CPU path of the public entry point is the plain version
    via_ops = ops.fused_score(*_torch_inputs(zq, wq, zc, wc), _torch_gbdt(g))
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("q,m,t,d", [(3, 40, 50, 5), (6, 9, 10, 4)])
def test_fused_score_gathered_matches_score_columns(q, m, t, d):
    r = np.random.default_rng(q * 100 + m)
    zq, wq = _profiles(r, (q,))
    zc, wc = _profiles(r, (q, m))
    g = _gbdt(t, d, seed=d)
    want = jstages.score_columns(*map(jnp.asarray, (zq, wq, zc, wc)),
                                 tuple(map(jnp.asarray, g)))
    got = ops.fused_score(*_torch_inputs(zq, wq, zc, wc), _torch_gbdt(g))
    assert got.shape == (q, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p,seed", [(16, 0), (128, 3), (7, 11)])
def test_make_permutations_bit_exact(p, seed):
    ja, jb = jax_make_permutations(p, seed)
    a, b = make_permutations(p, seed)
    assert a.dtype == np.uint32 and b.dtype == np.uint32
    assert np.array_equal(a, np.asarray(ja)) and np.array_equal(b, np.asarray(jb))


def _minhash_values(c, r, layout, seed):
    """(C, R) uint32 values at full width (the products wrap around 2^32)
    with sentinel cells laid out as ``layout`` names."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2 ** 32 - 1, (c, r), dtype=np.uint64).astype(np.uint32)
    if layout == "half":            # the back half of column 0
        vals[0, r // 2:] = FT.HASH_SENTINEL
    elif layout == "first_row":     # row 0 of every column; column 0's first 40
        vals[:, 0] = FT.HASH_SENTINEL
        vals[0, :40] = FT.HASH_SENTINEL
    elif layout == "scattered":     # ~30% of the cells anywhere
        vals[rng.random((c, r)) < 0.3] = FT.HASH_SENTINEL
    elif layout == "dead_column":   # one column without a valid cell
        vals[c // 2] = FT.HASH_SENTINEL
    elif layout == "all_dead":      # no valid cell anywhere
        vals[:] = FT.HASH_SENTINEL
    elif layout == "padded":        # ingest's padding: a random length each, 0 included
        n_real = rng.integers(0, r + 1, c)
        n_real[0] = 0
        vals[np.arange(r)[None, :] >= n_real[:, None]] = FT.HASH_SENTINEL
    else:
        raise ValueError(layout)
    return vals


@pytest.mark.parametrize("c,r,p,layout", [
    pytest.param(1, 10, 16, "half", id="1-10-16"),
    pytest.param(7, 700, 64, "half", id="7-700-64"),
    pytest.param(16, 1024, 128, "half", id="16-1024-128"),
    (8, 64, 16, "first_row"), (13, 300, 32, "scattered"), (9, 128, 16, "dead_column"),
    (5, 40, 8, "all_dead"), (10, 1000, 24, "scattered"), (11, 1000, 16, "padded"),
    (3, 33, 7, "first_row")])
def test_minhash_matches_pallas(c, r, p, layout):
    """The plain version against the Pallas kernel (4 x 128 blocks, so R =
    1000 spans eight row blocks and C = 13 a ragged column block)."""
    vals = _minhash_values(c, r, layout, seed=c + r + p)
    a, b = make_permutations(p, seed=3)
    want = minhash_pallas(jnp.asarray(vals), jnp.asarray(a), jnp.asarray(b),
                          block_c=4, block_r=128, interpret=True)
    got = ops.minhash(hashes_to_torch(vals, "cpu"), hashes_to_torch(a, "cpu"),
                      hashes_to_torch(b, "cpu"))
    assert np.array_equal(hashes_to_numpy(got), np.asarray(want))


def test_minhash_row_steps_do_not_change_signatures(monkeypatch):
    """The plain version's bounded row steps give the one-step result."""
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 2 ** 32 - 1, (5, 300), dtype=np.uint64).astype(np.uint32)
    a, b = (hashes_to_torch(x, "cpu") for x in make_permutations(32, seed=1))
    v = hashes_to_torch(vals, "cpu")
    whole = ref.minhash_ref(v, a, b)
    monkeypatch.setattr(ref, "_MINHASH_ELEMS", 5 * 32 * 7)   # 7 rows a step
    assert torch.equal(ref.minhash_ref(v, a, b), whole)


@pytest.mark.parametrize("q,c,b", [(1, 1, 4), (3, 100, 16), (8, 512, 64),
                                   (11, 777, 32)])
def test_lsh_probe_matches_pallas(q, c, b):
    rng = np.random.default_rng(q * c + b)
    qk = rng.integers(0, 50, (q, b)).astype(np.uint32)     # small key space
    ck = rng.integers(0, 50, (c, b)).astype(np.uint32)     # -> plenty of hits
    ck[-1, 0] = qk[0, 0]                                   # guaranteed hit
    qk[-1, -1] = PAD_QUERY
    ck[0, -1] = PAD_CORPUS
    want = lsh_probe_pallas(jnp.asarray(qk), jnp.asarray(ck), block_q=4,
                            block_c=128, interpret=True)
    got = ops.lsh_probe(hashes_to_torch(qk, "cpu"), hashes_to_torch(ck, "cpu"))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.any()


def _gathered_keys(q, c, b, seed):
    rng = np.random.default_rng(seed)
    qk = rng.integers(0, 50, (q, b)).astype(np.uint32)
    ck = rng.integers(0, 50, (q, c, b)).astype(np.uint32)
    ck[:, ::3] = PAD_CORPUS                                # padded survivor rows
    if c > 1:
        ck[0, 1, 0] = qk[0, 0]                             # a hit, unless q == 1
    qk[-1, :] = PAD_QUERY                                  # a padded query row
    return qk, ck


@pytest.mark.parametrize("q,c,b", [(1, 1, 16), (3, 300, 16), (5, 257, 64),
                                   (2, 513, 64)])
def test_lsh_probe_gathered_matches_pallas(q, c, b):
    qk, ck = _gathered_keys(q, c, b, seed=q * c + b)
    want = lsh_probe_gathered_pallas(jnp.asarray(qk), jnp.asarray(ck), block_q=2,
                                     block_c=256, interpret=True)
    got = ops.lsh_probe_gathered(hashes_to_torch(qk, "cpu"), hashes_to_torch(ck, "cpu"))
    assert got.dtype == torch.int32 and got.shape == (q, c)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert bool(got.any()) == (q > 1 and c > 1)
    assert not got[-1].any() and not got[:, ::3].any()


def _indexed_keys(q, c, n, b, seed):
    """A resident (N, B) table with padded rows, (Q, B) query keys with a
    padded query, and (Q, C') positions into the table: repeated within a
    query and across queries, some negative (counted from the end, as torch
    and numpy indexing do), and one planted hit."""
    rng = np.random.default_rng(seed)
    qk = rng.integers(0, 50, (q, b)).astype(np.uint32)
    table = rng.integers(0, 50, (n, b)).astype(np.uint32)
    table[::4] = PAD_CORPUS
    pos = rng.integers(0, n, (q, c)).astype(np.int64)
    pos[:, 1::3] = pos[:, :1]                              # repeats within a query
    pos[-1, ::2] = pos[0, ::2]                             # ... and across queries
    pos[:, 2::7] -= n                                      # negative positions
    if c > 0:
        table[pos[0, 0], 0] = qk[0, 0]                     # a hit, unless q == 1
    if q > 1:
        qk[-1] = PAD_QUERY
    return qk, table, pos


@pytest.mark.parametrize("q,c,n", [(3, 200, 50), (1, 33, 40), (2, 0, 10)])
@pytest.mark.parametrize("b", [1, 7, 16, 64])
def test_lsh_probe_gathered_indexed_matches_pallas(b, q, c, n):
    """The indexed form, ``ops.lsh_probe_gathered(qkeys, table, pos)``,
    equals the Pallas kernel over the gathered rows ``table[pos]``."""
    qk, table, pos = _indexed_keys(q, c, n, b, seed=b * 100 + c)
    got = ops.lsh_probe_gathered(hashes_to_torch(qk, "cpu"), hashes_to_torch(table, "cpu"),
                                 torch.from_numpy(pos))
    assert got.dtype == torch.int32 and got.shape == (q, c)
    want = np.zeros((q, 0), np.int32) if c == 0 else np.asarray(
        lsh_probe_gathered_pallas(jnp.asarray(qk), jnp.asarray(table[pos]), block_q=2,
                                  block_c=256, interpret=True))
    assert np.array_equal(got.numpy(), want)
    assert bool(got.any()) == (c > 0)                      # the planted hit
    assert not got.numpy()[table[pos][..., 0] == PAD_CORPUS].any()
    assert q == 1 or not got[-1].any()                     # the padded query
    # one function, two forms: the gathered rows give the same mask
    gathered = ops.lsh_probe_gathered(hashes_to_torch(qk, "cpu"),
                                      hashes_to_torch(table[pos], "cpu"))
    assert torch.equal(got, gathered)


@pytest.mark.parametrize("bad", ["past_end", "before_start"])
def test_lsh_probe_gathered_indexed_rejects_out_of_range_positions(bad):
    """A position outside [-N, N) raises as ``table[pos]`` does; it never
    reads as a miss."""
    qk, table, pos = _indexed_keys(2, 30, 20, 16, seed=5)
    pos[1, 7] = 20 if bad == "past_end" else -21
    with pytest.raises(IndexError):
        ops.lsh_probe_gathered(hashes_to_torch(qk, "cpu"), hashes_to_torch(table, "cpu"),
                               torch.from_numpy(pos))


def _wide_keys(q, c, b, seed, gathered):
    """Keys drawn from a few values on both sides of 2^31 (so bit-views are
    negative), with both sentinels: a padded query row, padded corpus rows."""
    rng = np.random.default_rng(seed)
    pool = np.uint32([3, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 5, 0xFFFFFFF0, PAD_CORPUS])
    qk = rng.choice(pool[:-1], (q, b)).astype(np.uint32)
    ck = rng.choice(pool, (q, c, b) if gathered else (c, b)).astype(np.uint32)
    qk[-1] = PAD_QUERY
    ck[..., ::4, :] = PAD_CORPUS
    return qk, ck


@pytest.mark.parametrize("q_form,c_form", [("u32", "u32"), ("bits", "bits"),
                                           ("u32", "bits"), ("bits", "u32")])
@pytest.mark.parametrize("gathered", [False, True])
def test_lsh_probes_take_int64_and_bit_view_keys(gathered, q_form, c_form):
    """The ops give the same mask for int64 keys holding uint32 values,
    int32 bit-views (the executor's resident form) and one of each: keys at
    and above 2^31 and both sentinels included, held against the Pallas
    kernel in interpret mode."""
    q, c, b = 5, 300, 16
    qk, ck = _wide_keys(q, c, b, seed=q_form == "bits", gathered=gathered)
    form = {"u32": lambda a: hashes_to_torch(a, "cpu"),
            "bits": lambda a: to_bits(hashes_to_torch(a, "cpu"))}
    qt, ct = form[q_form](qk), form[c_form](ck)
    if gathered:
        got = ops.lsh_probe_gathered(qt, ct)
        want = lsh_probe_gathered_pallas(jnp.asarray(qk), jnp.asarray(ck), block_q=2,
                                         block_c=128, interpret=True)
    else:
        got = ops.lsh_probe(qt, ct)
        want = lsh_probe_pallas(jnp.asarray(qk), jnp.asarray(ck), block_q=4, block_c=128,
                                interpret=True)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got[-1].any()
    assert not got[..., ::4].any()


def _quantized(r, lead, dtype):
    """(sidecar, scale, words) of random profiles quantized as one matrix."""
    z, w = _profiles(r, lead)
    side, scale = quantize_profiles(z.reshape(-1, FT.F_NUM), dtype)
    return side.reshape(z.shape), scale, w


@pytest.mark.parametrize("q,n,t,d", [(2, 64, 10, 4), (5, 300, 50, 5), (3, 17, 13, 6)])
@pytest.mark.parametrize("dtype", ["int8", "fp16"])
def test_fused_score_q_shared_matches_pallas(dtype, q, n, t, d):
    r = np.random.default_rng(q * 1000 + n)
    zq, wq = _profiles(r, (q,))
    zc, scale, wc = _quantized(r, (n,), dtype)
    g = _gbdt(t, d, seed=t)
    want = fused_score_q_pallas(*map(jnp.asarray, (zq, wq, zc, scale, wc)),
                                *map(jnp.asarray, g[:3]), base=g[3], block_q=4,
                                block_n=128, interpret=True)
    args = (torch.from_numpy(zq), hashes_to_torch(wq, "cpu"), torch.from_numpy(zc),
            torch.from_numpy(scale), hashes_to_torch(wc, "cpu"))
    got = ops.fused_score_q(*args, _torch_gbdt(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert torch.equal(got, ref.fused_score_q_ref(*args, *_torch_gbdt(g)))


@pytest.mark.parametrize("q,m,t,d", [(3, 40, 50, 5), (6, 9, 10, 4)])
@pytest.mark.parametrize("dtype", ["int8", "fp16"])
def test_fused_score_q_gathered_matches_score_columns(dtype, q, m, t, d):
    r = np.random.default_rng(q * 100 + m)
    zq, wq = _profiles(r, (q,))
    zc, scale, wc = _quantized(r, (q, m), dtype)
    g = _gbdt(t, d, seed=d)
    want = jstages.score_columns(jnp.asarray(zq), jnp.asarray(wq),
                                 jax_dequantize(jnp.asarray(zc), jnp.asarray(scale)),
                                 jnp.asarray(wc), tuple(map(jnp.asarray, g)))
    got = ops.fused_score_q(torch.from_numpy(zq), hashes_to_torch(wq, "cpu"),
                            torch.from_numpy(zc), torch.from_numpy(scale),
                            hashes_to_torch(wc, "cpu"), _torch_gbdt(g))
    assert got.shape == (q, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_kernel_bit_views_are_contiguous():
    """A column slice of a numpy array (the coarse digest's sampled rows)
    arrives with Fortran strides; the kernels' int32 views are contiguous."""
    keys = np.arange(24, dtype=np.uint32).reshape(4, 6)[:, [0, 2, 4]]
    t = hashes_to_torch(keys, "cpu")
    assert not t.is_contiguous()
    bits = to_bits(t)
    assert bits.is_contiguous() and bits.dtype == torch.int32
    assert torch.equal(from_bits(bits), t)


def test_ops_refuse_a_device_without_kernel_or_plain_version():
    t = torch.zeros((2, FT.F_WORDS), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.lsh_probe(t, t)


def _adversarial(seed, q, lead, t, d, dtype):
    """Inputs and an ensemble that punish a flipped leaf: thresholds taken
    from the pairs' own feature values (0.0, -0.0, the overlap steps k/10,
    1.0, exact |dz| values, |dz| = 0 planted), one (feature, threshold)
    repeated across trees, a query with NaN numeric slots. Returns (zq, wq,
    sidecar, scale, wc, gbdt); the sidecar is float32 for ``fp32``."""
    r = np.random.default_rng(seed)
    zq, wq = _profiles(r, (q,), n_words=12)
    zc, wc = _profiles(r, lead, n_words=12)
    wq[::2, 5:8] = FT.HASH_SENTINEL
    zc.reshape(-1, FT.F_NUM)[::5, 3] = zq[0, 3]
    zq[-1, ::4] = np.nan
    side, scale = quantize_profiles(zc.reshape(-1, FT.F_NUM), dtype)
    side = side.reshape(zc.shape)
    x = ref.profile_distance_ref(*_torch_inputs(zq, wq, _dequantized(side, scale), wc))
    x = x.numpy().reshape(-1, FT.F_DIST)
    steps = np.arange(11, dtype=np.float32) / np.float32(10)
    feats = r.integers(0, FT.F_DIST, (t, d)).astype(np.int32)
    thrs = np.empty((t, d), np.float32)
    for k, f in np.ndenumerate(feats):
        vals = x[:, f][np.isfinite(x[:, f])]
        if f == FT.F_NUM:
            pool = steps
        elif f == FT.F_NUM + 1:
            pool = np.float32([0.0, -0.0, 1.0])
        else:
            pool = np.concatenate([np.float32([0.0, -0.0]), r.choice(vals, 4)])
        thrs[k] = r.choice(pool)
    feats[1::3, 0], thrs[1::3, 0] = feats[0, 0], thrs[0, 0]
    leaves = r.normal(size=(t, 2 ** d)).astype(np.float32)
    return zq, wq, side, scale, wc, (feats, thrs, leaves, float(np.float32(r.normal())))


def _dequantized(side, scale):
    return side if side.dtype == np.float32 else side.astype(np.float32) * scale


def _plain_scores(zq, wq, side, scale, wc, g, device="cpu"):
    """The plain scorer of the sidecar's dtype (fused_score_ref for float32)."""
    zq_t, wq_t, zc_t, wc_t = _torch_inputs(zq, wq, side, wc, device)
    if side.dtype == np.float32:
        return ref.fused_score_ref(zq_t, wq_t, zc_t, wc_t, *_torch_gbdt(g, device))
    return ref.fused_score_q_ref(zq_t, wq_t, zc_t, torch.from_numpy(scale).to(device), wc_t,
                                 *_torch_gbdt(g, device))


# (Q, corpus lead shape, T, D): shared and gathered, (50, 8) among them
ADVERSARIAL = [(5, (300,), 50, 5), (4, (4, 77), 50, 8), (3, (40,), 13, 6)]


@pytest.mark.parametrize("q,lead,t,d", ADVERSARIAL)
@pytest.mark.parametrize("dtype", ["fp32", "int8", "fp16"])
def test_plain_scorers_match_jax_oracle_on_adversarial_ensembles(dtype, q, lead, t, d):
    zq, wq, side, scale, wc, g = _adversarial(t * d + len(lead), q, lead, t, d, dtype)
    got = _plain_scores(zq, wq, side, scale, wc, g).numpy()
    zf = _dequantized(side, scale)
    oracle = lambda zq_, wq_, zc_, wc_, thrs: np.asarray(jax_ref.fused_score_ref(
        *map(jnp.asarray, (zq_, wq_, zc_, wc_, g[0], thrs, g[2])), g[3]))
    if len(lead) == 1:
        want = oracle(zq, wq, zf, wc, g[1])
    else:
        want = np.concatenate([oracle(zq[i:i + 1], wq[i:i + 1], zf[i], wc[i], g[1])
                               for i in range(q)])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.isnan(zq[-1]).any() and np.isfinite(got).all()
    # the thresholds sit on feature values: one ulp up flips leaves by more
    # than the tolerance
    g_up = (g[0], np.nextafter(g[1], np.float32(np.inf)), g[2], g[3])
    flipped = _plain_scores(zq, wq, side, scale, wc, g_up).numpy()
    assert not np.allclose(flipped, got, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# CUDA kernels vs their plain versions (on a card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,t,d", [(1, 1, 1, 1), (5, 300, 50, 5),
                                     (13, 1029, 13, 6), (64, 5000, 50, 5)])
def test_fused_score_kernel_matches_plain(cuda, q, n, t, d):
    r = np.random.default_rng(n)
    zq, wq = _profiles(r, (q,))
    g = _torch_gbdt(_gbdt(t, d, seed=n), cuda)
    for lead in ((n,), (q, n)):                   # shared, then gathered
        zc, wc = _profiles(r, lead)
        args = _torch_inputs(zq, wq, zc, wc, cuda)
        got = ops.fused_score(*args, g)
        want = ref.fused_score_ref(*args, *g)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("c,r,p,layout", [
    pytest.param(1, 1, 1, "half", id="1-1-1"),
    pytest.param(7, 700, 64, "half", id="7-700-64"),
    pytest.param(33, 256, 128, "half", id="33-256-128"),
    pytest.param(9, 1000, 300, "half", id="9-1000-300"),
    # the narrow block (C < 4096): the upload geometry and its padding, every
    # layout, P = 1, R = 1000 over four row tiles, P = 300 over ten blocks
    (8, 256, 128, "padded"), (8, 16, 128, "half"), (8, 256, 1, "first_row"),
    (13, 300, 37, "first_row"), (13, 300, 37, "scattered"), (13, 300, 37, "dead_column"),
    (13, 300, 37, "all_dead"), (9, 1000, 300, "scattered"), (256, 256, 128, "padded"),
    # the wide block (C >= 4096): ingest's chunk, then ragged columns and
    # permutations, row tiles and every layout
    (16384, 256, 128, "padded"), (16384, 256, 128, "scattered"), (4096, 64, 1, "scattered"),
    (4099, 300, 37, "first_row"), (4099, 300, 37, "dead_column"), (4099, 300, 37, "all_dead"),
    (4100, 1024, 130, "padded"), (5000, 1000, 300, "scattered")])
def test_minhash_kernel_matches_plain(cuda, c, r, p, layout):
    v = hashes_to_torch(_minhash_values(c, r, layout, seed=c * r), cuda)
    a, b = (hashes_to_torch(x, cuda) for x in make_permutations(p, seed=2))
    got = ops.minhash(v, a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.minhash_ref(v, a, b))




def _probe_keys(q, c, b, seed):
    """Sentinel rows (a padded query, padded columns), a guaranteed hit, and
    keys from a small space for plenty of hits."""
    rng = np.random.default_rng(seed)
    qk = rng.integers(0, 60, (q, b)).astype(np.uint32)
    ck = rng.integers(0, 60, (c, b)).astype(np.uint32)
    ck[::5] = PAD_CORPUS
    ck[-1, -1] = qk[0, -1]
    if q > 1:
        qk[-1] = PAD_QUERY
    return qk, ck


@pytest.mark.gpu
@pytest.mark.parametrize("q,c,b", [(1, 1, 1), (11, 777, 32), (64, 5000, 64)]
                         + [(q, 1000, b) for q in (1, 63, 65, 130)
                            for b in (1, 7, 12, 16, 64, 256)])
def test_lsh_probe_kernel_matches_plain(cuda, q, c, b):
    """Every path of the kernel: B = 16 and 64 in registers, other B from
    shared memory; several query groups (Q = 65, 130); C not a multiple of
    the 128-column tile; keys through the ops' int64 conversion."""
    qk, ck = (hashes_to_torch(x, cuda) for x in _probe_keys(q, c, b, seed=q + c + b))
    got = ops.lsh_probe(qk, ck)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.lsh_probe_ref(qk, ck))
    assert got[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("b", [12, 16, 64])
def test_lsh_probe_kernel_takes_unaligned_keys(cuda, b):
    """Corpus keys that are contiguous but not 16-byte aligned (a view at a
    4-byte offset) take the kernel's 4-byte copies."""
    qk, ck = (to_bits(hashes_to_torch(x, cuda)) for x in _probe_keys(65, 333, b, seed=b))
    view = torch.empty(ck.numel() + 1, dtype=torch.int32, device=cuda)[1:].view(ck.shape)
    view.copy_(ck)
    assert view.data_ptr() % 16 != 0
    got = lsh_probe_cuda(qk, view)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.lsh_probe_ref(qk, ck))


@pytest.mark.gpu
@pytest.mark.parametrize("q,c,b", [(1, 1, 1), (3, 300, 16), (5, 257, 64),
                                   (64, 2048, 64), (2, 1000, 256), (3, 100, 12),
                                   (2, 333, 7), (4, 129, 4), (3, 200, 8), (2, 300, 32),
                                   (3, 150, 100), (2, 260, 128)])
def test_lsh_probe_gathered_kernel_matches_plain(cuda, q, c, b):
    """Both forms: pre-gathered (Q, C', B) rows, and the indexed form over a
    resident table (repeated and negative positions), each equal to the
    plain version over the gathered rows. B % 4 == 0 up to 64 takes the
    16-byte variant (1 to 16 vectors a row), the other B the one-key
    variant (1 to 8 keys a lane)."""
    qk, ck = (hashes_to_torch(x, cuda) for x in _gathered_keys(q, c, b, seed=c))
    got = ops.lsh_probe_gathered(qk, ck)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.lsh_probe_gathered_ref(qk, ck))
    qk, table, pos = _indexed_keys(q, c, 3 * c + 1, b, seed=c)
    qk, table = hashes_to_torch(qk, cuda), hashes_to_torch(table, cuda)
    pos = torch.from_numpy(pos).to(cuda)
    got = ops.lsh_probe_gathered(qk, table, pos)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.lsh_probe_gathered_ref(qk, table[pos]))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [64, 1, 4, 7, 8, 32, 100, 128, 256])
def test_lsh_probe_gathered_kernel_takes_unaligned_keys(cuda, b):
    """Keys that are contiguous but not 16-byte aligned (a view at an odd
    offset) take the kernel's one-key loads, 1 to 8 keys a lane."""
    qk, ck = (to_bits(hashes_to_torch(x, cuda)) for x in _gathered_keys(4, 300, b, seed=9))
    view = torch.empty(ck.numel() + 1, dtype=torch.int32, device=cuda)[1:].view(ck.shape)
    view.copy_(ck)
    assert view.data_ptr() % 16 != 0
    got = lsh_probe_gathered_cuda(qk, view)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.lsh_probe_gathered_ref(from_bits(qk), from_bits(ck)))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [7, 12, 16, 64, 256, 4, 8, 32, 100, 128])
def test_lsh_probe_gathered_indexed_kernel_takes_unaligned_tables(cuda, b):
    """A resident table that is contiguous but not 16-byte aligned (a view
    at a 4-byte offset) takes the one-key loads, in the indexed form."""
    qk, table, pos = _indexed_keys(9, 700, 300, b, seed=b)
    qk, table = to_bits(hashes_to_torch(qk, cuda)), to_bits(hashes_to_torch(table, cuda))
    view = torch.empty(table.numel() + 1, dtype=torch.int32, device=cuda)[1:].view(table.shape)
    view.copy_(table)
    assert view.data_ptr() % 16 != 0
    pos = torch.from_numpy(pos).to(cuda)
    got = lsh_probe_gathered_cuda(qk, view, pos)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.lsh_probe_gathered_ref(qk, table[pos]))


_OUT_OF_RANGE = """
import sys, torch
from repro_torch.kernels import ops
qk = torch.zeros((3, {b}), dtype=torch.int32, device="cuda")
table = torch.ones((50, {b}), dtype=torch.int32, device="cuda")
pos = torch.zeros((3, 100), dtype=torch.int64, device="cuda")
pos[2, 77] = {bad}
try:
    ops.lsh_probe_gathered(qk, table, pos)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("raised:", e)
    sys.exit(3)
"""


@pytest.mark.gpu
@pytest.mark.parametrize("b,bad", [(64, 50), (64, -51), (7, 2 ** 40), (0, 50)])
def test_lsh_probe_gathered_kernel_raises_on_out_of_range_position(cuda, b, bad):
    """An out-of-range position traps the kernel and raises at the next
    synchronization; it never reads as a miss. A trap leaves the process's
    CUDA context unusable, so the launch runs in a child process."""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _OUT_OF_RANGE.format(b=b, bad=bad)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 3, proc.stdout + proc.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,t,d", [(1, 1, 1, 1), (5, 300, 50, 5),
                                     (13, 1029, 13, 6), (64, 5000, 50, 5)])
@pytest.mark.parametrize("dtype", ["int8", "fp16"])
def test_fused_score_q_kernel_matches_plain(cuda, dtype, q, n, t, d):
    r = np.random.default_rng(n)
    zq, wq = _profiles(r, (q,))
    g = _torch_gbdt(_gbdt(t, d, seed=n), cuda)
    for lead in ((n,), (q, n)):                   # shared, then gathered
        zc, scale, wc = _quantized(r, lead, dtype)
        args = (torch.from_numpy(zq).to(cuda), hashes_to_torch(wq, cuda),
                torch.from_numpy(zc).to(cuda), torch.from_numpy(scale).to(cuda),
                hashes_to_torch(wc, cuda))
        got = ops.fused_score_q(*args, g)
        want = ref.fused_score_q_ref(*args, *g)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _kernel_scores(zq, wq, side, scale, wc, g, device):
    """The scorer kernel of the sidecar's dtype, through ``ops``."""
    zq_t, wq_t, zc_t, wc_t = _torch_inputs(zq, wq, side, wc, device)
    if side.dtype == np.float32:
        return ops.fused_score(zq_t, wq_t, zc_t, wc_t, _torch_gbdt(g, device))
    return ops.fused_score_q(zq_t, wq_t, zc_t, torch.from_numpy(scale).to(device), wc_t,
                             _torch_gbdt(g, device))


@pytest.mark.gpu
@pytest.mark.parametrize("q,lead,t,d", ADVERSARIAL + [(5, (5, 300), 50, 5),
                                                     (64, (2000,), 50, 5),
                                                     (3, (3, 1029), 13, 6)])
@pytest.mark.parametrize("dtype", ["fp32", "int8", "fp16"])
def test_fused_scorers_bit_equal_on_adversarial_ensembles(cuda, dtype, q, lead, t, d):
    case = _adversarial(t * d + len(lead), q, lead, t, d, dtype)
    got = _kernel_scores(*case, cuda)
    torch.cuda.synchronize()
    assert torch.equal(got, _plain_scores(*case, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("t,d", [(1, 1), (1000, 5), (1, 15), (2, 15)])
@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_fused_scorers_score_large_ensembles_in_chunks(cuda, dtype, t, d):
    """More conditions than the constant bank holds (1000 x 5), or more
    leaves than one block's shared memory (2 trees of depth 15): the kernel
    scores the trees in chunks, in tree order, with the same sums."""
    for lead in ((300,), (3, 200)):
        case = _adversarial(t + d, 3, lead, t, d, dtype)
        got = _kernel_scores(*case, cuda)
        torch.cuda.synchronize()
        assert torch.equal(got, _plain_scores(*case, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("q,n", [(1, 1), (5, 300), (13, 1029), (64, 5000)])
def test_profile_distance_kernel_matches_plain(cuda, q, n):
    r = np.random.default_rng(q + n)
    zq, wq = _profiles(r, (q,))
    zc, wc = _profiles(r, (n,))
    args = _torch_inputs(zq, wq, zc, wc, cuda)
    got = ops.profile_distance(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.profile_distance_ref(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("n,f", [(1, 23), (7, 23), (1000, 24), (5000, 23), (777, 5)])
@pytest.mark.parametrize("t,d", [(1, 1), (13, 6), (50, 5), (50, 8)])
def test_gbdt_infer_kernel_matches_plain(cuda, n, f, t, d):
    r = np.random.default_rng(n * f + t)
    x = r.normal(size=(n, f)).astype(np.float32)
    feats, thrs, leaves, base = _gbdt(t, d, seed=t)
    feats %= f
    x[::3, feats[0, 0]] = thrs[0, 0]                 # features exactly at a threshold
    g = _torch_gbdt((feats, thrs, leaves, base), cuda)
    xt = torch.from_numpy(x).to(cuda)
    got = ops.gbdt_infer(xt, g)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.gbdt_infer_ref(xt, *g))


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,t,d", GBDT_ADVERSARIAL + [(4099, 23, 1000, 5), (513, 24, 1000, 5),
                                                      (200, 23, 1, 15), (300, 200, 50, 5)])
def test_gbdt_infer_kernel_bit_equal_on_adversarial_ensembles(cuda, n, f, t, d):
    """Rows at thresholds, -0.0, NaN, a condition repeated across trees;
    (1000, 5) is scored in chunks of trees, (1, 15) beside 128 KB of leaves,
    F = 200 in 128-row tiles."""
    x, g = adversarial_rows(n * f + t, n, f, t, d)
    xt, gt = torch.from_numpy(x).to(cuda), _torch_gbdt(g, cuda)
    got = ops.gbdt_infer(xt, gt)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.gbdt_infer_ref(xt, *gt))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [23, 24])
def test_gbdt_infer_kernel_takes_an_offset_view(cuda, f):
    """Rows that start 4 bytes past a 16-byte boundary take the 4-byte copies."""
    x, g = adversarial_rows(f, 2000, f, 50, 5)
    view = torch.empty(x.size + 1, dtype=torch.float32, device=cuda)[1:].view(x.shape)
    view.copy_(torch.from_numpy(x))
    assert view.data_ptr() % 16 != 0
    gt = _torch_gbdt(g, cuda)
    got = ops.gbdt_infer(view, gt)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.gbdt_infer_ref(view, *gt))


def _assert_equal_nan(got, want):
    """Bit-equal, with NaN in the same places."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(0,), (1,), (3,), (5,), (1000,), (4097,), (7, 13),
                                   (128, 401), (300_001,), (64, 100_000)])
@pytest.mark.parametrize("s", [0.0, 0.25, 0.5])
def test_quality_cdf_kernel_matches_plain(cuda, shape, s):
    r = np.random.default_rng(len(shape) + int(4 * s))
    j = r.uniform(-0.1, 0.6, shape).astype(np.float32)
    k = r.uniform(-0.1, 1.1, shape).astype(np.float32)
    j.reshape(-1)[::11] = np.nan
    args = (torch.from_numpy(j).to(cuda), torch.from_numpy(k).to(cuda),
            0.0 + s, 0.19, 0.44, 0.28, 0.0, 1.0)
    got = ops.quality_cdf(*args)
    want = ref.quality_cdf_ref(*args)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    _assert_equal_nan(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("off_j,off_k", [(1, 1), (2, 2), (3, 3), (1, 2), (0, 3)])
@pytest.mark.parametrize("n", [2, 200_003])
def test_quality_cdf_kernel_takes_offset_views(cuda, off_j, off_k, n):
    """Views at an offset of 1-3 floats take the scalar head and tail
    (one offset for both) or the scalar walk (different offsets); n = 2 is
    below the 4-pair walk's size and takes the scalar walk at any offset."""
    r = np.random.default_rng(n + off_j)
    base_j = torch.from_numpy(r.uniform(-0.1, 0.6, n + 3).astype(np.float32)).to(cuda)
    base_k = torch.from_numpy(r.uniform(-0.1, 1.1, n + 3).astype(np.float32)).to(cuda)
    base_j[::7] = float("nan")
    j, k = base_j[off_j:off_j + n], base_k[off_k:off_k + n]
    args = (j, k, 0.25, 0.19, 0.44, 0.28, 0.0, 1.0)
    got = ops.quality_cdf(*args)
    want = ref.quality_cdf_ref(*args)
    torch.cuda.synchronize()
    _assert_equal_nan(got, want)


def _concurrent_case(kernel, t, d, seed, device):
    """A call of ``kernel`` on one ensemble at a small shape, where the host
    side of a call is most of its time: (the call, its plain result)."""
    r = np.random.default_rng(seed)
    g = _torch_gbdt(_gbdt(t, d, seed), device)
    if kernel == "gbdt_infer":
        x = torch.from_numpy(r.normal(size=(256, FT.F_DIST)).astype(np.float32)).to(device)
        return (lambda: ops.gbdt_infer(x, g)), ref.gbdt_infer_ref(x, *g)
    zq, wq = _profiles(r, (1,))
    if kernel == "fused_score":
        args = _torch_inputs(zq, wq, *_profiles(r, (128,)), device)
        return (lambda: ops.fused_score(*args, g)), ref.fused_score_ref(*args, *g)
    zc, scale, wc = _quantized(r, (128,), "int8")
    args = (torch.from_numpy(zq).to(device), hashes_to_torch(wq, device),
            torch.from_numpy(zc).to(device), torch.from_numpy(scale).to(device),
            hashes_to_torch(wc, device))
    return (lambda: ops.fused_score_q(*args, g)), ref.fused_score_q_ref(*args, *g)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fused_score", "fused_score_q", "gbdt_infer"])
def test_concurrent_calls_with_two_ensembles_match_plain(cuda, kernel):
    """Eight host threads on one stream, each calling the kernel with one of
    two ensembles (50 x 5, and 1000 x 5, which is scored in chunks of
    trees): every call stages its conditions in the library's constant bank
    and sets its kernel's shared-memory size, so an interleaving of two
    calls' enqueues would score one with the other's conditions or fail
    its launch. Every call must launch and equal its plain version."""
    n_threads, n_calls = 8, 1000
    cases = [_concurrent_case(kernel, 50, 5, 1, cuda), _concurrent_case(kernel, 1000, 5, 2, cuda)]
    start = threading.Barrier(n_threads)

    def hammer(call):
        """The thread's results, and the launches that raised (a failed
        launch configuration leaves the context usable)."""
        start.wait(timeout=60)
        outs, failed = [], []
        for _ in range(n_calls):
            try:
                outs.append(call())
            except RuntimeError as e:
                failed.append(str(e))
        return outs, failed

    with ThreadPoolExecutor(n_threads) as pool:
        futures = [pool.submit(hammer, cases[i % 2][0]) for i in range(n_threads)]
        results = [f.result(timeout=300) for f in futures]
    torch.cuda.synchronize()
    bad, worst, failed = 0, 0.0, []
    for i, (outs, errors) in enumerate(results):
        failed += errors
        want = cases[i % 2][1]
        for got in outs:
            if not torch.equal(got, want):
                bad += 1
                worst = max(worst, float((got - want).abs().max()))
    assert bad == 0 and not failed, (
        f"of {n_calls * n_threads} concurrent {kernel} calls, {bad} differ from their plain "
        f"versions (max |err| {worst}) and {len(failed)} failed to launch "
        f"({sorted(set(failed))})")

"""Every kernel launch runs on its tensors' card.

``cudaMemcpyToSymbolAsync`` into a constant bank, ``cudaFuncSetAttribute``
and ``<<<>>>`` act on the calling thread's current device, not on the
stream's, so each wrapper makes its tensors' device current around its
ctypes call (``kernels._build.on_device``). On the host, with the library
and the guard stubbed, each of the eleven wrappers must reach its library
only inside the guard and with its tensors' device; on a host with two cards
(``gpu`` marker), each kernel called with tensors on ``cuda:1`` from a thread
whose current device is 0 must equal its plain version.
"""
import contextlib
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import features as FT
from repro_torch.device import hashes_to_torch, to_bits
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.candidate_priority import candidate_priority_cuda
from repro_torch.kernels.coarse_priority import coarse_priority_cuda
from repro_torch.kernels.gbdt_infer import gbdt_infer_cuda
from repro_torch.kernels.lsh_probe import lsh_probe_cuda, lsh_probe_gathered_cuda
from repro_torch.kernels.minhash import make_permutations, minhash_cuda
from repro_torch.kernels.profile_distance import (fused_score_cuda, fused_score_q_cuda,
                                                  profile_distance_cuda)
from repro_torch.kernels.quality_cdf import quality_cdf_cuda
from repro_torch.kernels.topk import topk_cuda
from test_torch_kernels import (_gathered_keys, _gbdt, _probe_keys, _profiles, _quantized,
                                _torch_gbdt)


def _cases(device):
    """name -> (the kernel through ``ops``, its plain version) on ``device``."""
    r = np.random.default_rng(0)
    zq, wq = _profiles(r, (5,))
    zc, wc = _profiles(r, (300,))
    side, scale, wsq = _quantized(r, (300,), "int8")
    g = _torch_gbdt(_gbdt(50, 5, seed=1), device)
    t = lambda a: torch.from_numpy(a).to(device)
    h = lambda a: hashes_to_torch(a, device)
    score = (t(zq), h(wq), t(zc), h(wc))
    score_q = (t(zq), h(wq), t(side), t(scale), h(wsq))
    vals = h(r.integers(0, 2 ** 32 - 1, (33, 256), dtype=np.uint64).astype(np.uint32))
    perms = tuple(h(x) for x in make_permutations(128, seed=2))
    probe = tuple(h(x) for x in _probe_keys(11, 777, 64, seed=3))
    gathered = tuple(h(x) for x in _gathered_keys(5, 257, 64, seed=4))
    x = t(r.normal(size=(1000, FT.F_DIST)).astype(np.float32))
    cdf = (t(r.uniform(-0.1, 0.6, (4097,)).astype(np.float32)),
           t(r.uniform(-0.1, 1.1, (4097,)).astype(np.float32)), 0.25, 0.19, 0.44, 0.28, 0.0, 1.0)
    scores = t(r.normal(size=(5, 10_000)).astype(np.float32))
    coarse = _coarse_inputs(r, 5, 1000, t)
    hit, g, zn, *cand = _candidate_inputs(r, 5, 1000, t)
    return {
        "fused_score": (lambda: ops.fused_score(*score, g),
                        lambda: ref.fused_score_ref(*score, *g)),
        "fused_score_q": (lambda: ops.fused_score_q(*score_q, g),
                          lambda: ref.fused_score_q_ref(*score_q, *g)),
        "minhash": (lambda: ops.minhash(vals, *perms), lambda: ref.minhash_ref(vals, *perms)),
        "lsh_probe": (lambda: ops.lsh_probe(*probe), lambda: ref.lsh_probe_ref(*probe)),
        "lsh_probe_gathered": (lambda: ops.lsh_probe_gathered(*gathered),
                               lambda: ref.lsh_probe_gathered_ref(*gathered)),
        "profile_distance": (lambda: ops.profile_distance(*score),
                             lambda: ref.profile_distance_ref(*score)),
        "gbdt_infer": (lambda: ops.gbdt_infer(x, g), lambda: ref.gbdt_infer_ref(x, *g)),
        "quality_cdf": (lambda: ops.quality_cdf(*cdf), lambda: ref.quality_cdf_ref(*cdf)),
        "topk": (lambda: ops.topk(scores, 10), lambda: ref.topk_ref(scores, 10)),
        "coarse_priority": (lambda: _flat(ops.coarse_priority(*coarse, 32)),
                            lambda: _flat(ref.coarse_priority_ref(*coarse, 32))),
        # the kernel writes over its g: it gets a copy
        "candidate_priority": (lambda: ops.candidate_priority(hit, g.clone(), zn, *cand),
                               lambda: ref.candidate_priority_ref(hit, g, zn, *cand)),
    }


def _coarse_inputs(r, q: int, c: int, t):
    """The coarse priority's (hit, proxy, cids, tids, tq, qid) through ``t``:
    sparse hits, a proxy, a padded last column, tables of 8 columns."""
    tids = np.arange(c, dtype=np.int64) // 8
    qid = r.choice(c, q, replace=False).astype(np.int64)
    cids = np.arange(c, dtype=np.int64)
    cids[-1] = -1
    return (t((r.random((q, c)) < 0.01).astype(np.int32)),
            t(r.normal(0, 4, (q, c)).astype(np.float32)), t(cids), t(tids), t(tids[qid]),
            t(qid))


def _candidate_inputs(r, q: int, c: int, t):
    """The hybrid candidate priority's (hit, g, znorm, cids, tids, tq, qid)
    through ``t``: the coarse priority's hits, ids and tables, its proxy as g,
    and positive column norms."""
    hit, g, *rest = _coarse_inputs(r, q, c, t)
    return (hit, g, t(r.uniform(0, 40, c).astype(np.float32)), *rest)


def _flat(out) -> torch.Tensor:
    """The coarse priority's (prio, n_hits, n_survivors) as one float64 row,
    compared as one kernel output."""
    return torch.cat([x.to(torch.float64).reshape(-1) for x in out])


# ---------------------------------------------------------------------------
# on the host: every wrapper reaches its library inside the guard
# ---------------------------------------------------------------------------

def _wrapper_calls():
    """name -> a call of the kernel's ``*_cuda`` wrapper on host tensors, and
    the device those tensors live on."""
    r = np.random.default_rng(1)
    zq, wq = _profiles(r, (3,))
    zc, wc = _profiles(r, (40,))
    side, scale, wsq = _quantized(r, (40,), "int8")
    feats, thrs, leaves, base = _torch_gbdt(_gbdt(4, 3, seed=2))
    feats = feats.to(torch.int32)
    t = torch.from_numpy
    b = lambda a: to_bits(hashes_to_torch(a, "cpu"))
    qk, ck = _probe_keys(3, 40, 8, seed=3)
    gq, gk = _gathered_keys(3, 9, 8, seed=4)
    x = t(r.normal(size=(20, FT.F_DIST)).astype(np.float32))
    j = t(r.uniform(0, 1, (50,)).astype(np.float32))
    a, bb = make_permutations(16, seed=5)
    return {
        "fused_score": lambda: fused_score_cuda(t(zq), b(wq), t(zc), b(wc), feats, thrs,
                                                leaves, base),
        "fused_score_q": lambda: fused_score_q_cuda(t(zq), b(wq), t(side), t(scale),
                                                    b(wsq), feats, thrs, leaves, base),
        "minhash": lambda: minhash_cuda(b(np.arange(60, dtype=np.uint32).reshape(3, 20)),
                                        b(a), b(bb)),
        "lsh_probe": lambda: lsh_probe_cuda(b(qk), b(ck)),
        "lsh_probe_gathered": lambda: lsh_probe_gathered_cuda(b(gq), b(gk)),
        "profile_distance": lambda: profile_distance_cuda(t(zq), b(wq), t(zc), b(wc)),
        "gbdt_infer": lambda: gbdt_infer_cuda(x, feats, thrs, leaves, base),
        "quality_cdf": lambda: quality_cdf_cuda(j, j.clone(), 0.25, 0.19, 0.44, 0.28,
                                                0.0, 1.0),
        "topk": lambda: topk_cuda(x, 5),
        "coarse_priority": lambda: coarse_priority_cuda(*_coarse_inputs(r, 3, 40, t), 32),
        "candidate_priority": lambda: candidate_priority_cuda(*_candidate_inputs(r, 3, 40, t)),
    }


class _FakeLibrary:
    """A kernel library whose launches record whether they ran inside the
    guard, and on which device."""

    def __init__(self, guard):
        self.guard = guard
        self.launches = []

    def __getattr__(self, fn):
        if fn.endswith("_smem"):
            return lambda *a: 0
        if fn.endswith("_max_bands"):
            return lambda: 256
        return lambda *a: self.launches.append((fn, self.guard.device)) or 0


class _Guard:
    def __init__(self):
        self.device = None
        self.entered = []

    @contextlib.contextmanager
    def __call__(self, t):
        self.entered.append(t.device)
        self.device = t.device
        try:
            yield 0
        finally:
            self.device = None


@pytest.mark.parametrize("name", _build.KERNELS)
def test_every_wrapper_launches_inside_the_device_guard(monkeypatch, name):
    guard = _Guard()
    lib = _FakeLibrary(guard)
    monkeypatch.setattr(_build, "on_device", guard)
    monkeypatch.setattr(_build, "library", lambda op: lib)
    monkeypatch.setattr(_build, "expect", lambda *a, **k: None)
    monkeypatch.setattr(_build, "sm_count", lambda device: 1)
    monkeypatch.setattr(_build, "count_launch", lambda *a, **k: None)
    _wrapper_calls()[name]()
    assert lib.launches == [(f"freyja_{name}", torch.device("cpu"))]
    assert guard.entered == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# on two cards: cuda:1 tensors launched from a thread on device 0
# ---------------------------------------------------------------------------

@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the fault shows only when a tensor's card "
                    "is not the thread's current device")
    return torch.device("cuda", 1)


@pytest.mark.gpu
@pytest.mark.parametrize("name", _build.KERNELS)
def test_kernel_on_the_second_card_from_a_thread_on_the_first(two_cards, name):
    kernel, plain = _cases(two_cards)[name]
    out = {}

    def run():
        torch.cuda.set_device(0)
        out["got"] = kernel()
        torch.cuda.synchronize(two_cards)

    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive() and "got" in out
    got, want = out["got"], plain()
    assert got.device == two_cards
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], want[~nan])

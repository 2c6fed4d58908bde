"""The port's training substrate: ``tests/test_train.py`` restated on the
port, AdamW, the learning-rate schedule and the loss against the JAX
package's functions, block remat and the chunked RWKV scan, the loop's
resume and emergency checkpoint, ``launch.train`` and
``examples/torch_train_lm.py`` against ``examples/train_lm.py``."""
import contextlib
import copy
import dataclasses
import io
import os
import re
import runpy
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import labelled, one_thread, private_pair, to_torch  # noqa: F401
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.models import registry as jreg
from repro.train import optimizer as jopt
from repro.train import trainer as jtr
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import registry, rwkv
from repro_torch.train import optimizer
from repro_torch.train.loop import StragglerMonitor, train_loop
from repro_torch.train.optimizer import (AdamWConfig, adamw_update, global_norm,
                                         init_opt_state, lr_schedule)
from repro_torch.train.trainer import build_train_step, cross_entropy, loss_fn

CPU = torch.device("cpu")
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _smollm(**over):
    cfg = registry.reduced_config(registry.get_config("smollm-360m"))
    cfg = dataclasses.replace(cfg, **over)
    return cfg, registry.init_params(cfg, generator=torch.Generator().manual_seed(0), device=CPU)


# ---------------------------------------------------------------------------
# tests/test_train.py, restated
# ---------------------------------------------------------------------------

def test_adamw_matches_reference():
    """One AdamW step on a scalar matches the closed-form update."""
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                      grad_clip=1e9, warmup_steps=0, total_steps=10**9)
    p = {"w": torch.tensor(2.0)}
    g = {"w": torch.tensor(0.5)}
    st = init_opt_state(p)
    p2, st2, _ = adamw_update(cfg, p, g, st)
    m = 0.1 * 0.5
    v = 0.01 * 0.25
    mh, vh = m / 0.1, v / 0.01
    want = 2.0 - cfg.lr * mh / (np.sqrt(vh) + cfg.eps)
    assert np.isclose(float(p2["w"]), want, rtol=1e-5)
    assert int(st2["step"]) == 1


def test_grad_clip_and_schedule():
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=10, total_steps=100)
    # linear warmup starts at lr/warmup (not 0 — step 0 must make progress)
    assert float(lr_schedule(cfg, torch.tensor(0))) == pytest.approx(0.1)
    assert float(lr_schedule(cfg, torch.tensor(10))) == pytest.approx(1.0, rel=1e-3)
    assert float(lr_schedule(cfg, torch.tensor(100))) == pytest.approx(cfg.min_lr_frac, rel=1e-2)
    g = {"a": torch.full((10,), 10.0)}
    assert float(global_norm(g)) == pytest.approx(np.sqrt(1000), rel=1e-5)


def test_cross_entropy_masking():
    logits = torch.zeros((1, 4, 8))
    labels = torch.tensor([[1, 2, -1, -1]])
    loss = cross_entropy(logits, labels)
    assert float(loss) == pytest.approx(np.log(8), rel=1e-5)


def test_loss_decreases_and_resumes(tmp_path):
    cfg, model = _smollm()
    opt = init_opt_state(model)
    step = build_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=40))
    pipe = TokenPipeline(vocab=cfg.vocab, seq=64, global_batch=4)
    ckpt = str(tmp_path / "ck")
    logs = []
    _, _, hist = train_loop(step, copy.deepcopy(model), opt, pipe, cfg=cfg, steps=30,
                            ckpt_dir=ckpt, ckpt_every=10, log_every=1, log=logs.append)
    losses = [h[1] for h in hist]
    assert losses[-1] < losses[0] - 0.2, losses
    # restart resumes from the latest checkpoint and continues
    _, opt2, _ = train_loop(step, copy.deepcopy(model), init_opt_state(model), pipe, cfg=cfg,
                            steps=32, ckpt_dir=ckpt, ckpt_every=10, log_every=1,
                            log=logs.append)
    assert any("[resume]" in line for line in logs)
    assert int(opt2["step"]) == 32


def test_grad_accumulation_equivalence():
    """accum=2 must equal a single big-batch step (same mean gradient)."""
    cfg, model = _smollm()
    pipe = TokenPipeline(vocab=cfg.vocab, seq=32, global_batch=8)
    batch = {k: torch.from_numpy(v).long() for k, v in pipe.batch(0).items()}
    s1 = build_train_step(cfg, AdamWConfig(lr=1e-3), accum=1)
    s2 = build_train_step(cfg, AdamWConfig(lr=1e-3), accum=2)
    m1, m2 = copy.deepcopy(model), copy.deepcopy(model)
    p1, _, r1 = s1(m1, init_opt_state(m1), batch)
    p2, _, r2 = s2(m2, init_opt_state(m2), batch)
    assert np.isclose(float(r1["loss"]), float(r2["loss"]), rtol=1e-4)
    d = max(float((a - b).abs().max()) for a, b in zip(p1.state_dict().values(),
                                                        p2.state_dict().values()))
    assert d < 5e-3


def test_straggler_monitor():
    m = StragglerMonitor(alpha=0.5, threshold=2.0)
    assert not m.observe(1.0)
    assert not m.observe(1.1)
    assert m.observe(5.0)
    assert m.flagged == 1


def test_checkpoint_atomic_keepn(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": np.arange(5), "b": {"c": np.ones((2, 2))}}
    for s in (1, 2, 3):
        mgr.save(s, tree)
    assert mgr.latest_step() == 3
    files = [f for f in os.listdir(tmp_path) if f.startswith("ckpt_")]
    assert len(files) == 2                    # keep-N gc
    restored, step = mgr.restore(3, tree)
    assert step == 3
    np.testing.assert_array_equal(restored["a"], tree["a"])
    np.testing.assert_array_equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_structure_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": np.arange(3)})
    with pytest.raises(AssertionError):
        mgr.restore(1, {"zzz": np.arange(3)})


# ---------------------------------------------------------------------------
# AdamW, the schedule and the loss against the JAX package
# ---------------------------------------------------------------------------

def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at each value (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("grad_clip", [0.5, 1e3], ids=["clipping", "no-clipping"])
def test_adamw_update_matches_jax(grad_clip):
    """Three steps over float32 and bfloat16 leaves, one leaf without a
    gradient (zeros in JAX), warmup from step 0: params, moments, step, lr
    and grad norm within float32 rounding, bf16 leaves within one ulp."""
    r = np.random.default_rng(0)
    shapes = {"w": ((16, 8), "float32"), "b": ((8,), "float32"),
              "e": ((32, 4), "bfloat16"), "n": ((8,), "float32")}
    init = {k: r.normal(size=s).astype(np.float32) for k, (s, _) in shapes.items()}
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=10, grad_clip=grad_clip)
    jp = {k: jnp.asarray(v).astype(shapes[k][1]) for k, v in init.items()}
    tp = {k: torch.from_numpy(v.copy()).to(getattr(torch, shapes[k][1]))
          for k, v in init.items()}
    js, ts = jopt.init_opt_state(jp), init_opt_state(tp)
    assert all(m.dtype == torch.float32 for m in ts["m"].values())
    for i in range(3):
        g = {k: (r.normal(size=shapes[k][0]) * 3).astype(np.float32) for k in init}
        g["n"] = np.zeros(shapes["n"][0], np.float32)
        jg = {k: jnp.asarray(v).astype(shapes[k][1]) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(getattr(torch, shapes[k][1])) for k, v in g.items()}
        tg["n"] = None
        jp, js, jm = jopt.adamw_update(jopt.AdamWConfig(**cfg), jp, jg, js)
        _, ts, tm = adamw_update(AdamWConfig(**cfg), tp, tg, ts)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
        assert (float(jm["grad_norm"]) > grad_clip) == (grad_clip < 1)
        for k in init:
            for part in ("m", "v"):
                np.testing.assert_allclose(ts[part][k].numpy(), np.asarray(js[part][k]),
                                           rtol=1e-6, atol=1e-12, err_msg=f"{part} {k}")
            want = np.asarray(jp[k].astype(jnp.float32))
            got = tp[k].float().numpy()
            if shapes[k][1] == "bfloat16":
                assert tp[k].dtype == torch.bfloat16
                assert (np.abs(got - want) <= _bf16_ulp(want)).all(), k
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=k)
    # the leaf without a gradient decayed and its second moment stayed 0
    assert not torch.equal(tp["n"], torch.from_numpy(init["n"]))
    assert float(ts["v"]["n"].abs().max()) == 0.0


def test_lr_schedule_matches_jax():
    for cfg in (dict(lr=3e-4, warmup_steps=10, total_steps=50),
                dict(lr=1.0, warmup_steps=0, total_steps=20, min_lr_frac=0.2)):
        for s in range(cfg["total_steps"] + 6):
            want = float(jopt.lr_schedule(jopt.AdamWConfig(**cfg), jnp.asarray(s, jnp.int32)))
            got = lr_schedule(AdamWConfig(**cfg), torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=1e-6), (cfg, s)


def test_cross_entropy_matches_jax():
    r = np.random.default_rng(1)
    logits = (r.normal(size=(2, 8, 16)) * 3).astype(np.float32)
    labels = r.integers(0, 16, (2, 8)).astype(np.int32)
    labels[0, 3:] = -1
    masked = np.full((2, 8), -1, np.int32)
    for lab in (labels, masked):
        want = float(jtr.cross_entropy(jnp.asarray(logits), jnp.asarray(lab)))
        got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab).long()))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(masked))) == 0.0


@pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 64, 4, 0), (49152, 256, 8, 3)])
def test_token_pipeline_is_byte_identical_to_jax(vocab, seq, batch, seed):
    ours, theirs = TokenPipeline(vocab, seq, batch, seed), JaxTokenPipeline(vocab, seq, batch, seed)
    for step in (0, 1, 37):
        for got, want in ((ours.batch(step), theirs.batch(step)),
                          (ours.shard_batch(step, 1, 4), theirs.shard_batch(step, 1, 4))):
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


# ---------------------------------------------------------------------------
# remat and the chunked RWKV scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jreg.list_archs())
def test_block_remat_gives_the_same_gradients(arch):
    """remat="block" recomputes each block in the backward pass: the loss and
    every gradient equal those of remat="none"."""
    jcfg, _, tcfg, model = private_pair(arch)
    batch = to_torch(labelled(jcfg))
    out = {}
    for remat in ("none", "block"):
        m = copy.deepcopy(model).requires_grad_(True)
        loss = loss_fn(m, dataclasses.replace(tcfg, remat=remat), batch)
        loss.backward()
        out[remat] = (loss.detach(), {n: p.grad for n, p in m.named_parameters()})
    assert torch.equal(out["none"][0], out["block"][0])
    for name, g in out["none"][1].items():
        h = out["block"][1][name]
        assert (g is None) == (h is None), name
        if g is not None:
            torch.testing.assert_close(h, g, rtol=1e-6, atol=1e-9, msg=name)


def test_rwkv_chunked_scan_equals_the_token_loop():
    """With gradients on, the scan runs in checkpointed chunks (a short last
    one included): outputs, final state and input gradients equal the loop's."""
    g = torch.Generator().manual_seed(0)
    b, s, h, k = 2, 37, 2, 8
    r, kk, v = (torch.randn((b, s, h, k), generator=g) for _ in range(3))
    w = torch.rand((b, s, h, k), generator=g) * 0.9 + 0.05
    u = torch.randn((h, k), generator=g)
    st = torch.randn((b, h, k, k), generator=g)
    out = []
    for chunk in (s, 16):
        args = [t.clone().requires_grad_(True) for t in (r, kk, v, w, u, st)]
        y, fin = rwkv._wkv_scan(*args, chunk=chunk)
        (y.square().sum() + fin.sum()).backward()
        out.append((y.detach(), fin.detach(), [a.grad for a in args]))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    torch.testing.assert_close(out[1][1], out[0][1], rtol=0, atol=0)
    for a, b_ in zip(out[1][2], out[0][2]):
        torch.testing.assert_close(a, b_, rtol=1e-6, atol=1e-6)
    with torch.no_grad():                        # inference runs the loop
        y, _ = rwkv._wkv_scan(r, kk, v, w, u, st, chunk=16)
    torch.testing.assert_close(y, out[0][0], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the loop, the driver and the example
# ---------------------------------------------------------------------------

def test_keyboard_interrupt_writes_an_emergency_checkpoint(tmp_path):
    cfg, model = _smollm(n_layers=2)
    step = build_train_step(cfg, AdamWConfig(lr=1e-3))
    calls = []

    def interrupted(m, o, batch):
        if len(calls) == 3:
            raise KeyboardInterrupt
        calls.append(1)
        return step(m, o, batch)

    logs = []
    with pytest.raises(KeyboardInterrupt):
        train_loop(interrupted, model, init_opt_state(model),
                   TokenPipeline(vocab=cfg.vocab, seq=16, global_batch=2), cfg=cfg, steps=10,
                   ckpt_dir=str(tmp_path), ckpt_every=100, log=logs.append)
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
    assert logs[-1] == "[interrupt] emergency checkpoint @ step 3"


def test_interrupt_inside_the_update_resumes_as_an_uninterrupted_run(tmp_path, monkeypatch):
    """SIGINT between two foreach groups of the in-place AdamW update of
    step 2: the step finishes before the interrupt is raised, the emergency
    checkpoint holds the whole state of step 3, and resuming from it to
    step 6 gives the uninterrupted run's state bit for bit."""
    cfg, model0 = _smollm(n_layers=2)
    pipe = TokenPipeline(vocab=cfg.vocab, seq=16, global_batch=2)
    step = build_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=0))
    monkeypatch.setattr(optimizer, "GROUP_NUMEL", 1 << 12)   # one group a leaf
    updates = []
    real_groups = optimizer._groups

    def groups(leaves):
        sels = real_groups(leaves)
        if not leaves or not isinstance(leaves[0], torch.nn.Parameter):
            return sels                      # the gradients' norm, not the update
        updates.append(1)
        if len(updates) != 3:
            return sels
        assert len(sels) > 2

        def interrupted():
            for i, sel in enumerate(sels):
                if i == 1:
                    signal.raise_signal(signal.SIGINT)
                yield sel
        return interrupted()

    monkeypatch.setattr(optimizer, "_groups", groups)
    model, opt, logs = copy.deepcopy(model0), init_opt_state(model0), []
    with pytest.raises(KeyboardInterrupt):
        train_loop(step, model, opt, pipe, cfg=cfg, steps=6, ckpt_dir=str(tmp_path / "cut"),
                   ckpt_every=100, log=logs.append)
    assert len(updates) == 3 and int(opt["step"]) == 3
    assert logs[-1] == "[interrupt] emergency checkpoint @ step 3"
    model, opt = copy.deepcopy(model0), init_opt_state(model0)
    train_loop(step, model, opt, pipe, cfg=cfg, steps=6, ckpt_dir=str(tmp_path / "cut"),
               ckpt_every=100, log=logs.append)
    assert "[resume] restored checkpoint @ step 3" in logs

    whole, whole_opt = copy.deepcopy(model0), init_opt_state(model0)
    train_loop(step, whole, whole_opt, pipe, cfg=cfg, steps=6,
               ckpt_dir=str(tmp_path / "whole"), ckpt_every=100, log=lambda _: None)
    assert int(opt["step"]) == int(whole_opt["step"]) == 6
    want = dict(whole.named_parameters())
    for name, p in model.named_parameters():
        torch.testing.assert_close(p, want[name], rtol=0, atol=0, msg=name)
        for key in ("m", "v"):
            torch.testing.assert_close(opt[key][name], whole_opt[key][name], rtol=0, atol=0,
                                       msg=f"{key} {name}")


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = launch_train.main(argv)
    return result, out.getvalue()


def test_launch_train_runs_and_resumes(tmp_path):
    argv = ["--device", "cpu", "--reduce", "--batch", "2", "--seq", "32", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path)]
    (_, opt, hist), out = _main(argv + ["--steps", "4"])
    assert int(opt["step"]) == 4 and hist[0][0] == 0 and "first loss" in out
    (_, opt, _), out = _main(argv + ["--steps", "6"])
    assert "[resume] restored checkpoint @ step 4" in out
    assert int(opt["step"]) == 6
    with pytest.raises(ValueError, match="needs 256 devices"):
        launch_train.main(argv + ["--mesh", "single"])


def test_launch_train_module_runs_on_the_host(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(ROOT, "src")))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--reduce", "--steps", "2", "--batch", "2", "--seq", "32",
                          "--ckpt-dir", str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "first loss" in out.stdout


_LOSS_LINE = re.compile(r"step\s+(\d+) loss (\d+\.\d+)")


def test_example_matches_the_jax_example(tmp_path, monkeypatch):
    """examples/torch_train_lm.py and examples/train_lm.py at small flags,
    from the same JAX weights: the same logged losses (printed to 4 places)."""
    flags = ["--steps", "40", "--batch", "4", "--seq", "32", "--width", "128", "--layers", "2"]
    monkeypatch.chdir(tmp_path)                  # the JAX example writes artifacts/ here
    monkeypatch.setattr(sys, "argv", ["train_lm.py"] + flags)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(os.path.join(ROOT, "examples", "train_lm.py"), run_name="__main__")
    want = {int(s): float(v) for s, v in _LOSS_LINE.findall(out.getvalue())}

    example = runpy.run_path(os.path.join(ROOT, "examples", "torch_train_lm.py"))
    cfg = example["config"](128, 2, 32)
    jcfg = dataclasses.replace(jreg.get_config("smollm-360m"), **{
        f: getattr(cfg, f) for f in ("n_layers", "d_model", "d_ff", "n_heads", "n_kv", "d_head",
                                     "vocab", "param_dtype", "compute_dtype", "attn_chunk",
                                     "remat")})
    jparams, _ = jreg.init_params(jcfg, jax.random.PRNGKey(0))
    model = registry.init_params(cfg, device=CPU)
    model.load_state_dict(lm_params_from_jax(jparams, cfg))
    with contextlib.redirect_stdout(io.StringIO()):
        hist = example["main"](flags + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "t")],
                               model=model)
    got = {s: loss for s, loss, _ in hist}
    assert {0, 10, 20, 30} <= set(want) & set(got)
    for s in set(want) & set(got):
        assert got[s] == pytest.approx(want[s], abs=1.5e-4), s

"""The port's LM serving path: ``serve.engine.generate`` and
``launch.serve`` against the JAX package (greedy tokens under the margin
rule), and ``tests/test_serve.py`` restated on the port (determinism,
int8 KV caches, the image stub), with seeded temperature sampling and the
enc-dec refusal."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import CPU, pair
from repro.models import registry as jreg
from repro.serve.engine import generate as jax_generate
from repro_torch.launch import serve as launch_serve
from repro_torch.models import registry, transformer
from repro_torch.serve.engine import build_serve_step, generate

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# greedy tokens are compared only where JAX's top-2 logit margin exceeds
# this: below it, float32 rounding may flip the argmax (random weights)
MARGIN = 1e-3


def _prompts(cfg, b: int = 2, s: int = 16, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, cfg.vocab, (b, s)).astype(np.int32)


def _port(arch: str, seed: int = 0, **overrides):
    cfg = dataclasses.replace(registry.reduced_config(registry.get_config(arch)), **overrides)
    return cfg, registry.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                                     device=CPU)


def _margins(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


# (arch, overrides): the MoE raises capacity_factor so the teacher-forced
# pass over more tokens routes as the decode steps do
GENERATE_CASES = {"smollm-360m": {}, "qwen3-4b": {}, "rwkv6-3b": {},
                  "mixtral-8x22b": {"capacity_factor": 8.0}, "phi-3-vision-4.2b": {}}


@pytest.mark.parametrize("arch", sorted(GENERATE_CASES))
def test_generate_greedy_matches_jax_under_the_margin_rule(arch):
    """Along JAX's greedy trajectory, the port's teacher-forced argmax is
    JAX's token wherever JAX's top-2 margin exceeds 1e-3; the port's own
    ``generate`` emits JAX's tokens up to each row's first step below it."""
    jcfg, jparams, tcfg, model = pair(arch, **GENERATE_CASES[arch])
    prompts = _prompts(jcfg)
    n = 8
    img = None
    if jcfg.family == "vlm":
        img = (np.random.default_rng(1).normal(size=(2, jcfg.n_patches, jcfg.d_model))
               * 0.02).astype(np.float32)
    want = jax_generate(jparams, jcfg, jnp.asarray(prompts), max_new=n,
                        img=None if img is None else jnp.asarray(img))
    # JAX's trajectory, padded to 32 (RWKV's chunk divides it; causal, so
    # the padding leaves the first positions as they are)
    traj = np.concatenate([prompts, want[:, :-1]], axis=1)
    traj = np.pad(traj, ((0, 0), (0, 32 - traj.shape[1])))
    s = prompts.shape[1]
    batch = {"tokens": jnp.asarray(traj)}
    if img is not None:
        batch["img"] = jnp.asarray(img)
    margins = _margins(np.asarray(jreg.forward(jparams, jcfg, batch))[:, s - 1:s - 1 + n])
    tbatch = {"tokens": torch.from_numpy(traj).long()}
    if img is not None:
        tbatch["img"] = torch.from_numpy(img)
    forced = registry.forward(model, tcfg, tbatch).numpy()[:, s - 1:s - 1 + n].argmax(-1)
    sure = margins > MARGIN
    assert sure.mean() > 0.5, margins
    np.testing.assert_array_equal(forced[sure], want[sure])
    got = generate(model, tcfg, prompts, max_new=n, img=img, device="cpu")
    assert got.shape == (2, n) and got.dtype == np.int32
    for row in range(2):
        first_unsure = int(np.argmin(sure[row])) if not sure[row].all() else n
        np.testing.assert_array_equal(got[row, :first_unsure], want[row, :first_unsure])


def test_generate_greedy_deterministic():
    cfg, params = _port("smollm-360m")
    prompts = _prompts(cfg)
    out1 = generate(params, cfg, prompts, max_new=8, device="cpu")
    out2 = generate(params, cfg, torch.from_numpy(prompts), max_new=8, device="cpu")
    assert out1.shape == (2, 8)
    np.testing.assert_array_equal(out1, out2)


def test_serve_step_is_the_argmax_of_decode_step():
    cfg, params = _port("smollm-360m")
    toks = torch.from_numpy(_prompts(cfg)).long()
    _, c1 = transformer.forward_with_caches(params, cfg, toks, 32)
    _, c2 = transformer.forward_with_caches(params, cfg, toks, 32)
    nxt, c1 = build_serve_step(cfg)(params, toks[:, -1:], c1)
    logits, c2 = registry.decode_step(params, cfg, {"tokens": toks[:, -1:]}, c2)
    assert nxt.shape == (2, 1) and c1["len"] == 17
    np.testing.assert_array_equal(nxt[:, 0].numpy(), logits[:, -1].argmax(-1).numpy())


def test_temperature_sampling_is_repeatable_with_a_seeded_generator():
    cfg, params = _port("smollm-360m")
    prompts = _prompts(cfg)

    def sample(seed):
        return generate(params, cfg, prompts, max_new=12, temperature=1.0, device="cpu",
                        generator=torch.Generator().manual_seed(seed))

    a, b, c = sample(7), sample(7), sample(8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert ((a >= 0) & (a < cfg.vocab)).all()
    greedy = generate(params, cfg, prompts, max_new=12, device="cpu")
    np.testing.assert_array_equal(a[:, 0], greedy[:, 0])      # the prefill's argmax
    assert not np.array_equal(a, greedy)


def test_encdec_generate_raises():
    cfg, params = _port("whisper-base")
    with pytest.raises(NotImplementedError, match="enc-dec"):
        generate(params, cfg, _prompts(cfg), max_new=4, device="cpu")


def test_generate_refuses_parameters_on_another_device():
    cfg, params = _port("smollm-360m")
    with pytest.raises(ValueError, match="parameters are on cpu"):
        generate(params, cfg, _prompts(cfg), max_new=2, device="meta")


def test_generate_with_vlm_image():
    cfg, params = _port("phi-3-vision-4.2b")
    r = np.random.default_rng(0)
    img = (r.normal(size=(2, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    out = generate(params, cfg, _prompts(cfg), max_new=4, img=img, device="cpu")
    assert out.shape == (2, 4)


def test_generate_hybrid_follows_its_forward_pass():
    """The port serves the hybrid (the JAX package's hybrid prefill fails,
    tests/test_torch_models.py): greedy tokens equal the teacher-forced
    argmax wherever its top-2 margin exceeds 1e-3."""
    cfg, params = _port("zamba2-2.7b")
    prompts = _prompts(cfg, s=32)
    out = generate(params, cfg, prompts, max_new=8, device="cpu")
    traj = torch.from_numpy(np.concatenate([prompts, out[:, :-1]], axis=1)).long()
    logits = registry.forward(params, cfg, {"tokens": torch.nn.functional.pad(
        traj, (0, 64 - traj.shape[1]))}).numpy()[:, 31:39]
    sure = _margins(logits) > MARGIN
    np.testing.assert_array_equal(logits.argmax(-1)[sure], out[sure])


def test_int8_kv_cache_close_to_fp():
    cfg, params = _port("qwen3-4b", seed=1)
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    b, n = 2, 10
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (b, n))).long()
    c1 = registry.init_caches(cfg, b, 64, device=CPU)
    c2 = registry.init_caches(cfgq, b, 64, device=CPU)
    assert c2["kv"]["k"].dtype == torch.int8
    o1, o2 = [], []
    for i in range(n):
        l1, c1 = registry.decode_step(params, cfg, {"tokens": toks[:, i:i + 1]}, c1)
        l2, c2 = registry.decode_step(params, cfgq, {"tokens": toks[:, i:i + 1]}, c2)
        o1.append(l1.numpy())
        o2.append(l2.numpy())
    a, b_ = np.concatenate(o1, 1), np.concatenate(o2, 1)
    rel = np.abs(a - b_).max() / np.abs(a).max()
    assert rel < 0.05, rel
    agree = (a.argmax(-1) == b_.argmax(-1)).mean()
    assert agree > 0.9, agree


def test_int8_kv_prefill_path():
    cfg, params = _port("smollm-360m", seed=1, kv_quant=True)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 32))).long()
    logits, caches = transformer.forward_with_caches(params, cfg, toks, 64)
    assert caches["kv"]["k"].dtype == torch.int8
    assert caches["kv"]["k_scale"].dtype == torch.bfloat16
    lg, caches = registry.decode_step(params, cfg, {"tokens": toks[:, -1:]}, caches)
    assert np.isfinite(lg.numpy()).all()


def test_launch_serve_main_is_seeded():
    """Two runs of ``launch.serve.main`` with one seed generate the same tokens;
    another seed draws other weights."""
    args = ["--device", "cpu", "--reduce", "--batch", "2", "--prompt-len", "16",
            "--max-new", "6"]
    a = launch_serve.main(args)
    b = launch_serve.main(args)
    c = launch_serve.main(args + ["--seed", "1"])
    assert a.shape == (2, 6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_launch_serve_runs_from_the_command_line():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                          "--reduce"], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("generated (4, 32) in ") and "tok/s" in lines[0]
    assert lines[1].startswith("sample: [") and len(eval(lines[1][len("sample: "):])) == 16

"""The port's language-model families against the JAX package: configs and
parameter counts, the forward pass, prefill caches, cached decode and the
MoE dispatch, on reduced configs (b=2, s=64, float32) with the JAX weights
carried across by ``convert.lm_params_from_jax``. Then the JAX package's
own model tests (``tests/test_models.py``, ``tests/test_encdec_moe.py``)
restated on the port, and a ``gpu`` test of the card against the host."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _torch_lm import (ATOL, CPU, RTOL, assert_caches_match, caches_from_jax, inputs, pair,
                       to_jax, to_torch)
from repro.models import encdec as jencdec
from repro.models import registry as jreg
from repro.models import transformer as jtf
from repro.models.moe import _dispatch as jax_dispatch
from repro_torch.models import encdec, registry, transformer
from repro_torch.models.moe import _dispatch

ARCHS = jreg.list_archs()
# zamba2's SSD takes differences of long cumulative sums (``_segsum``), and
# its float32 logits carry that cancellation: the JAX package's own logits
# lie up to 2.4e-5 from a float64 evaluation of the same weights (at |logit|
# up to ~5), so the two packages' float32 runs are held at atol 5e-5
FORWARD_ATOL = {"zamba2-2.7b": 5e-5}


def _tokens(n: int, cfg, b: int = 2, seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, n)).astype(np.int32)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# configs and counts
# ---------------------------------------------------------------------------

def test_registry_tables_match_jax():
    assert registry.list_archs() == jreg.list_archs()
    assert registry.SHAPES == jreg.SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_config_counts_and_reduction_match_jax(arch):
    jcfg, tcfg = jreg.get_config(arch), registry.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert (tcfg.is_attention_free, tcfg.subquadratic) == \
        (jcfg.is_attention_free, jcfg.subquadratic)
    assert dataclasses.asdict(registry.reduced_config(tcfg)) == \
        dataclasses.asdict(jreg.reduced_config(jcfg))
    for shape in registry.SHAPES:
        assert registry.cell_supported(tcfg, shape) == jreg.cell_supported(jcfg, shape)
    assert registry.is_encdec(tcfg) == jreg.is_encdec(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_carry_across_under_the_jax_names(arch):
    """Every JAX leaf lands on one module parameter of its shape and dtype
    (a layers axis unstacked into the module list), and nothing is left."""
    jcfg, jparams, tcfg, model = pair(arch)
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    n_layers = {"blocks": tcfg.n_layers, "blocks_norm": tcfg.n_layers,
                "enc_blocks": tcfg.enc_layers, "dec_blocks": tcfg.dec_layers}
    state = model.state_dict()
    expected = sum(n_layers.get(path[0].key, 1) for path, _ in leaves)
    assert len(state) == expected
    for path, leaf in leaves:
        names = [p.key for p in path]
        if names[0] in n_layers:
            key = f"{names[0]}.0.{'.'.join(names[1:])}"
            shape = leaf.shape[1:]
        else:
            key, shape = ".".join(names), leaf.shape
        assert tuple(state[key].shape) == tuple(shape), key
        assert str(state[key].dtype).removeprefix("torch.") == str(leaf.dtype), key


def test_bfloat16_parameters_carry_across_exactly():
    cfg = dataclasses.replace(jreg.reduced_config(jreg.get_config("smollm-360m")),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams, _ = jreg.init_params(cfg, jax.random.PRNGKey(0))
    from repro_torch.convert import lm_params_from_jax
    state = lm_params_from_jax(jparams, cfg)
    assert state["embed.embedding"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        state["blocks.1.attn.wq"].float().numpy(),
        np.asarray(jparams["blocks"]["attn"]["wq"][1].astype(jnp.float32)))


# ---------------------------------------------------------------------------
# forward, prefill caches, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, jparams, tcfg, model = pair(arch)
    batch = inputs(jcfg)
    want = np.asarray(jreg.forward(jparams, jcfg, to_jax(batch)))
    got = _host(registry.forward(model, tcfg, to_torch(batch)))
    assert got.shape == (2, 64, tcfg.vocab)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=FORWARD_ATOL.get(arch, ATOL))


# (arch, overrides, batch, prompt length, cache size)
PREFILL_CASES = {
    "smollm-360m": ("smollm-360m", {}, 2, 64, 96),
    "stablelm-3b": ("stablelm-3b", {}, 2, 64, 96),
    "qwen3-4b": ("qwen3-4b", {}, 2, 64, 96),
    "qwen1.5-32b": ("qwen1.5-32b", {}, 2, 64, 96),
    # prompt twice the window: the ring wraps; no token drops (see below)
    "mixtral-8x22b": ("mixtral-8x22b", {"capacity_factor": 8.0}, 1, 128, 128),
    "phi3.5-moe-42b-a6.6b": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 8.0}, 2, 64, 96),
    "phi-3-vision-4.2b": ("phi-3-vision-4.2b", {}, 2, 64, 96),
    "rwkv6-3b": ("rwkv6-3b", {}, 2, 64, 96),
    "smollm-360m/int8": ("smollm-360m", {"kv_quant": True}, 2, 64, 96),
    "mixtral-8x22b/int8": ("mixtral-8x22b", {"kv_quant": True, "capacity_factor": 8.0}, 1,
                           128, 128),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_caches_and_decode_match_jax(case):
    """``forward_with_caches`` gives the JAX package's logits and caches
    (ring layout, int8 payloads and scales, RWKV states), and decoding 4
    tokens from each package's own caches gives its logits step by step.
    An int8 payload one apart moves the logits by ~1e-3, so the int8 cases
    decode from the same caches: a copy of JAX's. The MoE cases raise
    ``capacity_factor`` so no token drops (prefill and decode route
    different token counts, as in tests/test_models.py:114)."""
    arch, overrides, b, s, size = PREFILL_CASES[case]
    jcfg, jparams, tcfg, model = pair(arch, **overrides)
    batch = inputs(jcfg, b=b, s=s)
    img = batch.get("img")
    jl, jc = jtf.forward_with_caches(jparams, jcfg, jnp.asarray(batch["tokens"]), size,
                                     img=None if img is None else jnp.asarray(img))
    tb = to_torch(batch)
    tl, tc = transformer.forward_with_caches(model, tcfg, tb["tokens"], size, img=tb.get("img"))
    np.testing.assert_allclose(_host(tl), np.asarray(jl), rtol=RTOL, atol=ATOL)
    assert_caches_match(jc, tc)
    if tcfg.kv_quant:
        tc = caches_from_jax(jc)
    step = jax.jit(jreg.decode_step, static_argnums=1)
    toks = _tokens(4, jcfg, b=b)
    for i in range(4):
        jl, jc = step(jparams, jcfg, {"tokens": jnp.asarray(toks[:, i:i + 1])}, jc)
        tl, tc = registry.decode_step(model, tcfg,
                                      {"tokens": torch.from_numpy(toks[:, i:i + 1]).long()}, tc)
        np.testing.assert_allclose(_host(tl), np.asarray(jl), rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {i}")
    assert_caches_match(jc, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """Per-step ``decode_step`` logits from empty caches (whisper: against
    the precomputed cross K/V of one encoder pass) against JAX's, and the
    caches after the last step."""
    jcfg, jparams, tcfg, model = pair(arch)
    b, n = 2, 8
    toks = _tokens(n, jcfg, b=b)
    if jcfg.family == "encdec":
        frames = inputs(jcfg, b=b)["frames"]
        jc = jencdec.init_decode_caches(jcfg, b, 16, frames.shape[1])
        jc["cross"] = jencdec.precompute_cross_kv(
            jparams, jcfg, jencdec.encode(jparams, jcfg, jnp.asarray(frames)))
        tc = encdec.init_decode_caches(tcfg, b, 16, frames.shape[1], CPU)
        tc["cross"] = encdec.precompute_cross_kv(
            model, tcfg, encdec.encode(model, tcfg, torch.from_numpy(frames)))
        assert_caches_match(jc, tc)
    else:
        jc = jreg.init_caches(jcfg, b, 16)
        tc = registry.init_caches(tcfg, b, 16, device=CPU)
    step = jax.jit(jreg.decode_step, static_argnums=1)
    for i in range(n):
        jl, jc = step(jparams, jcfg, {"tokens": jnp.asarray(toks[:, i:i + 1])}, jc)
        tl, tc = registry.decode_step(model, tcfg,
                                      {"tokens": torch.from_numpy(toks[:, i:i + 1]).long()}, tc)
        np.testing.assert_allclose(_host(tl), np.asarray(jl), rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {i}")
    assert_caches_match(jc, tc)


@pytest.mark.parametrize("size,kv_quant", [(8192, False), (8192, True), (16384, False)])
def test_decode_over_long_caches_matches_jax(size, kv_quant):
    """Caches above 4096 slots: two 4096-slot chunks merged by the online
    softmax (int8: dequantized chunk by chunk), and from 16384 one pass."""
    jcfg, jparams, tcfg, model = pair("smollm-360m", kv_quant=kv_quant)
    toks = _tokens(4, jcfg, b=1)
    jc = jreg.init_caches(jcfg, 1, size)
    tc = registry.init_caches(tcfg, 1, size, device=CPU)
    step = jax.jit(jreg.decode_step, static_argnums=1)
    for i in range(4):
        jl, jc = step(jparams, jcfg, {"tokens": jnp.asarray(toks[:, i:i + 1])}, jc)
        tl, tc = registry.decode_step(model, tcfg,
                                      {"tokens": torch.from_numpy(toks[:, i:i + 1]).long()}, tc)
        np.testing.assert_allclose(_host(tl), np.asarray(jl), rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {i}")
    assert_caches_match(jc, tc)


def test_hybrid_prefill_caches_match_jax_decode():
    """The JAX package's hybrid prefill fails (``_hybrid_prefill`` unpacks
    the K/V cache dict into its key names), so the port's hybrid prefill is
    held against JAX's caches after decoding the same tokens one at a time."""
    jcfg, jparams, tcfg, model = pair("zamba2-2.7b")
    b, s = 2, 32
    toks = _tokens(s, jcfg, b=b)
    with pytest.raises(Exception):
        jtf.forward_with_caches(jparams, jcfg, jnp.asarray(toks), 48)
    jc = jreg.init_caches(jcfg, b, 48)
    step = jax.jit(jreg.decode_step, static_argnums=1)
    for i in range(s):
        jl, jc = step(jparams, jcfg, {"tokens": jnp.asarray(toks[:, i:i + 1])}, jc)
    tl, tc = transformer.forward_with_caches(model, tcfg, torch.from_numpy(toks).long(), 48)
    np.testing.assert_allclose(_host(tl)[:, -1], np.asarray(jl)[:, 0], rtol=RTOL,
                               atol=FORWARD_ATOL["zamba2-2.7b"])
    assert_caches_match(jc, tc, atol=FORWARD_ATOL["zamba2-2.7b"])


# ---------------------------------------------------------------------------
# MoE dispatch
# ---------------------------------------------------------------------------

@given(st.integers(1, 64), st.integers(1, 8), st.integers(1, 2), st.integers(1, 24),
       st.integers(0, 2 ** 31 - 1))
@settings(max_examples=12, deadline=None)   # JAX compiles every new shape (~0.5 s)
def test_moe_dispatch_equals_jax(n_tokens, n_experts, top_k, capacity, seed):
    r = np.random.default_rng(seed)
    eids = r.integers(0, n_experts, n_tokens * top_k).astype(np.int32)
    w = r.uniform(0.1, 1.0, n_tokens * top_k).astype(np.float32)
    tok = np.repeat(np.arange(n_tokens), top_k).astype(np.int32)
    want = jax_dispatch(jnp.asarray(eids), jnp.asarray(w), jnp.asarray(tok), n_experts,
                        capacity)
    got = _dispatch(torch.from_numpy(eids), torch.from_numpy(w), torch.from_numpy(tok),
                    n_experts, capacity)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(_host(g), np.asarray(j))


@given(st.integers(4, 64), st.integers(2, 8), st.integers(1, 2),
       st.integers(0, 2 ** 31 - 1))
@settings(max_examples=50, deadline=None)
def test_moe_dispatch_invariants(n_tokens, n_experts, top_k, seed):
    """tests/test_encdec_moe.py's invariants on the port: every slot holds
    at most one copy; no expert exceeds capacity; kept copies preserve their
    router weight."""
    r = np.random.default_rng(seed)
    eids = torch.from_numpy(r.integers(0, n_experts, n_tokens * top_k))
    w = torch.from_numpy(r.uniform(0.1, 1.0, n_tokens * top_k).astype(np.float32))
    tok = torch.from_numpy(np.repeat(np.arange(n_tokens), top_k))
    cap = max(1, (n_tokens * top_k) // n_experts)
    slot_token, slot_weight, slot_copy = map(_host, _dispatch(eids, w, tok, n_experts, cap))
    assert slot_token.shape == (n_experts * cap,)
    filled = slot_copy >= 0
    assert len(np.unique(slot_copy[filled])) == filled.sum()
    for s in np.flatnonzero(filled):
        c = slot_copy[s]
        assert int(eids[c]) == s // cap
        assert slot_token[s] == int(tok[c])
        assert np.isclose(slot_weight[s], float(w[c]), atol=1e-6)
    for e in range(n_experts):
        routed = int((eids == e).sum())
        assert int(filled[e * cap:(e + 1) * cap].sum()) == min(routed, cap)


def test_moe_top_k_takes_the_lower_expert_on_ties():
    """Equal router probabilities pick the lower expert ids first, as
    ``jax.lax.top_k``; the rows they land in equal JAX's."""
    from repro.models.moe import moe_ffn_local as jax_moe
    from repro_torch.models.moe import moe_ffn_local
    jcfg, jparams, tcfg, model = pair("mixtral-8x22b")
    pm = jax.tree.map(lambda a: a[0], jparams["blocks"]["mlp"])
    zero_router = {**pm, "router": jnp.zeros_like(pm["router"])}
    x = np.random.default_rng(0).normal(size=(16, tcfg.d_model)).astype(np.float32)
    want = np.asarray(jax_moe(zero_router, jcfg, jnp.asarray(x), model_axis=None))
    mlp = model.blocks[0].mlp
    saved = mlp.router.detach().clone()
    try:
        mlp.router.zero_()
        got = _host(moe_ffn_local(mlp, tcfg, torch.from_numpy(x)))
    finally:
        mlp.router.copy_(saved)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# tests/test_models.py and tests/test_encdec_moe.py on the port
# ---------------------------------------------------------------------------

def _port(arch: str, seed: int = 1, **overrides):
    cfg = dataclasses.replace(registry.reduced_config(registry.get_config(arch)), **overrides)
    return cfg, registry.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                                     device=CPU)


@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x22b", "zamba2-2.7b",
                                  "rwkv6-3b"])
def test_decode_consistency(arch):
    """Token-by-token decode equals teacher-forced forward."""
    cfg, params = _port(arch)
    b, n = 2, 12
    toks = torch.from_numpy(_tokens(n, cfg, b=b)).long()
    s_pad = max(cfg.attn_chunk, n)
    full = _host(registry.forward(
        params, cfg, {"tokens": torch.nn.functional.pad(toks, (0, s_pad - n))}))[:, :n]
    caches = registry.init_caches(cfg, b, 128, device=CPU)
    outs = []
    for i in range(n):
        lg, caches = registry.decode_step(params, cfg, {"tokens": toks[:, i:i + 1]}, caches)
        outs.append(_host(lg)[:, 0])
    np.testing.assert_allclose(np.stack(outs, 1), full, rtol=2e-2, atol=2e-4)


def test_vlm_prefill_decode_consistency():
    """VLM: prefill-with-caches must carry the image prefix into decode."""
    cfg, params = _port("phi-3-vision-4.2b")
    b, s = 2, 64
    batch = to_torch(inputs(cfg, b=b, s=s))
    toks, img = batch["tokens"], batch["img"]
    full = _host(registry.forward(params, cfg, {"tokens": toks, "img": img}))
    _, caches = transformer.forward_with_caches(params, cfg, toks[:, :s // 2], 128, img=img)
    outs = []
    for i in range(s // 2, s):
        lg, caches = registry.decode_step(params, cfg, {"tokens": toks[:, i:i + 1]}, caches)
        outs.append(_host(lg)[:, 0])
    np.testing.assert_allclose(np.stack(outs, 1), full[:, s // 2:], rtol=2e-2, atol=2e-4)


def test_sliding_window_ring_cache():
    """SWA prefill->decode stays consistent with full forward beyond W
    (capacity_factor raised so no MoE token drops, as in the JAX test)."""
    cfg, params = _port("mixtral-8x22b", capacity_factor=8.0)
    assert cfg.sliding_window == 64
    b, s = 1, 128                        # prompt 2x the window
    toks = torch.from_numpy(_tokens(s + 8, cfg, b=b, seed=3)).long()
    full = _host(registry.forward(
        params, cfg, {"tokens": torch.nn.functional.pad(toks, (0, 192 - s - 8))}))
    _, caches = transformer.forward_with_caches(params, cfg, toks[:, :s], 128)
    assert caches["kv"]["k"].shape[2] == 64 and caches["len"] == s
    outs = []
    for i in range(s, s + 8):
        lg, caches = registry.decode_step(params, cfg, {"tokens": toks[:, i:i + 1]}, caches)
        outs.append(_host(lg)[:, 0])
    np.testing.assert_allclose(np.stack(outs, 1), full[:, s:s + 8], rtol=2e-2, atol=2e-4)


def test_hybrid_prefill_decode_consistency():
    """The hybrid's prefill caches (mamba states, conv tails and the shared
    attention's K/V) carry on into decode as the full forward does."""
    cfg, params = _port("zamba2-2.7b")
    b, s = 2, 32
    toks = torch.from_numpy(_tokens(s + 8, cfg, b=b)).long()
    full = _host(registry.forward(params, cfg, {"tokens": torch.nn.functional.pad(
        toks, (0, 64 - s - 8))}))
    _, caches = transformer.forward_with_caches(params, cfg, toks[:, :s], 64)
    outs = []
    for i in range(s, s + 8):
        lg, caches = registry.decode_step(params, cfg, {"tokens": toks[:, i:i + 1]}, caches)
        outs.append(_host(lg)[:, 0])
    np.testing.assert_allclose(np.stack(outs, 1), full[:, s:s + 8], rtol=2e-2, atol=2e-4)


def test_long_500k_skip_rules():
    expected_runs = {"mixtral-8x22b", "zamba2-2.7b", "rwkv6-3b"}
    runs = {a for a in registry.list_archs()
            if registry.cell_supported(registry.get_config(a), "long_500k")[0]}
    assert runs == expected_runs


def test_whisper_decode_matches_teacher_forcing():
    cfg, params = _port("whisper-base")
    b, n, enc_len = 2, 10, 64
    r = np.random.default_rng(0)
    toks = torch.from_numpy(r.integers(1, cfg.vocab, (b, n))).long()
    frames = torch.from_numpy((r.normal(size=(b, enc_len, cfg.d_model)) * 0.02)
                              .astype(np.float32))
    pad = max(cfg.attn_chunk, n)
    full = _host(encdec.forward(params, cfg, torch.nn.functional.pad(toks, (0, pad - n)),
                                frames))[:, :n]
    memory = encdec.encode(params, cfg, frames)
    caches = encdec.init_decode_caches(cfg, b, 128, enc_len, CPU)
    caches["cross"] = encdec.precompute_cross_kv(params, cfg, memory)
    outs = []
    for i in range(n):
        lg, caches = encdec.decode_step(params, cfg, toks[:, i:i + 1], caches)
        outs.append(_host(lg)[:, 0])
    err = np.abs(np.stack(outs, 1) - full).max() / (np.abs(full).max() + 1e-9)
    assert err < 2e-2, err


def test_decode_writes_the_cache_in_place_and_never_needs_the_card():
    """The step writes the new K/V slot into the cache tensors it was given
    (no copy of the cache a token) and keeps ``len``/``offset`` host ints."""
    cfg, params = _port("smollm-360m")
    caches = registry.init_caches(cfg, 2, 16, device=CPU)
    k = caches["kv"]["k"]
    _, new = registry.decode_step(params, cfg, {"tokens": torch.ones((2, 1), dtype=torch.long)},
                                  caches)
    assert new["kv"]["k"] is k and (new["len"], new["offset"]) == (1, 0)
    assert isinstance(new["len"], int)
    assert k[:, :, 0].abs().sum() > 0 and k[:, :, 1:].abs().sum() == 0


# ---------------------------------------------------------------------------
# the card against the host (runs on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x22b", "rwkv6-3b", "zamba2-2.7b",
                                  "whisper-base"])
def test_card_matches_host(cuda, arch):
    """Host weights copied to the card: float32 logits of the forward pass
    on the card equal the host's (rtol 1e-4, atol 1e-5; zamba2 at the SSD's
    atol, as against JAX), and decode on the card follows its forward pass."""
    cfg, params = _port(arch, capacity_factor=8.0)
    batch = to_torch(inputs(cfg, b=2, s=64))
    host = _host(registry.forward(params, cfg, batch))
    on_card = params.to(cuda)
    card = _host(registry.forward(on_card, cfg, {k: v.to(cuda) for k, v in batch.items()}))
    np.testing.assert_allclose(card, host, rtol=RTOL, atol=FORWARD_ATOL.get(arch, ATOL))
    if registry.is_encdec(cfg):
        return
    toks = batch["tokens"]
    _, caches = transformer.forward_with_caches(on_card, cfg, toks[:, :32].to(cuda), 64)
    for i in range(32, 36):
        lg, caches = registry.decode_step(on_card, cfg, {"tokens": toks[:, i:i + 1].to(cuda)},
                                          caches)
        np.testing.assert_allclose(_host(lg)[:, 0], host[:, i], rtol=2e-2, atol=2e-4)


@pytest.mark.gpu
def test_card_bf16_decode_stays_near_float32(cuda):
    """bf16 weights and compute on the card: greedy decode logits within
    max |diff| / max |logit| < 0.05 of the float32 forward pass of the same
    weights (tests/test_serve.py:40's bound)."""
    cfg = dataclasses.replace(registry.reduced_config(registry.get_config("smollm-360m")),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    params = registry.init_params(cfg, generator=torch.Generator(cuda).manual_seed(1),
                                  device=cuda)
    toks = torch.from_numpy(_tokens(16, cfg)).long().to(cuda)
    logits, caches = transformer.forward_with_caches(params, cfg, toks, 32)
    gen, steps = [logits[:, -1:].argmax(-1)], []
    for _ in range(8):                     # step j feeds gen[j] at position 16 + j
        lg, caches = registry.decode_step(params, cfg, {"tokens": gen[-1]}, caches)
        steps.append(lg[:, 0].float())
        gen.append(lg[:, -1].argmax(-1)[:, None])
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    want = registry.forward(params.float(), cfg32,
                            {"tokens": torch.cat([toks] + gen[:-1], 1)})[:, 16:24]
    rel = float((torch.stack(steps, 1) - want).abs().max() / want.abs().max())
    assert rel < 0.05, rel


"""The port's train step against the JAX package's, for every family on
reduced configs (b=2, s=64, float32) from weights carried across by
``convert.lm_params_from_jax``: loss, global norm, gradients, AdamW moments
and the updated parameters after one step, five steps for three families,
gradient accumulation, and the conversions of the training state both
ways. A ``gpu`` test holds the card's step against the host's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import (GRAD_ATOL, GRAD_ATOL_BY_ARCH, GRAD_RTOL,  # noqa: F401
                          LOSS_RTOL, assert_leaves_close, assert_params_close,
                          assert_state_matches, jax_step, labelled, one_thread, private_pair,
                          resolved, resolved_v, to_jax, to_torch)
from repro.models import registry as jreg
from repro.train import optimizer as jopt
from repro.train import trainer as jtr
from repro_torch.convert import (lm_params_from_jax, lm_params_to_jax, opt_state_from_jax,
                                 opt_state_to_jax)
from repro_torch.models import registry
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.trainer import build_train_step, loss_fn

ARCHS = jreg.list_archs()
LR = 1e-3


def _port_step(cfg, accum: int = 1, warmup: int = 0):
    return build_train_step(cfg, AdamWConfig(lr=LR, warmup_steps=warmup), accum=accum)


def _metrics_close(tm: dict, jm: dict) -> None:
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=LOSS_RTOL, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_jax(arch):
    """Loss, gradients, grad norm, lr, moments and parameters of one step."""
    jcfg, jparams, tcfg, model = private_pair(arch)
    batch = labelled(jcfg)
    jgrads = jax.grad(jtr.loss_fn)(jparams, jcfg, to_jax(batch))
    jp, jo, jm = jax_step(arch)(jparams, jopt.init_opt_state(jparams), to_jax(batch))

    model.requires_grad_(True)
    loss_fn(model, tcfg, to_torch(batch)).backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    assert_leaves_close(grads, lm_params_from_jax(jgrads, tcfg),
                        GRAD_ATOL_BY_ARCH.get(arch, GRAD_ATOL), GRAD_RTOL, "grad")
    model.zero_grad(set_to_none=True)

    opt = init_opt_state(model)
    model, opt, tm = _port_step(tcfg)(model, opt, to_torch(batch))
    _metrics_close(tm, jm)
    assert all(v.dim() == 0 for v in tm.values())
    assert_state_matches(arch, tcfg, model, opt, jp, jo, LR, 1)


@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x22b", "rwkv6-3b"])
def test_five_train_steps_match_jax(arch):
    """The loss trajectory over five batches, with the learning rate warming
    up over them, and the final state."""
    jcfg, jparams, tcfg, model = private_pair(arch)
    step, jstep = _port_step(tcfg, warmup=5), jax_step(arch, warmup=5)
    jo, opt = jopt.init_opt_state(jparams), init_opt_state(model)
    masks, lr_sum = None, 0.0
    for i in range(5):
        batch = labelled(jcfg, seed=i)
        jparams, jo, jm = jstep(jparams, jo, to_jax(batch))
        model, opt, tm = step(model, opt, to_torch(batch))
        _metrics_close(tm, jm)
        masks, lr_sum = resolved(jo, tcfg, masks), lr_sum + float(jm["lr"])
    assert lr_sum < 5 * LR                      # the warmup ran
    assert_state_matches(arch, tcfg, model, opt, jparams, jo, lr_sum, 5, masks)


@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x22b"])
def test_grad_accumulation_matches_jax(arch):
    """accum=2 against the JAX package's accum=2 (micro-batch i takes rows
    i·b/2 onward, gradients summed in float32), on a batch of 4."""
    jcfg, jparams, tcfg, model = private_pair(arch)
    batch = labelled(jcfg, b=4)
    jp, jo, jm = jax_step(arch, accum=2)(jparams, jopt.init_opt_state(jparams),
                                         to_jax(batch))
    model, opt, tm = _port_step(tcfg, accum=2)(model, init_opt_state(model),
                                               to_torch(batch))
    _metrics_close(tm, jm)
    assert_state_matches(arch, tcfg, model, opt, jp, jo, LR, 1)


# bfloat16 compute rounds differently in XLA and ATen: over one accum=2
# step of the reduced smollm the loss and the global norm were measured
# within 2.4e-4, first moments within 2.7e-2 of a leaf's max and second
# moments within 3.8e-2; each is held at about twice that. A parameter
# moves by up to lr a step either way (Adam's sign(g) step), and its two
# bfloat16 roundings may land one ulp apart (<= 2^-7 of the larger)
BF16_LOSS_RTOL, BF16_M_ATOL, BF16_V_ATOL = 1e-3, 5e-2, 1e-1


def test_bfloat16_grad_accumulation_sums_in_float32():
    """accum=2 on a bfloat16 smollm: against the JAX package's accum=2 at the
    bfloat16 tolerances above, and, exactly up to float32 rounding, against
    the float32 sum of the step's own two bfloat16 micro-gradients (caught as
    each backward leaves them): the first moment after one step is
    (1 - b1)·scale·(g0 + g1)/2, which a bfloat16 sum would miss by up to
    2^-9 of it."""
    arch, bf16 = "smollm-360m", dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg, jparams, tcfg, model = private_pair(arch, **bf16)
    batch = labelled(jcfg, b=4)
    jstep = jax.jit(jtr.build_train_step(jcfg, jopt.AdamWConfig(lr=LR, warmup_steps=0),
                                         accum=2))
    jp, jo, jm = jstep(jparams, jopt.init_opt_state(jparams), to_jax(batch))

    model.requires_grad_(True)
    micro = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: micro.setdefault(n, []).append(p.grad.clone()))
        for n, p in model.named_parameters()]
    model, opt, tm = _port_step(tcfg, accum=2)(model, init_opt_state(model), to_torch(batch))
    for hook in hooks:
        hook.remove()

    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=BF16_LOSS_RTOL,
                                   err_msg=key)
    jo_t = opt_state_from_jax(jo, tcfg)
    assert_leaves_close(opt["m"], jo_t["m"], BF16_M_ATOL, 0.0, "m")
    assert_leaves_close(opt["v"], jo_t["v"], BF16_V_ATOL, 0.0, "v")
    want = lm_params_from_jax(jp, tcfg)
    for name, p in model.named_parameters():
        assert p.dtype == torch.bfloat16 and opt["m"][name].dtype == torch.float32, name
        got, w = p.detach().float(), want[name].float()
        bound = 2 * LR + 2.0 ** -7 * torch.maximum(got.abs(), w.abs())
        assert bool(((got - w).abs() <= bound).all()), name

    scale = torch.clamp(1.0 / torch.clamp(tm["grad_norm"], min=1e-9), max=1.0)
    for name, (g0, g1) in micro.items():
        assert g0.dtype == torch.bfloat16, name
        mean = (g0.float() + g1.float()) / 2
        torch.testing.assert_close(opt["m"][name], mean * scale * (1 - 0.9), rtol=1e-6,
                                   atol=0, msg=name)


def _bits(a) -> np.ndarray:
    """A leaf's raw bits (bfloat16 through its 16-bit integer view)."""
    if torch.is_tensor(a):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = jnp.asarray(a)
    return np.asarray(jax.lax.bitcast_convert_type(a, jnp.int16) if a.dtype == jnp.bfloat16
                      else a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_training_state_round_trips_bit_for_bit(arch, dtype):
    """lm_params_to_jax(lm_params_from_jax(p)) == p and the same for the AdamW
    state, every leaf in its dtype and stacked shape."""
    cfg = dataclasses.replace(jreg.reduced_config(jreg.get_config(arch)), param_dtype=dtype,
                              compute_dtype=dtype)
    params, _ = jreg.init_params(cfg, jax.random.PRNGKey(3))
    opt = jopt.init_opt_state(params)
    opt = {"m": jax.tree.map(lambda p: p.astype(jnp.float32) * 0.5, params),
           "v": jax.tree.map(lambda p: jnp.square(p.astype(jnp.float32)), params),
           "step": jnp.asarray(7, jnp.int32)}
    for back, want in ((lm_params_to_jax(lm_params_from_jax(params, cfg), cfg), params),
                       (opt_state_to_jax(opt_state_from_jax(opt, cfg), cfg), opt)):
        got_leaves = jax.tree_util.tree_leaves_with_path(back)
        want_leaves = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, g), (_, w) in zip(got_leaves, want_leaves):
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
            assert tuple(g.shape) == tuple(w.shape), path
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(path))


def test_to_jax_refuses_a_depth_the_config_does_not_have():
    jcfg, jparams, tcfg, model = private_pair("smollm-360m")
    state = {k: v for k, v in model.state_dict().items() if not k.startswith("blocks.1.")}
    with pytest.raises(ValueError, match="layers"):
        lm_params_to_jax(state, tcfg)


# ---------------------------------------------------------------------------
# the card against the host (runs on the card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_card_train_step_matches_host(cuda, arch):
    """One float32 step of the reduced config: host weights copied to the
    card; loss, grad norm, moments and parameters as against JAX."""
    jcfg, jparams, tcfg, host = private_pair(arch)
    batch = labelled(jcfg)
    card = registry.init_params(tcfg, device=cuda)
    card.load_state_dict(host.state_dict())
    hm, ho, hmet = _port_step(tcfg)(host, init_opt_state(host), to_torch(batch))
    cm, co, cmet = _port_step(tcfg)(card, init_opt_state(card),
                                    {k: v.to(cuda) for k, v in to_torch(batch).items()})
    assert cmet["loss"].device.type == "cuda"
    _metrics_close({k: v.cpu() for k, v in cmet.items()}, hmet)
    atol = GRAD_ATOL_BY_ARCH.get(arch, GRAD_ATOL)
    assert_leaves_close(co["m"], ho["m"], atol, GRAD_RTOL, "m")
    assert_leaves_close(co["v"], ho["v"], 2 * atol, 2 * GRAD_RTOL, "v")
    assert_params_close(dict(cm.named_parameters()), dict(hm.named_parameters()),
                        resolved_v(ho["v"]), LR)

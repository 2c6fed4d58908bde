"""Shared helpers of the training parity tests: one reduced architecture in
both packages from the same JAX weights (a private copy of the port's
module, which the model tests share), a labelled batch, the JAX train step
jitted once per configuration, and the tolerances of a step."""
from __future__ import annotations

import copy
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_lm import inputs, pair, to_jax, to_torch  # noqa: F401
from repro.train import optimizer as jopt
from repro.train import trainer as jtr
from repro_torch.convert import lm_params_from_jax, opt_state_from_jax

# float32 loss and global norm of the same computation in XLA and ATen
LOSS_RTOL = 1e-5
# gradients and first moments: |diff| <= GRAD_ATOL x the leaf's max |JAX| +
# GRAD_RTOL x |JAX|; zamba2's SSD (``_segsum`` differences of long cumulative
# sums) carries its float32 cancellation into the gradients too: measured up
# to 1.8e-5 of a leaf's max (``blocks.0.A_log``), so it is held at 5e-5, as
# its logits are held at 5x the others' atol
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
GRAD_ATOL_BY_ARCH = {"zamba2-2.7b": 5e-5}
# the parameters after AdamW steps: an element whose second moment was
# resolved after every step (sqrt(v) above 1e-3 of its leaf's max) moves by
# lr x m̂/(sqrt(v̂) + eps) a step, whose float32 rounding differs by ~1e-4
# (measured <= 6.6e-4 of the summed lr over one step of the ten families
# and 3.8e-4 over five steps of three), so it is held at 2e-3 of the summed
# lr; elsewhere a gradient was zero up to its tolerance, m̂/(sqrt(v̂) + eps)
# is 0/0-like and a rounding can flip its sign, so a step may differ by up
# to 2 lr
RESOLVED, RESOLVED_LR_FRAC = 1e-3, 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Run a module's tests on one intra-op thread. The training tests run
    many small ops; beside five other test workers on the same cores, the
    default pool's threads wait on each other (a 32-step loop took 295 s
    that way, 3 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def labelled(cfg, b: int = 2, s: int = 64, seed: int = 0) -> dict[str, np.ndarray]:
    """``_torch_lm.inputs`` with next-token labels, -1 at the last position."""
    batch = inputs(cfg, b=b, s=s, seed=seed)
    labels = np.roll(batch["tokens"], -1, axis=1)
    labels[:, -1] = -1
    batch["labels"] = labels.astype(np.int32)
    return batch


def private_pair(arch: str, **overrides):
    """``_torch_lm.pair`` with a deep copy of the port's (shared) module, so
    training does not change the weights under the other tests."""
    jcfg, jparams, tcfg, model = pair(arch, **overrides)
    return jcfg, jparams, tcfg, copy.deepcopy(model)


@functools.lru_cache(maxsize=None)
def jax_step(arch: str, accum: int = 1, lr: float = 1e-3, warmup: int = 0):
    jcfg = pair(arch)[0]
    return jax.jit(jtr.build_train_step(jcfg, jopt.AdamWConfig(lr=lr, warmup_steps=warmup),
                                        accum=accum))


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def assert_leaves_close(got: dict, want: dict, atol_frac: float, rtol: float, what: str):
    """Each leaf within atol_frac x the leaf's max |want| + rtol x |want|."""
    assert set(got) == set(want), set(got) ^ set(want)
    for name, w in want.items():
        w, g = _np(w), _np(got[name])
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_frac * scale,
                                   err_msg=f"{what} {name}")


def resolved(jopt_state, cfg, before: dict | None = None) -> dict[str, np.ndarray]:
    """Per leaf, the elements whose JAX second moment is resolved (by the
    rule above), and-ed with ``before`` (the masks of the earlier steps)."""
    return resolved_v(opt_state_from_jax(jopt_state, cfg)["v"], before)


def resolved_v(second_moments: dict, before: dict | None = None) -> dict[str, np.ndarray]:
    """``resolved`` of a port state's ``v``."""
    out = {}
    for name, v in second_moments.items():
        root = _np(v) ** 0.5
        out[name] = root > RESOLVED * root.max()
        if before is not None:
            out[name] &= before[name]
    return out


def assert_state_matches(arch, cfg, model, opt, jparams, jopt_state, lr_sum: float,
                         n_steps: int, masks: dict | None = None):
    """The port's parameters and AdamW state against the JAX package's after
    ``n_steps`` steps of learning rates summing to ``lr_sum``, by the rules
    above; ``masks`` are ``resolved``'s over every step (default: the last).
    A moment sums ``n_steps`` gradients, each within the gradient tolerance,
    so the moments are held at ``n_steps`` times it."""
    atol = GRAD_ATOL_BY_ARCH.get(arch, GRAD_ATOL) * n_steps
    jp = lm_params_from_jax(jparams, cfg)
    jo = opt_state_from_jax(jopt_state, cfg)
    masks = masks if masks is not None else resolved(jopt_state, cfg)
    assert int(opt["step"]) == int(jo["step"]) == n_steps
    assert_leaves_close(opt["m"], jo["m"], atol, GRAD_RTOL, "m")
    # v ~ g², so its relative error is twice the gradient's
    assert_leaves_close(opt["v"], jo["v"], 2 * atol, 2 * GRAD_RTOL, "v")
    assert_params_close(dict(model.named_parameters()), jp, masks, lr_sum)


def assert_params_close(params: dict, want: dict, masks: dict, lr_sum: float) -> None:
    """Parameters after AdamW steps of learning rates summing to ``lr_sum``:
    within RESOLVED_LR_FRAC x lr_sum where ``masks`` (``resolved``) holds,
    2 x lr_sum elsewhere."""
    assert set(params) == set(want)
    for name, w in want.items():
        diff = np.abs(_np(params[name]) - _np(w))
        bound = np.where(masks[name], RESOLVED_LR_FRAC, 2.0) * lr_sum
        bad = diff > bound
        assert not bad.any(), (name, float(diff[bad].max()), int(bad.sum()))

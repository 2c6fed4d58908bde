"""Shared helpers of the language-model parity tests: one architecture
built in both packages from the same JAX weights, the same numpy inputs
for both, and cache comparisons."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import registry as jreg
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import registry as treg

CPU = torch.device("cpu")
# float32 logits of the same computation in XLA and ATen (sums in another order)
RTOL, ATOL = 1e-4, 1e-5
# int8 KV payloads: x/scale may land on .5 in one package and not the other
INT8_MAX_DIFF, INT8_MAX_FRACTION = 1, 1e-3


@functools.lru_cache(maxsize=None)
def pair(arch: str, seed: int = 0, **overrides):
    """(JAX cfg, JAX params, port cfg, port model on the host): the reduced
    config of ``arch`` with ``overrides``, JAX weights from PRNGKey(seed)
    carried into the port by ``lm_params_from_jax``."""
    jcfg = dataclasses.replace(jreg.reduced_config(jreg.get_config(arch)), **overrides)
    tcfg = dataclasses.replace(treg.reduced_config(treg.get_config(arch)), **overrides)
    jparams, _ = jreg.init_params(jcfg, jax.random.PRNGKey(seed))
    model = treg.init_params(tcfg, device=CPU)
    model.load_state_dict(lm_params_from_jax(jparams, tcfg), strict=True)
    return jcfg, jparams, tcfg, model


def inputs(cfg, b: int = 2, s: int = 64, seed: int = 0) -> dict[str, np.ndarray]:
    """Tokens (and the image stub or audio frames the family takes), as in
    ``tests/test_models.py:_batch_for``."""
    r = np.random.default_rng(seed)
    out = {"tokens": r.integers(1, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["img"] = (r.normal(size=(b, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (r.normal(size=(b, s, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def flat(caches, prefix: str = "") -> dict:
    out = {}
    for k, v in caches.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def caches_from_jax(jcaches) -> dict:
    """A JAX cache tree as the port's: tensors of the same dtypes (the
    bfloat16 int8 scales exactly, through float32), host-int lengths."""
    out = {}
    for k, v in jcaches.items():
        if isinstance(v, dict):
            out[k] = caches_from_jax(v)
        elif v.ndim == 0:
            out[k] = int(v)
        elif v.dtype == jnp.bfloat16:
            out[k] = torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def assert_caches_match(jcaches, tcaches, rtol=RTOL, atol=ATOL) -> None:
    """Every leaf equal in shape and dtype; ``len``/``offset`` equal;
    float leaves within (rtol, atol); int8 payloads by the int8 rule,
    their bfloat16 scales at rtol 1e-6."""
    j, t = flat(jcaches), flat(tcaches)
    assert set(j) == set(t), (set(j) ^ set(t))
    for key, jv in j.items():
        tv = t[key]
        if not torch.is_tensor(tv):
            assert int(jv) == tv, key
            continue
        jn = np.asarray(jv.astype(jnp.float32) if jv.dtype == jnp.bfloat16 else jv)
        assert tuple(jn.shape) == tuple(tv.shape), key
        assert str(jv.dtype) == str(tv.dtype).removeprefix("torch."), (key, jv.dtype, tv.dtype)
        tn = tv.float().numpy() if tv.dtype == torch.bfloat16 else tv.numpy()
        if jn.dtype == np.int8:
            diff = np.abs(jn.astype(np.int32) - tn.astype(np.int32))
            assert diff.max() <= INT8_MAX_DIFF, key
            assert (diff > 0).mean() <= INT8_MAX_FRACTION, (key, (diff > 0).mean())
        elif key.endswith("_scale"):
            np.testing.assert_allclose(tn, jn, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_allclose(tn, jn, rtol=rtol, atol=atol, err_msg=key)

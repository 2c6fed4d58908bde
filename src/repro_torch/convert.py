"""Carry state from the JAX package into the port.

Both packages keep their state in arrays of the same layout, so a
conversion is a typed copy (a language model's stacked layers unstacked
into the port's module lists). The functions take the JAX package's
objects by duck type and import nothing of it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.profiles import LakeProfiles


def gbdt_from_jax(params) -> GBDTParams:
    """``repro.core.gbdt.GBDTParams`` -> the port's ``GBDTParams``."""
    return GBDTParams(feats=np.asarray(params.feats, np.int32).copy(),
                      thrs=np.asarray(params.thrs, np.float32).copy(),
                      leaves=np.asarray(params.leaves, np.float32).copy(),
                      base=float(params.base))


def profiles_from_jax(profiles) -> LakeProfiles:
    """``repro.core.profiles.LakeProfiles`` -> the port's ``LakeProfiles``."""
    return LakeProfiles(numeric=np.asarray(profiles.numeric, np.float32).copy(),
                        words=np.asarray(profiles.words, np.uint32).copy(),
                        n_rows=np.asarray(profiles.n_rows, np.int32).copy(),
                        mean=np.asarray(profiles.mean, np.float32).copy(),
                        std=np.asarray(profiles.std, np.float32).copy())


# JAX parameter subtrees stacked on a leading ``layers`` axis; the port keeps
# one module a layer in an ``nn.ModuleList``
_STACKED = ("blocks", "enc_blocks", "dec_blocks", "blocks_norm")


def _leaf_to_torch(a) -> torch.Tensor:
    """A numpy-convertible array -> tensor of the same dtype. bfloat16 goes
    through float32 (every bfloat16 value is a float32 value, so both steps
    are exact) and needs no bfloat16 type on the numpy side."""
    if str(getattr(a, "dtype", "")) == "bfloat16":
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def lm_params_from_jax(params, cfg) -> dict[str, torch.Tensor]:
    """A JAX language-model parameter tree (``repro.models.registry.
    init_params(cfg, key)[0]``: nested dicts of arrays) -> the port's module
    state (``model.load_state_dict`` of ``repro_torch.models.registry.
    init_params(cfg, ...)``), with every stacked ``layers`` axis
    (``blocks``, zamba2's ``blocks_norm``, whisper's ``enc_blocks`` and
    ``dec_blocks``) unstacked into the ``ModuleList``'s index. ``cfg`` is
    the architecture both were built for; it names the expected depths."""
    depth = {"blocks": cfg.n_layers, "blocks_norm": cfg.n_layers,
             "enc_blocks": cfg.enc_layers, "dec_blocks": cfg.dec_layers}
    state: dict[str, torch.Tensor] = {}

    def walk(tree, top: str, path: str) -> None:
        for name, sub in tree.items():
            if isinstance(sub, dict):
                walk(sub, top, f"{path}{name}.")
            elif top in _STACKED:
                layers = _leaf_to_torch(sub)
                if layers.shape[0] != depth[top]:
                    raise ValueError(f"{top}.{path}{name}: {layers.shape[0]} layers, "
                                     f"the config has {depth[top]}")
                for i, leaf in enumerate(layers):
                    state[f"{top}.{i}.{path}{name}"] = leaf.clone()
            else:
                state[f"{top}.{path}{name}"] = _leaf_to_torch(sub)

    for top, tree in params.items():
        walk(tree, top, "")
    return state

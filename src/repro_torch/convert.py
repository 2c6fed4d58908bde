"""Carry state between the JAX package and the port.

Both packages keep their state in arrays of the same layout, so a
conversion is a typed copy (a language model's stacked layers unstacked
into the port's module lists, and stacked again on the way back). The
functions take the JAX package's objects by duck type and import nothing
of it. The way back gives the JAX package's tree of torch tensors: numpy
has no bfloat16 without the ``ml_dtypes`` package, which the port does not
need; the checkpoint manager writes that tree in the JAX file format.
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


def _depths(cfg) -> dict[str, int]:
    """Each stacked subtree's number of layers under ``cfg``."""
    return {"blocks": cfg.n_layers, "blocks_norm": cfg.n_layers,
            "enc_blocks": cfg.enc_layers, "dec_blocks": cfg.dec_layers}


def _leaf_to_torch(a) -> torch.Tensor:
    """A numpy-convertible array (or a tensor, as is) -> tensor of the same
    dtype. bfloat16 goes through float32 (every bfloat16 value is a float32
    value, so both steps are exact) and needs no bfloat16 type on the numpy
    side."""
    if torch.is_tensor(a):
        return a
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
    depth = _depths(cfg)
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


def lm_params_to_jax(model_or_state, cfg) -> dict:
    """The inverse of ``lm_params_from_jax``: the port's module (or its
    ``state_dict``, or any mapping of the same names) -> the JAX package's
    nested dicts, every ``ModuleList`` restacked on a leading ``layers``
    axis. The leaves are torch tensors (stacked ones new, the others the
    state's own), on the state's device, in its dtypes."""
    state = (model_or_state.state_dict() if isinstance(model_or_state, torch.nn.Module)
             else model_or_state)
    depth = _depths(cfg)
    tree: dict = {}
    layers: dict[tuple[str, ...], dict[int, torch.Tensor]] = {}
    for key, t in state.items():
        parts = key.split(".")
        if parts[0] in _STACKED:
            layers.setdefault((parts[0], *parts[2:]), {})[int(parts[1])] = t.detach()
        else:
            _put(tree, parts, t.detach())
    for (top, *path), by_layer in layers.items():
        if sorted(by_layer) != list(range(depth[top])):
            raise ValueError(f"{top}.*.{'.'.join(path)}: layers {sorted(by_layer)}, the "
                             f"config has {depth[top]}")
        _put(tree, [top, *path], torch.stack([by_layer[i] for i in range(depth[top])]))
    return tree


def _put(tree: dict, path, leaf) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = leaf


def opt_state_from_jax(opt_state, cfg) -> dict:
    """A JAX AdamW state (``repro.train.optimizer.init_opt_state``: ``m`` and
    ``v`` trees like the parameters', a 0-d int32 ``step``) -> the port's
    (``repro_torch.train.optimizer``): ``m`` and ``v`` keyed by parameter
    name, ``step`` a 0-d int32 tensor, on the host."""
    return {"m": lm_params_from_jax(opt_state["m"], cfg),
            "v": lm_params_from_jax(opt_state["v"], cfg),
            "step": torch.tensor(int(np.asarray(opt_state["step"])), dtype=torch.int32)}


def opt_state_to_jax(opt_state, cfg) -> dict:
    """The inverse of ``opt_state_from_jax``: the JAX package's layout, the
    leaves torch tensors on the state's device."""
    return {"m": lm_params_to_jax(opt_state["m"], cfg),
            "v": lm_params_to_jax(opt_state["v"], cfg),
            "step": opt_state["step"].detach()}

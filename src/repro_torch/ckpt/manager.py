"""Atomic, keep-N checkpoints in the JAX package's file format.

The port of ``repro.ckpt.manager``. One ``ckpt_{step:08d}.npz`` a step
holds the flattened leaves as ``a0``, ``a1``, ... and a ``__manifest__``
JSON of the step and the leaves' key paths. A tree flattens as JAX's
``tree_flatten_with_path`` does: dict keys in sorted order, tuple and list
items by index, keys joined by ``/``. Writes go to ``tmp.<step>.npz`` and
then ``os.replace``, so a crash mid-write never corrupts the latest
checkpoint.

Leaves may be numpy arrays or torch tensors (written from the host). A
bfloat16 leaf is written as JAX writes it, as 2-byte void bits, and read
back as bfloat16 bits wherever the like-tree leaf is a bfloat16 tensor; no
``ml_dtypes`` is needed. The training state of a language model is saved
in the JAX package's layout (``(params, opt_state)``, stacked blocks) by
``save_train_state``, and ``restore_train_state`` writes a checkpoint into
the existing parameter and moment tensors on their device, so either
package resumes from the other's files. A state placed on a mesh
(``dist.sharding.ShardedModel``, ZeRO-1 moments) is gathered into the same
layout to save, and a restore writes every shard from the full leaves, so
a sharded run and an unsharded one resume each other.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch.convert import (lm_params_from_jax, lm_params_to_jax, opt_state_from_jax,
                                 opt_state_to_jax)
from repro_torch.dist.collectives import Sharded, gather
from repro_torch.dist.sharding import ShardedModel

_HOST = torch.device("cpu")


def _host(t) -> torch.Tensor:
    """A leaf (a tensor or a ``Sharded`` one) whole on the host."""
    if isinstance(t, Sharded):
        with torch.no_grad():
            return gather(t, _HOST)
    return t.detach().cpu()


def _params(model) -> dict:
    """name -> tensor (or ``Sharded``) of a module or a ``ShardedModel``."""
    return dict(model.leaves) if isinstance(model, ShardedModel) else model.state_dict()

_BF16_BITS = np.dtype("V2")


def _flatten(tree, prefix: str = ""):
    """(keys, leaves) in JAX's order: dicts by sorted key, sequences by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [prefix[:-1]], [tree]
    keys, leaves = [], []
    for k, v in items:
        ks, ls = _flatten(v, f"{prefix}{k}/")
        keys += ks
        leaves += ls
    return keys, leaves


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in ``_flatten``'s order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _to_numpy(leaf) -> np.ndarray:
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def _from_numpy(a: np.ndarray, like):
    """A loaded array in the form of its like-tree leaf: a host tensor of the
    like tensor's dtype (bfloat16 from its bits), or the array as loaded."""
    if not torch.is_tensor(like):
        return a
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {a.shape}, expected {tuple(like.shape)}")
    if like.dtype == torch.bfloat16:
        want = _BF16_BITS
    else:
        want = torch.empty((), dtype=like.dtype).numpy().dtype
    if a.dtype != want:
        raise ValueError(f"checkpoint leaf of dtype {a.dtype}, expected {like.dtype}")
    if like.dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def save(self, step: int, tree) -> str:
        keys, leaves = _flatten(tree)
        arrays = {f"a{i}": _to_numpy(v) for i, v in enumerate(leaves)}
        manifest = {"step": step, "keys": keys}
        tmp = os.path.join(self.dir, f"tmp.{step}.npz")
        final = self._path(step)
        np.savez(tmp, __manifest__=json.dumps(manifest), **arrays)
        os.replace(tmp, final)                      # atomic on POSIX
        self._gc()
        return final

    def latest_step(self) -> int | None:
        steps = [int(m.group(1)) for f in os.listdir(self.dir)
                 if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
        return max(steps) if steps else None

    def restore(self, step: int, like_tree):
        """The checkpoint of ``step`` in the structure of ``like_tree``: a
        numpy leaf's place gets the array as stored, a tensor leaf's place a
        host tensor of its dtype and shape. Returns (tree, step)."""
        with np.load(self._path(step), allow_pickle=False) as z:
            manifest = json.loads(str(z["__manifest__"]))
            keys, likes = _flatten(like_tree)
            assert keys == manifest["keys"], "checkpoint/model structure mismatch"
            loaded = [_from_numpy(z[f"a{i}"], like) for i, like in enumerate(likes)]
        return _unflatten(like_tree, loaded), manifest["step"]

    def save_train_state(self, step: int, model, opt_state: dict, cfg) -> str:
        """Save a language model's ``(params, opt_state)`` in the JAX
        package's layout (host copies, blocks stacked)."""
        host = {k: _host(v) for k, v in _params(model).items()}
        opt = {"m": {k: _host(v) for k, v in opt_state["m"].items()},
               "v": {k: _host(v) for k, v in opt_state["v"].items()},
               "step": opt_state["step"].cpu()}
        return self.save(step, (lm_params_to_jax(host, cfg), opt_state_to_jax(opt, cfg)))

    def restore_train_state(self, step: int, model, opt_state: dict, cfg) -> int:
        """Write the checkpoint of ``step`` into ``model``'s parameters and
        ``opt_state``'s tensors, in place on their device. Returns the step
        stored."""
        def layout(state):                  # shapes and dtypes only
            return lm_params_to_jax({k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                                     for k, v in state.items()}, cfg)

        like = (layout(_params(model)), {"m": layout(opt_state["m"]),
                                         "v": layout(opt_state["v"]),
                                         "step": opt_state["step"]})
        (params, opt), stored = self.restore(step, like)
        with torch.no_grad():
            if isinstance(model, ShardedModel):
                model.load_(lm_params_from_jax(params, cfg))
            else:
                model.load_state_dict(lm_params_from_jax(params, cfg), strict=True)
            got = opt_state_from_jax(opt, cfg)
            for part in ("m", "v"):
                for k, t in opt_state[part].items():
                    if isinstance(t, Sharded):
                        t.write_(got[part][k])
                    else:
                        t.copy_(got[part][k])
            opt_state["step"].copy_(got["step"])
        return stored

    def _gc(self):
        steps = sorted([int(m.group(1)) for f in os.listdir(self.dir)
                        if (m := re.match(r"ckpt_(\d+)\.npz$", f))])
        for s in steps[:-self.keep]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

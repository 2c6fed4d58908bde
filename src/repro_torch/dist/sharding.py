"""MaxText-style logical-axis sharding rules, and parameters placed by them.

The port of ``repro.dist.sharding``. ``models.registry.param_specs(cfg)``
gives a spec tree whose leaves are tuples of *logical* axis names
(``"embed"``, ``"heads"``, ``"mlp"``, ...), in the JAX package's nested
layout with the stacked ``layers`` axis first. This module owns the single
mapping from logical axes to physical mesh axes, switched by a
process-global *mode*, with the JAX package's rules verbatim:

* ``tp``   — tensor parallel: head/mlp/vocab/expert axes over ``model``;
* ``fsdp`` — tp + the ``embed`` axis sharded over the batch axes
  (parameter-sharded data parallelism);
* ``dp``   — pure data parallel: parameters fully replicated.

``batch_axes`` names the mesh axes that carry the batch (``data``, plus
``pod`` on multi-pod meshes); optimizer moments get an extra ZeRO-1 shard
over those axes via ``zero1_shardings``.

A :class:`PartitionSpec` is a tuple of mesh-axis entries (a name, a tuple
of names, or ``None``) and a :class:`NamedSharding` pairs it with a
``launch.mesh.DeviceMesh``. The port keeps one controller, as the JAX
package does: :func:`place_params` stores every leaf of a model split as
its sharding says (``dist.collectives.Sharded``, one shard a mesh
position), and a :class:`ShardedModel` hands each data rank's forward pass
a view whose leaves are gathered onto that rank's device when they are
read (``ShardedModel.view``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.convert import _STACKED, _depths, lm_params_to_jax
from repro_torch.dist.collectives import Sharded, axis_size, gather, place

_MODE = "tp"
_MODES = ("tp", "fsdp", "dp")

# logical axes that ride the model axis under tensor parallelism
_MODEL_AXES = ("heads", "kv", "mlp", "vocab", "expert", "conv", "state")


class PartitionSpec(tuple):
    """Per tensor dimension, the mesh axis (a name), the axes (a tuple of
    names, major first) or ``None`` (replicated) it is split over. A tuple
    of one name is that name, as in JAX's ``PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1 else a
                                     for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class DuplicateSpecError(ValueError):
    """A spec maps one mesh axis to more than one dimension (JAX's
    exception of the same name)."""


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A (mesh, spec) pair: how one tensor lies over a ``DeviceMesh``. A
    mesh axis splits at most one dimension: :class:`DuplicateSpecError`
    otherwise, as in JAX (e.g. ``zero1_shardings`` under ``fsdp``, where the
    batch axes already split ``embed``)."""
    mesh: object
    spec: PartitionSpec

    def __post_init__(self):
        used = [a for e in self.spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        if len(used) != len(set(used)):
            raise DuplicateSpecError(f"{self.spec} maps a mesh axis to more than one "
                                     "dimension")

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The per-device block of a ``shape`` tensor: each dimension over
        the product of its mesh axes, rounded up (the padded block XLA's
        buffers hold where a dimension does not divide)."""
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(-(-int(d) // axis_size(self.mesh, a)) for d, a in zip(shape, spec))


def set_mode(mode: str) -> None:
    global _MODE
    if mode not in _MODES:
        raise ValueError(f"unknown sharding mode {mode!r}; want one of {_MODES}")
    _MODE = mode


def get_mode() -> str:
    return _MODE


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that carry the global batch (pod-major on multi-pod)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _is_spec(v) -> bool:
    return isinstance(v, tuple)


def _physical(logical: str, mesh):
    """Mesh axis (or axes tuple) for one logical axis under the current mode."""
    if _MODE == "dp":
        return None
    if logical in _MODEL_AXES and "model" in mesh.axis_names:
        return "model"
    if logical == "embed" and _MODE == "fsdp":
        ba = batch_axes(mesh)
        return ba if ba else None
    return None


def spec_of(spec: tuple, mesh) -> PartitionSpec:
    """Logical spec tuple -> PartitionSpec under the current mode."""
    return P(*[_physical(s, mesh) for s in spec])


def _fit_spec(spec: tuple, shape, mesh) -> PartitionSpec:
    """spec_of with a divisibility check: a dimension that does not divide
    evenly over its mesh axes falls back to replication (small/reduced
    configs on big meshes)."""
    axes = []
    for logical, dim in zip(spec, shape):
        phys = _physical(logical, mesh)
        n = axis_size(mesh, phys)
        axes.append(phys if n > 1 and dim % n == 0 and dim >= n else None)
    return P(*axes)


def _map(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a nested dict of logical specs (and trees
    of the same structure)."""
    if _is_spec(specs):
        return fn(specs, *trees)
    return {k: _map(fn, v, *(t[k] for t in trees)) for k, v in specs.items()}


def param_shardings(specs, mesh, params=None):
    """NamedSharding tree for parameters.

    ``params`` (anything with a ``.shape`` a leaf, in the specs' layout)
    enables the divisibility fallback; without it the raw mode rules apply.
    """
    if params is None:
        return _map(lambda s: NamedSharding(mesh, spec_of(s, mesh)), specs)
    return _map(lambda s, p: NamedSharding(mesh, _fit_spec(s, p.shape, mesh)),
                specs, params)


def zero1_shardings(specs, params, mesh):
    """Optimizer-moment shardings: the param sharding plus a ZeRO-1 shard of
    the largest still-replicated dimension over the batch axes."""
    ba = batch_axes(mesh)
    nba = axis_size(mesh, ba)

    def one(spec, p):
        axes = list(_fit_spec(spec, p.shape, mesh))
        if nba > 1:
            order = sorted(range(len(axes)), key=lambda i: -p.shape[i])
            for i in order:
                if axes[i] is None and p.shape[i] % nba == 0 and p.shape[i] >= nba:
                    axes[i] = ba
                    break
        return NamedSharding(mesh, P(*axes))

    return _map(one, specs, params)


# ---------------------------------------------------------------------------
# the port's parameters on a mesh
# ---------------------------------------------------------------------------

def jax_layout(model, cfg) -> dict:
    """A model's (or a name -> tensor mapping's) leaves in the JAX package's
    nested layout, stacked layers first, as ``meta`` tensors: the shapes
    ``param_shardings(..., params=)`` and ``zero1_shardings`` read."""
    named = (dict(model.named_parameters()) if isinstance(model, torch.nn.Module)
             else dict(model))
    return lm_params_to_jax({n: torch.empty(t.shape, dtype=t.dtype, device="meta")
                             for n, t in named.items()}, cfg)


def jax_leaf(tree, name: str):
    """The leaf of a JAX-layout tree that port name ``name`` maps to
    (``blocks.3.attn.wq`` -> ``tree["blocks"]["attn"]["wq"]``), and the
    layer index for a leaf of a stacked subtree (else None)."""
    parts = name.split(".")
    stacked = parts[0] in _STACKED
    node = tree
    for key in ([parts[0], *parts[2:]] if stacked else parts):
        node = node[key]
    return node, int(parts[1]) if stacked else None


def per_leaf(tree, names, cfg) -> dict[str, tuple]:
    """A tree in the JAX layout (e.g. of NamedSharding) -> per port name,
    the tree's leaf and, for a leaf of a stacked subtree, (layer, depth);
    else None."""
    depth = _depths(cfg)
    out = {}
    for name in names:
        node, layer = jax_leaf(tree, name)
        out[name] = (node, None if layer is None else (layer, depth[name.split(".")[0]]))
    return out


class ShardedModel:
    """A model's parameters placed on a mesh: per ``named_parameters`` name
    (in that order) a :class:`~repro_torch.dist.collectives.Sharded` leaf,
    each shard a leaf tensor on its mesh position's device."""

    def __init__(self, mesh, leaves: dict[str, Sharded]):
        self.mesh = mesh
        self.leaves = leaves

    def shard_tensors(self):
        """Every shard, leaf by leaf, mesh position by position."""
        for sh in self.leaves.values():
            yield from sh.shards.values()

    def requires_grad_(self, flag: bool = True) -> "ShardedModel":
        for t in self.shard_tensors():
            t.requires_grad_(flag)
        return self

    def full(self, device="cpu") -> dict[str, torch.Tensor]:
        """Every leaf gathered whole onto ``device``, as new tensors: the
        module's state."""
        with torch.no_grad():
            return {n: gather(sh, torch.device(device)).detach().clone()
                    for n, sh in self.leaves.items()}

    def load_(self, state) -> None:
        """Write full tensors (name -> tensor, any device) into every shard."""
        with torch.no_grad():
            for name, sh in self.leaves.items():
                sh.write_(state[name])

    def view(self, device, data_index: int | None):
        """The parameters as the model functions read them, for one data
        rank's forward pass on ``device``: attribute access walks the module
        tree, and a leaf read is gathered onto ``device`` there and then
        (inside a rematerialised block it is gathered again in the backward
        pass instead of kept). Replicas in data row ``data_index`` are
        preferred; ``None`` marks a forward over every row's tokens."""
        root: dict = {}
        for name in self.leaves:
            *path, leaf = name.split(".")
            node = root
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = name
        return _View(self, root, torch.device(device), data_index)


class _View:
    """One module of a :meth:`ShardedModel.view`: submodules and lists of
    them as attributes, leaves gathered on read."""

    def __init__(self, model: ShardedModel, node: dict, device, data_index):
        self._model, self._device, self._data = model, device, data_index
        self._leaves = {}
        for key, sub in node.items():
            if isinstance(sub, str):
                self._leaves[key] = sub
            elif all(k.isdigit() for k in sub):
                self.__dict__[key] = [_View(model, sub[str(i)], device, data_index)
                                      for i in range(len(sub))]
            else:
                self.__dict__[key] = _View(model, sub, device, data_index)

    def __getattr__(self, name):
        leaves = self.__dict__.get("_leaves", {})
        if name not in leaves:
            raise AttributeError(name)
        return gather(self._model.leaves[leaves[name]], self._device,
                      prefer=self._prefer())

    def _prefer(self):
        return None if self._data is None else data_row(self._model.mesh, self._data)

    def leaf(self, name: str) -> Sharded:
        """The placed leaf itself (the MoE's collectives read its shards)."""
        return self._model.leaves[self._leaves[name]]

    @property
    def data_index(self):
        return self._data


def data_row(mesh, index: int) -> dict[str, int]:
    """Data rank ``index``'s coordinates on the batch axes (pod-major)."""
    ba = batch_axes(mesh)
    sizes = [mesh.shape[a] for a in ba]
    return dict(zip(ba, np.unravel_index(index, sizes) if sizes else ()))


def rank_device(mesh, index: int) -> torch.device:
    """The device data rank ``index`` computes on: its row's first position
    on every other axis."""
    return mesh.devices[position(mesh, index)]


def n_data_ranks(mesh) -> int:
    return axis_size(mesh, batch_axes(mesh))


def place_params(model, shardings, cfg) -> ShardedModel:
    """A model (``nn.Module`` or name -> tensor) placed by a NamedSharding
    tree in the JAX layout (``param_shardings``): every leaf split as its
    spec says, each shard a copy on its mesh position's device."""
    named = (dict(model.named_parameters()) if isinstance(model, torch.nn.Module)
             else dict(model))
    by_name = per_leaf(shardings, named, cfg)
    mesh = None
    leaves = {}
    with torch.no_grad():
        for name, t in named.items():
            sharding, layer = by_name[name]
            mesh = sharding.mesh
            leaves[name] = place(t.detach(), sharding.mesh, sharding.spec, layer=layer)
    return ShardedModel(mesh, leaves)


def rows_of(mesh, b: int) -> list[tuple[slice, int | None]]:
    """How a batch of ``b`` rows runs over ``mesh``'s data ranks: contiguous
    rows a rank when ``b`` divides over them, else every row on the first
    rank (``None``: a forward over every row's tokens)."""
    n = n_data_ranks(mesh)
    if b % n == 0 and b >= n:
        per = b // n
        return [(slice(i * per, (i + 1) * per), i) for i in range(n)]
    return [(slice(0, b), None)]


def position(mesh, data_index: int, **others: int) -> tuple:
    """The mesh position of data rank ``data_index``'s row with the given
    coordinates on the other axes (0 where not given)."""
    row = data_row(mesh, data_index)
    return tuple(int(row.get(a, others.get(a, 0))) for a in mesh.axis_names)


def is_sharded(params, mesh) -> bool:
    """Whether a model function runs ``params`` over ``mesh``'s data ranks:
    a :class:`ShardedModel` must come with its mesh, and a mesh with
    parameters placed on it (a rank's view passes through)."""
    if isinstance(params, ShardedModel):
        if mesh is None:
            raise ValueError("parameters placed on a mesh run over it: pass mesh=")
        return True
    if mesh is not None and not isinstance(params, _View):
        raise TypeError("mesh= needs the parameters placed on it "
                        "(dist.sharding.place_params)")
    return False


def on_ranks(model: ShardedModel, mesh, b: int, fn) -> list:
    """``fn(view, rows, device)`` for each data rank of a ``b``-row batch
    (``rows_of``), in rank order, each on its rank's device."""
    out = []
    for rows, index in rows_of(mesh, b):
        dev = rank_device(mesh, index or 0)
        out.append(fn(model.view(dev, index), rows, dev))
    return out


def rows_to(t, rows: slice, device):
    """A batch input's rows on a rank's device (None stays None)."""
    return None if t is None else t[rows].to(device)


def cat_ranks(parts: list, dim: int, device):
    """Per-rank outputs (tensors, or dicts of them; other leaves are the
    first rank's) joined along ``dim`` on ``device``, in rank order."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: cat_ranks([p[k] for p in parts], dim, device) for k in first}
    if torch.is_tensor(first):
        return torch.cat([p.to(device) for p in parts], dim=dim)
    return first


def cache_rows(caches: dict, rows: slice, device) -> tuple[dict, list]:
    """A rank's rows of stacked caches (batch on dim 1): views where the
    caches lie on ``device``, else copies. Returns (the rank's caches, the
    (global, copy) pairs to write back after the step)."""
    back = []

    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        if not torch.is_tensor(tree):
            return tree
        v = tree[:, rows]
        if v.device != device:
            v = v.to(device)
            back.append((tree, v))
        return v

    return take(caches), back


def write_back(back: list, rows: slice) -> None:
    for tree, v in back:
        tree[:, rows].copy_(v)


def check_divisible(b: int, mesh) -> None:
    """A training batch splits over the data ranks, as JAX's ``device_put``
    with ``P(batch_axes)`` requires."""
    n = n_data_ranks(mesh)
    if b % n or b < n:
        raise ValueError(f"a batch of {b} rows does not split over the {n} data ranks "
                         f"of {mesh}")


def specs_of(shardings):
    """A NamedSharding tree -> its PartitionSpec tree."""
    if isinstance(shardings, NamedSharding):
        return shardings.spec
    return {k: specs_of(v) for k, v in shardings.items()}

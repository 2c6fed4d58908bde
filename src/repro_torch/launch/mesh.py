"""Device meshes: the production, local, grid and replica builders.

The port of ``repro.launch.mesh``. A :class:`DeviceMesh` is what a JAX
``Mesh`` is to the planner and the sharded executor: an n-d array of devices
with a name per axis. The port is single-controller, as the JAX package is:
one process drives every tile of a sharded plan, placing each on its device
and moving the small (Q, k) merge tiles between cards with peer copies.

**A device may appear more than once** in a mesh. Its tiles then run in turn
on it: one card (or the host, ``torch.device("cpu")``) stands in for several,
as XLA's forced host-device count does for JAX on a CPU. The tests build
8-device meshes over ``[torch.device("cpu")] * 8`` this way; it is a test
affordance, not a deployment.
"""
from __future__ import annotations

import numpy as np
import torch


class DeviceMesh:
    """An n-d array of ``torch.device`` with one name per axis.

    ``devices`` is the object array; ``shape`` maps each axis name to its
    size, in axis order (the planner reads only ``mesh.shape[axis]``)."""

    def __init__(self, devices, axis_names):
        arr = _pool(devices).reshape(np.shape(devices))
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes {axis_names}")
        self.devices = arr
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {sorted({str(d) for d in self.devices.flat})})"


def _pool(devices) -> np.ndarray:
    """The flat device pool: ``devices``, or every visible card (a host
    without one raises unless the caller passes its devices)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is present; pass "
                               "devices=[torch.device('cpu')] to run on the host")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    flat = list(np.asarray(devices, dtype=object).reshape(-1))
    pool = np.empty(len(flat), dtype=object)
    for i, d in enumerate(flat):
        pool[i] = torch.device(d)
    return pool


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> DeviceMesh:
    """The JAX package's production mesh: (16, 16) ``("data", "model")``, or
    (2, 16, 16) ``("pod", "data", "model")`` with ``multi_pod``, over the
    first 256 (512) devices of the pool (default: every visible card).
    Fewer devices raise, as ``jax.make_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = _pool(devices)
    need = int(np.prod(shape))
    if devs.size < need:
        raise ValueError(f"the {'multi-pod ' if multi_pod else ''}production mesh {shape} "
                         f"needs {need} devices; {devs.size} are available")
    return DeviceMesh(devs[:need].reshape(shape), axes)


def make_local_mesh(model: int = 1, *, devices=None) -> DeviceMesh:
    """A ``(data, model)`` mesh over ``devices`` (default: every visible
    card), the model axis holding ``model`` devices."""
    devs = _pool(devices)
    data = devs.size // model
    return DeviceMesh(devs[:data * model].reshape(data, model), ("data", "model"))


def make_replica_meshes(n_replicas: int, *, devices=None, model: int = 1) -> list:
    """Cut the pool into ``n_replicas`` contiguous slices, one ``(data,
    model)`` mesh each, as the JAX package cuts its device set for the
    fleet. A slice of fewer than two devices (or than ``model``) gives every
    replica ``None``: one device each, the degenerate slice. A
    non-dividing replica count leaves the tail of the pool unused."""
    devs = _pool(devices)
    n_replicas = int(n_replicas)
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1; got {n_replicas}")
    per = devs.size // n_replicas
    if per < max(model, 1) or per < 2:
        return [None] * n_replicas
    per -= per % model                   # keep the model axis dividing
    return [DeviceMesh(devs[i * per:(i + 1) * per].reshape(per // model, model),
                       ("data", "model")) for i in range(n_replicas)]


def make_grid_mesh(q_shards: int, d_shards: int, *, devices=None) -> DeviceMesh:
    """2-D (query × data) grid mesh for discovery serving.

    ``q_shards`` shards the query batch, ``d_shards`` the lake's column axis;
    each (query, data) cell scores one tile. The pool's size must be a
    multiple of ``q_shards × d_shards``; the quotient becomes a trailing
    ``model`` axis, replicated by discovery placements. The flat device
    order is kept, so a (1, d) grid places its shards as the caller's own
    ``(data, model)`` mesh does."""
    devs = _pool(devices)
    n = q_shards * d_shards
    if n <= 0 or devs.size % n:
        raise ValueError(f"grid ({q_shards}, {d_shards}) does not tile "
                         f"{devs.size} devices")
    return DeviceMesh(devs.reshape(q_shards, d_shards, devs.size // n),
                      ("query", "data", "model"))


def make_replica_devices(n_replicas: int, *, devices=None) -> list[torch.device]:
    """One ``torch.device`` per replica of an engine fleet: the first device
    of each slice :func:`make_replica_meshes` cuts (a replica whose slice
    holds two or more devices also gets that slice's mesh from it). With
    fewer devices than replicas every replica takes ``devices[0]``, the
    counterpart of the JAX package's ``None`` (one shared device)."""
    n_replicas = int(n_replicas)
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1; got {n_replicas}")
    pool = _pool(devices)
    if pool.size == 0:
        raise ValueError("make_replica_devices needs at least one device")
    per = pool.size // n_replicas
    if per < 1:
        return [pool[0]] * n_replicas
    return [pool[i * per] for i in range(n_replicas)]

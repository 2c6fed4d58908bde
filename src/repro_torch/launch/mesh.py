"""Device placement for the replica fleet.

The port of ``repro.launch.mesh.make_replica_meshes``. A JAX replica gets a
``(data, model)`` sub-mesh; a port replica gets one ``torch.device``, since
the port's engine runs every plan on one device until sharded plans exist
(``ROADMAP.md`` queue 7). The other mesh builders of the JAX module
(production, local and grid meshes) belong to that slice.
"""
from __future__ import annotations

import torch


def make_replica_devices(n_replicas: int, *, devices=None) -> list[torch.device]:
    """One ``torch.device`` per replica of an engine fleet.

    ``devices`` is the pool (default: every visible CUDA card; a host with
    no card raises, so the CPU is used only when the caller passes it, as
    in ``devices=[torch.device("cpu")]``). The pool is cut into
    ``n_replicas`` contiguous slices of ``len(devices) // n_replicas``, as
    JAX cuts its meshes, and each replica takes the first device of its
    slice: a slice of several cards uses only its first card until sharded
    plans exist. A non-dividing replica count leaves the tail of the pool
    unused. With fewer devices than replicas every replica takes
    ``devices[0]``, the counterpart of the JAX package's ``None`` (one
    shared device).
    """
    n_replicas = int(n_replicas)
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1; got {n_replicas}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is present; pass "
                               "devices=[torch.device('cpu')] to run on the host")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    pool = [torch.device(d) for d in devices]
    if not pool:
        raise ValueError("make_replica_devices needs at least one device")
    per = len(pool) // n_replicas
    if per < 1:
        return [pool[0]] * n_replicas
    return [pool[i * per] for i in range(n_replicas)]

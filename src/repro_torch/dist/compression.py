"""int8 error-feedback gradient all-reduce.

The port of ``repro.dist.compression``. Each device quantizes ``g + ef`` to
int8 with a per-tensor scale, all-reduces the int8 payload (summed in
int32, averaged), and keeps the quantization residual in the
error-feedback buffer — the classic EF-SGD construction: the per-step
quantization error is bounded by ``scale/2`` and the accumulated bias
cancels across steps because the residual is re-injected.

Inputs and outputs are replicated, as in the JAX package's ``shard_map``
body. The port is single-controller: each device of ``axes`` holds the
payload the replicated inputs give it (a peer copy), and the payloads and
the scales are summed over those devices in mesh order
(``dist.collectives.psum``). The arithmetic is JAX's, step for step, in
float32 (``jnp.round`` and ``torch.round`` both round half to even), and
its results are JAX's bit for bit on the CPU.
"""
from __future__ import annotations

import itertools

import torch

from repro_torch.dist.collectives import psum


def _axis_devices(mesh, axes: tuple[str, ...]) -> list[torch.device]:
    """The devices along ``axes`` (mesh order), the other axes at index 0."""
    ranges = [range(mesh.shape[a]) if a in axes else range(1) for a in mesh.axis_names]
    return [mesh.devices[p] for p in itertools.product(*ranges)]


def make_int8_ef_allreduce(mesh, axes: tuple[str, ...]):
    """Returns ``(init, compress)``.

    ``init(grads)`` builds the zero error-feedback state.
    ``compress(grads, ef)`` -> ``(grads_hat, ef_new)`` where ``grads_hat`` is
    the dequantized, all-reduced (mean over ``axes``) gradient. ``grads``
    and ``ef`` are mappings of name -> tensor; the results lie on each
    gradient's device.
    """
    devices = _axis_devices(mesh, tuple(axes))
    n_dev = len(devices)

    def init(grads):
        return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for k, g in grads.items()}

    @torch.no_grad()
    def _one(g, ef):
        e = g.float() + ef
        scale = torch.clamp(e.abs().max(), min=1e-30) / 127.0
        q = torch.clamp(torch.round(e / scale), -127, 127).to(torch.int8)
        # all-reduce the int8 payload (int32 accumulator), mean over devices;
        # scales are tiny and all-reduced in f32
        qs = psum([q.to(d).to(torch.int32) for d in devices], g.device)
        ss = psum([scale.to(d) for d in devices], g.device)
        g_hat = qs.float() * (ss / n_dev) / n_dev
        # XLA contracts e - q·scale into one fused multiply-add (one
        # rounding). q·scale (8 x 24 bits) is exact in float64, and so is its
        # difference with e (|e - q·scale| <= scale/2), so rounding the
        # float64 result once gives the fused bits
        ef_new = (e.double() - q.double() * scale.double()).float()
        return g_hat, ef_new

    def compress(grads, ef):
        outs = {k: _one(g, ef[k]) for k, g in grads.items()}
        return ({k: o[0] for k, o in outs.items()}, {k: o[1] for k, o in outs.items()})

    return init, compress

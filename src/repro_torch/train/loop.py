"""Fault-tolerant training loop: checkpoint/restart, straggler monitor.

The port of ``repro.train.loop``, on one device or a mesh (a
``dist.sharding.ShardedModel``, its batch placed by ``to_device``). The
loop is deliberately
boring: deterministic data (batch = f(seed, step)), a checkpoint every N
steps through the atomic ``CheckpointManager`` (the JAX package's file
format, so either package resumes the other's run), resume from the latest
checkpoint on (re)start, and re-raise only after writing an emergency
checkpoint, so a preempted or crashed worker restarts byte-identically.
The port's step updates the parameters and moments in place, so an
interrupt that landed inside it would save a half-updated state: SIGINT is
held back while a step runs and raised as ``KeyboardInterrupt`` once the
step is whole, and the emergency checkpoint is named by the optimizer
state's own step.

A step's wall time is read after the model's device has finished it; the
loss is read back to the host only when a step is logged.

``StragglerMonitor`` keeps an EMA of step wall-time and flags steps slower
than ``threshold ×`` the EMA; on a real fleet this signal feeds the
controller that re-shards around slow hosts (here it logs — single host).
"""
from __future__ import annotations

import contextlib
import dataclasses
import signal
import threading
import time

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.dist.sharding import ShardedModel


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.2
    threshold: float = 2.0
    ema: float | None = None
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        slow = self.ema is not None and dt > self.threshold * self.ema
        self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        self.flagged += int(slow)
        return slow


def batch_to_device(batch: dict, device) -> dict:
    """A numpy batch on ``device``: integer arrays as int64 (token ids and
    labels index), the rest as they are."""
    return {k: torch.from_numpy(v).to(device).long() if v.dtype.kind in "iu"
            else torch.from_numpy(v).to(device) for k, v in batch.items()}


@contextlib.contextmanager
def _sigint_held():
    """Holds SIGINT back for the block and raises it as ``KeyboardInterrupt``
    when the block has run to its end. Only Python's default handler is
    replaced, and only in the main thread, where Python delivers signals."""
    if (threading.current_thread() is not threading.main_thread()
            or signal.getsignal(signal.SIGINT) is not signal.default_int_handler):
        yield
        return
    caught = []
    signal.signal(signal.SIGINT, lambda signum, frame: caught.append(signum))
    try:
        yield
    finally:
        signal.signal(signal.SIGINT, signal.default_int_handler)
    if caught:
        raise KeyboardInterrupt


def _devices(model) -> list[torch.device]:
    """The devices a model's parameters lie on (the first one first)."""
    if isinstance(model, ShardedModel):
        return list(dict.fromkeys(model.mesh.devices.flat))
    return [next(model.parameters()).device]


def _sync(devices) -> None:
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def train_loop(train_step, model, opt_state, pipeline, *, cfg, steps: int,
               ckpt_dir: str, ckpt_every: int = 50, log_every: int = 10,
               to_device=None, log=print):
    """Runs ``steps`` optimizer steps of ``train_step`` (``build_train_step``)
    on ``model`` (``cfg``'s architecture) with checkpoint/resume; the
    parameters and ``opt_state`` are updated in place. ``to_device`` maps a
    numpy batch onto the model's device (default: ``batch_to_device``; a
    model on a mesh takes it to its first data rank's device unless
    ``to_device`` places it over the mesh). Returns (model, opt_state,
    history of (step, loss, seconds))."""
    devices = _devices(model)
    if to_device is None:
        def to_device(batch):
            return batch_to_device(batch, devices[0])
    mgr = CheckpointManager(ckpt_dir)
    start = 0
    latest = mgr.latest_step()
    if latest is not None:
        mgr.restore_train_state(latest, model, opt_state, cfg)
        start = latest
        log(f"[resume] restored checkpoint @ step {latest}")

    monitor = StragglerMonitor()
    history = []
    try:
        for step in range(start, steps):
            batch = to_device(pipeline.batch(step))
            t0 = time.perf_counter()
            with _sigint_held():
                model, opt_state, metrics = train_step(model, opt_state, batch)
                _sync(devices)
            dt = time.perf_counter() - t0
            slow = monitor.observe(dt)
            if step % log_every == 0 or slow:
                loss = float(metrics["loss"])
                history.append((step, loss, dt))
                log(f"step {step:5d} loss {loss:.4f} {dt*1e3:7.1f} ms"
                    + (" [straggler]" if slow else ""))
            if (step + 1) % ckpt_every == 0:
                mgr.save_train_state(step + 1, model, opt_state, cfg)
    except KeyboardInterrupt:
        done = int(opt_state["step"])
        mgr.save_train_state(done, model, opt_state, cfg)
        log(f"[interrupt] emergency checkpoint @ step {done}")
        raise
    mgr.save_train_state(steps, model, opt_state, cfg)
    return model, opt_state, history

"""Train-step builder: loss, gradient accumulation, optional compressed
gradients, on one device or over a mesh.

The port of ``repro.train.trainer``. ``build_train_step`` returns a
``(model, opt_state, batch) -> (model, opt_state, metrics)`` callable that
updates the model's parameters and the optimizer state **in place**.
Cross-entropy is computed in float32 from the float32 logits.

Gradient accumulation runs ``accum`` micro-batches, micro-batch i taking
rows ``i·b/accum`` onward as JAX's reshape does, sums their gradients into
float32 buffers (a bf16 ``.grad`` summed in place would round at every
micro-step) and divides the loss and the sum by ``accum``. Optional int8
error-feedback compression (``dist/compression.py``) plugs in between the
gradients and the optimizer, as ``compressor(grads, opt_state) -> (grads,
opt_state)``.

**Over a mesh** (``mesh=``, the model placed by
``dist.sharding.place_params``), each micro-batch's rows split
contiguously over the data ranks; each rank runs the forward and backward
pass on its own device with the parameters gathered there, one rank after
the other. A rank's loss is its masked NLL summed over the micro-batch's
*global* masked count, so the ranks' losses add up to the single-device
loss. Autograd leaves each rank's gradient on the shards that rank read;
they are added, rank by rank in order, into float32 full gradients on the
first rank's device, which the compressor and the ZeRO-1 update take.
"""
from __future__ import annotations

import torch

from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import Sharded, gather
from repro_torch.models import registry
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def _masked_nll(logits, labels):
    """(sum of the NLL over unmasked positions, their count)."""
    mask = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None].long())[..., 0]
    return ((lse - ll) * mask).sum(), mask.sum()


def cross_entropy(logits, labels):
    """logits (B, S, V) f32, labels (B, S) integer (-1 = masked). The mean
    over unmasked positions; 0 when every position is masked (where
    ``F.cross_entropy(ignore_index=-1)`` gives NaN)."""
    nll, count = _masked_nll(logits, labels)
    return nll / torch.clamp(count, min=1)


def loss_fn(model, cfg, batch, *, mesh=None):
    logits = registry.forward(model, cfg, batch, mesh=mesh)
    return cross_entropy(logits, batch["labels"].to(logits.device))


def _rows(v, rows: slice, device, mesh, index):
    """A batch input's rows on a rank's device: a slice of a tensor, or of a
    batch placed over the mesh (``Sharded``), read from the rank's row."""
    if isinstance(v, Sharded):
        region = (rows,) + tuple(slice(0, n) for n in v.shape[1:])
        return gather(v, device, region, prefer=shd.data_row(mesh, index))
    return v[rows].to(device)


def _sharded_grads(model: shd.ShardedModel, cfg, batch, mesh, accum: int):
    """(loss, float32 full gradients on the first rank's device)."""
    b = batch["tokens"].shape[0]
    if b % accum:
        raise ValueError(f"batch {b} is not a multiple of accum {accum}")
    micro = b // accum
    shd.check_divisible(micro, mesh)
    dev0 = shd.rank_device(mesh, 0)
    grads = {n: torch.zeros(sh.shape, dtype=torch.float32, device=dev0)
             for n, sh in model.leaves.items()}
    loss = torch.zeros((), dtype=torch.float32, device=dev0)
    model.requires_grad_(True)
    for t in model.shard_tensors():
        t.grad = None
    for i in range(accum):
        lo = i * micro
        labels = _rows(batch["labels"], slice(lo, lo + micro), dev0, mesh, 0)
        count = torch.clamp((labels >= 0).sum(), min=1)
        for rows, index in shd.rows_of(mesh, micro):
            dev = shd.rank_device(mesh, index)
            rows = slice(lo + rows.start, lo + rows.stop)
            rb = {k: _rows(v, rows, dev, mesh, index) for k, v in batch.items()}
            logits = registry.forward(model.view(dev, index), cfg, rb, mesh=mesh)
            nll, _ = _masked_nll(logits, rb["labels"])
            part = nll / count.to(dev)
            part.backward()
            loss += part.detach().to(dev0)
            for name, sh in model.leaves.items():
                for pos, t in sh.shards.items():
                    if t.grad is not None:
                        grads[name][sh.region(pos)] += t.grad.float().to(dev0)
                        t.grad = None
    if accum > 1:
        loss = loss / accum
        torch._foreach_div_(list(grads.values()), accum)
    return loss, grads


def build_train_step(cfg, opt_cfg: AdamWConfig, *, mesh=None, accum: int = 1,
                     moment_specs=None, compressor=None):
    if mesh is None and moment_specs is not None:
        raise ValueError("moment_specs go with a mesh")

    def micro_grads(params, model, batch):
        for p in params.values():
            p.grad = None
        loss = loss_fn(model, cfg, batch)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in params.items()}

    def local_grads(model, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        if accum == 1:
            loss, grads = micro_grads(params, model, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % accum:
                raise ValueError(f"batch {b} is not a multiple of accum {accum}")
            step = b // accum
            loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in params.items()}
            for i in range(accum):
                mb = {k: v[i * step:(i + 1) * step] for k, v in batch.items()}
                l, g = micro_grads(params, model, mb)
                loss = loss + l
                have = [n for n, t in g.items() if t is not None]
                torch._foreach_add_([grads[n] for n in have], [g[n] for n in have])
            loss = loss / accum
            torch._foreach_div_(list(grads.values()), accum)
        for p in params.values():
            p.grad = None
        return params, loss, grads

    def train_step(model, opt_state, batch):
        if mesh is not None:
            if not isinstance(model, shd.ShardedModel):
                raise TypeError("a step over a mesh trains parameters placed on it "
                                "(dist.sharding.place_params)")
            params = model
            loss, grads = _sharded_grads(model, cfg, batch, mesh, accum)
        else:
            params, loss, grads = local_grads(model, batch)
        if compressor is not None:
            grads = {n: torch.zeros(params[n].shape, dtype=torch.float32,
                                    device=params[n].device) if g is None else g
                     for n, g in grads.items()}
            grads, opt_state = compressor(grads, opt_state)
        _, opt_state, metrics = adamw_update(opt_cfg, params, grads, opt_state,
                                             moment_specs=moment_specs, mesh=mesh)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step

"""Train-step builder: loss and gradient accumulation, on one device.

The port of ``repro.train.trainer``. ``build_train_step`` returns a
``(model, opt_state, batch) -> (model, opt_state, metrics)`` callable that
updates the model's parameters and the optimizer state **in place**.
Cross-entropy is computed in float32 from the float32 logits.

Gradient accumulation runs ``accum`` micro-batches, micro-batch i taking
rows ``i·b/accum`` onward as JAX's reshape does, sums their gradients into
float32 buffers (a bf16 ``.grad`` summed in place would round at every
micro-step) and divides the loss and the sum by ``accum``. The int8
error-feedback compressor and the mesh belong to the dist slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import registry
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def cross_entropy(logits, labels):
    """logits (B, S, V) f32, labels (B, S) integer (-1 = masked). The mean
    over unmasked positions; 0 when every position is masked (where
    ``F.cross_entropy(ignore_index=-1)`` gives NaN)."""
    mask = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None].long())[..., 0]
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def loss_fn(model, cfg, batch, *, mesh=None):
    if mesh is not None:
        raise NotImplementedError("a sharded loss comes with the port's dist slice")
    logits = registry.forward(model, cfg, batch)
    return cross_entropy(logits, batch["labels"])


def build_train_step(cfg, opt_cfg: AdamWConfig, *, mesh=None, accum: int = 1,
                     moment_specs=None, compressor=None):
    if compressor is not None:
        raise NotImplementedError("gradient compression (dist/compression.py) comes with "
                                  "the port's dist slice")
    if mesh is not None or moment_specs is not None:
        raise NotImplementedError("a sharded train step comes with the port's dist slice; "
                                  "on one device pass mesh=None")

    def micro_grads(params, model, batch):
        for p in params.values():
            p.grad = None
        loss = loss_fn(model, cfg, batch)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in params.items()}

    def train_step(model, opt_state, batch):
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
        _, opt_state, metrics = adamw_update(opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step

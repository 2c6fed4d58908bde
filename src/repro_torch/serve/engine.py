"""Batched serving engine: prefill + greedy/temperature decode loop.

The port of ``repro.serve.engine``. ``generate`` is a plain Python loop
over ``build_serve_step``'s one-token step (no CUDA graphs yet). Tokens
stay on the device between steps and the cache length is a host ``int``,
so the loop enqueues a step without waiting for the card; the generated
tokens come back in one copy at the end. With ``mesh=`` (the parameters
placed by ``dist.sharding.place_params``) the prefill and every decode
step run over the mesh's data ranks.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import ShardedModel, rank_device
from repro_torch.models import registry
from repro_torch.models.transformer import forward_with_caches


def build_serve_step(cfg, *, mesh=None):
    """The greedy one-token step: (params, tokens (B, 1), caches) ->
    (next tokens (B, 1), caches updated in place)."""
    def serve_step(params, tokens, caches):
        logits, caches = registry.decode_step(params, cfg, {"tokens": tokens}, caches,
                                              mesh=mesh)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], caches
    return serve_step


def _on(t, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t, device=dev)


def _check_params_on(params, dev: torch.device) -> None:
    have = (rank_device(params.mesh, 0) if isinstance(params, ShardedModel)
            else next(params.parameters()).device)
    if have.type != dev.type or (dev.index is not None and have.index != dev.index):
        raise ValueError(f"the model's parameters are on {have}, not on {dev}")


@torch.no_grad()
def generate(params, cfg, prompt_tokens, *, max_new: int = 32,
             cache_size: int | None = None, img=None, temperature: float = 0.0,
             generator: torch.Generator | None = None, device=None,
             mesh=None) -> np.ndarray:
    """prompt_tokens (B, S) -> generated (B, max_new) int32 (greedy by
    default), on ``device`` (default: the card), where ``params`` must live
    (on a mesh: its first data rank's device).

    Prefill-with-caches, then the decode step. With ``temperature`` > 0 and
    a ``generator`` (on the same device), each decode step samples from
    softmax(logits / temperature) with ``torch.multinomial``: the
    distribution of JAX's ``jax.random.categorical``, not its bits. The
    first token is always the prefill's argmax, as in JAX.
    """
    dev = resolve_device(device)
    _check_params_on(params, dev)
    b, s = prompt_tokens.shape
    cache_size = cache_size or (s + max_new)
    if registry.is_encdec(cfg):
        raise NotImplementedError("use whisper example for enc-dec serving")
    tokens = _on(prompt_tokens, dev).long()
    logits, caches = forward_with_caches(params, cfg, tokens, cache_size,
                                         img=None if img is None else _on(img, dev), mesh=mesh)
    step = build_serve_step(cfg, mesh=mesh)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = [tok]
    for _ in range(max_new - 1):
        if temperature > 0.0 and generator is not None:
            logits2, caches = registry.decode_step(params, cfg, {"tokens": tok}, caches,
                                                   mesh=mesh)
            probs = torch.softmax(logits2[:, -1] / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok, caches = step(params, tok, caches)
        out.append(tok)
    return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)

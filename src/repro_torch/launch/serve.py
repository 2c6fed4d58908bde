"""Batched serving from the command line: prefill a batch of prompts, decode
greedily.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --batch 4 --prompt-len 64 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduce

The port of ``repro.launch.serve``, with the same flags and output, plus
``--device`` (default: the card) and ``--seed``. The weights are random,
drawn from ``torch.Generator(device).manual_seed(seed)``; the prompts come
from numpy's ``default_rng(0)`` as in ``repro.launch.serve``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serve.engine import generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch)
    if args.reduce:
        cfg = registry.reduced_config(cfg)
    params = registry.init_params(cfg, generator=torch.Generator(dev).manual_seed(args.seed),
                                  device=dev)
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(args.batch, args.prompt_len)).astype(np.int32)

    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, max_new=args.max_new,
                   cache_size=args.prompt_len + args.max_new, device=dev)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s incl. the first call's setup)")
    print("sample:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()

"""End-to-end driver on the PyTorch/CUDA port: train a llama-family model
for a few hundred steps on the synthetic token pipeline, with
checkpointing/resume. The counterpart of ``examples/train_lm.py``; it
trains on ``--device`` (default: the card).

  python examples/torch_train_lm.py --steps 200 [--device cpu]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.train.loop import train_loop  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.train.trainer import build_train_step  # noqa: E402


def config(width: int, layers: int, seq: int):
    base = registry.get_config("smollm-360m")
    return dataclasses.replace(
        base, n_layers=layers, d_model=width, d_ff=width * 4,
        n_heads=width // 64, n_kv=max(2, width // 128), d_head=64,
        vocab=8192, param_dtype="float32", compute_dtype="float32",
        attn_chunk=min(256, seq), remat="none")


def main(argv=None, model=None):
    """Trains and returns the loss history; ``model`` replaces the seeded
    weights (a model of ``config``'s architecture on ``--device``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_lm")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = config(args.width, args.layers, args.seq)
    print(f"model: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model})")

    if model is None:
        model = registry.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                                     device=dev)
    opt = init_opt_state(model)
    step = build_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps))
    pipe = TokenPipeline(vocab=cfg.vocab, seq=args.seq, global_batch=args.batch)
    model, opt, hist = train_loop(step, model, opt, pipe, cfg=cfg, steps=args.steps,
                                  ckpt_dir=args.ckpt_dir, ckpt_every=100)
    print(f"loss: {hist[0][1]:.3f} -> {hist[-1][1]:.3f} over {args.steps} steps")
    assert hist[-1][1] < hist[0][1], "loss did not decrease"
    return hist


if __name__ == "__main__":
    main()

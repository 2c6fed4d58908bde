"""End-to-end training entry point.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --reduce --steps 200 --batch 8 --seq 256
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduce --steps 20
  # every visible card as one (data, model=1) mesh, ZeRO-1 moments
  PYTHONPATH=src python -m repro_torch.launch.train --mesh local --steps 20

The port of ``repro.launch.train``, with the same flags and output, plus
``--device`` (default: the card). The weights are random, drawn from
``torch.Generator(device).manual_seed(0)`` as in ``launch.serve``. A mesh
runs ``repro.launch.train``'s sequence: ``param_shardings`` -> place the weights
-> ``zero1_shardings`` -> ``init_opt_state`` -> ``build_train_step(mesh=,
moment_specs=)``, each batch placed over the batch axes. ``--mesh local``
is ``make_local_mesh()`` over the visible cards (over the host, a (1, 1)
mesh, with ``--device cpu``); ``single``/``multi`` are the production
meshes, which raise without 256 (512) devices.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import place
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import registry
from repro_torch.train.loop import train_loop
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.trainer import build_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduce", action="store_true",
                    help="use the reduced (smoke) config")
    ap.add_argument("--width", type=int, default=0,
                    help="override d_model of the reduced config (e.g. 768 "
                         "for a ~100M-class model)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none", choices=["none", "local", "single", "multi"])
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch)
    if args.reduce:
        cfg = registry.reduced_config(cfg)
        over = {}
        if args.width:
            over.update(d_model=args.width, d_ff=4 * args.width,
                        n_heads=max(4, args.width // 64), d_head=64,
                        n_kv=max(2, args.width // 128))
        if args.layers:
            over["n_layers"] = args.layers
        if over:
            cfg = dataclasses.replace(cfg, **over)
    print(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
          f"active≈{cfg.active_param_count()/1e6:.1f}M")

    mesh = None
    pool = [dev] if dev.type == "cpu" else None          # the host, or every card
    if args.mesh == "local":
        mesh = make_local_mesh(devices=pool)
    elif args.mesh in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"), devices=pool)

    model = registry.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                                 device=dev)
    moment_specs = moment_shardings = to_device = None
    if mesh is not None:
        specs = registry.param_specs(cfg)
        shapes = shd.jax_layout(model, cfg)
        model = shd.place_params(model, shd.param_shardings(specs, mesh), cfg)
        moment_shardings = shd.zero1_shardings(specs, shapes, mesh)
        moment_specs = shd.specs_of(moment_shardings)
        batch_spec = (shd.batch_axes(mesh),)

        def to_device(batch):
            return {k: place(torch.from_numpy(v).long() if v.dtype.kind in "iu"
                             else torch.from_numpy(v), mesh, batch_spec)
                    for k, v in batch.items()}

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=min(50, args.steps // 10 + 1))
    opt_state = init_opt_state(model, moment_shardings, cfg=cfg)
    step = build_train_step(cfg, opt_cfg, mesh=mesh, accum=args.accum,
                            moment_specs=moment_specs)

    pipe = TokenPipeline(vocab=cfg.vocab, seq=args.seq, global_batch=args.batch)
    model, opt_state, hist = train_loop(
        step, model, opt_state, pipe, cfg=cfg, steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, to_device=to_device)
    if hist:
        print(f"first loss {hist[0][1]:.4f} -> last loss {hist[-1][1]:.4f}")
    return model, opt_state, hist


if __name__ == "__main__":
    main()

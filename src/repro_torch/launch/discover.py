"""FREYJA discovery from the command line, on the port: build a lake,
profile it, train (or load) the join-quality model, and answer
discovery-by-attribute queries.

  PYTHONPATH=src python -m repro_torch.launch.discover --tables 40 --queries 10
  PYTHONPATH=src python -m repro_torch.launch.discover --device cpu --tables 12

The port of ``repro.launch.discover``, with the same flags and output, plus
``--device`` (default: the card). Every stage runs on that device:
profiling, the training labels and distances (``quality_cdf`` and
``profile_distance`` kernels) and the ranking (the fused scorer).

Service mode persists the lake into an on-disk catalog (the JAX package's
format), restarts an engine from it and serves the queries through the
continuous-batching scheduler, reporting the plan, serving stats and recall
against the exact scan:

  PYTHONPATH=src python -m repro_torch.launch.discover --device cpu \
      --catalog /tmp/tcat --serve [--follow] [--warmup serve] [--open-loop]

``--follow`` makes the engine a read replica of the catalog (the demo
publishes a table mid-run to show the pickup); ``--calibrate
BENCH_service.json`` fits the planner's cost model from measured timings;
``--open-loop`` offers Poisson arrivals through the scheduler.
``--replicas N`` serves through an :class:`EngineFleet` of N catalog
followers behind the load-aware router, each on its own device from
``make_replica_devices`` (on one card, or with ``--device cpu``, they share
it). ``--mesh`` serves over a mesh of every visible card (the one host
device under ``--device cpu``): ``--mode sharded`` is the full scan over it,
``--mode lsh`` shards the pruned plan over a mesh of several devices,
``--grid QxD`` pins the (query x data) device grid, and with ``--replicas``
each replica takes its slice of the mesh's devices.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.discovery import DiscoveryIndex, rank
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.lakegen import LakeSpec, generate_lake, select_queries
from repro_torch.core.predictor import JoinQualityModel, train_quality_model
from repro_torch.core.profiles import profile_lake
from repro_torch.device import resolve_device


def serve_mode(args, lake, model, dev):
    """Persist → restart → serve through the online engine."""
    from repro_torch.service import (CatalogReader, CatalogStore, DiscoveryEngine,
                                     DiscoveryRequest, EngineConfig, LSHConfig,
                                     add_lake, measure_recall, serve_discovery)

    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(devices=_mesh_devices(dev))
        print(f"mesh: {dict(mesh.shape)} ({len(mesh.devices.flat)} devices)")

    grid = None
    if args.grid:
        if mesh is None:
            raise SystemExit("--grid needs --mesh")
        try:
            grid = tuple(int(x) for x in args.grid.lower().split("x"))
            if len(grid) != 2:
                raise ValueError(args.grid)
        except ValueError:
            raise SystemExit(f"--grid wants QxD (e.g. 2x4), got {args.grid!r}")
        print(f"grid: {grid[0]} query shards x {grid[1]} data shards")

    t0 = time.perf_counter()
    catalog = CatalogStore(args.catalog, device=dev)
    if not catalog.tables():
        add_lake(catalog, lake)
        print(f"catalog: ingested {len(catalog.tables())} tables in "
              f"{time.perf_counter()-t0:.1f}s -> {args.catalog}")
    else:
        # query ids below index into the generated lake; a catalog built
        # from different --tables/--domains/--seed would misalign them
        if catalog.snapshot().names != lake.batch.names:
            raise SystemExit(
                f"catalog at {args.catalog} does not match the generated "
                f"lake — it was built with different --tables/--domains/"
                f"--seed; point --catalog at a fresh directory (or delete "
                f"this one)")
        print(f"catalog: reusing {len(catalog.tables())} tables from "
              f"{args.catalog}")

    cost_fn = None
    if args.calibrate:
        from repro_torch.launch.costmodel import calibrate_stage_costs
        constants, cost_fn = calibrate_stage_costs(args.calibrate)
        print(f"calibrated cost model from {args.calibrate}: "
              f"r2={constants['r2']:.3f} over {constants['n_obs']} obs, "
              f"score={constants['score_s_per_flop']:.3e} s/flop, "
              f"fixed={1e3*constants['fixed_s_per_query']:.3f} ms/query")

    if args.replicas > 1:
        fleet_mode(args, lake, model, cost_fn, grid, dev)
        return

    # restart path: a fresh process would do exactly this
    engine = DiscoveryEngine.from_catalog(
        CatalogStore(args.catalog, device=dev), model,
        EngineConfig(k=args.k, mode=args.mode,
                     lsh=LSHConfig(n_bands=args.lsh_bands),
                     cost_fn=cost_fn, grid=grid,
                     metrics=args.metrics_port is not None,
                     warmup=(False if args.warmup == "off" else args.warmup),
                     executable_cache_dir=args.executable_cache),
        device=dev, mesh=mesh)
    if engine.warmup_report is not None:
        rep = engine.warmup_report
        print(f"warmup[{rep['scope']}]: {rep['n_executables']} units over "
              f"buckets {rep['buckets']} in {rep['wall_ms']:.0f}ms")
    metrics_server = None
    if args.metrics_port is not None:
        from repro_torch.service import MetricsServer
        metrics_server = MetricsServer(engine.metrics, port=args.metrics_port)
        print(f"metrics: serving Prometheus exposition at {metrics_server.url}")
    if args.follow:
        # follower mode: the engine tails the manifest chain, picking up
        # versions published by any concurrent writer before each batch
        engine.follow(CatalogReader(args.catalog))
        print(f"follower: tailing {args.catalog} from version {engine.version}")
    qids = select_queries(lake, args.queries)
    reqs = [DiscoveryRequest(name=f"q{int(q)}", column_id=int(q)) for q in qids]
    t0 = time.perf_counter()
    responses = list(serve_discovery(engine, reqs, max_batch=args.batch))
    dt = time.perf_counter() - t0
    print(f"served {len(responses)} queries in {dt:.3f}s "
          f"({len(responses)/max(dt,1e-9):.1f} QPS, mode={args.mode})")
    stats = engine.stats()
    plan = stats.get("last_plan", {})
    print(f"plan: {plan.get('kind')} budget={plan.get('budget')} "
          f"grid={'x'.join(map(str, plan.get('grid', [1, 1])))} "
          f"(~{plan.get('cost', {}).get('total_flops', 0)/1e6:.2f} MFLOP/batch); "
          f"cache {stats['cache']['hits']}h/{stats['cache']['misses']}m, "
          f"plans={stats['plans']}")
    if args.mode in ("lsh", "auto", "tiered"):
        rec = measure_recall(engine, qids, k=args.k)
        print(f"recall@{args.k} vs {rec['baseline_plan']} scan: "
              f"{rec['recall']:.3f} scoring "
              f"{100*rec['scored_fraction']:.1f}% of columns")
    for r in responses[:3]:
        names = [m.column for m in r.matches[:5]]
        print(f"  {r.name} ({r.n_candidates} scored) -> {names}")

    if args.open_loop:
        open_loop_mode(args, engine, qids, len(responses) / max(dt, 1e-9))

    if metrics_server is not None:
        scrape = engine.metrics.collect()
        admitted = scrape["requests_admitted_total"]["values"].get("", 0)
        print(f"metrics: {int(admitted)} requests admitted; endpoint "
              f"{metrics_server.url} stays up until exit")

    if args.follow:
        # replication: a writer publishes a delta segment and the follower's
        # next batch observes the new version
        writer = CatalogStore(args.catalog, device=dev)
        if "follow_demo" not in writer.tables():
            writer.add_table("follow_demo",
                             [("demo_ids", [f"demo_{i}" for i in range(64)])])
        v0 = engine.version
        engine.query(DiscoveryRequest(name="demo", column_id=0))
        print(f"follower: observed version {engine.version} (was {v0}) "
              f"after a concurrent add_table; {engine.n_columns} columns live")
    engine.close()


def _mesh_devices(dev) -> list:
    """The device pool of ``--mesh`` and ``--replicas``: every visible card
    for ``--device`` unset (``cuda``), else the one device asked for."""
    if dev == torch.device("cuda"):
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def fleet_mode(args, lake, model, cost_fn, grid, dev) -> None:
    """``--replicas N``: serve through an :class:`EngineFleet` of catalog
    followers behind the load-aware router. ``--device`` unset (``cuda``)
    spreads the replicas over every visible card; any other device holds
    them all. With ``--mesh`` a replica whose slice holds several devices
    serves sharded plans over it."""
    from repro_torch.service import (DiscoveryRequest, EngineConfig, EngineFleet,
                                     LSHConfig, serve_discovery)

    devices = _mesh_devices(dev)
    fleet = EngineFleet.from_catalog(
        args.catalog, model,
        EngineConfig(k=args.k, mode=args.mode,
                     lsh=LSHConfig(n_bands=args.lsh_bands),
                     cost_fn=cost_fn, grid=grid,
                     metrics=args.metrics_port is not None,
                     warmup=(False if args.warmup == "off" else args.warmup),
                     executable_cache_dir=args.executable_cache),
        n_replicas=args.replicas, devices=devices)
    try:
        fleet.warm_event.wait(timeout=300)
        st = fleet.stats()
        slices = {rid: v["state"] for rid, v in st["replicas"].items()}
        print(f"fleet: {args.replicas} replicas over {len(devices)} devices, "
              f"states {slices}")
        metrics_server = None
        if args.metrics_port is not None:
            from repro_torch.service import MetricsServer
            metrics_server = MetricsServer(fleet.metrics, port=args.metrics_port)
            print(f"metrics: serving Prometheus exposition at {metrics_server.url}")
        qids = select_queries(lake, args.queries)
        reqs = [DiscoveryRequest(name=f"q{int(q)}", column_id=int(q)) for q in qids]
        t0 = time.perf_counter()
        responses = list(serve_discovery(fleet, reqs, max_batch=args.batch))
        dt = time.perf_counter() - t0
        st = fleet.stats()
        print(f"served {len(responses)} queries in {dt:.3f}s "
              f"({len(responses)/max(dt,1e-9):.1f} QPS, mode={args.mode}, "
              f"{st['dispatched']} batches routed, "
              f"{st['redispatches']} re-dispatched)")
        for rid, v in st["replicas"].items():
            print(f"  replica {rid}: {v['state']} "
                  f"served {v['requests_served']} requests in "
                  f"{v['batches_served']} batches "
                  f"(catalog v{v['engine_version']})")
        for r in responses[:3]:
            names = [m.column for m in r.matches[:5]]
            print(f"  {r.name} ({r.n_candidates} scored) -> {names}")
    finally:
        fleet.close()


def open_loop_mode(args, engine, qids, closed_qps: float) -> None:
    """Poisson-arrival serving through the continuous-batching scheduler."""
    from repro_torch.launch.costmodel import derive_batch_buckets
    from repro_torch.service import DiscoveryRequest
    from repro_torch.service.loadgen import run_open_loop
    from repro_torch.service.scheduler import SchedulerConfig

    offered = args.offered_qps or 2.0 * closed_qps
    buckets = derive_batch_buckets(args.calibrate or "BENCH_service.json")
    pool = [DiscoveryRequest(name=f"ol{i}", column_id=int(q))
            for i, q in enumerate(qids)]
    # warm every bucket's shape BEFORE offering load, so the first formed
    # batch at each size pays no first-contact cost against its deadline
    engine.install_buckets(buckets)
    rep = engine.warmup("serve")
    print(f"open-loop warmup: {rep['n_executables']} units in {rep['wall_ms']:.0f}ms")
    r = run_open_loop(engine, pool, offered, args.open_loop_duration,
                      args.deadline_ms,
                      scheduler_config=SchedulerConfig(batch_buckets=buckets))
    print(f"open-loop: offered {r['offered_qps']:.0f} QPS for "
          f"{r['duration_s']:.2f}s (Poisson, deadline "
          f"{args.deadline_ms:.0f}ms, buckets {r['buckets']})")
    if r["p50_ms"] is not None:
        print(f"  achieved {r['qps']:.0f} QPS, goodput "
              f"{r['goodput_qps']:.0f} QPS; latency incl queue "
              f"p50={r['p50_ms']:.1f}ms p99={r['p99_ms']:.1f}ms")
    print(f"  shed {r['shed']}/{r['n_offered']} "
          f"({100*r['shed_rate']:.1f}%), expired {r['expired']} "
          f"({100*r['expired_rate']:.1f}%); formed {r['batches']} batches, "
          f"size hist {r['batch_size_hist']}, "
          f"bucket hits {r['bucket_hits']}/{r['batches']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tables", type=int, default=40)
    ap.add_argument("--domains", type=int, default=16)
    ap.add_argument("--queries", type=int, default=10)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--model", default=None, help="path to a trained model .npz")
    ap.add_argument("--save-model", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs the "
                         "kernels' plain versions on the host)")
    ap.add_argument("--catalog", default=None,
                    help="catalog directory (enables service mode)")
    ap.add_argument("--serve", action="store_true",
                    help="serve queries through the online engine")
    ap.add_argument("--mode", default="lsh",
                    choices=["lsh", "full", "auto", "tiered", "sharded"],
                    help="engine mode ('sharded' needs --mesh)")
    ap.add_argument("--mesh", action="store_true",
                    help="serve over a mesh of every visible card (the one "
                         "host device with --device cpu)")
    ap.add_argument("--grid", default=None, metavar="QxD",
                    help="pin the (query x data) device grid for sharded "
                         "plans, e.g. 2x4 (needs --mesh; Q*D must equal the "
                         "device count). Default: the planner factorizes "
                         "the mesh per batch from batch size, lake size, "
                         "and the cost model")
    ap.add_argument("--lsh-bands", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="serve through an EngineFleet of N catalog-follower "
                         "replicas behind the load-aware router (each on its "
                         "own device slice, a mesh of it with --mesh; "
                         "warm->serve->drain->"
                         "evict lifecycle, health-check eviction, batch "
                         "re-dispatch)")
    ap.add_argument("--follow", action="store_true",
                    help="follower mode: tail the catalog manifest chain "
                         "and refresh onto new versions between batches")
    ap.add_argument("--calibrate", default=None, metavar="BENCH_JSON",
                    help="fit per-stage cost constants from a "
                         "BENCH_service.json and use them as the planner's "
                         "cost model")
    ap.add_argument("--open-loop", action="store_true",
                    help="follow the closed-loop serve with a Poisson "
                         "open-loop run through the continuous-batching "
                         "scheduler (QPS, goodput, p50/p99 incl queue wait, "
                         "shed rate)")
    ap.add_argument("--offered-qps", type=float, default=0.0,
                    help="open-loop offered load (0 = 2x the measured "
                         "closed-loop QPS)")
    ap.add_argument("--deadline-ms", type=float, default=100.0,
                    help="per-request deadline for the open-loop run")
    ap.add_argument("--open-loop-duration", type=float, default=2.0,
                    help="seconds of Poisson arrivals to offer")
    ap.add_argument("--warmup", default="off", choices=["off", "serve", "full"],
                    help="run the padded-batch bucket ladder's plans once "
                         "before serving: 'serve' the configured mode's plans "
                         "(+ recall baseline), 'full' every plan kind")
    ap.add_argument("--executable-cache", default=None, metavar="DIR",
                    help="the JAX package's persistent executable cache; the "
                         "port has no executables to persist and raises")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="enable the event bus + metrics registry and serve "
                         "the Prometheus text exposition on "
                         "http://127.0.0.1:PORT/metrics (0 = ephemeral port)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    lake = generate_lake(LakeSpec(n_domains=args.domains, n_tables=args.tables,
                                  seed=args.seed))
    print(f"lake: {lake.n_columns} columns, {lake.raw_bytes/1e6:.1f} MB raw "
          f"({time.perf_counter()-t0:.1f}s)")

    t0 = time.perf_counter()
    prof = profile_lake(lake.batch, device=dev)
    print(f"profiles: {prof.numeric.shape} in {time.perf_counter()-t0:.2f}s "
          f"({prof.nbytes()/1e3:.1f} KB = "
          f"{100*prof.nbytes()/max(lake.raw_bytes,1):.2f}% of raw)")

    if args.model:
        model = JoinQualityModel.load(args.model)
        print(f"loaded model (train R² {model.train_r2:.3f})")
    else:
        t0 = time.perf_counter()
        model = train_quality_model([lake], GBDTConfig(), device=dev)
        print(f"trained model R² {model.train_r2:.3f} "
              f"({time.perf_counter()-t0:.1f}s)")
        if args.save_model:
            model.save(args.save_model)

    if args.serve or args.catalog:
        if not args.catalog:
            ap.error("--serve needs --catalog DIR")
        serve_mode(args, lake, model, dev)
        return

    index = DiscoveryIndex(profiles=prof, model=model, names=lake.batch.names,
                           table_ids=lake.table)
    qids = select_queries(lake, args.queries)
    t0 = time.perf_counter()
    scores, ids = rank(index, qids, k=args.k, device=dev)
    dt = time.perf_counter() - t0
    valid = (ids >= 0).reshape(-1)          # k > lake size pads with -1
    sem = lake.is_semantic(np.repeat(qids, args.k),
                           np.maximum(ids.reshape(-1), 0)) & valid
    print(f"query: {len(qids)} queries in {dt:.3f}s "
          f"({dt/max(len(qids),1)*1e3:.1f} ms/query), "
          f"P@{args.k} = {sem.sum()/max(valid.sum(), 1):.3f}")
    for qi, i_row in list(zip(qids, ids))[:3]:
        names = [lake.batch.names[j] for j in i_row[:5] if j >= 0]
        print(f"  q={lake.batch.names[qi]} -> {names}")


if __name__ == "__main__":
    main()

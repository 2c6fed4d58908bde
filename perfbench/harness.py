"""One run of one benchmark cell: set-up, the measured window, the check.

The harness is driven by data. ``BENCHMARK.json`` names each cell's
configuration, traffic mix and metrics, and the harness finds each by its
name:

* a configuration's file (``configs/<config>.json``, as ``file`` says): the
  lake, the engine's settings, the plan, the model file and the limits of
  the check;
* a plan: ``plans/<kind>.py``, by the configuration's ``plan.kind``: the
  engine's name for it, the reference's answer and its control, and the
  least time a batch of it needs;
* a traffic mix: ``traffic/<mix>.json``, read by :mod:`perfbench.traffic`,
  and the kinds it names: ``arrivals/<kind>.py``, ``queries/<kind>.py``;
* a metric: ``metrics/<metric>.py``, whose ``read(run)`` returns the value
  or None when the run holds nothing for it to read.

Set-up draws the lake on the card from the seed, ingests it through the
port's ``service.catalog.profile_and_sign`` into an in-memory
``CatalogSnapshot``, opens ``DiscoveryEngine(snapshot, model, cfg)`` behind a
``RequestScheduler`` with its default settings and warms the engine for the
scheduler's bucket ladder. A configuration with ``"placement": {"replicas":
N}`` is served instead by an ``EngineFleet`` of N such engines, one a card
over the cell's ``chips`` cards (``cuda:0`` ... ``cuda:N-1``), each over the
same snapshot, behind the one scheduler. The window then drives
``RequestScheduler.submit``. After it closes, the program's state is freed
and the plain reference (:mod:`perfbench.reference`) answers a sample of
the window's requests drawn from the seed.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PB = ROOT / "perfbench"
JAX_NAMES = frozenset({"jax", "jaxlib", "flax", "repro"})
SAMPLE_SALT = 0x5A


class BenchError(Exception):
    """The benchmark's inputs are not what this run needs."""


def _json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"missing file {path}")
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def find_cell(manifest: dict, name: str) -> tuple[dict, dict]:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise BenchError(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    if cell["config"] not in configs:
        raise BenchError(f"workload {name!r} names configuration {cell['config']!r}, "
                         f"which BENCHMARK.json does not list")
    return cell, configs[cell["config"]]


def load_config(entry: dict, root: Path = ROOT) -> dict:
    return _json(root / entry["file"])


def piece(folder: str, name: str, root: Path = ROOT):
    """The module ``perfbench/<folder>/<name>.py``."""
    path = root / "perfbench" / folder / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"{folder} {name!r} has no module {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{folder}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_traffic(name: str, root: Path = ROOT):
    """The mix ``traffic/<name>.json`` with the modules of its kinds."""
    from perfbench import traffic
    params = _json(root / "perfbench" / "traffic" / f"{name}.json")
    try:
        return traffic.Mix(params, piece("arrivals", str(params.get("arrivals")), root),
                           piece("queries", str(params.get("queries")), root))
    except ValueError as e:
        raise BenchError(f"traffic {name!r}: {e}") from None


def load_plan(config: dict, root: Path = ROOT):
    return piece("plans", str(config["plan"]["kind"]), root)


def metrics_for(manifest: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics this cell's line carries: its end-to-end metrics, or with
    ``traced`` its per-layer metrics (those listing the cell, or listing no
    cells while moving an end-to-end metric the cell reports)."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def load_reader(name: str, root: Path = ROOT):
    return piece("metrics", name, root).read


class Names:
    """Column names ``c<i>`` without a list of millions of strings."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [f"c{j}" for j in range(*i.indices(self.n))]
        if not -self.n <= int(i) < self.n:
            raise IndexError(i)
        return f"c{int(i) % self.n}"


class Run:
    """What the metric readers and the check read. With a placement,
    ``engine_before``/``engine_after`` are the replicas' ``stats()`` merged
    (:func:`merged_stats`), and ``fleet_before``/``fleet_after`` the fleet's
    ``stats()`` (the router's counters, each replica's ``batches_served``);
    None without one."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def batch_sizes(self) -> dict[int, int]:
        """Formed batches of the window by size: the scheduler's histogram,
        after minus before."""
        a, b = self.sched_before["batch_size_hist"], self.sched_after["batch_size_hist"]
        return {int(n): int(c) - int(a.get(n, 0)) for n, c in b.items()
                if int(c) - int(a.get(n, 0)) > 0}

    def n_batches(self) -> int:
        return sum(self.batch_sizes().values())

    def per_batch_ms(self, phases) -> float | None:
        """Mean ms a formed batch spent in the engine's trace ``phases``: each
        response carries its batch's phase walls divided by the batch's
        size, so their sum over the responses, over the batches, is the
        mean a batch."""
        n = self.n_batches()
        if not n:
            return None
        return sum(self.window.log.span_ms.get(p, 0.0) for p in phases) / n


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------

def engine_config(config: dict):
    from repro_torch.service.engine import EngineConfig
    from repro_torch.service.lsh import LSHConfig
    e = dict(config["engine"])
    lsh = e.pop("lsh", {})
    return EngineConfig(lsh=LSHConfig(**lsh), **e)


def placement_replicas(config: dict) -> int | None:
    """The engines a fleet placement asks for, one a card; None without the
    ``placement`` key (one engine, no fleet)."""
    if "placement" not in config:
        return None
    place = config["placement"]
    n = place.get("replicas") if isinstance(place, dict) else None
    if (not isinstance(place, dict) or set(place) != {"replicas"} or not isinstance(n, int)
            or isinstance(n, bool) or n < 1):
        raise BenchError(f"placement {place!r}: want {{\"replicas\": N}} with a whole N >= 1")
    return n


def as_devices(device) -> list[torch.device]:
    """One device, or a list of them, as a list."""
    if isinstance(device, (str, torch.device)):
        device = [device]
    return [torch.device(d) for d in device]


def setup(config: dict, seed: int, device, log) -> dict:
    """Lake, snapshot, engine (or, with a placement, a fleet of engines, one a
    device of ``device``), scheduler, warmed: the program under test."""
    from perfbench import lakegen
    from repro_torch.core.ingest import ColumnBatch
    from repro_torch.core.predictor import JoinQualityModel
    from repro_torch.core.profiles import lake_profiles
    from repro_torch.service.catalog import CatalogSnapshot, profile_and_sign
    from repro_torch.service.engine import DiscoveryEngine
    from repro_torch.service.scheduler import RequestScheduler, SchedulerConfig

    devices = as_devices(device)
    n_replicas = placement_replicas(config)
    if len(devices) != (n_replicas or 1):
        raise BenchError(f"{len(devices)} device(s) for "
                         f"{n_replicas or 1} engine(s): {[str(d) for d in devices]}")
    walls = {}
    t = time.perf_counter()
    shape = lakegen.LakeShape.from_dict(config["lake"])
    # the columns are drawn on the (first) card as ingest walks them
    lake = lakegen.StreamedLake(shape, seed, devices[0])
    c = shape.n_columns
    table = (np.arange(c) // shape.cols_per_table).astype(np.int32)
    batch = ColumnBatch(values32=lake.values32, char_len=lake.char_len,
                        word_cnt=lake.word_cnt,
                        n_rows=np.full((c,), shape.row_budget, np.int32),
                        names=Names(c), table_ids=table)
    num, words, sigs = profile_and_sign(batch, config["n_perm"], config["minhash_seed"],
                                        device=devices[0])
    del batch, lake
    prof = lake_profiles(num, words, np.full((c,), shape.row_budget, np.int32))
    snap = CatalogSnapshot(profiles=prof, signatures=sigs, table_ids=table,
                           names=Names(c), table_names={}, version=1,
                           minhash_seed=config["minhash_seed"])
    walls["draw_and_ingest_s"] = time.perf_counter() - t
    t = time.perf_counter()
    model = JoinQualityModel.load(str(PB / config["model"]))
    engines = []
    for i, d in enumerate(devices):
        engines.append(DiscoveryEngine(snap, model, engine_config(config), device=d))
        walls[f"engine_s.{i}" if n_replicas else "engine_s"] = time.perf_counter() - t
        t = time.perf_counter()
    fleet = None
    if n_replicas:
        from repro_torch.service.fleet import EngineFleet, FleetConfig
        fleet = EngineFleet(engines, FleetConfig())
    scheduler = RequestScheduler(fleet if fleet is not None else engines[0], SchedulerConfig())
    # every engine warms the ladder the scheduler installed on it
    reports = [e.warmup("serve") for e in engines]
    if fleet is not None and not fleet.warm_event.wait(60.0):
        raise BenchError(f"the fleet has no serving replica: {fleet.stats()['replicas']}")
    _sync(devices)
    # the set-up heap (the imported modules, the warm engine) is frozen out
    # of the collector's walks, so the window's collections walk what the
    # window allocates: unfrozen, ~9 full collections of 100-150 ms fell in
    # every 10-s window and set the spread of the runs (PERF.md)
    gc.collect()
    gc.freeze()
    walls["warmup_s"] = time.perf_counter() - t
    log(f"set-up walls (s): {json.dumps({k: round(v, 3) for k, v in walls.items()})}; "
        f"warmup {reports[0]['n_executables']} units over buckets {reports[0]['buckets']}"
        + (f" on each of {len(engines)} replicas" if fleet is not None else ""))
    return {"engine": engines[0], "engines": engines, "fleet": fleet, "scheduler": scheduler,
            "shape": shape}


def _sync(devices) -> None:
    for d in {d for d in as_devices(devices) if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def merged_stats(stats: list[dict]) -> dict:
    """The replicas' ``engine.stats()`` as one: the counters, ``plans``, the
    ``cache`` counts and the ``trace`` totals summed (a span's ``max_ms``
    the largest), the rest replica 0's. One engine's are its own."""
    if len(stats) == 1:
        return stats[0]
    out = dict(stats[0])
    for key in ("queries", "batches", "scored_columns", "plans", "cache", "trace"):
        for s in stats[1:]:
            out[key] = _summed(out[key], s[key])
    return out


def _summed(a, b, key: str = ""):
    if isinstance(a, dict):
        return {k: _summed(a[k], b[k], k) if k in a and k in b else a.get(k, b.get(k))
                for k in {**a, **b}}
    if isinstance(a, bool) or not isinstance(a, (int, float)):
        return a
    return max(a, b) if key.startswith("max") else a + b


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def sample_rows(log, seed: int, n: int) -> np.ndarray:
    """Up to ``n`` answered requests of distinct columns, drawn from the seed."""
    answered = np.flatnonzero(log.answered)
    order = answered[np.random.default_rng([int(seed), SAMPLE_SALT]).permutation(answered.size)]
    _, first = np.unique(log.column_id[order], return_index=True)
    return order[np.sort(first)][:n]


def gaps(prog_sc, prog_ids, ref_sc, exact_of_prog) -> dict:
    """``rank_gap``: the widest margin by which the reference score of the
    program's j-th answer lies below the reference answer's j-th score (an
    answer missing where the reference has one, or one that may not answer,
    is an infinite gap). ``score_err``: the widest distance between a
    returned score and the reference's score of the same column."""
    with np.errstate(invalid="ignore"):
        return _gaps(prog_sc, prog_ids, ref_sc, exact_of_prog)


def _gaps(prog_sc, prog_ids, ref_sc, exact_of_prog) -> dict:
    ref_ok = np.isfinite(ref_sc)
    gap = np.where(ref_ok, ref_sc - exact_of_prog, 0.0)
    gap = np.where(ref_ok & ~np.isfinite(exact_of_prog), np.inf, gap)
    has = prog_ids >= 0
    err = np.where(has, np.abs(prog_sc.astype(np.float64) - exact_of_prog), 0.0)
    err = np.where(has & ~np.isfinite(exact_of_prog), np.inf, err)
    extra = has & ~ref_ok               # an answer where the reference has none
    return {"rank_gap": float(max(gap.max(initial=0.0), np.inf if extra.any() else 0.0)),
            "score_err": float(err.max(initial=0.0))}


def top_bucket(config: dict) -> int:
    """The largest batch the scheduler forms and pads to: the top of the
    ladder it takes from the engine (``SchedulerConfig()`` sets none)."""
    from repro_torch.exec.plan import DEFAULT_BATCH_BUCKETS
    return int(max(engine_config(config).batch_buckets or DEFAULT_BATCH_BUCKETS))


def reference_numbers(config: dict, seed: int, qids: np.ndarray, prog_sc, prog_ids,
                      device, log, *, pad: int, control: bool = False,
                      root: Path = ROOT) -> dict:
    """The reference's answers to ``qids``, in batches of ``pad`` (the
    scheduler's top bucket), and the numbers comparing the program's answers
    with them. ``control`` puts the reference, one precision lower, in the
    program's place (``prog_*`` are then ignored)."""
    from perfbench import lakegen
    from perfbench.reference import plain

    if len(qids) == 0:
        return {"rank_gap": 0.0, "score_err": 0.0}
    t = time.perf_counter()
    plan = load_plan(config, root)
    shape = lakegen.LakeShape.from_dict(config["lake"])
    k = int(config["engine"]["k"])
    blocks = lakegen.generate_blocks(shape, seed, device, lakegen.BLOCK)
    lake = plain.build_lake(blocks, shape.cols_per_table, device,
                            n_perm=config["n_perm"], minhash_seed=config["minhash_seed"],
                            **plan.lake_kwargs(config))
    model = plain.Ensemble.load(str(PB / config["model"]), device)
    t_lake = time.perf_counter() - t
    q = torch.from_numpy(np.asarray(qids, np.int64)).to(device)
    ref_sc, exact, ctl_sc, ctl_ids = [], [], [], []
    prog_ids_t = None if control else torch.from_numpy(np.asarray(prog_ids, np.int64)).to(device)
    for lo in range(0, len(qids), pad):
        qb = q[lo:lo + pad]
        sc, _ = plan.answer(lake, model, qb, k, config, pad)
        ref_sc.append(sc)
        if control:
            csc, cids = plan.answer(lake, model, qb, k, config, pad, control=True)
            ctl_sc.append(csc)
            ctl_ids.append(cids)
            exact.append(plain.exact_scores(lake, model, qb, cids))
        else:
            exact.append(plain.exact_scores(lake, model, qb, prog_ids_t[lo:lo + pad]))
    cat = lambda xs: torch.cat(xs).cpu().numpy()
    # the reference's own answer, scored exactly (its scores are exact)
    ref_exact = cat(ref_sc)
    if control:
        prog_sc, prog_ids = cat(ctl_sc), cat(ctl_ids)
    out = gaps(prog_sc, prog_ids, ref_exact, cat(exact))
    log(f"reference: lake worked out in {t_lake:.2f} s, {len(qids)} queries answered "
        f"in {time.perf_counter() - t - t_lake:.2f} s ({'control' if control else 'program'})")
    del lake
    return out


def check_numbers(run: Run, config: dict, seed: int, device, log, root: Path = ROOT) -> dict:
    """Every number compared, beside its limit."""
    k = int(config["engine"]["k"])
    limits = config["check"]["limits"]
    log_ = run.window.log
    unanswered = int((log_.state == log_.PENDING).sum())
    misdelivered = int(log_.misdelivered.sum() + log_.broken.sum())
    want = load_plan(config, root).LABEL
    pa, pb = run.engine_before["plans"], run.engine_after["plans"]
    wrong_plan = sum(int(v) - int(pa.get(p, 0)) for p, v in pb.items() if p != want)
    rows = sample_rows(log_, seed, int(config["check"]["sample"]))
    numbers = {"unanswered": unanswered + misdelivered, "wrong_plan": wrong_plan}
    run.free_program()
    numbers.update(reference_numbers(config, seed, log_.column_id[rows], log_.scores[rows],
                                     log_.ids[rows], device, log, pad=run.top_bucket,
                                     root=root))
    log(f"check: {len(rows)} sampled responses of {log_.n} requests")
    return {name: {"value": numbers[name], "limit": limits[name]} for name in
            ("unanswered", "wrong_plan", "rank_gap", "score_err")}


def _finite(v: float) -> float:
    """JSON has no infinity: an infinite gap prints as 1e30."""
    return float(v) if np.isfinite(v) else 1e30


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run_cell(cell: dict, config: dict, mix, seed: int, seconds: float,
             traced: bool, device, t_process: float, log=print, root: Path = ROOT) -> Run:
    """Set up, drive the window, read the trace; the program stays open on
    the returned run until :meth:`Run.free_program`. ``device`` is one
    device, or with a placement a list of them, one a replica."""
    from perfbench import devtrace, hoststat, traffic

    devices = as_devices(device)
    cards = list(dict.fromkeys(d for d in devices if d.type == "cuda"))
    if cards:
        torch.cuda.init()       # a card's memory statistics exist once CUDA is up
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)
    prog = setup(config, seed, devices, log)
    engines, fleet, scheduler = prog["engines"], prog["fleet"], prog["scheduler"]
    setup_s = time.perf_counter() - t_process
    sched_before = scheduler.stats()
    engine_before = merged_stats([e.stats() for e in engines])
    fleet_before = fleet.stats() if fleet is not None else None
    prof = None
    if traced:
        prof = devtrace.start(devices[0])
        gc.collect()            # what starting the profiler made, frozen as set-up's was
        gc.freeze()
    pauses = GcPauses()
    cpu0 = hoststat.sample()
    window = traffic.run(mix, scheduler, prog["shape"].n_columns, seed, seconds,
                         int(config["engine"]["k"]))
    _sync(devices)
    thread_cpu_s = hoststat.delta(cpu0, hoststat.sample())
    pauses.close()
    trace = (devtrace.summarize(prof, window.t_end - window.t_start, n_cards=max(len(cards), 1))
             if traced else None)
    peaks = [int(torch.cuda.max_memory_allocated(d)) if d.type == "cuda" else 0
             for d in devices]

    def free_program():
        scheduler.close()
        if fleet is not None:
            fleet.close()
        for e in engines:
            e.close()
        prog.clear()
        gc.collect()
        for card in cards:
            with torch.cuda.device(card):
                torch.cuda.empty_cache()

    plan = load_plan(config, root)
    trees, depth = np.load(PB / config["model"])["feats"].shape
    n = prog["shape"].n_columns

    def plan_bound_s(q: int) -> float:
        """The least seconds one padded batch of ``q`` needs, from the
        configuration's shapes."""
        return plan.bound_s(q, n, config, int(trees), int(depth))

    return Run(config=config, window=window, gc=pauses.summary(), thread_cpu_s=thread_cpu_s,
               setup_s=setup_s, memory_peak_bytes=max(peaks), devices=devices,
               card_peak_bytes=peaks,
               sched_before=sched_before, sched_after=scheduler.stats(),
               engine_before=engine_before,
               engine_after=merged_stats([e.stats() for e in engines]),
               fleet_before=fleet_before,
               fleet_after=fleet.stats() if fleet is not None else None, trace=trace,
               snap_batch=engines[0].planner.snap_batch, top_bucket=scheduler.buckets[-1],
               plan_bound_s=plan_bound_s, free_program=free_program)


class GcPauses:
    """The interpreter's garbage-collection pauses while it is open, by
    generation: how many, and their summed and longest milliseconds."""

    def __init__(self):
        self.n, self.ms, self.max_ms = [0] * 3, [0.0] * 3, [0.0] * 3
        self._t = 0.0
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
            return
        g, ms = info["generation"], (time.perf_counter() - self._t) * 1e3
        self.n[g] += 1
        self.ms[g] += ms
        self.max_ms[g] = max(self.max_ms[g], ms)

    def close(self) -> None:
        gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        return {"n": self.n, "ms": [round(x, 3) for x in self.ms],
                "max_ms": [round(x, 3) for x in self.max_ms]}


def describe(run: Run, log) -> None:
    """The numbers that go on earlier lines: sample counts, the tail beyond
    p95, the generator's lateness, the batches formed."""
    w = run.window
    lat = w.log.latency_ms()
    fin = lat[np.isfinite(lat)]
    late = w.lateness_ms
    info = {"requests": w.log.n, "answered": int(fin.size),
            "errors": int((w.log.state == w.log.FAILED).sum()), "first_errors": w.log.errors[:3],
            "window_s": round(w.seconds, 6), "drain_s": round(w.t_end - w.t_stop, 6),
            "latency_ms": ({q: float(np.quantile(fin, p)) for q, p in
                            (("p50", .5), ("p95", .95), ("p99", .99), ("max", 1.0))}
                           if fin.size else {}),
            "beyond_p95": int((fin > np.quantile(fin, .95)).sum()) if fin.size else 0,
            "lateness_ms": ({"p50": float(np.quantile(late, .5)),
                             "p99": float(np.quantile(late, .99)),
                             "max": float(late.max())} if late.size else {}),
            "batches": run.batch_sizes(),
            "max_queue_depth": run.sched_after["max_queue_depth"],
            "cache_hits": run.engine_after["cache"]["hits"] - run.engine_before["cache"]["hits"],
            "gc": run.gc, "thread_cpu_s": run.thread_cpu_s,
            **({"replica_batches": {r: v["batches_served"]
                                    - run.fleet_before["replicas"][r]["batches_served"]
                                    for r, v in run.fleet_after["replicas"].items()}}
               if run.fleet_after is not None else {}),
            **({"busy_s_per_card": run.trace["per_card"]} if run.trace is not None else {}),
            "phase_ms_a_batch": {p: round(v / max(run.n_batches(), 1), 4)
                                 for p, v in sorted(w.log.span_ms.items())
                                 if p not in ("queue", "profile")}}
    log("window: " + json.dumps(info))


def jax_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in JAX_NAMES)


def device_info(run: Run, traced: bool, fleet: bool) -> dict:
    """The result line's ``device``: the fullest card's peak; with a fleet
    also ``per_card``, each replica's device with its peak (and, traced, its
    busy seconds)."""
    dev = run.devices[0]
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
               "count": len(run.devices), "memory_peak_bytes": run.memory_peak_bytes}
    else:
        out = {"platform": "cpu", "kind": "host", "count": len(run.devices),
               "memory_peak_bytes": run.memory_peak_bytes}
    if traced:
        out["busy_s"] = run.trace["busy_s"]
        out["window_s"] = run.trace["window_s"]
    if fleet:
        out["per_card"] = [{"device": str(d), "memory_peak_bytes": peak}
                           for d, peak in zip(run.devices, run.card_peak_bytes)]
        if traced:
            for card, d in zip(out["per_card"], run.devices):
                card["busy_s"] = run.trace["per_card"].get(d.index, 0.0) \
                    if d.type == "cuda" else 0.0
    return out


def execute(cell_name: str, seed: int, seconds: float, traced: bool, t_process: float,
            *, device=None, root: Path = ROOT, out=print, err=None) -> int:
    """Run one cell once and print its lines; the exit code."""
    err = err or (lambda s: print(s, file=sys.stderr, flush=True))
    manifest = load_manifest(root)
    cell, entry = find_cell(manifest, cell_name)
    config = load_config(entry, root)
    load_plan(config, root)
    mix = load_traffic(cell["traffic"], root)
    wanted = metrics_for(manifest, cell_name, traced)
    readers = {m["name"]: load_reader(m["name"], root) for m in wanted}
    n_replicas = placement_replicas(config)
    if n_replicas is not None and n_replicas != int(cell["chips"]):
        raise BenchError(f"configuration {entry['name']!r} places {n_replicas} replica(s), "
                         f"one a card, but cell {cell_name!r} has {cell['chips']} chip(s)")
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            err(f"perfbench: cell {cell_name!r} needs {cell['chips']} CUDA device(s); "
                f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        device = [f"cuda:{i}" for i in range(n_replicas)] if n_replicas else "cuda:0"
    devices = as_devices(device)
    run = run_cell(cell, config, mix, seed, seconds, traced, devices, t_process, log=out,
                   root=root)
    metrics = {}
    for m in wanted:
        v = readers[m["name"]](run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    describe(run, out)
    found = jax_modules()
    if found:
        run.free_program()
        err(f"perfbench: JAX or the JAX package is loaded: {found}")
        return 4
    checks = check_numbers(run, config, seed, devices[0], out, root)
    result = {"correct": passed(checks), "attempted": run.window.log.n,
              "failed": int((~run.window.log.answered).sum()),
              "metrics": metrics, "device": device_info(run, traced, n_replicas is not None)}
    if traced:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = checks = {n: {"value": _finite(c["value"]), "limit": c["limit"]}
                                 for n, c in checks.items()}
    for name, c in checks.items():
        err(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    out(json.dumps(result))
    return 0

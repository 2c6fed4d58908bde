"""Executor: runs a QueryPlan's candidate→score→merge pipeline on a corpus.

The port of ``repro.exec.executor.Executor``. One ``Executor`` holds one
immutable corpus view on its device — the profile
matrix (float32, or an int8/float16 sidecar with its per-feature dequant
scale), word hashes, table ids, optional LSH band keys and an optional
coarse super-band digest — plus the GBDT parameters, and executes the
``all``, ``lsh``, ``hybrid`` and ``tiered`` pipelines against it. Scoring
always goes through the fused scorers (``ops.fused_score`` and, over a
sidecar, ``ops.fused_score_q``): the hand-written kernels on the card.

**Sharded plans** run on the plan's 2-D ``grid=(q_shards, d_shards)`` over
the executor's ``mesh`` (a :class:`~repro_torch.launch.mesh.DeviceMesh`):
(1, d) grids keep the caller's mesh and ``shard_axes``; q > 1 grids re-shape
its devices through ``make_grid_mesh``, cached per grid. The corpus is
placed over each grid's data axis once (cached per (grid, axes) and shared
by ``all`` and pruned plans; a successor built by ``extended`` places again
on its first sharded batch), the batch is padded to a multiple of
``q_shards`` and sliced back. Sharded tiles score float32 shards: a
quantized corpus is dequantized once at placement. Its sharded scans
over-fetch ``RESCORE_MULT × k`` for the exact re-rank, as the local ones
do, where the JAX package's sharded scans re-rank only the k they return:
the merged top ``RESCORE_MULT × k`` is the lake's, so a sharded quantized
answer equals the local one up to exact ties. ``tiered`` plans are local
only.

With a quantized ``profile_dtype`` only the sidecar and its scale live on
the device; the float32 source stays on the host. The scan over-fetches
``RESCORE_MULT × k`` candidates and an exact float32 re-rank of those few
gathered rows restores the float32 top-k ordering, so returned scores are
float32-exact whatever the resident dtype.

The returned contract is the JAX package's: numpy ``(scores (Q, k), global
ids (Q, k), n_scored (Q,))``, padded with -inf / -1 when fewer than k
columns are rankable, with ``n_scored`` the number of live columns the GBDT
actually scored per query (summed over the data shards on a grid).

**Lifecycle.** The serving engine keeps one executor per catalog version:

* ``n_padded=`` pads the resident corpus up to a column bucket with inert
  sentinel rows (profile 0, words ``HASH_SENTINEL``, table id -2, column id
  -1, band keys ``PAD_CORPUS``); the exclusion mask scores them -inf, so no
  plan ranks or counts them;
* :meth:`Executor.extended` builds the successor of an append-only delta:
  only the new rows cross the host-device link, and the live prefix is
  copied on the device into the successor's own tensors (a new bucket's
  size when the delta crosses one). A predecessor's tensors are never
  written, so a batch still running on it reads what it pinned;
* the row tensors and the GBDT tensors live in refcounted
  :class:`PlacementBundle` objects: :meth:`Executor.close` releases them (the
  GBDT bundle, shared by every successor, frees at its last release), and
  ``execute`` after close raises;
* :meth:`Executor.aot_compile` is the warmup: it runs every (plan, padded
  batch) once on sentinel queries, so every kernel library is loaded and
  every first-contact cost is paid before traffic. The port has no
  executables to serialize; the kernels it builds stay in ``_build``'s
  content-keyed build directory across processes.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.core import features as FT
from repro_torch.core.predictor import gbdt_to_torch
from repro_torch.device import from_bits, hashes_to_torch, resolve_device, to_bits
from repro_torch.exec import stages, tracing
from repro_torch.exec.plan import QueryPlan
from repro_torch.exec.sharded import (PAD_BITS, PAD_FILL, build_sharded_pipeline,
                                      place_sharded_corpus)
from repro_torch.kernels.lsh_probe import PAD_QUERY
from repro_torch.kernels.profile_distance import dequantize, quantize_profiles

# quantized scans over-fetch this multiple of k, then an exact float32
# re-rank of the over-fetched set restores the float32 top-k ordering: GBDT
# scores are threshold-discontinuous, so even fp16's ~5e-4 profile error
# flips near-boundary ranks
RESCORE_MULT = 4


class PlacementBundle:
    """Refcounted bundle of device tensors.

    Successors built by :meth:`Executor.extended` retain their
    predecessor's GBDT bundle instead of placing the parameters again,
    while each version's row tensors live in a bundle owned by one
    executor (or shared outright by a zero-row successor). A tensor frees
    when the last holder releases; the class-level live count gives leak
    tests a direct handle on how many placements exist.
    """

    _live = 0
    _live_lock = threading.Lock()

    def __init__(self, arrays: dict):
        self.arrays = dict(arrays)
        self.refs = 1
        self._lock = threading.Lock()
        with PlacementBundle._live_lock:
            PlacementBundle._live += 1

    def retain(self) -> "PlacementBundle":
        with self._lock:
            if self.refs <= 0:
                raise RuntimeError("retain() on a released bundle")
            self.refs += 1
        return self

    def release(self) -> None:
        with self._lock:
            self.refs -= 1
            if self.refs > 0:
                return
            self.arrays.clear()
        with PlacementBundle._live_lock:
            PlacementBundle._live -= 1


def live_placement_bundles() -> int:
    """Placement bundles currently holding tensors: bounded by (live
    versions) x (bundles per executor) when nothing leaks."""
    with PlacementBundle._live_lock:
        return PlacementBundle._live


def _pad_np(a: np.ndarray, n: int, fill) -> np.ndarray:
    """``a`` with its leading axis padded up to ``n`` rows of ``fill``."""
    if a.shape[0] >= n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad])


def _rescore_exact(zq, wq, zg, wg, gbdt_tuple, sc_scan, ids, k: int):
    """Re-rank an over-fetched (Q, R) candidate set with its exact float32
    rows ``zg``/``wg`` (Q, R, F); slots the scan left invalid (non-finite
    score) stay excluded. Returns (scores (Q, k'), ids (Q, k'))."""
    s = stages.score_columns(zq, wq, zg, wg, gbdt_tuple)
    s = torch.where(torch.isfinite(sc_scan), s, float("-inf"))
    sc, pos = stages.topk_stable(s, min(k, s.shape[1]))
    return sc, torch.where(torch.isfinite(sc), torch.gather(ids, 1, pos), -1)


def pad_rows(arrays, multiple: int):
    """Pad every array's leading (query) axis up to a multiple of
    ``multiple`` by repeating the last row — the repeated rows carry their
    qid/tq along, so masking stays consistent, and the caller slices the
    duplicate results back off. Returns (padded_arrays, original_length)."""
    q = int(np.asarray(arrays[0]).shape[0])
    pad = -(-q // max(multiple, 1)) * max(multiple, 1)
    if pad == q:
        return [np.asarray(a) for a in arrays], q
    rep = lambda a: np.concatenate(
        [np.asarray(a), np.repeat(np.asarray(a)[-1:], pad - q, axis=0)])
    return [rep(a) for a in arrays], q


def pad_topk(scores: np.ndarray, ids: np.ndarray, k: int):
    """Pad (Q, k_eff) top-k results out to k columns (-inf scores, -1 ids)."""
    k_eff = scores.shape[1]
    if k_eff >= k:
        return scores[:, :k], ids[:, :k]
    pad = ((0, 0), (0, k - k_eff))
    return (np.pad(scores, pad, constant_values=-np.inf),
            np.pad(ids, pad, constant_values=-1))


class Executor:
    """Executes query plans against one corpus view on ``device``, and
    sharded plans over the tiles of ``mesh``.

    ``profile_dtype`` ("fp32", "fp16" or "int8") quantizes ``z`` into the
    resident sidecar; a caller that already quantized passes the sidecar as
    ``z`` and its scale as ``z_scale``. ``fp32_rows`` (``ids -> (..., F)
    float32``) overrides the host float32 source of the exact re-rank.
    ``n_padded`` pads the corpus to that many rows with sentinel rows;
    ``events`` is a sink with ``publish(type, **payload)``. ``device``
    defaults to the mesh's first device with a mesh, else to the card.
    """

    def __init__(self, z: np.ndarray, w: np.ndarray, gbdt_tuple, *,
                 table_ids: np.ndarray | None = None,
                 band_keys: np.ndarray | None = None,
                 coarse_keys: np.ndarray | None = None,
                 profile_dtype: str = "fp32", z_scale=None, fp32_rows=None,
                 survivor_block: int = 32, events=None,
                 n_padded: int | None = None, device=None, mesh=None):
        if device is None and mesh is not None:
            device = mesh.devices.flat[0]
        self.device = resolve_device(device)
        self.mesh = mesh
        # n_live: the true resident columns; n_columns: the (bucket-padded)
        # corpus axis every plan clamp is computed from
        self.n_live = int(z.shape[0])
        self.n_columns = (max(int(n_padded), self.n_live) if n_padded is not None
                          else self.n_live)
        self.profile_dtype = str(profile_dtype)
        self.survivor_block = int(survivor_block)
        if z_scale is not None:
            z_res, scale = np.asarray(z), np.asarray(z_scale, np.float32)
            zf_host = None                   # pre-quantized: no float32 source
        else:
            z_res, scale = quantize_profiles(z, self.profile_dtype)
            zf_host = None if self.profile_dtype == "fp32" else np.asarray(z, np.float32)
        # the exact re-rank's row source: an explicit callable, the host
        # float32 copy of a quantized corpus, or None (the scan is exact)
        if fp32_rows is not None:
            self._fp32_rows = fp32_rows
        elif zf_host is not None:
            self._fp32_rows = zf_host.__getitem__
        else:
            self._fp32_rows = None
        n = self.n_columns
        tids = (np.asarray(table_ids, np.int32) if table_ids is not None
                else np.zeros((self.n_live,), np.int32))
        # host -> device bytes this placement spent (a successor built by
        # ``extended`` counts only its delta rows)
        self.bytes_uploaded = 0
        rows = dict(
            z=self._upload(_pad_np(z_res, n, PAD_FILL["z"])),
            w=from_bits(self._upload(_pad_np(_bits(w), n, -1))),   # -1: HASH_SENTINEL
            tids=self._upload(_pad_np(tids, n, PAD_FILL["tids"])).to(torch.int64),
            cids=_live_ids(self.n_live, n, self.device),
            # the probes test key equality only: the resident keys are int32
            # bit-views, so no probe call converts the lake's keys
            ckeys=(self._upload(_pad_np(_bits(band_keys), n, PAD_BITS))
                   if band_keys is not None else None),
            coarse=(self._upload(_pad_np(_bits(coarse_keys), n, PAD_BITS))
                    if coarse_keys is not None else None))
        self._zscale = self._upload(scale)
        self._adopt_rows(rows, PlacementBundle(dict(rows, zscale=self._zscale)))
        self._gbdt = gbdt_to_torch(gbdt_tuple, self.device)
        self._gbdt_bundle = PlacementBundle(
            {f"gbdt{i}": a for i, a in enumerate(self._gbdt[:3])})
        self._init_serving(events, warm=set(), seen=set())

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:              # a read-only segment memmap
            a = a.copy()
        self.bytes_uploaded += int(a.nbytes)
        return torch.from_numpy(a).to(self.device)

    def _adopt_rows(self, rows: dict, bundle: PlacementBundle) -> None:
        self._z, self._w = rows["z"], rows["w"]
        self._tids, self._cids = rows["tids"], rows["cids"]
        self._ckeys, self._coarse = rows["ckeys"], rows["coarse"]
        self._rows_bundle = bundle

    def _rows(self) -> dict:
        return dict(z=self._z, w=self._w, tids=self._tids, cids=self._cids,
                    ckeys=self._ckeys, coarse=self._coarse)

    def _init_serving(self, events, warm: set, seen: set) -> None:
        # warmup's dispatch table: the (pipeline, batch, corpus, statics)
        # units ``aot_compile`` ran; a successor inherits it
        self._warm = warm
        self._seen_shapes = seen
        self._dispatch_stats = {"aot": 0, "fallback": 0}
        # observability: a duck-typed event sink; the first execution of a
        # (plan, batch shape) is a visible compile_begin/compile_end pair
        self._events = events
        self._closed = False
        self._tls = threading.local()
        # sharded state, built lazily: grid meshes per grid, placements per
        # (grid, data axes), pipelines per (kind, k, budget, axes, grid)
        self._grid_meshes: dict[tuple, object] = {}
        self._placed: dict[tuple, dict] = {}
        self._pipelines: dict[tuple, object] = {}

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Release the corpus's device tensors. The engine closes a
        version's executor when the last batch that pinned it unpins it,
        after that batch's results reached the host. Idempotent; ``execute``
        after close raises."""
        if self._closed:
            return
        self._closed = True
        self._placed.clear()
        self._pipelines.clear()
        self._z = self._w = self._cids = self._tids = self._ckeys = None
        self._zscale = self._coarse = None
        self._rows_bundle.release()
        self._gbdt_bundle.release()

    @property
    def closed(self) -> bool:
        return self._closed

    # -- delta placement ----------------------------------------------------

    def extended(self, z_rows, w_rows, *, table_ids, band_keys=None,
                 coarse_keys=None, fp32_rows=None,
                 n_padded: int | None = None) -> "Executor":
        """Successor executor for an append-only corpus delta.

        Only the new rows cross the host-device link. The successor gets
        tensors of its own: the predecessor's live prefix copied on the
        device, then the delta rows, then sentinel padding up to
        ``n_padded`` (by default the predecessor's corpus size, or the live
        count if the delta outgrows it), so a new bucket places the corpus
        again at its size. A zero-row delta at the same size shares the
        predecessor's tensors outright. The GBDT tensors are shared
        (refcounted), and so are the warmed units, so a successor serves
        warmed shapes without a first-contact run.

        ``z_rows`` must be float32 rows z-scored under the predecessor's
        statistics; a quantized corpus takes the engine's full rebuild.
        """
        if self._closed:
            raise RuntimeError("executor is closed")
        if self.profile_dtype != "fp32":
            raise NotImplementedError(
                "delta placement requires a float32-resident corpus; "
                "quantized corpora take the full-rebuild path")
        if (self._ckeys is None) != (band_keys is None):
            raise ValueError("band_keys must match the predecessor's")
        if (self._coarse is None) != (coarse_keys is None):
            raise ValueError("coarse_keys must match the predecessor's")
        z_rows = np.asarray(z_rows, np.float32)
        d = int(z_rows.shape[0])
        n_live2 = self.n_live + d
        n_pad2 = (max(int(n_padded), n_live2) if n_padded is not None
                  else max(self.n_columns, n_live2))
        ex = object.__new__(Executor)
        ex.device, ex.mesh, ex.profile_dtype = self.device, self.mesh, self.profile_dtype
        ex.survivor_block = self.survivor_block
        ex.n_live, ex.n_columns = n_live2, n_pad2
        ex._fp32_rows = fp32_rows
        ex._zscale = self._zscale
        ex._gbdt = self._gbdt
        ex._gbdt_bundle = self._gbdt_bundle.retain()
        ex.bytes_uploaded = 0
        if d == 0 and n_pad2 == self.n_columns:
            ex._adopt_rows(self._rows(), self._rows_bundle.retain())
        else:
            delta = dict(
                z=ex._upload(z_rows),
                w=from_bits(ex._upload(_bits(w_rows))),
                tids=ex._upload(np.asarray(table_ids, np.int32)).to(torch.int64),
                cids=torch.arange(self.n_live, n_live2, device=self.device),
                ckeys=None if band_keys is None else ex._upload(_bits(band_keys)),
                coarse=None if coarse_keys is None else ex._upload(_bits(coarse_keys)))
            rows = {k: None if old is None else
                    _grown(old, self.n_live, delta[k], n_pad2, PAD_FILL[k])
                    for k, old in self._rows().items()}
            ex._adopt_rows(rows, PlacementBundle(dict(rows, zscale=ex._zscale)))
        ex._init_serving(self._events, warm=set(self._warm), seen=set(self._seen_shapes))
        return ex

    # -- warmup -------------------------------------------------------------

    def aot_compile(self, entries, *, n_columns: int | None = None) -> dict:
        """Warm every ``(plan, padded_batch)`` pair in ``entries``: run each
        pipeline unit once on sentinel queries (zero profiles, sentinel
        words, ``PAD_QUERY`` band keys), so every kernel library is loaded,
        every first-contact cost is paid, and the first real batch of a
        warmed shape is dispatched as warm with no compile attribution.

        ``n_columns`` warms for another corpus size, the background
        next-bucket warm ahead of a crossing: the units run on a stand-in
        successor of that size (this executor's rows, copied on the device
        and padded), which is closed afterwards; the warmed units land in
        this executor's table, which successors inherit.

        Publishes ``compile_begin``/``compile_end`` (``source="warmup"``) and
        ``executable_cache_miss`` (with a ``remaining`` countdown) per unit.
        Plans this corpus cannot serve count as skips. Returns a report."""
        if self._closed:
            raise RuntimeError("executor is closed")
        target = self
        if n_columns is not None and int(n_columns) != self.n_columns:
            target = self.extended(
                np.zeros((0, self._z.shape[1]), np.float32),
                np.zeros((0, self._w.shape[1]), np.uint32),
                table_ids=np.zeros((0,), np.int32),
                band_keys=(None if self._ckeys is None
                           else np.zeros((0, self._ckeys.shape[1]), np.uint32)),
                coarse_keys=(None if self._coarse is None
                             else np.zeros((0, self._coarse.shape[1]), np.uint32)),
                n_padded=int(n_columns))
        try:
            units, planned, skipped = {}, [], 0
            for plan, q in entries:
                key = target._unit(plan, int(q))
                if key is None:
                    skipped += 1
                    continue
                planned.append((plan, int(q)))
                units.setdefault(key, (plan, int(q)))
            report = {"n_plans": len(planned), "n_executables": len(units),
                      "skipped_plans": skipped, "cache_hits": 0, "cache_misses": 0,
                      "already_warm": 0, "compile_ms": 0.0}
            remaining = len(units)
            for key, (plan, q) in units.items():
                remaining -= 1
                if key in self._warm:
                    report["already_warm"] += 1
                    continue
                if self._events is not None:
                    self._events.publish("compile_begin", plan=key[0], grid=[],
                                         n_queries=q, k=0, source="warmup")
                t0 = time.perf_counter()
                target._warm_run(plan, q)
                ms = (time.perf_counter() - t0) * 1e3
                report["cache_misses"] += 1
                report["compile_ms"] += ms
                if self._events is not None:
                    self._events.publish("executable_cache_miss", name=key[0],
                                         n_queries=q, remaining=remaining)
                    self._events.publish("compile_end", plan=key[0], grid=[],
                                         n_queries=q, k=0, ms=ms, source="warmup")
                self._warm.add(key)
            for plan, q in planned:
                self._seen_shapes.add((plan.kind, plan.k, plan.budget, plan.grid, q))
        finally:
            if target is not self:
                target.close()
        return report

    def _unit(self, plan: QueryPlan, q: int):
        """Dispatch key of the pipeline ``plan`` runs at padded batch ``q``,
        or None when this corpus cannot serve the plan."""
        if self.n_live == 0 or q <= 0:
            return None
        if plan.candidates != "all" and self._ckeys is None:
            return None
        if plan.candidates == "tiered" and (plan.sharded or self._coarse is None):
            return None
        if plan.sharded:
            if self.mesh is None:
                return None
            qp = -(-q // plan.grid[0]) * plan.grid[0]
            return ("sharded", qp, self.n_columns, self._sharded_key(plan),
                    self._fp32_rows is not None)
        statics = self._local_spec(plan)
        name = {"all": "_local_all", "tiered": "_local_tiered"}.get(
            plan.candidates, "_local_pruned")
        if name == "_local_pruned":
            statics = dict(statics, kind=plan.candidates)
        return (name, int(q), self.n_columns, tuple(sorted(statics.items())),
                self._fp32_rows is not None)

    def _warm_run(self, plan: QueryPlan, q: int) -> None:
        """One execution of ``plan`` on ``q`` sentinel queries, with its
        results brought to the host as a served batch's are."""
        zq = np.zeros((q, self._z.shape[1]), np.float32)
        wq = np.full((q, self._w.shape[1]), FT.HASH_SENTINEL, np.uint32)
        none = np.full((q,), -1, np.int32)
        qkeys = (np.full((q, self._ckeys.shape[1]), PAD_QUERY, np.uint32)
                 if self._ckeys is not None else None)
        qcoarse = (np.full((q, self._coarse.shape[1]), PAD_QUERY, np.uint32)
                   if self._coarse is not None else None)
        self._run(plan, zq, wq, none, none, qkeys, qcoarse)

    def dispatch_stats(self) -> dict:
        """Warm vs first-contact dispatch counts: a warmed engine serving
        only ladder shapes shows zero fallbacks."""
        return dict(self._dispatch_stats)

    def last_compile_ms(self) -> float | None:
        """First-contact wall of this thread's most recent ``execute``, or
        None when the shape was already warm."""
        return getattr(self._tls, "compile_ms", None)

    # -- entry point --------------------------------------------------------

    def execute(self, plan: QueryPlan, zq, wq, tq, qid, qkeys=None, qcoarse=None):
        """Run ``plan`` for a query batch.

        ``zq`` (Q, F_NUM) float32, ``wq`` (Q, F_WORDS) uint32; ``tq`` (Q,)
        table ids to exclude (-1 disables); ``qid`` (Q,) global column id
        of resident queries (-1 for external); ``qkeys`` (Q, B) uint32 LSH
        band keys, required by pruned plans; ``qcoarse`` (Q, S) super-band
        digest keys, required by tiered plans. The calling thread's active
        :class:`~repro_torch.exec.tracing.Record`, if any, takes the stages'
        spans, their device intervals and the batch's counters. Returns numpy
        ``(scores (Q, k), ids (Q, k), n_scored (Q,))``.
        """
        if self._closed:
            raise RuntimeError("executor is closed (its snapshot version was "
                               "retired); pin a live version instead")
        q = int(np.asarray(zq).shape[0])
        self._tls.tier_stats = None
        self._tls.compile_ms = None
        if self.n_live == 0 or q == 0:
            return (np.full((q, plan.k), -np.inf, np.float32),
                    np.full((q, plan.k), -1, np.int32),
                    np.zeros((q,), np.int32))
        if plan.candidates != "all":
            if self._ckeys is None:
                raise ValueError(f"plan {plan.kind!r} needs LSH band keys, "
                                 f"but this executor has none")
            if qkeys is None:
                raise ValueError(f"plan {plan.kind!r} needs query band keys")
        if plan.candidates == "tiered":
            if plan.sharded:
                raise ValueError("tiered plans are local-only")
            if self._coarse is None:
                raise ValueError("plan 'tiered' needs a coarse super-band "
                                 "digest, but this executor has none")
            if qcoarse is None:
                raise ValueError("plan 'tiered' needs coarse query keys")
        if plan.sharded and self.mesh is None:
            raise ValueError(f"plan {plan.kind!r} needs a mesh")
        # first contact with this (kind, k, budget, grid, batch shape) is a
        # visible compile_begin/compile_end pair, its wall a thread-local
        # the engine folds into the request trace
        shape_key = (plan.kind, plan.k, plan.budget, plan.grid, q)
        first = shape_key not in self._seen_shapes
        self._seen_shapes.add(shape_key)
        self._dispatch_stats["aot" if self._unit(plan, q) in self._warm
                             else "fallback"] += 1
        if first and self._events is not None:
            self._events.publish("compile_begin", plan=plan.kind,
                                 grid=list(plan.grid), n_queries=q, k=plan.k)
        tr = tracing.current()
        t0 = time.perf_counter()
        sc, ids, n, tier = self._run(plan, zq, wq, tq, qid, qkeys, qcoarse, tr)
        if first:
            wall_ms = (time.perf_counter() - t0) * 1e3
            self._tls.compile_ms = wall_ms
            if self._events is not None:
                self._events.publish("compile_end", plan=plan.kind,
                                     grid=list(plan.grid), n_queries=q,
                                     k=plan.k, ms=wall_ms)
        self._tls.tier_stats = tier
        if tier is not None:
            tr.count("digest_hits", tier[0].sum())
            tr.count("survivors", tier[1].sum())
        if tier is not None and self._events is not None:
            n_hits, n_surv = tier
            self._events.publish(
                "coarse_pass", n_queries=q, n_columns=self.n_live,
                survivor_budget=plan.survivor_budget,
                hits_mean=float(n_hits.mean()),
                survivors_mean=float(n_surv.mean()),
                survivors_max=int(n_surv.max()),
                survivor_fraction=float(n_surv.mean()) / max(self.n_live, 1))
            self._events.publish(
                "fine_probe", n_queries=q, budget=plan.budget,
                survivor_budget=plan.survivor_budget, scored_mean=float(n.mean()))
        return sc, ids, n

    def _run(self, plan: QueryPlan, zq, wq, tq, qid, qkeys, qcoarse, tr=tracing.NULL):
        """The pipeline itself: numpy ``(scores, ids, n_scored, tier)``, with
        ``tier`` the tiered plan's (n_hits, n_survivors) or None. Every
        result is on the host when it returns. ``tr`` takes the stages:
        ``upload``, the plan's own, ``rerank`` over a quantized corpus, and
        ``download``, whose end, on the synchronized stream, anchors the
        device times."""
        dev = self.device
        local = not plan.sharded
        with tr.stage("upload", defer=True) as up:
            host = [torch.from_numpy(np.asarray(zq, np.float32)), _host_hashes(wq),
                    torch.from_numpy(np.asarray(tq, np.int64)),
                    torch.from_numpy(np.asarray(qid, np.int64))]
            if local and plan.candidates != "all":
                host.append(_host_hashes(qkeys))
            if local and plan.candidates == "tiered":
                host.append(_host_hashes(qcoarse))
            up.begin()
            zq, wq, tq, qid, *keys = [h.to(dev) for h in host]
            keys = [to_bits(k) for k in keys]
            tr.count("h2d_bytes", sum(h.nbytes for h in host))
        tier = hits = None
        if plan.sharded:
            with tr.stage("sharded"):
                sc, ids, n = self._run_sharded(plan, zq, wq, tq, qid, qkeys)
        elif plan.candidates == "all":
            sc, ids, n = self._local_all(zq, wq, tq, qid, **self._local_spec(plan), tr=tr)
        elif plan.candidates == "tiered":
            sc, ids, n, *tier = self._local_tiered(
                zq, wq, keys[0], keys[1], tq, qid, **self._local_spec(plan), tr=tr)
        else:
            sc, ids, n, hits = self._local_pruned(
                plan.candidates, zq, wq, keys[0], tq, qid, **self._local_spec(plan), tr=tr)
        if self._fp32_rows is not None:
            with tr.stage("rerank") as st:
                sc, ids = self._rescore(zq, wq, sc, ids, plan.k, st, tr)
        with tr.stage("download", anchor=True):
            out = [sc.cpu(), ids.to(torch.int32).cpu(), n.to(torch.int32).cpu()]
            if tier is not None:          # (n_hits, n_survivors), read after the scan
                out += [t.to(torch.int32).cpu() for t in tier]
            if hits is not None:
                out.append(hits.cpu())
            tr.count("d2h_bytes", sum(t.nbytes for t in out))
        if hits is not None:
            tr.count("prune_hits", out.pop())
        out = [t.numpy() for t in out]
        sc, ids = pad_topk(out[0], out[1], plan.k)
        return sc, ids, out[2], (tuple(out[3:]) if tier is not None else None)

    def last_tier_stats(self):
        """``(n_hits (Q,), n_survivors (Q,))`` of this thread's most recent
        ``execute`` if it ran a tiered plan, else None."""
        return getattr(self._tls, "tier_stats", None)

    def _local_spec(self, plan: QueryPlan) -> dict:
        """The k/budget clamps of the JAX executor's ``_local_spec``:
        quantized scans hand an over-fetched top set to the exact re-rank."""
        c = self.n_columns
        k = self._scan_k(plan)
        if plan.candidates == "all":
            return dict(k=min(k, c))
        budget = min(plan.budget, c)
        if plan.candidates == "tiered":
            surv = min(max(plan.survivor_budget, budget), c)
            return dict(k=min(k, budget, surv), budget=min(budget, surv),
                        survivor_budget=surv)
        return dict(k=min(k, budget), budget=budget)

    def _score(self, zq, wq, pos=None):
        """Scores against the resident corpus, or its rows at ``pos``."""
        if pos is None:
            return stages.score_columns(zq, wq, self._z, self._w, self._gbdt,
                                        self._zscale)
        return stages.score_columns(zq, wq, self._z[pos], self._w[pos],
                                    self._gbdt, self._zscale)

    def _local_all(self, zq, wq, tq, qid, k: int, tr=tracing.NULL):
        with tr.stage("score"):
            s = self._score(zq, wq)
        with tr.stage("mask"):
            s = torch.where(stages.exclusion_mask(self._cids, self._tids, tq, qid),
                            float("-inf"), s)
        with tr.stage("merge"):
            sc, ids = stages.merge_topk(s, self._cids, k)
            n = stages.live_count(self._cids).expand(zq.shape[0])
        return sc, ids, n

    def _local_pruned(self, kind, zq, wq, qkeys, tq, qid, k: int, budget: int,
                      tr=tracing.NULL):
        """The ``lsh``/``hybrid`` candidate stage over the whole lake, then the
        scorer over each query's ``budget`` candidates. Returns the top k,
        the scored counts and the budget slots an LSH hit filled (a 0-d
        tensor, read back with the results)."""
        with tr.stage("prune"):
            zf = dequantize(self._z, self._zscale)
            prio = stages.candidate_priorities(kind, zq, qkeys, zf, self._ckeys,
                                               self._cids, self._tids, tq, qid,
                                               stage=tr.stage)
            with tr.stage("select"):
                pval, pos = stages.topk_stable(prio, budget)
                valid = torch.isfinite(pval)
                hits = stages.budget_hits(kind, pval)
        with tr.stage("score"):
            s = torch.where(valid, self._score(zq, wq, pos), float("-inf"))
        with tr.stage("merge"):
            sc, ids = stages.merge_topk(s, self._cids[pos], k)
            n = valid.sum(1)
        return sc, ids, n, hits

    def _local_tiered(self, zq, wq, qkeys, qcoarse, tq, qid, k: int, budget: int,
                      survivor_budget: int, tr=tracing.NULL):
        """Coarse digest scan over the whole lake, then the fine probe, the
        proxy and the scorer over the gathered survivors only. The proxy
        over the (dequantized) resident sidecar fills survivor slots the
        digest left empty with profile-nearest columns."""
        with tr.stage("coarse"):
            with tr.stage("fill"):
                zf = dequantize(self._z, self._zscale)
                # -||zq - z||² up to a per-query constant: 2·zq@zᵀ - ||z||²
                fill = (2.0 * zq) @ zf.T - (zf * zf).sum(1)[None]
            pos, valid, n_hits, n_surv = stages.tiered_survivors(
                qcoarse, self._coarse, self._cids, self._tids, tq, qid,
                survivor_budget=survivor_budget, block_c=self.survivor_block, proxy=fill,
                stage=tr.stage)
        with tr.stage("fine"):
            # the fine probe reads the survivors' band keys in place through pos
            prio = stages.tiered_priorities(zq, qkeys, dequantize(self._z[pos], self._zscale),
                                            self._ckeys, valid, pos=pos)
            pos2, valid2 = stages.gather_candidates(prio, budget)
            gpos = torch.gather(pos, 1, pos2)                 # (Q, M) lake columns
        with tr.stage("score"):
            s = torch.where(valid2, self._score(zq, wq, gpos), float("-inf"))
        with tr.stage("merge"):
            sc, ids = stages.merge_topk(s, self._cids[gpos], k)
            n = valid2.sum(1)
        return sc, ids, n, n_hits, n_surv

    # -- sharded plans ------------------------------------------------------

    def _grid_mesh(self, grid: tuple):
        """(q, d) -> a (query × data × model) mesh over this executor's
        devices, cached per geometry; the flat device order is kept."""
        from repro_torch.launch.mesh import make_grid_mesh
        grid = tuple(grid)
        if grid not in self._grid_meshes:
            self._grid_meshes[grid] = make_grid_mesh(grid[0], grid[1],
                                                     devices=self.mesh.devices)
        return self._grid_meshes[grid]

    def _plan_mesh_axes(self, plan: QueryPlan):
        """Mesh + (shard_axes, query_axes) a plan executes with: (1, d) grids
        keep the caller's mesh and replicated queries (multi-axis
        ``shard_axes`` included); q > 1 grids, or a caller mesh that already
        has a non-trivial ``query`` axis, run on the re-shaped grid mesh."""
        premade_q = ("query" in self.mesh.axis_names
                     and int(self.mesh.shape["query"]) > 1)
        if plan.grid[0] == 1 and not premade_q:
            return self.mesh, tuple(plan.shard_axes), ()
        return self._grid_mesh(plan.grid), ("data",), ("query",)

    def _scan_k(self, plan: QueryPlan) -> int:
        """The k a scan returns: quantized scans over-fetch for the exact
        re-rank, sharded ones as local ones do."""
        return plan.k if self._fp32_rows is None else max(plan.k, RESCORE_MULT * plan.k)

    def _sharded_key(self, plan: QueryPlan) -> tuple:
        """Identity of a sharded pipeline: (kind, scan k, budget per shard,
        data axes, grid when the query axis is sharded)."""
        _, axes, qaxes = self._plan_mesh_axes(plan)
        return (plan.candidates, self._scan_k(plan),
                plan.budget_per_shard if plan.candidates != "all" else 0,
                axes, plan.grid if qaxes else ())

    def _corpus(self, plan: QueryPlan) -> dict:
        """The sharded placement ``plan`` reads: one per (mesh geometry, data
        axes), band keys included whenever the executor has them, so an
        ``all`` plan and a pruned plan share their shards."""
        mesh, axes, qaxes = self._plan_mesh_axes(plan)
        key = (plan.grid if qaxes else (), axes)
        if key not in self._placed:
            rows = dict(z=dequantize(self._z, self._zscale), w=self._w,
                        cids=self._cids, tids=self._tids, ckeys=self._ckeys)
            placed = place_sharded_corpus(mesh, axes, rows, qaxes)
            devices = {dev for _, dev in placed["shards"]}
            placed["gbdt"] = {dev: tuple(t.to(dev) if isinstance(t, torch.Tensor) else t
                                         for t in self._gbdt) for dev in devices}
            self._placed[key] = placed
        return self._placed[key]

    def _pipeline(self, plan: QueryPlan):
        key = self._sharded_key(plan)
        if key not in self._pipelines:
            mesh, axes, qaxes = self._plan_mesh_axes(plan)
            self._pipelines[key] = build_sharded_pipeline(
                mesh, candidates=plan.candidates, k=self._scan_k(plan),
                budget_per_shard=(plan.budget_per_shard
                                  if plan.candidates != "all" else None),
                shard_axes=axes, query_axes=qaxes)
        return self._pipelines[key]

    def _run_sharded(self, plan: QueryPlan, zq, wq, tq, qid, qkeys):
        """The grid pipeline on the batch padded to a multiple of q_shards
        (the repeated last row carries its own masks), sliced back."""
        q = zq.shape[0]
        qp = -(-q // plan.grid[0]) * plan.grid[0]
        idx = torch.clamp(torch.arange(qp, device=self.device), max=q - 1)
        keys = (None if qkeys is None else
                to_bits(hashes_to_torch(qkeys, self.device))[idx])
        corpus = self._corpus(plan)
        sc, ids, n = self._pipeline(plan)(corpus, corpus["gbdt"], zq[idx], wq[idx],
                                          tq[idx], qid[idx], keys, out=self.device)
        return sc[:q], ids[:q], n[:q]

    def _rescore(self, zq, wq, sc, ids, k: int, stage, tr):
        """Gather the scan's (Q, R) candidates' float32 rows from the host
        source and re-rank them exactly with the fused kernel. R is a small
        multiple of k, so the cost does not grow with the lake. The host
        round trip is ``stage``'s ``roundtrip`` child, outside its device
        time: the wait for the scan's ids (the batch's first synchronization),
        their download, the host gather of their float32 rows and the upload."""
        with stage.host("roundtrip"):
            ids_h = ids.cpu().numpy()
            # clip to live rows, not the padded corpus: the float32 source may be
            # an unpadded view (-1 -> row 0, already masked by the scan's -inf)
            safe = np.clip(ids_h, 0, self.n_live - 1)
            rows = torch.from_numpy(np.asarray(self._fp32_rows(safe), np.float32))
            pos = torch.from_numpy(safe)
            zg, pos_d = rows.to(self.device), pos.to(self.device)
        wg = self._w[pos_d]
        tr.count("d2h_bytes", ids_h.nbytes)
        tr.count("h2d_bytes", rows.nbytes + pos.nbytes)
        tr.count("rerank_rows", ids_h.size)
        return _rescore_exact(zq, wq, zg, wg, self._gbdt, sc, ids, k)


def _host_hashes(a) -> torch.Tensor:
    """uint32 hashes or keys -> an int64 host tensor (``hashes_to_torch``'s
    host half)."""
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _bits(a) -> np.ndarray:
    """uint32 hashes or keys -> their int32 bit-view (4 bytes each on the
    link; widened or kept as bit-views on the device)."""
    return np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32)


def _live_ids(n_live: int, n: int, device) -> torch.Tensor:
    """Column ids 0..n_live-1, then -1 on the pad rows."""
    ids = torch.arange(n, device=device)
    return torch.where(ids < n_live, ids, -1)


def _grown(old: torch.Tensor, n_live: int, rows: torch.Tensor, n: int, fill):
    """A new (n, ...) tensor: ``old``'s live prefix copied on the device, then
    ``rows``, then ``fill``. ``old`` itself is never written."""
    out = torch.full((n,) + tuple(old.shape[1:]), fill, dtype=old.dtype, device=old.device)
    out[:n_live] = old[:n_live]
    out[n_live:n_live + rows.shape[0]] = rows.to(old.dtype)
    return out

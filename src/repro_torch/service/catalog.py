"""Persistent on-disk column catalog — the serving-grade lake index.

The port of ``repro.service.catalog``. **The on-disk format is shared**:
the segment ``.npy`` files, ``meta.json``, the ``MANIFEST-{v:08d}.json``
chain and the lease file are byte for byte the JAX package's, so a catalog
written by either package opens in the other. Profiling and MinHash
signing (``profile_and_sign``, ``add_table``/``add_batch`` and the
compaction re-sign) run on the store's device (``CatalogStore(device=)``,
default the card) through the port's kernels; everything else is numpy
and file I/O, copied from the JAX package.

The paper's point is that a column's footprint in the index is a few KB of
profile; this module makes that index *durable, incremental and
multi-writer* so a lake can grow (or shrink) under concurrent ingest
without reprofiling:

* :class:`CatalogStore` — the writer half. Every ``add_table`` profiles
  the new columns on-device, MinHashes their values, and writes one
  immutable **delta segment** (plain ``.npy`` files + a JSON sidecar); the
  manifest advance is a **compare-and-swap** on a chain of immutable
  per-version manifest files, so several ingest workers append delta
  segments concurrently — a lost race re-reads the head and retries
  (rewriting only the tid-dependent sidecar files, never re-profiling);
* ``drop_table`` is a manifest tombstone (O(1));
* ``compact()`` merges the segments live at a **pinned** version into one
  and CAS-publishes the swap — segments appended by concurrent writers
  after the pin are retained via manifest replay, and an advisory
  :class:`WriterLease` keeps compactors mutually exclusive.  Passing
  ``n_perm=`` / ``minhash_seed=`` **re-signs** every live column from the
  per-segment value sketches (``values.npy``) so the LSH geometry can be
  retuned without re-ingesting the lake; ``retain_versions=N`` defers
  deletion of replaced segments until the head passes the swap by N
  versions, keeping the last N manifest versions materializable for
  pinned/lagging followers;
* :class:`CatalogReader` — the follower half: tails the manifest chain
  (``poll()`` — a single ``os.stat`` of the pointer hint when nothing
  changed) and materializes immutable :class:`CatalogSnapshot`\\ s
  keyed by version, so read replicas observe every version in order and
  queries can pin one version for their whole pipeline;
* **lazy snapshots** (``snapshot(lazy=True)``) keep the segment arrays as
  read-only ``np.memmap`` views instead of copying them, and recover the
  lake-wide z-score stats from per-segment **moments** stored in each
  segment's ``meta.json`` — opening a compacted million-column catalog is
  O(manifest), not O(lake), and resident memory grows only with the bytes
  a query actually touches.  POSIX unlink semantics keep a pinned lazy
  snapshot valid across a concurrent compaction that deletes its segment
  files: the mapping holds the data alive until the last reader drops it.

Layout::

    <root>/MANIFEST.json            # pointer to the newest version (hint)
    <root>/MANIFEST-00000007.json   # immutable per-version manifests (CAS)
    <root>/LEASE.json               # advisory writer lease (compaction)
    <root>/seg-00000001-3fa9c1/{numeric,words,n_rows,sigs,table_ids}.npy
    <root>/seg-00000001-3fa9c1/values.npy  # folded value hashes (re-sign src)
    <root>/seg-00000001-3fa9c1/meta.json   # column names, table name -> id

The CAS primitive is ``os.link`` of a fully-written temp file onto
``MANIFEST-{v+1}`` — creation fails atomically if another writer already
published that version.  ``MANIFEST.json`` is a best-effort pointer
updated after each publish; readers resolve the true head by probing the
chain forward from it, so a stale pointer costs a few extra ``stat``\\ s,
never a wrong answer.  A crash mid-``add_table`` leaves at worst an
orphaned segment directory that no manifest references.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Iterable, Sequence

import numpy as np

import torch

from repro_torch.core import features as FT
from repro_torch.core.ingest import ColumnBatch, ingest_string_columns
from repro_torch.core.profiles import LakeProfiles, compute_profiles_batch
from repro_torch.device import hashes_to_numpy, hashes_to_torch, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.minhash import make_permutations

MANIFEST = "MANIFEST.json"
LEASE = "LEASE.json"
_PROFILE_PAD_C = 8     # pad column counts as the JAX package does
CHUNK_COLUMNS = 16384   # columns profiled and signed per device step


def profile_and_sign(batch: ColumnBatch, n_perm: int, seed: int,
                     pad_c: int = _PROFILE_PAD_C, *, device=None,
                     chunk: int = CHUNK_COLUMNS):
    """Profile + MinHash a batch on ``device`` -> (numeric, words, sigs) numpy.

    Columns are padded to a multiple of ``pad_c`` and rows to the next
    power of two (at least 16) with sentinel cells, exactly as the JAX
    package pads them, so signatures and profiles agree with it bit for bit
    (words, signatures) or to float32 rounding (numeric). The batch is
    walked ``chunk`` columns at a time, so a 100k-column lake fits.
    """
    dev = resolve_device(device)
    c, r = batch.values32.shape
    cp = -(-c // pad_c) * pad_c
    rp = max(1 << (max(r, 1) - 1).bit_length(), 16)
    a_np, b_np = make_permutations(n_perm, seed)
    a, b = hashes_to_torch(a_np, dev), hashes_to_torch(b_np, dev)
    chunk = max(pad_c, chunk // pad_c * pad_c)
    nums, words, sigs = [], [], []
    for lo in range(0, cp, chunk):
        hi = min(lo + chunk, cp)
        n_real = max(0, min(hi, c) - lo)
        v = np.full((hi - lo, rp), FT.HASH_SENTINEL, np.uint32)
        cl = np.zeros((hi - lo, rp), np.float32)
        wc = np.zeros((hi - lo, rp), np.float32)
        nr = np.zeros((hi - lo,), np.int32)
        v[:n_real, :r] = batch.values32[lo:lo + n_real]
        cl[:n_real, :r] = batch.char_len[lo:lo + n_real]
        wc[:n_real, :r] = batch.word_cnt[lo:lo + n_real]
        nr[:n_real] = batch.n_rows[lo:lo + n_real]
        vt = hashes_to_torch(v, dev)
        num, wd = compute_profiles_batch(vt, torch.from_numpy(cl).to(dev),
                                         torch.from_numpy(wc).to(dev),
                                         torch.from_numpy(nr).to(dev))
        sg = ops.minhash(vt, a, b)
        nums.append(num[:n_real].cpu().numpy())
        words.append(hashes_to_numpy(wd[:n_real]))
        sigs.append(hashes_to_numpy(sg[:n_real]))
    if not nums:
        return (np.zeros((0, FT.F_NUM), np.float32),
                np.zeros((0, FT.F_WORDS), np.uint32),
                np.zeros((0, n_perm), np.uint32))
    return (np.concatenate(nums).astype(np.float32), np.concatenate(words),
            np.concatenate(sigs))


def _slice_batch(batch: ColumnBatch, idx: np.ndarray) -> ColumnBatch:
    return ColumnBatch(
        values32=batch.values32[idx], char_len=batch.char_len[idx],
        word_cnt=batch.word_cnt[idx], n_rows=batch.n_rows[idx],
        names=[batch.names[i] for i in idx],
        table_ids=batch.table_ids[idx])


@dataclasses.dataclass
class CatalogSnapshot:
    """Materialized live view of the catalog at one manifest version.

    Immutable once built.  Eager snapshots copy every array off the
    segment mmaps; **lazy** snapshots (``lazy=True``) keep the read-only
    memmap views and recover the z-score stats from stored per-segment
    moments — O(manifest) open cost.  Both isolate a pinned query
    pipeline from every concurrent add / drop / compaction, including
    segment deletion after a swap: a copy trivially, a memmap because
    POSIX unlink leaves the mapped bytes readable until the mapping is
    dropped.
    """

    profiles: LakeProfiles          # zscored lazily via lake-wide mean/std
    signatures: np.ndarray          # (C, P) uint32 MinHash signatures
    table_ids: np.ndarray           # (C,) int32
    names: list[str]                # column names
    table_names: dict[int, str]     # table id -> name
    version: int                    # manifest version (engine cache epoch)
    minhash_seed: int = 0           # permutation seed for external queries
    lazy: bool = False              # arrays are segment memmaps, not copies

    @property
    def n_columns(self) -> int:
        return int(self.signatures.shape[0])


# ---------------------------------------------------------------------------
# manifest chain I/O (shared by store and reader)
# ---------------------------------------------------------------------------

def _manifest_name(version: int) -> str:
    return f"MANIFEST-{int(version):08d}.json"


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def read_manifest_version(root: str, version: int) -> dict | None:
    """The immutable manifest at ``version`` (pointer fallback for catalogs
    written before the CAS chain existed)."""
    m = _read_json(os.path.join(root, _manifest_name(version)))
    if m is None:
        ptr = _read_json(os.path.join(root, MANIFEST))
        if ptr is not None and int(ptr["version"]) == int(version):
            return ptr
    return m


def read_latest_manifest(root: str) -> dict | None:
    """Resolve the head of the manifest chain: start from the pointer hint
    and probe forward until the next version is missing."""
    m = _read_json(os.path.join(root, MANIFEST))
    v = int(m["version"]) if m is not None else -1
    while True:
        nxt = _read_json(os.path.join(root, _manifest_name(v + 1)))
        if nxt is None:
            return m
        m, v = nxt, v + 1


def _empty_arrays(n_perm: int) -> dict[str, np.ndarray]:
    return {"numeric": np.zeros((0, FT.F_NUM), np.float32),
            "words": np.zeros((0, FT.F_WORDS), np.uint32),
            "n_rows": np.zeros((0,), np.int32),
            "sigs": np.zeros((0, n_perm), np.uint32),
            "table_ids": np.zeros((0,), np.int32)}


def _load_segment(root: str, seg: str) -> dict:
    seg_dir = os.path.join(root, seg)
    out = {k: np.load(os.path.join(seg_dir, f"{k}.npy"), mmap_mode="r")
           for k in ("numeric", "words", "n_rows", "sigs", "table_ids")}
    vpath = os.path.join(seg_dir, "values.npy")
    if os.path.exists(vpath):    # absent in pre-maintenance segments
        out["values"] = np.load(vpath, mmap_mode="r")
        mpath = os.path.join(seg_dir, "values_valid.npy")
        if os.path.exists(mpath):
            out["values_valid"] = np.load(mpath, mmap_mode="r")
    with open(os.path.join(seg_dir, "meta.json")) as f:
        meta = json.load(f)
    out["names"] = meta["names"]
    out["tables"] = meta["tables"]
    out["moments"] = meta.get("moments")   # absent in pre-lazy segments
    return out


def _numeric_moments(numeric: np.ndarray) -> dict:
    """Per-segment z-score moments stored in ``meta.json`` so a lazy open
    recovers the lake-wide mean/std without reading the profile bytes."""
    x = np.asarray(numeric, np.float64)
    return {"count": int(x.shape[0]),
            "sum": x.sum(axis=0).tolist() if x.shape[0] else
            [0.0] * x.shape[1],
            "sumsq": (x * x).sum(axis=0).tolist() if x.shape[0] else
            [0.0] * x.shape[1]}


def _stats_from_moments(moments: Iterable[dict]):
    """Combine per-segment moments -> lake-wide (mean, std)."""
    n = 0
    s = np.zeros((FT.F_NUM,), np.float64)
    s2 = np.zeros((FT.F_NUM,), np.float64)
    for m in moments:
        n += int(m["count"])
        s += np.asarray(m["sum"], np.float64)
        s2 += np.asarray(m["sumsq"], np.float64)
    if n == 0:
        return (np.zeros((FT.F_NUM,), np.float32),
                np.ones((FT.F_NUM,), np.float32))
    mean = s / n
    var = np.maximum(s2 / n - mean * mean, 0.0)
    std = np.sqrt(var)
    std = np.where(std < 1e-6, 1.0, std)
    return mean.astype(np.float32), std.astype(np.float32)


def manifest_delta(old_m: dict | None, new_m: dict | None) -> list[str] | None:
    """Appended segments when ``new_m`` is a pure append-only advance of
    ``old_m``, else None.

    Append-only means: same MinHash geometry, the *identical* tombstone
    list (not merely both empty — equal drops filter the shared prefix
    identically), and ``old_m``'s segment list a prefix of ``new_m``'s.
    Under those conditions :func:`materialize_snapshot` concatenates
    segments in manifest order with the same per-segment filtering, so
    the new snapshot's first ``old.n_columns`` rows are byte-identical
    to the old snapshot's — the contract the engine's delta-refresh path
    (``EngineConfig.incremental``) builds on.  Drops, compactions and
    re-signs all return None → full rebuild."""
    if old_m is None or new_m is None:
        return None
    if (int(old_m["n_perm"]) != int(new_m["n_perm"])
            or int(old_m["minhash_seed"]) != int(new_m["minhash_seed"])):
        return None
    if list(old_m.get("dropped_ids", ())) != \
            list(new_m.get("dropped_ids", ())):
        return None
    old_segs = list(old_m.get("segments", ()))
    new_segs = list(new_m.get("segments", ()))
    if new_segs[:len(old_segs)] != old_segs:
        return None
    return new_segs[len(old_segs):]


def moments_from_stats(mean: np.ndarray, std: np.ndarray,
                       count: int) -> dict:
    """Reconstruct accumulated float64 moments from (mean, std, count) —
    the inverse of :func:`_stats_from_moments` (up to the <1e-6 std
    clamp).  Lets a freshly built engine state seed its moment
    accumulator without an O(lake) pass over the profile bytes."""
    m = np.asarray(mean, np.float64)
    s = np.asarray(std, np.float64)
    n = int(count)
    return {"count": n, "sum": m * n, "sumsq": (s * s + m * m) * n}


def fold_moments(acc: dict, delta: dict) -> dict:
    """Accumulate ``delta``'s float64 moments into a copy of ``acc`` —
    the O(delta) stats update an incremental refresh performs."""
    return {"count": int(acc["count"]) + int(delta["count"]),
            "sum": np.asarray(acc["sum"], np.float64)
            + np.asarray(delta["sum"], np.float64),
            "sumsq": np.asarray(acc["sumsq"], np.float64)
            + np.asarray(delta["sumsq"], np.float64)}


def materialize_snapshot(root: str, manifest: dict, *,
                         lazy: bool = False) -> CatalogSnapshot:
    """Materialize the live columns of ``manifest`` into an immutable
    :class:`CatalogSnapshot` (segment arrays are read with ``mmap_mode`` so
    this touches only the bytes it concatenates).

    ``lazy=True`` requests the zero-copy fast path: when the manifest is a
    single segment with no pending tombstones and stored moments (the
    steady state after a compaction), the snapshot keeps the read-only
    memmaps and the combined moments — no profile byte is read at open.
    A manifest that still needs filtering or concatenation falls back to
    the eager copy (``snapshot.lazy`` reports which path was taken)."""
    dropped = set(manifest["dropped_ids"])
    parts = [_load_segment(root, s) for s in manifest["segments"]]

    if (lazy and len(parts) == 1 and not dropped
            and parts[0]["moments"] is not None):
        part = parts[0]
        mean, std = _stats_from_moments([part["moments"]])
        profiles = LakeProfiles(numeric=part["numeric"],
                                words=part["words"],
                                n_rows=part["n_rows"],
                                mean=mean, std=std)
        return CatalogSnapshot(
            profiles=profiles, signatures=part["sigs"],
            table_ids=part["table_ids"], names=list(part["names"]),
            table_names={i: t for t, i in part["tables"].items()},
            version=int(manifest["version"]),
            minhash_seed=int(manifest["minhash_seed"]), lazy=True)
    acc = {k: [] for k in ("numeric", "words", "n_rows", "sigs",
                           "table_ids")}
    names: list[str] = []
    table_names: dict[int, str] = {}
    for part in parts:
        keep = ~np.isin(part["table_ids"], list(dropped))
        for k in acc:
            acc[k].append(part[k][keep])
        names.extend([n for n, ok in zip(part["names"], keep) if ok])
        table_names.update({i: t for t, i in part["tables"].items()
                            if i not in dropped})

    empty = _empty_arrays(int(manifest["n_perm"]))
    cat = {k: (np.concatenate(v) if v else empty[k])    # copies off mmap
           for k, v in acc.items()}
    numeric = cat["numeric"].astype(np.float32)
    c = numeric.shape[0]
    mean = numeric.mean(axis=0) if c else np.zeros((FT.F_NUM,), np.float32)
    std = numeric.std(axis=0) if c else np.ones((FT.F_NUM,), np.float32)
    std = np.where(std < 1e-6, 1.0, std).astype(np.float32)
    profiles = LakeProfiles(numeric=numeric, words=cat["words"],
                            n_rows=cat["n_rows"],
                            mean=mean.astype(np.float32), std=std)
    return CatalogSnapshot(profiles=profiles, signatures=cat["sigs"],
                           table_ids=cat["table_ids"], names=names,
                           table_names=table_names,
                           version=int(manifest["version"]),
                           minhash_seed=int(manifest["minhash_seed"]))


# spare-capacity factor for extended-snapshot buffers: each append-only
# advance writes its new rows into the previous buffer's tail when room
# remains, so steady-state snapshot materialization copies only the
# delta; the O(lake) copy recurs only on capacity growth (amortized)
_SNAP_GROWTH = 1.5


def extend_snapshot(root: str, prev: CatalogSnapshot, prev_manifest: dict,
                    manifest: dict) -> CatalogSnapshot | None:
    """Delta-materialize ``manifest`` by appending its new segments onto
    an already-materialized predecessor snapshot — O(delta) disk reads
    and (steady-state) O(delta) host copies, instead of re-reading and
    re-concatenating every live segment.

    Returns ``None`` when the advance is not append-only per
    :func:`manifest_delta` (drops, compactions, geometry changes) — those
    take the full :func:`materialize_snapshot` path.

    The arrays of the returned snapshot are views over capacity buffers
    carrying ``_SNAP_GROWTH`` headroom (stashed on the snapshot as
    ``_capacity``).  Writing a successor's rows into a predecessor's
    spare tail never mutates any published view: every view is bounded
    by its own version's column count, and concurrent extensions of the
    same predecessor write byte-identical rows (the bytes are a pure
    function of the on-disk segments), so the race is benign.  Z-score
    stats are recomputed over the concatenated matrix with the same
    reduction as the eager path, keeping the result bit-identical to a
    fresh materialization."""
    new_segs = manifest_delta(prev_manifest, manifest)
    if new_segs is None:
        return None
    version = int(manifest["version"])
    caps_in = getattr(prev, "_capacity", {})
    if not new_segs:
        snap = dataclasses.replace(prev, version=version)
        snap._capacity = caps_in
        return snap
    dropped = set(manifest["dropped_ids"])
    acc: dict[str, list] = {k: [] for k in ("numeric", "words", "n_rows",
                                            "sigs", "table_ids")}
    names = list(prev.names)
    table_names = dict(prev.table_names)
    for seg in new_segs:
        part = _load_segment(root, seg)
        keep = ~np.isin(part["table_ids"], list(dropped))
        for k in acc:
            acc[k].append(part[k][keep])
        names.extend([n for n, ok in zip(part["names"], keep) if ok])
        table_names.update({i: t for t, i in part["tables"].items()
                            if i not in dropped})

    caps_out: dict[str, np.ndarray] = {}

    def ext(key: str, prev_arr: np.ndarray, dtype=None) -> np.ndarray:
        parts = [np.asarray(p, dtype) if dtype is not None else np.asarray(p)
                 for p in acc[key]]
        c0 = int(prev_arr.shape[0])
        c1 = c0 + sum(int(p.shape[0]) for p in parts)
        cap = caps_in.get(key)
        if cap is None or cap.shape[0] < c1 \
                or not np.shares_memory(cap[:c0], prev_arr):
            tail = prev_arr.shape[1:]
            cap = np.empty((max(int(c1 * _SNAP_GROWTH), c1),) + tail,
                           parts[0].dtype if dtype is None and parts
                           else (dtype or prev_arr.dtype))
            cap[:c0] = prev_arr
        o = c0
        for p in parts:
            cap[o:o + p.shape[0]] = p
            o += p.shape[0]
        caps_out[key] = cap
        return cap[:c1]

    prof = prev.profiles
    numeric = ext("numeric", np.asarray(prof.numeric), np.float32)
    c = numeric.shape[0]
    mean = numeric.mean(axis=0) if c else np.zeros((FT.F_NUM,), np.float32)
    std = numeric.std(axis=0) if c else np.ones((FT.F_NUM,), np.float32)
    std = np.where(std < 1e-6, 1.0, std).astype(np.float32)
    profiles = LakeProfiles(numeric=numeric,
                            words=ext("words", np.asarray(prof.words)),
                            n_rows=ext("n_rows", np.asarray(prof.n_rows)),
                            mean=mean.astype(np.float32), std=std)
    snap = CatalogSnapshot(profiles=profiles,
                           signatures=ext("sigs",
                                          np.asarray(prev.signatures)),
                           table_ids=ext("table_ids",
                                         np.asarray(prev.table_ids)),
                           names=names, table_names=table_names,
                           version=version,
                           minhash_seed=int(manifest["minhash_seed"]))
    snap._capacity = caps_out
    return snap


# ---------------------------------------------------------------------------
# writer lease
# ---------------------------------------------------------------------------

class LeaseHeldError(RuntimeError):
    """Another writer holds a live lease over this catalog."""


class WriterLease:
    """Advisory time-bounded lease over a catalog root.

    Used to keep compactors mutually exclusive (delta appends need no lease
    — the manifest CAS already serializes them).  Acquisition atomically
    creates ``LEASE.json``; an expired lease is stolen via atomic replace
    and the steal verified by re-reading the token.  The lease is advisory:
    it bounds concurrent *compaction work*, while manifest correctness is
    always guaranteed by the CAS chain alone.
    """

    def __init__(self, root: str, *, owner: str | None = None,
                 ttl_s: float = 60.0, clock=time.time):
        self.root = root
        self.owner = owner or f"pid-{os.getpid()}"
        self.ttl_s = float(ttl_s)
        # injectable wall clock: expiry tests advance a fake clock past
        # the ttl instead of sleeping (or hacking negative ttls).  Every
        # participant judging the same lease must share the clock
        self._clock = clock
        self.token = os.urandom(8).hex()
        self._held = False

    @property
    def path(self) -> str:
        return os.path.join(self.root, LEASE)

    def _read(self) -> dict | None:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _write_tmp(self) -> str:
        rec = {"owner": self.owner, "token": self.token,
               "expires": self._clock() + self.ttl_s}
        tmp = os.path.join(self.root, f".lease-{self.token}.tmp")
        with open(tmp, "w") as f:
            json.dump(rec, f)
        return tmp

    def acquire(self) -> "WriterLease":
        tmp = self._write_tmp()
        try:
            os.link(tmp, self.path)
            self._held = True
            return self
        except FileExistsError:
            pass
        finally:
            os.unlink(tmp)
        cur = self._read()
        now = self._clock()
        if (cur is not None and cur.get("token") != self.token
                and float(cur.get("expires", 0)) > now):
            raise LeaseHeldError(
                f"catalog lease held by {cur.get('owner')!r} for another "
                f"{float(cur['expires']) - now:.1f}s")
        # expired (or unreadable) lease: unlink the record we judged
        # expired iff it is still the one on disk, then race a fresh
        # create-if-absent — exactly one stealer's link succeeds (a blind
        # replace would let every stealer pass its own verification)
        cur2 = self._read()
        if (cur is not None and cur2 is not None
                and cur2.get("token") == cur.get("token")):
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
        tmp = self._write_tmp()
        try:
            os.link(tmp, self.path)
        except FileExistsError:
            raise LeaseHeldError("lost the race stealing an expired lease")
        finally:
            os.unlink(tmp)
        self._held = True
        return self

    def renew(self) -> None:
        if not self._held:
            raise RuntimeError("cannot renew a lease that is not held")
        tmp = self._write_tmp()
        os.replace(tmp, self.path)

    def release(self) -> None:
        if not self._held:
            return
        self._held = False
        cur = self._read()
        if cur is not None and cur.get("token") == self.token:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass

    def __enter__(self) -> "WriterLease":
        if not self._held:
            self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# ---------------------------------------------------------------------------
# store (writer half)
# ---------------------------------------------------------------------------

class CatalogStore:
    """Open (or create) the catalog rooted at ``root``.

    Safe for several concurrent writers (threads or processes, each with
    its own store handle): every mutation is a CAS loop over the manifest
    chain.  ``self.manifest`` is this handle's last-confirmed view of the
    head; reads that must be fresh go through :meth:`_refresh`.
    """

    def __init__(self, root: str, *, n_perm: int = 128, minhash_seed: int = 0,
                 events=None, device=None):
        # the device that profiles and signs this handle's ingest
        self.device = resolve_device(device)
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._mlock = threading.Lock()
        # optional event sink (any object with .publish(type, **payload),
        # e.g. service.events.EventBus): every successful CAS advance
        # publishes manifest_advanced
        self.events = events
        self.stats = {"cas_retries": 0, "publishes": 0, "compactions": 0}
        m = read_latest_manifest(root)
        if m is None:
            m = {
                "version": 0, "n_perm": int(n_perm),
                "minhash_seed": int(minhash_seed),
                "next_table_id": 0, "next_segment": 1,
                "segments": [], "tables": {}, "dropped_ids": [],
            }
            if not self._publish(m):        # lost the creation race
                m = read_latest_manifest(root)
        else:
            self._ensure_chain(m)
        self._set_manifest(m)

    # -- properties ---------------------------------------------------------

    @property
    def n_perm(self) -> int:
        return int(self.manifest["n_perm"])

    @property
    def version(self) -> int:
        return int(self.manifest["version"])

    def tables(self) -> dict[str, int]:
        return dict(self._refresh()["tables"])

    # -- manifest chain -----------------------------------------------------

    def _set_manifest(self, m: dict) -> None:
        with self._mlock:
            if (not hasattr(self, "manifest")
                    or int(m["version"]) >= self.version):
                self.manifest = m

    def _refresh(self) -> dict:
        m = read_latest_manifest(self.root)
        self._set_manifest(m)
        return m

    def _publish(self, m: dict) -> bool:
        """CAS-advance the chain to ``m['version']``.  False = lost race."""
        final = os.path.join(self.root, _manifest_name(m["version"]))
        tmp = os.path.join(self.root,
                           f".manifest-{os.urandom(6).hex()}.tmp")
        with open(tmp, "w") as f:
            json.dump(m, f, indent=1)
        try:
            os.link(tmp, final)             # atomic create-if-absent
        except FileExistsError:
            return False
        finally:
            os.unlink(tmp)
        self.stats["publishes"] += 1
        self._update_pointer(m)
        if self.events is not None:
            self.events.publish("manifest_advanced",
                                version=int(m["version"]),
                                n_segments=len(m.get("segments", ())),
                                follower=False)
        return True

    def _update_pointer(self, m: dict) -> None:
        """Best-effort MANIFEST.json hint (readers probe forward from it)."""
        ptr = os.path.join(self.root, MANIFEST)
        cur = _read_json(ptr)
        if cur is not None and int(cur["version"]) >= int(m["version"]):
            return
        tmp = ptr + f".{os.urandom(4).hex()}.tmp"
        with open(tmp, "w") as f:
            json.dump(m, f, indent=1)
        os.replace(tmp, ptr)                # atomic on POSIX

    def _ensure_chain(self, m: dict) -> None:
        """Backfill the chain file for a pre-CAS catalog's head version."""
        final = os.path.join(self.root, _manifest_name(m["version"]))
        if os.path.exists(final):
            return
        tmp = os.path.join(self.root,
                           f".manifest-{os.urandom(6).hex()}.tmp")
        with open(tmp, "w") as f:
            json.dump(m, f, indent=1)
        try:
            os.link(tmp, final)
        except FileExistsError:
            pass
        finally:
            os.unlink(tmp)

    # -- mutation -----------------------------------------------------------

    def add_table(self, name: str,
                  columns: Sequence[tuple[str, Iterable[str | None]]] | None = None,
                  *, batch: ColumnBatch | None = None,
                  row_budget: int | None = None) -> int:
        """Register a table from raw string columns (``columns``) or an
        already-packed ``ColumnBatch``. Writes one delta segment and
        CAS-publishes the manifest advance; a lost race retries against the
        new head, re-signing only if the LSH geometry changed underneath us
        and rewriting only the tid-dependent sidecar files. Returns the
        assigned table id."""
        if (columns is None) == (batch is None):
            raise ValueError("pass exactly one of columns= or batch=")
        if batch is None:
            batch, _ = ingest_string_columns(columns, row_budget=row_budget)
        if batch.n_columns == 0:
            raise ValueError(f"table {name!r} has no columns")

        signed: dict[tuple[int, int], tuple] = {}   # geometry -> arrays
        seg = seg_dir = None
        seg_tid = seg_geom = None
        try:
            while True:
                m = copy.deepcopy(self._refresh())
                if name in m["tables"]:
                    raise ValueError(f"table {name!r} already in catalog")
                geom = (int(m["n_perm"]), int(m["minhash_seed"]))
                if geom not in signed:
                    signed[geom] = profile_and_sign(batch, *geom,
                                                    device=self.device)
                numeric, words, sigs = signed[geom]
                tid = int(m["next_table_id"])
                if seg is None:
                    seg = (f"seg-{int(m['next_segment']):08d}-"
                           f"{os.urandom(3).hex()}")
                    seg_dir = os.path.join(self.root, seg)
                    self._write_segment(
                        seg_dir, batch, numeric, words, sigs,
                        np.full((batch.n_columns,), tid, np.int32),
                        {name: tid})
                    seg_tid, seg_geom = tid, geom
                else:
                    if geom != seg_geom:    # concurrent re-sign compaction
                        np.save(os.path.join(seg_dir, "sigs.npy"), sigs)
                        seg_geom = geom
                    if tid != seg_tid:      # another writer took our tid
                        np.save(os.path.join(seg_dir, "table_ids.npy"),
                                np.full((batch.n_columns,), tid, np.int32))
                        with open(os.path.join(seg_dir, "meta.json"),
                                  "w") as f:
                            json.dump({"names": list(batch.names),
                                       "tables": {name: tid},
                                       "moments":
                                           _numeric_moments(numeric)}, f)
                        seg_tid = tid

                m["tables"][name] = tid
                m["next_table_id"] = tid + 1
                m["next_segment"] = int(m["next_segment"]) + 1
                m["segments"].append(seg)
                m["version"] = int(m["version"]) + 1
                if self._publish(m):
                    self._set_manifest(m)
                    return tid
                self.stats["cas_retries"] += 1
        except BaseException:
            if seg_dir is not None:         # never leak an orphan segment
                shutil.rmtree(seg_dir, ignore_errors=True)
            raise

    @staticmethod
    def _write_segment(seg_dir: str, batch: ColumnBatch, numeric, words,
                       sigs, table_ids: np.ndarray,
                       tables: dict[str, int]) -> None:
        os.makedirs(seg_dir, exist_ok=True)
        np.save(os.path.join(seg_dir, "numeric.npy"), numeric)
        np.save(os.path.join(seg_dir, "words.npy"), words)
        np.save(os.path.join(seg_dir, "n_rows.npy"),
                batch.n_rows.astype(np.int32))
        np.save(os.path.join(seg_dir, "sigs.npy"), sigs)
        # the re-sign source for signature maintenance at compact()
        np.save(os.path.join(seg_dir, "values.npy"), batch.values32)
        np.save(os.path.join(seg_dir, "table_ids.npy"),
                np.asarray(table_ids, np.int32))
        with open(os.path.join(seg_dir, "meta.json"), "w") as f:
            json.dump({"names": list(batch.names), "tables": tables,
                       "moments": _numeric_moments(numeric)}, f)

    def add_batch(self, batch: ColumnBatch,
                  table_names: Sequence[str], *,
                  profile_chunk: int = 8192) -> dict[str, int]:
        """Bulk-register many tables from one packed batch as **one**
        delta segment (the segment format already carries per-column
        table ids and a multi-table name map).

        ``batch.table_ids`` hold *local* ids indexing ``table_names``;
        they are remapped onto catalog-assigned ids at publish time.
        This is the scale ingest path: a 10^5-column synthetic lake lands
        in one segment + one manifest CAS instead of one of each per
        table — and leaves the catalog in the single-segment steady state
        the lazy snapshot fast path wants.  Profiling/MinHashing runs in
        ``profile_chunk``-column slices to bound device memory.  Returns
        ``{table name: assigned id}``."""
        if batch.n_columns == 0:
            raise ValueError("batch has no columns")
        local = np.asarray(batch.table_ids, np.int64)
        if local.min() < 0 or local.max() >= len(table_names):
            raise ValueError(
                f"batch table_ids must index table_names "
                f"(0..{len(table_names) - 1}); got range "
                f"[{int(local.min())}, {int(local.max())}]")
        if len(set(table_names)) != len(table_names):
            raise ValueError("duplicate names in table_names")

        def _sign(geom):
            outs = ([], [], [])
            for i in range(0, batch.n_columns, profile_chunk):
                idx = np.arange(i, min(i + profile_chunk, batch.n_columns))
                for acc, arr in zip(outs, profile_and_sign(
                        _slice_batch(batch, idx), *geom, device=self.device)):
                    acc.append(arr)
            return tuple(np.concatenate(a) for a in outs)

        signed: dict[tuple[int, int], tuple] = {}
        seg = seg_dir = None
        seg_base = seg_geom = None
        try:
            while True:
                m = copy.deepcopy(self._refresh())
                taken = [t for t in table_names if t in m["tables"]]
                if taken:
                    raise ValueError(f"table(s) {taken!r} already in "
                                     f"catalog")
                geom = (int(m["n_perm"]), int(m["minhash_seed"]))
                if geom not in signed:
                    signed[geom] = _sign(geom)
                numeric, words, sigs = signed[geom]
                base = int(m["next_table_id"])
                tids = (base + local).astype(np.int32)
                tables = {t: base + i for i, t in enumerate(table_names)}
                if seg is None:
                    seg = (f"seg-{int(m['next_segment']):08d}-"
                           f"{os.urandom(3).hex()}")
                    seg_dir = os.path.join(self.root, seg)
                    self._write_segment(seg_dir, batch, numeric, words,
                                        sigs, tids, tables)
                    seg_base, seg_geom = base, geom
                else:
                    if geom != seg_geom:
                        np.save(os.path.join(seg_dir, "sigs.npy"), sigs)
                        seg_geom = geom
                    if base != seg_base:
                        np.save(os.path.join(seg_dir, "table_ids.npy"),
                                tids)
                        with open(os.path.join(seg_dir, "meta.json"),
                                  "w") as f:
                            json.dump({"names": list(batch.names),
                                       "tables": tables,
                                       "moments":
                                           _numeric_moments(numeric)}, f)
                        seg_base = base
                m["tables"].update(tables)
                m["next_table_id"] = base + len(table_names)
                m["next_segment"] = int(m["next_segment"]) + 1
                m["segments"].append(seg)
                m["version"] = int(m["version"]) + 1
                if self._publish(m):
                    self._set_manifest(m)
                    return tables
                self.stats["cas_retries"] += 1
        except BaseException:
            if seg_dir is not None:
                shutil.rmtree(seg_dir, ignore_errors=True)
            raise

    def drop_table(self, name: str) -> None:
        """Tombstone a table; its columns disappear from snapshots and its
        bytes are reclaimed at the next ``compact()``."""
        while True:
            m = copy.deepcopy(self._refresh())
            if name not in m["tables"]:
                raise KeyError(f"table {name!r} not in catalog")
            tid = m["tables"].pop(name)
            m["dropped_ids"].append(int(tid))
            m["version"] = int(m["version"]) + 1
            if self._publish(m):
                self._set_manifest(m)
                return
            self.stats["cas_retries"] += 1

    # -- compaction ---------------------------------------------------------

    def compact(self, *, n_perm: int | None = None,
                minhash_seed: int | None = None,
                resign_chunk: int = 256,
                lease_ttl_s: float = 60.0,
                retain_versions: int = 0,
                on_built=None) -> None:
        """Merge the segments live at a pinned version into one; drop
        tombstoned columns; CAS-publish the swap; delete the replaced
        segment directories.

        ``retain_versions=N`` keeps replaced segments on disk until the
        manifest head has advanced ``N`` versions past the swap that
        retired them (tracked via the manifest's ``retired`` list, GC'd
        by later compactions), so the last ``N`` manifest versions stay
        **materializable** — a pinned historical ``reader.snapshot(v)``
        or a lagging follower inside the window never hits a deleted
        segment.  The default ``0`` deletes immediately (and purges any
        window left by earlier compactions); already-materialized
        snapshots are plain numpy copies and outlive deletion either way.

        Runs under the advisory :class:`WriterLease` (raises
        :class:`LeaseHeldError` if another compactor holds it).  Concurrent
        ``add_table`` / ``drop_table`` are safe: segments appended after
        the pin are **retained via manifest replay** at publish time, and
        tombstones laid after the pin stay tombstoned.  ``on_built`` (a
        zero-arg callable) fires after the compacted segment is built and
        before the publish — the hook concurrency tests synchronize on.

        Signature maintenance: passing ``n_perm`` and/or ``minhash_seed``
        re-MinHashes every live column from the stored per-segment value
        sketches (``values.npy``, in column chunks of ``resign_chunk``) and
        updates the manifest, so snapshots after the compaction carry the
        new signature geometry.  A re-sign cannot replay concurrent adds
        (their segments carry old-geometry signatures), so it restarts from
        the new head instead.  Segments written before value storage
        existed cannot be re-signed and raise ``ValueError``.
        """
        lease = WriterLease(self.root, ttl_s=lease_ttl_s).acquire()
        try:
            while True:
                pinned = copy.deepcopy(self._refresh())
                built = self._build_compacted(pinned, n_perm, minhash_seed,
                                              resign_chunk,
                                              renew=lease.renew)
                lease.renew()           # a long build must not outlive ttl
                if on_built is not None:
                    on_built()
                nm, due = self._publish_compacted(pinned, built,
                                                  retain_versions)
                if nm is not None:
                    self._set_manifest(nm)
                    self.stats["compactions"] += 1
                    for s in due:
                        shutil.rmtree(os.path.join(self.root, s),
                                      ignore_errors=True)
                    return
                # unpublishable build (re-sign raced a concurrent write, or
                # another compactor swapped our inputs out): rebuild from
                # the head
                shutil.rmtree(os.path.join(self.root, built["seg"]),
                              ignore_errors=True)
        finally:
            lease.release()

    def _build_compacted(self, pinned: dict, n_perm, minhash_seed,
                         resign_chunk: int, renew=None) -> dict:
        """Merge ``pinned``'s live segments into one new on-disk segment.

        ``renew`` (zero-arg, optional) is called once per merged segment
        and once per re-sign chunk, so a build longer than the lease ttl
        keeps its mutual exclusion."""
        cur_seed = int(pinned["minhash_seed"])
        cur_perm = int(pinned["n_perm"])
        new_perm = cur_perm if n_perm is None else int(n_perm)
        new_seed = cur_seed if minhash_seed is None else int(minhash_seed)
        resign = new_perm != cur_perm or new_seed != cur_seed

        parts = [_load_segment(self.root, s) for s in pinned["segments"]]
        dropped = set(pinned["dropped_ids"])
        old_segs = list(pinned["segments"])

        # segments written before value storage (or carrying columns merged
        # from such segments) cannot be re-signed; their rows are tracked by
        # a validity mask so a plain compact() never discards the re-sign
        # source of the segments that DO have one
        def _part_valid(part, keep):
            if "values" not in part:
                return np.zeros((int(keep.sum()),), bool)
            if "values_valid" in part:
                return np.asarray(part["values_valid"])[keep]
            return np.ones((int(keep.sum()),), bool)

        keeps = [~np.isin(p["table_ids"], list(dropped)) for p in parts]
        if resign:
            legacy = [s for s, p, keep in zip(old_segs, parts, keeps)
                      if not _part_valid(p, keep).all()]
            if legacy:
                raise ValueError(
                    f"cannot change n_perm/minhash_seed: segment(s) "
                    f"{legacy} predate value storage (no complete "
                    f"values.npy); re-ingest those tables to enable "
                    f"signature maintenance")

        merged = {k: [] for k in ("numeric", "words", "n_rows", "sigs",
                                  "table_ids")}
        values_parts: list[np.ndarray] = []
        valid_parts: list[np.ndarray] = []
        names: list[str] = []
        tables: dict[str, int] = {}
        for part, keep in zip(parts, keeps):
            if renew is not None:
                renew()
            for k in merged:
                merged[k].append(part[k][keep])
            if "values" in part:
                values_parts.append(np.asarray(part["values"][keep]))
            else:
                values_parts.append(
                    np.full((int(keep.sum()), 1), FT.HASH_SENTINEL,
                            np.uint32))
            valid_parts.append(_part_valid(part, keep))
            names.extend([n for n, ok in zip(part["names"], keep) if ok])
            tables.update({t: i for t, i in part["tables"].items()
                           if i not in dropped})

        cat = {k: (np.concatenate(v) if v else
                   _empty_arrays(cur_perm)[k]) for k, v in merged.items()}
        budget = max((v.shape[1] for v in values_parts), default=1)
        values_parts = [
            np.pad(v, ((0, 0), (0, budget - v.shape[1])),
                   constant_values=FT.HASH_SENTINEL)
            for v in values_parts]
        values = (np.concatenate(values_parts) if values_parts else
                  np.full((0, 1), FT.HASH_SENTINEL, np.uint32))
        values_valid = (np.concatenate(valid_parts) if valid_parts else
                        np.zeros((0,), bool))
        if resign:
            cat["sigs"] = self._resign(values, new_perm, new_seed,
                                       chunk=resign_chunk, renew=renew,
                                       device=self.device)

        seg = (f"seg-{int(pinned['next_segment']):08d}-"
               f"{os.urandom(3).hex()}")
        seg_dir = os.path.join(self.root, seg)
        os.makedirs(seg_dir, exist_ok=True)
        for k, arr in cat.items():
            np.save(os.path.join(seg_dir, f"{k}.npy"), arr)
        np.save(os.path.join(seg_dir, "values.npy"), values)
        if not values_valid.all():         # all-True is implied when absent
            np.save(os.path.join(seg_dir, "values_valid.npy"), values_valid)
        with open(os.path.join(seg_dir, "meta.json"), "w") as f:
            json.dump({"names": names, "tables": tables,
                       "moments": _numeric_moments(cat["numeric"])}, f)

        return {"seg": seg, "replaced": old_segs,
                "applied_drops": set(pinned["dropped_ids"]),
                "n_perm": new_perm, "minhash_seed": new_seed,
                "resign": resign}

    def _publish_compacted(self, pinned: dict, built: dict,
                           retain_versions: int = 0):
        """CAS-publish the compaction swap, replaying concurrent writes.

        Returns ``(manifest, due_segments)`` — the published manifest plus
        the retired segments now past the ``retain_versions`` window (the
        caller deletes those, and only those) — or ``(None, None)`` when a
        re-sign must restart (its new geometry cannot absorb
        concurrently-added segments)."""
        replaced = set(built["replaced"])
        retain = max(int(retain_versions), 0)
        while True:
            cur = read_latest_manifest(self.root)
            live = set(cur["segments"])
            new_segs = [s for s in cur["segments"] if s not in replaced]
            geom_moved = (int(cur["n_perm"]), int(cur["minhash_seed"])) != \
                (int(pinned["n_perm"]), int(pinned["minhash_seed"]))
            # a segment we merged is gone from the head: another compactor
            # already swapped it out — publishing would serve every one of
            # its columns twice (once in ours, once in theirs). Restart.
            if geom_moved or (built["resign"] and new_segs) or \
                    not replaced <= live:
                return None, None
            v_new = int(cur["version"]) + 1
            # retirement window: a segment replaced by the publish at
            # version v stays on disk until the head passes v + retain,
            # so the last `retain` manifest versions stay materializable
            retired = [[int(v), s] for v, s in cur.get("retired", [])]
            retired += [[v_new, s] for s in built["replaced"]]
            due = [s for v, s in retired if v <= v_new - retain]
            nm = {
                "version": v_new,
                "n_perm": built["n_perm"],
                "minhash_seed": built["minhash_seed"],
                "next_table_id": int(cur["next_table_id"]),
                "next_segment": int(cur["next_segment"]) + 1,
                "segments": [built["seg"]] + new_segs,
                "tables": dict(cur["tables"]),
                # tombstones laid after the pin survive the swap; the ones
                # the compacted segment already applied are cleared
                "dropped_ids": [d for d in cur["dropped_ids"]
                                if d not in built["applied_drops"]],
                "retired": [[v, s] for v, s in retired
                            if v > v_new - retain],
            }
            if self._publish(nm):
                return nm, due
            self.stats["cas_retries"] += 1

    @staticmethod
    def _resign(values: np.ndarray, n_perm: int, seed: int,
                chunk: int = 256, renew=None, *, device=None) -> np.ndarray:
        """Re-MinHash stored value sketches -> (C, n_perm) signatures, on
        ``device`` through ``ops.minhash``."""
        c = values.shape[0]
        if c == 0:
            return np.zeros((0, n_perm), np.uint32)
        dev = resolve_device(device)
        a_np, b_np = make_permutations(n_perm, seed)
        a, b = hashes_to_torch(a_np, dev), hashes_to_torch(b_np, dev)
        out = []
        for i in range(0, c, chunk):
            if renew is not None:
                renew()
            v = hashes_to_torch(np.ascontiguousarray(values[i:i + chunk]), dev)
            out.append(hashes_to_numpy(ops.minhash(v, a, b)))
        return np.concatenate(out)

    # -- reads --------------------------------------------------------------

    def snapshot(self, *, lazy: bool = False) -> CatalogSnapshot:
        """Materialize the current head (writers see their own writes).
        ``lazy=True`` requests the zero-copy memmap fast path (see
        :func:`materialize_snapshot`)."""
        return materialize_snapshot(self.root, self._refresh(), lazy=lazy)


# Back-compat alias: the pre-MVCC single-writer class name.
ColumnCatalog = CatalogStore


# ---------------------------------------------------------------------------
# reader (follower half)
# ---------------------------------------------------------------------------

class CatalogReader:
    """Read-only follower over a catalog root.

    Tails the manifest chain (:meth:`poll`) and serves immutable
    :class:`CatalogSnapshot`\\ s keyed by version, caching the most
    recently materialized ones.  A follower observes **every** published
    version in order — it never skips from v to v+2 without reporting v+1
    — which is what the replication tests assert.

    Old versions stay materializable only until a compaction deletes their
    segments; snapshots already materialized (cached or held by an engine)
    remain valid forever — eager ones are plain numpy copies, lazy ones
    hold open memmaps whose bytes POSIX unlink cannot reclaim while the
    mapping lives.
    """

    def __init__(self, root: str, *, max_cached_snapshots: int = 4,
                 deep_poll_every: int = 128, events=None,
                 lazy: bool = False):
        self.root = root
        # default materialization mode for snapshot(); lazy=True serves
        # zero-copy memmap snapshots whenever the manifest allows it
        self.lazy = bool(lazy)
        # optional event sink; DiscoveryEngine.follow() injects its bus
        # here so follower-observed manifest_advanced events (follower=
        # True) land on the serving engine's stream
        self.events = events
        # stat the pointer BEFORE resolving the head: a publish landing in
        # between moves the pointer afterwards, so the next poll goes deep
        self._ptr_stat = self._stat_pointer()
        m = read_latest_manifest(root)
        if m is None:
            raise FileNotFoundError(f"no catalog manifest under {root!r}")
        self._max_cached = int(max_cached_snapshots)
        self._deep_every = max(int(deep_poll_every), 1)
        self._manifests: dict[int, dict] = {int(m["version"]): m}
        self._version = int(m["version"])
        self._snaps: "dict[tuple[int, bool], CatalogSnapshot]" = {}
        self._lock = threading.Lock()
        self.stats = {"polls": 0, "fast_polls": 0, "deep_polls": 0}

    @property
    def version(self) -> int:
        """Latest version this follower has observed."""
        return self._version

    def _stat_pointer(self):
        try:
            s = os.stat(os.path.join(self.root, MANIFEST))
        except FileNotFoundError:
            return None
        return (s.st_mtime_ns, s.st_ino, s.st_size)

    def poll(self) -> list[int]:
        """Probe the chain forward; returns newly observed versions in
        order (empty when the head has not moved).

        Fast path: every publish rewrites the ``MANIFEST.json`` pointer
        hint (``os.replace`` — new inode, new mtime), so an unchanged
        pointer stat means nothing moved and the poll is a **single
        ``os.stat``** — no JSON read/parse per probe.  The pointer is
        best-effort (a writer could crash between the chain CAS and the
        pointer rewrite), so every ``deep_poll_every``-th poll probes the
        chain regardless; correctness never depends on the hint."""
        new: list[int] = []
        with self._lock:
            self.stats["polls"] += 1
            st = self._stat_pointer()
            if (st is not None and st == self._ptr_stat
                    and self.stats["polls"] % self._deep_every != 0):
                self.stats["fast_polls"] += 1
                return []
            self.stats["deep_polls"] += 1
            # cache the PRE-probe stat: a publish racing the probe below
            # either lands in it, or moves the pointer after this stat
            # and the next poll goes deep again
            self._ptr_stat = st
            v = self._version
            while True:
                m = read_manifest_version(self.root, v + 1)
                if m is None:
                    break
                v += 1
                self._manifests[v] = m
                new.append(v)
            self._version = v
            # keep a bounded manifest tail
            for old in sorted(self._manifests):
                if len(self._manifests) <= 64:
                    break
                del self._manifests[old]
        if self.events is not None:       # publish outside the poll lock
            for v_ in new:
                self.events.publish("manifest_advanced", version=v_,
                                    follower=True)
        return new

    def manifest(self, version: int | None = None) -> dict:
        if version is None:
            version = self._version
        version = int(version)
        m = self._manifests.get(version) or \
            read_manifest_version(self.root, version)
        if m is None:
            raise KeyError(f"catalog version {version} not found under "
                           f"{self.root!r}")
        return m

    def snapshot(self, version: int | None = None, *,
                 lazy: bool | None = None) -> CatalogSnapshot:
        """Immutable snapshot at ``version`` (default: latest, after an
        implicit :meth:`poll`).  ``lazy`` overrides the reader's default
        materialization mode for this call.

        The latest-snapshot path is race-proof against compaction: if a
        swap publishes and deletes our target's segments between the poll
        and the materialize, the reader re-polls and retries at the new
        head (the deletion itself proves a newer version exists).  An
        *explicitly* pinned historical version whose segments were
        compacted away raises ``KeyError`` instead — the caller asked for
        that version, not whatever is newest."""
        lazy = self.lazy if lazy is None else bool(lazy)
        if version is not None:
            try:
                return self._snapshot_at(int(version), lazy)
            except FileNotFoundError as e:
                raise KeyError(
                    f"catalog version {int(version)} is no longer "
                    f"materializable (its segments were compacted away); "
                    f"only snapshots materialized before the swap remain "
                    f"valid") from e
        self.poll()
        while True:
            head = self._version
            try:
                return self._snapshot_at(head, lazy)
            except FileNotFoundError:
                if not self.poll():     # head did not move: a real error
                    raise

    def _snapshot_at(self, version: int, lazy: bool) -> CatalogSnapshot:
        key = (version, lazy)
        with self._lock:
            if key in self._snaps:
                return self._snaps[key]
            # newest cached predecessor: an append-only advance extends it
            # with only the new segments (O(delta)) instead of re-reading
            # the lake.  A multi-segment lazy request already falls back
            # to the eager copy, so extension never loses lazy behavior.
            prev_key = max((k for k in self._snaps if k[0] < version),
                           default=None)
            prev = self._snaps.get(prev_key)
        snap = None
        if prev is not None:
            try:
                snap = extend_snapshot(self.root, prev,
                                       self.manifest(prev_key[0]),
                                       self.manifest(version))
            except KeyError:      # predecessor manifest aged out of the tail
                snap = None
        if snap is None:
            snap = materialize_snapshot(self.root, self.manifest(version),
                                        lazy=lazy)
        with self._lock:
            self._snaps[key] = snap
            while len(self._snaps) > self._max_cached:
                del self._snaps[min(self._snaps)]
        return snap


def add_lake(catalog: CatalogStore, lake, prefix: str = "table") -> list[int]:
    """Ingest every table of a ``core.lakegen`` synthetic lake (one delta
    segment per table — exercising the incremental path at scale)."""
    tids = []
    for t in np.unique(lake.batch.table_ids):
        idx = np.flatnonzero(lake.batch.table_ids == t)
        sub = _slice_batch(lake.batch, idx)
        tids.append(catalog.add_table(f"{prefix}{int(t)}", batch=sub))
    return tids

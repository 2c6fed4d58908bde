"""Background compaction for the catalog store.

Compaction is the only catalog operation whose cost grows with the lake,
so it must never block ingest or queries.  :class:`BackgroundCompactor`
runs :meth:`~repro.service.catalog.CatalogStore.compact` on a single
worker thread: the compacted segment is built against a **pinned**
manifest version, concurrent ``add_table`` / ``drop_table`` proceed
normally (their delta segments are retained via manifest replay at
publish time), and readers keep serving whichever snapshot they pinned —
the swap is one CAS manifest advance, never a torn read.

Typical serving-loop wiring::

    store = CatalogStore(root)
    with BackgroundCompactor(store, min_segments=16) as compactor:
        for batch in ingest_stream:
            store.add_table(...)
            compactor.maybe_compact()     # non-blocking; coalesces
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor

from repro_torch.service.catalog import CatalogStore


class BackgroundCompactor:
    """Off-thread, coalescing driver for ``store.compact()``.

    At most one compaction is in flight; :meth:`submit` while one runs
    returns the in-flight future instead of queueing another (compacting a
    head the running swap is about to replace would be wasted work).
    """

    def __init__(self, store: CatalogStore, *, min_segments: int = 8,
                 events=None):
        self.store = store
        self.min_segments = int(min_segments)
        # event sink: explicit, else the store's (so compaction lifecycle
        # events land on the same stream as its manifest advances)
        self.events = events if events is not None \
            else getattr(store, "events", None)
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="freyja-compact")
        self._lock = threading.Lock()
        self._inflight: Future | None = None
        self._closed = False

    # -- scheduling ---------------------------------------------------------

    def submit(self, **compact_kw) -> Future:
        """Schedule one compaction; returns its future (or the in-flight
        one — submissions during a running compaction coalesce)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("compactor is closed")
            if self._inflight is not None and not self._inflight.done():
                return self._inflight
            self._inflight = self._pool.submit(
                self._run_compaction, compact_kw)
            return self._inflight

    def _run_compaction(self, compact_kw: dict):
        """Worker-thread body: the store's compact() bracketed by
        lifecycle events (compaction_published carries the new head
        version; a no-op or lost-race compact publishes started only)."""
        if self.events is not None:
            self.events.publish("compaction_started",
                                version=self.store.version)
        out = self.store.compact(**compact_kw)
        if self.events is not None:
            self.events.publish("compaction_published",
                                version=self.store.version)
        return out

    def maybe_compact(self, min_segments: int | None = None,
                      **compact_kw) -> Future | None:
        """Trigger a compaction iff the live segment count reached the
        threshold; None when below it (the common, free case)."""
        threshold = self.min_segments if min_segments is None \
            else int(min_segments)
        # count segments at the refreshed head, not this handle's last view:
        # deltas appended through OTHER writer handles must trigger too
        if len(self.store._refresh()["segments"]) < threshold:
            return None
        return self.submit(**compact_kw)

    # -- lifecycle ----------------------------------------------------------

    @property
    def busy(self) -> bool:
        with self._lock:
            return self._inflight is not None and not self._inflight.done()

    def wait(self, timeout: float | None = None) -> None:
        """Block until the in-flight compaction (if any) finishes,
        re-raising its exception."""
        with self._lock:
            fut = self._inflight
        if fut is not None:
            fut.result(timeout=timeout)

    def close(self, wait: bool = True) -> None:
        with self._lock:
            self._closed = True
        self._pool.shutdown(wait=wait)

    def __enter__(self) -> "BackgroundCompactor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

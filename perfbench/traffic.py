"""The one traffic generator: it reads a mix's parameters and drives the
scheduler with them.

A mix is a data file ``perfbench/traffic/<name>.json``::

    {"arrivals": "closed", "in_flight": 256, "queries": "resident_uniform"}
    {"arrivals": "poisson", "rate_qps": 4000.0, "queries": "resident_uniform"}

Its ``arrivals`` and ``queries`` name kinds, each a module of its own that
the harness finds by the name: ``perfbench/arrivals/<kind>.py`` (``validate``
and ``drive``, which sends on :func:`closed_loop` or, from a schedule of due
times, on :func:`open_loop`) and ``perfbench/queries/<kind>.py``
(``validate``, ``columns``: the seed's requested columns, and ``request``).
A new kind is a new module; a new mix of known kinds is a new data file.

Every request is timed from its due time, so a generator that runs late
counts its lateness into the latency, and the lateness is reported. The
window is a fixed time. Requests that are outstanding when it closes are
awaited (up to ``GRACE_S`` past the close); one that never comes is
unanswered. What a response says is copied into flat arrays as it arrives
and the response is dropped, so the harness holds no growing heap of Python
objects for the collector to walk during the window.

This is a repaired copy of the port's ``service/loadgen.run_open_loop``,
which stamps latency at submit, reports no lateness and counts its window in
arrivals.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict

import numpy as np

GRACE_S = 60.0
# a request the scheduler refused by its admission rules, not one the
# program failed to answer
REFUSALS = ("SchedulerOverloadError", "DeadlineExpired")
MAX_QPS = 100_000          # a closed loop's record capacity a second


class Mix:
    """A mix's parameters and the modules of its two kinds."""

    def __init__(self, params: dict, arrivals, queries):
        self.params, self.arrivals, self.queries = params, arrivals, queries
        arrivals.validate(params)
        queries.validate(params)


class Client:
    """What an arrival kind drives: the scheduler, the window's length and
    the query kind's requests, drawn from the seed."""

    def __init__(self, mix: Mix, scheduler, n_columns: int, seed: int, seconds: float,
                 k: int):
        self.mix, self.scheduler, self.n_columns = mix, scheduler, n_columns
        self.seed, self.seconds, self.k = seed, seconds, k

    def columns(self, n: int) -> np.ndarray:
        return self.mix.queries.columns(self.mix.params, self.seed, self.n_columns, n)

    def submit(self, i: int, column_id: int):
        return self.scheduler.submit(self.mix.queries.request(f"r{i}", int(column_id)))


class Log:
    """Every request of a window, one row each: the column asked, when it
    was due, sent and settled, and what its response said (its top-k ids
    and scores, its queue wait); the responses' trace spans summed by
    phase."""

    PENDING, ANSWERED, FAILED = 0, 1, 2

    def __init__(self, columns: np.ndarray, k: int):
        n = len(columns)
        self.column_id = np.asarray(columns, np.int64)
        self.t_due = np.full(n, np.nan)
        self.t_sent = np.full(n, np.nan)
        self.t_done = np.full(n, np.nan)
        self.state = np.zeros(n, np.int8)
        self.misdelivered = np.zeros(n, bool)
        self.broken = np.zeros(n, bool)      # failed with an error not a refusal
        self.queue_ms = np.full(n, np.nan)
        self.ids = np.full((n, k), -1, np.int64)
        self.scores = np.full((n, k), -np.inf, np.float32)
        self.span_ms: dict[str, float] = defaultdict(float)
        self.errors: list[str] = []
        self.n = 0                     # rows in use
        self.k = k
        self._lock = threading.Lock()

    def settle(self, i: int, fut) -> None:
        """Copy request ``i``'s outcome out of its future."""
        t = time.perf_counter()
        try:
            r = fut.result()
        except Exception as e:  # noqa: BLE001 - a failed request is recorded, not raised
            self.fail(i, e, t)
            return
        m = r.matches[:self.k]
        self.ids[i, :len(m)] = [x.column_id for x in m]
        self.scores[i, :len(m)] = [x.score for x in m]
        self.queue_ms[i] = r.queue_ms
        self.misdelivered[i] = r.name != f"r{i}"
        with self._lock:
            for s in r.trace:
                self.span_ms[s["phase"]] += s["ms"]
        self.t_done[i] = t
        self.state[i] = self.ANSWERED

    def fail(self, i: int, exc: Exception, t: float) -> None:
        self.broken[i] = type(exc).__name__ not in REFUSALS
        with self._lock:
            if len(self.errors) < 20:
                self.errors.append(repr(exc))
        self.t_done[i] = t
        self.state[i] = self.FAILED

    def trim(self) -> "Log":
        """Drop the unused rows of a closed loop's capacity."""
        for name in ("column_id", "t_due", "t_sent", "t_done", "state", "misdelivered",
                     "broken", "queue_ms", "ids", "scores"):
            setattr(self, name, getattr(self, name)[:self.n])
        return self

    @property
    def answered(self) -> np.ndarray:
        return self.state == self.ANSWERED

    def latency_ms(self) -> np.ndarray:
        """Due time to response; infinite where no answer came."""
        return np.where(self.answered, (self.t_done - self.t_due) * 1e3, np.inf)


class Window:
    def __init__(self, log: Log, t_start: float, t_stop: float, t_end: float):
        self.log, self.t_start, self.t_stop, self.t_end = log, t_start, t_stop, t_end

    @property
    def seconds(self) -> float:
        return self.t_stop - self.t_start

    @property
    def lateness_ms(self) -> np.ndarray:
        sent = self.log.t_sent
        return ((sent - self.log.t_due) * 1e3)[np.isfinite(sent)]


def run(mix: Mix, scheduler, n_columns: int, seed: int, seconds: float, k: int) -> Window:
    """Drive ``scheduler`` with ``mix`` for ``seconds``; ``k`` answers of
    each request are kept."""
    return mix.arrivals.drive(mix.params, Client(mix, scheduler, n_columns, seed, seconds, k))


def closed_loop(in_flight: int, client: Client) -> Window:
    """Keep ``in_flight`` requests outstanding until the window closes."""
    seconds = client.seconds
    cap = in_flight + int(seconds * MAX_QPS)
    log = Log(client.columns(cap), client.k)
    lock = threading.Condition()
    outstanding = [0]
    stop = [float("inf")]

    def send() -> None:
        with lock:
            i = log.n
            if i >= cap:
                return
            log.n += 1
            outstanding[0] += 1
        log.t_due[i] = log.t_sent[i] = time.perf_counter()
        try:
            fut = client.submit(i, log.column_id[i])
        except Exception as e:  # noqa: BLE001 - a refused request is a failure
            log.fail(i, e, time.perf_counter())
            done()
            return
        fut.add_done_callback(lambda f, i=i: answered(i, f))

    def done() -> None:
        with lock:
            outstanding[0] -= 1
            lock.notify_all()

    def answered(i: int, fut) -> None:
        log.settle(i, fut)
        if log.t_done[i] < stop[0]:
            send()
        done()

    t_start = time.perf_counter()
    stop[0] = t_start + seconds
    for _ in range(in_flight):
        send()
    time.sleep(max(0.0, stop[0] - time.perf_counter()))
    with lock:
        lock.wait_for(lambda: outstanding[0] == 0, timeout=GRACE_S + seconds)
    return Window(log.trim(), t_start, stop[0], time.perf_counter())


def open_loop(due: np.ndarray, client: Client) -> Window:
    """Send one request at each due offset (s) from one generator thread."""
    seconds = client.seconds
    log = Log(client.columns(len(due)), client.k)
    log.n = len(due)
    futures = [None] * len(due)
    t_start = time.perf_counter()
    log.t_due[:] = t_start + due

    def generate() -> None:
        for i in range(len(due)):
            wait = log.t_due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            log.t_sent[i] = time.perf_counter()
            try:
                fut = client.submit(i, log.column_id[i])
            except Exception as e:  # noqa: BLE001 - a refused request is a failure
                log.fail(i, e, time.perf_counter())
                continue
            fut.add_done_callback(lambda f, i=i: log.settle(i, f))
            futures[i] = fut

    gen = threading.Thread(target=generate, name="perfbench-poisson", daemon=True)
    gen.start()
    gen.join(timeout=seconds + GRACE_S)
    t_stop = t_start + seconds
    deadline = max(t_stop, time.perf_counter()) + GRACE_S
    for i, fut in enumerate(futures):
        if fut is None:
            continue
        try:
            fut.exception(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception:  # noqa: BLE001 - a timeout leaves the request unanswered
            continue
        for _ in range(1000):          # its done-callback runs just after it resolves
            if log.state[i] != Log.PENDING:
                break
            time.sleep(0.001)
    return Window(log, t_start, t_stop, time.perf_counter())

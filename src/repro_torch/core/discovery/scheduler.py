"""Always-on async serving tier: cross-caller micro-batch coalescing
with double-buffered dispatch (PyTorch port of
``repro.core.discovery.scheduler``).

:class:`MicroBatchScheduler` is the serving loop in front of one
:class:`~.service.DiscoveryService`:

  * **Coalescing** — queries arriving within ``window_ms`` are drained
    across callers and packed into shared buckets by
    :func:`~.planner.coalesce_queries`, exactly the buckets a solo
    ``submit`` of the same queries forms, so each query's results equal
    a solo ``submit``'s.
  * **Priority classes** — ``"interactive"`` buckets dispatch before
    ``"batch"`` ones; each class has its own bounded queue, and a full
    queue raises :class:`SchedulerBackpressure` at ``submit_async``.
  * **Double-buffered dispatch** — up to ``pipeline_depth`` windows are
    in flight: while window N scores on the card, window N+1's train
    sketches are staged into pinned host tensors
    (:func:`~.executors.stage_trains_host`) and uploaded on a side CUDA
    stream (:func:`~.executors.upload_trains`: the copies run on that
    stream, the compute stream waits for them with ``wait_stream``, and
    ``record_stream`` keeps the allocator from reusing the tensors
    early); then window N+1's work is enqueued, and only then is window
    N collected.
  * **Fault isolation per coalesced bucket** — windows dispatch with
    ``isolate=True``, so the resilience ladder runs per bucket and every
    :class:`QueryHandle` resolves to its own
    :class:`~.resilience.QueryOutcome`.  An ingest between a window's
    dispatch and its collect leaves that window's results unchanged: the
    window ranks against the corpus size it dispatched with, and the
    index's in-place flush only writes rows the window's plan holds as
    dead (see ``index._DeviceStore.append_block``).

The scheduler's own fault sites (``window_timer``, ``ingest_midflight``,
plus ``staging`` in the executors) are armed through the same
:func:`~.resilience.inject_faults` harness.

Threading model: callers touch only the bounded queues (``_cv``).  All
service work — planning, uploads, kernel launches, collects, ingest via
:meth:`add` — runs serialised on ``_service_lock`` by the one loop
thread, which works on the index's device explicitly, or by a test
that calls :meth:`run_pending` itself (``start=False``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.discovery.resilience import (
    InjectedFault,
    QueryOutcome,
    maybe_fault,
)
from repro_torch.core.discovery.service import _check_options

__all__ = [
    "PRIORITIES",
    "MicroBatchScheduler",
    "QueryHandle",
    "SchedulerBackpressure",
    "SchedulerStats",
]

# Priority classes, best first; the rank (index) orders coalesced
# buckets at dispatch.
PRIORITIES = ("interactive", "batch")
_PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}


class SchedulerBackpressure(RuntimeError):
    """A priority class's queue is at ``max_depth``: the submit is
    refused now instead of queueing unboundedly.  Callers back off and
    resubmit."""


class QueryHandle:
    """Per-query future returned by :meth:`MicroBatchScheduler.submit_async`.

    Resolves to the ``(ranked results, QueryOutcome)`` pair a
    ``submit_safe`` of the query would produce.  ``result()`` /
    ``outcome()`` block until the owning window collects (optionally
    with a timeout); ``done()`` polls.  ``enqueued_at`` /
    ``dispatched_at`` / ``done_at`` are ``time.perf_counter`` stamps.
    """

    __slots__ = (
        "priority", "enqueued_at", "dispatched_at", "done_at",
        "_event", "_result", "_outcome",
    )

    def __init__(self, priority: str):
        self.priority = priority
        self.enqueued_at = time.perf_counter()
        self.dispatched_at: float | None = None
        self.done_at: float | None = None
        self._event = threading.Event()
        self._result = None
        self._outcome: QueryOutcome | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> "QueryHandle":
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"query not served within {timeout}s (priority="
                f"{self.priority})"
            )
        return self

    def result(self, timeout: float | None = None):
        """Ranked result list (None for quarantined/failed queries —
        check :meth:`outcome`)."""
        return self.wait(timeout)._result

    def outcome(self, timeout: float | None = None) -> QueryOutcome:
        return self.wait(timeout)._outcome

    def _resolve(self, result, outcome: QueryOutcome) -> None:
        self._result = result
        self._outcome = outcome
        self.done_at = time.perf_counter()
        self._event.set()


class _Entry:
    """One queued query: its handle, sketch, and serving options."""

    __slots__ = ("handle", "sketch", "opts_key", "opts")

    def __init__(self, handle, sketch, opts_key, opts):
        self.handle = handle
        self.sketch = sketch
        self.opts_key = opts_key
        self.opts = opts


class _LatencyWindow:
    """Bounded latency reservoir (seconds in, milliseconds out): the most
    recent ``cap`` samples, percentiles computed on read."""

    __slots__ = ("_samples",)

    def __init__(self, cap: int = 4096):
        self._samples: deque = deque(maxlen=cap)

    def record(self, seconds: float) -> None:
        self._samples.append(float(seconds))

    def __len__(self) -> int:
        return len(self._samples)

    def quantiles(self) -> dict | None:
        """``{"p50": ms, "p95": ms, "p99": ms}`` or None when empty."""
        if not self._samples:
            return None
        q = np.percentile(np.fromiter(self._samples, dtype=np.float64),
                          [50.0, 95.0, 99.0])
        return {
            "p50": round(float(q[0]) * 1e3, 4),
            "p95": round(float(q[1]) * 1e3, 4),
            "p99": round(float(q[2]) * 1e3, 4),
        }


class SchedulerStats:
    """Serving telemetry for the micro-batch tier.

    Per priority class: query/rejection counters and bounded reservoirs
    of queue-wait (enqueue -> dispatch) and end-to-end (enqueue ->
    resolve) latency, as p50/p95/p99 ms.  Across classes: ``windows``,
    ``dispatched_buckets`` / ``coalesced_queries`` (their ratio is the
    coalesce ratio), ``overlapped_windows`` (dispatches made while a
    previous window was still in flight), ``timer_stalls``,
    ``failed_windows`` and loop ``occupancy``.
    """

    def __init__(self, cap: int = 4096):
        self.queue_wait = {p: _LatencyWindow(cap) for p in PRIORITIES}
        self.e2e = {p: _LatencyWindow(cap) for p in PRIORITIES}
        self.queries = {p: 0 for p in PRIORITIES}
        self.rejected = {p: 0 for p in PRIORITIES}
        self.windows = 0
        self.dispatched_buckets = 0
        self.coalesced_queries = 0
        self.overlapped_windows = 0
        self.timer_stalls = 0
        self.failed_windows = 0
        self.busy_s = 0.0
        self.started_at = time.perf_counter()

    @property
    def coalesce_ratio(self) -> float | None:
        """Queries per dispatched bucket; > 1 means cross-caller packing
        is paying off."""
        if not self.dispatched_buckets:
            return None
        return self.coalesced_queries / self.dispatched_buckets

    def occupancy(self) -> float:
        wall = time.perf_counter() - self.started_at
        return min(self.busy_s / wall, 1.0) if wall > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "per_class": {
                p: {
                    "queries": self.queries[p],
                    "rejected": self.rejected[p],
                    "queue_wait_ms": self.queue_wait[p].quantiles(),
                    "e2e_ms": self.e2e[p].quantiles(),
                }
                for p in PRIORITIES
            },
            "windows": self.windows,
            "dispatched_buckets": self.dispatched_buckets,
            "coalesced_queries": self.coalesced_queries,
            "coalesce_ratio": self.coalesce_ratio,
            "overlapped_windows": self.overlapped_windows,
            "timer_stalls": self.timer_stalls,
            "failed_windows": self.failed_windows,
            "occupancy": round(self.occupancy(), 4),
        }


class _Flight:
    """One dispatched scheduler window awaiting collect: the service
    windows (one per distinct option set) and their entries."""

    __slots__ = ("parts",)

    def __init__(self, parts: list):
        self.parts = parts  # [(service _Window | None, [entries]), ...]


class MicroBatchScheduler:
    """The always-on micro-batch tier in front of one
    :class:`~.service.DiscoveryService`.

    ``window_ms`` is the coalescing window: after traffic arrives the
    loop waits that long for more callers, then packs everything queued
    into shared buckets and dispatches.  ``max_depth`` bounds each
    priority class's queue; ``pipeline_depth`` bounds the windows in
    flight (2 = double buffering: dispatch N+1, then collect N).
    ``start=False`` skips the background thread — tests drive the loop
    through :meth:`run_pending`.

    Use :meth:`add` (not ``service.add``) for ingest while the scheduler
    is live: it serialises against the loop.
    """

    def __init__(
        self,
        service,
        *,
        window_ms: float = 2.0,
        max_depth: int = 256,
        pipeline_depth: int = 2,
        start: bool = True,
    ):
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got "
                             f"{pipeline_depth}")
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.service = service
        self.window_ms = float(window_ms)
        self.max_depth = int(max_depth)
        self.pipeline_depth = int(pipeline_depth)
        self.stats_ = SchedulerStats()
        self._cv = threading.Condition()
        self._queues: dict[str, deque] = {p: deque() for p in PRIORITIES}
        self._inflight: deque[_Flight] = deque()
        self._closed = False
        # All service access (dispatch/collect/ingest) serialises here;
        # callers never hold it, so submit_async stays non-blocking.
        self._service_lock = threading.RLock()
        # Side stream of the train uploads, made on first dispatch (by
        # the loop thread), None off the card.
        self._copy_stream = None
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="discovery-microbatch", daemon=True,
            )
            self._thread.start()

    # ------------------------------------------------------------------
    # Caller surface
    # ------------------------------------------------------------------

    def submit_async(
        self,
        queries,
        *,
        priority: str = "interactive",
        top_k: int = 10,
        min_join: int = 8,
        prefilter: bool | None = None,
        fused: bool | None = None,
        min_containment: float = 0.0,
        rank: str = "mi",
    ):
        """Enqueue one sketch (returns a :class:`QueryHandle`) or a list
        of sketches (returns a list of handles).

        Non-blocking: validation, dispatch and collection happen on the
        loop; the only immediate failures are argument errors and
        :class:`SchedulerBackpressure` when ``priority``'s queue is full
        (then nothing from this call is enqueued).
        """
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got {priority!r}"
            )
        _check_options(rank)
        single = not isinstance(queries, (list, tuple))
        sketches = [queries] if single else list(queries)
        opts = {
            "top_k": int(top_k), "min_join": int(min_join),
            "prefilter": prefilter, "fused": fused,
            "min_containment": float(min_containment), "rank": rank,
        }
        opts_key = tuple(sorted(opts.items(), key=lambda kv: kv[0]))
        entries = []
        with self._cv:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            q = self._queues[priority]
            if len(q) + len(sketches) > self.max_depth:
                self.stats_.rejected[priority] += len(sketches)
                raise SchedulerBackpressure(
                    f"{priority} queue at depth {len(q)} cannot take "
                    f"{len(sketches)} more (max_depth="
                    f"{self.max_depth}); back off and resubmit"
                )
            for sk in sketches:
                entry = _Entry(QueryHandle(priority), sk, opts_key, opts)
                q.append(entry)
                entries.append(entry)
            self._cv.notify_all()
        handles = [e.handle for e in entries]
        return handles[0] if single else handles

    def add(self, *args, **kwargs) -> None:
        """Ingest one candidate column through the scheduler (see
        :meth:`SketchIndex.add`), serialised against the loop; windows
        already in flight collect against their dispatch-time corpus."""
        with self._service_lock:
            maybe_fault("ingest_midflight")
            self.service.add(*args, **kwargs)

    def flush(self, timeout: float | None = None) -> None:
        """Block until everything queued or in flight has resolved."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        while True:
            with self._cv:
                idle = not self._queued_count() and not self._inflight
            if idle:
                return
            if self._thread is None:
                self.run_pending()
                continue
            if deadline is not None and time.perf_counter() > deadline:
                raise TimeoutError(f"flush did not drain in {timeout}s")
            time.sleep(0.0002)

    def close(self, timeout: float = 10.0) -> None:
        """Graceful drain: refuse new submits, serve everything already
        queued, stop the loop.  Idempotent."""
        with self._cv:
            if self._closed and self._thread is None:
                return
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"scheduler loop did not stop within {timeout}s"
                )
            self._thread = None
        else:
            while self._queued_count() or self._inflight:
                if not self.run_pending() and not self._inflight:
                    break

    def __enter__(self) -> "MicroBatchScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        return self.stats_.as_dict()

    # ------------------------------------------------------------------
    # Loop
    # ------------------------------------------------------------------

    def _queued_count(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _device_scope(self):
        dev = self.service.index.device
        if dev.type == "cuda":
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def _loop(self) -> None:
        with self._device_scope():
            while True:
                with self._cv:
                    while not (self._closed or self._queued_count()
                               or self._inflight):
                        self._cv.wait(0.05)
                    if self._closed and not self._queued_count() \
                            and not self._inflight:
                        return
                    has_traffic = bool(self._queued_count())
                if has_traffic and not self._closed:
                    # The coalescing window: let concurrent callers land
                    # in this drain instead of the next one.
                    time.sleep(self.window_ms / 1e3)
                self.run_pending()

    def run_pending(self, collect: bool = True) -> int:
        """One scheduler iteration, callable directly in tests
        (``start=False``): drain the queues, dispatch one window, collect
        down to the pipeline bound (or fully, when idle).  Returns the
        number of queries drained.  ``collect=False`` dispatches only,
        holding the window in flight."""
        with self._service_lock:
            t0 = time.perf_counter()
            try:
                maybe_fault("window_timer")
            except InjectedFault:
                # A stalled tick loses no queries: they stay queued and
                # ride the next tick.
                self.stats_.timer_stalls += 1
                return 0
            with self._cv:
                entries: list[_Entry] = []
                for p in PRIORITIES:
                    q = self._queues[p]
                    while q:
                        entries.append(q.popleft())
            if entries:
                flight = self._dispatch(entries)
                if flight is not None:
                    if self._inflight:
                        self.stats_.overlapped_windows += 1
                    self._inflight.append(flight)
            if collect:
                # Double buffer: keep pipeline_depth-1 windows scoring
                # while traffic keeps arriving; drain fully once the
                # queues go quiet.
                while len(self._inflight) >= self.pipeline_depth:
                    self._collect_flight(self._inflight.popleft())
                if not self._queued_count():
                    while self._inflight:
                        self._collect_flight(self._inflight.popleft())
            self.stats_.busy_s += time.perf_counter() - t0
            return len(entries)

    def _stream(self):
        dev = self.service.index.device
        if self._copy_stream is None and dev.type == "cuda":
            self._copy_stream = torch.cuda.Stream(device=dev)
        return self._copy_stream

    def _dispatch(self, entries: list[_Entry]) -> _Flight | None:
        """Stage + dispatch one window: group drained entries by option
        set (priority first), fire each group through the service's
        dispatch half (no host sync on the fused path), and record
        queue-wait telemetry."""
        st = self.stats_
        groups: dict[tuple, list[_Entry]] = {}
        for e in entries:
            groups.setdefault(e.opts_key, []).append(e)
        ordered = sorted(
            groups.values(),
            key=lambda g: min(_PRIORITY_RANK[e.handle.priority] for e in g),
        )
        now = time.perf_counter()
        parts = []
        for group in ordered:
            prio = [_PRIORITY_RANK[e.handle.priority] for e in group]
            try:
                win = self.service._window_dispatch(
                    [e.sketch for e in group],
                    isolate=True, priorities=prio, coalesced=True,
                    copy_stream=self._stream(), **group[0].opts,
                )
            except Exception as e:  # noqa: BLE001 — window-isolated
                st.failed_windows += 1
                for i, en in enumerate(group):
                    en.handle.dispatched_at = now
                    en.handle._resolve(None, QueryOutcome(
                        i, "failed", error="dispatch_failed", detail=repr(e),
                    ))
                continue
            for e in group:
                e.handle.dispatched_at = now
                st.queue_wait[e.handle.priority].record(
                    now - e.handle.enqueued_at
                )
            st.coalesced_queries += len(group)
            st.dispatched_buckets += len(win.jobs) if win else 0
            parts.append((win, group))
        if not parts:
            return None
        st.windows += 1
        return _Flight(parts)

    def _collect_flight(self, flight: _Flight) -> None:
        """Collect one window's results and resolve its handles; a
        collect failure fails only this window's handles (bucket-level
        failures were already isolated by the service's ladder)."""
        st = self.stats_
        for win, group in flight.parts:
            if win is None:
                results = [None] * len(group)
                outcomes = [
                    QueryOutcome(i, "failed", error="empty_window")
                    for i in range(len(group))
                ]
            else:
                try:
                    results, outcomes = self.service._window_collect(win)
                except Exception as e:  # noqa: BLE001 — isolate
                    st.failed_windows += 1
                    for i, en in enumerate(group):
                        en.handle._resolve(None, QueryOutcome(
                            i, "failed", error="collect_failed",
                            detail=repr(e),
                        ))
                    continue
            now = time.perf_counter()
            for i, en in enumerate(group):
                en.handle._resolve(results[i], outcomes[i])
                p = en.handle.priority
                st.queries[p] += 1
                st.e2e[p].record(now - en.handle.enqueued_at)

"""Spans and counters inside the discovery path, off unless switched on.

An operator switches them on with :func:`enable`, serves traffic, and
reads :func:`snapshot`; :func:`disable` switches them off again and
keeps what was recorded until :func:`reset`.

* **Spans** (:func:`span`, a context manager): name, start and end on
  ``time.perf_counter_ns`` (the clock of ``QueryHandle``'s stamps), the
  thread, the span's id, its parent (the innermost span open on the same
  thread) and attributes.  Each span also carries a *group*: a span that
  opens with no span open on its thread starts a group of its own id,
  and the spans inside it share that group.  So every span of one
  scheduler window, or of one ``query_many`` call, carries one
  identifier; a window's collect, which runs inside the next window's
  span, is given its own window's group.
* **Counters** (:func:`add`, :func:`timed`): sums by name.
* **Garbage collections**: while on, a ``gc.callbacks`` hook records each
  collection as a ``python.gc`` span with its generation, inside
  whatever span its thread had open.

Spans are kept in memory, the newest :data:`CAPACITY` of them; older
ones are dropped and counted (``snapshot()["dropped"]``).  Nothing is
logged or written out.  Off (the default), :func:`span` and :func:`timed`
return one shared no-op after a single check, :func:`add` returns at
once, nothing is kept and no ``gc.callbacks`` entry is registered.

The sites sit per window, per bucket or per call, never per candidate:

=====================  ==============================================
``sched.window``       ``MicroBatchScheduler.run_pending`` (``queries``)
``sched.sleep``        the coalescing sleep of the scheduler's loop
``service.dispatch``   ``DiscoveryService._window_dispatch``
``service.collect``    ``DiscoveryService._window_collect``
``executors.stage``    ``stage_trains_host`` (so ``stack_trains_host``)
``executors.fetch``    every device-to-host copy of a result (``bytes``)
``discovery.rank``     the non-finite fence and ranking of a bucket, or
                       of a ``query_many`` call (``queries``)
``index.query_many``   ``SketchIndex.query_many`` (``queries``)
``python.gc``          each garbage collection (``generation``)
=====================  ==============================================

and the counter ``index.sketch_s`` (seconds spent building and
validating candidate sketches at ingest).  How long queries wait in the
scheduler's queue is ``SchedulerStats.queue_wait_s``, which is always
kept.
"""

from __future__ import annotations

import gc
import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

__all__ = [
    "Span", "add", "current_group", "disable", "enable", "enabled",
    "reset", "snapshot", "span", "timed",
]

CAPACITY = 100_000


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: int | None
    group: int | None
    attrs: dict


_on = False
_spans: deque = deque(maxlen=CAPACITY)
_dropped = 0
_counters: dict = {}
# Reentrant: a collection that starts while a thread records runs the
# GC hook on that same thread.
_lock = threading.RLock()
_ids = itertools.count(1)
_local = threading.local()
_gc_start: int | None = None


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _record(sp: Span) -> None:
    global _dropped
    with _lock:
        if len(_spans) == _spans.maxlen:
            _dropped += 1
        _spans.append(sp)


class _Open:
    __slots__ = ("name", "group", "attrs", "id", "parent", "start_ns",
                 "stack")

    def __init__(self, name: str, group, attrs: dict):
        self.name, self.group, self.attrs = name, group, attrs

    def __enter__(self):
        stack = self.stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        if self.group is None:
            self.group = up.group if up is not None else self.id
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.stack.remove(self)
        # Recorded even if telemetry was switched off meanwhile: the span
        # opened while on.
        _record(Span(self.name, self.start_ns, end, threading.get_ident(),
                     self.id, self.parent, self.group, self.attrs))
        return False


class _Timed:
    __slots__ = ("counter", "t0")

    def __init__(self, counter: str):
        self.counter = counter

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        add(self.counter, (time.perf_counter_ns() - self.t0) * 1e-9)
        return False


def span(name: str, group: int | None = None, **attrs):
    """A span around a ``with`` block; ``group`` (default: the enclosing
    span's, or a new one) names the window or call it belongs to."""
    if not _on:
        return _NOOP
    return _Open(name, group, attrs)


def timed(counter: str):
    """A ``with`` block whose seconds are added to ``counter``."""
    if not _on:
        return _NOOP
    return _Timed(counter)


def add(counter: str, value=1) -> None:
    if not _on:
        return
    with _lock:
        _counters[counter] = _counters.get(counter, 0) + value


def current_group() -> int | None:
    """The group of the innermost span open on this thread (None when
    off or outside every span)."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1].group if stack else None


def _on_gc(phase: str, info: dict) -> None:
    global _gc_start
    if phase == "start":
        _gc_start = time.perf_counter_ns()
        return
    start, _gc_start = _gc_start, None
    if start is None:
        return
    stack = getattr(_local, "stack", None)
    up = stack[-1] if stack else None
    _record(Span("python.gc", start, time.perf_counter_ns(),
                 threading.get_ident(), next(_ids),
                 up.id if up is not None else None,
                 up.group if up is not None else None,
                 {"generation": info["generation"],
                  "collected": info["collected"]}))


def enable() -> None:
    """Switch spans, counters and the GC hook on."""
    global _on
    with _lock:
        if _on_gc not in gc.callbacks:
            gc.callbacks.append(_on_gc)
        _on = True


def disable() -> None:
    """Switch everything off; what was recorded stays until :func:`reset`."""
    global _on, _gc_start
    with _lock:
        _on = False
        while _on_gc in gc.callbacks:
            gc.callbacks.remove(_on_gc)
        _gc_start = None


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every span, counter and drop."""
    global _dropped
    with _lock:
        _spans.clear()
        _counters.clear()
        _dropped = 0


def snapshot(spans: bool = True) -> dict:
    """``{"enabled", "spans" (oldest first; [] with ``spans=False``),
    "counters", "dropped"}``, copied."""
    with _lock:
        return {"enabled": _on, "spans": list(_spans) if spans else [],
                "counters": dict(_counters), "dropped": _dropped}

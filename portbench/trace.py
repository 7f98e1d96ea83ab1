"""The traced run: a profiler slice inside the window, the benchmark's
own spans around the calls into each layer, and their reduction.

:class:`Slice` starts ``torch.profiler`` at a set time of the window and
stops it a set time later (the traffic loop calls it between waits).  While
the window runs, :func:`spans` times the program's calls that a request
passes through on the host, on any thread, as ``portbench.<call>``
spans (the profiler records host ranges of its own thread only).
:func:`reduce` turns the slice into the device's busy time (the union
of kernel intervals), its idle gaps named by what the host was doing
(the innermost span over the gap's middle, else the innermost profiled
host operation, else "host: no span"), and device time by kernel name.
"""

from __future__ import annotations

import contextlib
import re
import time

import torch

SLICE = "portbench.slice"


@contextlib.contextmanager
def spans():
    """Time the host calls of a query's path; yields the list that
    collects (label, start, end) on ``time.perf_counter``."""
    from repro_torch.core.discovery import executors, index, service

    targets = [
        (index.SketchIndex, "_rank", "portbench.rank"),
        (index.SketchIndex, "query_many", "portbench.query_many"),
        (service.DiscoveryService, "_window_dispatch", "portbench.dispatch"),
        (service.DiscoveryService, "_window_collect", "portbench.collect"),
        (executors, "stage_trains_host", "portbench.stage"),
        (executors, "upload_trains", "portbench.upload"),
    ]
    recorded, saved = [], []
    for owner, attr, label in targets:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))

        def wrapped(*a, _fn=fn, _label=label, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                recorded.append((_label, t0, time.perf_counter()))
        setattr(owner, attr, wrapped)
    try:
        yield recorded
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


class Slice:
    """Profile from ``at`` seconds into the window for ``length`` seconds,
    and count the rise of each of ``counters`` (name -> callable) in it.

    The profiler is set up before the window (:meth:`prepare`: its
    warm-up cycle, which records nothing, pays the tracer's start), so
    the slice starts and stops by ``step()`` between the traffic's waits.
    """

    def __init__(self, at: float, length: float, counters: dict):
        self.at, self.length, self.counters = at, length, counters
        self.prof = None
        self.events = None
        self.start = self.stop = None
        self.launches = None
        self._mark = None
        self._first = None

    def prepare(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
            on_trace_ready=self._ready)
        self.prof.start()

    def _ready(self, prof):
        self.events = list(prof.events())

    def __call__(self, now: float):
        if self._first is None:
            self._first = now
        if self.start is None and now >= self._first + self.at:
            self.prof.step()
            self._mark = torch.profiler.record_function(SLICE)
            self._mark.__enter__()
            self.start = time.perf_counter()
            self.launches = {n: -f() for n, f in self.counters.items()}
        elif self.stop is None and self.start is not None \
                and time.perf_counter() >= self.start + self.length:
            self.finish()

    def finish(self):
        """Close the slice (at the window's end at the latest)."""
        if self.prof is None:
            return
        if self.start is not None and self.stop is None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.stop = time.perf_counter()
            for n, f in self.counters.items():
                self.launches[n] += f()
            self._mark.__exit__(None, None, None)
            self.prof.step()
        self.prof.stop()
        self.prof = None


def _short(name: str) -> str:
    name = re.sub(r"<.*>", "<>", name)
    return name[:96]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events, spans=(), mark_t: float | None = None) -> dict | None:
    """Busy and idle seconds, kernels, gaps and device ops of the slice's
    profiler events; ``spans`` (perf_counter seconds) are placed on the
    profiler's clock by the slice's mark, entered at ``mark_t``."""
    if not events:
        return None
    marks = [e for e in events if e.name == SLICE]
    if not marks:
        return None
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    kernels, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name == SLICE or e.name.startswith("ProfilerStep"):
            continue  # the profiler's own ranges, on the host and the card
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if t > w0 and s < w1:
                kernels.append((e.name, max(s, w0), min(t, w1)))
        else:
            host.append((e.name, s, t))
    if mark_t is not None:
        host += [(n, w0 + (a - mark_t) * 1e6, w0 + (b - mark_t) * 1e6)
                 for n, a, b in spans]
    busy = _union([(s, t) for _, s, t in kernels])
    gaps, prev = [], w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    by_name: dict = {}
    for name, s, t in kernels:
        by_name[_short(name)] = by_name.get(_short(name), 0.0) + (t - s) / 1e6

    def label(mid):
        over = [(t - s, n) for n, s, t in host if s <= mid <= t]
        mine = [o for o in over if o[1].startswith("portbench.")]
        pick = min(mine or over, default=None)
        return pick[1] if pick else "host: no span"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(t - s for s, t in busy) / 1e6,
        "kernels": kernels,
        "device_ops": sorted(([n, v] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": [[label((s + t) / 2), (t - s) / 1e6] for s, t in gaps[:10]],
    }

"""Where a cell's window spends its host time and the card's idle time,
by the program's own spans and counters (``repro_torch.telemetry``).

    python3 portbench/program_trace.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on the card.  It sets the cell up as
``harness.run_cell`` does, with the program's telemetry switched on
before the lake is made, and runs the window with the harness's
profiler slice inside it.  Standard error gets the slice's idle time
split by the innermost program span open over it, the residual of the
clock placement, the longest idle gaps with the chain of spans over
each, and the garbage collections by generation; the last line of
standard output is a JSON object of the readings.  The benchmark's own
runs (``run.py``) keep the program's telemetry off, so this is a run of
its own; its answers are not checked.

Readings, over the window unless named otherwise:

* ``rank_host_ms_per_query``: ``discovery.rank`` seconds (the fence and
  ranking of a bucket, or of a ``query_many`` call) over the queries
  those spans ranked;
* ``device_wait_ms_per_query``: ``executors.fetch`` seconds (the host's
  waits on the device for results) over the same queries;
* ``queue_wait_ms_per_query``: the rise of the scheduler's
  ``queue_wait_s`` over that of its ``coalesced_queries`` (served cells);
* ``gc_pause_s``: ``python.gc`` seconds, on any thread (and
  ``gc_collected``: the objects those collections freed, by generation);
* ``device_idle_in_rank_pct``, over the slice: the time the card is idle
  while a ``discovery.rank`` span is open, over the slice;
* ``ingest_sketch_s``, over set-up: the ``index.sketch_s`` counter;
* ``gc_objects``: the objects the garbage collector tracks (what a
  generation-2 collection walks) at the window's start and end.

The program's spans are placed on the profiler's microseconds by the
slice's mark, as ``trace.reduce`` places the benchmark's own spans
(``w0 + (t - slice.start) * 1e6``).  The residual of that placement at
the mark's other end is logged; above :data:`RESIDUAL_US` the spans are
placed by both ends instead.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from portbench import harness, trace  # noqa: E402

RESIDUAL_US = 100.0
NO_SPAN = "no program span"
RANK = "discovery.rank"


def _log(msg: str):
    print(f"[program_trace] {msg}", file=sys.stderr, flush=True)


def place(spans, w0: float, w1: float, start: float, stop: float):
    """Program spans (``telemetry.Span``, perf_counter ns) on the
    profiler's microseconds, for a slice whose mark spans [w0, w1] and
    was entered at ``start`` and closed after ``stop`` (perf_counter s).
    Returns ([(s_us, e_us, span)] of the spans that overlap the slice,
    the residual in us, the anchors used)."""
    residual = w1 - (w0 + (stop - start) * 1e6)
    scale, how = 1.0, "the slice's start"
    if abs(residual) > RESIDUAL_US and stop > start:
        scale, how = (w1 - w0) / ((stop - start) * 1e6), "both ends"

    def at(ns):
        return w0 + (ns * 1e-9 - start) * 1e6 * scale

    placed = []
    for s in spans:
        a, b = at(s.start_ns), at(s.end_ns)
        if b > w0 and a < w1:
            placed.append((a, b, s))
    return placed, residual, how


def _gaps(busy, w0: float, w1: float) -> list:
    """The stretches of [w0, w1] outside every ``busy`` interval."""
    out, prev = [], w0
    for s, t in sorted(busy) + [(w1, w1)]:
        if s > prev:
            out.append((prev, min(s, w1)))
        prev = max(prev, t)
    return out


def idle_split(busy, w0: float, w1: float, placed, mark: str = RANK):
    """Microseconds of [w0, w1] outside every ``busy`` interval, by the
    innermost placed span open over them (the shortest; :data:`NO_SPAN`
    where none is), and the microseconds of it during which a span named
    ``mark`` is open."""
    gaps = _gaps(busy, w0, w1)
    cuts = {x for g in gaps for x in g}
    for a, b, _ in placed:
        cuts.update(x for x in (a, b) if w0 < x < w1)
    cuts = sorted(cuts)
    split: dict = {}
    marked = 0.0
    gi = 0
    for x0, x1 in zip(cuts, cuts[1:]):
        while gi < len(gaps) and gaps[gi][1] <= x0:
            gi += 1
        if gi == len(gaps) or gaps[gi][0] > x0:
            continue  # the card is busy here
        over = [(b - a, s.name) for a, b, s in placed if a <= x0 and b >= x1]
        name = min(over)[1] if over else NO_SPAN
        split[name] = split.get(name, 0.0) + (x1 - x0)
        if any(n == mark for _, n in over):
            marked += x1 - x0
    return split, marked


def longest_gaps(busy, w0: float, w1: float, placed, n: int = 5) -> list:
    """The ``n`` longest idle gaps of [w0, w1]: (us, the chain of program
    spans open over the gap's middle, outermost first; "" where none
    is)."""
    by_id = {s.id: s for _, _, s in placed}
    out = []
    for g0, g1 in sorted(_gaps(busy, w0, w1), key=lambda g: g[0] - g[1])[:n]:
        mid = (g0 + g1) / 2
        over = [(b - a, s.id) for a, b, s in placed if a <= mid <= b]
        chain = []
        s = by_id[min(over)[1]] if over else None
        while s is not None:
            chain.append(s.name)
            s = by_id.get(s.parent)
        out.append((g1 - g0, " > ".join(reversed(chain))))
    return out


def slice_readings(spans, events, start: float, stop: float) -> dict:
    """The slice's idle time by program span, from its profiler events
    and the program's spans; {} without the slice's mark."""
    marks = [e for e in events or [] if e.name == trace.SLICE]
    if not marks or stop is None:
        return {}
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    busy = [(s, t) for _, s, t in trace.reduce(events)["kernels"]]
    placed, residual, how = place(spans, w0, w1, start, stop)
    split, in_rank = idle_split(busy, w0, w1, placed)
    return {
        "slice_s": (w1 - w0) / 1e6,
        "idle_s": sum(split.values()) / 1e6,
        "residual_us": residual,
        "placed_by": how,
        "idle_by_span_s": {k: v / 1e6 for k, v in
                           sorted(split.items(), key=lambda kv: -kv[1])},
        "device_idle_in_rank_pct": 100.0 * in_rank / (w1 - w0),
        "longest_gaps_ms": [[us / 1e3, chain] for us, chain in
                            longest_gaps(busy, w0, w1, placed)],
    }


def readings(snap: dict, setup: dict, start: float, end: float,
             queue=None) -> dict:
    """The window's readings from a telemetry ``snapshot()`` taken after
    it, the counters at the end of set-up, the window's bounds
    (perf_counter s) and the scheduler's (``queue_wait_s``,
    ``coalesced_queries``) rise over it (None without a scheduler)."""
    lo, hi = start * 1e9, end * 1e9
    inside = [s for s in snap["spans"] if lo <= s.start_ns <= hi]

    def seconds(name):
        return sum(s.end_ns - s.start_ns for s in inside
                   if s.name == name) * 1e-9

    ranked = sum(s.attrs["queries"] for s in inside if s.name == RANK)
    gcs = [s for s in inside if s.name == "python.gc"]
    out = {
        "window_s": end - start,
        "spans": len(inside),
        "dropped": snap["dropped"],
        "queries_ranked": ranked,
        "gc_pause_s": seconds("python.gc"),
        "gc_by_generation": [sum(s.attrs["generation"] == g for s in gcs)
                             for g in (0, 1, 2)],
        "gc_longest_ms": max((s.end_ns - s.start_ns for s in gcs),
                             default=0) / 1e6,
        "gc_collected": [sum(s.attrs.get("collected", 0) for s in gcs
                             if s.attrs["generation"] == g)
                         for g in (0, 1, 2)],
        "ingest_sketch_s": setup.get("index.sketch_s"),
    }
    if ranked:
        out["rank_host_ms_per_query"] = 1e3 * seconds(RANK) / ranked
        out["device_wait_ms_per_query"] = \
            1e3 * seconds("executors.fetch") / ranked
    if queue is not None and queue[1]:
        out["queue_wait_ms_per_query"] = 1e3 * queue[0] / queue[1]
    return out


def _queue(driver):
    sched = getattr(driver, "sched", None)
    if sched is None:
        return None
    return sched.stats_.queue_wait_s, sched.stats_.coalesced_queries


def measure(cell: harness.Cell, seed: int, seconds: float,
            device="cuda") -> dict:
    """One run of ``cell`` with the program's telemetry on (off again at
    the end); its readings."""
    from repro_torch import telemetry

    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    telemetry.disable()
    telemetry.reset()
    telemetry.enable()
    try:
        lake = harness.load_module("lakes", cfg["lake"], cell.base).make(
            cfg, seed, device)
        index = harness._ingest(lake, cfg, device)
        setup = telemetry.snapshot(spans=False)["counters"]
        sketches = harness._train_sketches(lake, cfg)
        driver = harness.load_module("drivers", traffic["driver"],
                                     cell.base).make(
            index, cfg, traffic, sketches, lake.query_discrete, seed)
        harness._warm(driver, traffic)
        harness._sync(device)
        telemetry.reset()  # the window's spans only
        objects = len(gc.get_objects())
        q0 = _queue(driver)
        slicer = trace.Slice(seconds * harness.SLICE_AT,
                             min(harness.SLICE_MAX_S, seconds / 2), {})
        slicer.prepare()
        win = driver.run(seconds, tick=slicer)
        slicer.finish()
        q1 = _queue(driver)
        harness._sync(device)
        snap = telemetry.snapshot()
        objects = [objects, len(gc.get_objects())]
    finally:
        telemetry.disable()
    driver.close()
    harness._drop_programs()
    out = readings(snap, setup, win.start, win.end,
                   None if q0 is None else (q1[0] - q0[0], q1[1] - q0[1]))
    out["queries_per_s"] = sum(a[3] for a in win.answers) / out["window_s"]
    out["gc_objects"] = objects
    out.update(slice_readings(snap["spans"], slicer.events, slicer.start,
                              slicer.stop))
    return out


def report(out: dict) -> None:
    """The readings, for a reader, on standard error."""
    if "slice_s" in out:
        idle = out["idle_s"]
        _log(f"spans placed by {out['placed_by']}; residual at the "
             f"slice's other end {out['residual_us']:.1f} us")
        parts = ", ".join(f"{k} {100 * v / idle:.1f}%"
                          for k, v in out["idle_by_span_s"].items()) \
            if idle else "none"
        _log(f"idle {idle * 1e3:.1f} ms of the {out['slice_s'] * 1e3:.1f} "
             f"ms slice, by innermost program span: {parts}")
        _log("longest idle gaps: " + "; ".join(
            f"{ms:.2f} ms {chain or NO_SPAN}"
            for ms, chain in out["longest_gaps_ms"]))
    _log(f"window {out['window_s']:.2f} s: {out['spans']} spans "
         f"({out['dropped']} dropped), {out['queries_ranked']} queries "
         f"ranked; python.gc {out['gc_pause_s'] * 1e3:.1f} ms, by "
         f"generation {out['gc_by_generation']} (objects freed "
         f"{out['gc_collected']}), longest "
         f"{out['gc_longest_ms']:.2f} ms; objects tracked "
         f"{out['gc_objects'][0]} at its start, {out['gc_objects'][1]} at "
         f"its end")


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/program_trace.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(spec, args.workload)
    if not torch.cuda.is_available():
        _log("needs a CUDA card")
        return 2
    torch.cuda.set_device(0)
    out = measure(cell, args.seed, args.seconds)
    report(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The program's spans and counters over a cell's window
(``program_trace``), on the CPU: a tiny run gives every reading, the
benchmark's own runs leave the program's telemetry off, and on a
synthetic slice the program's spans land where ``trace.reduce`` puts
the benchmark's own and the readings are the hand-computed values."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from portbench import harness, program_trace, tiny, trace
from repro_torch import telemetry
from repro_torch.telemetry import Span


@pytest.fixture(autouse=True)
def one_thread_and_telemetry_off():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    telemetry.disable()
    telemetry.reset()
    yield
    torch.set_num_threads(before)
    telemetry.disable()
    telemetry.reset()


@pytest.mark.parametrize("name", ["lake64k-serve", "lake64k-batch"])
def test_tiny_run_gives_every_reading(name):
    out = program_trace.measure(tiny.cell(name), 2**31 + 17, 2.0, "cpu")
    assert not telemetry.enabled()
    assert out["queries_per_s"] > 0 and out["queries_ranked"] > 0
    assert out["rank_host_ms_per_query"] > 0
    assert out["device_wait_ms_per_query"] > 0
    assert out["gc_pause_s"] >= 0 and out["ingest_sketch_s"] > 0
    assert 0 < out["device_idle_in_rank_pct"] <= 100
    # No card: the whole slice is idle, split over the program's spans.
    assert out["idle_s"] == pytest.approx(out["slice_s"])
    assert sum(out["idle_by_span_s"].values()) == pytest.approx(out["idle_s"])
    assert RANK_OR_CALL[name] in out["idle_by_span_s"]
    assert abs(out["residual_us"]) < 1e5 and out["dropped"] == 0
    assert len(out["gc_objects"]) == 2 and min(out["gc_objects"]) > 0
    if name.endswith("serve"):
        assert out["queue_wait_ms_per_query"] > 0
    else:
        assert "queue_wait_ms_per_query" not in out


RANK_OR_CALL = {"lake64k-serve": "sched.window",
                "lake64k-batch": "index.query_many"}


@pytest.mark.parametrize("traced", [False, True])
def test_benchmark_runs_keep_the_telemetry_off(traced):
    """The harness never switches the program's telemetry on, so its
    readers read the run they read before the program had any."""
    out = harness.run_cell(tiny.cell("lake64k-serve"), 2**31 + 19, 0.8,
                           traced, "cpu")
    assert out["correct"] is True
    snap = telemetry.snapshot()
    assert not snap["enabled"]
    assert snap["spans"] == [] and snap["counters"] == {}


# A synthetic slice: the mark from 1000 to 4000 us on the profiler's
# clock, entered at 50 s and closed after 50.003 s on perf_counter;
# kernels over [1000, 1500], [2500, 3000], [3800, 4000].
T0, W0, W1 = 50.0, 1000.0, 4000.0


def _event(name, s, t, cuda=False):
    dev = torch.autograd.DeviceType.CUDA if cuda \
        else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=s, end=t))


def _ns(ms):
    return round((T0 + ms * 1e-3) * 1e9)


def _span(name, a_ms, b_ms, sid, parent=None, **attrs):
    return Span(name, _ns(a_ms), _ns(b_ms), 1, sid, parent, 1, attrs)


EVENTS = [_event(trace.SLICE, W0, W1),
          _event("k1", 1000, 1500, True), _event("k2", 2500, 3000, True),
          _event("k3", 3800, 4000, True)]
SPANS = [
    _span("executors.fetch", 0.1, 0.5, 1, bytes=64),     # busy
    _span("service.collect", 0.6, 1.6, 2),
    _span("discovery.rank", 0.7, 1.3, 3, 2, queries=10),
    _span("python.gc", 0.85, 0.95, 4, 3, generation=0, collected=3),
    _span("sched.sleep", 2.1, 2.4, 5),
    _span("discovery.rank", 2.9, 3.2, 6, queries=6),     # busy, then past
]


def test_synthetic_slice_places_spans_as_trace_reduce():
    placed, residual, how = program_trace.place(SPANS, W0, W1, T0, T0 + 0.003)
    assert residual == pytest.approx(0, abs=1e-6)
    assert how == "the slice's start"
    by_id = {s.id: (a, b) for a, b, s in placed}
    for s in SPANS:
        want = (W0 + (s.start_ns * 1e-9 - T0) * 1e6,
                W0 + (s.end_ns * 1e-9 - T0) * 1e6)
        assert by_id[s.id] == pytest.approx(want, abs=1e-3)
    rank = SPANS[2]
    reduced = trace.reduce(EVENTS, [("portbench.rank", rank.start_ns * 1e-9,
                                     rank.end_ns * 1e-9)], T0)
    # The longest gap, [1500, 2500], is named by the span over its middle.
    assert reduced["idle_gaps"][0] == ["portbench.rank", pytest.approx(1e-3)]
    assert by_id[rank.id] == pytest.approx((1700, 2300), abs=1e-3)

    busy = [(s, t) for _, s, t in reduced["kernels"]]
    split, in_rank = program_trace.idle_split(busy, W0, W1, placed)
    # (The fetch ends on the first kernel's end, up to float rounding.)
    assert {k: v for k, v in split.items() if v > 1e-6} == pytest.approx({
        program_trace.NO_SPAN: 600, "service.collect": 300,
        "discovery.rank": 500, "python.gc": 100, "sched.sleep": 300},
        abs=1e-3)
    assert in_rank == pytest.approx(600, abs=1e-3)
    assert program_trace.longest_gaps(busy, W0, W1, placed) == [
        (pytest.approx(1000), "service.collect > discovery.rank"),
        (pytest.approx(800), "sched.sleep")]


def test_synthetic_slice_places_by_both_ends_past_the_residual():
    stop = T0 + 0.003 - 500e-6  # the mark ends 500 us after stop's place
    placed, residual, how = program_trace.place(SPANS, W0, W1, T0, stop)
    assert residual == pytest.approx(500, abs=1e-3) and how == "both ends"
    by_id = {s.id: (a, b) for a, b, s in placed}
    scale = 3000 / 2500
    assert by_id[3] == pytest.approx((W0 + 700 * scale, W0 + 1300 * scale),
                                     abs=1e-3)


def test_synthetic_readings_are_the_hand_computed_values():
    snap = {"spans": SPANS + [_span("discovery.rank", 9, 10, 7, queries=50)],
            "dropped": 0}
    # The window holds the first six spans, not the one at 9 ms.
    got = program_trace.readings(snap, {"index.sketch_s": 12.5}, T0,
                                 T0 + 0.004, queue=(0.5, 200))
    assert got == pytest.approx({
        "window_s": 0.004, "spans": 6, "dropped": 0, "queries_ranked": 16,
        "gc_pause_s": 1e-4, "gc_by_generation": [1, 0, 0],
        "gc_longest_ms": 0.1, "gc_collected": [3, 0, 0],
        "ingest_sketch_s": 12.5,
        "rank_host_ms_per_query": 0.9 / 16,
        "device_wait_ms_per_query": 0.4 / 16,
        "queue_wait_ms_per_query": 1e3 * 0.5 / 200}, rel=1e-6)
    sl = program_trace.slice_readings(SPANS, EVENTS, T0, T0 + 0.003)
    assert sl["device_idle_in_rank_pct"] == pytest.approx(100 * 600 / 3000)
    assert sl["idle_s"] == pytest.approx(1.8e-3)
    assert sl["slice_s"] == pytest.approx(3e-3)
    assert list(sl["idle_by_span_s"])[0] == program_trace.NO_SPAN
    assert program_trace.slice_readings(SPANS, EVENTS[1:], T0, T0 + 3) == {}


def test_cli_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert program_trace.main(["--workload", "lake64k-serve", "--seed", "1",
                               "--seconds", "1"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err

"""The port's spans and counters (``repro_torch.telemetry``), on the CPU.

Held: off, nothing is kept, ``span()`` is one shared no-op and no
``gc.callbacks`` entry is registered; nested spans get their parent and
group; the spans of one scheduler window share its group across the
thread that dispatched it and the thread that collected it, and so do
the spans of one ``query_many`` call; the bounded list counts drops;
``enable`` / ``disable`` add and remove the GC hook, and a forced
collection is one ``python.gc`` span of generation 2; the scheduler's
queue-wait sum (kept on or off) and the ingest counter; many threads
lose no count and no span.
"""

import gc
import sys
import threading
from collections import deque

import numpy as np
import pytest

from repro_torch import telemetry
from repro_torch.core.discovery import DiscoveryService, SketchIndex
from repro_torch.core.sketch import build_sketch
from _torch_threads import one_thread  # noqa: F401 (autouse)

N_ROWS = 300
SK_N = 64
KEY_SPACE = 1500


@pytest.fixture(autouse=True)
def telemetry_off():
    telemetry.disable()
    telemetry.reset()
    yield
    telemetry.disable()
    telemetry.reset()


def _hooks():
    return [cb for cb in gc.callbacks
            if getattr(cb, "__module__", None) == telemetry.__name__]


def _keys(rng):
    return rng.choice(KEY_SPACE, size=N_ROWS, replace=False).astype(np.uint64)


def _service(seed=0, n=6):
    rng = np.random.default_rng(seed)
    svc = DiscoveryService(index=SketchIndex(n=SK_N, device="cpu"))
    for i in range(n):
        svc.add(f"t{i}", "k", "v", _keys(rng),
                rng.normal(size=N_ROWS).astype(np.float32))
    return svc


def _queries(seed, q):
    rng = np.random.default_rng(seed)
    return [build_sketch(_keys(rng), rng.normal(size=N_ROWS).astype(np.float32),
                         n=SK_N, side="train")
            for _ in range(q)]


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_off_keeps_nothing():
    assert not telemetry.enabled() and not _hooks()
    a, b = telemetry.span("a", queries=1), telemetry.span("b")
    assert a is b and telemetry.timed("c") is a
    with a, telemetry.timed("c"):
        telemetry.add("c", 3)
    assert telemetry.current_group() is None
    svc = _service()
    sched = svc.scheduler(start=False, window_ms=0.0)
    handles = sched.submit_async(_queries(1, 3), min_join=4)
    sched.run_pending()
    svc.index.query_many(_queries(2, 2), min_join=4)
    assert all(h.done() for h in handles)
    snap = telemetry.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}
    assert snap["dropped"] == 0 and not snap["enabled"] and not _hooks()


def test_nested_spans_get_parent_and_group():
    telemetry.enable()
    with telemetry.span("outer", queries=2) as outer:
        with telemetry.span("inner"):
            assert telemetry.current_group() == outer.id
        with telemetry.span("other", group=7):
            assert telemetry.current_group() == 7
    with telemetry.span("next"):
        pass
    got = {s.name: s for s in telemetry.snapshot()["spans"]}
    assert got["outer"].parent is None and got["outer"].group == got["outer"].id
    assert got["outer"].attrs == {"queries": 2}
    assert got["inner"].parent == got["outer"].id
    assert got["inner"].group == got["outer"].id
    assert got["other"].parent == got["outer"].id and got["other"].group == 7
    assert got["next"].group == got["next"].id != got["outer"].id
    assert got["outer"].start_ns <= got["inner"].start_ns \
        <= got["inner"].end_ns <= got["outer"].end_ns
    assert {s.thread for s in got.values()} == {threading.get_ident()}


def test_scheduler_window_shares_its_group_across_threads():
    svc = _service()
    sched = svc.scheduler(start=False, window_ms=0.0, pipeline_depth=2)
    telemetry.enable()
    handles = sched.submit_async(_queries(3, 4), min_join=4)
    worker = threading.Thread(target=lambda: sched.run_pending(collect=False))
    worker.start()
    worker.join(60)
    assert not any(h.done() for h in handles)
    sched.run_pending()  # collects the window on this thread
    assert all(h.outcome().ok for h in handles)
    spans = telemetry.snapshot()["spans"]
    (win,) = _named(spans, "sched.window")
    assert win.attrs == {"queries": 4} and win.group == win.id
    (collect,) = _named(spans, "service.collect")
    assert collect.thread == threading.get_ident() != win.thread
    assert collect.group == win.id and collect.parent is None
    (dispatch,) = _named(spans, "service.dispatch")
    assert dispatch.parent == win.id and dispatch.thread == win.thread
    for name in ("executors.stage", "executors.fetch", "discovery.rank"):
        got = _named(spans, name)
        assert got and all(s.group == win.id for s in got), name
    assert sum(s.attrs["queries"] for s in _named(spans, "discovery.rank")) == 4
    assert all(s.attrs["bytes"] > 0 for s in _named(spans, "executors.fetch"))
    assert telemetry.snapshot()["counters"] == {}


@pytest.mark.parametrize("on", [False, True])
def test_scheduler_sums_the_queue_wait(on):
    svc = _service()
    sched = svc.scheduler(start=False, window_ms=0.0)
    if on:
        telemetry.enable()
    handles = sched.submit_async(_queries(6, 5), min_join=4)
    sched.run_pending()
    assert all(h.outcome().ok for h in handles)
    st = sched.stats_
    waits = [h.dispatched_at - h.enqueued_at for h in handles]
    assert st.coalesced_queries == 5
    assert st.queue_wait_s == pytest.approx(sum(waits)) and st.queue_wait_s > 0
    assert sched.stats()["queue_wait_s"] == st.queue_wait_s


def test_loop_thread_window_and_sleep():
    svc = _service()
    telemetry.enable()
    sched = svc.scheduler(window_ms=1.0)
    try:
        for h in sched.submit_async(_queries(4, 3), min_join=4):
            h.wait(60)
    finally:
        svc.close()
    spans = telemetry.snapshot()["spans"]
    wins = _named(spans, "sched.window")
    assert wins and _named(spans, "sched.sleep")
    loop = {s.thread for s in wins}
    assert threading.get_ident() not in loop
    for s in _named(spans, "service.collect"):
        assert s.group in {w.group for w in wins}


def test_query_many_call_shares_one_group():
    svc = _service()
    telemetry.enable()
    svc.index.query_many(_queries(5, 3), min_join=4)
    spans = telemetry.snapshot()["spans"]
    (call,) = _named(spans, "index.query_many")
    assert call.attrs == {"queries": 3} and call.group == call.id
    inner = [s for s in spans if s is not call and s.name != "python.gc"]
    assert {s.name for s in inner} >= {"executors.stage", "executors.fetch",
                                        "discovery.rank"}
    assert all(s.group == call.id for s in inner)
    (rank,) = _named(spans, "discovery.rank")
    assert rank.parent == call.id and rank.attrs == {"queries": 3}


def test_bounded_list_counts_drops(monkeypatch):
    monkeypatch.setattr(telemetry, "_spans", deque(maxlen=3))
    telemetry.enable()
    for i in range(5):
        with telemetry.span(f"s{i}"):
            pass
    snap = telemetry.snapshot()
    assert [s.name for s in snap["spans"]] == ["s2", "s3", "s4"]
    assert snap["dropped"] == 2
    telemetry.reset()
    assert telemetry.snapshot()["dropped"] == 0


def test_enable_disable_add_and_remove_the_gc_hook():
    before = len(gc.callbacks)
    telemetry.enable()
    telemetry.enable()
    assert len(_hooks()) == 1 and len(gc.callbacks) == before + 1
    telemetry.disable()
    assert not _hooks() and len(gc.callbacks) == before
    with telemetry.span("after"):
        telemetry.add("n", 1)
    assert telemetry.snapshot()["spans"] == []


def test_forced_collection_is_one_gc_span_of_generation_2():
    was = gc.isenabled()
    gc.disable()  # no automatic collection in between
    try:
        telemetry.enable()
        with telemetry.span("around") as around:
            gc.collect()
        telemetry.disable()
    finally:
        if was:
            gc.enable()
    gcs = _named(telemetry.snapshot()["spans"], "python.gc")
    assert len(gcs) == 1
    (g,) = gcs
    assert g.attrs["generation"] == 2 and g.end_ns >= g.start_ns
    assert g.parent == around.id and g.group == around.id


def test_ingest_counters():
    telemetry.enable()
    svc = _service(n=5)
    assert set(telemetry.snapshot()["counters"]) == {"index.sketch_s"}
    assert telemetry.snapshot()["counters"]["index.sketch_s"] > 0
    assert {s.name for s in telemetry.snapshot()["spans"]} <= {"python.gc"}
    assert len(svc) == 5


def test_many_threads_lose_no_count_and_no_span():
    threads, each = 12, 1500
    switch = sys.getswitchinterval()
    telemetry.enable()

    def work():
        for _ in range(each):
            with telemetry.span("w"):
                telemetry.add("n", 1)

    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    snap = telemetry.snapshot()
    assert snap["counters"]["n"] == threads * each
    spans = _named(snap["spans"], "w")
    assert len(spans) == threads * each and snap["dropped"] == 0
    assert len({s.id for s in spans}) == len(spans)
    assert all(s.parent is None and s.group == s.id for s in spans)

"""The port's micro-batch scheduler (mirrors ``tests/test_scheduler.py``).

Most tests drive the loop deterministically (``start=False`` +
``run_pending``); the few that start the loop thread bound every wait
with a timeout and check the thread stopped.  Held, on the CPU:

  (a) every query served through ``submit_async`` equals a solo
      ``submit`` of it, value for value — under coalescing, priorities,
      double buffering and a mid-flight ingest — and matches the JAX
      package's solo ``submit`` (candidates and join sizes equal, MI
      within rtol/atol 1e-5, torch's digamma differing by ~2e-6);
  (b) coalesced buckets reuse the plan-cache entries solo traffic made;
  (c) backpressure, telemetry and lifecycle behave as the reference's.

The reference's transfer-guard test has its counterpart on the card
(``chip_smoke.py`` counts synchronising calls under
``torch.cuda.set_sync_debug_mode``).
"""

import threading
import time

import numpy as np
import pytest

from repro.core.discovery import DiscoveryService as JService
from repro.core.sketch import build_sketch as j_build
from repro_torch.core.discovery import (
    DiscoveryService,
    SchedulerBackpressure,
    SketchIndex,
    coalesce_queries,
)
from repro_torch.core.discovery.scheduler import SchedulerStats, _LatencyWindow
from repro_torch.core.sketch import build_sketch as t_build
from _torch_threads import one_thread  # noqa: F401 (autouse)

TOL = 1e-5
N_ROWS = 400
SK_N = 64
KEY_SPACE = 2000
JOIN_TIMEOUT = 60.0


def _keys(rng):
    return rng.choice(KEY_SPACE, size=N_ROWS, replace=False).astype(np.uint64)


def _corpus_service(seed=0, n_cont=5, n_disc=2, cls=DiscoveryService, **kwargs):
    rng = np.random.default_rng(seed)
    if cls is DiscoveryService:
        svc = cls(index=SketchIndex(n=SK_N, device="cpu"), **kwargs)
    else:
        svc = cls(n=SK_N, **kwargs)
    for i in range(n_cont):
        svc.add(f"tc{i}", "k", "v", _keys(rng),
                rng.normal(size=N_ROWS).astype(np.float32))
    for i in range(n_disc):
        svc.add(f"td{i}", "k", "v", _keys(rng),
                rng.integers(0, 5, size=N_ROWS), True)
    return svc


def _query(rng, disc=False, build=t_build):
    vals = rng.integers(0, 4, size=N_ROWS) if disc \
        else rng.normal(size=N_ROWS).astype(np.float32)
    return build(_keys(rng), vals, n=SK_N, side="train", value_is_discrete=disc)


def _queries(seed, q, disc_every=3, build=t_build):
    rng = np.random.default_rng(seed)
    return [_query(rng, disc=bool(disc_every and i % disc_every == 0),
                   build=build)
            for i in range(q)]


def _flat(res):
    return [(m.table, mi, js) for m, mi, js in res]


def assert_same_results(got, want):
    """Port vs JAX: equal candidates and join sizes, MI allclose; two
    entries may trade places only where their scores are within
    tolerance."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _flat(g), _flat(w)
        assert len(g) == len(w)
        w_by = {t: (mi, js) for t, mi, js in w}
        for (tg, mg, jg), (tw, mw, jw) in zip(g, w):
            assert np.isclose(mg, mw, rtol=TOL, atol=TOL), (tg, mg, tw, mw)
            assert tg in w_by and w_by[tg][1] == jg
            if tg != tw:
                assert np.isclose(w_by[tg][0], mw, rtol=TOL, atol=TOL)


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_TIMEOUT)
    assert not any(t.is_alive() for t in threads)


@pytest.fixture(scope="module")
def svc():
    service = _corpus_service(seed=3)
    yield service
    service.close()


class TestHandles:
    def test_single_sketch_single_handle(self, svc):
        sk = _query(np.random.default_rng(40))
        solo = svc.submit([sk])[0]
        sched = DiscoveryService(index=svc.index).scheduler(start=False)
        handle = sched.submit_async(sk)
        sched.run_pending()
        assert _flat(handle.result(timeout=30)) == _flat(solo)
        out = handle.outcome()
        assert out.ok and out.rung == "batched"
        assert handle.done()
        assert handle.done_at >= handle.dispatched_at >= handle.enqueued_at
        sched.close()

    def test_list_of_sketches_list_of_handles(self, svc):
        qs = _queries(41, 5)
        solo = [svc.submit([q])[0] for q in qs]
        sched = DiscoveryService(index=svc.index).scheduler(start=False)
        handles = sched.submit_async(qs)
        assert len(handles) == len(qs)
        sched.run_pending()
        assert [_flat(h.result(timeout=30)) for h in handles] == \
            [_flat(r) for r in solo]
        sched.close()

    def test_result_timeout(self):
        svc = _corpus_service(seed=5, n_cont=2, n_disc=0)
        sched = svc.scheduler(start=False)  # nothing drives the loop
        handle = sched.submit_async(_query(np.random.default_rng(1)))
        with pytest.raises(TimeoutError):
            handle.result(timeout=0.01)
        sched.close()
        assert handle.done()  # close() drains
        svc.close()

    def test_bad_args_raise_eagerly(self, svc):
        sched = DiscoveryService(index=svc.index).scheduler(start=False)
        sk = _query(np.random.default_rng(2))
        with pytest.raises(ValueError, match="priority"):
            sched.submit_async(sk, priority="urgent")
        with pytest.raises(ValueError, match="rank"):
            sched.submit_async(sk, rank="mae")
        assert not sched._queued_count()
        # The phase-0 gate is ported: a gated handle resolves to the
        # reference's gated submit.
        handle = sched.submit_async(sk, min_containment=0.1)
        sched.run_pending()
        assert not sched._queued_count()
        want = _corpus_service(seed=3, cls=JService).submit(
            [_query(np.random.default_rng(2), build=j_build)],
            min_containment=0.1)
        assert want[0]
        assert_same_results([handle.result(timeout=30)], want)
        sched.close()


class TestCoalescing:
    def test_concurrent_callers_match_solo_and_reference(self):
        """8 caller threads hitting one window: every caller's results
        equal its solo submit (and the JAX package's), and the traffic
        coalesced."""
        svc = _corpus_service(seed=7)
        per_caller = {c: _queries(100 + c, 3) for c in range(8)}
        solo = {c: [svc.submit([q])[0] for q in qs]
                for c, qs in per_caller.items()}
        sched = svc.scheduler(window_ms=25.0)
        barrier = threading.Barrier(8, timeout=JOIN_TIMEOUT)
        got, errors = {}, []

        def caller(c):
            try:
                barrier.wait()
                handles = svc.submit_async(per_caller[c])
                got[c] = [h.result(timeout=JOIN_TIMEOUT) for h in handles]
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=caller, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        _join(threads)
        assert not errors
        assert {c: [_flat(r) for r in v] for c, v in got.items()} == \
            {c: [_flat(r) for r in v] for c, v in solo.items()}
        st = sched.stats_
        assert st.coalesced_queries == 24
        assert st.dispatched_buckets < 16  # fewer than per-caller dispatch
        assert st.coalesce_ratio > 1.0
        pc = svc.plan_cache
        assert pc.coalesced_hits + pc.coalesced_misses > 0
        svc.close()
        assert svc._scheduler is None

        j_svc = _corpus_service(seed=7, cls=JService)
        for c in range(8):
            want = [j_svc.submit([q])[0]
                    for q in _queries(100 + c, 3, build=j_build)]
            assert_same_results(got[c], want)

    def test_mixed_priorities_share_buckets(self):
        svc = _corpus_service(seed=9, n_disc=0)
        qs = _queries(55, 6, disc_every=0)
        solo = [svc.submit([q])[0] for q in qs]
        sched = svc.scheduler(start=False)
        hi = [sched.submit_async(q, priority="interactive") for q in qs[:3]]
        hb = [sched.submit_async(q, priority="batch") for q in qs[3:]]
        sched.run_pending()
        assert [_flat(h.result()) for h in hi + hb] == [_flat(r) for r in solo]
        # one signature, six queries -> exactly one dispatched bucket
        assert sched.stats_.dispatched_buckets == 1
        assert sched.stats_.coalesce_ratio == 6.0
        assert sched.stats_.queries == {"interactive": 3, "batch": 3}
        svc.close()

    def test_coalesced_windows_reuse_solo_plans(self):
        """Coalesced windows form the buckets a solo submit of the same
        queue forms, so they hit the plan-cache entries it made."""
        svc = _corpus_service(seed=11)
        qs = _queries(60, 8)
        solo = svc.submit(qs)
        svc.submit(qs)  # steady state: rungs settled, entries cached
        cache_misses = svc.plan_cache.misses
        sched = svc.scheduler(start=False)
        handles = [sched.submit_async(q) for q in qs]
        sched.run_pending()
        assert [_flat(h.result()) for h in handles] == [_flat(r) for r in solo]
        assert svc.plan_cache.misses == cache_misses
        assert svc.plan_cache.coalesced_hits > 0
        svc.close()

    def test_coalesce_priority_ordering_unit(self):
        entries = [(i, ("sig_a",), 1 if i < 3 else 0) for i in range(6)]
        buckets = coalesce_queries(entries, cap=4)
        assert buckets[0].chunk == (3, 4, 5, 0)
        assert buckets[0].priority == 0
        assert buckets[1].chunk == (1, 2)
        assert buckets[1].priority == 1
        assert [b.q_bucket for b in buckets] == [4, 2]

    def test_coalesce_single_priority_is_arrival_order(self):
        entries = [(i, ("s", i % 2), 0) for i in range(5)]
        buckets = coalesce_queries(entries, cap=64)
        assert [b.chunk for b in buckets] == [(0, 2, 4), (1, 3)]


class TestBackpressure:
    def test_full_queue_refuses(self):
        svc = _corpus_service(seed=13, n_cont=2, n_disc=0)
        sched = svc.scheduler(start=False, max_depth=4)
        qs = _queries(70, 6, disc_every=0)
        for q in qs[:4]:
            sched.submit_async(q)
        with pytest.raises(SchedulerBackpressure):
            sched.submit_async(qs[4])
        assert sched.stats_.rejected["interactive"] == 1
        hb = sched.submit_async(qs[4], priority="batch")  # independent queue
        with pytest.raises(SchedulerBackpressure):  # all-or-nothing
            sched.submit_async(qs[4:6])
        assert sum(len(q) for q in sched._queues.values()) == 5
        sched.run_pending()
        assert hb.done()
        sched.close()
        svc.close()


class TestDoubleBuffer:
    def test_pipeline_holds_and_overlaps(self):
        svc = _corpus_service(seed=15)
        qsA, qsB = _queries(80, 4), _queries(81, 4)
        solo = [svc.submit([q])[0] for q in qsA + qsB]
        sched = svc.scheduler(start=False, pipeline_depth=2)
        hA = [sched.submit_async(q) for q in qsA]
        sched.run_pending(collect=False)
        assert len(sched._inflight) == 1
        assert not any(h.done() for h in hA)
        hB = [sched.submit_async(q) for q in qsB]
        sched.run_pending()  # dispatch B (overlap), then drain both
        assert sched.stats_.overlapped_windows == 1
        assert [_flat(h.result()) for h in hA + hB] == [_flat(r) for r in solo]
        assert not sched._inflight
        assert sched._copy_stream is None  # side stream only on the card
        svc.close()

    def test_midflight_ingest_leaves_window_unchanged(self):
        rng = np.random.default_rng(90)
        svc = _corpus_service(seed=17)
        qs = _queries(91, 4)
        solo_before = [svc.submit([q])[0] for q in qs]
        sched = svc.scheduler(start=False)
        handles = [sched.submit_async(q) for q in qs]
        sched.run_pending(collect=False)  # in flight
        for i in range(12):  # enough to grow the continuous store
            sched.add(f"late{i}", "k", "v", _keys(rng),
                      rng.normal(size=N_ROWS).astype(np.float32))
        svc.index.plan(False), svc.index.plan(True)  # flush before collect
        assert svc.index.ingest_stats["group_store_grows"] >= 1
        sched.run_pending()  # collect the pre-ingest window
        assert [_flat(h.result()) for h in handles] == \
            [_flat(r) for r in solo_before]
        assert all(h.outcome().ok for h in handles)
        wide = svc.submit([qs[1]], top_k=len(svc))[0]
        assert any(m.table.startswith("late") for m, _, _ in wide)
        svc.close()


class TestTelemetry:
    def test_latency_window_quantiles(self):
        w = _LatencyWindow(cap=16)
        assert w.quantiles() is None
        for ms in range(1, 101):
            w.record(ms / 1e3)
        assert len(w) == 16  # only the last 16 samples (85..100 ms)
        q = w.quantiles()
        assert q["p50"] == pytest.approx(92.5, abs=0.01)
        assert q["p50"] <= q["p95"] <= q["p99"] <= 100.0

    def test_stats_shape_and_ratio(self):
        st = SchedulerStats()
        assert st.coalesce_ratio is None
        st.coalesced_queries, st.dispatched_buckets = 12, 3
        d = st.as_dict()
        assert d["coalesce_ratio"] == 4.0
        assert set(d["per_class"]) == {"interactive", "batch"}
        assert 0.0 <= d["occupancy"] <= 1.0

    def test_service_stats_surface(self):
        svc = _corpus_service(seed=21, n_cont=2, n_disc=0)
        assert svc.stats()["scheduler"] is None
        handle = svc.submit_async(_query(np.random.default_rng(8)))
        handle.wait(timeout=JOIN_TIMEOUT)
        tele = svc.stats()["scheduler"]
        assert tele["per_class"]["interactive"]["queries"] == 1
        assert tele["per_class"]["interactive"]["e2e_ms"]["p50"] > 0
        assert tele["windows"] >= 1
        svc.close()

    def test_queue_wait_recorded_per_class(self):
        svc = _corpus_service(seed=23, n_cont=2, n_disc=0)
        sched = svc.scheduler(start=False)
        h1 = sched.submit_async(_query(np.random.default_rng(9)))
        time.sleep(0.01)
        sched.run_pending()
        q = sched.stats_.queue_wait["interactive"].quantiles()
        assert q["p50"] >= 10.0  # waited at least the sleep
        assert h1.dispatched_at - h1.enqueued_at >= 0.01
        svc.close()


class TestLifecycle:
    def test_close_drains_and_refuses(self):
        svc = _corpus_service(seed=25, n_cont=2, n_disc=0)
        qs = _queries(95, 3, disc_every=0)
        handles = svc.submit_async(qs)
        thread = svc._scheduler._thread
        svc.close()
        assert not thread.is_alive()
        assert all(h.done() for h in handles)
        assert all(h.outcome().ok for h in handles)
        # a fresh scheduler can be attached after close
        h = svc.submit_async(qs[0])
        assert h.outcome(timeout=JOIN_TIMEOUT).ok
        svc.close()

    def test_submit_after_close_raises(self):
        svc = _corpus_service(seed=27, n_cont=2, n_disc=0)
        sched = svc.scheduler(start=False)
        sched.close()
        with pytest.raises(RuntimeError, match="closed"):
            sched.submit_async(_query(np.random.default_rng(3)))
        svc.close()

    def test_flush_serves_everything(self):
        svc = _corpus_service(seed=29, n_cont=2, n_disc=0)
        sched = svc.scheduler(start=False)
        handles = [sched.submit_async(q) for q in _queries(96, 4, disc_every=0)]
        sched.flush()
        assert all(h.done() for h in handles)
        svc.close()

    def test_scheduler_reconfigure_rejected(self):
        svc = _corpus_service(seed=31, n_cont=2, n_disc=0)
        svc.scheduler(start=False)
        with pytest.raises(ValueError, match="already attached"):
            svc.scheduler(window_ms=50.0)
        svc.close()

    def test_concurrent_first_use_attaches_one_scheduler(self):
        """Racing first-time submit_async calls share ONE scheduler."""
        svc = _corpus_service(seed=32, n_cont=2, n_disc=0)
        qs = _queries(99, 8, disc_every=0)
        barrier = threading.Barrier(8, timeout=JOIN_TIMEOUT)
        handles, seen = [None] * 8, [None] * 8

        def caller(c):
            barrier.wait()
            handles[c] = svc.submit_async(qs[c])
            seen[c] = svc._scheduler

        threads = [threading.Thread(target=caller, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        _join(threads)
        assert all(h.outcome(timeout=JOIN_TIMEOUT).ok for h in handles)
        assert len({id(s) for s in seen}) == 1
        st = svc._scheduler.stats_
        assert st.coalesced_queries == 8
        assert sum(st.queries.values()) == 8
        svc.close()


class TestIsolation:
    def test_quarantine_isolated_from_neighbors(self):
        svc = _corpus_service(seed=33, n_disc=0)
        qs = _queries(97, 4, disc_every=0)
        solo = [svc.submit([q])[0] for q in qs]
        bad = t_build(_keys(np.random.default_rng(4)),
                      np.zeros(N_ROWS, np.float32), n=SK_N, side="train")
        bad.mask[:] = False  # empty sketch: admission rejects it
        sched = svc.scheduler(start=False)
        handles = [sched.submit_async(q) for q in qs[:2]]
        hbad = sched.submit_async(bad)
        handles += [sched.submit_async(q) for q in qs[2:]]
        sched.run_pending()
        assert hbad.outcome().status == "quarantined"
        assert hbad.result() is None
        assert [_flat(h.result()) for h in handles] == [_flat(r) for r in solo]
        assert all(h.outcome().ok for h in handles)
        svc.close()

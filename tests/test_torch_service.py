"""The port's ``DiscoveryService`` against ``repro.core.discovery``'s
(mirrors ``tests/test_service.py`` and the single-device half of
``tests/test_discovery_service.py``).

One seeded corpus goes into a fresh index of each package, and the same
queues go through ``submit`` / ``submit_safe`` on both.  Held equal:
candidates, join sizes and rank order wherever score gaps exceed the
tolerance, plan signatures, bucket chunking, and the admission counters
``submitted``, ``quarantined``, ``batches``, ``split_batches``,
``retries``, ``fallbacks``, ``nonfinite_lanes``, ``lost_queries``,
``host_syncs``, ``fused_windows``, and the Q ladder's ``padded_lanes``
and ``q_buckets`` (both packages pad each bucket up the pow-2 ladder).
MI within rtol/atol 1e-5 (torch's digamma differs from jax's by
~2e-6).  Within the port (CPU), ``submit`` is held equal to looped
``SketchIndex.query`` value for value.
"""

import numpy as np
import pytest

from repro.core import hashing
from repro.core.discovery import DiscoveryService as JService
from repro.core.discovery import SketchIndex as JIndex
from repro.core.discovery import coalesce_queries as j_coalesce
from repro.core.discovery import plan_signature as j_plan_signature
from repro.core.sketch import build_sketch as j_build
from repro_torch.core.discovery import (
    MAX_Q_BUCKET,
    BatchedExecutor,
    DiscoveryService,
    PartitionedLocalExecutor,
    PlanCache,
    SketchIndex,
    coalesce_queries,
    plan_signature,
    stack_trains_host,
)
from repro_torch.core.sketch import build_sketch as t_build
from repro_torch.launch.mesh import make_host_mesh

TOL = 1e-5
N, ROWS, C = 64, 120, 48
MIN_JOIN = 8
PATHS = {
    "fused": dict(),
    "staged": dict(fused=False),
    "dense": dict(prefilter=False),
}
STAT_KEYS = ("submitted", "quarantined", "batches", "split_batches",
             "retries", "fallbacks", "nonfinite_lanes", "lost_queries",
             "host_syncs", "fused_windows", "padded_lanes", "q_buckets")

KEYS = hashing.murmur3_32_np(np.arange(ROWS, dtype=np.uint32), seed=np.uint32(3))


def _rows(seed=303):
    """C candidates: a third share the train keys, a third overlap them
    partly (join sizes around ``MIN_JOIN``), a third are disjoint; a
    quarter are discrete."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=ROWS).astype(np.float32)
    rows = []
    for c in range(C):
        kk = KEYS if c % 3 == 0 else hashing.murmur3_32_np(
            np.arange((c + 1) * 1000, (c + 1) * 1000 + ROWS, dtype=np.uint32),
            seed=np.uint32(3))
        if c % 3 == 1:
            kk = np.concatenate([KEYS[: 20 + c], kk[20 + c:]])
        a = (c % 7) / 7
        v = (a * y + (1 - a) * rng.normal(size=ROWS)).astype(np.float32)
        disc = c % 4 == 0
        if disc:
            v = np.digitize(v, [-1.0, -0.3, 0.3, 1.0]).astype(np.int64)
        rows.append((f"t{c:02d}", "k", "v", kk, v, disc))
    return rows, y


ROWS_, Y = _rows()


def _index(cls=SketchIndex, rows=ROWS_):
    ix = cls(n=N, device="cpu") if cls is SketchIndex else cls(n=N)
    for r in rows:
        ix.add(*r)
    return ix


def _queue(q, seed=6, disc_every=3, build=t_build):
    """q train sketches with discrete/continuous targets interleaved."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(q):
        yq = (Y + (0.1 + 0.2 * i) * rng.normal(size=ROWS)).astype(np.float32)
        disc = bool(disc_every) and i % disc_every == disc_every - 1
        v = np.digitize(yq, [-0.5, 0.0, 0.5]).astype(np.int64) if disc else yq
        out.append(build(KEYS, v, n=N, side="train", value_is_discrete=disc))
    return out


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


def _stats(svc):
    adm = svc.stats()["admission"]
    return {k: adm[k] for k in STAT_KEYS}


@pytest.fixture(scope="module")
def index():
    return _index()


@pytest.fixture(scope="module")
def j_index():
    return _index(JIndex)


# ---------------------------------------------------------------------------
# Planner pieces of the service
# ---------------------------------------------------------------------------


class TestChunkingAndPlans:
    @pytest.mark.parametrize("cap", [1, 3, 4, 64])
    def test_coalesce_chunks_match_reference(self, cap):
        rng = np.random.default_rng(cap)
        entries = [(i, ("sig", int(rng.integers(0, 3))), int(rng.integers(0, 2)))
                   for i in range(20)]
        if cap & (cap - 1):  # a full chunk has no rung on the pow-2 ladder
            for coalesce in (coalesce_queries, j_coalesce):
                with pytest.raises(ValueError, match="bucket cap"):
                    coalesce(entries, cap=cap)
            return
        got = coalesce_queries(entries, cap=cap)
        want = j_coalesce(entries, cap=cap)
        assert [(b.signature, b.chunk, b.priority, b.q_bucket) for b in got] == \
            [(b.signature, b.chunk, b.priority, b.q_bucket) for b in want]
        assert all(len(b.chunk) <= b.q_bucket <= cap for b in got)
        assert sorted(q for b in got for q in b.chunk) == list(range(20))

    def test_coalesce_priority_order(self):
        entries = [(i, ("sig_a",), 1 if i < 3 else 0) for i in range(6)]
        buckets = coalesce_queries(entries, cap=4)
        assert buckets[0].chunk == (3, 4, 5, 0) and buckets[0].priority == 0
        assert buckets[1].chunk == (1, 2) and buckets[1].priority == 1
        assert [b.q_bucket for b in buckets] == [4, 2]

    @pytest.mark.parametrize("y_disc", [False, True])
    def test_plan_signature_matches_reference(self, index, j_index, y_disc):
        assert plan_signature(index.plan(y_disc)) == \
            j_plan_signature(j_index.plan(y_disc))

    def test_plan_cache_keys_and_lru(self, index):
        cache = PlanCache(max_entries=2)
        build = lambda: index.plan(False)  # noqa: E731
        a = cache.lookup(1, False, 4, build)
        assert cache.lookup(1, False, 4, build) is a  # hit
        assert cache.lookup(1, False, 3, build) is not a  # another Q
        cache.lookup(2, False, 4, build)  # version bump -> new entry
        assert cache.stats["evictions"] == 1  # LRU cap of 2
        assert cache.stats["hits"] == 1 and cache.stats["misses"] == 3
        assert a.signature == plan_signature(index.plan(False))


# ---------------------------------------------------------------------------
# submit / submit_safe against the reference
# ---------------------------------------------------------------------------


class TestSubmitMatchesReference:
    @pytest.mark.parametrize("path", sorted(PATHS))
    def test_mixed_queue_matches_reference_and_loop(self, path):
        """Fresh services on both packages, two submits (the first grows
        the shortlist rungs on the fused path): results, layouts and
        counters equal; the port's submit equals its looped query."""
        t_svc = DiscoveryService(index=_index(), max_q_bucket=4)
        j_svc = JService(index=_index(JIndex), max_q_bucket=4)
        sks, j_sks = _queue(9), _queue(9, build=j_build)
        for _ in range(2):
            got = t_svc.submit(sks, top_k=12, min_join=MIN_JOIN, **PATHS[path])
            want = j_svc.submit(j_sks, top_k=12, min_join=MIN_JOIN, **PATHS[path])
            assert_same_results(got, want)
            assert _stats(t_svc) == _stats(j_svc)
        loop = [t_svc.index.query(sk, top_k=12, min_join=MIN_JOIN, **PATHS[path])
                for sk in sks]
        assert [_flat(g) for g in got] == [_flat(w) for w in loop]
        adm = t_svc.stats()["admission"]
        assert adm["signatures"] == 2  # one per target dtype
        assert adm["split_batches"] == 2 * 1  # 6 continuous > cap of 4, per submit
        assert adm["padded_lanes"] == 2 * 1  # the 3 discrete ride rung 4
        assert adm["q_buckets"] == [2, 4]  # chunks 4 + 2 and 3 -> 4
        assert any(len(r) > 3 for r in got)

    def test_submit_safe_matches_reference(self, index, j_index):
        t_svc = DiscoveryService(index=_index())
        j_svc = JService(index=_index(JIndex))
        res, outs = t_svc.submit_safe(_queue(5), top_k=12, min_join=MIN_JOIN)
        j_res, j_outs = j_svc.submit_safe(_queue(5, build=j_build), top_k=12,
                                          min_join=MIN_JOIN)
        assert_same_results(res, j_res)
        assert [(o.status, o.rung) for o in outs] == \
            [(o.status, o.rung) for o in j_outs]
        assert _stats(t_svc) == _stats(j_svc)

    def test_hybrid_rank_matches_reference(self, index, j_index):
        got = DiscoveryService(index=index).submit(
            _queue(4), top_k=12, min_join=MIN_JOIN, rank="hybrid")
        want = JService(index=j_index).submit(
            _queue(4, build=j_build), top_k=12, min_join=MIN_JOIN, rank="hybrid")
        assert_same_results(got, want)
        plain = DiscoveryService(index=index).submit(_queue(4), top_k=12,
                                                     min_join=MIN_JOIN)
        assert [_flat(g) for g in got] != [_flat(p) for p in plain]

    def test_interleaved_ingest_queue(self):
        """add between submits: the next submit serves the grown corpus
        on both packages."""
        t_svc = DiscoveryService(index=_index(rows=ROWS_[:20]), max_q_bucket=8)
        j_svc = JService(index=_index(JIndex, rows=ROWS_[:20]), max_q_bucket=8)
        sks, j_sks = _queue(5), _queue(5, build=j_build)
        t_svc.submit(sks, top_k=6, min_join=MIN_JOIN)
        j_svc.submit(j_sks, top_k=6, min_join=MIN_JOIN)
        for r in ROWS_[20:]:
            t_svc.add(*r)
            j_svc.add(*r)
        got = t_svc.submit(sks, top_k=6, min_join=MIN_JOIN)
        want = j_svc.submit(j_sks, top_k=6, min_join=MIN_JOIN)
        assert_same_results(got, want)
        assert _stats(t_svc) == _stats(j_svc)
        loop = [t_svc.index.query(sk, top_k=6, min_join=MIN_JOIN) for sk in sks]
        assert [_flat(g) for g in got] == [_flat(w) for w in loop]
        assert len(t_svc) == C


# ---------------------------------------------------------------------------
# The port's own contracts
# ---------------------------------------------------------------------------


class TestSubmitContracts:
    def test_q_cap_validation_and_non_pow2_chunks(self, index, j_index):
        for cap in (0, 5):  # the cap is a rung of the pow-2 ladder
            with pytest.raises(ValueError, match="max_q_bucket"):
                DiscoveryService(index=index, max_q_bucket=cap)
            with pytest.raises(ValueError, match="max_q_bucket"):
                JService(index=j_index, max_q_bucket=cap)
        svc = DiscoveryService(index=index, max_q_bucket=4)
        sks = _queue(11, disc_every=0)  # chunks of 4, 4 and 3
        got = svc.submit(sks, top_k=6, min_join=MIN_JOIN)
        assert svc.admission.q_buckets == {4}
        assert svc.admission.split_batches == 2
        assert svc.admission.padded_lanes == 1
        loop = [index.query(sk, top_k=6, min_join=MIN_JOIN) for sk in sks]
        assert [_flat(g) for g in got] == [_flat(w) for w in loop]
        assert DiscoveryService(index=index).max_q_bucket == MAX_Q_BUCKET

    def test_non_default_k(self, index):
        """The service's k flows into every scorer."""
        svc = DiscoveryService(index=index, k=5, max_q_bucket=4)
        sks = _queue(5)
        got = svc.submit(sks, top_k=6, min_join=MIN_JOIN)
        want = [index.query(sk, top_k=6, min_join=MIN_JOIN, k=5) for sk in sks]
        assert [_flat(g) for g in got] == [_flat(w) for w in want]
        base = [index.query(sk, top_k=6, min_join=MIN_JOIN) for sk in sks]
        assert any(_flat(g) != _flat(b) for g, b in zip(got, base))

    def test_submit_empty_and_single(self, index):
        svc = DiscoveryService(index=index)
        assert svc.submit([]) == []
        assert svc.submit_safe([]) == ([], [])
        sk = _queue(1)[0]
        assert _flat(svc.submit([sk], top_k=3, min_join=MIN_JOIN)[0]) == \
            _flat(index.query(sk, top_k=3, min_join=MIN_JOIN))

    def test_repeat_traffic_hits_plan_cache(self, index):
        svc = DiscoveryService(index=index, max_q_bucket=8)
        sks = _queue(6)
        svc.submit(sks, top_k=3, min_join=MIN_JOIN)
        svc.submit(sks, top_k=3, min_join=MIN_JOIN)  # rungs settled
        misses = svc.plan_cache.stats["misses"]
        svc.submit(sks, top_k=3, min_join=MIN_JOIN)
        svc.submit(list(reversed(sks)), top_k=3, min_join=MIN_JOIN)
        assert svc.plan_cache.stats["misses"] == misses  # all hits

    def test_later_slices_raise(self, index, j_index):
        # The mesh is ported: a mesh submit ranks as the batched one.
        mesh = make_host_mesh(devices=["cpu"] * 4)
        assert DiscoveryService(index=index, mesh=mesh).submit(
            _queue(3), top_k=5, min_join=MIN_JOIN) == \
            DiscoveryService(index=index).submit(_queue(3), top_k=5,
                                                 min_join=MIN_JOIN)
        svc = DiscoveryService(index=index)
        # The phase-0 gate is ported: a gated submit equals the reference's.
        gated = svc.submit(_queue(3), top_k=5, min_join=MIN_JOIN,
                           min_containment=0.2)
        assert all(gated)
        assert_same_results(gated, JService(index=j_index).submit(
            _queue(3, build=j_build), top_k=5, min_join=MIN_JOIN,
            min_containment=0.2))
        with pytest.raises(ValueError, match="rank"):
            svc.submit(_queue(1), rank="mae")

    def test_stats_surface(self, index):
        svc = DiscoveryService(index=index)
        svc.submit(_queue(3), top_k=3, min_join=MIN_JOIN)
        st = svc.stats()
        assert set(st) == {"admission", "plan_cache", "compiled_programs",
                           "ingest", "tiers", "scheduler"}
        assert st["compiled_programs"] >= 1
        assert st["scheduler"] is None
        assert st["admission"]["cands_filtered_out"] >= 0
        assert st["ingest"]["pending_rows"] == 0

    def test_default_device_is_the_card(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            DiscoveryService(n=N)
        cpu = SketchIndex(n=N, device="cpu")
        assert DiscoveryService(index=cpu).index.device.type == "cpu"


class TestIngestBetweenDispatchAndCollect:
    """The port has no plan leases: an ingest between a window's dispatch
    and its collect (in-place append, or a grow into new tensors) must
    leave the window's results unchanged."""

    @pytest.mark.parametrize("path", sorted(PATHS))
    @pytest.mark.parametrize("n_late", [1, 40])  # within the bucket / grows it
    def test_results_unchanged(self, path, n_late):
        rows = ROWS_[:24]
        svc = DiscoveryService(index=_index(rows=rows))
        sks = _queue(5)
        opts = dict(top_k=12, min_join=MIN_JOIN, **PATHS[path])
        solo = svc.submit(sks, **opts)
        win = svc._window_dispatch(sks, isolate=True, **{"prefilter": None,
                                                         **opts})
        grows = svc.index.ingest_stats["group_store_grows"]
        for i in range(n_late):
            name, kc, vc, kk, v, disc = ROWS_[(24 + i) % C]
            svc.add(f"late{i}", kc, vc, kk, v, disc)
        svc.index.plan(False), svc.index.plan(True)  # flush now
        if n_late > 1:
            assert svc.index.ingest_stats["group_store_grows"] > grows
        res, outs = svc._window_collect(win)
        assert all(o.ok for o in outs)
        assert [_flat(r) for r in res] == [_flat(r) for r in solo]
        # the next submit serves the grown corpus
        grown = svc.submit(sks, top_k=12, min_join=MIN_JOIN, **PATHS[path])
        loop = [svc.index.query(sk, top_k=12, min_join=MIN_JOIN, **PATHS[path])
                for sk in sks]
        assert [_flat(g) for g in grown] == [_flat(w) for w in loop]


class TestExecutorsAndIngest:
    """Single-device half of ``tests/test_discovery_service.py``."""

    @pytest.mark.parametrize("y_disc", [False, True])
    def test_partitioned_and_batched_identical(self, index, y_disc):
        sks = [s for s in _queue(6) if s.value_is_discrete == y_disc][:3]
        trains = stack_trains_host(sks, "cpu")
        plan = index.plan(y_disc)
        mi_p, js_p = PartitionedLocalExecutor().execute(plan, trains)
        mi_b, js_b = BatchedExecutor().execute(plan, trains)
        np.testing.assert_array_equal(mi_p, mi_b)
        np.testing.assert_array_equal(js_p, js_b)

    def test_add_after_submit_moves_only_new_rows(self):
        svc = DiscoveryService(index=_index(rows=ROWS_[:10]))
        svc.submit(_queue(2, disc_every=0), top_k=3, min_join=MIN_JOIN)
        assert svc.stats()["ingest"]["group_h2d_rows"] == 10
        svc.add(*ROWS_[10])
        svc.submit(_queue(2, disc_every=0), top_k=3, min_join=MIN_JOIN)
        assert svc.stats()["ingest"]["group_h2d_rows"] == 11

    @pytest.mark.parametrize("y_disc", [False, True])
    def test_incremental_equals_rebuild(self, y_disc):
        """Interleaved add/serve cycles serve what a from-scratch index
        of the same candidates serves."""
        sk = [s for s in _queue(3) if s.value_is_discrete == y_disc][0]
        svc = DiscoveryService(index=_index(rows=ROWS_[:8]))
        svc.submit([sk], top_k=5, min_join=MIN_JOIN)  # flush mid-growth
        for r in ROWS_[8:]:
            svc.add(*r)
        got = svc.submit([sk], top_k=5, min_join=MIN_JOIN)[0]
        want = _index().query(sk, top_k=5, min_join=MIN_JOIN)
        assert _flat(got) == _flat(want)

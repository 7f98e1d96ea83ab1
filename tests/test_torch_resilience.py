"""The port's resilience layer against ``repro.core.discovery.resilience``
(mirrors ``tests/test_resilience.py``):

  (a) admission validation quarantines malformed sketches with the
      reference's error codes while the rest of the queue serves
      unchanged;
  (b) an injected dispatch/collect fault retries with bounded backoff,
      then degrades to the reference rung, every other bucket untouched,
      with the reference's retry / fallback / failure counts;
  (c) non-finite MI lanes are recomputed through the materialized
      estimators — the ``scores`` site corrupts the same lanes as in the
      JAX package, and the fence demotes the same candidates;
  (d) ingest stays transactional under faults, and ``AdmissionStats``
      stays consistent across mid-submit failures.

One seeded corpus goes through both packages.  Within the port (CPU),
results after recovery or fencing are held equal to the clean submit,
value for value: fused and materialized MI are bit-identical here.
Against the JAX package: candidates and join sizes equal, MI within
rtol/atol 1e-5 (torch's digamma differs from jax's by ~2e-6), and the
recovery counters equal.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import hashing
from repro.core.discovery import DiscoveryService as JService
from repro.core.discovery import RetryPolicy as JRetryPolicy
from repro.core.discovery import SketchIndex as JIndex
from repro.core.discovery import inject_faults as j_inject_faults
from repro.core.discovery import resilience as j_resilience
from repro.core.discovery import validate_query as j_validate_query
from repro.core.sketch import build_sketch as j_build
from repro_torch.core.discovery import (
    BatchedExecutor,
    DiscoveryService,
    InjectedFault,
    RetryPolicy,
    SketchIndex,
    fence_nonfinite,
    inject_faults,
    stack_trains_host,
    validate_query,
)
from repro_torch.core.discovery import executors as _ex
from repro_torch.core.discovery import resilience
from repro_torch.core.discovery.planner import PlanCache
from repro_torch.core.discovery.resilience import FaultPlan
from repro_torch.core.sketch import build_sketch as t_build
from _torch_threads import one_thread  # noqa: F401 (autouse)

TOL = 1e-5
N_ROWS = 800
SK_N = 64
KEYS = np.asarray(hashing.murmur3_32_np(np.arange(N_ROWS, dtype=np.uint32),
                                        seed=np.uint32(9)))
Y = np.random.default_rng(1000).normal(size=N_ROWS)

FAST_RETRY = RetryPolicy(max_retries=2, sleep=lambda s: None)
J_FAST_RETRY = JRetryPolicy(max_retries=2, sleep=lambda s: None)

# The counters both packages must agree on, the Q ladder's included.
STAT_KEYS = ("submitted", "quarantined", "batches", "split_batches",
             "retries", "fallbacks", "nonfinite_lanes", "lost_queries",
             "host_syncs", "fused_windows", "failed_buckets", "padded_lanes",
             "q_buckets")


def _rows():
    rng = np.random.default_rng(1001)
    rows = [(f"cont{i}", "k", "v", KEYS,
             (Y + (0.2 + i) * rng.normal(size=N_ROWS)).astype(np.float32), False)
            for i in range(3)]
    rows += [(f"disc{i}", "k", "v", KEYS, rng.integers(0, 4 + i, size=N_ROWS), True)
             for i in range(2)]
    return rows


ROWS = _rows()


def _index(cls=SketchIndex):
    ix = cls(n=SK_N, device="cpu") if cls is SketchIndex else cls(n=SK_N)
    for r in ROWS:
        ix.add(*r)
    return ix


def _train(v, disc, build=t_build):
    return build(KEYS, v, n=SK_N, method="tupsk", side="train",
                 value_is_discrete=disc)


def _mixed_queue(q, seed=7, disc_every=3, build=t_build):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(q):
        noisy = Y + (0.1 + 0.25 * i) * rng.normal(size=N_ROWS)
        if i % disc_every == disc_every - 1:
            out.append(_train((noisy > 0).astype(np.int64), True, build))
        else:
            out.append(_train(noisy.astype(np.float32), False, build))
    return out


def _flat(res):
    return [(m.table, mi, js) for m, mi, js in res]


def assert_same_results(got, want):
    """Port vs JAX: equal candidates and join sizes, MI allclose; two
    entries may trade places only where their scores are within
    tolerance."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        g, w = _flat(g), _flat(w)
        assert len(g) == len(w)
        w_by = {t: (mi, js) for t, mi, js in w}
        for (tg, mg, jg), (tw, mw, jw) in zip(g, w):
            assert np.isclose(mg, mw, rtol=TOL, atol=TOL), (tg, mg, tw, mw)
            assert tg in w_by and w_by[tg][1] == jg
            if tg != tw:
                assert np.isclose(w_by[tg][0], mw, rtol=TOL, atol=TOL)


def _same_stats(t_svc, j_svc):
    t, j = t_svc.stats()["admission"], j_svc.stats()["admission"]
    assert {k: t[k] for k in STAT_KEYS} == {k: j[k] for k in STAT_KEYS}


def _service(index, **kw):
    kw.setdefault("retry_policy", FAST_RETRY)
    return DiscoveryService(index=index, **kw)


def _j_service(index, **kw):
    kw.setdefault("retry_policy", J_FAST_RETRY)
    return JService(index=index, **kw)


def _poison(kind: str, build=t_build):
    """A query sketch that must be quarantined, by failure mode."""
    if kind == "nonfinite_values":
        sk = _train(np.ones(N_ROWS, np.float32), False, build)
        vals = sk.values.copy()
        vals[: max(1, sk.size // 4)] = np.nan
        return dataclasses.replace(sk, values=vals), "nonfinite_values"
    if kind == "empty_sketch":
        sk = _train(Y.astype(np.float32), False, build)
        return dataclasses.replace(sk, mask=np.zeros_like(sk.mask)), "empty_sketch"
    if kind == "capacity_mismatch":
        sk = build(KEYS, Y.astype(np.float32), n=SK_N // 2, method="tupsk",
                   side="train", value_is_discrete=False)
        return sk, "capacity_mismatch"
    raise ValueError(kind)


@pytest.fixture(scope="module")
def index():
    return _index()


@pytest.fixture(scope="module")
def j_index():
    return _index(JIndex)


# ---------------------------------------------------------------------------
# Fault-injection harness semantics
# ---------------------------------------------------------------------------


class TestFaultHarness:
    def test_unknown_site_rejected(self):
        with pytest.raises(ValueError, match="unknown fault site"):
            FaultPlan({"warp_core": "all"})
        # the gate's site is a known one
        FaultPlan({"tiered_dispatch": "all"})

    def test_no_nesting(self):
        with inject_faults({"collect": 1}):
            with pytest.raises(RuntimeError, match="does not nest"):
                with inject_faults({"collect": 1}):
                    pass

    def test_unarmed_is_noop(self):
        resilience.maybe_fault("collect")  # no active plan -> no raise

    def test_int_schedule_fails_first_n(self):
        plan = FaultPlan({"collect": 2})
        for _ in range(2):
            with pytest.raises(InjectedFault):
                plan.check("collect", None)
        plan.check("collect", None)  # third invocation passes
        assert plan.fired == {"collect": 2}

    def test_index_schedule(self):
        plan = FaultPlan({"collect": [1]})
        plan.check("collect", None)
        with pytest.raises(InjectedFault):
            plan.check("collect", None)
        plan.check("collect", None)

    def test_scoped_key_only_hits_its_scope(self):
        plan = FaultPlan({"dispatch@batched": "all"})
        plan.check("dispatch", "other")  # other scope: passes
        with pytest.raises(InjectedFault):
            plan.check("dispatch", "batched")

    def test_unscoped_key_hits_every_scope(self):
        plan = FaultPlan({"dispatch": "all"})
        with pytest.raises(InjectedFault):
            plan.check("dispatch", "batched")
        with pytest.raises(InjectedFault):
            plan.check("dispatch", "other")


# ---------------------------------------------------------------------------
# Admission validation + quarantine
# ---------------------------------------------------------------------------


class TestValidation:
    def test_valid_sketch_passes(self, index):
        assert validate_query(_train(Y.astype(np.float32), False), index) is None

    @pytest.mark.parametrize(
        "kind", ["nonfinite_values", "empty_sketch", "capacity_mismatch"]
    )
    def test_error_codes_match_reference(self, index, j_index, kind):
        sk, code = _poison(kind)
        got = validate_query(sk, index)
        assert got is not None and got[0] == code
        j_sk, _ = _poison(kind, j_build)
        assert j_validate_query(j_sk, j_index)[0] == code

    def test_not_a_sketch(self, index):
        got = validate_query(object(), index)
        assert got is not None and got[0] == "invalid_sketch"

    def test_ragged_arrays(self, index):
        sk = _train(Y.astype(np.float32), False)
        bad = dataclasses.replace(sk, mask=np.ones(3, bool))
        got = validate_query(bad, index)
        assert got is not None and got[0] == "invalid_sketch"

    def test_unknown_dtype_flag(self, index):
        sk = _train(Y.astype(np.float32), False)
        bad = dataclasses.replace(sk, value_is_discrete=1)
        got = validate_query(bad, index)
        assert got is not None and got[0] == "unknown_dtype"

    def test_quarantine_preserves_other_results(self, index):
        svc = _service(index)
        queue = _mixed_queue(6)
        baseline = svc.submit(queue, top_k=5, min_join=4)
        bad, code = _poison("nonfinite_values")
        res, outs = svc.submit_safe(queue + [bad], top_k=5, min_join=4)
        assert res[-1] is None
        assert outs[-1].status == "quarantined"
        assert outs[-1].error == code and not outs[-1].ok
        assert [_flat(r) for r in res[:-1]] == [_flat(r) for r in baseline]
        assert all(o.ok for o in outs[:-1])
        assert svc.admission.quarantined == 1

    def test_all_quarantined(self, index):
        svc = _service(index)
        bad, _ = _poison("empty_sketch")
        res, outs = svc.submit_safe([bad], top_k=5)
        assert res == [None]
        assert outs[0].status == "quarantined"
        assert svc.admission.batches == 0


# ---------------------------------------------------------------------------
# Retry + executor-ladder fallback, against the JAX package
# ---------------------------------------------------------------------------


RECOVERY_CASES = {
    # name: (fault schedule, submit options, expected rung of faulted queries)
    "transient_shortlist": ({"shortlist_dispatch": [0]}, {"fused": False}, "batched"),
    "persistent_shortlist": ({"shortlist_dispatch": "all"}, {"fused": False},
                             "reference"),
    "stack_h2d": ({"stack_h2d": [0]}, {"fused": False}, "batched"),
    "prefilter_dispatch": ({"prefilter_dispatch": [0]}, {"fused": False}, "batched"),
    "collect": ({"collect": [2]}, {"fused": False}, "batched"),
    "dense_dispatch": ({"dispatch": [0]}, {"prefilter": False}, "batched"),
    "fused_dispatch": ({"fused_dispatch": [0]}, {}, "batched"),
    "fused_and_prefilter": ({"fused_dispatch": "all", "prefilter_dispatch": "all"},
                            {}, "reference"),
}


class TestRecovery:
    @pytest.mark.parametrize("case", sorted(RECOVERY_CASES))
    def test_recovery_matches_reference(self, index, j_index, case):
        schedule, opts, rung = RECOVERY_CASES[case]
        queue = _mixed_queue(5)
        svc = _service(index)
        base = svc.submit(queue, top_k=5, min_join=4, **opts)
        with inject_faults(schedule) as plan:
            res, outs = svc.submit_safe(queue, top_k=5, min_join=4, **opts)
        assert all(o.ok for o in outs)
        assert [_flat(r) for r in res] == [_flat(r) for r in base]
        assert rung in {o.rung for o in outs}
        assert svc.admission.retries >= 1
        assert svc.admission.lost_queries == 0

        j_svc = _j_service(j_index)
        j_base = j_svc.submit(_mixed_queue(5, build=j_build), top_k=5,
                              min_join=4, **opts)
        with j_inject_faults(schedule) as j_plan:
            j_res, j_outs = j_svc.submit_safe(_mixed_queue(5, build=j_build),
                                              top_k=5, min_join=4, **opts)
        assert plan.fired == j_plan.fired
        assert [(o.status, o.rung, o.retries, o.fallbacks) for o in outs] == \
            [(o.status, o.rung, o.retries, o.fallbacks) for o in j_outs]
        assert_same_results(res, j_res)
        assert_same_results(base, j_base)
        _same_stats(svc, j_svc)

    def test_persistent_fault_counts(self, index):
        svc = _service(index)
        with inject_faults({"shortlist_dispatch": "all"}):
            _, outs = svc.submit_safe(_mixed_queue(5), top_k=5, min_join=4,
                                      fused=False)
        assert {o.rung for o in outs} == {"reference"}
        st = svc.admission
        # 2 dtype buckets x (2 retries on the batched rung, then one
        # descent to the hook-free reference loop).
        assert st.failed_buckets == 2
        assert st.retries == 4 and st.fallbacks == 2

    def test_ladder_exhaustion_yields_failed_outcomes(self, index, monkeypatch):
        queue = _mixed_queue(5)
        svc = _service(index)
        base = svc.submit(queue, top_k=5, min_join=4)
        delivered = svc.admission.batches

        def boom(*a, **kw):
            raise RuntimeError("reference rung down")

        monkeypatch.setattr(_ex.PartitionedLocalExecutor, "execute", boom)
        with inject_faults({"stack_h2d": "all"}):
            res, outs = svc.submit_safe(queue, top_k=5, min_join=4)
        assert all(r is None for r in res)
        assert all(o.status == "failed" for o in outs)
        assert all(o.error == "ladder_exhausted" for o in outs)
        st = svc.admission
        assert st.lost_queries == len(queue)
        assert st.batches == delivered  # nothing delivered -> nothing committed
        monkeypatch.undo()
        # The service is not wedged: the next clean submit delivers.
        res2, outs2 = svc.submit_safe(queue, top_k=5, min_join=4)
        assert all(o.ok for o in outs2)
        assert [_flat(r) for r in res2] == [_flat(r) for r in base]

    def test_plan_failure_isolated(self):
        svc = _service(SketchIndex(n=SK_N, device="cpu"))  # empty corpus
        res, outs = svc.submit_safe([_train(Y.astype(np.float32), False)], top_k=5)
        assert res == [None]
        assert outs[0].status == "failed"
        assert outs[0].error == "plan_failed"


# ---------------------------------------------------------------------------
# Numeric fences
# ---------------------------------------------------------------------------


class TestNumericFence:
    def test_fence_repairs_bit_identically(self, index):
        sk = _train(Y.astype(np.float32), False)
        plan = index.plan(False)
        mi, js = BatchedExecutor(k=3).execute(plan, stack_trains_host([sk], "cpu"))
        v, jrow = mi[0].copy(), js[0]
        lanes = np.flatnonzero(jrow >= 4)[:3]
        assert lanes.size, "corpus must have joinable candidates"
        v[lanes] = np.nan
        fixed, n = fence_nonfinite(v, np.arange(len(index)), jrow, index, sk, 4, 3)
        assert n == lanes.size
        np.testing.assert_array_equal(fixed, mi[0])

    def test_reference_pairs_span_estimators(self, index):
        """Pairs of several estimator groups in one call: each equals the
        batched executor's lane (one join + materialized call per group)."""
        for y_disc in (False, True):
            v = (Y > 0).astype(np.int64) if y_disc else Y.astype(np.float32)
            sk = _train(v, y_disc)
            mi, _ = BatchedExecutor(k=3).execute(index.plan(y_disc),
                                                 stack_trains_host([sk], "cpu"))
            ids = np.array([4, 0, 3, 2])  # disc, cont, disc, cont
            got = resilience.reference_score_pairs(index, sk, ids, 3)
            np.testing.assert_array_equal(got, mi[0][ids])

    def test_fence_ignores_ineligible_lanes(self, index):
        sk = _train(Y.astype(np.float32), False)
        C = len(index)
        v = np.full(C, np.nan, np.float32)
        js = np.zeros(C, np.int32)
        _, n = fence_nonfinite(v, np.arange(C), js, index, sk, 4, 3)
        assert n == 0

    def test_scores_site_matches_reference_lanes(self, index, j_index,
                                                 monkeypatch):
        """The same seed corrupts the same lanes in both packages, the
        fence demotes the same candidates, and the repaired rankings
        equal the clean submit."""
        demoted = {"t": [], "j": []}
        for mod, key in ((resilience, "t"), (j_resilience, "j")):
            real = mod.reference_score_pairs

            def spy(ix, sk, ids, k, real=real, key=key):
                demoted[key].append(sorted(int(i) for i in ids))
                return real(ix, sk, ids, k)

            monkeypatch.setattr(mod, "reference_score_pairs", spy)
        queue = _mixed_queue(5)
        svc = _service(index)
        base = svc.submit(queue, top_k=5, min_join=4)
        with inject_faults({"scores": 2}, seed=3) as plan:
            res, outs = svc.submit_safe(queue, top_k=5, min_join=4)
        assert plan.corrupted > 0
        assert [_flat(r) for r in res] == [_flat(r) for r in base]
        assert sum(o.nonfinite_lanes for o in outs) == plan.corrupted
        assert svc.admission.nonfinite_lanes == plan.corrupted

        j_svc = _j_service(j_index)
        j_queue = _mixed_queue(5, build=j_build)
        j_svc.submit(j_queue, top_k=5, min_join=4)
        with j_inject_faults({"scores": 2}, seed=3) as j_plan:
            j_res, j_outs = j_svc.submit_safe(j_queue, top_k=5, min_join=4)
        assert plan.corrupted == j_plan.corrupted
        assert demoted["t"] == demoted["j"]
        assert [o.nonfinite_lanes for o in outs] == \
            [o.nonfinite_lanes for o in j_outs]
        assert_same_results(res, j_res)


# ---------------------------------------------------------------------------
# Transactional ingest
# ---------------------------------------------------------------------------


class _FakeColumn:
    def __init__(self, values, discrete, poisoned=False):
        self._values = values
        self._discrete = discrete
        self._poisoned = poisoned

    @property
    def is_discrete(self):
        return self._discrete

    def key_codes(self, seed=0):
        return KEYS

    def value_array(self):
        if self._poisoned:
            raise RuntimeError("storage backend lost this column")
        return self._values


class _FakeTable:
    """Duck-typed Table: key column + value columns, one optionally
    poisoned mid-iteration."""

    name = "faketab"

    def __init__(self, cols):
        self._cols = {"k": _FakeColumn(KEYS, True), **cols}

    def __getitem__(self, name):
        return self._cols[name]

    def pairs(self, key_column):
        return [(key_column, c) for c in self._cols if c != key_column]


class TestTransactionalIngest:
    def _table(self, poison_middle):
        return _FakeTable({
            "a": _FakeColumn(Y.astype(np.float32), False),
            "b": _FakeColumn(Y.astype(np.float32), False, poisoned=poison_middle),
            "c": _FakeColumn(np.random.default_rng(5).integers(0, 4, N_ROWS), True),
        })

    def test_poisoned_middle_column_rolls_back(self):
        index = _index()
        sk = _train(Y.astype(np.float32), False)
        before_len, before_version = len(index), index._version
        before_res = _flat(index.query(sk, top_k=5, min_join=4))
        with pytest.raises(RuntimeError, match="lost this column"):
            index.add_table(self._table(poison_middle=True), "k")
        assert len(index) == before_len
        assert index._version == before_version
        assert _flat(index.query(sk, top_k=5, min_join=4)) == before_res

    def test_capacity_poison_rolls_back(self):
        index = _index()
        tab = self._table(poison_middle=False)
        tab._cols["b"] = _FakeColumn(Y[: N_ROWS // 2].astype(np.float32), False)
        tab._cols["b"].key_codes = lambda seed=0: KEYS[: N_ROWS // 2]
        before_len = len(index)
        with pytest.raises(Exception):
            index.add_table(tab, "k")
        assert len(index) == before_len

    def test_clean_table_commits_all(self):
        index = _index()
        before = len(index)
        index.add_table(self._table(poison_middle=False), "k")
        assert len(index) == before + 3
        assert [m.table for m in index.meta[-3:]] == ["faketab"] * 3

    def test_flush_fault_leaves_store_consistent(self):
        index = _index()
        sk = _train(Y.astype(np.float32), False)
        index.query(sk, top_k=5, min_join=4)
        index.add("late", "k", "v", KEYS,
                  (Y + 0.05 * np.random.default_rng(6).normal(size=N_ROWS))
                  .astype(np.float32), False)
        rows_before = index.ingest_stats["group_h2d_rows"]
        with inject_faults({"flush": "all"}):
            with pytest.raises(InjectedFault):
                index.query(sk, top_k=5, min_join=4)
        # The fault fired before any store mutation.
        assert index.ingest_stats["group_h2d_rows"] == rows_before
        after = _flat(index.query(sk, top_k=5, min_join=4))
        assert len(index) == 6  # 3 cont + 2 disc + "late"
        assert index.ingest_stats["pending_rows"] == 0
        assert "late" in [t for t, _, _ in after]


# ---------------------------------------------------------------------------
# Stats consistency
# ---------------------------------------------------------------------------


class TestStatsConsistency:
    def test_legacy_submit_counts_failure_and_stays_consistent(self, index):
        svc = _service(index)
        rng = np.random.default_rng(8)
        queue = [_train((Y + 0.3 * rng.normal(size=N_ROWS)).astype(np.float32),
                        False) for _ in range(3)]
        with inject_faults({"shortlist_dispatch": "all"}):
            with pytest.raises(InjectedFault):
                svc.submit(queue, top_k=5, min_join=4, fused=False)
        st = svc.admission
        # Arrival counters committed, delivery counters untouched.
        assert st.submits == 1 and st.submitted == 3
        assert st.failed_buckets == 1
        assert st.batches == 0 and st.padded_lanes == 0
        assert st.prefiltered == 0 and st.cands_considered == 0
        # A clean retry delivers and commits exactly one bucket.
        svc.submit(queue, top_k=5, min_join=4)
        assert st.batches == 1
        assert st.padded_lanes == 1  # Q=3 rides rung 4, as in the reference
        assert st.q_buckets == {4}
        assert st.prefiltered == 3

    def test_plan_cache_counts_build_failures(self):
        cache = PlanCache(4)

        def boom():
            raise RuntimeError("no plan for you")

        with pytest.raises(RuntimeError):
            cache.lookup(0, False, 4, boom)
        assert cache.build_failures == 1
        assert cache.misses == 0 and len(cache) == 0
        assert cache.stats["build_failures"] == 1


# ---------------------------------------------------------------------------
# End-to-end: Q=32 mixed burst, one poisoned query, one bucket fault
# ---------------------------------------------------------------------------


class TestEndToEndIsolation:
    @pytest.mark.parametrize("kind", ["nonfinite_values", "empty_sketch",
                                      "capacity_mismatch"])
    def test_q32_burst_poison_plus_bucket_fault(self, index, j_index, kind):
        poison_at = 4  # a continuous query (i % 3 != 2)
        queue = _mixed_queue(32, seed=11)
        queue[poison_at], code = _poison(kind)
        svc = _service(index)
        expected = {i: _flat(index.query(queue[i], top_k=5, min_join=4, k=svc.k))
                    for i in range(32) if i != poison_at}
        # shortlist_dispatch invocation order: the continuous bucket's
        # phase-2 dispatch is 0, the discrete bucket's is 1; [0, 2, 3]
        # kills the continuous bucket's primary attempt and both its
        # batched-rung retries, forcing one descent to the reference rung.
        sched = {"shortlist_dispatch": [0, 2, 3]}
        with inject_faults(sched) as plan:
            res, outs = svc.submit_safe(queue, top_k=5, min_join=4, fused=False)
        assert plan.fired == {"shortlist_dispatch": 3}
        assert res[poison_at] is None
        assert outs[poison_at].status == "quarantined"
        assert outs[poison_at].error == code
        for i, want in expected.items():
            assert outs[i].ok, outs[i]
            assert _flat(res[i]) == want, f"query {i} diverged"
            if i % 3 == 2:
                assert (outs[i].rung, outs[i].retries, outs[i].fallbacks) == \
                    ("batched", 0, 0)
            else:
                assert (outs[i].rung, outs[i].retries, outs[i].fallbacks) == \
                    ("reference", 2, 1)
        st = svc.stats()["admission"]
        assert (st["quarantined"], st["failed_buckets"], st["retries"],
                st["fallbacks"], st["lost_queries"], st["submitted"],
                st["batches"], st["nonfinite_lanes"]) == (1, 1, 2, 1, 0, 31, 2, 0)

        j_queue = _mixed_queue(32, seed=11, build=j_build)
        j_queue[poison_at], _ = _poison(kind, j_build)
        j_svc = _j_service(j_index)
        with j_inject_faults(sched):
            j_res, j_outs = j_svc.submit_safe(j_queue, top_k=5, min_join=4,
                                              fused=False)
        assert [(o.status, o.error, o.rung, o.retries, o.fallbacks)
                for o in outs] == \
            [(o.status, o.error, o.rung, o.retries, o.fallbacks) for o in j_outs]
        assert_same_results(res, j_res)
        _same_stats(svc, j_svc)


# ---------------------------------------------------------------------------
# Scheduler chaos: the micro-batch tier's fault sites
# ---------------------------------------------------------------------------


class TestSchedulerChaos:
    def _sched_service(self, index):
        svc = _service(index)
        return svc, svc.scheduler(start=False)

    @pytest.mark.parametrize("stalls", [1, 2])
    def test_window_timer_stall_loses_no_queries(self, index, stalls):
        svc, sched = self._sched_service(index)
        queue = _mixed_queue(6)
        solo = svc.submit(queue, top_k=5, min_join=4)
        handles = [sched.submit_async(q, top_k=5, min_join=4) for q in queue]
        with inject_faults({"window_timer": stalls}) as plan:
            for _ in range(stalls):
                assert sched.run_pending() == 0
                assert not any(h.done() for h in handles)
            assert sched.run_pending() == len(queue)
        assert plan.fired == {"window_timer": stalls}
        assert sched.stats_.timer_stalls == stalls
        assert all(h.outcome().ok for h in handles)
        assert [_flat(h.result()) for h in handles] == [_flat(r) for r in solo]
        svc.close()

    def test_staging_fault_walks_ladder_neighbors_untouched(self, index):
        svc, sched = self._sched_service(index)
        queue = _mixed_queue(6)
        solo = svc.submit(queue, top_k=5, min_join=4)
        handles = [sched.submit_async(q, top_k=5, min_join=4) for q in queue]
        with inject_faults({"staging": "all"}):
            sched.run_pending()
        outs = [h.outcome() for h in handles]
        assert all(o.ok for o in outs)
        assert {o.rung for o in outs} == {"reference"}
        assert all(o.retries == FAST_RETRY.max_retries for o in outs)
        assert all(o.fallbacks == 1 for o in outs)
        assert [_flat(h.result()) for h in handles] == [_flat(r) for r in solo]
        svc.close()

    def test_staging_fault_single_bucket_isolated(self, index):
        svc, sched = self._sched_service(index)
        queue = _mixed_queue(6)  # 4 continuous + 2 discrete -> 2 buckets
        solo = svc.submit(queue, top_k=5, min_join=4)
        handles = [sched.submit_async(q, top_k=5, min_join=4) for q in queue]
        with inject_faults({"staging": [0]}) as plan:
            sched.run_pending()
        assert plan.fired == {"staging": 1}
        outs = [h.outcome() for h in handles]
        assert all(o.ok and o.rung == "batched" for o in outs)
        hit = [o for o in outs if o.retries]
        clean = [o for o in outs if not o.retries]
        assert hit and clean  # exactly one bucket paid the retry
        assert all(o.fallbacks == 0 for o in outs)
        assert [_flat(h.result()) for h in handles] == [_flat(r) for r in solo]
        svc.close()

    def test_ingest_midflight_fault_spares_inflight_window(self):
        index = _index()
        svc, sched = self._sched_service(index)
        queue = _mixed_queue(4)
        solo = svc.submit(queue, top_k=5, min_join=4)
        before_len = len(svc)
        handles = [sched.submit_async(q, top_k=5, min_join=4) for q in queue]
        sched.run_pending(collect=False)  # window in flight
        with inject_faults({"ingest_midflight": "all"}):
            with pytest.raises(InjectedFault):
                sched.add("late", "k", "v", KEYS, Y.astype(np.float32), False)
        assert len(svc) == before_len
        sched.run_pending()  # collect the in-flight window
        assert all(h.outcome().ok for h in handles)
        assert [_flat(h.result()) for h in handles] == [_flat(r) for r in solo]
        # the tier is not wedged: a clean ingest + query still works
        sched.add("late", "k", "v", KEYS, Y.astype(np.float32), False)
        assert len(svc) == before_len + 1
        h = sched.submit_async(_train(Y.astype(np.float32), False),
                               top_k=before_len + 1, min_join=4)
        sched.run_pending()
        assert "late" in [m.table for m, _, _ in h.result()]
        svc.close()

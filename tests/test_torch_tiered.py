"""The port's phase-0 containment gate against the JAX package (mirrors
``tests/test_tiered_retrieval.py``).

One seeded corpus goes into a fresh index of each package, and the same
train sketches go through both, on the CPU:

  (a) ``signature_join_size``: the (Q, R) estimates bit-equal to the
      reference's vmapped function, keys >= 2^31 and the fence-collision
      key included; exact when a candidate holds at most ``w`` keys;
  (b) the signature tier: ``_signature_block`` and the stores' ``"sig"``
      rows equal to a host recompute (and to the reference's) after
      interleaved ingest; a ``flush`` fault leaves both tiers consistent;
  (c) the gate: ``_containment_gate`` rows, lanes and counts equal to the
      reference's, a threshold that needs the 6-decimal rounding
      included; ``tier_spec`` widths equal;
  (d) gated retrieval: ``min_containment=0`` is the fused path, a
      capacity-wide signature makes gated equal ungated, and both
      packages return the same rankings across ``min_join`` and dtype;
  (e) the overflow protocol: ``SurvivorOverflow``, hint growth, the
      service's ``host_syncs`` / ``gated_windows`` accounting and warm
      delivery gated; the ``tiered_dispatch`` fault recovering ungated;
  (f) the argument checks, ``stats()["tiers"]``, ``submit_async``, the
      gate on a 3-shard CPU mesh, and the reference's 4-shard scenario
      held against the port's batched executor.

Join sizes, survivors and candidates are held equal; MI within rtol/atol
1e-5 (torch's digamma differs from jax's by ~2e-6); rankings identical
wherever score gaps exceed that tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing
from repro.core import join as j_join
from repro.core.discovery import DiscoveryService as JService
from repro.core.discovery import SketchIndex as JIndex
from repro.core.discovery import executors as j_ex
from repro.core.discovery import planner as j_planner
from repro.core.discovery.index import _signature_block as j_signature_block
from repro.core.sketch import build_sketch as j_build
from repro_torch.core import join as t_join
from repro_torch.core.discovery import (
    MIN_SURVIVORS,
    BatchedExecutor,
    DiscoveryService,
    InjectedFault,
    RetryPolicy,
    SketchIndex,
    SurvivorOverflow,
    bucket_survivors,
    fused_shortlist_spec,
    inject_faults,
    stack_trains_host,
    tier_spec,
)
from repro_torch.core.discovery import executors as t_ex
from repro_torch.core.discovery import planner as t_planner
from repro_torch.core.discovery.index import _signature_block
from repro_torch.core.sketch import build_sketch as t_build
from repro_torch.launch.mesh import make_host_mesh

TOL = 1e-5
N_ROWS = 1200
SK_N = 64
KEY_MAX = 0xFFFFFFFF


def _keys(seed=9, lo=0):
    raw = np.arange(lo, lo + N_ROWS, dtype=np.uint32)
    return np.asarray(hashing.murmur3_32_np(raw, seed=np.uint32(seed)))


KEYS = _keys()
Y = np.random.default_rng(21).normal(size=N_ROWS).astype(np.float32)


def _rows(rng, n_joinable=3, n_disjoint=3, n_disc=2):
    """Joinable core + disjoint tail: the selectivity regime the gate
    exists for (as the reference's ``_mixed_index``)."""
    rows = []
    for i in range(n_joinable):
        rows.append((f"cont{i}", "k", "v", KEYS,
                     (Y + (0.2 + i) * rng.normal(size=N_ROWS))
                     .astype(np.float32), False))
    for i in range(n_disc):
        rows.append((f"disc{i}", "k", "v", KEYS,
                     rng.integers(0, 4 + i, size=N_ROWS), True))
    for i in range(n_disjoint):
        rows.append((f"far{i}", "k", "v", _keys(lo=(i + 1) * N_ROWS),
                     rng.normal(size=N_ROWS).astype(np.float32), False))
    return rows


def _pair(rows, sig_width=16):
    """The same corpus in a JAX index and a port index on the CPU."""
    ji = JIndex(n=SK_N, method="tupsk", sig_width=sig_width)
    ti = SketchIndex(n=SK_N, method="tupsk", device="cpu",
                     sig_width=sig_width)
    for r in rows:
        ji.add(*r)
        ti.add(*r)
    return ji, ti


def _train(v, disc=False, build=t_build):
    return build(KEYS, v, n=SK_N, method="tupsk", side="train",
                 value_is_discrete=disc)


def _target(disc):
    return (Y > 0).astype(np.int64) if disc else Y


def _queue(seed, q, disc_every=3, build=t_build):
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
        g, w = _flat(g), _flat(w)
        assert len(g) == len(w)
        w_by = {t: (mi, js) for t, mi, js in w}
        for (tg, mg, jg), (tw, mw, jw) in zip(g, w):
            assert np.isclose(mg, mw, rtol=TOL, atol=TOL), (tg, mg, tw, mw)
            assert tg in w_by and w_by[tg][1] == jg
            if tg != tw:
                assert np.isclose(w_by[tg][0], mw, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# (a) the signature estimate
# ---------------------------------------------------------------------------


def _effective_row(keys: np.ndarray, cap: int):
    """Store-format key row: valid prefix first, ascending, fenced."""
    ks = np.sort(np.unique(keys.astype(np.uint32)))[:cap]
    row = np.full(cap, KEY_MAX, dtype=np.uint32)
    row[: ks.size] = ks
    mask = np.zeros(cap, dtype=bool)
    mask[: ks.size] = True
    return row, mask


def _sig_row(row, mask, w):
    return np.concatenate([row[:w].view(np.int32),
                           np.asarray([mask.sum()], np.int32)])


def _j_estimates(tk, tm, sig):
    return np.asarray(jax.vmap(lambda a, b: jax.vmap(
        lambda s: j_join.signature_join_size(a, b, s))(jnp.asarray(sig)))(
            jnp.asarray(tk), jnp.asarray(tm)))


def _t_estimates(tk, tm, sig):
    return t_join.signature_join_size(
        torch.from_numpy(tk.astype(np.int64)), torch.from_numpy(tm),
        torch.from_numpy(sig)).numpy()


def _random_signatures(rng, tk, R, w, cap=SK_N, high=False):
    """R signature rows sampling ``tk``'s keys and fresh ones; with
    ``high`` every key is >= 2^31."""
    lo = 2**31 if high else 0
    rows = []
    for _ in range(R):
        take = tk[rng.random(tk.shape) < rng.uniform(0, 0.6)]
        extra = rng.integers(lo, 2**32 - 1, size=rng.integers(0, 2 * cap),
                             dtype=np.uint64).astype(np.uint32)
        rows.append(_sig_row(*_effective_row(np.concatenate([take, extra]),
                                             cap), w))
    return np.stack(rows)


class TestSignatureJoinSize:
    @pytest.mark.parametrize("seed,w,high", [(0, 16, False), (1, 16, True),
                                             (2, 64, False), (3, 8, True)])
    def test_bit_equal_to_reference(self, seed, w, high):
        """(Q, R) estimates bit-equal to the reference's vmap, repeated
        train keys and masked train rows included."""
        rng = np.random.default_rng(seed)
        Q, n = 4, SK_N
        lo = 2**31 if high else 0
        tk = rng.integers(lo, 2**32 - 1, size=(Q, n),
                          dtype=np.uint64).astype(np.uint32)
        tk[:, 10:20] = tk[:, :10]  # train sketches keep repeats
        tm = rng.random((Q, n)) < 0.8
        sig = _random_signatures(rng, tk[0], 40, w, high=high)
        want, got = _j_estimates(tk, tm, sig), _t_estimates(tk, tm, sig)
        assert got.dtype == np.float32 and got.shape == (Q, 40)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        assert (got > 0).any()

    @pytest.mark.parametrize("w", [16, SK_N])
    def test_exact_when_candidate_fits_the_signature(self, w):
        """A candidate of at most ``w`` keys is its own signature: the
        estimate is the exact presorted join size."""
        rng = np.random.default_rng(4)
        tk = np.sort(np.asarray(hashing.murmur3_32_np(
            np.arange(300, dtype=np.uint32), seed=np.uint32(5))))[:SK_N]
        tm = np.ones(SK_N, dtype=bool)
        sigs, exact = [], []
        for cand_n in (0, 1, 5, 10, 16, 40, 64):
            ck = np.concatenate([rng.choice(tk, size=cand_n // 2, replace=False),
                                 rng.integers(0, 2**32 - 1, size=cand_n - cand_n // 2,
                                              dtype=np.uint64).astype(np.uint32)])
            row, mask = _effective_row(ck, SK_N)
            sigs.append(_sig_row(row, mask, w))
            exact.append((mask.sum(), int(t_join.presorted_join_size(
                torch.from_numpy(tk.astype(np.int64)), torch.from_numpy(tm),
                torch.from_numpy(row.astype(np.int64)), torch.from_numpy(mask)))))
        got = _t_estimates(tk[None], tm[None], np.stack(sigs))[0]
        for (valid, js), est in zip(exact, got):
            if valid <= w:
                assert est == js, (valid, est, js)

    def test_fence_collision_key(self):
        """A candidate key equal to 0xFFFFFFFF reads as the fence; the
        estimate stays finite and equal to the reference's."""
        rng = np.random.default_rng(5)
        tk = np.sort(rng.integers(0, 2**31, size=50).astype(np.uint32))
        tk = np.concatenate([tk, np.full(14, KEY_MAX, np.uint32)])
        tm = np.arange(SK_N) < 50
        ck = np.concatenate([tk[:10], np.asarray([KEY_MAX], np.uint32)])
        sig = _sig_row(*_effective_row(ck, SK_N), SK_N)[None]
        got = _t_estimates(tk[None], tm[None], sig)
        np.testing.assert_array_equal(got, _j_estimates(tk[None], tm[None], sig))
        assert np.isfinite(got).all() and got[0, 0] >= 10

    def test_high_keys_keep_their_order(self):
        """Keys >= 2^31 are negative as int32 bit patterns; widened they
        still probe the right train rows (exact count at w = capacity)."""
        tk = np.arange(2**32 - 200, 2**32 - 200 + SK_N, dtype=np.uint64)
        tk = tk.astype(np.uint32)
        tm = np.ones(SK_N, dtype=bool)
        ck = np.concatenate([tk[::2], np.arange(5, 25, dtype=np.uint32)])
        sig = _sig_row(*_effective_row(ck, SK_N), SK_N)[None]
        got = _t_estimates(tk[None], tm[None], sig)
        assert got[0, 0] == SK_N // 2
        np.testing.assert_array_equal(got, _j_estimates(tk[None], tm[None], sig))


# ---------------------------------------------------------------------------
# (b) the signature tier
# ---------------------------------------------------------------------------


def _assert_tiers_consistent(ti, ji=None):
    for y_disc, state in ti._groups.items():
        for eid, store in state.stores.items():
            idx = state.index[eid][: store.rows]
            want = _signature_block(ti._host_block(idx), store.sig_cols)
            sig = store.arrays["sig"].numpy()
            np.testing.assert_array_equal(sig[: store.rows], want)
            assert (sig[store.rows:] == -1).all()  # dead rows stay fenced
            if ji is not None:
                j_sig = np.asarray(ji._groups[y_disc].stores[eid].arrays["sig"])
                np.testing.assert_array_equal(sig, j_sig)


class TestSignatureTier:
    def test_signature_block_matches_reference(self):
        ji, ti = _pair(_rows(np.random.default_rng(6)))
        idx = list(range(len(ti)))
        for w in (1, 16, SK_N):
            np.testing.assert_array_equal(
                _signature_block(ti._host_block(idx), w),
                j_signature_block(ji._host_block(idx), w))

    def test_store_matches_host_recompute_interleaved_ingest(self):
        rng = np.random.default_rng(7)
        ji, ti = _pair(_rows(rng))
        sk_t, sk_j = _train(Y), _train(Y, build=j_build)
        for step in range(3):
            assert_same_results(
                [ti.query(sk_t, top_k=5, min_join=4, min_containment=0.05)],
                [ji.query(sk_j, top_k=5, min_join=4, min_containment=0.05)])
            _assert_tiers_consistent(ti, ji)
            late = (f"late{step}", "k", "v", KEYS,
                    (0.4 * Y + rng.normal(size=N_ROWS)).astype(np.float32),
                    False)
            ji.add(*late)
            ti.add(*late)

    def test_flush_fault_leaves_tiers_consistent(self):
        rng = np.random.default_rng(8)
        ti = _pair(_rows(rng))[1]
        sk = _train(Y)
        want = _flat(ti.query(sk, top_k=5, min_join=4, min_containment=0.05))
        ti.add("late", "k", "v", KEYS,
               (0.4 * Y + rng.normal(size=N_ROWS)).astype(np.float32), False)
        with inject_faults({"flush": 1}):
            with pytest.raises(InjectedFault):
                ti.query(sk, top_k=5, min_join=4, min_containment=0.05)
        # The failed flush mutated nothing; the retry flushes the same
        # pending block into both tiers and serves.
        got = ti.query(sk, top_k=5, min_join=4, min_containment=0.05)
        _assert_tiers_consistent(ti)
        assert _flat(got) == _flat(ti.query(sk, top_k=5, min_join=4))
        assert len(got) >= len(want)

    def test_width_clamp_and_device_bytes(self):
        ji, ti = _pair(_rows(np.random.default_rng(9)), sig_width=4 * SK_N)
        ti.plan(False)
        ji.plan(False)
        assert ti._sig_cols() == ji._sig_cols() == SK_N
        st, jst = ti.ingest_stats, ji.ingest_stats
        stores = list(ti._groups[False].stores.values())
        assert st["signature_bytes"] == jst["signature_bytes"] == sum(
            s.arrays["sig"].numel() * 4 for s in stores)
        assert st["sketch_bytes"] == sum(
            a.numel() * a.element_size() for s in stores
            for n, a in s.arrays.items() if n != "sig")
        off = SketchIndex(n=SK_N, device="cpu", sig_width=0)
        off.add(*_rows(np.random.default_rng(9))[0])
        off.plan(False)
        assert off._sig_cols() is None
        assert off.ingest_stats["signature_bytes"] == 0
        assert off.plan(False).groups[0].sig is None


# ---------------------------------------------------------------------------
# (c) the gate against the reference's
# ---------------------------------------------------------------------------


def _gate_pair(ti, ji, sks_t, sks_j, mc, s_surv):
    """The port's and the reference's gate on every group of the plan:
    [(rows, lane_live, counts)] each, on the host."""
    y_disc = bool(sks_t[0].value_is_discrete)
    tp, jp = ti.plan(y_disc), ji.plan(y_disc)
    tt = stack_trains_host(sks_t, "cpu")
    jt = j_ex.stack_trains([ji.train_arrays(sk) for sk in sks_j])
    out_t, out_j = [], []
    for tg, jg in zip(tp.groups, jp.groups):
        rows, live, counts = t_ex._containment_gate(
            tt["keys"], tt["mask"], tg.sig, tg.live,
            t_planner.stage_min_containment(mc), s_surv)
        out_t.append((rows.numpy(), live.numpy(), counts.numpy()))
        rows, live, counts = j_ex._containment_gate(
            jt["keys"], jt["mask"], jg.sig, jg.live,
            j_planner.stage_min_containment(mc), s_surv=s_surv)
        out_j.append(tuple(np.asarray(a) for a in (rows, live, counts)))
    return out_t, out_j


class TestGateParity:
    @pytest.mark.parametrize("mc", [0.05, 0.3, 0.1234567])
    @pytest.mark.parametrize("disc", [False, True])
    def test_gate_rows_lanes_counts(self, mc, disc):
        rng = np.random.default_rng(10)
        ji, ti = _pair(_rows(rng, n_joinable=6, n_disjoint=5, n_disc=3))
        sks_t = _queue(11, 4, disc_every=1 if disc else 99)
        sks_j = _queue(11, 4, disc_every=1 if disc else 99, build=j_build)
        out_t, out_j = _gate_pair(ti, ji, sks_t, sks_j, mc, s_surv=8)
        for (rt, lt, ct), (rj, lj, cj) in zip(out_t, out_j):
            np.testing.assert_array_equal(ct, cj)
            np.testing.assert_array_equal(lt, lj)
            np.testing.assert_array_equal(rt, rj)
        assert sum(int(c.sum()) for _, _, c in out_t) > 0

    def test_threshold_rounds_to_six_decimals(self):
        """Containment exactly 0.5 passes a threshold of 0.5000004: the
        threshold is rounded to 6 decimals (0.5) before the float32
        compare, in both packages."""
        tk = np.sort(np.asarray(hashing.murmur3_32_np(
            np.arange(32, dtype=np.uint32), seed=np.uint32(6))))
        half = _sig_row(*_effective_row(tk[::2], SK_N), 16)      # 16 of 32
        less = _sig_row(*_effective_row(tk[1:31:2], SK_N), 16)   # 15 of 32
        sig = np.stack([half, less, half])
        tkp = np.concatenate([tk, np.zeros(SK_N - 32, np.uint32)])[None]
        tm = (np.arange(SK_N) < 32)[None]
        live = np.array([True, True, False])
        for mc, want_count in ((0.5000004, 1), (0.500001, 0), (0.46875, 2)):
            rows, lanes, counts = t_ex._containment_gate(
                torch.from_numpy(tkp.astype(np.int64)), torch.from_numpy(tm),
                torch.from_numpy(sig), torch.from_numpy(live),
                t_planner.stage_min_containment(mc), 8)
            jr, jl, jc = j_ex._containment_gate(
                jnp.asarray(tkp), jnp.asarray(tm), jnp.asarray(sig),
                jnp.asarray(live), j_planner.stage_min_containment(mc), s_surv=8)
            assert int(counts[0]) == int(jc[0]) == want_count, mc
            np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
            np.testing.assert_array_equal(lanes.numpy(), np.asarray(jl))

    def test_staged_threshold_equals_reference(self):
        for mc in (1e-7, 0.05, 0.1234567, 0.7, 0.9999996, 1.0):
            want = float(np.asarray(j_planner.stage_min_containment(mc)))
            assert t_planner.stage_min_containment(mc) == want, mc

    def test_tier_spec_and_ladder_match_reference(self):
        for n in (0, 1, 7, 8, 9, 100, 4097):
            assert bucket_survivors(n) == j_planner.bucket_survivors(n)
        assert MIN_SURVIVORS == j_planner.MIN_SURVIVORS
        ji, ti = _pair(_rows(np.random.default_rng(12)))
        th, jh = t_planner.ShortlistHints(), j_planner.ShortlistHints()
        for hints in (th, jh):
            hints.observe(("tier0", False, 1, 0.123457, False), 30,
                          overflowed=True)
        for mc in (0.1234567, 0.5):
            t_spec = tier_spec(ti.plan(False), th, mc)
            j_spec = j_planner.tier_spec(ji.plan(False), jh, mc)
            assert t_spec.s_survivors == j_spec.s_survivors
            assert t_spec.signature == j_spec.signature


# ---------------------------------------------------------------------------
# (d) gated retrieval against the reference and against the ungated path
# ---------------------------------------------------------------------------


class TestGatedRetrieval:
    def test_zero_threshold_is_fused_path(self):
        ti = _pair(_rows(np.random.default_rng(13)))[1]
        sk = _train(Y)
        assert _flat(ti.query(sk, top_k=6, min_join=4)) == _flat(
            ti.query(sk, top_k=6, min_join=4, min_containment=0.0))
        assert ti.tier_hints.overflows == 0

    @pytest.mark.parametrize("min_join", [1, 4, 16])
    @pytest.mark.parametrize("disc", [False, True])
    def test_exact_gate_equals_ungated_and_reference(self, min_join, disc):
        """sig_width == capacity makes phase 0 exact: gated == ungated,
        and the port's gated results equal the reference's."""
        ji, ti = _pair(_rows(np.random.default_rng(14)), sig_width=SK_N)
        sk_t = _train(_target(disc), disc)
        sk_j = _train(_target(disc), disc, build=j_build)
        gated = ti.query(sk_t, top_k=6, min_join=min_join, min_containment=1e-6)
        assert _flat(gated) == _flat(ti.query(sk_t, top_k=6, min_join=min_join))
        assert_same_results([gated], [ji.query(
            sk_j, top_k=6, min_join=min_join, min_containment=1e-6)])

    @pytest.mark.parametrize("min_join", [1, 4, 16])
    @pytest.mark.parametrize("disc", [False, True])
    def test_query_many_noisy_gate_matches_reference(self, min_join, disc):
        """At the default width (16 of 64 keys) the gate is an estimate:
        the port keeps the reference's survivors, so results match across
        the sweep, cold (survivor overflow) and warm."""
        ji, ti = _pair(_rows(np.random.default_rng(15), n_joinable=10,
                             n_disjoint=4, n_disc=4))
        sks_t = _queue(16, 5, disc_every=1 if disc else 99)
        sks_j = _queue(16, 5, disc_every=1 if disc else 99, build=j_build)
        for _ in range(2):
            got = ti.query_many(sks_t, top_k=8, min_join=min_join,
                                min_containment=0.3)
            want = ji.query_many(sks_j, top_k=8, min_join=min_join,
                                 min_containment=0.3)
            assert_same_results(got, want)
        assert ti.tier_hints.overflows == ji.tier_hints.overflows

    def test_high_margin_gate_equals_ungated(self):
        ji, ti = _pair(_rows(np.random.default_rng(17)))
        sk = _train(Y)
        gated = ti.query(sk, top_k=6, min_join=4, min_containment=0.05)
        assert _flat(gated) == _flat(ti.query(sk, top_k=6, min_join=4))
        assert_same_results([gated], [ji.query(
            _train(Y, build=j_build), top_k=6, min_join=4,
            min_containment=0.05)])


# ---------------------------------------------------------------------------
# (e) the overflow protocol and recovery
# ---------------------------------------------------------------------------


def _overflow_rows(rng):
    """More than MIN_SURVIVORS fully joinable candidates in one group:
    cold tier rungs must overflow."""
    return [(f"cont{i}", "k", "v", KEYS,
             (Y + (0.2 + i) * rng.normal(size=N_ROWS)).astype(np.float32),
             False)
            for i in range(MIN_SURVIVORS + 4)]


class TestOverflowProtocol:
    def test_executor_raises_and_reports(self):
        ji, ti = _pair(_overflow_rows(np.random.default_rng(18)))
        plan = ti.plan(False)
        hints = t_planner.ShortlistHints()
        handle = BatchedExecutor().tiered_dispatch(
            plan, stack_trains_host([_train(Y)], "cpu"),
            tier_spec(plan, hints, 0.05), fused_shortlist_spec(plan, hints, 1),
            1, 0.05)
        with pytest.raises(SurvivorOverflow):
            handle.collect()
        jplan = ji.plan(False)
        jh = j_planner.ShortlistHints()
        jhandle = j_ex.BatchedExecutor().tiered_dispatch(
            jplan, j_ex.stack_trains([ji.train_arrays(_train(Y, build=j_build))]),
            j_planner.tier_spec(jplan, jh, 0.05),
            j_planner.fused_shortlist_spec(jplan, jh, 1), 1, 0.05)
        with pytest.raises(j_planner.SurvivorOverflow):
            jhandle.collect()
        assert handle.observed_t0 == jhandle.observed_t0
        assert max(handle.observed_t0.values()) > MIN_SURVIVORS

    def test_service_fallback_accounting_and_warm_delivery(self):
        ji, ti = _pair(_overflow_rows(np.random.default_rng(19)))
        svc, jsvc = (DiscoveryService(index=ti, max_q_bucket=4),
                     JService(index=ji, max_q_bucket=4))
        sk_t, sk_j = _train(Y), _train(Y, build=j_build)
        # Warm the ungated fused rungs so the overflow re-run is the
        # one-sync fused window.
        plain = svc.submit([sk_t], top_k=20, min_join=1)
        jsvc.submit([sk_j], top_k=20, min_join=1)
        base = svc.stats()["admission"]
        cold = svc.submit([sk_t], top_k=20, min_join=1, min_containment=0.05)
        st1 = svc.stats()["admission"]
        assert st1["host_syncs"] - base["host_syncs"] == 2
        assert st1["gated_windows"] == base["gated_windows"]
        assert st1["cands_considered_t0"] == base["cands_considered_t0"]
        assert ti.tier_hints.overflows > 0
        warm = svc.submit([sk_t], top_k=20, min_join=1, min_containment=0.05)
        st2 = svc.stats()["admission"]
        assert st2["host_syncs"] - st1["host_syncs"] == 1
        assert st2["gated_windows"] - st1["gated_windows"] == 1
        assert st2["cands_gated_t0"] >= MIN_SURVIVORS + 4
        assert 0.0 < st2["t0_selectivity"] <= 1.0
        assert st2["signature_bytes"] > 0
        assert _flat(cold[0]) == _flat(warm[0]) == _flat(plain[0])
        for _ in range(2):
            want = jsvc.submit([sk_j], top_k=20, min_join=1,
                               min_containment=0.05)
        assert_same_results(warm, want)
        j_adm = jsvc.stats()["admission"]
        for key in ("host_syncs", "gated_windows", "fused_windows",
                    "cands_considered_t0", "cands_gated_t0",
                    "cands_shortlisted", "signature_bytes"):
            assert st2[key] == j_adm[key], key
        assert ti.tier_hints.overflows == ji.tier_hints.overflows

    def test_tiered_dispatch_fault_recovers_ungated(self):
        ji, ti = _pair(_rows(np.random.default_rng(20)))
        policy = RetryPolicy(max_retries=1, sleep=lambda s: None)
        svc = DiscoveryService(index=ti, max_q_bucket=4, retry_policy=policy)
        sks = _queue(21, 4)
        with inject_faults({"tiered_dispatch@batched": 1}):
            res, outs = svc.submit_safe(sks, top_k=5, min_join=4,
                                        min_containment=0.05)
        assert all(o.ok for o in outs)
        assert any(o.retries > 0 or o.fallbacks > 0 for o in outs)
        # Recovery rungs are ungated: results match the ungated path.
        want = svc.submit(sks, top_k=5, min_join=4)
        assert [_flat(r) for r in res] == [_flat(w) for w in want]
        assert_same_results(res, JService(index=ji).submit(
            _queue(21, 4, build=j_build), top_k=5, min_join=4))


# ---------------------------------------------------------------------------
# (f) argument checks, the service surface, and the 4-shard scenario
# ---------------------------------------------------------------------------


class TestValidation:
    @pytest.fixture(scope="class")
    def index(self):
        return _pair(_rows(np.random.default_rng(22)))[1]

    def test_gate_requires_fused(self, index):
        with pytest.raises(ValueError, match="fused"):
            index.query(_train(Y), min_join=4, min_containment=0.1,
                        fused=False)
        with pytest.raises(ValueError, match="fused"):
            DiscoveryService(index=index).submit(
                [_train(Y)], top_k=3, min_join=4, min_containment=0.1,
                fused=False)

    def test_gate_requires_prefilter(self, index):
        with pytest.raises(ValueError, match="two-phase"):
            index.query(_train(Y), min_join=4, min_containment=0.1,
                        prefilter=False)
        with pytest.raises(ValueError, match="two-phase"):
            index.query_many([_train(Y)], min_join=0, min_containment=0.1)
        with pytest.raises(ValueError, match="fused"):
            DiscoveryService(index=index).submit(
                [_train(Y)], top_k=3, min_join=0, min_containment=0.1)

    def test_gate_requires_signature_tier(self):
        index = SketchIndex(n=SK_N, device="cpu", sig_width=0)
        for r in _rows(np.random.default_rng(23)):
            index.add(*r)
        with pytest.raises(ValueError, match="sig_width"):
            index.query(_train(Y), min_join=4, min_containment=0.1)
        # min_containment=0 stays available without the tier
        assert index.query(_train(Y), top_k=3, min_join=4)

    def test_mesh_still_raises(self, index):
        """The gate runs on the mesh (it used to raise): per shard, with
        the batched path's rankings."""
        mesh = make_host_mesh(devices=["cpu"] * 3)
        kw = dict(top_k=5, min_join=4, min_containment=0.1)
        got = index.query_many([_train(Y)], mesh=mesh, **kw)
        assert got[0] and got == index.query_many([_train(Y)], **kw)


class TestServiceSurface:
    def test_stats_tiers(self):
        ji, ti = _pair(_rows(np.random.default_rng(24)))
        svc, jsvc = DiscoveryService(index=ti), JService(index=ji)
        svc.submit([_train(Y)], top_k=5, min_join=4, min_containment=0.05)
        jsvc.submit([_train(Y, build=j_build)], top_k=5, min_join=4,
                    min_containment=0.05)
        st, jst = svc.stats(), jsvc.stats()
        tiers = st["tiers"]
        assert set(tiers) == set(jst["tiers"])
        assert tiers["signature_width"] == jst["tiers"]["signature_width"] == 16
        assert tiers["signature_bytes"] == jst["tiers"]["signature_bytes"]
        assert 0 < tiers["signature_bytes"] < tiers["sketch_bytes"]
        assert st["admission"]["cands_considered_t0"] > 0
        assert set(st) == set(jst)  # compiled_programs too, as in the reference

    def test_submit_safe_gated_matches_reference(self):
        ji, ti = _pair(_rows(np.random.default_rng(25), n_joinable=10))
        svc, jsvc = DiscoveryService(index=ti), JService(index=ji)
        for _ in range(2):  # cold (overflow re-run), then warm (gated)
            res, outs = svc.submit_safe(_queue(26, 6), top_k=5, min_join=4,
                                        min_containment=0.1)
            jres, _ = jsvc.submit_safe(_queue(26, 6, build=j_build), top_k=5,
                                       min_join=4, min_containment=0.1)
            assert all(o.ok and o.rung == "batched" for o in outs)
            assert_same_results(res, jres)
        assert svc.stats()["admission"]["gated_windows"] == \
            jsvc.stats()["admission"]["gated_windows"] > 0

    def test_submit_async_equals_submit(self):
        ti = _pair(_rows(np.random.default_rng(27)))[1]
        svc = DiscoveryService(index=ti)
        sks = _queue(28, 5)
        want = svc.submit(sks, top_k=5, min_join=4, min_containment=0.1)
        sched = DiscoveryService(index=ti).scheduler(start=False)
        handles = sched.submit_async(sks, top_k=5, min_join=4,
                                     min_containment=0.1)
        sched.run_pending()
        assert [_flat(h.result(timeout=30)) for h in handles] == \
            [_flat(w) for w in want]
        assert all(h.outcome().ok for h in handles)
        sched.close()

    def test_hybrid_rank_gated(self):
        ji, ti = _pair(_rows(np.random.default_rng(29)), sig_width=SK_N)
        svc, jsvc = DiscoveryService(index=ti), JService(index=ji)
        got = svc.submit([_train(Y)], top_k=20, min_join=1,
                         min_containment=1e-6, rank="hybrid")
        want = jsvc.submit([_train(Y, build=j_build)], top_k=20, min_join=1,
                           min_containment=1e-6, rank="hybrid")
        assert_same_results(got, want)


class TestBatchedShardScenario:
    """The reference's 4-shard scenario (``TestFourShardParity`` in
    ``tests/test_tiered_retrieval.py``) with the port's batched executor
    in place of the mesh: 5 joinable and 5 disjoint candidates."""

    @pytest.fixture(scope="class")
    def pair(self):
        rng = np.random.default_rng(14)
        rows = [(f"cont{i}", "k", "v", KEYS,
                 (Y + (0.2 + i) * rng.normal(size=N_ROWS)).astype(np.float32),
                 False) for i in range(5)]
        rows += [(f"far{i}", "k", "v", _keys(lo=(i + 1) * N_ROWS),
                  rng.normal(size=N_ROWS).astype(np.float32), False)
                 for i in range(5)]
        return _pair(rows)

    def test_gated_equals_ungated_cold_and_warm(self, pair):
        ji, ti = pair
        sk_t, sk_j = _train(Y), _train(Y, build=j_build)
        for _ in range(2):
            gated = ti.query(sk_t, top_k=5, min_join=4, min_containment=0.05)
            assert _flat(gated) == _flat(ti.query(sk_t, top_k=5, min_join=4))
            assert_same_results([gated], [ji.query(
                sk_j, top_k=5, min_join=4, min_containment=0.05)])

    def test_service_gated_windows(self, pair):
        ji, ti = pair
        rng = np.random.default_rng(30)
        noise = [(0.2 * (q + 1) * rng.normal(size=N_ROWS)) for q in range(3)]
        sks = [_train((Y + e).astype(np.float32)) for e in noise]
        svc = DiscoveryService(index=ti, max_q_bucket=2)
        svc.submit(sks, top_k=5, min_join=4, min_containment=0.05)
        got = svc.submit(sks, top_k=5, min_join=4, min_containment=0.05)
        assert [_flat(g) for g in got] == [
            _flat(w) for w in svc.submit(sks, top_k=5, min_join=4)]
        adm = svc.stats()["admission"]
        assert adm["gated_windows"] > 0 and adm["cands_gated_t0"] > 0
        jsks = [_train((Y + e).astype(np.float32), build=j_build)
                for e in noise]
        assert_same_results(got, JService(index=ji).submit(
            jsks, top_k=5, min_join=4, min_containment=0.05))

    def test_warm_dispatch_collect_moves_one_transfer(self, pair, monkeypatch):
        """The counterpart of the reference's transfer guard: a warm gated
        dispatch -> collect builds no host shortlist and moves its
        results in one device-to-host transfer."""
        ti = pair[1]
        sk = _train(Y)
        for _ in range(2):
            ti.query(sk, top_k=5, min_join=4, min_containment=0.05)

        def boom(*a, **k):
            raise AssertionError("host shortlist build on the gated path")

        monkeypatch.setattr(t_planner, "build_shortlists", boom)
        calls = []
        real_host = t_ex._host
        monkeypatch.setattr(t_ex, "_host",
                            lambda t: calls.append(t.shape) or real_host(t))
        plan = ti.plan(False)
        handle = BatchedExecutor().tiered_dispatch(
            plan, stack_trains_host([sk], "cpu"),
            tier_spec(plan, ti.tier_hints, 0.05),
            fused_shortlist_spec(plan, ti.tier_hints, 4), 4, 0.05)
        assert calls == []  # nothing crosses at dispatch
        triples = handle.collect()
        assert len(calls) == 1
        assert len(triples) == 1 and len(triples[0][0]) > 0

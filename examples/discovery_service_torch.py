"""Discovery service example (PyTorch port): index a repository, answer
top-k MI queries, including a NON-monotone relationship that
correlation-based discovery (the paper's Section I motivation) cannot
see, then drive the serving scenarios the layered engine exists for, as
``examples/discovery_service.py`` does on the reference:

  1. **Concurrent queries**: ``query_many`` scores a batch of queries
     per estimator group, each answer bit-identical to a solo ``query``.
  2. **Live ingest**: a table added while serving is uploaded into the
     device-resident index (only its rows cross to the device) and the
     next query ranks it.
  3. **The service front end**: a mixed, bursty queue through
     ``DiscoveryService.submit`` (per-signature splitting, pow-2 Q
     buckets), answers bit-identical to solo queries.
  4. **Joinability gating**: ``min_join`` pushed into planning; the
     join-size prefilter skips what cannot pass, results unchanged.
  5. **Fault isolation**: a malformed sketch and an injected dispatch
     fault in one burst; ``submit_safe`` quarantines the one, retries the
     other, and every healthy query keeps its answer.
  6. **Graceful drain**: a preemption notice (SIGTERM) mid-traffic
     finishes the window in flight and refuses the next, through the
     training stack's ``PreemptionGuard``.
  7. **Tiered retrieval at data-lake scale**: a skewed lake (65,536
     candidates by default) where almost nothing is joinable;
     ``min_containment`` engages the phase-0 signature tier, and
     ``rank="hybrid"`` re-weights MI by containment.
  8. **The async tier**: four caller threads through ``submit_async``;
     the micro-batch scheduler coalesces their queries, every handle
     resolving to its solo submit's answer.

    PYTHONPATH=src python examples/discovery_service_torch.py              # the card
    PYTHONPATH=src python examples/discovery_service_torch.py --device cpu --lake 4096

The data is generated in process from seeds; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import dataclasses
import threading
import time

import numpy as np

from repro_torch.core import hashing
from repro_torch.core.discovery import DiscoveryService, SketchIndex, inject_faults
from repro_torch.core.sketch import build_sketch
from repro_torch.data.tables import Table
from repro_torch.device import resolve_device
from repro_torch.train.fault_tolerance import PreemptionGuard

N = 8000


def _same(a, b) -> bool:
    return [(m.table, mi) for m, mi, _ in a] == [(m.table, mi) for m, mi, _ in b]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--lake", type=int, default=65536,
                    help="candidates in scenario 7's lake (a multiple of 512)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(3)

    keys = np.array([f"id{i:06d}" for i in range(N)])
    y = rng.normal(size=N).astype(np.float32)
    repo = [
        # numeric, monotone: both correlation and MI find this
        Table("linear", {"k": keys, "v": (1.5 * y + 0.2 * rng.normal(size=N))
                         .astype(np.float32)}),
        # numeric, NON-monotone: Pearson rho ~ 0, MI sees it
        Table("parabola", {"k": keys, "v": (y ** 2).astype(np.float32)}),
        # categorical (strings): correlation undefined, MLE / DC-KSG apply
        Table("category", {"k": keys,
                           "v": np.where(y > 0.5, "high",
                                         np.where(y < -0.5, "low", "mid"))}),
        # independent noise
        Table("noise", {"k": keys, "v": rng.normal(size=N).astype(np.float32)}),
        # disjoint keys: never joinable, filtered by join size
        Table("disjoint", {"k": np.array([f"zz{i}" for i in range(N)]),
                           "v": y.copy()}),
    ]
    index = SketchIndex(n=512, method="tupsk", device=dev)
    for t in repo:
        index.add_table(t, "k")
    print(f"indexed {len(index)} candidate columns from {len(repo)} tables "
          f"on {dev}")
    base = Table("base", {"k": keys, "target": y})

    def train_sketch_for(target, discrete=False):
        return build_sketch(base["k"].key_codes(), target, n=512,
                            method="tupsk", side="train",
                            value_is_discrete=discrete)

    train_sk = train_sketch_for(base["target"].value_array())
    print("\ntop matches by estimated MI (no join materialized):")
    for meta, mi, join in index.query(train_sk, top_k=5):
        pearson = "n/a"
        for t in repo:
            if t.name == meta.table and not t[meta.value_column].is_discrete:
                pearson = f"{np.corrcoef(t[meta.value_column].data[:N], y)[0, 1]:+.2f}"
        print(f"  MI={mi:5.2f}  join={join:4d}  rho={pearson:>6s}   "
              f"{meta.table}.{meta.value_column}")
    print("\nnote: 'parabola' ranks high on MI with rho ~ 0: the relationship "
          "correlation-based discovery misses (paper Section I).")

    # Scenario 1: concurrent queries.
    batch = [train_sketch_for((y + 0.25 * (q + 1) * rng.normal(size=N))
                              .astype(np.float32)) for q in range(8)]
    answers = index.query_many(batch, top_k=3)
    print(f"\nquery_many: answered {len(answers)} concurrent queries:")
    for q, res in enumerate(answers):
        print(f"  user {q}: " + ", ".join(f"{m.table}({mi:.2f})"
                                          for m, mi, _ in res[:2]))
    assert _same(answers[0], index.query(batch[0], top_k=3))
    print("  (user 0's batched answer == solo query, bit for bit)")

    # Scenario 2: live ingest while serving.
    before = index.ingest_stats["group_h2d_rows"]
    fresh = Table("fresh_signal", {"k": keys, "v": (0.8 * y + 0.1 * rng.normal(
        size=N)).astype(np.float32)})
    index.add_table(fresh, "k")
    res = index.query(train_sk, top_k=3)
    moved = index.ingest_stats["group_h2d_rows"] - before
    print(f"\nlive ingest: added '{fresh.name}' while serving, {moved} "
          f"candidate row(s) uploaded (corpus is {len(index)}):")
    for meta, mi, join in res:
        marker = "  <- just ingested" if meta.table == "fresh_signal" else ""
        print(f"  MI={mi:5.2f}  join={join:4d}   "
              f"{meta.table}.{meta.value_column}{marker}")

    # Scenario 3: the admission-controlled front end.
    service = DiscoveryService(index=index)
    mixed_queue = []
    for q in range(7):
        noisy = y + 0.3 * (q + 1) * rng.normal(size=N)
        if q % 3 == 2:  # every third user asks about a categorical target
            mixed_queue.append(train_sketch_for(np.where(noisy > 0, 1, 0), True))
        else:
            mixed_queue.append(train_sketch_for(noisy.astype(np.float32)))
    answers = service.submit(mixed_queue, top_k=3)
    print(f"\nDiscoveryService.submit: {len(mixed_queue)} mixed-dtype queries:")
    for q, res in enumerate(answers):
        kind = "disc" if mixed_queue[q].value_is_discrete else "cont"
        print(f"  user {q} ({kind}): " + ", ".join(
            f"{m.table}({mi:.2f})" for m, mi, _ in res[:2]))
    assert _same(answers[2], index.query(mixed_queue[2], top_k=3))
    print("  (user 2's admitted answer == solo query, bit for bit)")
    service.add_table(Table("hot_update", {"k": keys, "v": (
        0.7 * y + 0.2 * rng.normal(size=N)).astype(np.float32)}), "k")
    service.submit(mixed_queue[:3], top_k=3)
    stats = service.stats()
    adm, cache = stats["admission"], stats["plan_cache"]
    print(f"\nservice stats after {adm['submits']} submits: {adm['submitted']} "
          f"queries -> {adm['batches']} batches ({adm['signatures']} estimator "
          f"signatures, Q-buckets {adm['q_buckets']}, {adm['padded_lanes']} "
          f"padded lanes); plan cache {cache['hits']} hits / {cache['misses']} "
          f"misses; store grows {stats['ingest']['group_store_grows']}")

    # Scenario 4: joinability gating.
    gated = service.submit([train_sk], top_k=3, min_join=16)
    dense = index.query(train_sk, top_k=3, min_join=16, prefilter=False)
    assert _same(gated[0], dense)
    adm = service.stats()["admission"]
    print(f"\ntwo-phase retrieval: {adm['cands_filtered_out']} of "
          f"{adm['cands_considered']} (query, candidate) pairs filtered out by "
          f"the join-size prefilter before any estimator ran; gated results == "
          f"dense scoring, bit for bit")

    # Scenario 5: fault isolation.
    clean_answers = service.submit(mixed_queue, top_k=3)
    bad_sk = train_sketch_for((y * np.nan).astype(np.float32))
    if not np.isnan(bad_sk.values[bad_sk.mask]).any():
        bad_sk = dataclasses.replace(bad_sk,
                                     values=np.full_like(bad_sk.values, np.nan))
    with inject_faults({"fused_dispatch": [0]}) as fault_plan:
        results, outcomes = service.submit_safe(mixed_queue + [bad_sk], top_k=3)
    assert results[-1] is None and outcomes[-1].status == "quarantined"
    for q in range(len(mixed_queue)):
        assert outcomes[q].ok and _same(results[q], clean_answers[q])
    adm = service.stats()["admission"]
    print(f"\nsubmit_safe under faults: 1 query quarantined "
          f"({outcomes[-1].error}), {fault_plan.fired['fused_dispatch']} "
          f"injected dispatch fault(s) recovered with {adm['retries']} "
          f"retry(ies) and {adm['fallbacks']} fallback(s); the other "
          f"{len(mixed_queue)} answers == clean run, bit for bit")

    # Scenario 6: graceful drain on a preemption notice.
    guard = PreemptionGuard(install=True)  # hooks SIGTERM
    windows = [mixed_queue[:3], mixed_queue[3:6], mixed_queue[6:]]
    served = drained = 0
    for i, window in enumerate(windows):
        if guard.requested:
            drained += len(window)
            continue  # preempted: refuse new windows, never drop in-flight
        service.submit(window, top_k=3)
        served += len(window)
        if i == 0:
            guard.trigger()  # the notice lands mid-traffic
    print(f"\ngraceful drain: SIGTERM after window 0 -> served {served} "
          f"in-flight queries, declined {drained} queued ones, exiting clean "
          "(launchers treat PREEMPTED_EXIT_CODE=43 from training jobs the "
          "same way)")

    # Scenario 7: tiered retrieval on a skewed lake.
    C, n_rows, n_sk = args.lake, 96, 64
    lake_rng = np.random.default_rng(17)
    lake_keys = np.asarray(hashing.murmur3_32_np(
        np.arange(n_rows, dtype=np.uint32), seed=np.uint32(5)))
    lake_y = lake_rng.normal(size=n_rows).astype(np.float32)
    lake = SketchIndex(n=n_sk, method="tupsk", sig_width=16, device=dev)
    t0 = time.perf_counter()
    far = 1
    for c in range(C):
        if c % (C // 16) == 0:  # joinable minority: full key overlap
            alpha = lake_rng.uniform(0.3, 0.9)
            v = (alpha * lake_y + (1 - alpha) * lake_rng.normal(size=n_rows)) \
                .astype(np.float32)
            lake.add(f"hit{c}", "k", "v", lake_keys, v, False)
            continue
        if c % (C // 512) == 0:  # marginal overlap: ~8% of rows shared
            raw = np.concatenate([
                np.arange(8, dtype=np.uint32),
                np.arange(far * n_rows, far * n_rows + n_rows - 8,
                          dtype=np.uint32)])
            kk = np.asarray(hashing.murmur3_32_np(raw, seed=np.uint32(5)))
            lake.add(f"mid{c}", "k", "v", kk,
                     lake_rng.normal(size=n_rows).astype(np.float32), False)
        else:  # the skewed majority: disjoint keys
            other = np.asarray(hashing.murmur3_32_np(
                np.arange(far * n_rows, (far + 1) * n_rows, dtype=np.uint32),
                seed=np.uint32(5)))
            lake.add(f"far{c}", "k", "v", other,
                     lake_rng.normal(size=n_rows).astype(np.float32), False)
        far += 1
    print(f"\nscenario 7: indexed a {len(lake)}-candidate lake in "
          f"{time.perf_counter() - t0:.1f}s (host side; the device flush rides "
          "the first query)")
    lake_svc = DiscoveryService(index=lake)
    lake_sk = build_sketch(lake_keys, lake_y, n=n_sk, method="tupsk",
                           side="train", value_is_discrete=False)
    plain = lake_svc.submit([lake_sk], top_k=5, min_join=8)
    for _ in range(2):  # a warm pass widens the cold survivor rung
        gated = lake_svc.submit([lake_sk], top_k=5, min_join=8,
                                min_containment=0.1)
    assert [(m.table, mi, js) for m, mi, js in gated[0]] == \
           [(m.table, mi, js) for m, mi, js in plain[0]]
    stats = lake_svc.stats()
    adm, tiers = stats["admission"], stats["tiers"]
    print(f"  phase-0 gate: {adm['t0_selectivity']:.1%} of {len(lake)} "
          f"candidates survived into the exact phases ({adm['gated_windows']} "
          f"gated windows); the signature tier holds "
          f"{tiers['signature_bytes'] / 2**20:.1f} MiB against "
          f"{tiers['sketch_bytes'] / 2**20:.1f} MiB of full sketches (width "
          f"{tiers['signature_width']}); gated == ungated, bit for bit")
    lake.add("fresh_hit", "k", "v", lake_keys,
             (0.9 * lake_y + 0.1 * lake_rng.normal(size=n_rows))
             .astype(np.float32), False)
    res = lake_svc.submit([lake_sk], top_k=5, min_join=8, min_containment=0.1)[0]
    assert any(m.table == "fresh_hit" for m, _, _ in res)
    print("  live ingest: 'fresh_hit' added mid-stream, ranked "
          f"#{[m.table for m, _, _ in res].index('fresh_hit') + 1} by the next "
          "gated window")
    raw = np.concatenate([
        np.arange(n_rows // 4, dtype=np.uint32),
        np.arange(10**7, 10**7 + n_rows - n_rows // 4, dtype=np.uint32)])
    narrow_keys = np.asarray(hashing.murmur3_32_np(raw, seed=np.uint32(5)))
    narrow_v = np.where(np.isin(raw, np.arange(n_rows // 4)),
                        np.concatenate([lake_y[: n_rows // 4],
                                        np.zeros(n_rows - n_rows // 4, np.float32)]),
                        lake_rng.normal(size=n_rows)).astype(np.float32)
    lake.add("narrow_perfect", "k", "v", narrow_keys, narrow_v, False)
    by_mi = lake_svc.submit([lake_sk], top_k=10, min_join=8,
                            min_containment=0.1, rank="mi")[0]
    by_hybrid = lake_svc.submit([lake_sk], top_k=10, min_join=8,
                                min_containment=0.1, rank="hybrid")[0]

    def rank_of(res, t):
        r = next((i + 1 for i, (m, _, _) in enumerate(res) if m.table == t), None)
        return f"#{r}" if r else f"below #{len(res)}"

    print(f"  hybrid ranking: 'narrow_perfect' (25% containment) is "
          f"{rank_of(by_mi, 'narrow_perfect')} by MI alone but "
          f"{rank_of(by_hybrid, 'narrow_perfect')} by hybrid (mi x join/train)")

    # Scenario 8: the async tier.
    callers, per_caller = 4, 3
    caller_queues = [[train_sketch_for((y + 0.2 * (c * per_caller + q + 1)
                                        * rng.normal(size=N)).astype(np.float32))
                      for q in range(per_caller)] for c in range(callers)]
    solo_truth = [[service.submit([sk], top_k=3)[0] for sk in qs]
                  for qs in caller_queues]
    async_answers = [None] * callers
    barrier = threading.Barrier(callers)

    def impatient_user(c):
        barrier.wait()  # all callers fire inside one coalescing window
        handles = service.submit_async(caller_queues[c], top_k=3,
                                       priority="interactive")
        async_answers[c] = [h.result(timeout=60) for h in handles]

    threads = [threading.Thread(target=impatient_user, args=(c,))
               for c in range(callers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert async_answers == solo_truth
    tele = service.stats()["scheduler"]
    i_cls = tele["per_class"]["interactive"]
    print(f"\nasync tier: {callers} concurrent callers x {per_caller} queries "
          f"coalesced into {tele['dispatched_buckets']} bucket(s) across "
          f"{tele['windows']} window(s) (coalesce ratio "
          f"{tele['coalesce_ratio']:.1f}); every handle == its solo submit, "
          "bit for bit")
    print(f"  interactive latency: queue-wait p50="
          f"{i_cls['queue_wait_ms']['p50']:.1f}ms, e2e p50="
          f"{i_cls['e2e_ms']['p50']:.1f}ms p95={i_cls['e2e_ms']['p95']:.1f}ms "
          f"over {i_cls['queries']} queries; loop occupancy "
          f"{tele['occupancy']:.0%}")
    service.close()  # drains the scheduler; the sync surfaces keep working


if __name__ == "__main__":
    main()

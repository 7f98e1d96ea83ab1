"""Admission-controlled discovery service: the serving front end
(PyTorch port of ``repro.core.discovery.service``).

:class:`DiscoveryService` sits between "a list of user queries" and the
well-shaped batches the executors answer fast.  A real queue is mixed
(discrete and continuous targets interleaved), bursty and concurrent
with ingest; ``submit`` runs admission control over it:

  1. **Split** — queries are partitioned by target dtype, and so by
     estimator signature (:func:`~.planner.plan_signature`), so every
     admitted bucket is homogeneous.
  2. **Chunk + Q-bucket** — each signature's queries are cut into
     chunks of at most ``max_q_bucket`` (a power of two) and each chunk
     is padded up the pow-2 Q ladder (:func:`~.planner.coalesce_queries`,
     :func:`~.planner.bucket_queries`; ``padded_lanes``, ``q_buckets``),
     so any traffic builds at most |signatures| x |Q buckets| x |widths|
     compiled programs (``stats()["compiled_programs"]``).
  3. **Schedule** — every bucket is dispatched before any result is
     transferred (the executors' ``dispatch`` / ``collect`` split).

Results come back in arrival order and equal looping
:meth:`SketchIndex.query` over the same queue: padded lanes repeat a
live lane and are sliced off on the device.  With ``min_join`` > 0
each bucket runs two-phase retrieval, by default as one fused device
pipeline whose only host sync is its collect (``host_syncs``,
``fused_windows``); a compaction overflow falls back to the host
shortlist boundary for that bucket.  ``min_containment`` > 0 puts the
phase-0 containment gate in front of that pipeline (``gated_windows``,
``cands_gated_t0``); a survivor-buffer overflow re-runs the bucket
ungated.

**Fault isolation** (``resilience.py``): ``submit_safe`` returns
``(results, outcomes)``.  Invalid sketches are quarantined at admission;
a bucket whose dispatch or collect raises is retried under the
service's :class:`~.resilience.RetryPolicy`, then served by the
reference per-query loop; non-finite MI lanes are recomputed through
the materialized estimators (the ``pairwise_cheb`` kernel on the card).
Arrival counters commit at admission; delivery counters are staged per
bucket and committed only after its collect.  The fault sites sit at
the executors' entry points and collects, outside every captured
program, so the ladder is the same with programs on or under
:func:`~repro_torch.compile.eager`.

**The mesh** (``mesh=``): every admitted bucket runs on the index's
group-major distributed executor (one per (mesh, k), so the service and
``index.query(mesh=...)`` share its sharded groups) and returns ranked
winners merged on the first device.  The ladder then runs distributed
-> batched -> reference, and each outcome reports its rung.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from repro_torch.compile import compile_count
from repro_torch.core.discovery import executors as _ex
from repro_torch.core.discovery import resilience
from repro_torch.core.discovery.index import SketchIndex, topk_oversample
from repro_torch.core.discovery.planner import (
    MAX_Q_BUCKET,
    PlanCache,
    ShortlistOverflow,
    SurvivorOverflow,
    build_shortlists,
    coalesce_queries,
    fused_shortlist_spec,
    plan_signature,
    shortlist_signature,
    tier_spec,
)
from repro_torch.core.discovery.resilience import QueryOutcome, RetryPolicy
from repro_torch.core.sketch import Sketch

__all__ = ["AdmissionStats", "DiscoveryService"]


@dataclass
class AdmissionStats:
    """What admission control did to the traffic so far.

    Arrival counters commit when a submit is admitted; delivery counters
    (``batches`` onwards) only after the owning bucket's results were
    collected.
    """

    submitted: int = 0       # queries accepted across all submit() calls
    submits: int = 0         # submit() calls
    quarantined: int = 0     # queries rejected at admission validation
    batches: int = 0         # buckets that delivered
    split_batches: int = 0   # extra chunks forced by the max_q_bucket cap
    padded_lanes: int = 0    # dead query lanes paid to ride the Q ladder
    prefiltered: int = 0     # queries served via two-phase retrieval
    cands_considered: int = 0   # (query, candidate) pairs seen by phase 1
    cands_shortlisted: int = 0  # pairs that reached phase-2 scoring
    fused_windows: int = 0   # buckets delivered by the fused device path
    gated_windows: int = 0   # buckets delivered by the phase-0-gated path
    cands_considered_t0: int = 0  # (query, candidate) pairs swept by the
    #                               phase-0 signature gate
    cands_gated_t0: int = 0  # pairs the gate passed into the exact phases
    signature_bytes: int = 0  # device bytes of the signature tier the
    #                           most recent gated window swept
    host_syncs: int = 0      # device->host syncs paid by delivered buckets
    #                          (fused/dense/tiered: 1; host-boundary
    #                          two-phase: 2; fused overflow fallback: 3;
    #                          a tiered overflow adds 1 to what the
    #                          ungated re-run pays)
    failed_buckets: int = 0  # buckets whose primary executor pass raised
    retries: int = 0         # same-rung re-attempts across all buckets
    fallbacks: int = 0       # executor-ladder descents across all buckets
    nonfinite_lanes: int = 0  # score lanes fenced to the reference path
    lost_queries: int = 0    # queries whose bucket exhausted the ladder
    signatures: set = field(default_factory=set)
    q_buckets: set = field(default_factory=set)
    s_buckets: set = field(default_factory=set)

    def as_dict(self) -> dict:
        return {
            "submitted": self.submitted,
            "submits": self.submits,
            "quarantined": self.quarantined,
            "batches": self.batches,
            "split_batches": self.split_batches,
            "padded_lanes": self.padded_lanes,
            "prefiltered": self.prefiltered,
            "cands_considered": self.cands_considered,
            "cands_shortlisted": self.cands_shortlisted,
            "fused_windows": self.fused_windows,
            "gated_windows": self.gated_windows,
            "cands_considered_t0": self.cands_considered_t0,
            "cands_gated_t0": self.cands_gated_t0,
            # The share of swept (query, candidate) pairs the gate let
            # through to the exact phases.
            "t0_selectivity": (
                self.cands_gated_t0 / self.cands_considered_t0
                if self.cands_considered_t0 else None
            ),
            "signature_bytes": self.signature_bytes,
            "host_syncs": self.host_syncs,
            "cands_filtered_out":
                self.cands_considered - self.cands_shortlisted,
            "failed_buckets": self.failed_buckets,
            "retries": self.retries,
            "fallbacks": self.fallbacks,
            "nonfinite_lanes": self.nonfinite_lanes,
            "lost_queries": self.lost_queries,
            "signatures": len(self.signatures),
            "q_buckets": sorted(self.q_buckets),
            "s_buckets": sorted(self.s_buckets),
        }


class _BucketJob:
    """One admitted bucket moving through dispatch -> collect, carrying
    its staged stat deltas (committed only after a successful collect)
    and its recovery bookkeeping."""

    __slots__ = (
        "chunk", "y_disc", "q_bucket", "sp", "sketches", "trains",
        "pend1", "handle", "rung", "retries", "fallbacks", "error",
        "staged", "tsize",
    )

    def __init__(self, chunk: list[int], y_disc: bool, sketches: list,
                 q_bucket: int):
        self.chunk = chunk
        self.y_disc = y_disc
        self.q_bucket = q_bucket
        self.sp = None
        self.sketches = sketches
        self.trains = None
        self.pend1 = None
        self.handle = None
        self.rung = None
        self.retries = 0
        self.fallbacks = 0
        self.error = None
        self.staged: dict = {}
        # rank="hybrid": each query's train size, which the distributed
        # rung's shard programs weight by before their top-k.
        self.tsize = None


class _Window:
    """One dispatched-but-uncollected admission window.

    Everything ranking needs is captured at dispatch — the corpus size
    and version the work was planned against, the serving options — so
    :meth:`DiscoveryService._window_collect` can run later (after other
    windows dispatched, after an ingest landed) and still give the
    results of a synchronous submit.
    """

    __slots__ = (
        "queries", "jobs", "results", "outcomes", "C", "version",
        "top_k", "min_join", "min_containment", "rank", "isolate",
        "use_pref", "n_shards",
    )

    def __init__(self, queries: list, isolate: bool):
        self.queries = queries
        self.jobs: list[_BucketJob] = []
        self.results: list = [None] * len(queries)
        self.outcomes: list = [None] * len(queries)
        self.C = 0
        self.version = 0
        self.top_k = 0
        self.min_join = 0
        self.min_containment = 0.0
        self.rank = "mi"
        self.isolate = isolate
        self.use_pref = False
        self.n_shards = 1


def _check_options(rank: str) -> None:
    if rank not in ("mi", "hybrid"):
        raise ValueError(f"rank must be 'mi' or 'hybrid', got {rank!r}")


class DiscoveryService:
    """Serving surface: live ingest + concurrent mixed queries.

    ``add`` / ``add_table`` ingest candidate columns; ``submit`` answers
    a queue of train sketches (``submit_safe`` behind quarantine, the
    retry/fallback ladder and the numeric fence; ``submit_async``
    through the micro-batch scheduler).  One service owns one
    :class:`SketchIndex` (pass ``index=`` to wrap an existing corpus,
    e.g. ``SketchIndex(device="cpu")`` for a CPU run; otherwise one is
    made on the card, with a ``sig_width``-wide signature tier).  With
    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`) every bucket runs
    sharded over the mesh's ``"data"`` axis.
    """

    def __init__(
        self,
        index: SketchIndex | None = None,
        *,
        n: int = 256,
        method: str = "tupsk",
        agg: str = "first",
        k: int = 3,
        mesh=None,
        max_q_bucket: int = MAX_Q_BUCKET,
        plan_cache_size: int = 32,
        retry_policy: RetryPolicy | None = None,
        sig_width: int = 16,
    ):
        max_q_bucket = int(max_q_bucket)
        # The chunker cuts queues to max_q_bucket and the ladder pads up
        # to the next power of two, so a non-pow-2 cap would make a full
        # chunk unbucketable.
        if max_q_bucket < 1 or max_q_bucket & (max_q_bucket - 1):
            raise ValueError(
                f"max_q_bucket must be a power of two >= 1 (the Q-axis "
                f"bucket ladder is pow-2), got {max_q_bucket}"
            )
        self.index = index if index is not None else SketchIndex(
            n=n, method=method, agg=agg, sig_width=sig_width
        )
        self.k = k
        self.max_q_bucket = max_q_bucket
        self.plan_cache = PlanCache(plan_cache_size)
        self.admission = AdmissionStats()
        self.retry_policy = retry_policy if retry_policy is not None \
            else RetryPolicy()
        self._batched = _ex.BatchedExecutor(k=k)
        self.mesh = mesh
        # The index's per-(mesh, k) distributed executor, shared with
        # direct ``index.query(mesh=...)`` callers.
        self._dist = (self.index._distributed_executor(mesh, k)
                      if mesh is not None else None)
        # The micro-batch scheduler is attached on the first
        # submit_async; the lock makes racing first callers share one.
        self._scheduler = None
        self._scheduler_lock = threading.Lock()

    # ------------------------------------------------------------------
    # Ingest (delegates to the index; flushes ride the next submit)
    # ------------------------------------------------------------------

    def add(self, *args, **kwargs) -> None:
        """Ingest one candidate column (see :meth:`SketchIndex.add`)."""
        self.index.add(*args, **kwargs)

    def add_table(self, table, key_column: str) -> None:
        """Ingest every (key, value) pair of a table, atomically (see
        :meth:`SketchIndex.add_table`)."""
        self.index.add_table(table, key_column)

    def __len__(self) -> int:
        return len(self.index)

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------

    def submit(
        self,
        queries: list[Sketch],
        *,
        top_k: int = 10,
        min_join: int = 8,
        prefilter: bool | None = None,
        fused: bool | None = None,
        min_containment: float = 0.0,
        rank: str = "mi",
    ) -> list[list]:
        """Answer a mixed, arbitrarily sized queue of discovery queries:
        one ranked result list per query, in arrival order, each equal
        to ``index.query(sk, top_k=..., min_join=..., k=self.k)``.

        ``prefilter`` (default on when ``min_join`` > 0) runs two-phase
        retrieval; ``fused`` (default on with the prefilter) runs both
        phases as one device pipeline per bucket.  ``rank="hybrid"``
        re-weights each score by exact containment (mi x join_size /
        train_size) before ranking.  ``min_containment`` > 0 (fused path
        only) adds the phase-0 containment gate in front of each
        bucket's pipeline.  The first bucket failure is counted
        (``failed_buckets``) and re-raised; use :meth:`submit_safe` for
        isolation.
        """
        results, _ = self._submit(
            list(queries), top_k=top_k, min_join=min_join,
            prefilter=prefilter, fused=fused, isolate=False,
            min_containment=min_containment, rank=rank,
        )
        return results

    def submit_safe(
        self,
        queries: list[Sketch],
        *,
        top_k: int = 10,
        min_join: int = 8,
        prefilter: bool | None = None,
        fused: bool | None = None,
        min_containment: float = 0.0,
        rank: str = "mi",
    ) -> tuple[list, list]:
        """Fault-isolated :meth:`submit`: ``(results, outcomes)``, one
        :class:`~.resilience.QueryOutcome` per query.  Invalid sketches
        are quarantined (result None); a failing bucket retries, then
        descends to the reference rung; non-finite MI lanes are
        recomputed through the materialized estimators and counted
        (``nonfinite_lanes``)."""
        return self._submit(
            list(queries), top_k=top_k, min_join=min_join,
            prefilter=prefilter, fused=fused, isolate=True,
            min_containment=min_containment, rank=rank,
        )

    # ------------------------------------------------------------------
    # Async serving tier (micro-batch scheduler)
    # ------------------------------------------------------------------

    def scheduler(self, **kwargs):
        """The service's micro-batch scheduler, created (and started) on
        first use.  ``kwargs`` configure the first creation
        (``window_ms``, ``max_depth``, ``pipeline_depth``, ``start``);
        passing them after the scheduler exists is an error."""
        if self._scheduler is None:
            from repro_torch.core.discovery.scheduler import MicroBatchScheduler
            with self._scheduler_lock:
                if self._scheduler is None:
                    self._scheduler = MicroBatchScheduler(self, **kwargs)
                    return self._scheduler
        if kwargs:
            raise ValueError(
                "scheduler already attached; its configuration is fixed "
                f"at creation (got {sorted(kwargs)})"
            )
        return self._scheduler

    def submit_async(
        self,
        queries,
        *,
        priority: str = "interactive",
        top_k: int = 10,
        min_join: int = 8,
        prefilter: bool | None = None,
        fused: bool | None = None,
        min_containment: float = 0.0,
        rank: str = "mi",
    ):
        """Future-style :meth:`submit_safe` through the micro-batch tier:
        one :class:`~.scheduler.QueryHandle` per query (a single handle
        for a single sketch), resolving to the ranked results and a
        :class:`~.resilience.QueryOutcome`.  Queries of different
        callers arriving within the scheduler's window share buckets;
        ``priority`` is ``"interactive"`` (dispatched first) or
        ``"batch"``; a full queue raises
        :class:`~.scheduler.SchedulerBackpressure`."""
        return self.scheduler().submit_async(
            queries, priority=priority, top_k=top_k, min_join=min_join,
            prefilter=prefilter, fused=fused,
            min_containment=min_containment, rank=rank,
        )

    def close(self) -> None:
        """Drain and stop the attached scheduler, if any (idempotent;
        the synchronous surfaces keep working after close)."""
        if self._scheduler is not None:
            self._scheduler.close()
            self._scheduler = None

    def _submit(self, queries: list, **kw) -> tuple[list, list]:
        window = self._window_dispatch(queries, **kw)
        if window is None:
            return [], []
        return self._window_collect(window)

    def _upload(self, sketches: list, copy_stream):
        dev = self.index.device
        return _ex.upload_trains(_ex.stage_trains_host(sketches, dev), dev,
                                 stream=copy_stream)

    def _window_dispatch(
        self, queries: list, *, top_k: int, min_join: int,
        prefilter: bool | None, isolate: bool, fused: bool | None = None,
        min_containment: float = 0.0, rank: str = "mi",
        priorities: list[int] | None = None, coalesced: bool = False,
        copy_stream=None,
    ) -> "_Window | None":
        """Admission + dispatch half of a submit: validate, split by
        signature, chunk, and enqueue every bucket's device work (the
        host-boundary two-phase path also syncs phase 1 here).  Returns
        an in-flight :class:`_Window` (None for an empty queue).

        ``priorities`` (one rank per query, lower = sooner) orders the
        scheduler's coalesced buckets; ``coalesced`` marks plan-cache
        traffic as cross-caller; ``copy_stream`` is the scheduler's side
        CUDA stream for the train uploads.
        """
        _check_options(rank)
        if not queries:
            return None
        st = self.admission
        st.submits += 1
        win = _Window(list(queries), isolate)
        outcomes = win.outcomes

        # 0. admission validation (isolate mode only: the legacy surface
        # keeps its raise-from-the-depths behaviour for invalid inputs).
        admitted: list[int] = []
        for qi, sk in enumerate(queries):
            if isolate:
                bad = resilience.validate_query(sk, self.index)
                if bad is not None:
                    code, detail = bad
                    outcomes[qi] = QueryOutcome(
                        qi, "quarantined", error=code, detail=detail
                    )
                    st.quarantined += 1
                    continue
            admitted.append(qi)
        st.submitted += len(admitted)
        if not admitted:
            return win

        C = win.C = len(self.index)
        version = win.version = self.index._version
        use_pref = self.index._use_prefilter(prefilter, min_join)
        use_fused = use_pref and (True if fused is None else bool(fused))
        use_gate = use_fused and float(min_containment) > 0.0
        if float(min_containment) > 0.0 and not use_fused:
            raise ValueError(
                "min_containment > 0 requires the fused two-phase "
                "pipeline (prefilter off or fused=False disables the "
                "path the phase-0 gate fronts)"
            )
        n_shards = self.mesh.shape["data"] if self.mesh is not None else 1
        primary_rung = "distributed" if self._dist is not None else "batched"
        win.top_k, win.min_join, win.rank = top_k, min_join, rank
        win.min_containment = min_containment
        win.use_pref, win.n_shards = use_pref, n_shards

        # 1. split the queue by target dtype -> estimator signature and
        # chunk it (nothing flushes mid-dispatch, so one plan per dtype).
        entries: list[tuple] = []
        try:
            sigs: dict[bool, tuple] = {}
            for qi in admitted:
                y_disc = bool(queries[qi].value_is_discrete)
                if y_disc not in sigs:
                    sigs[y_disc] = plan_signature(self.index.plan(y_disc))
                entries.append((
                    qi, sigs[y_disc],
                    0 if priorities is None else int(priorities[qi]),
                ))
        except Exception as e:  # noqa: BLE001 — isolate into outcomes
            if not isolate:
                raise
            # Planning failed for the whole queue (e.g. empty index):
            # there is no per-bucket ladder to descend yet.
            for qi in admitted:
                outcomes[qi] = QueryOutcome(
                    qi, "failed", error="plan_failed", detail=repr(e)
                )
            st.lost_queries += len(admitted)
            return win

        buckets = coalesce_queries(entries, self.max_q_bucket)
        per_sig: dict[tuple, int] = {}
        for b in buckets:
            per_sig[b.signature] = per_sig.get(b.signature, 0) + 1
        for sig, n_chunks in per_sig.items():
            st.signatures.add(sig)
            st.split_batches += n_chunks - 1
        jobs = win.jobs = [
            _BucketJob(list(b.chunk), b.signature[0],
                       [queries[i] for i in b.chunk], b.q_bucket)
            for b in buckets
        ]
        if rank == "hybrid":
            for job in jobs:
                job.tsize = np.array([max(int(sk.size), 1)
                                      for sk in job.sketches], np.float32)

        # 2. dispatch every bucket before any collect.  With the
        # prefilter on and fused off, "dispatch" is phase 1 only.
        for job in jobs:
            job.rung = primary_rung
            try:
                job.sp = self.plan_cache.lookup(
                    version, job.y_disc, job.q_bucket,
                    lambda y=job.y_disc: self.index.plan(y),
                    coalesced=coalesced,
                )
                job.staged = {
                    "batches": 1,
                    "padded_lanes": job.q_bucket - len(job.chunk),
                    "q_buckets": {job.q_bucket},
                    "host_syncs": 1,
                }
                job.trains = self._upload(job.sketches, copy_stream)
                if use_gate:
                    job.handle = self._tiered_dispatch(
                        job, min_join, min_containment, top_k, n_shards, C,
                        version,
                    )
                elif use_fused:
                    job.handle = self._fused_dispatch(
                        job, min_join, top_k, n_shards, C, version)
                elif use_pref:
                    ex = self._dist if self._dist is not None \
                        else self._batched
                    job.pend1 = ex.prefilter_dispatch(
                        job.sp.plan, job.trains, q_bucket=job.q_bucket
                    )
                elif self._dist is not None:
                    job.handle = self._dist.topk_dispatch(
                        job.sp.plan, job.trains, topk_oversample(top_k, C),
                        q_bucket=job.q_bucket, tsize=job.tsize,
                    )
                else:
                    job.handle = self._batched.dispatch(
                        job.sp.plan, job.trains, q_bucket=job.q_bucket
                    )
            except Exception as e:  # noqa: BLE001 — bucket-isolated
                job.error = e
                if not isolate:
                    st.failed_buckets += 1
                    raise

        # 2b. host-boundary two-phase buckets only: collect join sizes,
        # build shortlists and dispatch phase 2 for every bucket before
        # any phase-2 collect.
        if use_pref and not use_fused:
            for job in jobs:
                if job.error is not None:
                    continue
                try:
                    job.handle = self._shortlist_phase(
                        job, min_join, top_k, n_shards, C, version)
                except Exception as e:  # noqa: BLE001
                    job.error = e
                    if not isolate:
                        st.failed_buckets += 1
                        raise
        return win

    def _window_collect(self, win: "_Window") -> tuple[list, list]:
        """Collect half of a submit: sync each bucket's results, fence,
        rank against the corpus size the window dispatched with, scatter
        to arrival order, and run the recovery ladder for failed
        buckets."""
        st = self.admission
        queries, results, outcomes = win.queries, win.results, win.outcomes
        C, version = win.C, win.version
        top_k, min_join, rank, isolate = (win.top_k, win.min_join, win.rank,
                                          win.isolate)
        n_shards = win.n_shards
        for job in win.jobs:
            if job.error is not None:
                continue
            try:
                triples = self._collect_triples(
                    job, C, min_join, top_k, n_shards, version,
                    min_containment=win.min_containment,
                )
            except Exception as e:  # noqa: BLE001
                job.error = e
                if not isolate:
                    st.failed_buckets += 1
                    raise
                continue
            self._finish(job, triples, queries, results, outcomes,
                         top_k, min_join, isolate, rank=rank, C=C)
        # Recovery is ungated: a rung that rescues a failing bucket adds
        # no approximate filter on top.
        for job in win.jobs:
            if job.error is not None:
                st.failed_buckets += 1
                self._recover(job, queries, results, outcomes, top_k,
                              min_join, win.use_pref, n_shards, C, version,
                              rank=rank)
        return results, outcomes

    def _shortlist_phase(self, job: _BucketJob, min_join: int, top_k: int,
                         n_shards: int, C: int, version: int,
                         rung: str | None = None):
        """Collect a bucket's phase-1 join sizes, build its shortlists,
        stage the prefilter stat deltas, and dispatch phase 2 on the
        bucket's rung."""
        on_mesh = (rung or job.rung) == "distributed"
        pend1 = job.pend1
        # A fused handle that overflowed replays its own phase-1 join
        # sizes (already on the device) instead of recomputing them.
        js = pend1.js_blocks() if hasattr(pend1, "js_blocks") \
            else pend1.collect()
        job.staged["host_syncs"] = job.staged.get("host_syncs", 1) + 1
        shortlists = build_shortlists(job.sp.plan, js, min_join,
                                      multiple=n_shards if on_mesh else 1)
        s_key = shortlist_signature(shortlists)
        self.plan_cache.lookup(
            version, job.y_disc, job.q_bucket,
            lambda p=job.sp.plan: p, s_key=s_key,
        )
        job.staged["prefiltered"] = len(job.chunk)
        job.staged["cands_considered"] = len(job.chunk) * C
        job.staged["cands_shortlisted"] = sum(
            sl.shortlisted for sl in shortlists if sl is not None
        )
        job.staged["s_buckets"] = {b for _, b in s_key}
        if on_mesh:
            return self._dist.shortlist_topk_dispatch(
                job.sp.plan, job.trains, shortlists, top_k,
                q_bucket=job.q_bucket, tsize=job.tsize)
        return self._batched.shortlist_dispatch(
            job.sp.plan, job.trains, shortlists, q_bucket=job.q_bucket
        )

    def _fused_dispatch(self, job: _BucketJob, min_join: int, top_k: int,
                        n_shards: int, C: int, version: int):
        """Enqueue a bucket's whole fused two-phase pipeline; the
        compaction widths come from the index's adaptive hints (per shard
        on the mesh)."""
        on_mesh = job.rung == "distributed"
        plan = job.sp.plan
        spec = fused_shortlist_spec(plan, self.index.shortlist_hints,
                                    min_join,
                                    multiple=n_shards if on_mesh else 1,
                                    sharded=on_mesh)
        s_key = tuple(("fused", gp.est_id, s)
                      for gp, s in zip(plan.groups, spec.s_buckets))
        self.plan_cache.lookup(
            version, job.y_disc, job.q_bucket, lambda p=plan: p, s_key=s_key,
        )
        job.staged["prefiltered"] = len(job.chunk)
        job.staged["cands_considered"] = len(job.chunk) * C
        job.staged["s_buckets"] = set(spec.s_buckets)
        job.staged["fused_windows"] = 1
        if on_mesh:
            return self._dist.fused_topk_dispatch(
                plan, job.trains, spec, min_join, top_k,
                q_bucket=job.q_bucket, tsize=job.tsize)
        return self._batched.fused_dispatch(plan, job.trains, spec, min_join,
                                            q_bucket=job.q_bucket)

    def _tiered_dispatch(self, job: _BucketJob, min_join: int,
                         min_containment: float, top_k: int, n_shards: int,
                         C: int, version: int):
        """Enqueue a bucket's phase-0-gated pipeline: the corpus-wide
        signature sweep and the fused chain, one dispatch, one collect.
        Survivor and shortlist widths come from the tier hints and join
        the plan-cache key (``"tier0"`` entries beside ``"fused"`` ones,
        so a gated window never shares its ungated twin's entry)."""
        on_mesh = job.rung == "distributed"
        mult = n_shards if on_mesh else 1
        plan = job.sp.plan
        hints = self.index.tier_hints
        tspec = tier_spec(plan, hints, min_containment, multiple=mult,
                          sharded=on_mesh)
        spec = fused_shortlist_spec(plan, hints, min_join, multiple=mult,
                                    sharded=on_mesh)
        s_key = tuple(("fused", gp.est_id, s)
                      for gp, s in zip(plan.groups, spec.s_buckets))
        self.plan_cache.lookup(
            version, job.y_disc, job.q_bucket, lambda p=plan: p,
            s_key=s_key + tspec.signature,
        )
        job.staged["prefiltered"] = len(job.chunk)
        job.staged["cands_considered"] = len(job.chunk) * C
        job.staged["cands_considered_t0"] = len(job.chunk) * C
        job.staged["s_buckets"] = set(spec.s_buckets)
        job.staged["fused_windows"] = 1
        job.staged["gated_windows"] = 1
        job.staged["signature_bytes"] = \
            self.index.ingest_stats["signature_bytes"]
        if on_mesh:
            return self._dist.tiered_topk_dispatch(
                plan, job.trains, tspec, spec, min_join, min_containment,
                top_k, q_bucket=job.q_bucket, tsize=job.tsize)
        return self._batched.tiered_dispatch(
            plan, job.trains, tspec, spec, min_join, min_containment,
            q_bucket=job.q_bucket,
        )

    def _collect_triples(self, job: _BucketJob, C: int, min_join: int,
                         top_k: int, n_shards: int, version: int,
                         min_containment: float = 0.0) -> list:
        """First host sync of a bucket's handle -> one (values, global
        indices, join sizes) triple per query.  A fused handle checks its
        overflow fence here: on overflow the hints grow and the bucket
        falls back to the host boundary, reusing the fused pass's join
        sizes.  A tiered handle that overflows grows both rungs and
        re-runs the bucket through the ungated fused path."""
        handle = job.handle
        if isinstance(handle, _ex._PendingScores):
            mi, js = handle.collect()
            gi = np.arange(C, dtype=np.int32)
            return [(mi[q], gi, js[q]) for q in range(len(job.chunk))]
        if isinstance(handle, (_ex._PendingTiered, _ex._PendingTieredTopk)):
            return self._collect_tiered(job, handle, C, min_join, top_k,
                                        n_shards, version, min_containment)
        if isinstance(handle, (_ex._PendingFused, _ex._PendingFusedTopk)):
            on_mesh = isinstance(handle, _ex._PendingFusedTopk)
            hints = self.index.shortlist_hints
            try:
                triples = handle.collect()
            except ShortlistOverflow:
                for eid, seen in handle.observed.items():
                    hints.observe((job.y_disc, eid, int(min_join), on_mesh),
                                  seen, overflowed=True)
                job.pend1 = handle
                job.handle = self._shortlist_phase(job, min_join, top_k,
                                                   n_shards, C, version)
                job.staged["host_syncs"] = 3
                job.staged["fused_windows"] = 0
                return self._collect_triples(job, C, min_join, top_k,
                                             n_shards, version)
            for eid, seen in handle.observed.items():
                hints.observe((job.y_disc, eid, int(min_join), on_mesh), seen)
            job.staged["cands_shortlisted"] = handle.shortlisted
            return triples
        return handle.collect()

    def _collect_tiered(self, job: _BucketJob, handle, C: int,
                        min_join: int, top_k: int, n_shards: int,
                        version: int, min_containment: float) -> list:
        on_mesh = isinstance(handle, _ex._PendingTieredTopk)
        hints = self.index.tier_hints
        mc_key = round(float(min_containment), 6)
        try:
            triples = handle.collect()
        except SurvivorOverflow:
            for eid, seen in handle.observed_t0.items():
                hints.observe(("tier0", job.y_disc, eid, mc_key, on_mesh),
                              seen, overflowed=True)
            for eid, seen in handle.observed.items():
                # The truncated survivor buffer truncated this count too;
                # the survivor count bounds it from above.
                hints.observe((job.y_disc, eid, int(min_join), on_mesh),
                              max(seen, handle.observed_t0.get(eid, 0)),
                              overflowed=True)
            # The gate did not deliver this window: its staged counters
            # are withdrawn, and the sync its fence paid is added to what
            # the ungated re-run stages.
            job.staged["gated_windows"] = 0
            job.staged.pop("cands_considered_t0", None)
            job.staged.pop("signature_bytes", None)
            job.handle = self._fused_dispatch(job, min_join, top_k, n_shards,
                                              C, version)
            triples = self._collect_triples(job, C, min_join, top_k,
                                            n_shards, version)
            job.staged["host_syncs"] = job.staged.get("host_syncs", 1) + 1
            return triples
        for eid, seen in handle.observed_t0.items():
            hints.observe(("tier0", job.y_disc, eid, mc_key, on_mesh), seen)
        for eid, seen in handle.observed.items():
            hints.observe((job.y_disc, eid, int(min_join), on_mesh), seen)
        job.staged["cands_gated_t0"] = handle.survivors
        job.staged["cands_shortlisted"] = handle.shortlisted
        return triples

    def _finish(
        self, job: _BucketJob, triples: list, queries: list,
        results: list, outcomes: list, top_k: int, min_join: int,
        isolate: bool, rank: str = "mi", C: int | None = None,
    ) -> None:
        """Rank a delivered bucket (fencing non-finite lanes first in
        isolate mode, per query row), scatter results, emit outcomes,
        and commit the bucket's staged stat deltas.  ``C`` is the corpus
        size the scores were computed against; ``rank="hybrid"`` scales
        each score by join_size / train_size before ranking.  The
        distributed rung's shard programs applied that weight on the
        device before their top-k (``job.tsize``), so only the lanes the
        non-finite fence recomputes are weighted here."""
        st = self.admission
        C = len(self.index) if C is None else int(C)
        weighted = job.tsize is not None and job.rung == "distributed"
        for row, qi in enumerate(job.chunk):
            v, gi, js = triples[row]
            nf = 0
            fenced = None
            if isolate:
                v, gi, js = np.asarray(v), np.asarray(gi), np.asarray(js)
                eligible = (gi < C) & (js >= min_join)
                v = resilience.corrupt_scores(v, eligible)
                fenced = (~np.isfinite(np.asarray(v, np.float32))
                          & (gi < len(self.index)) & (js >= min_join))
                v, nf = resilience.fence_nonfinite(
                    v, gi, js, self.index, queries[qi], min_join, self.k
                )
                st.nonfinite_lanes += nf
            if rank == "hybrid" and not (weighted and nf == 0):
                tsize = max(int(queries[qi].size), 1)
                w = np.asarray(js, np.float32) / np.float32(tsize)
                v = np.asarray(v, np.float32)
                # Weighted on the device already: only the lanes the
                # fence recomputed.
                v = np.where(fenced, v * w, v) if weighted else v * w
            results[qi] = self.index._rank(v, gi, js, top_k, min_join, C=C)
            if isolate:
                outcomes[qi] = QueryOutcome(
                    qi, "ok", rung=job.rung, retries=job.retries,
                    fallbacks=job.fallbacks, nonfinite_lanes=nf,
                )
        staged = job.staged
        st.batches += staged.get("batches", 0)
        st.padded_lanes += staged.get("padded_lanes", 0)
        st.prefiltered += staged.get("prefiltered", 0)
        st.cands_considered += staged.get("cands_considered", 0)
        st.cands_shortlisted += staged.get("cands_shortlisted", 0)
        st.q_buckets.update(staged.get("q_buckets", ()))
        st.s_buckets.update(staged.get("s_buckets", ()))
        st.host_syncs += staged.get("host_syncs", 0)
        st.fused_windows += staged.get("fused_windows", 0)
        st.gated_windows += staged.get("gated_windows", 0)
        st.cands_considered_t0 += staged.get("cands_considered_t0", 0)
        st.cands_gated_t0 += staged.get("cands_gated_t0", 0)
        if "signature_bytes" in staged:
            st.signature_bytes = staged["signature_bytes"]

    # ------------------------------------------------------------------
    # Recovery ladder
    # ------------------------------------------------------------------

    def _recover(
        self, job: _BucketJob, queries: list, results: list,
        outcomes: list, top_k: int, min_join: int, use_pref: bool,
        n_shards: int, C: int, version: int, rank: str = "mi",
    ) -> None:
        """Retry a failed bucket with bounded backoff, descending the
        executor ladder (distributed, with a mesh; batched; reference)
        between rungs; other buckets are untouched.  The primary pass
        spent its rung's first attempt; each lower rung gets a fresh
        attempt plus retries.  The reference rung — the dense per-query
        path of :meth:`SketchIndex.query`, free of every fault site — is
        the last."""
        st = self.admission
        policy = self.retry_policy
        rungs = (["distributed"] if self._dist is not None else []) \
            + ["batched", "reference"]
        last_err = job.error
        for ri, rung in enumerate(rungs):
            if ri > 0:
                job.fallbacks += 1
                st.fallbacks += 1
            delays = policy.delays()
            for attempt in range(1 if ri == 0 else 0, 1 + len(delays)):
                if attempt > 0:
                    policy.sleep(delays[attempt - 1])
                    job.retries += 1
                    st.retries += 1
                try:
                    triples = self._run_bucket(job, queries, top_k, min_join,
                                               use_pref, n_shards, C, version,
                                               rung)
                    job.rung = rung
                    job.error = None
                    self._finish(job, triples, queries, results, outcomes,
                                 top_k, min_join, True, rank=rank, C=C)
                    return
                except Exception as e:  # noqa: BLE001 — keep descending
                    last_err = e
        for qi in job.chunk:
            outcomes[qi] = QueryOutcome(
                qi, "failed", rung=rungs[-1], error="ladder_exhausted",
                detail=repr(last_err), retries=job.retries,
                fallbacks=job.fallbacks,
            )
        st.lost_queries += len(job.chunk)

    def _run_bucket(self, job: _BucketJob, queries: list, top_k: int,
                    min_join: int, use_pref: bool, n_shards: int, C: int,
                    version: int, rung: str) -> list:
        """Synchronously re-execute one bucket on the given rung and
        return its per-query triples (``job.staged`` is rebuilt to match
        what this run did)."""
        job.staged = {
            "batches": 1,
            "padded_lanes": (job.q_bucket - len(job.chunk)
                             if rung != "reference" else 0),
            "q_buckets": {job.q_bucket} if rung != "reference" else set(),
            "host_syncs": 1,
        }
        if rung == "reference":
            ex = _ex.PartitionedLocalExecutor(k=self.k)
            triples = []
            for qi in job.chunk:
                train = self.index.train_arrays(queries[qi])
                mi, js = ex.execute(job.sp.plan, train)
                triples.append((mi[0], np.arange(C), js[0]))
            return triples
        ex = self._dist if rung == "distributed" else self._batched
        job.trains = _ex.stack_trains_host(job.sketches, self.index.device)
        if use_pref:
            job.pend1 = ex.prefilter_dispatch(
                job.sp.plan, job.trains, q_bucket=job.q_bucket
            )
            job.handle = self._shortlist_phase(job, min_join, top_k,
                                               n_shards, C, version,
                                               rung=rung)
        elif rung == "distributed":
            job.handle = ex.topk_dispatch(
                job.sp.plan, job.trains, topk_oversample(top_k, C),
                q_bucket=job.q_bucket, tsize=job.tsize,
            )
        else:
            job.handle = ex.dispatch(
                job.sp.plan, job.trains, q_bucket=job.q_bucket
            )
        return self._collect_triples(job, C, min_join, top_k, n_shards,
                                     version)

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """Serving counters: admission decisions, resilience traffic
        (quarantine / retry / fallback / fence), plan-cache traffic, the
        compiled programs built so far
        (:func:`~repro_torch.compile.compile_count`), ingest transfer
        accounting, the device bytes of each tier (full
        sketches; phase-0 signatures, and the signature width) and, once
        ``submit_async`` attached it, the scheduler's telemetry."""
        ingest = self.index.ingest_stats
        return {
            "admission": self.admission.as_dict(),
            "plan_cache": self.plan_cache.stats,
            "compiled_programs": compile_count(),
            "ingest": ingest,
            "tiers": {
                "sketch_bytes": ingest["sketch_bytes"],
                "signature_bytes": ingest["signature_bytes"],
                "signature_width": self.index._sig_cols(),
            },
            "scheduler": (
                self._scheduler.stats() if self._scheduler is not None
                else None
            ),
        }

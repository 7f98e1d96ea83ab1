"""Query planner (PyTorch port): estimator partitioning, group-major
layout, the power-of-two bucket ladders and the shortlist machinery of
two-phase retrieval.

The subset of ``repro.core.discovery.planner`` the discovery path
reads.  A :class:`QueryPlan` fixes, once per corpus version and target
dtype, which estimator scores each candidate and the padded group-major
device layout every executor runs on.  Two-phase retrieval pads its
shortlist axis up its own pow-2 ladder; :func:`build_shortlists` is the
host-side phase boundary, and :class:`ShortlistHints` /
:func:`fused_shortlist_spec` choose the on-device compaction widths of
the fused path before phase 1 runs, with :class:`ShortlistOverflow` as
the fallback signal when a width guess was too small.  The phase-0
containment gate sizes its survivor buffer up a third pow-2 ladder
(:func:`bucket_survivors`, :func:`tier_spec`), with
:class:`SurvivorOverflow` as its fallback signal.

:func:`make_plan` / :func:`pack_group` lay out a raw stacked candidate
dict (the ad-hoc scorers' input) the way the index lays out its stores.

On a mesh every ladder takes ``multiple=`` (the shard count): a rung
that does not divide it is rounded up to a multiple, so each shard holds
the same number of rows or lanes; for power-of-two shard counts the
ladders are unchanged.  The fused and gated widths are per shard there
(``sharded=`` keys the hints apart from the single-device path's).

For the service: :func:`plan_signature` / :func:`shortlist_signature`
(what a batch's layout is keyed on), :func:`coalesce_queries` (split a
queue by signature, chunk it at ``max_q_bucket`` and bucket each chunk
up the pow-2 Q ladder, :func:`bucket_queries`), and :class:`PlanCache` /
:class:`ServicePlan`.  The Q ladder bounds the compiled programs
(:mod:`repro_torch.compile`) a bursty queue can build to one per
(signature, Q bucket, width), as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.join import effective_keys

__all__ = [
    "EST_MLE",
    "EST_MIXED",
    "EST_DC_XD",
    "EST_DC_YD",
    "estimator_id",
    "partition_by_estimator",
    "bucket_rows",
    "bucket_shortlist",
    "MIN_BUCKET",
    "MIN_SHORTLIST",
    "MIN_SURVIVORS",
    "bucket_survivors",
    "bucket_queries",
    "GroupPlan",
    "QueryPlan",
    "Shortlist",
    "ShortlistOverflow",
    "SurvivorOverflow",
    "ShortlistHints",
    "FusedSpec",
    "fused_shortlist_spec",
    "stage_min_containment",
    "TierSpec",
    "tier_spec",
    "build_shortlists",
    "MAX_Q_BUCKET",
    "plan_signature",
    "shortlist_signature",
    "CoalescedBucket",
    "coalesce_queries",
    "ServicePlan",
    "PlanCache",
    "group_rows",
    "pack_group",
    "make_plan",
]

# Estimator ids (stable across the repo and equal to the reference's).
EST_MLE, EST_MIXED, EST_DC_XD, EST_DC_YD = 0, 1, 2, 3

# Smallest bucket on the shared group-size ladder.
MIN_BUCKET = 8

# Smallest bucket on the shortlist-size ladder.
MIN_SHORTLIST = 8

# Smallest bucket on the phase-0 survivor ladder (tiered retrieval).
MIN_SURVIVORS = 8

# Largest rung of the Q-axis ladder: the most queries an admission
# controller hands to one executor pass; larger queues are chunked.
MAX_Q_BUCKET = 64


def estimator_id(x_discrete: bool, y_discrete: bool) -> int:
    """Estimator for a (candidate dtype, target dtype) pair."""
    if x_discrete and y_discrete:
        return EST_MLE
    if not x_discrete and not y_discrete:
        return EST_MIXED
    return EST_DC_XD if x_discrete else EST_DC_YD


def partition_by_estimator(est_id: np.ndarray) -> list[tuple[int, np.ndarray]]:
    """Stable partition of the candidate axis by estimator id."""
    est_id = np.asarray(est_id)
    return [
        (int(eid), np.flatnonzero(est_id == eid))
        for eid in np.unique(est_id)
    ]


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _round_up(b: int, multiple: int) -> int:
    """``b`` rounded up to a multiple of ``multiple`` (a mesh shard count)
    when it does not already divide."""
    if multiple > 1 and b % multiple:
        b = -(-b // multiple) * multiple
    return b


def bucket_rows(n: int, multiple: int = 1) -> int:
    """Next power of two >= max(n, MIN_BUCKET), rounded up to
    ``multiple``."""
    return _round_up(_next_pow2(max(n, MIN_BUCKET)), multiple)


def bucket_shortlist(n: int, multiple: int = 1) -> int:
    """Shortlist-ladder bucket for ``n`` prefilter survivors: next power
    of two >= max(n, MIN_SHORTLIST), rounded up to ``multiple``."""
    return _round_up(_next_pow2(max(n, MIN_SHORTLIST)), multiple)


def bucket_survivors(n: int, multiple: int = 1) -> int:
    """Survivor-ladder bucket for ``n`` phase-0 gate survivors: next
    power of two >= max(n, MIN_SURVIVORS), rounded up to ``multiple``."""
    return _round_up(_next_pow2(max(n, MIN_SURVIVORS)), multiple)


def bucket_queries(q: int, cap: int = MAX_Q_BUCKET) -> int:
    """Q-axis ladder bucket for a batch of ``q`` queries: the next power
    of two >= q.  A bucket above ``cap`` raises: an admission controller
    chunks batches at ``cap`` first, so the leading-Q shapes are exactly
    {1, 2, 4, ..., cap}."""
    if q < 1:
        raise ValueError(f"batch of {q} queries")
    b = _next_pow2(q)
    if b > cap:
        raise ValueError(
            f"Q={q} exceeds the bucket cap {cap}; chunk the batch first"
        )
    return b


@dataclass(frozen=True)
class GroupPlan:
    """One homogeneous estimator group in group-major device layout.

    ``arrays`` rows [0, size) hold live candidates (keys in effective
    int64 form); rows [size, bucket) are dead (mask all-False, join
    empty, score 0.0).  ``index`` maps group row -> global candidate
    index; dead rows map to the sentinel ``n_candidates``.
    ``index_dev`` / ``live`` are the device copies the fused path reads;
    ``sig`` is the group's (bucket, w + 1) int32 signature tier, or
    None when the index keeps none.
    """

    est_id: int
    arrays: dict  # keys int64 / vals_f float32 / vals_u int64 / mask bool
    index: np.ndarray  # (bucket,) int32, dead rows -> n_candidates
    live: torch.Tensor  # (bucket,) bool, on the device
    size: int  # live rows
    index_dev: torch.Tensor = field(default=None, compare=False, repr=False)
    sig: torch.Tensor | None = field(default=None, compare=False, repr=False)

    @property
    def bucket(self) -> int:
        return int(self.live.shape[0])


@dataclass(frozen=True)
class QueryPlan:
    """Everything an executor needs to score one corpus layout."""

    y_discrete: bool
    n_candidates: int
    groups: list[GroupPlan] = field(default_factory=list)
    device: torch.device = field(default=torch.device("cpu"), compare=False)


@dataclass(frozen=True)
class Shortlist:
    """Phase-2 layout for one estimator group: the group rows that
    survived the join-size prefilter, per query.  ``rows`` (Q, s_bucket)
    ascending per query, padded with row 0; padded slots carry ``gidx``
    = ``n_candidates`` and ``js`` = 0 and are scored but never ranked."""

    group: GroupPlan
    rows: np.ndarray  # (Q, s_bucket) int32 group-row indices, pad -> 0
    gidx: np.ndarray  # (Q, s_bucket) int32 global ids, pad -> sentinel
    js: np.ndarray  # (Q, s_bucket) int32 join sizes, pad -> 0
    s_bucket: int
    shortlisted: int  # live (query, candidate) entries across all Q


def build_shortlists(
    plan: QueryPlan,
    js_blocks: list,
    min_join: int,
    multiple: int = 1,
) -> list:
    """Turn phase-1 join sizes into per-group phase-2 shortlists.

    ``js_blocks`` pairs each :class:`GroupPlan` with its host (Q,
    bucket) join-size matrix.  Rows passing ``min_join`` (live rows only)
    become the shortlist, ascending, padded up the pow-2 shortlist
    ladder shared across the batch's queries (rounded up to ``multiple``,
    the mesh's shard count, whose extra lanes are padding); a group with
    no survivor for any query yields ``None``.
    """
    out = []
    for gp, js in js_blocks:
        js = np.asarray(js)
        Q = js.shape[0]
        live = np.asarray(gp.index) < plan.n_candidates
        passing = (js >= min_join) & live[None, :]
        counts = passing.sum(axis=1)
        s_max = int(counts.max(initial=0))
        if s_max == 0:
            out.append(None)
            continue
        s_bucket = min(bucket_shortlist(s_max, multiple),
                       bucket_rows(gp.bucket, multiple))
        take = min(s_bucket, passing.shape[1])
        order = np.argsort(~passing, axis=1, kind="stable")[:, :take]
        if take < s_bucket:
            order = np.concatenate(
                [order, np.zeros((Q, s_bucket - take), order.dtype)],
                axis=1,
            )
        lane_live = np.arange(s_bucket)[None, :] < counts[:, None]
        rows = np.where(lane_live, order, 0).astype(np.int32)
        gidx = np.where(
            lane_live, gp.index[order], np.int32(plan.n_candidates)
        ).astype(np.int32)
        jsz = np.where(
            lane_live, np.take_along_axis(js, order, axis=1), 0
        ).astype(np.int32)
        out.append(Shortlist(gp, rows, gidx, jsz, s_bucket, int(counts.sum())))
    return out


class ShortlistOverflow(Exception):
    """Fused compaction found more prefilter survivors than the staged
    ``s_bucket`` has lanes for; the caller falls back to the host
    :func:`build_shortlists` boundary for this batch, reusing the
    already-computed join sizes."""


class SurvivorOverflow(Exception):
    """The phase-0 gate found more survivors than the staged survivor
    buffer has lanes for (or the within-survivor shortlist more than its
    width); the caller re-runs the window through the ungated fused
    path, and the observation grows the rungs so the next window at this
    selectivity stays gated."""


class ShortlistHints:
    """Adaptive per-workload shortlist-bucket predictor.

    Grows immediately to ``bucket_shortlist(observed)`` when a batch
    overflows or fills its rung; shrinks only with a full rung of
    headroom (``bucket * 4 <= current``), then to ``bucket * 2``.
    """

    def __init__(self):
        self._rungs: dict[tuple, int] = {}
        self.overflows = 0

    def get(self, key: tuple) -> int:
        return self._rungs.get(key, MIN_SHORTLIST)

    def observe(self, key: tuple, observed: int, overflowed: bool = False) -> None:
        tgt = bucket_shortlist(int(observed))
        cur = self._rungs.get(key, MIN_SHORTLIST)
        if overflowed:
            self.overflows += 1
        if tgt > cur:
            self._rungs[key] = tgt
        elif tgt * 4 <= cur:
            self._rungs[key] = tgt * 2


@dataclass(frozen=True)
class FusedSpec:
    """Per-group compaction widths for one fused two-phase pass,
    aligned with ``plan.groups``."""

    s_buckets: tuple


def _width(rung: int, bucket: int, multiple: int) -> int:
    """A group's compaction width: its rung clamped to the group's rows,
    or on a mesh the per-shard rung clamped to a shard's rows, times the
    shard count."""
    if multiple > 1:
        rows_local = max(bucket_rows(bucket, multiple) // multiple, 1)
        return min(rung, rows_local) * multiple
    return min(rung, bucket_rows(bucket))


def fused_shortlist_spec(
    plan: QueryPlan,
    hints: ShortlistHints,
    min_join: int,
    multiple: int = 1,
    sharded: bool = False,
) -> FusedSpec:
    """Choose each group's compaction width from the hint table (clamped
    to the group's row bucket).  On a mesh (``multiple`` shards) the
    compaction and its overflow fence are per shard, so the width is the
    per-shard rung times the shard count; ``sharded`` keys the hints so
    that per-shard counts do not feed the single-device rungs."""
    s_buckets = []
    for gp in plan.groups:
        key = (bool(plan.y_discrete), gp.est_id, int(min_join), sharded)
        rung = bucket_shortlist(hints.get(key))
        s_buckets.append(_width(rung, gp.bucket, multiple))
    return FusedSpec(tuple(s_buckets))


def stage_min_containment(min_containment: float) -> float:
    """The gate's threshold: ``min_containment`` rounded to 6 decimals
    (part of the reference's semantics: 0.1234567 gates at 0.123457),
    then to float32, returned as the Python float of that float32 value
    so that the compare is the same in float32 and in float64."""
    return float(np.float32(round(float(min_containment), 6)))


@dataclass(frozen=True)
class TierSpec:
    """Per-group phase-0 survivor-buffer widths for one tiered pass,
    aligned with ``plan.groups``; ``signature`` is the tier's part of
    the plan-cache ``s_key`` (``"tier0"`` entries, disjoint from the
    ``"fused"`` ones, so a gated window and its ungated twin never share
    an entry)."""

    s_survivors: tuple
    signature: tuple


def tier_spec(plan: QueryPlan, hints: ShortlistHints,
              min_containment: float, multiple: int = 1,
              sharded: bool = False) -> TierSpec:
    """Choose each group's survivor-buffer width from the hint table, as
    :func:`fused_shortlist_spec` does (per shard on a mesh), the hint
    keyed on the rounded threshold (survivor counts track the gate's
    selectivity, not ``min_join``) and clamped to the group's row
    bucket."""
    mc_key = round(float(min_containment), 6)
    s_survivors = []
    for gp in plan.groups:
        key = ("tier0", bool(plan.y_discrete), gp.est_id, mc_key, sharded)
        rung = bucket_survivors(hints.get(key))
        s_survivors.append(_width(rung, gp.bucket, multiple))
    sig = tuple(("tier0", gp.est_id, s)
                for gp, s in zip(plan.groups, s_survivors))
    return TierSpec(tuple(s_survivors), sig)


def plan_signature(plan: QueryPlan) -> tuple:
    """Estimator signature of a plan: the target dtype, then (est_id,
    bucket) per group.  The service batches queries by signature."""
    return (bool(plan.y_discrete),) + tuple(
        (gp.est_id, gp.bucket) for gp in plan.groups
    )


def shortlist_signature(shortlists: list) -> tuple:
    """Layout signature of a phase-2 pass: ((est_id, s_bucket), ...) over
    the non-empty groups; extends the plan-cache key of a two-phase
    batch."""
    return tuple(
        (sl.group.est_id, sl.s_bucket)
        for sl in shortlists if sl is not None
    )


@dataclass(frozen=True)
class CoalescedBucket:
    """One dispatchable bucket produced by :func:`coalesce_queries`:
    queries from (possibly) many callers that share an estimator
    signature.  ``chunk`` holds caller-supplied query ids in
    priority-then-arrival order; ``priority`` is the best (lowest)
    priority rank present; ``q_bucket`` is the chunk's rung on the Q
    ladder (:func:`bucket_queries`)."""

    signature: tuple
    chunk: tuple
    priority: int
    q_bucket: int


def coalesce_queries(entries, cap: int = MAX_Q_BUCKET) -> list[CoalescedBucket]:
    """Pack ``(query_id, signature, priority)`` entries into pow-2 Q
    buckets of at most ``cap`` queries — the coalescing core of both the
    service's admission (one caller, priority 0 throughout) and the
    micro-batch scheduler (many callers, interactive before batch).

    Grouping is by signature in first-seen order; within a group,
    members sort by (priority, arrival), so interactive queries fill the
    earlier chunks when a group overflows ``cap``.  Buckets are stably
    ordered by priority, so equal-priority traffic dispatches in arrival
    order.
    """
    if cap < 1:
        raise ValueError(f"bucket cap must be >= 1, got {cap}")
    groups: dict[tuple, list] = {}
    for seq, (qid, sig, pr) in enumerate(entries):
        groups.setdefault(sig, []).append((int(pr), seq, qid))
    buckets: list[CoalescedBucket] = []
    for sig, members in groups.items():
        members.sort(key=lambda t: (t[0], t[1]))
        for lo in range(0, len(members), cap):
            part = members[lo:lo + cap]
            buckets.append(CoalescedBucket(
                signature=sig,
                chunk=tuple(qid for _, _, qid in part),
                priority=min(pr for pr, _, _ in part),
                q_bucket=bucket_queries(len(part), cap),
            ))
    buckets.sort(key=lambda b: b.priority)  # stable: arrival order kept
    return buckets


@dataclass(frozen=True)
class ServicePlan:
    """One admitted batch layout: a corpus plan, its Q bucket and
    signature, and for two-phase batches the shortlist signature."""

    plan: QueryPlan
    q_bucket: int
    signature: tuple
    s_key: tuple | None = None


class PlanCache:
    """Admission-control plan cache keyed on (corpus version, target
    dtype, Q bucket[, shortlist signature]), insertion-order LRU.

    It counts hits and misses so tests and ``DiscoveryService.stats()``
    can show that steady-state traffic replans nothing; ``coalesced``
    lookups (cross-caller micro-batches) share entries with solo traffic
    and are counted apart.  A failed build caches nothing and is counted
    under ``build_failures``, not as a miss.
    """

    def __init__(self, max_entries: int = 32):
        self.max_entries = max_entries
        self._entries: dict[tuple, ServicePlan] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.build_failures = 0
        self.coalesced_hits = 0
        self.coalesced_misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(
        self, version: int, y_discrete: bool, q_bucket: int,
        build, s_key: tuple | None = None, coalesced: bool = False,
    ) -> ServicePlan:
        """Cached ServicePlan for the key, building via ``build()`` — a
        zero-argument callable returning the current QueryPlan — on a
        miss."""
        key = (int(version), bool(y_discrete), int(q_bucket), s_key)
        hit = self._entries.pop(key, None)
        if hit is not None:
            self.hits += 1
            if coalesced:
                self.coalesced_hits += 1
            self._entries[key] = hit  # re-insert: LRU touch
            return hit
        try:
            plan = build()
        except Exception:
            self.build_failures += 1
            raise
        self.misses += 1
        if coalesced:
            self.coalesced_misses += 1
        sp = ServicePlan(plan, int(q_bucket), plan_signature(plan), s_key)
        while len(self._entries) >= self.max_entries:
            self._entries.pop(next(iter(self._entries)))
            self.evictions += 1
        self._entries[key] = sp
        return sp

    @property
    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "build_failures": self.build_failures,
            "coalesced_hits": self.coalesced_hits,
            "coalesced_misses": self.coalesced_misses,
        }


def group_rows(idx: np.ndarray, device,
               multiple: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """A group's candidate rows padded up the group ladder (rounded up to
    ``multiple``): (rows (bucket,) int64, the first ``len(idx)`` ``idx``
    and the rest ``idx[0]`` again; live (bucket,) bool), on ``device``.
    The ad-hoc scorers pad every group this way, so each estimator call
    sees the shapes a plan gives it."""
    g = len(idx)
    bucket = bucket_rows(g, multiple)
    rows = np.concatenate([idx, np.full(bucket - g, idx[0], idx.dtype)])
    return (torch.from_numpy(rows.astype(np.int64)).to(device),
            torch.from_numpy(np.arange(bucket) < g).to(device))


def pack_group(cands: dict, eid: int, idx: np.ndarray, n_candidates: int,
               pad_multiple: int = 1) -> GroupPlan:
    """Gather one estimator group from a raw stacked candidate dict into
    its group-major bucket (the ad-hoc path; the index keeps its group
    stores itself).

    ``cands`` holds (C, cap) tensors on one device.  Rows [g, bucket)
    repeat candidate ``idx[0]`` with an all-False mask (they join empty
    and score 0.0) and map to the sentinel ``n_candidates``; keys are
    returned in effective form.  ``pad_multiple`` (a mesh's shard count)
    rounds the bucket up to a multiple of it.
    """
    g = len(idx)
    device = cands["keys"].device
    gathered, live = group_rows(idx, device, pad_multiple)
    mask = cands["mask"][gathered] & live[:, None]
    arrays = {
        "keys": effective_keys(cands["keys"][gathered], mask),
        "vals_f": cands["vals_f"][gathered],
        "vals_u": cands["vals_u"][gathered],
        "mask": mask,
    }
    index = np.concatenate([idx.astype(np.int32), np.full(
        len(live) - g, n_candidates, np.int32)])
    return GroupPlan(eid, arrays, index, live, g,
                     torch.from_numpy(index).to(device))


def make_plan(cands: dict, y_discrete: bool, pad_multiple: int = 1,
              n_candidates: int | None = None) -> QueryPlan:
    """Plan from a raw stacked candidate dict (it must carry ``est_id``).

    Candidates whose mask is all False (stack padding) still join empty
    and score 0.0, in their original place, so executors reproduce the
    ad-hoc scorers' output shapes.  ``pad_multiple`` rounds every group
    bucket up to a multiple of a mesh's shard count (see
    :func:`pack_group`).
    """
    est = torch.as_tensor(cands["est_id"]).cpu().numpy()
    C = int(est.shape[0]) if n_candidates is None else int(n_candidates)
    groups = [
        pack_group(cands, eid, idx, C, pad_multiple)
        for eid, idx in partition_by_estimator(est[:C])
    ]
    return QueryPlan(bool(y_discrete), C, groups, cands["keys"].device)

"""Execution backends for planned discovery queries (PyTorch port).

  * :class:`PartitionedLocalExecutor` — per query, one homogeneous
    scoring pass per estimator group.
  * :class:`BatchedExecutor` — the multi-query path: every group scores
    all Q queries at once.  Its ``fused_dispatch`` runs the two-phase
    pipeline — join-size prefilter, shortlist compaction, gather, score
    — on the device with no host sync until ``collect``; its
    ``tiered_dispatch`` puts the phase-0 containment gate (a signature
    sweep and survivor compaction) in front of the same pipeline.
  * :class:`GroupMajorDistributedExecutor` — the same paths on a mesh
    (:mod:`repro_torch.launch.mesh`): each group's candidate rows split
    over the ``"data"`` axis, each shard scoring its own rows and keeping
    its top-k, the winners merged on the first device with one top-k.

Where the reference vmaps a per-sample body over (Q, candidates), the
port writes the batch dimension out: one join over all (Q × rows)
pairs, then one estimator call over all joined samples, so every
KSG-family group makes **one** ``radius_counts`` kernel launch per
batch.  PyTorch enqueues device work asynchronously, so ``dispatch``
returns pending handles whose ``collect`` is the first host sync, as
in the reference.

Each group's body — dense (:func:`_score_group`), fused
(:func:`_fused_score_group`) and tiered (:func:`_tiered_score_group`) —
runs as a compiled program (:mod:`repro_torch.compile`, the reference's
``jax.jit`` with the same static arguments): on the card it is captured
once per key as a CUDA graph and replayed after that.  The group's
device store is read in place; the trains, the plan's ``live`` /
``index_dev`` and the device scalars ``min_join``, ``sentinel`` and the
staged ``min_containment`` are the program's inputs.  ``q_bucket=`` on
every dispatch pads the query axis up the pow-2 ladder
(:func:`pad_trains_q`: dead lanes repeat lane 0), which bounds the
programs a bursty queue builds; the handles return the live lanes only.
The host-boundary two-phase path (``prefilter_dispatch`` /
``shortlist_dispatch``, the fused path's overflow fallback) runs eager.

The ad-hoc entry points take raw stacked candidate dicts (carrying
``est_id``) instead of an index: :func:`score_batch` (lexsort join, then
each candidate's estimator), :func:`score_batch_reference` (the same
with the materialized estimators) and :func:`score_batch_partitioned`
(planned through :func:`~repro_torch.core.discovery.planner.make_plan`,
scored by the partitioned executor); :func:`get_executor` resolves an
executor by name.  Where the reference's switch scorer runs all four
estimator branches under ``vmap`` and selects, :func:`score_batch`
scores each ``est_id`` group on its own, padded up the group ladder
exactly as the plan pads it, so that every estimator call sees the
batch shape the partitioned path gives it and the two agree bit for
bit on the card as on the CPU (the order in which the card reduces a
float32 row sum can depend on the batch shape).

The estimator-id -> estimator mapping lives in :func:`_estimate` only.

Fault-injection sites (:func:`~repro_torch.core.discovery.resilience.maybe_fault`)
sit where the reference has them: ``staging`` and ``stack_h2d`` in the
two halves of the train upload, ``dispatch`` / ``prefilter_dispatch`` /
``shortlist_dispatch`` / ``fused_dispatch`` / ``tiered_dispatch`` at the
batched and distributed executors' entry points (scopes ``"batched"`` and
``"distributed"``), and ``collect`` at each pending handle's first host sync.
The partitioned executor, the service's reference rung, has none.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.compile import program
from repro_torch.core import estimators
from repro_torch.core.discovery.planner import (
    EST_DC_XD,
    EST_MIXED,
    EST_MLE,
    GroupPlan,
    QueryPlan,
    ShortlistOverflow,
    SurvivorOverflow,
    _next_pow2,
    group_rows,
    make_plan,
    pack_group,
    partition_by_estimator,
    stage_min_containment,
)
from repro_torch.core.discovery.resilience import maybe_fault
from repro_torch.core.join import (
    effective_keys,
    presorted_join_size,
    signature_join_size,
    sketch_join_lexsort,
    sketch_join_presorted,
)
from repro_torch.device import canonical_device

__all__ = [
    "score_batch",
    "score_batch_reference",
    "score_batch_partitioned",
    "stack_trains",
    "stack_trains_host",
    "stage_trains_host",
    "upload_trains",
    "train_arrays",
    "pad_trains_q",
    "Executor",
    "PartitionedLocalExecutor",
    "BatchedExecutor",
    "GroupMajorDistributedExecutor",
    "get_executor",
    "distributed_topk",
]

_TRAIN_FIELDS = ("keys", "vals_f", "vals_u", "mask")

# Bound on (query, candidate, slot) probes per join-size chunk: keeps the
# phase-1 int64 temporaries near 256 MiB however large a group grows.
_JOIN_PROBES = 1 << 25


def _estimate(est_id: int, xf, xu, y_f, y_u, mask, k: int,
              impl: str = "fused"):
    """One estimator over a batch of joined samples (B, P)."""
    if est_id == EST_MLE:
        return estimators.mle_mi(xu, y_u, mask)
    if est_id == EST_MIXED:
        return estimators.mixed_ksg_mi(xf, y_f, mask, k=k, impl=impl)
    if est_id == EST_DC_XD:  # discrete X (candidate feature), continuous Y
        return estimators.dc_ksg_mi(
            estimators.dense_rank(xu, mask), y_f, mask, k=k, impl=impl
        )
    # continuous X, discrete Y
    return estimators.dc_ksg_mi(
        estimators.dense_rank(y_u, mask), xf, mask, k=k, impl=impl
    )


def _score_pairs(trains: dict, ck, cf, cu, cm, *, est_id: int, k: int):
    """Join and score (Q, S) candidate lanes against their queries.

    ``trains`` fields are (Q, n); ``ck``/``cf``/``cu``/``cm`` are the
    gathered candidate rows, (Q, S, cap), keys in effective form.
    Returns (mi (Q, S) float32, js (Q, S) int32).
    """
    Q, S = ck.shape[:2]
    t = {f: trains[f][:, None, :] for f in _TRAIN_FIELDS}
    (xf, xu), (y_f, y_u), mask = sketch_join_presorted(
        t["keys"], t["mask"], ck, cm, (cf, cu), (t["vals_f"], t["vals_u"]),
        keys_effective=True,
    )
    n = mask.shape[-1]
    flat = [a.reshape(Q * S, n) for a in (xf, xu, y_f, y_u, mask)]
    mi = _estimate(est_id, *flat, k)
    return mi.reshape(Q, S), mask.sum(-1, dtype=torch.int32)


def _score_group_impl(trains: dict, arrays: dict, *, est_id: int, k: int):
    """Dense homogeneous scoring: every query against every group row.
    Returns (mi (Q, bucket), js (Q, bucket))."""
    Q = trains["keys"].shape[0]
    cand = [arrays[f][None].expand(Q, -1, -1) for f in _TRAIN_FIELDS]
    return _score_pairs(trains, *cand, est_id=est_id, k=k)


_score_group = program(_score_group_impl, static=("est_id", "k"),
                       resident=("arrays",))


def _gather_score_group(trains: dict, arrays: dict, rows: torch.Tensor,
                        *, est_id: int, k: int):
    """Phase-2 gather-and-score: each query scores only its own
    shortlist rows (``rows`` (Q, S) group-row indices)."""
    rows = rows.long()
    cand = [arrays[f][rows] for f in _TRAIN_FIELDS]
    return _score_pairs(trains, *cand, est_id=est_id, k=k)


def _join_sizes(train_keys, train_mask, cand_keys, cand_mask) -> torch.Tensor:
    """(Q, rows) int32 join sizes: every query against every candidate
    row — the phase-1 prefilter, chunked over candidate rows so the
    (chunk, Q, n) probe temporaries stay bounded."""
    Q, n = train_keys.shape
    G = cand_keys.shape[0]
    step = max(1, _JOIN_PROBES // max(Q * n, 1))
    out = [
        presorted_join_size(
            train_keys[None], train_mask[None],
            cand_keys[g0:g0 + step, None], cand_mask[g0:g0 + step, None],
        )
        for g0 in range(0, G, step)
    ]
    if not out:
        return torch.zeros((Q, 0), dtype=torch.int32, device=train_keys.device)
    return torch.cat(out).T.contiguous()


def _compact_lanes(passing: torch.Tensor, width: int):
    """Compact each row's passing columns, ascending, into ``width``
    lanes.  The prefix count of passing columns is monotone, so the l-th
    passing column is the first position where it reaches l + 1: a
    batched ``searchsorted`` reads every lane off it.  Dead lanes take
    column 0.  ``counts`` is unclamped, so a collect-side fence sees
    ``counts > width``.  Returns (pos, lane_live, counts)."""
    Q = passing.shape[0]
    cum = torch.cumsum(passing, dim=1, dtype=torch.int32)
    counts = cum[:, -1]
    lanes = torch.arange(1, width + 1, dtype=torch.int32,
                         device=passing.device)
    raw = torch.searchsorted(cum, lanes.expand(Q, width).contiguous())
    lane_live = (
        torch.arange(width, device=passing.device)[None, :] < counts[:, None]
    )
    return torch.where(lane_live, raw, 0), lane_live, counts


def _compact_shortlist(js, live, min_join, sentinel, index, s_bucket: int):
    """Device shortlist compaction — the fused replacement for the host
    :func:`~repro_torch.core.discovery.planner.build_shortlists` boundary.
    Dead lanes take row 0, the sentinel global id and join size 0, and
    are still scored.  Returns (rows, gidx, jsz, counts)."""
    rows, lane_live, counts = _compact_lanes(
        (js >= min_join) & live[None, :], s_bucket
    )
    gidx = torch.where(lane_live, index[rows], sentinel)
    jsz = torch.where(lane_live, js.gather(1, rows), 0)
    return rows, gidx, jsz, counts


def _fused_score_group_impl(trains: dict, arrays: dict, index, live,
                            min_join, sentinel, *, est_id: int, k: int,
                            s_bucket: int):
    """Fused prefilter -> compact -> gather -> score for one group, all
    enqueued on the device.  ``min_join`` / ``sentinel`` are int32
    device scalars.  Returns (mi (Q, s_bucket), gidx, jsz,
    js (Q, bucket), counts (Q,))."""
    js = _join_sizes(trains["keys"], trains["mask"],
                     arrays["keys"], arrays["mask"])
    rows, gidx, jsz, counts = _compact_shortlist(
        js, live, min_join, sentinel, index, s_bucket
    )
    mi, _ = _gather_score_group(trains, arrays, rows, est_id=est_id, k=k)
    return mi, gidx, jsz, js, counts


_fused_score_group = program(_fused_score_group_impl,
                             static=("est_id", "k", "s_bucket"),
                             resident=("arrays",))


def _signature_estimates(train_keys, train_mask, sig) -> torch.Tensor:
    """(Q, rows) float32 signature join-size estimates, chunked over the
    signature rows so the (Q, chunk·w) probe temporaries stay bounded."""
    Q = train_keys.shape[0]
    w = sig.shape[1] - 1
    step = max(1, _JOIN_PROBES // max(Q * w, 1))
    return torch.cat([
        signature_join_size(train_keys, train_mask, sig[r0:r0 + step])
        for r0 in range(0, sig.shape[0], step)
    ], dim=1)


def _containment_gate(train_keys, train_mask, sig, live, min_containment,
                      s_surv: int):
    """The phase-0 containment gate for one group.

    One signature sweep over every group row estimates containment as
    the signature join size over the train size (``max(sum(mask), 1)``,
    float32); rows at or above the staged float32 threshold (a float or
    a 0-dim float32 tensor) and live are compacted, ascending, into
    ``s_surv`` survivor lanes, so the exact phases keep the dense path's
    ranking ties.  Returns (rows
    (Q, s_surv), lane_live, counts (Q,) unclamped: ``counts > s_surv``
    is the survivor-buffer fence).
    """
    tsize = train_mask.sum(1).clamp_min(1).to(torch.float32)
    cont = _signature_estimates(train_keys, train_mask, sig) / tsize[:, None]
    return _compact_lanes((cont >= min_containment) & live[None, :], s_surv)


def _survivor_join_sizes(train_keys, train_mask, arrays, rows0):
    """(Q, s_surv) int32 exact join sizes of each query's survivor rows
    ``rows0``: the candidate rows are gathered per query, a chunk of
    survivors at a time, so the (Q, chunk, n) probe temporaries stay
    bounded as in :func:`_join_sizes`."""
    Q, n = train_keys.shape
    step = max(1, _JOIN_PROBES // max(Q * n, 1))
    out = []
    for s0 in range(0, rows0.shape[1], step):
        r = rows0[:, s0:s0 + step]
        out.append(presorted_join_size(
            train_keys[:, None], train_mask[:, None],
            arrays["keys"][r], arrays["mask"][r],
        ))
    return torch.cat(out, dim=1)


def _tiered_score_group_impl(trains: dict, arrays: dict, sig, index, live,
                             min_join, min_containment, sentinel, *,
                             est_id: int, k: int, s_surv: int,
                             s_bucket: int):
    """Gate -> prefilter -> compact -> gather -> score for one group,
    all enqueued on the device.  Every exact phase runs at survivor
    width; the within-survivor compaction keeps ascending row order and
    the scorer is the fused path's own, so a candidate that clears the
    gate scores as on the ungated path.  Dead lanes take group row 0, as
    the fused path's do (the reference's take the first survivor, whose
    full join the estimator would score for nothing).  ``min_join`` /
    ``sentinel`` are int32 device scalars, ``min_containment`` the
    staged float32 threshold.  Returns (mi (Q, s_bucket), gidx, jsz,
    counts0 (Q,), counts1 (Q,)), both counts unclamped."""
    rows0, live0, counts0 = _containment_gate(
        trains["keys"], trains["mask"], sig, live, min_containment, s_surv,
    )
    js = _survivor_join_sizes(trains["keys"], trains["mask"], arrays, rows0)
    pos, lane_live, counts1 = _compact_lanes((js >= min_join) & live0,
                                             s_bucket)
    rows = torch.where(lane_live, rows0.gather(1, pos), 0)
    gidx = torch.where(lane_live, index[rows], sentinel)
    jsz = torch.where(lane_live, js.gather(1, pos), 0)
    mi, _ = _gather_score_group(trains, arrays, rows, est_id=est_id, k=k)
    return mi, gidx, jsz, counts0, counts1


_tiered_score_group = program(_tiered_score_group_impl,
                              static=("est_id", "k", "s_surv", "s_bucket"),
                              resident=("arrays", "sig"))


def _host(t: torch.Tensor) -> np.ndarray:
    """A device result on the host: the host waits here for the device
    (an ``executors.fetch`` span)."""
    with telemetry.span("executors.fetch", bytes=t.nbytes):
        return t.cpu().numpy()


def _host_many(tensors: list) -> list:
    """Several 4-byte device tensors on the host in one transfer: packed
    as int32 words, copied once, split and viewed back."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).view(torch.int32) for t in tensors])
    words = _host(flat)
    out, o = [], 0
    for t in tensors:
        dt = np.dtype(str(t.dtype).removeprefix("torch."))
        out.append(words[o:o + t.numel()].view(dt).reshape(tuple(t.shape)))
        o += t.numel()
    return out


def _empty_triple():
    return (np.zeros(0, np.float32), np.zeros(0, np.int32),
            np.zeros(0, np.int32))


class _PendingScores:
    """Dispatched dense batch: ``collect`` returns (mi (Q, C), js (Q, C))
    in original candidate order, padded query lanes sliced off."""

    def __init__(self, plan: QueryPlan, blocks: list, q_live: int):
        self._plan = plan
        self._blocks = blocks
        self._q_live = q_live

    def collect(self):
        maybe_fault("collect")
        return self._scatter()

    def _scatter(self):
        q = self._q_live
        mi_out = np.zeros((q, self._plan.n_candidates), np.float32)
        js_out = np.zeros((q, self._plan.n_candidates), np.int32)
        for gp, mi, js in self._blocks:
            g = gp.size
            mi_out[:, gp.index[:g]] = _host(mi[:q, :g])
            js_out[:, gp.index[:g]] = _host(js[:q, :g])
        return mi_out, js_out


class _PendingJoinSizes:
    """Dispatched phase-1 prefilter: ``collect`` returns [(group,
    js (q_live, bucket) int32), ...] for ``build_shortlists``."""

    def __init__(self, blocks: list, q_live: int):
        self._blocks = blocks
        self._q_live = q_live

    def collect(self):
        maybe_fault("collect")
        return [(gp, _host(js[:self._q_live])) for gp, js in self._blocks]


def _triples(host: list, q: int) -> list:
    """Per-query (values, global ids, join sizes), groups concatenated."""
    if not host:
        return [_empty_triple() for _ in range(q)]
    return [
        (np.concatenate([mi[qi] for mi, _, _ in host]),
         np.concatenate([gi[qi] for _, gi, _ in host]),
         np.concatenate([jz[qi] for _, _, jz in host]))
        for qi in range(q)
    ]


class _PendingShortlist:
    """Dispatched phase-2 gather-and-score over host shortlists."""

    def __init__(self, blocks: list, q_live: int):
        self._blocks = blocks  # [(Shortlist, mi (Qb, S))]
        self._q_live = q_live

    def collect(self):
        maybe_fault("collect")
        q = self._q_live
        host = [(_host(mi[:q]), sl.gidx[:q], sl.js[:q])
                for sl, mi in self._blocks]
        return _triples(host, q)


class _PendingFused:
    """Dispatched fused two-phase batch.

    ``collect`` moves the survivor counts and the score blocks to the
    host, then checks the compaction fence: a group whose survivor count
    exceeds its ``s_bucket`` raises :class:`ShortlistOverflow` (the
    caller then runs the host boundary on ``js_blocks()``).
    ``observed`` (per-est_id max survivor count) feeds the hints.
    """

    def __init__(self, blocks: list, q_live: int):
        # blocks: [(group, s_bucket, mi, gidx, jsz, js, counts)]
        self._blocks = blocks
        self._q_live = q_live
        self.observed: dict[int, int] = {}
        self.shortlisted = 0

    def js_blocks(self):
        """Phase-1 join sizes on the host — the overflow fallback's
        ``build_shortlists`` operand, reused rather than recomputed."""
        q = self._q_live
        return [(gp, _host(js[:q])) for gp, _s, _mi, _gi, _jz, js, _c
                in self._blocks]

    def collect(self):
        q = self._q_live
        overflow = False
        shortlisted = 0
        for gp, s_bucket, *_rest, counts in self._blocks:
            c = _host(counts[:q])
            m = int(c.max(initial=0))
            self.observed[gp.est_id] = max(self.observed.get(gp.est_id, 0), m)
            shortlisted += int(c.sum())
            overflow |= m > s_bucket
        self.shortlisted = shortlisted
        if overflow:
            raise ShortlistOverflow(
                "fused shortlist compaction overflowed its staged bucket"
            )
        # The overflow fence is part of the fused protocol, not a
        # failure, so it is checked before the fault site.
        maybe_fault("collect")
        host = [(_host(mi[:q]), _host(gidx[:q]), _host(jsz[:q]))
                for _gp, _s, mi, gidx, jsz, _js, _c in self._blocks]
        return _triples(host, q)


class _PendingTiered:
    """Dispatched tiered (phase-0-gated) batch.

    ``collect`` moves the survivor counts, the shortlist counts and the
    score blocks to the host in one transfer, then checks both fences: a
    group whose survivor count exceeds its ``s_surv`` lanes, or whose
    within-survivor shortlist count exceeds its ``s_bucket`` lanes,
    raises :class:`SurvivorOverflow` (the caller re-runs the window
    ungated).  ``observed_t0`` / ``observed`` (per-est_id max counts)
    feed the survivor and shortlist rungs; ``survivors`` /
    ``shortlisted`` feed the admission stats.
    """

    def __init__(self, blocks: list, q_live: int):
        # blocks: [(group, s_surv, s_bucket, mi, gidx, jsz, c0, c1)]
        self._blocks = blocks
        self._q_live = q_live
        self.observed: dict[int, int] = {}
        self.observed_t0: dict[int, int] = {}
        self.shortlisted = 0
        self.survivors = 0

    def _fence(self, counts: list) -> None:
        overflow = False
        survivors = shortlisted = 0
        for (gp, s_surv, s_bucket, *_rest), (c0, c1) in zip(self._blocks,
                                                             counts):
            m0, m1 = int(c0.max(initial=0)), int(c1.max(initial=0))
            self.observed_t0[gp.est_id] = max(
                self.observed_t0.get(gp.est_id, 0), m0)
            self.observed[gp.est_id] = max(self.observed.get(gp.est_id, 0), m1)
            survivors += int(c0.sum())
            shortlisted += int(c1.sum())
            overflow |= m0 > s_surv or m1 > s_bucket
        self.survivors = survivors
        self.shortlisted = shortlisted
        if overflow:
            raise SurvivorOverflow(
                "phase-0 containment gate overflowed its staged buffers"
            )

    def collect(self):
        q = self._q_live
        flat = _host_many([t[:q] for *_h, mi, gidx, jsz, c0, c1
                           in self._blocks for t in (mi, gidx, jsz, c0, c1)])
        per = [flat[i:i + 5] for i in range(0, len(flat), 5)]
        # The fences are part of the tiered protocol, not a failure, so
        # they are checked before the fault site.
        self._fence([(c0, c1) for *_b, c0, c1 in per])
        maybe_fault("collect")
        return _triples([(mi, gi, jz) for mi, gi, jz, _c0, _c1 in per], q)


def _stack_host(sketches: list) -> dict:
    """Stack Q train sketches into host numpy arrays, (Q, n) per field;
    keys and the uint32 value view as zero-extended int64."""
    if not sketches:
        raise ValueError("no train sketches")
    y_disc = {bool(sk.value_is_discrete) for sk in sketches}
    if len(y_disc) != 1:
        raise ValueError(
            "a train batch must share one target dtype "
            "(got both discrete and continuous); split the batch"
        )
    views = [sk.value_views() for sk in sketches]
    return {
        "keys": np.stack([sk.key_hashes for sk in sketches]).astype(np.int64),
        "vals_f": np.stack([vf for vf, _ in views]),
        "vals_u": np.stack([vu for _, vu in views]).astype(np.int64),
        "mask": np.stack([sk.mask for sk in sketches]),
        "y_discrete": y_disc.pop(),
    }


def stage_trains_host(sketches: list, device) -> dict:
    """The host half of a bucket's train upload: the Q sketches stacked
    into one host tensor per field, in pinned memory when ``device`` is
    a card, so that :func:`upload_trains` can copy them asynchronously
    (the scheduler stages window N+1 while window N scores)."""
    maybe_fault("staging")
    with telemetry.span("executors.stage", queries=len(sketches)):
        host = _stack_host(sketches)
        pin = torch.device(device).type == "cuda"
        out = {}
        for f in _TRAIN_FIELDS:
            t = torch.from_numpy(host[f])
            out[f] = t.pin_memory() if pin else t
    out["y_discrete"] = host["y_discrete"]
    return out


def upload_trains(staged: dict, device, stream=None) -> dict:
    """The device half: one ``non_blocking`` host-to-device copy per
    field.  With a side CUDA ``stream`` the copies run there (beside
    whatever the current stream is computing); the current stream then
    waits for them, and ``record_stream`` tells the allocator the
    tensors are used on it."""
    maybe_fault("stack_h2d")
    if stream is None:
        out = {f: staged[f].to(device, non_blocking=True)
               for f in _TRAIN_FIELDS}
    else:
        current = torch.cuda.current_stream(device)
        with torch.cuda.stream(stream):
            out = {f: staged[f].to(device, non_blocking=True)
                   for f in _TRAIN_FIELDS}
        current.wait_stream(stream)
        for t in out.values():
            t.record_stream(current)
    out["y_discrete"] = staged["y_discrete"]
    return out


def stack_trains_host(sketches: list, device) -> dict:
    """Stack Q train ``Sketch`` objects into one leading-Q dict on
    ``device``, one host-to-device copy per field: :func:`stage_trains_host`
    then :func:`upload_trains`."""
    return upload_trains(stage_trains_host(sketches, device), device)


def train_arrays(sketches: list, device) -> dict:
    """The same stacked dict as :func:`stack_trains_host`, without the
    fault sites: the upload of the service's reference rung and of the
    non-finite fence, which must not depend on the path they rescue."""
    host = _stack_host(sketches)
    out = {f: torch.from_numpy(host[f]).to(device) for f in _TRAIN_FIELDS}
    out["y_discrete"] = host["y_discrete"]
    return out


def pad_trains_q(trains: dict, q_bucket: int) -> dict:
    """Pad a stacked train dict up to ``q_bucket`` query lanes.  Dead
    lanes repeat lane 0: real data, so every lane runs what a live lane
    runs, and live lanes equal the unpadded run's; callers slice
    ``[:Q]``."""
    Q = int(trains["keys"].shape[0])
    if q_bucket < Q:
        raise ValueError(f"q_bucket {q_bucket} < batch size {Q}")
    if q_bucket == Q:
        return trains
    pad = q_bucket - Q
    out = {
        f: torch.cat([trains[f],
                      trains[f][:1].expand((pad,) + tuple(trains[f].shape[1:]))])
        for f in _TRAIN_FIELDS
    }
    out["y_discrete"] = bool(trains.get("y_discrete", False))
    return out


def _pad_rows_q(a: np.ndarray, q_bucket: int) -> np.ndarray:
    """Pad a host (Q, ...) shortlist operand to ``q_bucket`` query lanes
    by repeating lane 0 (the same discipline as :func:`pad_trains_q`)."""
    q = a.shape[0]
    if q_bucket <= q:
        return a
    return np.concatenate(
        [a, np.broadcast_to(a[:1], (q_bucket - q,) + a.shape[1:])]
    )


def _train_inputs(trains: dict) -> dict:
    """The tensor fields of a stacked train dict: a program's input."""
    return {f: trains[f] for f in _TRAIN_FIELDS}


def _device_scalar(value, dtype, device) -> torch.Tensor:
    """A 0-dim device tensor made by a fill (no host copy): what the
    reference traces as a scalar, as a program input."""
    return torch.full((), value, dtype=dtype, device=device)


def _as_stacked_trains(trains: dict) -> dict:
    if trains["keys"].dim() == 1:  # single query -> Q == 1
        return {
            **{f: trains[f][None] for f in _TRAIN_FIELDS},
            "y_discrete": bool(trains.get("y_discrete", False)),
        }
    return trains


class Executor:
    """Backend interface: dense scoring + ranked retrieval of a plan."""

    def execute(self, plan: QueryPlan, trains: dict):
        """Score every (query, candidate) pair; returns (mi (Q, C),
        js (Q, C)) numpy arrays in the original candidate order."""
        raise NotImplementedError

    def topk(self, plan: QueryPlan, trains: dict, top_k: int):
        """Per-query top-k: a list of (values, int32 global indices, join
        sizes), one triple per query, best first.  Default = dense +
        stable argsort; the distributed executor overrides it with the
        per-shard merge."""
        mi, js = self.execute(plan, _as_stacked_trains(trains))
        out = []
        for q in range(mi.shape[0]):
            order = np.argsort(-mi[q], kind="stable")[:min(top_k, mi.shape[1])]
            out.append((mi[q][order], order.astype(np.int32), js[q][order]))
        return out


class PartitionedLocalExecutor(Executor):
    """Per-query estimator-partitioned scoring (the single-query path):
    every (query, group) pass is enqueued before the first host copy."""

    def __init__(self, k: int = 3):
        self.k = k

    def execute(self, plan, trains):
        trains = _as_stacked_trains(trains)
        Q = int(trains["keys"].shape[0])
        blocks = []
        for gp in plan.groups:
            per_q = [
                _score_group({f: trains[f][q:q + 1] for f in _TRAIN_FIELDS},
                             gp.arrays, est_id=gp.est_id, k=self.k)
                for q in range(Q)
            ]
            blocks.append((gp, torch.cat([mi for mi, _ in per_q]),
                           torch.cat([js for _, js in per_q])))
        return _PendingScores(plan, blocks, Q)._scatter()


class BatchedExecutor(Executor):
    """Multi-query batched scoring: one program per group over all Q
    queries, with optional Q padding (``q_bucket=``: the pow-2 ladder
    that bounds the compiled programs; dead lanes repeat lane 0 and
    never leave the device)."""

    def __init__(self, k: int = 3):
        self.k = k

    @staticmethod
    def _prepare(trains, q_bucket: int | None):
        trains = _as_stacked_trains(trains)
        Q = int(trains["keys"].shape[0])
        if q_bucket is not None:
            trains = pad_trains_q(trains, q_bucket)
        return trains, Q

    def dispatch(self, plan, trains, *, q_bucket: int | None = None):
        """Enqueue every group's dense scoring; the handle's ``collect``
        is the first host sync."""
        maybe_fault("dispatch", "batched")
        trains, Q = self._prepare(trains, q_bucket)
        blocks = [
            (gp, *_score_group(_train_inputs(trains), gp.arrays,
                               est_id=gp.est_id, k=self.k))
            for gp in plan.groups
        ]
        return _PendingScores(plan, blocks, Q)

    def execute(self, plan, trains, *, q_bucket: int | None = None):
        return self.dispatch(plan, trains, q_bucket=q_bucket).collect()

    # -- two-phase retrieval ------------------------------------------------

    def prefilter_dispatch(self, plan, trains, *,
                           q_bucket: int | None = None):
        """Phase 1: enqueue the join-size prefilter for every group."""
        maybe_fault("prefilter_dispatch", "batched")
        trains, Q = self._prepare(trains, q_bucket)
        blocks = [
            (gp, _join_sizes(trains["keys"], trains["mask"],
                             gp.arrays["keys"], gp.arrays["mask"]))
            for gp in plan.groups
        ]
        return _PendingJoinSizes(blocks, Q)

    def shortlist_dispatch(self, plan, trains, shortlists, *,
                           q_bucket: int | None = None):
        """Phase 2: gather and score every non-empty host shortlist."""
        maybe_fault("shortlist_dispatch", "batched")
        trains, Q = self._prepare(trains, q_bucket)
        qb = int(trains["keys"].shape[0])
        blocks = []
        for sl in shortlists:
            if sl is None:
                continue
            rows = torch.from_numpy(_pad_rows_q(sl.rows, qb)).to(plan.device)
            mi, _ = _gather_score_group(
                trains, sl.group.arrays, rows, est_id=sl.group.est_id, k=self.k
            )
            blocks.append((sl, mi))
        return _PendingShortlist(blocks, Q)

    def fused_dispatch(self, plan, trains, spec, min_join: int, *,
                       q_bucket: int | None = None):
        """Fused two-phase: per group, prefilter, compaction, gather and
        score are enqueued without a host sync.  The handle raises
        ``ShortlistOverflow`` at collect when a width in ``spec`` was
        too small."""
        maybe_fault("fused_dispatch", "batched")
        trains, Q = self._prepare(trains, q_bucket)
        t_in = _train_inputs(trains)
        dev = trains["keys"].device
        mj = _device_scalar(int(min_join), torch.int32, dev)
        sentinel = _device_scalar(plan.n_candidates, torch.int32, dev)
        blocks = []
        for gp, s_bucket in zip(plan.groups, spec.s_buckets):
            mi, gidx, jsz, js, counts = _fused_score_group(
                t_in, gp.arrays, gp.index_dev, gp.live, mj, sentinel,
                est_id=gp.est_id, k=self.k, s_bucket=int(s_bucket),
            )
            blocks.append((gp, int(s_bucket), mi, gidx, jsz, js, counts))
        return _PendingFused(blocks, Q)

    def tiered_dispatch(self, plan, trains, tspec, spec, min_join: int,
                        min_containment: float, *,
                        q_bucket: int | None = None):
        """Tiered retrieval: the phase-0 containment gate and the fused
        pipeline, per group, enqueued without a host sync.  ``tspec``
        (:class:`~repro_torch.core.discovery.planner.TierSpec`) gives the
        survivor widths, ``spec`` the shortlist widths, each clamped to
        its group's survivor width.  The staged threshold reaches the
        program as a float32 device scalar.  The handle raises
        ``SurvivorOverflow`` at collect when a width was too small:
        re-run the window through ``fused_dispatch``."""
        maybe_fault("tiered_dispatch", "batched")
        trains, Q = self._prepare(trains, q_bucket)
        t_in = _train_inputs(trains)
        dev = trains["keys"].device
        mj = _device_scalar(int(min_join), torch.int32, dev)
        mc = _device_scalar(stage_min_containment(min_containment),
                            torch.float32, dev)
        sentinel = _device_scalar(plan.n_candidates, torch.int32, dev)
        blocks = []
        for gp, s_surv, s_bucket in zip(plan.groups, tspec.s_survivors,
                                        spec.s_buckets):
            if gp.sig is None:
                raise ValueError(
                    "tiered dispatch on a plan without a signature tier"
                )
            sb = min(int(s_bucket), int(s_surv))
            mi, gidx, jsz, c0, c1 = _tiered_score_group(
                t_in, gp.arrays, gp.sig, gp.index_dev, gp.live, mj, mc,
                sentinel, est_id=gp.est_id, k=self.k, s_surv=int(s_surv),
                s_bucket=sb,
            )
            blocks.append((gp, int(s_surv), sb, mi, gidx, jsz, c0, c1))
        return _PendingTiered(blocks, Q)


# ---------------------------------------------------------------------------
# The discovery mesh: candidate rows sharded over the "data" axis.
# ---------------------------------------------------------------------------


def _shard_topk_plan(c_padded: int, n_shards: int,
                     top_k: int) -> tuple[int, int]:
    """Per-shard and global result counts of a distributed top-k.

    ``k_shard`` rides a pow-2 ladder (the next power of two >= ``top_k``,
    clamped to the shard's rows), so varied top-k traffic builds one
    shard program per k bucket; every shard keeps ``min(k_bucket,
    shard_size)`` and the merge returns ``min(top_k, shards ·
    k_shard)``, never fewer than ``min(top_k, C)``.
    """
    shard_size = c_padded // n_shards
    k_shard = max(min(_next_pow2(top_k), shard_size), 1)
    k_final = min(top_k, n_shards * k_shard)
    return k_shard, k_final


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest of each row,
    best first, ties to the lowest position.  A stable descending sort,
    since ``torch.topk`` promises no order among equal values."""
    v, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], pos[..., :k]


def _hybrid(trains: dict, mi: torch.Tensor, js: torch.Tensor) -> torch.Tensor:
    """``rank="hybrid"``'s score when the trains carry ``"tsize"`` (each
    query's train size, at least 1, float32 (Q,)): mi · (js / tsize),
    the division first, as the service weights a batched result on the
    host, so the bits are the same; ``mi`` unchanged otherwise."""
    tsize = trains.get("tsize")
    if tsize is None:
        return mi
    return mi * (js.to(torch.float32) / tsize[:, None])


def _shard_topk_impl(trains: dict, lives: dict, shards: list, *,
                     est_id: int, k: int, k_shard: int):
    """Dense scoring of the shards that share one device, each over its
    own rows (trains replicated).  ``k_shard == 0`` returns each shard's
    (mi, js) (Q, rows); otherwise its top ``k_shard`` per query by the
    (hybrid-weighted, see :func:`_hybrid`) score, dead rows fenced to
    -inf: (values, shard-local rows, join sizes)."""
    out = []
    for sh, live in zip(shards, lives.values()):
        mi, js = _score_group_impl(trains, sh, est_id=est_id, k=k)
        if k_shard == 0:
            out.append((mi, js))
            continue
        mi = _hybrid(trains, mi, js)
        v, i = _top_k(torch.where(live[None, :], mi, -torch.inf), k_shard)
        out.append((v, i, js.gather(1, i)))
    return out


def _shard_fused_impl(trains: dict, lives: dict, indexes: dict, shards: list,
                      min_join, sentinel, *, est_id: int, k: int,
                      s_shard: int, k_shard: int):
    """The fused pipeline on each shard of one device: its own
    prefilter, compaction into ``s_shard`` lanes, gather, scoring and
    top ``k_shard``.  Per shard: (values, global ids, join sizes,
    survivor counts (Q, 1), the phase-1 join sizes (Q, rows))."""
    out = []
    for sh, live, index in zip(shards, lives.values(), indexes.values()):
        mi, gidx, jsz, js, counts = _fused_score_group_impl(
            trains, sh, index, live, min_join, sentinel, est_id=est_id,
            k=k, s_bucket=s_shard)
        mi = _hybrid(trains, mi, jsz)
        v, pos = _top_k(torch.where(gidx != sentinel, mi, -torch.inf),
                        k_shard)
        out.append((v, gidx.gather(1, pos), jsz.gather(1, pos),
                    counts[:, None], js))
    return out


def _shard_tiered_impl(trains: dict, lives: dict, indexes: dict,
                       shards: list, min_join, min_containment, sentinel, *,
                       est_id: int, k: int, s_surv: int, s_shard: int,
                       k_shard: int):
    """The gated pipeline on each shard of one device (its signature rows
    sharded like its sketch rows, so the survivor gather stays on the
    shard).  Per shard: (values, global ids, join sizes, survivor counts
    (Q, 1), shortlist counts (Q, 1))."""
    out = []
    for sh, live, index in zip(shards, lives.values(), indexes.values()):
        mi, gidx, jsz, c0, c1 = _tiered_score_group_impl(
            trains, sh, sh["sig"], index, live, min_join, min_containment,
            sentinel, est_id=est_id, k=k, s_surv=s_surv, s_bucket=s_shard)
        mi = _hybrid(trains, mi, jsz)
        v, pos = _top_k(torch.where(gidx != sentinel, mi, -torch.inf),
                        k_shard)
        out.append((v, gidx.gather(1, pos), jsz.gather(1, pos),
                    c0[:, None], c1[:, None]))
    return out


# One program per (group, Q bucket, k bucket, widths) and device: the
# shards that share a device are one graph on the card.
_shard_topk = program(_shard_topk_impl, static=("est_id", "k", "k_shard"),
                      resident=("shards",))
_shard_fused = program(_shard_fused_impl,
                       static=("est_id", "k", "s_shard", "k_shard"),
                       resident=("shards",))
_shard_tiered = program(_shard_tiered_impl,
                        static=("est_id", "k", "s_surv", "s_shard", "k_shard"),
                        resident=("shards",))


def _globalize_rows(i: torch.Tensor, index: torch.Tensor, *, k_shard: int,
                    shard_rows: int) -> torch.Tensor:
    """Per-shard top-k rows (Q, shards · k_shard), each numbered within
    its shard, as global candidate ids: undo the shard numbering, then
    read the group's row -> candidate index (dead rows give the
    sentinel, which the ranking drops)."""
    shard = torch.arange(i.shape[1], device=i.device) // k_shard
    return index[i + (shard * shard_rows)[None, :]]


def _concat1(xs: list) -> torch.Tensor:
    """Concatenate along axis 1, with no copy for a single block."""
    return xs[0] if len(xs) == 1 else torch.cat(xs, dim=1)


def _merge_topk_device(v, gi, js, *, k_final: int):
    """The cross-shard, cross-group merge on the first device: one top-k
    over the concatenated winners, all Q rows at once, ties to the
    lowest position as ``lax.top_k``; the host then receives
    O(Q · k_final) values."""
    vals, pos = _top_k(v, k_final)
    return vals, gi.gather(1, pos), js.gather(1, pos)


def _pad_group_to_shards(gp: GroupPlan, n_shards: int,
                         sentinel: int) -> GroupPlan:
    """A group whose row bucket does not divide the shard count (a
    non-power-of-two mesh on a plan built without the mesh rounding),
    zero-padded to a multiple of it: dead rows point at ``sentinel``
    (the plan's ``n_candidates``), their keys go back through
    :func:`~repro_torch.core.join.effective_keys` so the presorted join
    stays fenced, and signature pads are -1."""
    b = gp.bucket
    if b % n_shards == 0:
        return gp
    pad = -(-b // n_shards) * n_shards - b
    arrays = {name: torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
              for name, a in gp.arrays.items()}
    arrays["keys"] = effective_keys(arrays["keys"], arrays["mask"])
    index = np.concatenate([np.asarray(gp.index, np.int32),
                            np.full(pad, sentinel, np.int32)])
    live = torch.cat([gp.live, gp.live.new_zeros(pad)])
    sig = gp.sig
    if sig is not None:
        sig = torch.cat([sig, sig.new_full((pad, sig.shape[1]), -1)])
    return GroupPlan(gp.est_id, arrays, index, live, gp.size,
                     torch.from_numpy(index).to(live.device), sig)


class _ShardedGroup:
    """One plan group laid out on the mesh: the shard-padded group (on
    the plan's device), and per shard its rows on its own device — views
    of the group's tensors where the shard shares their device, copies
    otherwise — its live mask and its rows' global ids."""

    __slots__ = ("gp", "rows", "shards", "lives", "indexes", "index_first",
                 "by_device")

    def __init__(self, gp: GroupPlan, devices: list):
        n = len(devices)
        self.gp = gp
        self.rows = R = gp.bucket // n
        home = canonical_device(gp.live.device)

        def part(t, s, dev):
            rows = t[s * R:(s + 1) * R]
            return rows if dev == home else rows.to(dev)

        tensors = dict(gp.arrays)
        if gp.sig is not None:
            tensors["sig"] = gp.sig
        self.shards, self.lives, self.indexes = [], [], []
        by_device: dict = {}
        for s, dev in enumerate(devices):
            self.shards.append({name: part(t, s, dev)
                                for name, t in tensors.items()})
            self.lives.append(part(gp.live, s, dev))
            self.indexes.append(part(gp.index_dev, s, dev))
            by_device.setdefault(dev, []).append(s)
        self.by_device = list(by_device.items())
        first = devices[0]
        self.index_first = (gp.index_dev if first == home
                            else gp.index_dev.to(first))

    def call(self, fn, trains_by_dev: dict, scalars_by_dev: dict | None = None,
             indexed: bool = False, **static) -> list:
        """``fn`` (a shard program) once per device over the shards on
        it; returns the per-shard outputs in shard order, each on its
        own device."""
        out = [None] * len(self.shards)
        for dev, ids in self.by_device:
            args = [trains_by_dev[dev],
                    {str(j): self.lives[s] for j, s in enumerate(ids)}]
            if indexed:
                args.append({str(j): self.indexes[s]
                             for j, s in enumerate(ids)})
            args.append([self.shards[s] for s in ids])
            args += (scalars_by_dev or {}).get(dev, [])
            for s, o in zip(ids, fn(*args, **static)):
                out[s] = o
        return out


class _PendingTopk:
    """Dispatched distributed top-k: the merged (Q, k_merge) triples on
    the first device.  ``collect`` syncs once and returns one (values,
    global ids, join sizes) triple per live query, cut to ``k_live``
    columns (the merge is best-first, so the first columns of a wider
    merge are the same).  An empty handle (every shortlist empty) gives
    zero-length triples."""

    def __init__(self, vals, gidx, jsz, q_live: int, k_live: int | None = None):
        self._vals = vals
        self._gidx = gidx
        self._jsz = jsz
        self._q_live = q_live
        self._k_live = k_live

    def _triples(self, v, gi, js) -> list:
        kl = self._k_live
        if kl is not None and kl < v.shape[1]:
            v, gi, js = v[:, :kl], gi[:, :kl], js[:, :kl]
        return [(v[i], gi[i], js[i]) for i in range(self._q_live)]

    def _result(self) -> list:
        q = self._q_live
        return [t[:q] for t in (self._vals, self._gidx, self._jsz)]

    def collect(self):
        maybe_fault("collect")
        if self._vals is None:
            return [_empty_triple() for _ in range(self._q_live)]
        return self._triples(*_host_many(self._result()))


class _PendingFusedTopk(_PendingTopk):
    """Dispatched fused two-phase top-k on the mesh: the merged triples
    and the shard-local compaction fence.  ``collect`` moves the
    per-(group, shard) survivor counts and the triples in one transfer,
    then checks the fence: a shard whose survivor count exceeds its
    ``s_shard`` lanes raises :class:`ShortlistOverflow` (the caller then
    builds host shortlists from ``js_blocks()``).  The collect fault site
    fires only on a clean fence."""

    def __init__(self, vals, gidx, jsz, q_live: int, k_live: int,
                 fence: list):
        super().__init__(vals, gidx, jsz, q_live, k_live=k_live)
        # fence: [(group, s_shard, counts (Qb, shards), js (Qb, bucket))]
        self._fence = fence
        self.observed: dict[int, int] = {}
        self.shortlisted = 0

    def _fence_host(self, counts: list) -> None:
        overflow = False
        shortlisted = 0
        for (gp, s_shard, _c, _js), c in zip(self._fence, counts):
            m = int(c.max(initial=0))
            self.observed[gp.est_id] = max(self.observed.get(gp.est_id, 0), m)
            shortlisted += int(c.sum())
            overflow |= m > s_shard
        self.shortlisted = shortlisted
        if overflow:
            raise ShortlistOverflow(
                "fused shard-local compaction overflowed its staged bucket")

    def js_blocks(self):
        q = self._q_live
        return [(gp, _host(js[:q])) for gp, _s, _c, js in self._fence]

    def collect(self):
        q = self._q_live
        counts = [c[:q] for _gp, _s, c, _js in self._fence]
        result = [] if self._vals is None else self._result()
        host = _host_many(counts + result)
        self._fence_host(host[:len(counts)])
        if self._vals is None:
            return super().collect()
        maybe_fault("collect")
        return self._triples(*host[len(counts):])


class _PendingTieredTopk(_PendingTopk):
    """Dispatched gated top-k on the mesh: the merged triples and both
    shard-local fences (phase-0 survivor counts and within-survivor
    shortlist counts per (group, shard)).  A shard past either width
    raises :class:`SurvivorOverflow` (the caller re-runs the window
    through the ungated fused mesh path); the collect fault site fires
    only on a clean fence."""

    def __init__(self, vals, gidx, jsz, q_live: int, k_live: int,
                 fence: list):
        super().__init__(vals, gidx, jsz, q_live, k_live=k_live)
        # fence: [(group, s_surv_shard, s_shard, c0 (Qb, shards),
        #          c1 (Qb, shards))]
        self._fence = fence
        self.observed: dict[int, int] = {}
        self.observed_t0: dict[int, int] = {}
        self.shortlisted = 0
        self.survivors = 0

    def _fence_host(self, counts: list) -> None:
        overflow = False
        survivors = shortlisted = 0
        for (gp, s_surv, s_shard, _c0, _c1), (c0, c1) in zip(self._fence,
                                                             counts):
            m0, m1 = int(c0.max(initial=0)), int(c1.max(initial=0))
            self.observed_t0[gp.est_id] = max(
                self.observed_t0.get(gp.est_id, 0), m0)
            self.observed[gp.est_id] = max(self.observed.get(gp.est_id, 0), m1)
            survivors += int(c0.sum())
            shortlisted += int(c1.sum())
            overflow |= m0 > s_surv or m1 > s_shard
        self.survivors = survivors
        self.shortlisted = shortlisted
        if overflow:
            raise SurvivorOverflow(
                "shard-local containment gate overflowed its staged buffers")

    def collect(self):
        q = self._q_live
        counts = [t[:q] for *_h, c0, c1 in self._fence for t in (c0, c1)]
        result = [] if self._vals is None else self._result()
        host = _host_many(counts + result)
        n = len(counts)
        self._fence_host([(host[i], host[i + 1]) for i in range(0, n, 2)])
        if self._vals is None:
            return super().collect()
        maybe_fault("collect")
        return self._triples(*host[n:])


class GroupMajorDistributedExecutor(Executor):
    """Mesh-sharded scoring with estimator partitioning outside the
    shards: per group, one program per device runs every shard there
    over its own candidate rows, the train arrays replicated; each
    shard keeps its top ``k_shard`` and the winners are merged on the
    first device with one top-k, so ``topk`` moves O(groups · shards ·
    k_shard) values between devices and O(Q · k) to the host.

    ``mesh`` is a :class:`~repro_torch.launch.mesh.Mesh`; shard ``s`` of
    its ``"data"`` axis runs on that axis's ``s``-th device, and a
    device may hold several shards.  The kernel's inputs and outputs
    stay on each shard's device until the merge.
    """

    # One live plan per target dtype is the steady state (the index
    # caches exactly that); a deeper cache would pin superseded plans'
    # device buffers during ingest-while-serving.
    _PAD_CACHE_MAX = 2

    def __init__(self, mesh, k: int = 3):
        self.mesh = mesh
        self.k = k
        self.devices = list(mesh.axis_devices("data"))
        self.first = self.devices[0]
        # Sharded groups per plan, keyed by plan identity with a strong
        # reference to the plan so its id cannot be recycled while the
        # entry lives: repeat queries against a cached plan re-shard and
        # re-copy nothing.
        self._pad_cache: dict[int, tuple[QueryPlan, list]] = {}

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def _groups(self, plan: QueryPlan) -> list[_ShardedGroup]:
        hit = self._pad_cache.get(id(plan))
        if hit is not None and hit[0] is plan:
            return hit[1]
        groups = [
            _ShardedGroup(_pad_group_to_shards(gp, self.n_shards,
                                               plan.n_candidates),
                          self.devices)
            for gp in plan.groups
        ]
        while len(self._pad_cache) >= self._PAD_CACHE_MAX:
            self._pad_cache.pop(next(iter(self._pad_cache)))
        self._pad_cache[id(plan)] = (plan, groups)
        return groups

    def _replicate(self, trains: dict, q_bucket: int | None,
                   tsize=None):
        """The stacked trains padded to ``q_bucket`` lanes and copied to
        every device of the mesh (once each); returns (trains per device,
        live query count).  ``tsize`` (one train size a live query, for
        ``rank="hybrid"``) rides along as the trains' ``"tsize"`` field,
        a float32 device input (padded lanes 1), so the shard programs
        weight before their top-k and a new size is no new program."""
        trains = _as_stacked_trains(trains)
        Q = int(trains["keys"].shape[0])
        if q_bucket is not None:
            trains = pad_trains_q(trains, q_bucket)
        t_in = _train_inputs(trains)
        home = canonical_device(trains["keys"].device)
        if tsize is not None:
            ts = np.ones(int(trains["keys"].shape[0]), np.float32)
            ts[:Q] = np.maximum(np.asarray(tsize, np.float32), 1.0)
            t_in["tsize"] = torch.from_numpy(ts).to(home)
        by_dev = {}
        for dev in self.devices:
            if dev not in by_dev:
                by_dev[dev] = t_in if dev == home else {
                    f: t.to(dev, non_blocking=True) for f, t in t_in.items()}
        return by_dev, Q

    def _to_first(self, t: torch.Tensor) -> torch.Tensor:
        return t if canonical_device(t.device) == self.first else \
            t.to(self.first, non_blocking=True)

    def _gather(self, per_shard: list, j: int) -> torch.Tensor:
        """Output ``j`` of every shard, on the first device, concatenated
        along axis 1 in shard order (the all-gather)."""
        return _concat1([self._to_first(o[j]) for o in per_shard])

    def _scalars(self, *values) -> dict:
        """Each (value, dtype) as a 0-dim tensor on every device."""
        return {dev: [_device_scalar(v, dt, dev) for v, dt in values]
                for dev in dict.fromkeys(self.devices)}

    def _merge(self, vs, gis, jss, top_k: int):
        """The cross-group merge on the pow-2 k ladder of the shard
        programs; the exact count is cut on the host."""
        flat_v = _concat1(vs)
        width = int(flat_v.shape[1])
        k_merge = min(_next_pow2(top_k), width)
        vals, gidx, jsz = _merge_topk_device(flat_v, _concat1(gis),
                                             _concat1(jss), k_final=k_merge)
        return vals, gidx, jsz, min(top_k, width)

    def execute(self, plan, trains):
        """Dense (Q, C) scores and join sizes, every shard scoring its
        rows; equal to the batched executor's."""
        by_dev, Q = self._replicate(trains, None)
        blocks = []
        for sg in self._groups(plan):
            out = sg.call(_shard_topk, by_dev, est_id=sg.gp.est_id, k=self.k,
                          k_shard=0)
            blocks.append((sg.gp, self._gather(out, 0), self._gather(out, 1)))
        return _PendingScores(plan, blocks, Q)._scatter()

    def topk_dispatch(self, plan, trains, top_k: int, *,
                      q_bucket: int | None = None, tsize=None):
        """Enqueue every group's shard programs and the merge; the
        handle's ``collect`` is the first host sync.  With ``tsize`` (see
        :meth:`_replicate`) every top-k ranks by the hybrid score."""
        maybe_fault("dispatch", "distributed")
        by_dev, Q = self._replicate(trains, q_bucket, tsize)
        vs, gis, jss = [], [], []
        for sg in self._groups(plan):
            k_shard, _ = _shard_topk_plan(sg.gp.bucket, self.n_shards, top_k)
            out = sg.call(_shard_topk, by_dev, est_id=sg.gp.est_id, k=self.k,
                          k_shard=k_shard)
            vs.append(self._gather(out, 0))
            gis.append(_globalize_rows(self._gather(out, 1), sg.index_first,
                                       k_shard=k_shard, shard_rows=sg.rows))
            jss.append(self._gather(out, 2))
        vals, gidx, jsz, k_live = self._merge(vs, gis, jss, top_k)
        return _PendingTopk(vals, gidx, jsz, Q, k_live=k_live)

    def topk(self, plan, trains, top_k: int):
        return self.topk_dispatch(plan, trains, top_k).collect()

    # -- two-phase retrieval ------------------------------------------------

    def prefilter_dispatch(self, plan, trains, *,
                           q_bucket: int | None = None):
        """Phase 1 on the mesh: each shard's join sizes over its own rows,
        gathered to (Q, bucket) per shard-padded group; pass
        ``multiple=n_shards`` to ``build_shortlists``."""
        maybe_fault("prefilter_dispatch", "distributed")
        by_dev, Q = self._replicate(trains, q_bucket)
        blocks = []
        for sg in self._groups(plan):
            per_shard = []
            for dev, ids in sg.by_device:
                t = by_dev[dev]
                per_shard += [(s, _join_sizes(t["keys"], t["mask"],
                                              sg.shards[s]["keys"],
                                              sg.shards[s]["mask"]))
                              for s in ids]
            per_shard.sort(key=lambda e: e[0])
            blocks.append((sg.gp, _concat1([self._to_first(js)
                                            for _, js in per_shard])))
        return _PendingJoinSizes(blocks, Q)

    def shortlist_topk_dispatch(self, plan, trains, shortlists, top_k: int,
                                *, q_bucket: int | None = None, tsize=None):
        """Phase 2 on the mesh: each non-empty shortlist is gathered on the
        plan's device into a compact (Q, s_bucket) batch, its lanes split
        over the shards; each shard scores its lanes, fences dead ones
        and keeps its top ``k_shard``; the winners merge on the first
        device.  Every scored candidate passed ``min_join``, so the top
        ``top_k`` are exact."""
        maybe_fault("shortlist_dispatch", "distributed")
        by_dev, Q = self._replicate(trains, q_bucket, tsize)
        qb = int(next(iter(by_dev.values()))["keys"].shape[0])
        n = self.n_shards
        vs, gis, jss = [], [], []
        for sl in shortlists:
            if sl is None:
                continue
            home = sl.group.live.device
            rows = torch.from_numpy(_pad_rows_q(sl.rows, qb)).to(home).long()
            cand = [sl.group.arrays[f][rows] for f in _TRAIN_FIELDS]
            gi = torch.from_numpy(np.ascontiguousarray(
                _pad_rows_q(sl.gidx, qb))).to(home)
            js = torch.from_numpy(np.ascontiguousarray(
                _pad_rows_q(sl.js, qb))).to(home)
            k_shard, _ = _shard_topk_plan(sl.s_bucket, n, top_k)
            S = sl.s_bucket // n
            per_shard = []
            for s, dev in enumerate(self.devices):
                part = slice(s * S, (s + 1) * S)
                c = [t[:, part].to(dev) for t in cand]
                g, j = gi[:, part].to(dev), js[:, part].to(dev)
                mi, _ = _score_pairs(by_dev[dev], *c, est_id=sl.group.est_id,
                                     k=self.k)
                mi = _hybrid(by_dev[dev], mi, j)
                v, pos = _top_k(torch.where(g < plan.n_candidates, mi,
                                            -torch.inf), k_shard)
                per_shard.append((v, g.gather(1, pos), j.gather(1, pos)))
            vs.append(self._gather(per_shard, 0))
            gis.append(self._gather(per_shard, 1))
            jss.append(self._gather(per_shard, 2))
        if not vs:
            return _PendingTopk(None, None, None, Q)
        vals, gidx, jsz, k_live = self._merge(vs, gis, jss, top_k)
        return _PendingTopk(vals, gidx, jsz, Q, k_live=k_live)

    def fused_topk_dispatch(self, plan, trains, spec, min_join: int,
                            top_k: int, *, q_bucket: int | None = None,
                            tsize=None):
        """Fused two-phase on the mesh: per group and shard, prefilter,
        compaction, gather, scoring and top-k on the shard's own rows,
        then the merge; no host sync before the handle's ``collect``.
        Each shard compacts ``s_bucket // n_shards`` lanes (build
        ``spec`` with ``multiple=n_shards``), so the overflow fence is per
        (group, shard); an overflow at collect falls back to the host
        boundary through the handle's ``js_blocks()``."""
        maybe_fault("fused_dispatch", "distributed")
        by_dev, Q = self._replicate(trains, q_bucket, tsize)
        n = self.n_shards
        scalars = self._scalars((int(min_join), torch.int32),
                                (plan.n_candidates, torch.int32))
        vs, gis, jss, fence = [], [], [], []
        for sg, s_bucket in zip(self._groups(plan), spec.s_buckets):
            s_shard = max(min(int(s_bucket), sg.gp.bucket) // n, 1)
            k_shard = max(min(_next_pow2(top_k), s_shard), 1)
            out = sg.call(_shard_fused, by_dev, scalars, indexed=True,
                          est_id=sg.gp.est_id, k=self.k, s_shard=s_shard,
                          k_shard=k_shard)
            vs.append(self._gather(out, 0))
            gis.append(self._gather(out, 1))
            jss.append(self._gather(out, 2))
            fence.append((sg.gp, s_shard, self._gather(out, 3),
                          self._gather(out, 4)))
        if not vs:
            return _PendingFusedTopk(None, None, None, Q, 0, fence)
        vals, gidx, jsz, k_live = self._merge(vs, gis, jss, top_k)
        return _PendingFusedTopk(vals, gidx, jsz, Q, k_live, fence)

    def tiered_topk_dispatch(self, plan, trains, tspec, spec, min_join: int,
                             min_containment: float, top_k: int, *,
                             q_bucket: int | None = None, tsize=None):
        """The gated pipeline on the mesh: per group and shard, the
        phase-0 gate and the fused pipeline over the shard's rows, then
        the merge.  Build ``tspec`` and ``spec`` with
        ``multiple=n_shards``; both fences are per (group, shard).  An
        overflow at collect re-runs the window through
        :meth:`fused_topk_dispatch` (ungated)."""
        maybe_fault("tiered_dispatch", "distributed")
        by_dev, Q = self._replicate(trains, q_bucket, tsize)
        n = self.n_shards
        scalars = self._scalars(
            (int(min_join), torch.int32),
            (stage_min_containment(min_containment), torch.float32),
            (plan.n_candidates, torch.int32))
        vs, gis, jss, fence = [], [], [], []
        for sg, s_surv, s_bucket in zip(self._groups(plan), tspec.s_survivors,
                                        spec.s_buckets):
            if sg.gp.sig is None:
                raise ValueError(
                    "tiered dispatch on a plan without a signature tier")
            rows_local = max(sg.gp.bucket // n, 1)
            s_surv_shard = min(max(min(int(s_surv), sg.gp.bucket) // n, 1),
                               rows_local)
            s_shard = min(max(min(int(s_bucket), sg.gp.bucket) // n, 1),
                          s_surv_shard)
            k_shard = max(min(_next_pow2(top_k), s_shard), 1)
            out = sg.call(_shard_tiered, by_dev, scalars, indexed=True,
                          est_id=sg.gp.est_id, k=self.k, s_surv=s_surv_shard,
                          s_shard=s_shard, k_shard=k_shard)
            vs.append(self._gather(out, 0))
            gis.append(self._gather(out, 1))
            jss.append(self._gather(out, 2))
            fence.append((sg.gp, s_surv_shard, s_shard, self._gather(out, 3),
                          self._gather(out, 4)))
        if not vs:
            return _PendingTieredTopk(None, None, None, Q, 0, fence)
        vals, gidx, jsz, k_live = self._merge(vs, gis, jss, top_k)
        return _PendingTieredTopk(vals, gidx, jsz, Q, k_live, fence)


def get_executor(spec, mesh=None, k: int = 3) -> Executor:
    """Resolve an executor: an instance passes through; ``None`` picks
    the distributed backend when a mesh is given, else the partitioned
    one.  The distributed backend raises without a mesh."""
    if isinstance(spec, Executor):
        return spec
    if spec is None:
        spec = "distributed" if mesh is not None else "partitioned"
    if spec == "partitioned":
        return PartitionedLocalExecutor(k=k)
    if spec == "batched":
        return BatchedExecutor(k=k)
    if spec == "distributed":
        if mesh is None:
            raise ValueError("distributed executor requires a mesh")
        return GroupMajorDistributedExecutor(mesh, k=k)
    raise ValueError(f"unknown executor {spec!r}")


# ---------------------------------------------------------------------------
# The ad-hoc functional entry points (raw stacked arrays, no index).
# ---------------------------------------------------------------------------


def _one_train(train: dict) -> dict:
    """The tensor fields of one train sketch as (n,) rows: the
    reference's unstacked form passes, the port's Q=1 form is unstacked,
    a wider stack raises."""
    if train["keys"].dim() == 1:
        return {f: train[f] for f in _TRAIN_FIELDS}
    if train["keys"].shape[0] != 1:
        raise ValueError(
            f"the ad-hoc scorers take one train sketch; got a stack of "
            f"{train['keys'].shape[0]} (use query_many or an executor)"
        )
    return {f: train[f][0] for f in _TRAIN_FIELDS}


def stack_trains(trains: list[dict]) -> dict:
    """Stack single-query train dicts, each (n,) or Q=1, into one
    leading-Q dict."""
    if not trains:
        raise ValueError("no train sketches")
    y_disc = {bool(t.get("y_discrete", False)) for t in trains}
    if len(y_disc) != 1:
        raise ValueError(
            "query_many requires all train targets to share one dtype "
            "(got both discrete and continuous); split the batch"
        )
    rows = [_one_train(t) for t in trains]
    out = {f: torch.stack([r[f] for r in rows]) for f in _TRAIN_FIELDS}
    out["y_discrete"] = y_disc.pop()
    return out


def _score_by_estimator(train: dict, cands: dict, k: int, impl: str):
    """Join every candidate row with the lexsort join, then score each
    ``est_id`` group with its estimator, padded up the group ladder by
    :func:`~repro_torch.core.discovery.planner.group_rows` as a plan
    pads it (the padding rows repeat the group's first candidate with an
    all-False mask).  Returns (mi (C,) float32, js (C,) int32) on the
    inputs' device."""
    t = _one_train(train)
    ck, cm = cands["keys"], cands["mask"]
    xf, y_f, mask = sketch_join_lexsort(t["keys"], t["vals_f"], t["mask"],
                                        ck, cands["vals_f"], cm)
    xu, y_u, _ = sketch_join_lexsort(t["keys"], t["vals_u"], t["mask"],
                                     ck, cands["vals_u"], cm)
    est = torch.as_tensor(cands["est_id"]).cpu().numpy()
    mi = torch.zeros(len(est), dtype=torch.float32, device=ck.device)
    for eid, idx in partition_by_estimator(est):
        g = len(idx)
        rows, live = group_rows(idx, ck.device)
        m = mask[rows] & live[:, None]
        mi_g = _estimate(eid, xf[rows], xu[rows], y_f[rows], y_u[rows], m, k,
                         impl)
        mi[rows[:g]] = mi_g[:g]
    return mi, mask.sum(-1, dtype=torch.int32)


def score_batch(train: dict, cands: dict, k: int = 3):
    """MI of every candidate of a stacked dict against one train sketch.

    ``cands`` holds (C, cap) ``keys`` / ``vals_f`` / ``vals_u`` /
    ``mask`` tensors in any key order and ``est_id`` (C,), the estimator
    of each candidate; ``train`` one train sketch, (n,) or Q=1.  Returns
    (mi (C,) float32, join sizes (C,) int32) on the inputs' device.
    """
    return _score_by_estimator(train, cands, k, "fused")


def score_batch_reference(train: dict, cands: dict, k: int = 3):
    """:func:`score_batch` through the materialized (P×P) estimators: the
    seed's scoring path, kept for comparison.  Same inputs and outputs."""
    return _score_by_estimator(train, cands, k, "materialized")


def score_batch_partitioned(train: dict, cands: dict, k: int = 3,
                            groups: list[tuple] | None = None):
    """Estimator-partitioned scoring of a raw stacked dict: planned ad hoc
    by :func:`~repro_torch.core.discovery.planner.make_plan` (``groups``,
    ``(est_id, indices)`` entries, overrides the partition) and run by
    the partitioned executor.  Candidate keys must be sorted at ingest
    (as the index stores them).  Equal to :func:`score_batch`, bit for
    bit.  Returns (mi (C,) float32, join sizes (C,) int32) on the
    inputs' device."""
    device = cands["keys"].device
    C = int(torch.as_tensor(cands["est_id"]).shape[0])
    y_disc = bool(train.get("y_discrete", False))
    if groups is None:
        plan = make_plan(cands, y_discrete=y_disc)
    else:
        plan = QueryPlan(y_disc, C, [
            pack_group(cands, int(entry[0]), np.asarray(entry[1]), C)
            for entry in groups
        ], device)
    mi, js = PartitionedLocalExecutor(k=k).execute(plan, _one_train(train))
    return torch.from_numpy(mi[0]).to(device), torch.from_numpy(js[0]).to(device)


def distributed_topk(train: dict, cands: dict, mesh, top_k: int, k: int = 3):
    """Mesh-sharded discovery query of a raw stacked candidate dict with a
    per-shard top-k and the merge on the first device.

    The candidates are planned ad hoc with every group bucket rounded to
    the shard count (:func:`~repro_torch.core.discovery.planner.make_plan`
    with ``pad_multiple``) on every call; repeated callers hold a
    :class:`GroupMajorDistributedExecutor` and the index's cached plan,
    as ``SketchIndex.query(mesh=...)`` does.  Returns (values, global
    ids, join sizes) of the global top ``min(top_k, C)``, best first, as
    host arrays.
    """
    plan = make_plan(cands, y_discrete=bool(train.get("y_discrete", False)),
                     pad_multiple=mesh.shape["data"])
    ex = GroupMajorDistributedExecutor(mesh, k=k)
    return ex.topk(plan, _one_train(train), top_k)[0]

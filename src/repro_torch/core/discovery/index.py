"""Device-resident candidate index (PyTorch port).

:class:`SketchIndex` holds candidate sketches in preallocated tensors on
its device, one group-major store per (target dtype, estimator group).
``add`` is a host-side append (build and validate the sketch); the next
``plan()`` flushes only the pending rows into the stores, doubling row
capacity along a power-of-two ladder when full.  Keys are stored in
*effective* form (masked slots fenced to 0xFFFFFFFF) as zero-extended
int64, so the hot join is one ``searchsorted`` per (query, candidate).

:meth:`SketchIndex.stacked` gives the corpus as dense device tensors in
candidate order with each candidate's ``est_id`` (its own store,
flushed incrementally), the input of the ad-hoc scorers
(``executors.score_batch`` and its siblings).

``query`` / ``query_many`` run two-phase retrieval by default: a
join-size prefilter shortlists the candidates that can pass
``min_join`` and only those are gathered and scored — fused on the
device, with the host shortlist boundary as the overflow fallback.
``prefilter=False`` scores the whole corpus (the dense path) and
``fused=False`` forces the host boundary (the staged path); all three
give the same rankings.

``min_containment > 0`` puts the phase-0 containment gate in front of
the fused pipeline: every flush also writes each candidate's
bottom-``sig_width`` key signature (:func:`_signature_block`), one
signature sweep over the whole corpus estimates each candidate's
containment of the train keys, and only the survivors reach the exact
phases, which then run at survivor width.  A survivor-buffer overflow
re-runs the window ungated.

``mesh=`` (a :class:`~repro_torch.launch.mesh.Mesh`) runs every path on
the group-major distributed executor, one per (mesh, k), shared with the
service: candidate rows sharded over the mesh's ``"data"`` axis, each
shard keeping its own top-k and the winners merged on the first device.
The dense mesh path asks each shard for :func:`topk_oversample` winners
so that the ``min_join`` filter cannot starve the result list.

The device flush carries the ``flush`` fault-injection site, fired
before either tier mutates.  Not in the port: the reference's plan
leases, which it does not need (see ``_DeviceStore.append_block``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.discovery import executors as _ex
from repro_torch.core.discovery.planner import (
    EST_MLE,
    MIN_BUCKET,
    GroupPlan,
    QueryPlan,
    ShortlistHints,
    ShortlistOverflow,
    SurvivorOverflow,
    build_shortlists,
    estimator_id,
    fused_shortlist_spec,
    tier_spec,
)
from repro_torch.core.discovery.resilience import maybe_fault
from repro_torch.core.join import KEY_MAX
from repro_torch.core.sketch import Sketch, build_sketch
from repro_torch.device import resolve_device

__all__ = ["CandidateMeta", "SketchIndex", "topk_oversample"]

# Gather indices, group row ids and the dead-candidate sentinel are int32
# end to end; ingest refuses to grow past the int32 index space.
_MAX_ROWS_I32 = 2**31 - 1

_DTYPES = {
    "keys": torch.int64,
    "vals_f": torch.float32,
    "vals_u": torch.int64,
    "mask": torch.bool,
}
_FILL = {"keys": KEY_MAX, "vals_f": 0, "vals_u": 0, "mask": False}


def topk_oversample(top_k: int, n_candidates: int) -> int:
    """Winners the dense mesh path asks for: 4x ``top_k``, so that the
    ``min_join`` filter can drop high-MI, low-support candidates without
    starving the list.  One definition for ``query``, ``query_many`` and
    ``DiscoveryService.submit``: their equality rests on asking the
    executor for the same count."""
    return max(min(top_k * 4, n_candidates), 1)


def _signature_block(block: dict[str, np.ndarray], w: int) -> np.ndarray:
    """Phase-0 signatures of a host block about to be flushed.

    The block's keys are effective (masked slots fenced to KEY_MAX, the
    valid prefix first, ascending), so its first ``w`` columns are each
    candidate's bottom-``w`` keys, the sample
    :func:`~repro_torch.core.join.signature_join_size` estimates from.
    They are kept as int32 bit patterns of the uint32 keys (the fence
    becomes -1), followed by one column with the live key count.  Built
    from the same host block as the sketch rows, inside the same
    append, so the two tiers never disagree about a candidate.
    """
    keys = np.ascontiguousarray(block["keys"][:, :w]).astype(np.uint32)
    count = block["mask"].sum(axis=1, dtype=np.int32)
    return np.concatenate([keys.view(np.int32), count[:, None]], axis=1)


@dataclass
class CandidateMeta:
    table: str
    key_column: str
    value_column: str
    value_is_discrete: bool


class _DeviceStore:
    """Preallocated device tensors with power-of-two row-capacity doubling.

    Rows [0, rows) are live; rows beyond carry an all-False mask and
    KEY_MAX keys, so they join empty wherever they leak into a batch.
    ``sig_cols`` adds the phase-0 signature tier under ``arrays["sig"]``:
    (cap_rows, sig_cols + 1) int32, dead rows -1, on the same capacity
    ladder and in the same ``append_block`` as the sketches.
    """

    def __init__(self, cap_cols: int, device: torch.device,
                 sig_cols: int | None = None):
        self.cap_cols = cap_cols
        self.device = device
        self.sig_cols = sig_cols
        self._dtypes = dict(_DTYPES)
        self._fill = dict(_FILL)
        if sig_cols:
            self._dtypes["sig"] = torch.int32
            self._fill["sig"] = -1
        self.cap_rows = 0
        self.rows = 0
        self.arrays: dict[str, torch.Tensor] = {}
        self.grows = 0
        self.h2d_rows = 0

    def _cols(self, name: str) -> int:
        return self.sig_cols + 1 if name == "sig" else self.cap_cols

    @property
    def device_bytes(self) -> dict[str, int]:
        """Allocated device bytes per tier (capacity, not live rows)."""
        nbytes = {name: a.numel() * a.element_size()
                  for name, a in self.arrays.items()}
        return {"sketch": sum(v for k, v in nbytes.items() if k != "sig"),
                "signature": nbytes.get("sig", 0)}

    def ensure_rows(self, need: int) -> None:
        if need <= self.cap_rows:
            return
        if need > _MAX_ROWS_I32:
            raise OverflowError(
                f"device store cannot grow to {need} rows: candidate "
                f"indices are int32 end-to-end (max {_MAX_ROWS_I32})"
            )
        new_cap = max(self.cap_rows, MIN_BUCKET)
        while new_cap < need:
            new_cap *= 2
        new = {
            name: torch.full((new_cap, self._cols(name)), self._fill[name],
                             dtype=dt, device=self.device)
            for name, dt in self._dtypes.items()
        }
        if self.cap_rows:
            for name, a in self.arrays.items():
                new[name][:self.rows].copy_(a[:self.rows])
            self.grows += 1
        self.arrays = new
        self.cap_rows = new_cap

    def append_block(self, block: dict[str, np.ndarray]) -> None:
        """Write ``block`` rows after the live rows.

        The append is in place: ``copy_`` into a slice of the
        preallocated tensors, where the reference donates the store
        buffer to a ``dynamic_update_slice``.  Only the new rows cross
        the bus.  A plan built before the append still sees its own rows
        unchanged; the new rows land in rows it holds as dead, and the
        copy is enqueued behind whatever that plan's work already
        enqueued on the same stream.  A grow allocates new tensors while
        the old plan keeps its own.  So, unlike the reference, no plan
        needs a lease against a flush.
        """
        n_new = block["keys"].shape[0]
        if n_new == 0:
            return
        if self.sig_cols:
            block = {**block, "sig": _signature_block(block, self.sig_cols)}
        # Fault-injection site: fires before any store mutation, so an
        # injected flush failure leaves rows and tensors of both tiers
        # consistent and the next flush retries the same pending block.
        maybe_fault("flush")
        self.ensure_rows(self.rows + n_new)
        r0 = self.rows
        for name, a in self.arrays.items():
            a[r0:r0 + n_new].copy_(torch.from_numpy(block[name]))
        self.rows += n_new
        self.h2d_rows += n_new


class _GroupState:
    """Incrementally maintained group-major layout for one target dtype."""

    def __init__(self):
        self.stores: dict[int, _DeviceStore] = {}
        self.index: dict[int, list[int]] = {}
        self.flushed = 0


class SketchIndex:
    """Repository-side index: candidate sketches, device-resident, with
    incremental ingest and version-checked group-major query plans.

    ``device`` defaults to ``"cuda"`` and raises when no card is present.
    ``sig_width`` is the phase-0 signature width: the bottom-``sig_width``
    keys of every candidate, kept on the device for the containment gate
    (clamped to the sketch capacity; <= 0 keeps no signature tier).
    """

    def __init__(self, n: int = 256, method: str = "tupsk",
                 agg: str = "first", device: str | torch.device | None = None,
                 sig_width: int = 16):
        self.n = n
        self.method = method
        self.agg = agg
        self.device = resolve_device(device)
        self.sig_width = int(sig_width)
        self.meta: list[CandidateMeta] = []
        self._keys: list[np.ndarray] = []
        self._vals_f: list[np.ndarray] = []
        self._vals_u: list[np.ndarray] = []
        self._masks: list[np.ndarray] = []
        self._discrete: list[bool] = []
        self._cap_cols: int | None = None
        self._version = 0
        self._store: _DeviceStore | None = None
        self._groups: dict[bool, _GroupState] = {}
        self._stacked_cache: dict[tuple[bool, int], tuple[int, dict]] = {}
        self._plan_cache: dict[bool, tuple[int, QueryPlan]] = {}
        # Adaptive compaction-width rungs of the fused two-phase path.
        self.shortlist_hints = ShortlistHints()
        # The gated path's own rungs: its survivor rungs ("tier0" keys)
        # and its shortlist rungs, which count within the survivors and
        # so must not shrink the ungated path's.
        self.tier_hints = ShortlistHints()
        # One distributed executor per (mesh, k), held across queries so
        # its sharded group cache serves every query of a plan.
        self._dist_executors: dict = {}

    def __len__(self) -> int:
        return len(self.meta)

    # ------------------------------------------------------------------
    # Ingest (host-side append; the device flush is deferred)
    # ------------------------------------------------------------------

    def _build_validated(self, key_hashes, values, value_is_discrete,
                         agg, cap_cols) -> Sketch:
        """Build one candidate sketch and check every ingest invariant
        without touching index state."""
        sk = build_sketch(
            key_hashes, values, n=self.n, method=self.method, side="cand",
            agg=agg or self.agg, value_is_discrete=value_is_discrete,
        )
        size = sk.size
        if not np.all(np.diff(sk.key_hashes[:size].astype(np.int64)) > 0):
            raise ValueError(
                "candidate sketch violates the sorted-at-ingest key invariant"
            )
        if cap_cols is not None and sk.capacity != cap_cols:
            raise ValueError(
                f"sketch capacity {sk.capacity} != index capacity "
                f"{cap_cols} (one n/method per index)"
            )
        return sk

    def _commit_arrays(self, meta: CandidateMeta, keys, vals_f, vals_u,
                       mask) -> None:
        """Append one validated candidate's host arrays."""
        if len(self.meta) >= _MAX_ROWS_I32:
            raise OverflowError(
                "index is full: candidate ids (and the dead-row "
                f"sentinel) are int32 end-to-end (max {_MAX_ROWS_I32})"
            )
        if self._cap_cols is None:
            self._cap_cols = len(keys)
        self.meta.append(meta)
        self._keys.append(keys)
        self._vals_f.append(vals_f)
        self._vals_u.append(vals_u)
        self._masks.append(mask)
        self._discrete.append(bool(meta.value_is_discrete))
        self._version += 1

    def _commit(self, table, key_column, value_column, sk: Sketch) -> None:
        vf, vu = sk.value_views()
        self._commit_arrays(
            CandidateMeta(table, key_column, value_column, sk.value_is_discrete),
            sk.key_hashes, vf, vu, sk.mask,
        )

    def add(self, table: str, key_column: str, value_column: str,
            key_hashes: np.ndarray, values: np.ndarray,
            value_is_discrete: bool | None = None, agg: str | None = None) -> None:
        sk = self._build_validated(
            key_hashes, values, value_is_discrete, agg, self._cap_cols
        )
        self._commit(table, key_column, value_column, sk)

    def add_table(self, table, key_column: str) -> None:
        """Index every (key, value) column pair of a Table, atomically:
        all columns are built and validated before any is committed."""
        key_codes = table[key_column].key_codes()
        staged: list[tuple[str, Sketch]] = []
        cap = self._cap_cols
        for _, val_col in table.pairs(key_column):
            col = table[val_col]
            sk = self._build_validated(
                key_codes, col.value_array(), col.is_discrete, None, cap
            )
            if cap is None:
                cap = sk.capacity
            staged.append((val_col, sk))
        if len(self.meta) + len(staged) > _MAX_ROWS_I32:
            raise OverflowError(
                f"index is full: table {table.name!r} would pass the int32 "
                f"candidate-id space (max {_MAX_ROWS_I32})"
            )
        for val_col, sk in staged:
            self._commit(table.name, key_column, val_col, sk)

    @property
    def ingest_stats(self) -> dict:
        """Host->device transfer accounting: rows ever uploaded into the
        stacked store and into the group stores (each equal to the
        candidates, per cached dtype for the groups, when ingest is
        incremental), capacity doublings, rows on no device store yet,
        and the allocated device bytes of each tier (full sketches;
        phase-0 signatures)."""
        groups = [st for state in self._groups.values()
                  for st in state.stores.values()]
        stores = groups + ([self._store] if self._store else [])
        flushed = max([self._store.rows if self._store else 0]
                      + [s.flushed for s in self._groups.values()])
        return {
            "h2d_rows": self._store.h2d_rows if self._store else 0,
            "store_grows": self._store.grows if self._store else 0,
            "group_h2d_rows": sum(st.h2d_rows for st in groups),
            "group_store_grows": sum(st.grows for st in groups),
            "pending_rows": len(self.meta) - flushed,
            "sketch_bytes": sum(st.device_bytes["sketch"] for st in stores),
            "signature_bytes": sum(st.device_bytes["signature"]
                                   for st in stores),
        }

    # ------------------------------------------------------------------
    # Device flush and plans
    # ------------------------------------------------------------------

    def _host_block(self, idx: list[int]) -> dict[str, np.ndarray]:
        """Candidates ``idx`` in device-store form: effective keys (masked
        slots fenced to KEY_MAX) and the uint32 value view, both int64."""
        masks = np.stack([self._masks[i] for i in idx]).astype(bool)
        keys = np.stack([self._keys[i] for i in idx]).astype(np.int64)
        return {
            "keys": np.where(masks, keys, np.int64(KEY_MAX)),
            "vals_f": np.stack([self._vals_f[i] for i in idx]).astype(np.float32),
            "vals_u": np.stack([self._vals_u[i] for i in idx]).astype(np.int64),
            "mask": masks,
        }

    def _sig_cols(self) -> int | None:
        """The committed signature width: ``sig_width`` clamped to the
        sketch capacity (at capacity <= width the signature is the whole
        key set and the gate's estimate exact); None without a tier."""
        if self.sig_width <= 0 or self._cap_cols is None:
            return None
        return min(self.sig_width, self._cap_cols)

    def _host_row(self, i: int) -> dict[str, np.ndarray]:
        """Candidate ``i``'s host arrays in device-store form (keys kept
        as int64, where the reference's ``_host_row`` gives uint32)."""
        return {name: a[0] for name, a in self._host_block([i]).items()}

    def _flush_groups(self, y_discrete: bool) -> _GroupState:
        state = self._groups.setdefault(bool(y_discrete), _GroupState())
        C = len(self.meta)
        if state.flushed < C:
            by_eid: dict[int, list[int]] = {}
            for i in range(state.flushed, C):
                eid = estimator_id(self._discrete[i], y_discrete)
                by_eid.setdefault(eid, []).append(i)
            for eid, idx in by_eid.items():
                store = state.stores.setdefault(
                    eid, _DeviceStore(self._cap_cols, self.device,
                                      self._sig_cols())
                )
                store.append_block(self._host_block(idx))
                state.index.setdefault(eid, []).extend(idx)
            state.flushed = C
        return state

    def _flush_store(self) -> _DeviceStore:
        """The stacked store (every candidate in candidate order, no
        signature tier) with the pending rows flushed into it."""
        if self._store is None:
            self._store = _DeviceStore(self._cap_cols, self.device)
        pending = list(range(self._store.rows, len(self.meta)))
        if pending:
            self._store.append_block(self._host_block(pending))
        return self._store

    def stacked(self, y_is_discrete: bool, pad_to_multiple: int = 1) -> dict:
        """The corpus as dense device tensors in candidate order: the
        stacked store's ``keys`` (effective form), ``vals_f``, ``vals_u``
        and ``mask`` rows, and ``est_id`` (C,) int32, each candidate's
        estimator against a target of this dtype.

        The candidate axis pads to a multiple of ``pad_to_multiple`` with
        all-False-mask rows scored by MLE.  Cached per (target dtype,
        padding) until the next ``add``; an ``add`` after ``stacked()``
        uploads only the new rows on the next call.  The rows returned
        are never written again: an ``add`` appends after them, a grow
        allocates new tensors, and padding rows are tensors of their own.
        """
        C = len(self.meta)
        if C == 0:
            raise ValueError("empty index")
        cache_key = (bool(y_is_discrete), int(pad_to_multiple))
        hit = self._stacked_cache.get(cache_key)
        if hit is not None and hit[0] == self._version:
            return hit[1]
        store = self._flush_store()
        pad = -(-C // pad_to_multiple) * pad_to_multiple - C
        out = {}
        for name, dt in _DTYPES.items():
            rows = store.arrays[name][:C]
            if pad:
                rows = torch.cat([rows, torch.full(
                    (pad, store.cap_cols), _FILL[name], dtype=dt,
                    device=self.device)])
            out[name] = rows
        est_ids = np.array(
            [estimator_id(d, y_is_discrete) for d in self._discrete]
            + [EST_MLE] * pad, dtype=np.int32)
        out["est_id"] = torch.from_numpy(est_ids).to(self.device)
        self._stacked_cache[cache_key] = (self._version, out)
        return out

    def plan(self, y_is_discrete: bool) -> QueryPlan:
        """The executor-ready plan for this corpus and target dtype,
        cached until the next ``add`` (version-checked)."""
        C = len(self.meta)
        if C == 0:
            raise ValueError("empty index")
        y_is_discrete = bool(y_is_discrete)
        hit = self._plan_cache.get(y_is_discrete)
        if hit is not None and hit[0] == self._version:
            return hit[1]
        state = self._flush_groups(y_is_discrete)
        groups = []
        for eid in sorted(state.stores):
            store = state.stores[eid]
            g = store.rows
            index = np.concatenate([
                np.asarray(state.index[eid], np.int32),
                np.full(store.cap_rows - g, C, np.int32),
            ])
            live = torch.from_numpy(np.arange(store.cap_rows) < g).to(self.device)
            groups.append(GroupPlan(
                eid, {name: store.arrays[name] for name in _DTYPES}, index,
                live, g, torch.from_numpy(index).to(self.device),
                sig=store.arrays.get("sig"),
            ))
        plan = QueryPlan(y_is_discrete, C, groups, self.device)
        self._plan_cache[y_is_discrete] = (self._version, plan)
        return plan

    def train_arrays(self, sk: Sketch) -> dict:
        """Train-side sketch formatted for the scorers, on the device, as
        a Q=1 stacked dict (no fault sites: see ``executors.train_arrays``)."""
        return _ex.train_arrays([sk], self.device)

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------

    def _distributed_executor(self, mesh, k: int = 3):
        ex = self._dist_executors.get((mesh, k))
        if ex is None:
            ex = self._dist_executors[(mesh, k)] = \
                _ex.GroupMajorDistributedExecutor(mesh, k=k)
        return ex

    def _rank(self, v, gi, js, top_k: int, min_join: int,
              C: int | None = None) -> list:
        """Score descending, global candidate index ascending on ties —
        the rule that makes shortlist rankings equal dense rankings."""
        C = len(self.meta) if C is None else int(C)
        order = np.lexsort((gi, -np.where(js >= min_join, v, -np.inf)))
        out = []
        for idx in order:
            if gi[idx] >= C or js[idx] < min_join:
                continue
            out.append((self.meta[gi[idx]], float(v[idx]), int(js[idx])))
            if len(out) >= top_k:
                break
        return out

    @staticmethod
    def _use_prefilter(prefilter: bool | None, min_join: int) -> bool:
        return (min_join > 0) if prefilter is None else bool(prefilter)

    def _fused_triples(self, plan: QueryPlan, trains, top_k: int,
                       min_join: int, ex, n_shards: int) -> list:
        """The fused device pipeline, with the host boundary as the
        overflow fallback; observed survivor counts update the hints
        (per shard on a mesh of more than one shard)."""
        sharded = n_shards > 1
        on_mesh = isinstance(ex, _ex.GroupMajorDistributedExecutor)
        mult = n_shards if sharded else 1
        hints = self.shortlist_hints
        spec = fused_shortlist_spec(plan, hints, min_join, multiple=mult,
                                    sharded=sharded)
        if on_mesh:
            handle = ex.fused_topk_dispatch(plan, trains, spec, min_join,
                                            top_k)
        else:
            handle = ex.fused_dispatch(plan, trains, spec, min_join)
        try:
            triples = handle.collect()
            overflowed = False
        except ShortlistOverflow:
            triples = None
            overflowed = True
        for eid, m in handle.observed.items():
            hints.observe(
                (plan.y_discrete, eid, int(min_join), sharded), m,
                overflowed=overflowed,
            )
        if overflowed:
            shortlists = build_shortlists(plan, handle.js_blocks(), min_join,
                                          multiple=mult)
            if on_mesh:
                triples = ex.shortlist_topk_dispatch(
                    plan, trains, shortlists, top_k).collect()
            else:
                triples = ex.shortlist_dispatch(plan, trains,
                                                shortlists).collect()
        return triples

    def _tiered_triples(self, plan: QueryPlan, trains, top_k: int,
                        min_join: int, min_containment: float, ex,
                        n_shards: int) -> list:
        """The phase-0 containment gate in front of the fused pipeline.

        One signature sweep over every candidate estimates its
        containment of the train keys; only the survivors reach the
        exact prefilter, compaction, gather and scoring, which run at
        survivor width.  The one host sync is the fused path's collect.
        A fence breach (:class:`SurvivorOverflow`) re-runs the window
        through the ungated :meth:`_fused_triples`.  Survivor and
        shortlist rungs live in ``tier_hints``.
        """
        sharded = n_shards > 1
        on_mesh = isinstance(ex, _ex.GroupMajorDistributedExecutor)
        mult = n_shards if sharded else 1
        hints = self.tier_hints
        tspec = tier_spec(plan, hints, min_containment, multiple=mult,
                          sharded=sharded)
        spec = fused_shortlist_spec(plan, hints, min_join, multiple=mult,
                                    sharded=sharded)
        if on_mesh:
            handle = ex.tiered_topk_dispatch(plan, trains, tspec, spec,
                                             min_join, min_containment, top_k)
        else:
            handle = ex.tiered_dispatch(plan, trains, tspec, spec, min_join,
                                        min_containment)
        try:
            triples = handle.collect()
            overflowed = False
        except SurvivorOverflow:
            triples = None
            overflowed = True
        mc_key = round(float(min_containment), 6)
        for eid, m in handle.observed_t0.items():
            hints.observe(("tier0", plan.y_discrete, eid, mc_key, sharded), m,
                          overflowed=overflowed)
        for eid, m in handle.observed.items():
            if overflowed:
                # A truncated survivor buffer truncates the shortlist
                # count with it; the survivor count bounds it from above,
                # so growing to it converges in one round.
                m = max(m, handle.observed_t0.get(eid, 0))
            hints.observe((plan.y_discrete, eid, int(min_join), sharded), m,
                          overflowed=overflowed)
        if overflowed:
            triples = self._fused_triples(plan, trains, top_k, min_join, ex,
                                          n_shards)
        return triples

    def _two_phase(self, plan: QueryPlan, trains, top_k: int,
                   min_join: int, mesh, k: int, fused: bool | None,
                   min_containment: float = 0.0) -> list:
        """Join-size prefilter (phase 1), then gather-and-score of the
        survivors (phase 2); one ranked list per query.
        ``min_containment`` > 0 puts the phase-0 gate in front of the
        fused pipeline (it needs the fused path and the signature tier);
        at 0 the window takes the ungated fused path.  With ``mesh`` every
        phase runs sharded on the distributed executor."""
        use_fused = fused is None or bool(fused)
        gate = float(min_containment) > 0.0
        if gate and not use_fused:
            raise ValueError(
                "min_containment > 0 requires the fused pipeline "
                "(fused=False forces the host-boundary reference path, "
                "which has no phase-0 gate)"
            )
        if gate and any(gp.sig is None for gp in plan.groups):
            raise ValueError(
                "min_containment > 0 requires a signature tier; this "
                "index was built with sig_width <= 0"
            )
        if mesh is not None:
            ex = self._distributed_executor(mesh, k)
            n_shards = mesh.shape["data"]
        else:
            ex = _ex.BatchedExecutor(k=k)
            n_shards = 1
        if gate:
            triples = self._tiered_triples(plan, trains, top_k, min_join,
                                           min_containment, ex, n_shards)
        elif use_fused:
            triples = self._fused_triples(plan, trains, top_k, min_join, ex,
                                          n_shards)
        else:
            shortlists = build_shortlists(
                plan, ex.prefilter_dispatch(plan, trains).collect(), min_join,
                multiple=n_shards,
            )
            if mesh is not None:
                triples = ex.shortlist_topk_dispatch(
                    plan, trains, shortlists, top_k).collect()
            else:
                triples = ex.shortlist_dispatch(plan, trains,
                                                shortlists).collect()
        return [
            self._rank(v, gi, js, top_k, min_join) for v, gi, js in triples
        ]

    def _check_options(self, min_containment, prefilter, min_join) -> None:
        if float(min_containment) > 0.0 and not self._use_prefilter(
            prefilter, min_join
        ):
            raise ValueError(
                "min_containment > 0 requires two-phase retrieval "
                "(prefilter=False disables the pipeline the gate fronts)"
            )

    def query(self, train_sketch: Sketch, top_k: int = 10, mesh=None,
              min_join: int = 8, k: int = 3, prefilter: bool | None = None,
              fused: bool | None = None, min_containment: float = 0.0):
        """Rank candidates by estimated MI with the train target.

        Returns a list of (CandidateMeta, mi, join_size), best first.
        ``prefilter`` (default: on when ``min_join`` > 0) runs two-phase
        retrieval, fused unless ``fused=False``.  ``min_containment`` > 0
        adds the phase-0 containment gate: only candidates whose
        estimated containment (signature join size / train size) reaches
        the threshold are scored.  The gate is an estimate, exact for
        candidates holding at most ``sig_width`` keys.  ``mesh`` shards
        the candidates over its ``"data"`` axis.
        """
        self._check_options(min_containment, prefilter, min_join)
        train = self.train_arrays(train_sketch)
        C = len(self.meta)
        plan = self.plan(train_sketch.value_is_discrete)
        if self._use_prefilter(prefilter, min_join):
            return self._two_phase(plan, train, top_k, min_join, mesh, k,
                                   fused, min_containment)[0]
        if mesh is not None:
            ex = self._distributed_executor(mesh, k)
            v, gi, js = ex.topk(plan, train, topk_oversample(top_k, C))[0]
            return self._rank(v, gi, js, top_k, min_join)
        mi, jsz = _ex.PartitionedLocalExecutor(k=k).execute(plan, train)
        return self._rank(mi[0], np.arange(C), jsz[0], top_k, min_join)

    def query_many(self, train_sketches: list[Sketch], top_k: int = 10,
                   min_join: int = 8, mesh=None, executor=None, k: int = 3,
                   prefilter: bool | None = None, fused: bool | None = None,
                   min_containment: float = 0.0):
        """Answer Q concurrent discovery queries of one target dtype in
        one executor pass; one result list per train sketch.

        ``executor=`` (a name for :func:`~repro_torch.core.discovery
        .executors.get_executor`, or an instance) keeps the dense path
        through that executor; with ``prefilter=True`` or with
        ``min_containment > 0`` it raises, since the two-phase path picks
        its own backend.  With ``mesh`` the dense path runs the
        distributed executor's top-k (an ``executor=`` must then be the
        distributed one)."""
        if executor is not None and prefilter:
            raise ValueError(
                "prefilter=True is incompatible with executor=: the "
                "two-phase path picks its own backend (drop executor=, "
                "or pass prefilter=False/None for dense scoring)"
            )
        if float(min_containment) > 0.0 and (
            executor is not None
            or not self._use_prefilter(prefilter, min_join)
        ):
            raise ValueError(
                "min_containment > 0 requires the two-phase path "
                "(incompatible with executor= and with prefilter=False)"
            )
        if not train_sketches:
            return []
        y_disc = {bool(sk.value_is_discrete) for sk in train_sketches}
        if len(y_disc) != 1:
            raise ValueError(
                "query_many requires one target dtype per batch; split "
                "discrete and continuous targets"
            )
        trains = _ex.stack_trains_host(train_sketches, self.device)
        plan = self.plan(y_disc.pop())
        C = len(self.meta)
        if self._use_prefilter(prefilter, min_join) and executor is None:
            return self._two_phase(plan, trains, top_k, min_join, mesh, k,
                                   fused, min_containment)
        if executor is None:
            ex = (self._distributed_executor(mesh, k) if mesh is not None
                  else _ex.BatchedExecutor(k=k))
        else:
            ex = _ex.get_executor(executor, mesh=mesh, k=k)
        if mesh is not None:
            if not isinstance(ex, _ex.GroupMajorDistributedExecutor):
                raise ValueError(
                    f"mesh= runs the distributed executor's top-k; "
                    f"executor={executor!r} has none (drop executor= or "
                    f"pass executor='distributed')"
                )
            triples = ex.topk(plan, trains, topk_oversample(top_k, C))
        else:
            mi, js = ex.execute(plan, trains)
            triples = [(mi[q], np.arange(C), js[q])
                       for q in range(mi.shape[0])]
        return [
            self._rank(v, gi, js, top_k, min_join) for v, gi, js in triples
        ]

"""Resilience layer of the serving stack (PyTorch port): per-query
outcomes, bucket-level fault isolation, numeric fences, and a
deterministic fault-injection harness.

The four pieces ``DiscoveryService.submit_safe`` composes, as in
``repro.core.discovery.resilience``:

  * **Admission validation + quarantine** — :func:`validate_query`
    checks every sketch before it reaches the executors (capacity/``n``
    against the index, empty/all-masked, non-finite values, unknown
    dtype); offenders become structured :class:`QueryOutcome` errors
    while the rest of the queue serves unchanged.
  * **Retry/fallback ladder** — :class:`RetryPolicy` bounds same-rung
    re-attempts with exponential backoff; a bucket that exhausts its
    executor degrades down the ladder (distributed mesh, with a mesh ->
    batched -> the reference per-query loop).
  * **Numeric fences** — :func:`fence_nonfinite` finds non-finite MI
    lanes after collect and recomputes them through the materialized
    estimators (:func:`reference_score_pairs`), which reach the
    ``pairwise_cheb`` kernel on the card instead of ``radius_counts``.
  * **Deterministic fault injection** — :func:`inject_faults` arms the
    named sites threaded through ``executors.py`` (``stack_h2d``,
    ``staging``, ``dispatch``, ``prefilter_dispatch``,
    ``shortlist_dispatch``, ``fused_dispatch``, ``tiered_dispatch``,
    ``collect``), ``index.py`` (``flush``) and ``scheduler.py``
    (``window_timer``, ``ingest_midflight``) with seeded failure
    schedules.  The pseudo-site ``scores`` does not raise: it corrupts
    collected MI lanes with NaN (:func:`corrupt_scores`) to drive the
    fence end to end.

Import discipline: this module sits below ``executors`` / ``index`` /
``service`` in the import graph (they call the hooks here), so it
imports ``executors`` only inside :func:`reference_score_pairs`.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.discovery.planner import estimator_id

__all__ = [
    "FAULT_SITES",
    "FaultPlan",
    "InjectedFault",
    "QueryOutcome",
    "RetryPolicy",
    "corrupt_scores",
    "fence_nonfinite",
    "inject_faults",
    "maybe_fault",
    "reference_score_pairs",
    "validate_query",
]


# ---------------------------------------------------------------------------
# Fault-injection harness
# ---------------------------------------------------------------------------

# Named sites instrumented through the serving stack.  Raising sites
# abort the enclosing bucket stage; "scores" is a corruption site (NaN
# lanes, consumed by corrupt_scores) and never raises.
FAULT_SITES = (
    "stack_h2d",           # executors.upload_trains (train H2D upload)
    "staging",             # executors.stage_trains_host (host-side stack)
    "dispatch",            # dense dispatch
    "prefilter_dispatch",  # two-phase phase 1 enqueue
    "shortlist_dispatch",  # two-phase phase 2 enqueue
    "fused_dispatch",      # fused two-phase enqueue (single pipeline)
    "tiered_dispatch",     # phase-0-gated tiered enqueue
    "collect",             # any pending handle's first host sync
    "flush",               # index._DeviceStore.append_block (ingest)
    "window_timer",        # scheduler loop's coalesce-window tick
    "ingest_midflight",    # scheduler.add while windows are in flight
    "scores",              # NaN corruption of collected MI lanes
)


class InjectedFault(RuntimeError):
    """Raised by an armed fault site; carries the site key + invocation."""


class FaultPlan:
    """One armed injection schedule (see :func:`inject_faults`).

    ``schedule`` maps a site key to *which invocations fail*:

      * ``"site"`` matches the site under any executor scope;
        ``"site@scope"`` matches only calls made with that scope
        (``"batched"`` or ``"distributed"``, the executor's rung).
      * value ``"all"`` — every invocation raises; ``int n`` — the first
        ``n`` invocations raise; iterable of ints — exactly those 0-based
        invocation indices raise.  (For the ``scores`` corruption site
        the int is instead the number of lanes to NaN per query row.)

    Invocation counters are per schedule key and advance only while the
    plan is armed, so a schedule is a deterministic function of the
    call sequence.  ``seed`` drives only the ``scores`` lane picker.
    """

    def __init__(self, schedule: dict, *, seed: int = 0):
        self.schedule: dict[str, object] = {}
        for key, val in dict(schedule).items():
            site = key.split("@", 1)[0]
            if site not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; sites: {FAULT_SITES}"
                )
            if site == "scores":
                self.schedule[key] = int(val)
            elif val == "all":
                self.schedule[key] = "all"
            elif isinstance(val, (int, np.integer)):
                self.schedule[key] = frozenset(range(int(val)))
            else:
                self.schedule[key] = frozenset(int(i) for i in val)
        self.counts: dict[str, int] = {}
        self.fired: dict[str, int] = {}
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.corrupted = 0  # lanes NaN'd via the "scores" site

    def _keys_for(self, site: str, scope: str | None) -> list[str]:
        keys = []
        if scope is not None and f"{site}@{scope}" in self.schedule:
            keys.append(f"{site}@{scope}")
        if site in self.schedule:
            keys.append(site)
        return keys

    def check(self, site: str, scope: str | None) -> None:
        for key in self._keys_for(site, scope):
            sched = self.schedule[key]
            idx = self.counts.get(key, 0)
            self.counts[key] = idx + 1
            if sched == "all" or idx in sched:
                self.fired[key] = self.fired.get(key, 0) + 1
                raise InjectedFault(f"injected fault at {key}[{idx}]")

    def scores_lanes(self) -> int:
        """Lanes to corrupt per query row (0 = site unarmed)."""
        return int(self.schedule.get("scores", 0))


_ACTIVE: FaultPlan | None = None


def maybe_fault(site: str, scope: str | None = None) -> None:
    """Hook called at every instrumented site; no-op unless a plan is
    armed via :func:`inject_faults` (one branch on the hot path)."""
    if _ACTIVE is not None:
        _ACTIVE.check(site, scope)


@contextlib.contextmanager
def inject_faults(schedule: dict, *, seed: int = 0):
    """Arm a deterministic fault schedule for the enclosed block.

    Yields the :class:`FaultPlan` so tests can assert exactly which
    injections fired (``plan.fired``) and how many score lanes were
    corrupted (``plan.corrupted``).  Plans do not nest.
    """
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("inject_faults does not nest")
    plan = FaultPlan(schedule, seed=seed)
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = None


def corrupt_scores(v: np.ndarray, eligible: np.ndarray) -> np.ndarray:
    """Apply the ``scores`` corruption site: NaN seeded eligible lanes.

    ``eligible`` marks lanes that would actually rank (live candidate,
    join size past the predicate).  The lanes are drawn from
    ``np.random.default_rng(seed)`` over the eligible finite lanes, as
    in the reference, so equal eligible arrays corrupt the same lanes.
    Returns ``v`` untouched unless a plan with a ``scores`` entry is
    armed.
    """
    plan = _ACTIVE
    if plan is None:
        return v
    n = plan.scores_lanes()
    if n <= 0:
        return v
    idx = np.flatnonzero(np.asarray(eligible) & np.isfinite(v))
    if idx.size == 0:
        return v
    pick = plan.rng.choice(idx, size=min(n, idx.size), replace=False)
    out = np.array(v, copy=True)
    out[pick] = np.nan
    plan.corrupted += int(pick.size)
    return out


# ---------------------------------------------------------------------------
# Per-query outcomes + admission validation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QueryOutcome:
    """Structured per-query serving outcome (one per submitted query).

    ``status`` is ``"ok"`` (result delivered), ``"quarantined"``
    (rejected at admission validation — ``error`` carries the code,
    ``detail`` the reason), or ``"failed"`` (the bucket exhausted the
    executor ladder; the paired result is None).  ``rung`` names the
    executor that delivered the result (``distributed`` / ``batched`` /
    ``reference``);
    ``retries`` / ``fallbacks`` count what recovery cost this query's
    bucket; ``nonfinite_lanes`` counts score lanes the numeric fence
    recomputed for this query.
    """

    query: int
    status: str
    rung: str | None = None
    error: str | None = None
    detail: str | None = None
    retries: int = 0
    fallbacks: int = 0
    nonfinite_lanes: int = 0

    @property
    def ok(self) -> bool:
        return self.status == "ok"


def validate_query(sk, index) -> tuple[str, str] | None:
    """Admission validation of one train sketch against an index.

    Returns None for a servable sketch, else ``(code, detail)`` with a
    stable error code: ``invalid_sketch`` (not sketch-shaped),
    ``unknown_dtype`` (non-numeric values / non-bool dtype flag),
    ``capacity_mismatch`` (capacity or ``n`` differs from the index),
    ``empty_sketch`` (no live rows), ``nonfinite_values`` (NaN/inf in
    live continuous values).  Host-side numpy over one sketch.
    """
    try:
        cap = int(sk.capacity)
        mask = np.asarray(sk.mask, dtype=bool)
        values = np.asarray(sk.values)
        keys = np.asarray(sk.key_hashes)
        disc = sk.value_is_discrete
        n = int(sk.n)
    except Exception as e:  # noqa: BLE001 — anything non-sketch-shaped
        return ("invalid_sketch", f"not a servable sketch: {e!r}")
    if not isinstance(disc, (bool, np.bool_)):
        return (
            "unknown_dtype",
            f"value_is_discrete must be bool, got {type(disc).__name__}",
        )
    if not np.issubdtype(values.dtype, np.number):
        return ("unknown_dtype", f"unsupported value dtype {values.dtype}")
    if keys.shape != values.shape or keys.shape != mask.shape:
        return (
            "invalid_sketch",
            f"ragged sketch arrays: keys {keys.shape}, values "
            f"{values.shape}, mask {mask.shape}",
        )
    if index._cap_cols is not None and cap != index._cap_cols:
        return (
            "capacity_mismatch",
            f"sketch capacity {cap} != index capacity {index._cap_cols}",
        )
    if n != index.n:
        return ("capacity_mismatch", f"sketch n={n} != index n={index.n}")
    if not mask.any():
        return ("empty_sketch", "no live rows (empty or all-masked sketch)")
    live = values[mask]
    if not disc and not np.all(np.isfinite(live.astype(np.float64))):
        return (
            "nonfinite_values",
            f"{int((~np.isfinite(live.astype(np.float64))).sum())} "
            "non-finite live values",
        )
    return None


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for same-rung bucket re-attempts.

    ``max_retries`` re-attempts per rung after the rung's first failed
    attempt, sleeping ``base_delay * 2**i`` (capped at ``max_delay``)
    before each.  ``sleep`` is injectable so tests run at full speed.
    """

    max_retries: int = 2
    base_delay: float = 0.01
    max_delay: float = 0.25
    sleep: object = time.sleep

    def delays(self) -> list[float]:
        return [
            min(self.base_delay * (2 ** i), self.max_delay)
            for i in range(self.max_retries)
        ]


# ---------------------------------------------------------------------------
# Numeric fences: demote non-finite score lanes to the reference path
# ---------------------------------------------------------------------------


def reference_score_pairs(index, sk, cand_ids, k: int) -> np.ndarray:
    """Reference MI for explicit (query, candidate) pairs.

    Scores the pairs through the materialized estimators straight from
    the index's host rows — no executor, no fused kernel, no fault site.
    Where the reference scores pair by pair, the port stacks all the
    pairs of one estimator into one join and one materialized estimator
    call (the query's fenced lanes span at most the index's estimator
    groups).  The materialized statistics equal the fused ones, so a
    lane whose fused value was corrupted, not genuinely non-finite,
    comes back with its clean score (bit for bit on the CPU).
    """
    from repro_torch.core.discovery import executors as _ex
    from repro_torch.core.join import sketch_join_presorted

    cand_ids = np.asarray(cand_ids, dtype=np.int64)
    out = np.empty(len(cand_ids), np.float32)
    if cand_ids.size == 0:
        return out
    train = index.train_arrays(sk)  # (1, n) per field
    y_disc = bool(sk.value_is_discrete)
    eids = np.array([estimator_id(index._discrete[int(ci)], y_disc)
                     for ci in cand_ids])
    for eid in np.unique(eids):
        sel = np.flatnonzero(eids == eid)
        rows = [index._host_row(int(cand_ids[j])) for j in sel]
        cand = {
            f: torch.from_numpy(np.stack([r[f] for r in rows])).to(index.device)
            for f in ("keys", "vals_f", "vals_u", "mask")
        }
        (xf, xu), (y_f, y_u), mask = sketch_join_presorted(
            train["keys"], train["mask"], cand["keys"], cand["mask"],
            (cand["vals_f"], cand["vals_u"]),
            (train["vals_f"], train["vals_u"]), keys_effective=True,
        )
        mi = _ex._estimate(int(eid), xf, xu, y_f, y_u, mask, k,
                           impl="materialized")
        out[sel] = mi.cpu().numpy()
    return out


def fence_nonfinite(
    v, gi, js, index, sk, min_join: int, k: int
) -> tuple[np.ndarray, int]:
    """Detect and repair non-finite MI lanes in one query's triples.

    A lane is fenced only if it would actually rank — live candidate
    (``gi`` below the sentinel) passing ``min_join``.  Fenced lanes are
    recomputed via :func:`reference_score_pairs` and substituted in
    place.  Returns ``(v_fixed, n_demoted)``.
    """
    v = np.asarray(v, dtype=np.float32)
    gi = np.asarray(gi)
    js = np.asarray(js)
    bad = ~np.isfinite(v) & (gi < len(index)) & (js >= min_join)
    n = int(bad.sum())
    if n == 0:
        return v, 0
    idx = np.flatnonzero(bad)
    out = np.array(v, copy=True)
    out[idx] = reference_score_pairs(index, sk, gi[idx], k)
    return out, n

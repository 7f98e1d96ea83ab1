"""Featurization (AGG) functions for many-to-many join keys.

Section III-B of the paper: a candidate table with repeated join keys is
mapped to the augmentation table ``T_aug[K_X, X]`` by grouping on the key
and applying an aggregation function.  The aggregation runs at sketch
*construction* time directly over ``T_cand`` — the aggregate table is
never materialized in full (only for the ``n`` keys surviving sampling
would be strictly necessary; we aggregate all groups in one vectorized
pass, which is the cheaper-constant choice at these sizes).

All implementations are sort-based segment reductions: O(N log N), one
pass, no python-level loops.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["aggregate_by_key", "AGG_FUNCTIONS", "output_is_discrete"]


def _segments(sorted_keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Segment boundaries of equal-key runs in a sorted key array."""
    n = len(sorted_keys)
    new_run = np.empty(n, dtype=bool)
    new_run[0] = True
    new_run[1:] = sorted_keys[1:] != sorted_keys[:-1]
    starts = np.flatnonzero(new_run)
    ends = np.r_[starts[1:], n]
    return starts, ends


def _agg_avg(v: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    csum = np.r_[0.0, np.cumsum(v.astype(np.float64))]
    return ((csum[ends] - csum[starts]) / (ends - starts)).astype(np.float32)


def _agg_sum(v: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    csum = np.r_[0.0, np.cumsum(v.astype(np.float64))]
    return (csum[ends] - csum[starts]).astype(np.float32)


def _agg_count(v: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    return (ends - starts).astype(np.float32)


def _agg_min(v: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    return np.minimum.reduceat(v, starts)


def _agg_max(v: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    return np.maximum.reduceat(v, starts)


def _agg_first(v: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    return v[starts]


def _agg_mode(v: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Most frequent value within each key group (ties -> smallest value).

    Within each key segment, sorting values groups equal values into
    runs; the longest run wins.  Implemented with one global lexsort.
    """
    seg_id = np.zeros(len(v), dtype=np.int64)
    seg_id[starts[1:]] = 1
    seg_id = np.cumsum(seg_id)
    order = np.lexsort((v, seg_id))
    sv, sseg = v[order], seg_id[order]
    n = len(v)
    new_val = np.empty(n, dtype=bool)
    new_val[0] = True
    new_val[1:] = (sv[1:] != sv[:-1]) | (sseg[1:] != sseg[:-1])
    vstarts = np.flatnonzero(new_val)
    vends = np.r_[vstarts[1:], n]
    run_len = vends - vstarts
    run_seg = sseg[vstarts]
    run_val = sv[vstarts]
    # For each segment pick the run with max length (first on ties ->
    # smallest value because runs are value-sorted within a segment).
    out = np.empty(len(starts), dtype=v.dtype)
    # run_seg is sorted; reduceat-style argmax per segment:
    seg_starts_in_runs = np.searchsorted(run_seg, np.arange(len(starts)))
    seg_ends_in_runs = np.r_[seg_starts_in_runs[1:], len(run_seg)]
    for s in range(len(starts)):  # bounded by #distinct keys, not rows
        a, b = seg_starts_in_runs[s], seg_ends_in_runs[s]
        out[s] = run_val[a + np.argmax(run_len[a:b])]
    return out


AGG_FUNCTIONS: dict[str, Callable[[np.ndarray, np.ndarray, np.ndarray], np.ndarray]] = {
    "avg": _agg_avg,
    "sum": _agg_sum,
    "count": _agg_count,
    "min": _agg_min,
    "max": _agg_max,
    "first": _agg_first,
    "mode": _agg_mode,
}


def output_is_discrete(agg: str, input_is_discrete: bool) -> bool:
    """Data type of AGG output (paper Section III-B): COUNT is always
    discrete-integer but treated as ordered-numeric; MODE/FIRST preserve
    the input type; numeric reductions output continuous."""
    if agg in ("mode", "first"):
        return input_is_discrete
    return False


def aggregate_by_key(
    keys: np.ndarray, values: np.ndarray, agg: str
) -> tuple[np.ndarray, np.ndarray]:
    """Group ``values`` by ``keys`` and reduce with ``agg``.

    Returns (unique_keys, aggregated_values), unique_keys sorted.
    """
    if agg not in AGG_FUNCTIONS:
        raise ValueError(f"unknown AGG {agg!r}; choose from {sorted(AGG_FUNCTIONS)}")
    keys = np.asarray(keys)
    values = np.asarray(values)
    if keys.shape != values.shape:
        raise ValueError("keys/values length mismatch")
    if len(keys) == 0:
        return keys, values
    order = np.argsort(keys, kind="stable")
    sk, sv = keys[order], values[order]
    starts, ends = _segments(sk)
    if agg in ("avg", "sum") and not np.issubdtype(values.dtype, np.number):
        raise TypeError(f"AGG {agg!r} requires numeric values")
    return sk[starts], AGG_FUNCTIONS[agg](sv, starts, ends)

"""Sampling-based sketches for MI estimation over joins (paper Section IV).

Five sketching strategies are implemented; all produce a fixed-capacity
set of ``<h(k), value>`` tuples:

  * ``TUPSK``  — the paper's contribution.  Rows are identified by the
    derived tuple-key <k, j> (j = occurrence index of key k), hashed, and
    the n minimum hash values are kept.  Every row has uniform inclusion
    probability 1/N regardless of the join-key frequency distribution,
    so the recovered sketch join is a uniform sample of the full left
    join.  Capacity is exactly n.
  * ``LV2SK``  — two-level baseline: level 1 selects the n distinct keys
    with minimum h_u(k); level 2 caps the rows kept per key at
    n_k = max(1, floor(n * N_k / N)).  Capacity is bounded by 2n.
    Inclusion probability depends on the key-frequency distribution
    (non-identically-distributed samples -> extra estimator bias).
  * ``PRISK``  — LV2SK with frequency-weighted priority sampling at
    level 1 (priority N_k / u_k) instead of uniform min-hash.
  * ``INDSK``  — independent per-table Bernoulli-style sampling (n rows
    with minimum *table-seeded* row hashes).  No coordination: expected
    join size is quadratically smaller.
  * ``CSK``    — Correlation Sketches [Santos et al. 2021] extended to
    MI: n minimum distinct keys, first value seen per key (repeated keys
    are not handled).

Sketching is an ingestion-time, single-pass, vectorized-numpy operation
(the streaming reservoir formulation in the paper is sequential; on a
columnar in-memory table the sort-based formulation below is the
vectorized equivalent with identical output).  Join + estimation run in
PyTorch on the card (see ``repro_torch.core.join`` /
``repro_torch.core.estimators``), batched over thousands of candidate
sketches per launch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import hashing
from repro_torch.core.aggregate import aggregate_by_key, output_is_discrete

__all__ = ["Sketch", "build_sketch", "SKETCH_METHODS"]

SKETCH_METHODS = ("tupsk", "lv2sk", "prisk", "indsk", "csk")

_INDSK_SEED = 0x5EEDF00D


@dataclass
class Sketch:
    """Fixed-capacity sketch of one (key column, value column) pair.

    Arrays are padded to ``capacity``; ``mask`` flags the valid prefix.
    ``value_is_discrete`` drives MI-estimator dispatch downstream.

    Candidate-side sketches (``side == 'cand'``) additionally guarantee
    the sorted-at-ingest invariant: valid ``key_hashes`` are unique and
    ascending, padding trails them — the contract the presorted
    discovery join depends on.
    """

    method: str
    n: int
    side: str  # 'train' (sample rows, keep repeats) | 'cand' (aggregate)
    key_hashes: np.ndarray  # uint32 (capacity,)
    values: np.ndarray  # float32 or int64 codes (capacity,)
    mask: np.ndarray  # bool (capacity,)
    value_is_discrete: bool
    source_rows: int  # N of the source table
    source_distinct_keys: int  # m_K of the source table

    @property
    def capacity(self) -> int:
        return len(self.key_hashes)

    @property
    def size(self) -> int:
        return int(self.mask.sum())

    def value_views(self) -> tuple[np.ndarray, np.ndarray]:
        """The (float32, int64) views of ``values`` the scorers consume.

        Discrete values travel as exact uint32 codes plus a float32 cast
        (for estimators that rank them); continuous values as float32
        plus their bit-pattern reinterpretation — one pair of arrays per
        sketch, shared by the train and candidate ingest paths.

        The second view holds the reference's uint32 view *zero-extended
        to int64*: torch has no uint32 comparison, shift or
        ``searchsorted`` on the CPU, and int64 keeps the unsigned order
        (every value lies in [0, 2**32)).
        """
        if self.value_is_discrete:
            vu = self.values.astype(np.int64) & 0xFFFFFFFF
            vf = self.values.astype(np.float32)
        else:
            vf = self.values.astype(np.float32)
            vu = vf.view(np.uint32).astype(np.int64)
        return vf, vu

    def _pad_to(self, capacity: int) -> "Sketch":
        pad = capacity - len(self.key_hashes)
        if pad < 0:
            raise ValueError("cannot shrink sketch")
        return Sketch(
            self.method,
            self.n,
            self.side,
            np.pad(self.key_hashes, (0, pad)),
            np.pad(self.values, (0, pad)),
            np.pad(self.mask, (0, pad)),
            self.value_is_discrete,
            self.source_rows,
            self.source_distinct_keys,
        )


def _take(keys: np.ndarray, values: np.ndarray, idx: np.ndarray, capacity: int,
          method: str, n: int, side: str, discrete: bool, rows: int, mk: int) -> Sketch:
    """Assemble a padded sketch from selected row indices."""
    size = len(idx)
    if size > capacity:
        raise AssertionError(f"{method}: size {size} exceeds capacity {capacity}")
    kh = np.zeros(capacity, dtype=np.uint32)
    vdtype = np.int64 if discrete else np.float32
    vals = np.zeros(capacity, dtype=vdtype)
    mask = np.zeros(capacity, dtype=bool)
    kh[:size] = keys[idx]
    vals[:size] = values[idx].astype(vdtype)
    mask[:size] = True
    return Sketch(method, n, side, kh, vals, mask, discrete, rows, mk)


def _distinct_key_stats(key_hashes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    uniq, counts = np.unique(key_hashes, return_counts=True)
    return uniq, counts


def _minhash_select(ranks: np.ndarray, n: int) -> np.ndarray:
    """Indices of the n minimum rank values (all if fewer)."""
    if len(ranks) <= n:
        return np.arange(len(ranks))
    idx = np.argpartition(ranks, n)[:n]
    return idx


# ---------------------------------------------------------------------------
# Train-side builders: sample rows, preserving key repetition.
# ---------------------------------------------------------------------------

def _tupsk_train(key_hashes, values, n):
    j = hashing.occurrence_index(key_hashes)
    tuple_h = hashing.murmur3_32_np(j.astype(np.uint32), seed=key_hashes)
    ranks = hashing.fibonacci32_np(tuple_h)
    return _minhash_select(ranks, n)


def _row_rank_within_key(key_hashes):
    """Per-row pseudo-random rank used for level-2 subsampling (LV2SK):
    deterministic stand-in for the paper's reservoir—rows of a key are
    kept in order of their tuple-hash."""
    j = hashing.occurrence_index(key_hashes)
    return hashing.fibonacci32_np(
        hashing.murmur3_32_np(j.astype(np.uint32), seed=key_hashes)
    )


def _two_level_train(key_hashes, values, n, *, priority: bool):
    N = len(key_hashes)
    uniq, counts = _distinct_key_stats(key_hashes)
    key_rank_u32 = hashing.fibonacci32_np(uniq)
    if priority:
        # Priority sampling: keep n largest N_k / u_k  <=>  n smallest u_k / N_k.
        u = key_rank_u32.astype(np.float64) + 1.0  # avoid div-by-zero ties
        sel = _minhash_select(u / counts, n)
    else:
        sel = _minhash_select(key_rank_u32, n)
    chosen = uniq[sel]
    n_k = np.maximum(1, (n * counts[sel]) // N)

    # Keep the n_k lowest-row-rank rows for each chosen key.
    row_rank = _row_rank_within_key(key_hashes)
    order = np.lexsort((row_rank, key_hashes))
    sk = key_hashes[order]
    # Position of each row within its key group (rows are rank-sorted).
    pos_in_group = np.arange(N) - np.searchsorted(sk, sk, side="left")
    # Vectorized membership + per-row cap lookup (chosen is searchsorted-able
    # after sorting alongside its caps).
    csort = np.argsort(chosen)
    chosen_s, nk_s = chosen[csort], n_k[csort]
    pos = np.clip(np.searchsorted(chosen_s, sk), 0, max(len(chosen_s) - 1, 0))
    member = chosen_s[pos] == sk
    lim = np.where(member, nk_s[pos], 0)
    keep_idx = np.flatnonzero(member & (pos_in_group < lim))
    return order[keep_idx]


def _indsk_train(key_hashes, values, n, table_seed):
    N = len(key_hashes)
    row_ids = np.arange(N, dtype=np.uint32)
    ranks = hashing.fibonacci32_np(
        hashing.murmur3_32_np(row_ids, seed=np.uint32(table_seed))
    )
    return _minhash_select(ranks, n)


def _csk_train(key_hashes, values, n):
    # First value seen per distinct key, n min-hash distinct keys.
    first_idx = np.zeros(0, dtype=np.int64)
    order = np.argsort(key_hashes, kind="stable")
    sk = key_hashes[order]
    new_run = np.empty(len(sk), dtype=bool)
    new_run[0] = True
    new_run[1:] = sk[1:] != sk[:-1]
    first_idx = order[np.flatnonzero(new_run)]
    ranks = hashing.fibonacci32_np(key_hashes[first_idx])
    sel = _minhash_select(ranks, n)
    return first_idx[sel]


# ---------------------------------------------------------------------------
# Candidate-side builder: aggregate repeats, then coordinate on keys.
# ---------------------------------------------------------------------------

def _cand_select(method, uniq_keys, n, table_seed):
    if method == "tupsk":
        # Coordinate with train-side j == 1 tuples: h_u(<k, 1>).
        ranks = hashing.fibonacci32_np(
            hashing.murmur3_32_np(np.ones_like(uniq_keys), seed=uniq_keys)
        )
    elif method in ("lv2sk", "prisk", "csk"):
        ranks = hashing.fibonacci32_np(uniq_keys)
    elif method == "indsk":
        ranks = hashing.fibonacci32_np(
            hashing.murmur3_32_np(uniq_keys, seed=np.uint32(table_seed))
        )
    else:
        raise ValueError(method)
    return _minhash_select(ranks, n)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def build_sketch(
    key_hashes: np.ndarray,
    values: np.ndarray,
    *,
    n: int,
    method: str = "tupsk",
    side: str = "train",
    agg: str = "first",
    value_is_discrete: bool | None = None,
    table_seed: int = _INDSK_SEED,
) -> Sketch:
    """Build a sketch of one (key, value) column pair.

    ``side='train'`` samples rows (repeated keys preserved — the left
    table of the augmentation join).  ``side='cand'`` first featurizes
    with ``agg`` (GROUP BY key) and then samples the resulting unique
    keys, coordinating hashes with the train side.
    """
    if method not in SKETCH_METHODS:
        raise ValueError(f"unknown sketch method {method!r}")
    key_hashes = np.asarray(key_hashes, dtype=np.uint32)
    values = np.asarray(values)
    if value_is_discrete is None:
        value_is_discrete = not np.issubdtype(values.dtype, np.number)
    N = len(key_hashes)
    mk = len(np.unique(key_hashes)) if N else 0
    capacity = 2 * n if method in ("lv2sk", "prisk") else n

    if side == "cand":
        uniq, agg_vals = aggregate_by_key(key_hashes, values, agg)
        discrete_out = output_is_discrete(agg, value_is_discrete)
        sel = _cand_select(method, uniq, n, table_seed)
        # Sorted-at-ingest invariant: candidate keys are emitted in
        # ascending order (uniq is sorted, so sorting the selection
        # indices sorts the keys), valid prefix first, padding last.
        # The discovery hot path (``sketch_join_presorted``) does one
        # searchsorted against this static order instead of re-sorting
        # every candidate on every query.
        sel = np.sort(sel)
        # Candidate sketches always have unique keys -> capacity n suffices,
        # but keep LV2SK/PRISK at 2n so stacked batched sketches align.
        return _take(uniq, agg_vals, sel, capacity, method, n, "cand",
                     discrete_out, N, mk)

    if side != "train":
        raise ValueError(f"side must be 'train' or 'cand', got {side!r}")

    if method == "tupsk":
        idx = _tupsk_train(key_hashes, values, n)
    elif method == "lv2sk":
        idx = _two_level_train(key_hashes, values, n, priority=False)
    elif method == "prisk":
        idx = _two_level_train(key_hashes, values, n, priority=True)
    elif method == "indsk":
        idx = _indsk_train(key_hashes, values, n, table_seed)
    else:  # csk
        idx = _csk_train(key_hashes, values, n)
    return _take(key_hashes, values, idx, capacity, method, n, "train",
                 value_is_discrete, N, mk)

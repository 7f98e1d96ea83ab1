"""Plain TUPSK sketches and the sketch join, rebuilt from raw tables.

The benchmark's yardstick for what the program's ingest and join must
produce (arXiv:2403.15553 Section IV), in plain PyTorch:

* a train sketch keeps the ``n`` rows of the query table whose tuple-key
  ``<k, j>`` (j: the occurrence index of key k, 1-based, in row order)
  has the smallest Fibonacci hash of ``murmur3(j, seed=k)``; repeated
  keys are kept;
* a candidate sketch first groups its table by key, keeping the first
  value of each key in row order (AGG ``first``), then keeps the ``n``
  distinct keys with the smallest hash of ``murmur3(1, seed=k)``, so
  that it coordinates with the train side's ``j = 1`` tuples;
* the join matches each train row's key against the candidate sketch's
  keys: the matched rows are the joined sample (x = candidate value,
  y = train value), their count the join size.

Candidate sketches of a whole lake are built at once, one row a table.
Keys are int64 tensors holding uint32 hashes; ``FENCE`` pads sketches
and sorts after every key.
"""

from __future__ import annotations

import torch

from portbench.reference.murmur3 import fibonacci32, murmur3_32

FENCE = 1 << 32
_NOT_SAMPLED = 1 << 33  # rank of a repeated key: never among the n smallest


def _runs(sorted_keys: torch.Tensor) -> torch.Tensor:
    """True where a run of equal keys starts, along the last axis."""
    new = torch.ones_like(sorted_keys, dtype=torch.bool)
    new[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    return new


def occurrence_index(keys: torch.Tensor) -> torch.Tensor:
    """1-based occurrence index of each key along the last axis, in row
    order."""
    order = torch.sort(keys, dim=-1, stable=True).indices
    new = _runs(keys.gather(-1, order))
    pos = torch.arange(keys.shape[-1], device=keys.device).expand_as(keys)
    start = torch.where(new, pos, torch.zeros_like(pos)).cummax(-1).values
    return torch.empty_like(pos).scatter_(-1, order, pos - start + 1)


def train_sketch(keys: torch.Tensor, values: torch.Tensor, n: int):
    """(keys, values) of the train sketch of one query table (R,)."""
    j = occurrence_index(keys)
    rank = fibonacci32(murmur3_32(j, seed=keys))
    if keys.numel() <= n:
        return keys, values
    idx = torch.topk(rank, n, largest=False).indices
    return keys[idx], values[idx]


def cand_sketches(keys: torch.Tensor, values: torch.Tensor, n: int):
    """Candidate sketches of C tables (C, R): keys (C, n) ascending with
    ``FENCE`` after the valid ones, and the values beside them."""
    order = torch.sort(keys, dim=-1, stable=True).indices
    sk, sv = keys.gather(-1, order), values.gather(-1, order)
    rank = fibonacci32(murmur3_32(torch.ones_like(sk), seed=sk))
    rank = torch.where(_runs(sk), rank, torch.full_like(rank, _NOT_SAMPLED))
    m = min(n, keys.shape[-1])
    top = torch.topk(rank, m, dim=-1, largest=False)
    ck = torch.where(top.values < FENCE, sk.gather(-1, top.indices),
                     torch.full_like(top.indices, FENCE))
    cv = sv.gather(-1, top.indices)
    ck, perm = torch.sort(ck, dim=-1)
    cv = cv.gather(-1, perm)
    if m < n:
        ck = torch.cat([ck, torch.full((ck.shape[0], n - m), FENCE,
                                       dtype=ck.dtype, device=ck.device)], 1)
        cv = torch.cat([cv, torch.zeros((cv.shape[0], n - m), dtype=cv.dtype,
                                        device=cv.device)], 1)
    return ck, cv


def join(train_keys: torch.Tensor, cand_keys: torch.Tensor,
         cand_values: torch.Tensor):
    """Join one train sketch (m,) with C candidate sketches (C, n).
    Returns (x (C, m) candidate values, matched (C, m), join sizes (C,))."""
    C, n = cand_keys.shape
    probes = train_keys.expand(C, -1).contiguous()
    pos = torch.searchsorted(cand_keys, probes).clamp_(max=n - 1)
    matched = cand_keys.gather(-1, pos) == probes
    return cand_values.gather(-1, pos), matched, matched.sum(-1)

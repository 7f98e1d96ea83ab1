"""Sketch joins and the full-join reference (PyTorch port).

The sketch join recovers a sample of the left-outer join
``T_train ⋈ T_aug`` by matching hashed keys between a train-side sketch
(values = target Y, repeated keys preserved) and a candidate-side sketch
(values = feature X, keys unique after aggregation).

  * :func:`sketch_join` — host numpy, used by tests and benchmarks.
  * :func:`sketch_join_lexsort` — the ad-hoc scorers' join, batched over
    leading dimensions: it sorts the candidate keys on every call, so it
    takes candidate rows in ANY key order.
  * :func:`sketch_join_presorted` — the discovery hot path, batched over
    leading dimensions.  It relies on the sorted-at-ingest invariant
    (``build_sketch(side="cand")`` emits valid keys ascending, padding
    last): one ``searchsorted`` against the candidate keys, then every
    value view is gathered from the same positions.
  * :func:`signature_join_size` — the phase-0 gate's estimate, batched:
    (Q, n) train rows against (R, w + 1) signature rows.
  * :func:`full_left_join` — the materialized ground truth.

Keys are carried as **int64 holding the uint32 hash, zero-extended**:
torch has no uint32 ``searchsorted``, comparison or shift on the CPU.
The reference's ``0xFFFFFFFF`` fence becomes the int64 4294967295, the
largest value any key can take, so the sort order of every key row is
unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.aggregate import aggregate_by_key, output_is_discrete
from repro_torch.core.sketch import Sketch

__all__ = [
    "KEY_MAX",
    "JoinSample",
    "effective_keys",
    "sketch_join",
    "sketch_join_lexsort",
    "sketch_join_presorted",
    "presorted_join_size",
    "signature_join_size",
    "full_left_join",
]

KEY_MAX = 0xFFFFFFFF


def effective_keys(keys: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Remap masked-out key slots to 0xFFFFFFFF (the presorted-join fence).

    Returns int64.  Idempotent, so packing paths may apply it
    unconditionally; the device store applies it once at ingest.
    """
    return torch.where(
        mask, keys.to(torch.int64), torch.full((), KEY_MAX, dtype=torch.int64,
                                               device=keys.device)
    )


@dataclass
class JoinSample:
    """Padded sample of the join: pairs (x=feature, y=target)."""

    x: np.ndarray
    y: np.ndarray
    mask: np.ndarray
    x_is_discrete: bool
    y_is_discrete: bool

    @property
    def size(self) -> int:
        return int(np.asarray(self.mask).sum())


def sketch_join(train: Sketch, cand: Sketch) -> JoinSample:
    """Join two sketches on their hashed keys (host-side)."""
    if cand.side != "cand":
        raise ValueError("right operand must be a candidate-side sketch")
    tk, tv, tm = train.key_hashes, train.values, train.mask
    ck, cv, cm = cand.key_hashes, cand.values, cand.mask

    cvalid = np.flatnonzero(cm)
    order = np.argsort(ck[cvalid], kind="stable")
    ck_sorted = ck[cvalid][order]
    cv_sorted = cv[cvalid][order]

    pos = np.searchsorted(ck_sorted, tk)
    pos_c = np.clip(pos, 0, max(len(ck_sorted) - 1, 0))
    matched = tm & (len(ck_sorted) > 0)
    if len(ck_sorted):
        matched &= ck_sorted[pos_c] == tk
    x = np.zeros(train.capacity, dtype=cv.dtype)
    if len(ck_sorted):
        x[matched] = cv_sorted[pos_c[matched]]
    y = np.where(tm, tv, 0)
    return JoinSample(x, y, matched, cand.value_is_discrete, train.value_is_discrete)


def _lead(a: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """``a`` broadcast over the leading dims ``shape`` (last dim kept)."""
    return a.expand(*shape, a.shape[-1])


def sketch_join_lexsort(
    train_keys: torch.Tensor,
    train_values: torch.Tensor,
    train_mask: torch.Tensor,
    cand_keys: torch.Tensor,
    cand_values: torch.Tensor,
    cand_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Join that sorts the candidate keys first; any key order.

    Shapes are ``(..., n_train)`` and ``(..., n_cand)`` with broadcasting
    leading dims, as in :func:`sketch_join_presorted`.  Each candidate
    row is sorted by (key, invalid-last) — one stable sort of
    ``2 * key + invalid`` (keys are below 2^32, so the int64 holds it) —
    so that for a key present both as padding and as a valid entry,
    ``searchsorted``'s left position lands on the valid one; the
    gathered mask then rejects matches that landed on padding.  Between
    equal valid keys the first in row order wins, as in the reference's
    stable ``lexsort``.

    Returns (x, y, matched) of the broadcast shape ``(..., n_train)``:
    the gathered candidate value (0 where unmatched), the train value (0
    where masked) and the match mask.
    """
    lead = torch.broadcast_shapes(train_keys.shape[:-1], cand_keys.shape[:-1])
    tk = _lead(train_keys.to(torch.int64), lead).contiguous()
    tm = _lead(train_mask, lead)
    ck = cand_keys.to(torch.int64)
    order = torch.sort(ck * 2 + (~cand_mask).to(torch.int64), dim=-1,
                       stable=True).indices
    ck_sorted = _lead(ck.gather(-1, order), lead).contiguous()
    cv_sorted = _lead(cand_values.gather(-1, order), lead)
    cm_sorted = _lead(cand_mask.gather(-1, order), lead)
    pos = torch.searchsorted(ck_sorted, tk)
    pos_c = pos.clamp_(0, ck_sorted.shape[-1] - 1)
    matched = tm & (ck_sorted.gather(-1, pos_c) == tk) \
        & cm_sorted.gather(-1, pos_c)
    zero = torch.zeros((), dtype=cand_values.dtype, device=cand_values.device)
    x = torch.where(matched, cv_sorted.gather(-1, pos_c), zero)
    y = torch.where(tm, _lead(train_values, lead),
                    torch.zeros((), dtype=train_values.dtype,
                                device=train_values.device))
    return x, y, matched


def sketch_join_presorted(
    train_keys: torch.Tensor,
    train_mask: torch.Tensor,
    cand_keys: torch.Tensor,
    cand_mask: torch.Tensor,
    cand_values: tuple[torch.Tensor, ...],
    train_values: tuple[torch.Tensor, ...],
    keys_effective: bool = False,
) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...], torch.Tensor]:
    """Single-searchsorted join for key-sorted candidate sketches.

    Shapes are ``(..., n_train)`` for the train operands and
    ``(..., n_cand)`` for the candidate operands; the leading dims
    broadcast against each other, so (Q, 1, n) trains against (1, G, n)
    candidates join every query with every candidate.

    Invariant (established by ``build_sketch(side="cand")`` and checked
    by ``SketchIndex.add``): valid candidate keys are unique and
    ascending, padding trails them.  Masked-out keys are remapped to
    0xFFFFFFFF, which keeps each row nondecreasing with the valid prefix
    first, so ``searchsorted``'s left position for any probe lands on the
    valid entry when one exists; the gathered mask rejects probes that
    landed on padding (including a probe key that IS 0xFFFFFFFF).

    Returns (gathered candidate views, masked train views, match mask),
    all of the broadcast shape ``(..., n_train)``.
    """
    lead = torch.broadcast_shapes(train_keys.shape[:-1], cand_keys.shape[:-1])
    tk = _lead(train_keys.to(torch.int64), lead)
    tm = _lead(train_mask, lead)
    ck = cand_keys if keys_effective else effective_keys(cand_keys, cand_mask)
    ck = _lead(ck.to(torch.int64), lead).contiguous()
    cm = _lead(cand_mask, lead)
    n_c = ck.shape[-1]
    pos = torch.searchsorted(ck, tk.contiguous())
    pos_c = pos.clamp_(0, n_c - 1)
    matched = tm & (ck.gather(-1, pos_c) == tk) & cm.gather(-1, pos_c)
    xs = tuple(
        torch.where(matched, _lead(v, lead).gather(-1, pos_c),
                    torch.zeros((), dtype=v.dtype, device=v.device))
        for v in cand_values
    )
    ys = tuple(
        torch.where(tm, _lead(v, lead),
                    torch.zeros((), dtype=v.dtype, device=v.device))
        for v in train_values
    )
    return xs, ys, matched


def presorted_join_size(
    train_keys: torch.Tensor,
    train_mask: torch.Tensor,
    cand_keys: torch.Tensor,
    cand_mask: torch.Tensor,
    keys_effective: bool = True,
) -> torch.Tensor:
    """Join sizes (int32, broadcast leading shape) of presorted
    candidates against train sketches: the ``matched.sum()`` the scorers
    report, without value gathers or estimator work."""
    _, _, matched = sketch_join_presorted(
        train_keys, train_mask, cand_keys, cand_mask, (), (),
        keys_effective=keys_effective,
    )
    return matched.sum(-1, dtype=torch.int32)


def signature_join_size(
    train_keys: torch.Tensor,
    train_mask: torch.Tensor,
    sig: torch.Tensor,
) -> torch.Tensor:
    """(Q, R) float32 join-size estimates of R candidates from their
    bottom-``w`` key signatures, for each of Q train sketches.

    ``sig`` (R, w + 1) int32 holds each candidate's ``w`` smallest
    effective keys as uint32 bit patterns (dead columns -1, the
    0xFFFFFFFF fence) and then its live key count.  Sketch keys are
    uniform hashes, so the signature is an exchangeable ``w``-subset of
    the candidate's keys and

        ``est = matched_in_signature * cand_valid / sig_valid``

    estimates :func:`presorted_join_size`, exactly when the candidate
    holds at most ``w`` keys.  The signature keys probe the sorted,
    fenced train row (a left and a right ``searchsorted`` count each
    key's train-side multiplicity): 2·``w`` probes per candidate.  Each
    train row is sorted once for all R candidates.  A valid key equal to
    0xFFFFFFFF reads as the fence on both sides, a perturbation of at
    most one key of an estimate.
    """
    Q, n = train_keys.shape
    R, w = sig.shape[0], sig.shape[1] - 1
    # int32 bit patterns -> zero-extended uint32: keys >= 2^31 keep their
    # order and the -1 fence becomes KEY_MAX.
    sk = sig[:, :w].to(torch.int64) & KEY_MAX
    sig_mask = sk != KEY_MAX
    sig_valid = sig_mask.sum(1, dtype=torch.int32)
    cand_valid = sig[:, w].clamp_min(0)
    tk_sorted = torch.where(train_mask, train_keys.to(torch.int64),
                            KEY_MAX).sort(dim=1).values
    n_valid = train_mask.sum(1, dtype=torch.int64)
    probes = sk.reshape(1, R * w).expand(Q, R * w).contiguous()
    lo = torch.searchsorted(tk_sorted, probes)
    hi = torch.searchsorted(tk_sorted, probes, right=True)
    hi = torch.minimum(hi, n_valid[:, None])  # the fenced tail is masked rows
    hits = (hi - lo).clamp_min_(0).reshape(Q, R, w)
    raw = torch.where(sig_mask[None], hits, 0).sum(-1, dtype=torch.int32)
    scale = cand_valid.to(torch.float32) / sig_valid.clamp_min(1).to(torch.float32)
    return raw.to(torch.float32) * scale[None, :]


def full_left_join(
    train_keys: np.ndarray,
    train_values: np.ndarray,
    cand_keys: np.ndarray,
    cand_values: np.ndarray,
    agg: str = "first",
    cand_value_is_discrete: bool = False,
) -> JoinSample:
    """Reference: materialized LEFT JOIN (GROUP BY key, AGG) — the ground
    truth the sketches approximate.  Rows whose key is absent from the
    candidate table are dropped."""
    uk, uv = aggregate_by_key(np.asarray(cand_keys), np.asarray(cand_values), agg)
    pos = np.searchsorted(uk, train_keys)
    pos_c = np.clip(pos, 0, max(len(uk) - 1, 0))
    matched = np.zeros(len(train_keys), dtype=bool)
    if len(uk):
        matched = uk[pos_c] == np.asarray(train_keys)
    x = np.zeros(len(train_keys), dtype=uv.dtype)
    if len(uk):
        x[matched] = uv[pos_c[matched]]
    y_is_disc = not np.issubdtype(np.asarray(train_values).dtype, np.number)
    return JoinSample(
        x,
        np.asarray(train_values),
        matched,
        output_is_discrete(agg, not np.issubdtype(np.asarray(cand_values).dtype, np.number)),
        y_is_disc,
    )

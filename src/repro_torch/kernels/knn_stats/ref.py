"""Plain PyTorch kNN statistics: the CPU path and the kernels' oracle.

Computes what ``repro.kernels.knn_stats.ops`` computes, for a batch of
B padded samples at once:

  * :func:`radius_counts` — the fused radius+count of
    ``knn_radius_counts``, term for term like its single-tile body
    ``_knn_counts_fused_tile``;
  * :func:`knn_smallest` and :func:`ball_counts` — the two ops that
    ``knn_with_counts`` composes.

The (B, P, P) distance tensors are formed in chunks of samples so the
temporaries stay bounded: at B=65536 and P=256 one unchunked float32
(B, P, P) tensor is 17 GB.

Non-finite inputs: a NaN distance is never selected (it is treated as
+inf before the order statistic is taken) and fails every count
condition.  ``kernel.py``'s CUDA kernels do the same, so the two agree
on every input; agreement with the JAX reference is claimed for finite
inputs only.
"""

from __future__ import annotations

import torch

__all__ = ["ball_counts", "knn_smallest", "radius_counts"]

# Bound on chunk * P * P elements per temporary (64 MiB of float32).
_CHUNK_ELEMS = 1 << 24


def _over_chunks(fn, *arrays):
    """``fn`` over chunks of the leading (batch) axis of ``arrays``; at
    least one call, so an empty batch gives outputs of the right shape."""
    B, P = arrays[0].shape
    chunk = max(1, _CHUNK_ELEMS // max(P * P, 1))
    return [fn(*(a[b0:b0 + chunk] for a in arrays))
            for b0 in range(0, max(B, 1), chunk)]


def _absdiff(v):
    """|v_i - v_j| (c, P, P)."""
    return (v[:, :, None] - v[:, None, :]).abs_()


def _valid(m):
    """The valid j != i pairs (c, P, P)."""
    eye = torch.eye(m.shape[-1], dtype=torch.bool, device=m.device)
    return m[:, :, None] & m[:, None, :] & ~eye


def _smallest(x, dx, dy, valid, mode, T):
    """The T smallest selected distances per row, ascending with +inf
    beyond, and the same-class count (zeros in joint mode)."""
    c, P = x.shape
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=x.device)
    if mode == "joint":
        d = torch.maximum(dx, dy)  # NaN-propagating, as jnp.maximum
        d_sel = torch.where(valid & ~d.isnan(), d, inf)
        cnt = torch.zeros((c, P), dtype=torch.int32, device=x.device)
    else:  # class: neighbourhoods restricted to equal x codes
        sel = valid & (x[:, :, None] == x[:, None, :])
        d_sel = torch.where(sel & ~dy.isnan(), dy, inf)
        cnt = sel.sum(-1, dtype=torch.int32)
    if T > P:  # fewer columns than the buffer: the tail is +inf
        d_sel = torch.cat([d_sel, inf.expand(c, P, T - P)], dim=-1)
    knn = torch.topk(d_sel, T, dim=-1, largest=False, sorted=True).values
    return knn, cnt


def _counts(dx, dy, valid, r, which):
    """The five ball/tie counts (5, c, P) at the per-row radius r; only
    y_lt for which == "y" (dx may then be None)."""
    rr = r[..., None]
    y_lt = (valid & (dy < rr)).sum(-1, dtype=torch.int32)
    if which == "y":
        zero = torch.zeros_like(y_lt)
        return torch.stack([zero, y_lt, zero, zero, zero])
    return torch.stack([
        (valid & (dx < rr)).sum(-1, dtype=torch.int32),
        y_lt,
        (valid & (dx <= 0.0)).sum(-1, dtype=torch.int32),
        (valid & (dy <= 0.0)).sum(-1, dtype=torch.int32),
        (valid & (torch.maximum(dx, dy) <= 0.0)).sum(-1, dtype=torch.int32),
    ])


def _chunk_stats(x, y, m, *, k, kb, kk, mode, which):
    dx, dy, valid = _absdiff(x), _absdiff(y), _valid(m)
    knn, cnt = _smallest(x, dx, dy, valid, mode, k if mode == "joint" else kb)
    if mode == "joint":
        t = torch.full(x.shape, k - 1, dtype=torch.int64, device=x.device)
    else:
        n_x = cnt + m.to(torch.int32)  # includes self
        t = (torch.clamp(n_x - 1, max=kk) - 1).clamp_(0, kb - 1).to(torch.int64)
    r = knn.gather(-1, t[..., None])[..., 0]
    return r, cnt, _counts(dx, dy, valid, r, which)


def radius_counts(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    *,
    k: int,
    kb: int,
    kk: int,
    mode: str,
    which: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row radius, class count and ball/tie counts of B samples.

    ``x``, ``y`` float32 (B, P), ``mask`` bool (B, P).  The radius is the
    t-th smallest selected distance (0-based, duplicates counted; +inf
    when fewer than t+1 are selectable): t = k-1 in joint mode, the
    DC-KSG lane ``clip(min(kk, n_x-1)-1, 0, kb-1)`` in class mode.
    Returns (r float32 (B, P), cnt int32 (B, P), counts int32 (5, B, P))
    with counts ordered x_lt, y_lt, x_eq, y_eq, j_eq over valid j != i;
    only y_lt is computed for ``which="y"``.
    """
    parts = _over_chunks(
        lambda a, b, c: _chunk_stats(a, b, c, k=k, kb=kb, kk=kk, mode=mode,
                                     which=which), x, y, mask)
    rs, cnts, counts = zip(*parts)
    return torch.cat(rs), torch.cat(cnts), torch.cat(counts, dim=1)


def knn_smallest(
    x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, *, kb: int, mode: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kb smallest selected distances per row of B samples.

    Joint mode selects max(|dx|, |dy|) over valid j != i; class mode
    selects |dy| over valid j != i with x_j == x_i.  Returns (knn float32
    (B, P, kb), ascending, duplicates kept, +inf beyond the selectable
    ones; cnt int32 (B, P), the same-class count, zeros in joint mode).
    """
    def chunk(a, b, c):
        return _smallest(a, _absdiff(a), _absdiff(b), _valid(c), mode, kb)

    knns, cnts = zip(*_over_chunks(chunk, x, y, mask))
    return torch.cat(knns), torch.cat(cnts)


def ball_counts(
    x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, r: torch.Tensor, *,
    which: str,
) -> torch.Tensor:
    """The five counts of B samples at a per-row radius ``r`` float32
    (B, P): over valid j != i, |dx| < r, |dy| < r, dx == 0, dy == 0 and
    both == 0.  Returns int32 (5, B, P); for ``which="y"`` only |dy| < r,
    the other four zero, and x is never read."""
    def chunk(b, c, rr, a=None):
        dx = None if a is None else _absdiff(a)
        return _counts(dx, _absdiff(b), _valid(c), rr, which)

    arrays = (y, mask, r) if which == "y" else (y, mask, r, x)
    return torch.cat(_over_chunks(chunk, *arrays), dim=1)

"""Plain PyTorch fused radius+count: the CPU path and the kernel's oracle.

Computes what ``repro.kernels.knn_stats.ops.knn_radius_counts`` computes,
term for term like its single-tile body ``_knn_counts_fused_tile``, for a
batch of B padded samples at once.  The (B, P, P) distance tensors are
formed in chunks of samples so the temporaries stay bounded: at B=65536
and P=256 one unchunked float32 (B, P, P) tensor is 17 GB.

Non-finite inputs: a NaN distance is never selected (it is treated as
+inf before the order statistic is taken) and fails every count
condition.  ``kernel.py``'s CUDA kernel does the same, so the two agree
on every input; agreement with the JAX reference is claimed for finite
inputs only.
"""

from __future__ import annotations

import torch

__all__ = ["radius_counts"]

# Bound on chunk * P * P elements per temporary (64 MiB of float32).
_CHUNK_ELEMS = 1 << 24


def _chunk_stats(x, y, m, *, k, kb, kk, mode, which):
    c, P = x.shape
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=x.device)
    dx = (x[:, :, None] - x[:, None, :]).abs_()  # (c, P, P): |x_i - x_j|
    dy = (y[:, :, None] - y[:, None, :]).abs_()
    eye = torch.eye(P, dtype=torch.bool, device=x.device)
    valid = m[:, :, None] & m[:, None, :] & ~eye
    if mode == "joint":
        d = torch.maximum(dx, dy)  # NaN-propagating, as jnp.maximum
        d_sel = torch.where(valid & ~d.isnan(), d, inf)
        cnt = torch.zeros((c, P), dtype=torch.int32, device=x.device)
        T = k
        t = torch.full((c, P), k - 1, dtype=torch.int64, device=x.device)
    else:  # class: neighbourhoods restricted to equal x codes
        sel = valid & (x[:, :, None] == x[:, None, :])
        d_sel = torch.where(sel & ~dy.isnan(), dy, inf)
        cnt = sel.sum(-1, dtype=torch.int32)
        T = kb
        n_x = cnt + m.to(torch.int32)  # includes self
        t = (torch.clamp(n_x - 1, max=kk) - 1).clamp_(0, kb - 1).to(torch.int64)
    if T > P:  # fewer columns than the buffer: the tail is +inf
        d_sel = torch.cat([d_sel, inf.expand(c, P, T - P)], dim=-1)
    knn = torch.topk(d_sel, T, dim=-1, largest=False, sorted=True).values
    r = knn.gather(-1, t[..., None])[..., 0]
    rr = r[..., None]
    y_lt = (valid & (dy < rr)).sum(-1, dtype=torch.int32)
    if which == "y":
        zero = torch.zeros_like(y_lt)
        counts = torch.stack([zero, y_lt, zero, zero, zero])
    else:
        counts = torch.stack([
            (valid & (dx < rr)).sum(-1, dtype=torch.int32),
            y_lt,
            (valid & (dx <= 0.0)).sum(-1, dtype=torch.int32),
            (valid & (dy <= 0.0)).sum(-1, dtype=torch.int32),
            (valid & (torch.maximum(dx, dy) <= 0.0)).sum(-1, dtype=torch.int32),
        ])
    return r, cnt, counts


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
    B, P = x.shape
    chunk = max(1, _CHUNK_ELEMS // max(P * P, 1))
    rs, cnts, counts = [], [], []
    for b0 in range(0, B, chunk):
        r, c, n = _chunk_stats(
            x[b0:b0 + chunk], y[b0:b0 + chunk], mask[b0:b0 + chunk],
            k=k, kb=kb, kk=kk, mode=mode, which=which,
        )
        rs.append(r)
        cnts.append(c)
        counts.append(n)
    if not rs:
        empty = x.new_empty((0, P))
        return (empty, empty.to(torch.int32),
                empty.to(torch.int32).expand(5, 0, P).contiguous())
    return torch.cat(rs), torch.cat(cnts), torch.cat(counts, dim=1)

"""Sample-based mutual information estimators (PyTorch port).

Every estimator takes padded samples ``(x, y, mask)`` of shape (B, P) —
a leading batch of B joined samples, where the reference vmaps — and
returns (B,) float32 estimates:

  * :func:`mle_mi`       — plug-in MLE for discrete-discrete pairs.
  * :func:`ksg_mi`       — KSG-1 for continuous pairs.
  * :func:`mixed_ksg_mi` — Gao et al. (2017) for discrete-continuous
    mixtures.
  * :func:`dc_ksg_mi`    — Ross (2014) for (discrete X, continuous Y).

The KSG family takes ``impl``: ``"fused"`` (the default) gets its radii
and counts from one ``knn_radius_counts`` call over the whole batch (the
``radius_counts`` CUDA kernel on the card); ``"materialized"`` forms the
three (P, P) distance matrices with ``pairwise_cheb`` (its CUDA kernel
on the card) and reads the same statistics off them with ``torch.topk``
/ ``torch.sort`` and compares, term for term as the reference.  The
materialized statistics are formed in chunks of samples, so the (chunk,
P, P) matrices stay bounded; the tails then run once over the whole
batch, as on the fused path.  Both paths select the same float32
distances and count the same pairs, so their statistics are equal and
MI agrees bit for bit on the CPU.

Integer and selection outputs (ranks, radii, counts) equal the
reference's exactly.  The tails use ``torch.special.digamma``, which
differs from JAX's by up to ~2e-6, so MI agrees to float tolerance, not
bit for bit.
"""

from __future__ import annotations

from typing import Literal

import torch

from repro_torch.kernels.knn_stats.ops import K_MAX, knn_radius_counts
from repro_torch.kernels.pairwise_cheb.ops import pairwise_cheb

__all__ = [
    "dense_rank",
    "discrete_entropy",
    "mle_mi",
    "mle_mi_smoothed",
    "ksg_mi",
    "mixed_ksg_mi",
    "dc_ksg_mi",
    "estimate_mi",
]

Impl = Literal["fused", "materialized"]

# Bound on chunk * P * P elements per materialized (chunk, P, P) matrix:
# 2048 samples at P=256, 512 MiB of float32 each.  With DX, DY, DJ and
# the sort's values and int64 indices a chunk holds under 4 GB.
_MATERIALIZED_ELEMS = 1 << 27


def dense_rank(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Dense int32 ranks of the valid entries of each row of ``v``
    (ties share a rank); invalid entries receive rank P.

    The reference's ``lexsort((v, invalid))`` is two stable sorts, the
    secondary key first.  Integer ``v`` (codes carried as zero-extended
    int64) orders as the reference's uint32.
    """
    P = v.shape[-1]
    vkey = v.to(torch.float32) if v.is_floating_point() else v
    inval = (~mask).to(torch.int32)
    o1 = torch.sort(vkey, dim=-1, stable=True).indices
    o2 = torch.sort(inval.gather(-1, o1), dim=-1, stable=True).indices
    order = o1.gather(-1, o2)
    s = vkey.gather(-1, order)
    m_s = mask.gather(-1, order)
    new_run = torch.ones_like(mask)
    new_run[..., 1:] = (s[..., 1:] != s[..., :-1]) | (m_s[..., 1:] != m_s[..., :-1])
    rank_sorted = torch.cumsum(new_run, dim=-1, dtype=torch.int32) - 1
    ranks = torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)
    return torch.where(mask, ranks, torch.full_like(ranks, P))


def _masked_count_entropy(codes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Ĥ_MLE = −Σ (N_i/N) ln (N_i/N) per row from dense codes; invalid
    rows carry code P and land in a spill slot that is cut off."""
    P = codes.shape[-1]
    m = mask.sum(-1).clamp(min=1)
    counts = torch.zeros(
        codes.shape[:-1] + (P + 1,), dtype=torch.float32, device=codes.device
    ).scatter_add_(-1, codes.long(), mask.to(torch.float32))[..., :P]
    p = counts / m[..., None]
    return -torch.where(counts > 0, p * torch.log(p), 0.0).sum(-1)


def discrete_entropy(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Empirical (MLE) entropy of discrete samples, in nats."""
    return _masked_count_entropy(dense_rank(v, mask), mask)


def mle_mi(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Plug-in MLE mutual information for discrete-discrete samples."""
    P = x.shape[-1]
    cx = dense_rank(x, mask)
    cy = dense_rank(y, mask)
    joint = torch.where(mask, cx * (P + 1) + cy,
                        torch.full_like(cx, (P + 1) * (P + 1)))
    cj = dense_rank(joint, mask)
    hx = _masked_count_entropy(cx, mask)
    hy = _masked_count_entropy(cy, mask)
    hxy = _masked_count_entropy(cj, mask)
    return torch.clamp(hx + hy - hxy, min=0.0)


def mle_mi_smoothed(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                    alpha: float = 0.5) -> torch.Tensor:
    """Laplace-smoothed plug-in MI: p̂(i,j) = (N_ij + α) / (N + α·m_x·m_y)
    over the observed m_x × m_y support.  Builds a (B, P+1, P+1) grid."""
    w = mask.to(torch.float32)
    P = x.shape[-1]
    cx = dense_rank(x, mask).long()
    cy = dense_rank(y, mask).long()
    neg = torch.full_like(cx, -1)
    m_x = torch.where(mask, cx, neg).amax(-1) + 1
    m_y = torch.where(mask, cy, neg).amax(-1) + 1
    N = w.sum(-1)
    M = (m_x * m_y).to(torch.float32)
    grid = torch.zeros(x.shape[:-1] + ((P + 1) * (P + 1),),
                       dtype=torch.float32, device=x.device)
    grid = grid.scatter_add_(-1, cx * (P + 1) + cy, w)
    grid = grid.reshape(x.shape[:-1] + (P + 1, P + 1))[..., :P, :P]
    ii = torch.arange(P, device=x.device)
    valid = (ii[:, None] < m_x[..., None, None]) & (ii[None, :] < m_y[..., None, None])
    denom = (N + alpha * M)[..., None, None]
    pj = torch.where(valid, (grid + alpha) / denom, 0.0)
    px = (grid.sum(-1) + alpha * m_y[..., None]) / denom[..., 0]
    py = (grid.sum(-2) + alpha * m_x[..., None]) / denom[..., 0]
    ratio = pj / torch.clamp(px[..., :, None] * py[..., None, :], min=1e-30)
    mi = torch.where(valid, pj * torch.log(torch.clamp(ratio, min=1e-30)), 0.0)
    mi = mi.sum((-2, -1))
    return torch.where(N > 1, mi, 0.0)


def _digamma(v: torch.Tensor) -> torch.Tensor:
    return torch.special.digamma(v.to(torch.float32))


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    # A fill on the device, not a host-to-device copy: a copy from host
    # memory cannot be captured into a CUDA graph.
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _check_impl(impl: str) -> None:
    if impl not in ("fused", "materialized"):
        raise ValueError(f"unknown impl {impl!r}")


def _materialized(stats, *arrays):
    """Per-row statistics ``stats(*chunk)`` over samples of shape
    (..., P), formed in chunks of samples; each result comes back in the
    samples' shape."""
    shape = arrays[0].shape
    P = shape[-1]
    flat = [a.reshape(-1, P) for a in arrays]
    step = max(1, _MATERIALIZED_ELEMS // max(P * P, 1))
    parts = [stats(*(a[s:s + step] for a in flat))
             for s in range(0, max(flat[0].shape[0], 1), step)]
    return tuple(torch.cat(cols).reshape(shape) for cols in zip(*parts))


def _kth_smallest(d: torch.Tensor, k: int) -> torch.Tensor:
    """k-th smallest entry along the last axis."""
    return torch.topk(d, k, dim=-1, largest=False).values[..., k - 1]


def _off_diagonal(P: int, device) -> torch.Tensor:
    return ~torch.eye(P, dtype=torch.bool, device=device)


def _count(cond: torch.Tensor) -> torch.Tensor:
    return cond.sum(-1, dtype=torch.int32)


def _ksg_tail(nx, ny, mask, M, k):
    per_i = _digamma(nx + 1.0) + _digamma(ny + 1.0)
    mean_term = torch.where(mask, per_i, 0.0).sum(-1) / M.clamp(min=1)
    est = _digamma(_scalar(k, M)) + _digamma(M) - mean_term
    return torch.where(M > k, est, 0.0)


def _ksg_stats(x, y, mask, k):
    dx, dy, dj = pairwise_cheb(x, y, mask)
    eps = _kth_smallest(dj, k)[..., None]
    off = _off_diagonal(x.shape[-1], x.device)
    return _count((dx < eps) & off), _count((dy < eps) & off)


def ksg_mi(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
           k: int = 3, impl: Impl = "fused") -> torch.Tensor:
    """KSG estimator #1 (Kraskov et al. 2004) for continuous pairs."""
    _check_impl(impl)
    M = mask.sum(-1)
    if impl == "fused":
        _, _, c = knn_radius_counts(x, y, mask, k=k, mode="joint")
        return _ksg_tail(c.x_lt, c.y_lt, mask, M, k)
    nx, ny = _materialized(lambda a, b, m: _ksg_stats(a, b, m, k),
                           x.to(torch.float32), y.to(torch.float32), mask)
    return _ksg_tail(nx, ny, mask, M, k)


def _mixed_tail(rho, kp_tie, nx_tie, ny_tie, nx_cont, ny_cont, mask, M, k):
    tie = rho <= 0.0
    kp = torch.where(tie, kp_tie, k).to(torch.float32)
    nx = torch.where(tie, nx_tie, nx_cont).to(torch.float32)
    ny = torch.where(tie, ny_tie, ny_cont).to(torch.float32)
    logM = torch.log(M.to(torch.float32))[..., None]
    per_i = _digamma(kp) + logM - torch.log(nx) - torch.log(ny)
    est = torch.where(mask, per_i, 0.0).sum(-1) / M.clamp(min=1)
    return torch.where(M > k, est, 0.0)


def _mixed_stats(x, y, mask, k):
    dx, dy, dj = pairwise_cheb(x, y, mask)
    rho = _kth_smallest(dj, k)
    r = rho[..., None]
    off = _off_diagonal(x.shape[-1], x.device)  # DX/DY hold +inf at invalid pairs
    return (
        rho,
        _count((dj <= 0.0) & off) + 1, _count((dx <= 0.0) & off) + 1,
        _count((dy <= 0.0) & off) + 1, _count((dx < r) & off) + 1,
        _count((dy < r) & off) + 1,
    )


def mixed_ksg_mi(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                 k: int = 3, impl: Impl = "fused") -> torch.Tensor:
    """Gao et al. (2017) estimator for discrete-continuous mixtures:
    I ≈ ⟨ψ(k̃_i) + ln M − ln n_{x,i} − ln n_{y,i}⟩, counts including
    the point itself."""
    _check_impl(impl)
    M = mask.sum(-1)
    if impl == "fused":
        rho, _, c = knn_radius_counts(x, y, mask, k=k, mode="joint")
        return _mixed_tail(
            rho, c.j_eq + 1, c.x_eq + 1, c.y_eq + 1,
            c.x_lt + 1, c.y_lt + 1, mask, M, k,
        )
    stats = _materialized(lambda a, b, m: _mixed_stats(a, b, m, k),
                          x.to(torch.float32), y.to(torch.float32), mask)
    return _mixed_tail(*stats, mask, M, k)


def _dc_stats(codes, y, mask, kk):
    P = y.shape[-1]
    off = _off_diagonal(P, y.device)
    same = (codes[..., :, None] == codes[..., None, :]) \
        & mask[..., :, None] & mask[..., None, :]
    n_x = _count(same)  # includes self
    k_eff = torch.clamp(n_x - 1, max=kk)
    _, dy, _ = pairwise_cheb(y, y, mask)  # DY with +inf at invalid pairs
    inf = torch.full((), float("inf"), dtype=torch.float32, device=y.device)
    dy_sorted = torch.sort(torch.where(same & off, dy, inf), dim=-1).values
    idx = torch.clamp(k_eff - 1, 0, P - 1).long()
    d_i = dy_sorted.gather(-1, idx[..., None])
    return n_x, k_eff, _count((dy < d_i) & off)


def dc_ksg_mi(
    x_codes: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, k: int = 3,
    impl: Impl = "fused", k_i: int | None = None,
) -> torch.Tensor:
    """Ross (2014) estimator for (discrete X, continuous Y).

    I ≈ ψ(M') + ⟨ψ(k_i)⟩ − ⟨ψ(N_{x,i})⟩ − ⟨ψ(m_i + 1)⟩ over the points
    whose class has at least two members.  ``k_i`` (default ``k``) is the
    per-point budget; a budget above ``k`` widens the class-mode buffer
    to ``max(k, k_i)``, capped at :data:`K_MAX`.  ``x_codes`` must be
    exactly float32-representable (dense ranks are).
    """
    _check_impl(impl)
    if k_i is not None and k_i > K_MAX:
        raise ValueError(
            f"DC-KSG per-point neighbor budget k_i={k_i} exceeds "
            f"k_max={K_MAX}: the class-mode kNN buffer is capped at the "
            "kernel lane width, so a wider budget cannot be served on "
            "any backend — lower k_i"
        )
    kk = k if k_i is None else k_i
    k_buf = max(k, kk)
    M = mask.sum(-1)
    if impl == "fused":
        _, same_cnt, counts = knn_radius_counts(
            x_codes.to(torch.float32), y, mask, k=k, k_max=k_buf,
            mode="class", which="y", kk=kk,
        )
        n_x = same_cnt + mask.to(torch.int32)
        k_eff = torch.clamp(n_x - 1, max=kk)
        m_i = counts.y_lt
    else:
        n_x, k_eff, m_i = _materialized(
            lambda c, b, m: _dc_stats(c, b, m, kk),
            x_codes, y.to(torch.float32), mask,
        )
    valid_i = mask & (n_x >= 2)
    cnt = valid_i.sum(-1).clamp(min=1)

    def mean_of(t):
        return torch.where(valid_i, t, 0.0).sum(-1) / cnt

    est = (
        _digamma(cnt)
        + mean_of(_digamma(k_eff.clamp(min=1)))
        - mean_of(_digamma(n_x))
        - mean_of(_digamma(m_i.to(torch.float32) + 1.0))
    )
    return torch.where(M > k, torch.clamp(est, min=0.0), 0.0)


def estimate_mi(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    *,
    x_discrete: bool,
    y_discrete: bool,
    method: str = "auto",
    k: int = 3,
) -> torch.Tensor:
    """Type-dispatched MI estimate: discrete-discrete -> MLE;
    numeric-numeric -> MixedKSG; discrete-continuous -> DC-KSG."""
    if method == "auto":
        if x_discrete and y_discrete:
            method = "mle"
        elif not x_discrete and not y_discrete:
            method = "mixed_ksg"
        else:
            method = "dc_ksg"
    if method == "mle":
        return mle_mi(x, y, mask)
    if method == "mle_smoothed":
        return mle_mi_smoothed(x, y, mask)
    if method == "ksg":
        return ksg_mi(x, y, mask, k=k)
    if method == "mixed_ksg":
        return mixed_ksg_mi(x, y, mask, k=k)
    if method == "dc_ksg":
        if x_discrete:
            return dc_ksg_mi(dense_rank(x, mask), y, mask, k=k)
        return dc_ksg_mi(dense_rank(y, mask), x, mask, k=k)
    raise ValueError(f"unknown method {method!r}")

"""Plain mutual-information estimators over batches of joined samples.

Each takes (B, P) samples with a (B, P) validity mask and returns (B,)
estimates in nats, in ``tail`` precision.  Distances are taken in
``dist`` precision (float32, as the configurations state; the control
lowers it), the digamma and log tails in ``tail``:

* :func:`mixed_ksg` - Gao et al. (2017), both sides numeric: the k-th
  smallest Chebyshev distance rho_i over j != i; where rho_i is 0 the
  ties set k~, n_x and n_y, else k and the strict ball counts plus one:
  I = <psi(k~) + ln M - ln n_x - ln n_y>;
* :func:`dc_ksg` - Ross (2014), one side discrete (``codes``): the
  radius is the min(n_x - 1, k)-th smallest distance within the point's
  class, m_i the points of any class strictly inside it, over the points
  whose class has two members or more: I = psi(M') + <psi(min(n_x-1, k))>
  - <psi(n_x)> - <psi(m_i + 1)>, floored at 0;
* :func:`mle` - the plug-in estimate of two discrete sides, floored at 0.

Every estimate is 0 for a sample of k points or fewer.  Samples are
taken in chunks so that the (chunk, P, P) temporaries stay bounded.
"""

from __future__ import annotations

import torch

_PAIR_ELEMS = 1 << 26


def _chunks(fn, *arrays):
    B, P = arrays[0].shape
    step = max(1, _PAIR_ELEMS // max(P * P, 1))
    return torch.cat([fn(*(a[s:s + step] for a in arrays))
                      for s in range(0, max(B, 1), step)])


def _absdiff(v: torch.Tensor, dist) -> torch.Tensor:
    v = v.to(dist)
    return (v[:, :, None] - v[:, None, :]).abs()


def _valid_pairs(m: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(m.shape[-1], dtype=torch.bool, device=m.device)
    return m[:, :, None] & m[:, None, :] & ~eye


def _kth(d: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest entries along the last axis, ascending, +inf
    beyond the last column."""
    P = d.shape[-1]
    if P < k:
        d = torch.cat([d, d.new_full(d.shape[:-1] + (k - P,), float("inf"))], -1)
    return torch.topk(d, k, dim=-1, largest=False, sorted=True).values


def _count(cond: torch.Tensor) -> torch.Tensor:
    return cond.sum(-1)


def mixed_ksg(x, y, m, k: int, dist=torch.float32, tail=torch.float64):
    def one(x, y, m):
        valid = _valid_pairs(m)
        dx, dy = _absdiff(x, dist), _absdiff(y, dist)
        dj = torch.maximum(dx, dy)
        inf = torch.full((), float("inf"), dtype=dist, device=x.device)
        rho = _kth(torch.where(valid, dj, inf), k)[..., k - 1]
        r = rho[..., None]
        tie = rho <= 0
        kp = torch.where(tie, _count(valid & (dj <= 0)) + 1, k)
        nx = torch.where(tie, _count(valid & (dx <= 0)), _count(valid & (dx < r))) + 1
        ny = torch.where(tie, _count(valid & (dy <= 0)), _count(valid & (dy < r))) + 1
        M = m.sum(-1).to(tail)
        per = (torch.special.digamma(kp.to(tail)) + torch.log(M)[:, None]
               - torch.log(nx.to(tail)) - torch.log(ny.to(tail)))
        est = torch.where(m, per, 0).sum(-1) / M.clamp(min=1)
        return torch.where(M > k, est, 0)
    return _chunks(one, x, y, m)


def dc_ksg(codes, cont, m, k: int, dist=torch.float32, tail=torch.float64):
    def one(codes, cont, m):
        valid = _valid_pairs(m)
        same = valid & (codes[:, :, None] == codes[:, None, :])
        n_x = _count(same) + m
        dy = _absdiff(cont, dist)
        inf = torch.full((), float("inf"), dtype=dist, device=cont.device)
        knn = _kth(torch.where(same, dy, inf), k)
        t = (torch.clamp(n_x - 1, max=k) - 1).clamp(0, k - 1)
        r = knn.gather(-1, t[..., None])
        m_i = _count(valid & (dy < r))
        k_eff = torch.clamp(n_x - 1, max=k).clamp(min=1)
        keep = m & (n_x >= 2)
        cnt = keep.sum(-1).clamp(min=1).to(tail)

        def mean_of(v):
            return torch.where(keep, v, 0).sum(-1) / cnt

        dg = torch.special.digamma
        est = (dg(cnt) + mean_of(dg(k_eff.to(tail))) - mean_of(dg(n_x.to(tail)))
               - mean_of(dg((m_i + 1).to(tail))))
        return torch.where(m.sum(-1) > k, est.clamp(min=0), 0)
    return _chunks(one, codes, cont, m)


def _dense_codes(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Dense ranks of the valid entries of each row; invalid ones P."""
    P = v.shape[-1]
    key = torch.where(m, v.to(torch.float64), float("inf"))
    s, order = torch.sort(key, dim=-1)
    new = torch.ones_like(m)
    new[..., 1:] = s[..., 1:] != s[..., :-1]
    ranks = torch.empty_like(order).scatter_(-1, order, new.long().cumsum(-1) - 1)
    return torch.where(m, ranks, P)


def _entropy(codes: torch.Tensor, m: torch.Tensor, tail) -> torch.Tensor:
    P = codes.shape[-1]
    counts = torch.zeros(codes.shape[:-1] + (P + 1,), dtype=tail,
                         device=codes.device).scatter_add_(-1, codes, m.to(tail))
    p = counts[..., :P] / m.sum(-1, keepdim=True).clamp(min=1).to(tail)
    return -torch.where(p > 0, p * torch.log(p), 0).sum(-1)


def mle(x, y, m, k: int, dist=torch.float32, tail=torch.float64):
    def one(x, y, m):
        P = x.shape[-1]
        cx = _dense_codes(x.to(dist), m)
        cy = _dense_codes(y.to(dist), m)
        cj = _dense_codes((cx * (P + 1) + cy).to(torch.float64), m)
        mi = _entropy(cx, m, tail) + _entropy(cy, m, tail) - _entropy(cj, m, tail)
        return mi.clamp(min=0)
    return _chunks(one, x, y, m)

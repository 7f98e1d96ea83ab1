"""Plain PyTorch pairwise Chebyshev matrices: the CPU path and the
kernel's oracle.

Computes what ``repro.kernels.pairwise_cheb.ref.pairwise_cheb_ref``
computes, over a leading batch: for samples (x, y, mask) of shape
(B, P),

    DX[b, i, j] = |x_i - x_j|,  DY[b, i, j] = |y_i - y_j|,
    DJ[b, i, j] = max(DX, DY)

with every pair that has an invalid end set to +inf in all three, and
only DJ's diagonal fenced to +inf.  ``torch.maximum`` propagates NaN as
``jnp.maximum`` does, so a NaN input gives NaN in DJ, not the other
marginal's distance.
"""

from __future__ import annotations

import torch

__all__ = ["pairwise_cheb"]


def pairwise_cheb(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """(DX, DY, DJ), each float32 of shape ``x.shape + (P,)``."""
    P = x.shape[-1]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=x.device)
    valid = mask[..., :, None] & mask[..., None, :]
    dx = torch.where(valid, (x[..., :, None] - x[..., None, :]).abs(), inf)
    dy = torch.where(valid, (y[..., :, None] - y[..., None, :]).abs(), inf)
    eye = torch.eye(P, dtype=torch.bool, device=x.device)
    dj = torch.where(eye, inf, torch.maximum(dx, dy))
    return dx, dy, dj

"""Public knn_stats API of the port: the fused radius+count entry.

:func:`knn_radius_counts` is everything the KSG-family estimators
consume — per-row radius, class-mode neighbourhood size and the five
ball/tie counts at that radius — for a batch of padded samples with a
leading batch dimension.

It dispatches by the tensors' device: a CPU tensor takes the plain
PyTorch version (``ref.py``); a CUDA tensor launches the hand-written
kernel (``kernel.py``) or raises.  A CUDA tensor never takes the plain
path.  ``knn_smallest``, ``ball_counts`` and ``knn_with_counts`` of the
reference are off the discovery path and not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.knn_stats import kernel, ref

__all__ = ["BallCounts", "K_MAX", "knn_radius_counts"]

# Widest kNN buffer: the reference's TPU lane width.  Hopper has no such
# cap, but one ceiling everywhere keeps parameter ranges equal to the
# reference's.
K_MAX = 128


class BallCounts(NamedTuple):
    """Per-row counts over valid j ≠ i (int32, the batch shape)."""

    x_lt: torch.Tensor  # |x_i − x_j| <  r_i
    y_lt: torch.Tensor  # |y_i − y_j| <  r_i
    x_eq: torch.Tensor  # x_j == x_i
    y_eq: torch.Tensor  # y_j == y_i
    j_eq: torch.Tensor  # x_j == x_i and y_j == y_i


def _buffer_width(k: int, k_max: int | None) -> int:
    kb = k if k_max is None else int(k_max)
    if kb < k:
        raise ValueError(f"k_max={kb} < k={k}: the buffer must hold at "
                         "least the k tracked neighbors")
    if kb > K_MAX:
        raise ValueError(
            f"kNN buffer width {kb} exceeds K_MAX={K_MAX} (the kernel "
            "lane width); no backend can serve it"
        )
    return kb


def knn_radius_counts(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    *,
    k: int,
    k_max: int | None = None,
    mode: str = "joint",
    which: str = "all",
    kk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, BallCounts]:
    """Fused radius+count over samples of shape ``(..., P)``.

    Joint mode takes the k-th smallest joint Chebyshev distance (the
    KSG/MixedKSG ε_i); class mode takes the DC-KSG clipped within-class
    extraction with per-point budget ``kk`` (default ``k``) from a
    ``k_max``-wide buffer.  Returns ``(r, cnt, counts)`` of the batch
    shape: float32 radii, int32 class counts, int32 :class:`BallCounts`.
    """
    if mode not in ("joint", "class"):
        raise ValueError(f"unknown mode {mode!r}")
    if which not in ("all", "y"):
        raise ValueError(f"unknown which {which!r}")
    kb = _buffer_width(k, k_max)
    kkv = k if kk is None else int(kk)
    if kkv > kb:
        raise ValueError(
            f"class-mode per-point budget kk={kkv} exceeds the buffer "
            f"width k_max={kb}; widen k_max so the kk-th distance exists"
        )
    shape = x.shape
    P = shape[-1]
    xf = x.to(torch.float32).reshape(-1, P).contiguous()
    yf = y.to(torch.float32).reshape(-1, P).contiguous()
    m = mask.to(torch.bool).reshape(-1, P).contiguous()
    if xf.device.type == "cpu":
        impl = ref.radius_counts
    elif xf.device.type == "cuda":
        impl = kernel.radius_counts
    else:
        raise ValueError(f"no radius_counts implementation for {xf.device}")
    r, cnt, counts = impl(xf, yf, m, k=k, kb=kb, kk=kkv, mode=mode, which=which)
    return (
        r.reshape(shape), cnt.reshape(shape),
        BallCounts(*(c.reshape(shape) for c in counts.unbind(0))),
    )

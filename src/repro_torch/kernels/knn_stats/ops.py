"""Public knn_stats API of the port, over samples with leading batch
dimensions ``(..., P)``:

  * :func:`knn_radius_counts` — everything the KSG-family estimators
    consume (per-row radius, class-mode neighbourhood size and the five
    ball/tie counts at that radius) in one fused kernel launch;
  * :func:`knn_smallest` — the k smallest selected distances per row;
  * :func:`ball_counts` — the ball/tie counts at a per-row radius;
  * :func:`knn_with_counts` — the two, with a caller's radius rule
    between them.  ``knn_radius_counts`` is bit-equal to it with the
    estimators' radius rules, so it is the fused path's oracle.

Each dispatches by the tensors' device: a CPU tensor takes the plain
PyTorch version (``ref.py``); a CUDA tensor launches the hand-written
kernel (``kernel.py``) or raises.  A CUDA tensor never takes the plain
path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.knn_stats import kernel, ref

__all__ = ["BallCounts", "K_MAX", "ball_counts", "knn_radius_counts",
           "knn_smallest", "knn_with_counts"]

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


def _check_mode(mode: str | None = None, which: str | None = None) -> None:
    if mode is not None and mode not in ("joint", "class"):
        raise ValueError(f"unknown mode {mode!r}")
    if which is not None and which not in ("all", "y"):
        raise ValueError(f"unknown which {which!r}")


def _flat(*samples):
    """float32 x, y and bool mask as contiguous (B, P), and the batch shape."""
    shape = samples[0].shape
    P = shape[-1]
    xf, yf, m = (t.to(dt).reshape(-1, P).contiguous() for t, dt in
                 zip(samples, (torch.float32, torch.float32, torch.bool)))
    return xf, yf, m, shape


def _impl(name: str, device: torch.device):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if device.type == "cpu":
        return getattr(ref, name)
    if device.type == "cuda":
        return getattr(kernel, name)
    raise ValueError(f"no {name} implementation for {device}")


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
    _check_mode(mode, which)
    kb = _buffer_width(k, k_max)
    kkv = k if kk is None else int(kk)
    if kkv > kb:
        raise ValueError(
            f"class-mode per-point budget kk={kkv} exceeds the buffer "
            f"width k_max={kb}; widen k_max so the kk-th distance exists"
        )
    xf, yf, m, shape = _flat(x, y, mask)
    impl = _impl("radius_counts", xf.device)
    r, cnt, counts = impl(xf, yf, m, k=k, kb=kb, kk=kkv, mode=mode, which=which)
    return (
        r.reshape(shape), cnt.reshape(shape),
        BallCounts(*(c.reshape(shape) for c in counts.unbind(0))),
    )


def knn_smallest(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    *,
    k: int,
    k_max: int | None = None,
    mode: str = "joint",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row k smallest selected distances over samples ``(..., P)``.

    Mode "joint" selects the joint Chebyshev max(|dx|, |dy|); mode
    "class" selects |dy| over rows with equal x code (DC-KSG; x carries
    class codes).  ``k_max`` widens the buffer beyond ``k`` (capped at
    :data:`K_MAX`).  Returns (knn float32 ``(..., P, max(k, k_max))``,
    ascending with +inf padding; cnt int32 ``(..., P)``, the valid
    same-class neighbours j != i, zeros in joint mode).  On the card,
    samples of more than 256 columns that take the tiled body (P > 1024,
    or a buffer wider than 16) also take 40 bytes of device scratch a
    column while the call runs, at most 1 GiB (or one sample's).
    """
    _check_mode(mode)
    kb = _buffer_width(k, k_max)
    xf, yf, m, shape = _flat(x, y, mask)
    knn, cnt = _impl("knn_smallest", xf.device)(xf, yf, m, kb=kb, mode=mode)
    return knn.reshape(shape + (kb,)), cnt.reshape(shape)


def ball_counts(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    r: torch.Tensor,
    *,
    which: str = "all",
) -> BallCounts:
    """Ball / tie counts per row at a per-row radius ``r`` (the batch
    shape): strict ``< r_i`` in both marginals and the exact ties, over
    valid j != i.  ``which="y"`` computes only ``y_lt`` (the rest are
    zeros) and never reads x.  On the card, samples of more than 1024
    columns (the tiled body) also take 40 bytes of device scratch a column
    while the call runs, at most 1 GiB (or one sample's)."""
    _check_mode(which=which)
    xf, yf, m, shape = _flat(x, y, mask)
    rf = r.to(torch.float32).reshape(xf.shape).contiguous()
    counts = _impl("ball_counts", xf.device)(xf, yf, m, rf, which=which)
    return BallCounts(*(c.reshape(shape) for c in counts.unbind(0)))


def knn_with_counts(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    *,
    k: int,
    k_max: int | None = None,
    mode: str = "joint",
    which: str = "all",
    radius=None,
) -> tuple[torch.Tensor, torch.Tensor, BallCounts]:
    """:func:`knn_smallest`, a per-row radius, and :func:`ball_counts` at
    that radius.

    ``radius`` is a callable ``(knn, cnt) -> r`` on tensors of the batch
    shape (default: the k-th smallest selected distance,
    ``knn[..., k-1]``, the KSG/MixedKSG choice; DC-KSG passes its clipped
    within-class extraction).  On the card it runs as plain torch ops
    between the two kernel launches.  Returns ``(knn, cnt, counts)``.
    """
    _check_mode(mode, which)
    if radius is None:
        radius = lambda knn, cnt: knn[..., k - 1]  # noqa: E731
    knn, cnt = knn_smallest(x, y, mask, k=k, k_max=k_max, mode=mode)
    r = radius(knn, cnt)
    return knn, cnt, ball_counts(x, y, mask, r, which=which)

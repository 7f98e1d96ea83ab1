"""Public pairwise_cheb API of the port: (DX, DY, DJ) with masking and
diagonal fencing, over a leading batch.

It dispatches by the tensors' device: a CPU tensor takes the plain
PyTorch version (``ref.py``); a CUDA tensor launches the hand-written
kernel (``kernel.py``) or raises.  A CUDA tensor never takes the plain
path.  The op has no tuning knob: on the card, ``kernel.pairwise_cheb``
takes its launch shape (thread rows a block) from the autotuner
(``repro_torch.kernels.autotune``; ``REPRO_AUTOTUNE=on`` sweeps on the
card, unset with no cache file launches the default), and every rung
gives the same bits.  A CPU tensor never reaches the tuner.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.pairwise_cheb import kernel, ref

__all__ = ["pairwise_cheb"]


def pairwise_cheb(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """(DX, DY, DJ), each float32 of shape ``x.shape + (P,)``: invalid
    pairs +inf in all three, DJ = max(DX, DY) (NaN-propagating) with its
    diagonal +inf."""
    shape = x.shape
    P = shape[-1]
    xf = x.to(torch.float32).reshape(-1, P).contiguous()
    yf = y.to(torch.float32).reshape(-1, P).contiguous()
    m = mask.to(torch.bool).reshape(-1, P).contiguous()
    if xf.device.type == "cpu":
        impl = ref.pairwise_cheb
    elif xf.device.type == "cuda":
        impl = kernel.pairwise_cheb
    else:
        raise ValueError(f"no pairwise_cheb implementation for {xf.device}")
    return tuple(d.reshape(shape + (P,)) for d in impl(xf, yf, m))

"""Public attention op of the port: the CUDA kernel on the card, the
plain chunked version on the CPU.

``attention(q, k, v)`` takes the reference's (B, H, S, D) layout and
contract (``repro/kernels/flash_attention/ops.py::attention``).  A CPU
tensor takes ``ref.chunked_attention``; a CUDA tensor launches a
hand-written kernel (``kernel.flash_attention``: the Hopper kernel for
bfloat16/float16 at its head dims, which rounds P to that dtype before
P·V, the CUDA-core kernel otherwise) or raises, and never takes the
plain path.  There is no block autotuner and no host-side padding of S or D:
the kernel masks its own ragged edge.  Unlike the reference, a
non-causal call at an S that is not a block multiple is exact (the
reference lets its padded keys into the softmax).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref

__all__ = ["attention"]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float | None = None, causal: bool = True) -> torch.Tensor:
    """GQA attention, (B, Hq, S, Dk) x (B, Hkv, S, Dk), (B, Hkv, S, Dv) ->
    (B, Hq, S, Dv) in q's dtype.  Distinct Dk/Dv are taken (MLA)."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if q.device.type == "cpu":
        return ref.chunked_attention(q, k, v, scale=scale, causal=causal)
    if q.device.type == "cuda":
        return kernel.flash_attention(q, k, v, scale=scale, causal=causal)
    raise ValueError(f"no attention implementation for {q.device}")

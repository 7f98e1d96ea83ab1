"""Public attention op of the port: the CUDA kernel on the card, the
plain chunked version on the CPU.

``attention(q, k, v)`` takes the reference's (B, H, S, D) layout and
contract (``repro/kernels/flash_attention/ops.py::attention``).  A CPU
tensor takes ``ref.chunked_attention`` (under autograd too); a CUDA tensor
launches a hand-written kernel (``kernel.flash_attention``: the Hopper
kernel for bfloat16/float16 at its head dims, which rounds P to that
dtype before P·V, the CUDA-core kernel otherwise) or raises, and never
takes the plain path in the forward.  There is no block autotuner and no
host-side padding of S or D: the kernel masks its own ragged edge.
Unlike the reference, a non-causal call at an S that is not a block
multiple is exact (the reference lets its padded keys into the softmax).

Gradients: the kernels have no backward, and a ctypes launch records
nothing for autograd.  On a CUDA tensor that requires grad (grad mode
on), :class:`FlashAttention` launches the kernel in its forward exactly as
above, keeps q, k, v, and in its backward recomputes the attention
through ``ref.chunked_attention`` and returns the autograd gradients of
that: what the reference differentiates, as it has no backward kernel
either.  Nothing of the forward is kept besides its inputs, so the
backward recomputes one layer's attention at a time.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.kernels.flash_attention import kernel, ref

__all__ = ["attention", "FlashAttention", "BACKWARD_SPAN"]

# The record_function range around the backward's recompute (a profiler
# sees its kernels as one family).
BACKWARD_SPAN = "flash_backward_recompute"


class FlashAttention(torch.autograd.Function):
    """The kernel's forward with the plain version's gradient (see the
    module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.causal = scale, causal
        return kernel.flash_attention(q, k, v, scale=scale, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        with record_function(BACKWARD_SPAN), torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip((q, k, v), ctx.needs_input_grad)]
            out = ref.chunked_attention(*leaves, scale=ctx.scale,
                                        causal=ctx.causal)
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grad_out))
        return (*(next(got) if t.requires_grad else None for t in leaves),
                None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float | None = None, causal: bool = True) -> torch.Tensor:
    """GQA attention, (B, Hq, S, Dk) x (B, Hkv, S, Dk), (B, Hkv, S, Dv) ->
    (B, Hq, S, Dv) in q's dtype.  Distinct Dk/Dv are taken (MLA)."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if q.device.type == "cpu":
        return ref.chunked_attention(q, k, v, scale=scale, causal=causal)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return FlashAttention.apply(q, k, v, scale, causal)
        return kernel.flash_attention(q, k, v, scale=scale, causal=causal)
    raise ValueError(f"no attention implementation for {q.device}")

"""One-token attention against a KV cache (decode).

The port's counterpart of ``repro/parallel/decode_attention.py``: its
``_local_decode``, in plain torch (the reference has no Pallas kernel
here; XLA fuses it).  There is no mesh branch yet: the context-parallel
merge over mesh axes, and the fence for a shard with no live row, come
with the model mesh, the next multi-GPU slice.
"""

from __future__ import annotations

import torch

__all__ = ["decode_attention"]

_NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int | torch.Tensor, *,
                     scale: float) -> torch.Tensor:
    """q (B, H, Dh); caches (B, S, Hkv, Dh); ``pos`` the last valid
    index, an int or a 0-dim tensor on q's device (a captured decode
    step's).  Returns (B, H, Dh) in q's dtype; softmax in float32."""
    B, S, Hkv, Dh = k_cache.shape
    H = q.shape[1]
    qf = q.reshape(B, Hkv, H // Hkv, Dh).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float()) * scale
    live = torch.arange(S, device=q.device) <= pos
    scores = torch.where(live, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, Dh).to(q.dtype)

"""Plain PyTorch versions of flash attention (the kernel's oracles).

  * :func:`mha_reference`: naive full-softmax GQA attention in float32,
    O(S²) memory; the ground truth for every tolerance check.
  * :func:`chunked_attention`: the online softmax over KV chunks, the
    same algorithm as the CUDA kernel (running max, denominator and
    weighted sum in float32, the finite ``-1e30`` mask, ``safe_l``).  It
    is what ``ops.attention`` runs on a CPU tensor.  Unlike the
    reference's ``lax.scan`` version it takes any S: the last chunk is
    simply shorter.  With ``p_dtype`` it is the plain version of the
    Hopper kernel (``csrc/flash_wgmma.cu``): the chunks are the kernel's
    ``KEY_TILE`` keys, and each chunk's weights ``exp(s - m_new)`` are
    rounded to ``p_dtype`` before P·V while l sums the unrounded weights.

Layout as the reference: q (B, Hq, S, Dk), k (B, Hkv, S, Dk),
v (B, Hkv, S, Dv) -> (B, Hq, S, Dv) in q's dtype; KV head = h // group.
"""

from __future__ import annotations

import torch

__all__ = ["KEY_TILE", "mha_reference", "chunked_attention"]

_NEG_INF = -1e30
# Keys per chunk of the online softmax: bounds the live (B, H, S, chunk)
# score tensor; the reference's ``cfg.attn_chunk`` default.
_CHUNK = 1024
# Keys per K/V tile of the Hopper kernel: the chunk of its rounding rule.
KEY_TILE = 128


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool = True) -> torch.Tensor:
    S = q.shape[2]
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: float, causal: bool = True,
                      p_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash semantics): peak
    live memory O(B·H·S·chunk), not O(B·H·S²).

    ``p_dtype``: the Hopper kernel's rule (see the module docstring):
    chunks of ``KEY_TILE`` keys, each chunk's weights rounded to this
    dtype before P·V.  None: chunks of ``_CHUNK`` keys, weights kept in
    float32."""
    B, Hq, S, Dk = q.shape
    Dv = v.shape[-1]
    Hkv = k.shape[1]
    group = Hq // Hkv
    chunk = max(1, min(_CHUNK if p_dtype is None else KEY_TILE, S))
    qf = q.float().reshape(B, Hkv, group, S, Dk)
    q_pos = torch.arange(S, device=q.device)

    m = torch.full((B, Hkv, group, S), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, group, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, group, S, Dv), dtype=torch.float32,
                      device=q.device)
    for start in range(0, S, chunk):
        k_blk = k[:, :, start:start + chunk].float()
        v_blk = v[:, :, start:start + chunk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k_blk) * scale
        if causal:
            k_pos = start + torch.arange(k_blk.shape[2], device=q.device)
            live = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(live, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        if p_dtype is not None:
            p = p.to(p_dtype).float()
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd",
                                                    p, v_blk)
        m = m_new
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    out = (acc / safe_l[..., None]).reshape(B, Hq, S, Dv)
    return out.to(q.dtype)

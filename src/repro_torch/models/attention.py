"""Attention mixers: GQA (with optional QKV bias) and MLA (DeepSeek-V2).

The port's counterpart of ``repro/models/attention.py``.  Each mixer exposes
``init(cfg, gen, device)``, ``apply(cfg, p, x, positions)`` for prefill
(full sequence, causal) and ``decode(cfg, p, x, cache, pos)`` for one
token against a KV cache, with the reference's layouts: activations
(B, S, D), GQA's cache (B, S, Hkv, Dh), MLA's latent cache (see ``mla``).

``apply`` calls ``ops.attention`` on every device, so on the card the
prefill runs the hand-written flash kernel (the reference used the
Pallas kernel only on a TPU).  The (B, H, S, Dh) operands are transposed
views; the kernel reads their strides, nothing is copied.  ``decode``
writes the new K/V row into the cache in place with ``index_copy_`` at
a device position (the reference returns a new cache with
``dynamic_update_slice``), so a captured step reads no host integer,
and returns the same dict.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import attention as flash_attention
from repro_torch.models.common import (apply_rope, cast, dense_init,
                                       dtype_of, linear, rope_cos_sin, shard)
from repro_torch.parallel.decode_attention import decode_attention

__all__ = ["gqa", "mla"]

_NEG_INF = -1e30


class gqa:
    @staticmethod
    def init(cfg: ModelConfig, gen: torch.Generator | None,
             device) -> nn.ModuleDict:
        d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        kw = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        return nn.ModuleDict({
            "wq": dense_init(gen, d, h * dh, bias=cfg.qkv_bias, **kw),
            "wk": dense_init(gen, d, hkv * dh, bias=cfg.qkv_bias, **kw),
            "wv": dense_init(gen, d, hkv * dh, bias=cfg.qkv_bias, **kw),
            "wo": dense_init(gen, h * dh, d,
                             scale=0.02 / math.sqrt(2 * cfg.num_layers), **kw),
        })

    @staticmethod
    def _qkv(cfg: ModelConfig, p: nn.ModuleDict, x: torch.Tensor,
             positions: torch.Tensor):
        B, S, _ = x.shape
        h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = linear(p["wq"], x).reshape(B, S, h, dh)
        k = linear(p["wk"], x).reshape(B, S, hkv, dh)
        v = linear(p["wv"], x).reshape(B, S, hkv, dh)
        q = shard(q, "batch", "seq", "heads", None)
        k = shard(k, "batch", "seq", "kv_heads", None)
        v = shard(v, "batch", "seq", "kv_heads", None)
        cos, sin = rope_cos_sin(positions, dh, cfg.rope_theta)
        cos, sin = cos[..., None, :], sin[..., None, :]
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    @staticmethod
    def apply(cfg: ModelConfig, p: nn.ModuleDict, x: torch.Tensor,
              positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Full-sequence causal attention.  Returns (out, kv) where kv is
        the cache contribution (used by prefill)."""
        B, S, _ = x.shape
        q, k, v = gqa._qkv(cfg, p, x, positions)
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2),
                              scale=1.0 / math.sqrt(cfg.head_dim), causal=True)
        out = out.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.head_dim)
        out = shard(out, "batch", "seq", "mlp")
        return linear(p["wo"], out), {"k": k, "v": v}

    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    @staticmethod
    def decode(cfg: ModelConfig, p: nn.ModuleDict, x: torch.Tensor,
               cache: dict, pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """x (B, 1, D); cache k/v (B, Smax, Hkv, Dh), updated in place at
        ``pos`` (a 0-dim integer tensor on x's device); returns (out,
        cache)."""
        B = x.shape[0]
        positions = pos.to(torch.int32).reshape(1, 1).expand(B, 1)
        q, k_new, v_new = gqa._qkv(cfg, p, x, positions)
        row = pos.reshape(1).to(torch.int64)
        cache["k"].index_copy_(1, row, k_new.to(cache["k"].dtype))
        cache["v"].index_copy_(1, row, v_new.to(cache["v"].dtype))
        out = decode_attention(q[:, 0], cache["k"], cache["v"], pos,
                               scale=1.0 / math.sqrt(cfg.head_dim))
        out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
        return linear(p["wo"], out), cache


class mla:
    """DeepSeek-V2 multi-head latent attention.

    The prefill (``apply``) expands the latent into per-head K/V and runs
    the flash kernel at (Dk, Dv) = (nope + rope, v_head); v is a strided
    slice of ``kv_up``'s output, read in place.  The cache holds the
    compressed latent ``c_kv`` (B, S, kv_lora_rank) and the rope key
    ``k_rope`` (B, S, rope); ``decode`` is the reference's absorbed
    formulation in plain torch (W_UK folded into the query, W_UV applied
    to the attention-weighted latent, float32 softmax), writing the cache
    in place at a device position as ``gqa.decode`` does.
    """

    @staticmethod
    def init(cfg: ModelConfig, gen: torch.Generator | None,
             device) -> nn.ModuleDict:
        d, h = cfg.d_model, cfg.num_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        lora = cfg.kv_lora_rank
        kw = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        return nn.ModuleDict({
            "wq": dense_init(gen, d, h * (dn + dr), **kw),
            "kv_down": dense_init(gen, d, lora + dr, **kw),
            "kv_up": dense_init(gen, lora, h * (dn + dv), **kw),
            "wo": dense_init(gen, h * dv, d,
                             scale=0.02 / math.sqrt(2 * cfg.num_layers), **kw),
        })

    @staticmethod
    def _latent(cfg: ModelConfig, p: nn.ModuleDict, x: torch.Tensor,
                positions: torch.Tensor):
        """Compressed KV latent + rope key (what the cache stores)."""
        lat = linear(p["kv_down"], x)  # (B, S, lora + dr)
        c_kv, k_rope = lat[..., :cfg.kv_lora_rank], lat[..., cfg.kv_lora_rank:]
        cos, sin = rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
        k_rope = apply_rope(k_rope[..., None, :], cos[..., None, :],
                            sin[..., None, :])[..., 0, :]
        return c_kv, k_rope

    @staticmethod
    def _queries(cfg: ModelConfig, p: nn.ModuleDict, x: torch.Tensor,
                 positions: torch.Tensor):
        B, S, _ = x.shape
        h = cfg.num_heads
        dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        q = linear(p["wq"], x).reshape(B, S, h, dn + dr)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        cos, sin = rope_cos_sin(positions, dr, cfg.rope_theta)
        q_rope = apply_rope(q_rope, cos[..., None, :], sin[..., None, :])
        return q_nope, q_rope

    @staticmethod
    def apply(cfg: ModelConfig, p: nn.ModuleDict, x: torch.Tensor,
              positions: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Prefill: the explicit formulation.  Returns (out, {"c_kv",
        "k_rope"}), the cache contribution."""
        B, S, _ = x.shape
        h = cfg.num_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        q_nope, q_rope = mla._queries(cfg, p, x, positions)
        c_kv, k_rope = mla._latent(cfg, p, x, positions)

        kv = linear(p["kv_up"], c_kv).reshape(B, S, h, dn + dv)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        k_rope_b = k_rope[:, :, None, :].expand(B, S, h, dr)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope_b], dim=-1)
        q = shard(q, "batch", "seq", "heads", None)
        k = shard(k, "batch", "seq", "heads", None)
        v = shard(v, "batch", "seq", "heads", None)

        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2),
                              scale=1.0 / math.sqrt(dn + dr), causal=True)
        out = out.transpose(1, 2).reshape(B, S, h * dv)
        return linear(p["wo"], out), {"c_kv": c_kv, "k_rope": k_rope}

    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
        return {
            "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device),
        }

    @staticmethod
    def decode(cfg: ModelConfig, p: nn.ModuleDict, x: torch.Tensor,
               cache: dict, pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Absorbed-matrix decode: score against the latent directly.
        x (B, 1, D); the cache updated in place at ``pos`` (a 0-dim
        integer tensor on x's device); returns (out, cache)."""
        B = x.shape[0]
        h = cfg.num_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        lora = cfg.kv_lora_rank
        positions = pos.to(torch.int32).reshape(1, 1).expand(B, 1)

        q_nope, q_rope = mla._queries(cfg, p, x, positions)  # (B, 1, h, .)
        c_new, kr_new = mla._latent(cfg, p, x, positions)
        row = pos.reshape(1).to(torch.int64)
        cache["c_kv"].index_copy_(1, row, c_new.to(cache["c_kv"].dtype))
        cache["k_rope"].index_copy_(1, row, kr_new.to(cache["k_rope"].dtype))
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]

        w_up = cast(p["kv_up"]["w"], x.dtype).reshape(lora, h, dn + dv)
        w_uk, w_uv = w_up[..., :dn], w_up[..., dn:]  # (lora, h, dn / dv)
        # Absorb W_UK into the query: (B,1,h,dn).(lora,h,dn) -> (B,h,lora)
        q_eff = torch.einsum("bohd,lhd->bhl", q_nope, w_uk)
        S = c_kv.shape[1]
        scale = 1.0 / math.sqrt(dn + dr)
        c32 = c_kv.float()
        scores = (torch.einsum("bhl,bsl->bhs", q_eff.float(), c32)
                  + torch.einsum("bohd,bsd->bhs", q_rope.float(),
                                 k_rope.float())) * scale
        live = (torch.arange(S, device=x.device) <= pos)[None, None, :]
        scores = torch.where(live, scores, torch.full_like(scores, _NEG_INF))
        w = torch.softmax(scores, dim=-1)
        lat_out = torch.einsum("bhs,bsl->bhl", w, c32)
        out = torch.einsum("bhl,lhd->bhd", lat_out, w_uv.float())
        out = out.reshape(B, 1, h * dv).to(x.dtype)
        return linear(p["wo"], out), cache

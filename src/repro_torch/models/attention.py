"""Attention mixers: GQA (with optional QKV bias); MLA waits.

The port's counterpart of ``repro/models/attention.py``.  ``gqa`` exposes
``init(cfg, gen, device)``, ``apply(cfg, p, x, positions)`` for prefill
(full sequence, causal) and ``decode(cfg, p, x, cache, pos)`` for one
token against a KV cache, with the reference's layouts: activations
(B, S, D), the cache (B, S, Hkv, Dh).

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
from repro_torch.models.common import (apply_rope, dense_init, dtype_of,
                                       linear, rope_cos_sin, shard)
from repro_torch.parallel.decode_attention import decode_attention

__all__ = ["gqa", "mla"]


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
    """DeepSeek-V2 multi-head latent attention: not ported yet."""

    NOT_PORTED = ("MLA (deepseek-v2-lite) is not ported yet: it comes with "
                  "the MLA slice (absorbed decode) of the model stack")

    @staticmethod
    def _missing(*_args, **_kw):
        raise NotImplementedError(mla.NOT_PORTED)

    init = apply = init_cache = decode = _missing

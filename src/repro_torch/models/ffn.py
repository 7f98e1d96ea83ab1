"""FFN layers: dense SwiGLU; the dropless MoE waits.

The port's counterpart of ``repro/models/ffn.py``.  ``moe_ffn`` raises
until the MoE slice, where ``lax.ragged_dot`` becomes a grouped GEMM.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, dtype_of, linear, shard

__all__ = ["dense_ffn", "moe_ffn"]


class dense_ffn:
    @staticmethod
    def init(cfg: ModelConfig, gen: torch.Generator | None, device,
             d_ff: int | None = None) -> nn.ModuleDict:
        d_ff = d_ff or cfg.d_ff
        kw = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        return nn.ModuleDict({
            "gate": dense_init(gen, cfg.d_model, d_ff, **kw),
            "up": dense_init(gen, cfg.d_model, d_ff, **kw),
            "down": dense_init(gen, d_ff, cfg.d_model,
                               scale=0.02 / math.sqrt(2 * cfg.num_layers), **kw),
        })

    @staticmethod
    def apply(cfg: ModelConfig, p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(linear(p["gate"], x)) * linear(p["up"], x)
        h = shard(h, "batch", "seq", "mlp")
        return linear(p["down"], h)


class moe_ffn:
    """Dropless mixture of experts: not ported yet."""

    NOT_PORTED = ("MoE FFN (qwen3-moe, jamba, deepseek-v2-lite) is not "
                  "ported yet: it comes with the MoE slice (dropless dispatch "
                  "as a grouped GEMM)")

    @staticmethod
    def _missing(*_args, **_kw):
        raise NotImplementedError(moe_ffn.NOT_PORTED)

    init = apply = route = _missing

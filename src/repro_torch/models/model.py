"""Model registry: config lookup and analytic parameter counts.

The port's counterpart of ``repro/models/model.py``.  ``input_specs`` and
``SHAPES`` serve the reference's dry-run and wait for the mesh slice.
"""

from __future__ import annotations

from repro_torch.configs import REGISTRY
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

__all__ = ["get_config", "list_archs", "count_params_analytic"]


def list_archs() -> list[str]:
    return sorted(REGISTRY)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    full, smoke_cfg = REGISTRY[name]
    return smoke_cfg if smoke else full


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from the port's own parameter shapes (built on the
    ``meta`` device, nothing allocated), every leaf the reference has: a
    Mamba2 mixer's float32 ``A_log`` / ``dt_bias`` / ``D`` included, no
    ``post_norm`` / ``ffn`` on a layer without an FFN.  ``active_only``
    scales the routed-expert tensors by top_k / num_experts (MoE
    6·N_active·D), as the reference does."""
    params = transformer.init_params(cfg, None, device="meta")
    total = 0.0
    for name, p in params.named_parameters():
        size = p.numel()
        if active_only and ".experts." in f".{name}.":
            size *= cfg.top_k / cfg.num_experts
        total += size
    return int(total)

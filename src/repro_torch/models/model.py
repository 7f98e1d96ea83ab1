"""Model registry: config lookup, analytic parameter counts, input specs.

The port's counterpart of ``repro/models/model.py``.  The reference's
``ShapeDtypeStruct`` stand-ins are tensors on the ``meta`` device here:
``abstract_params`` builds the model there and ``input_specs`` gives the
inputs of each (architecture x input-shape) cell, so the dry run
(``launch/dryrun.py``) runs a step without allocating anything.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs import REGISTRY
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.common import dtype_of

__all__ = ["get_config", "list_archs", "count_params_analytic", "SHAPES",
           "shape_applicable", "input_specs", "abstract_params"]

SHAPES: dict[str, dict[str, Any]] = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}


def list_archs() -> list[str]:
    return sorted(REGISTRY)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    full, smoke_cfg = REGISTRY[name]
    return smoke_cfg if smoke else full


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runnable, reason).  long_500k needs sub-quadratic attention: it
    runs for the SSM / hybrid families and is skipped for pure
    full-attention ones, in the reference's words."""
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, (
            "long_500k needs sub-quadratic sequence mixing; "
            f"{cfg.name} is pure full-attention ({cfg.family})"
        )
    return True, ""


def abstract_params(cfg: ModelConfig):
    """The parameters on the ``meta`` device (shapes and dtypes, nothing
    allocated)."""
    return transformer.init_params(cfg, None, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> dict[str, Any]:
    """``meta`` tensors standing for one (arch x shape) cell's inputs, in
    the reference's shapes and dtypes.

    train  -> {'batch': {...}, 'labels', 'loss_mask'}
    prefill-> {'batch': {...}, 'max_len'}
    decode -> {'caches', 'tokens', 'pos'} (one new token; the caches in
    the port's layout, ``transformer.init_decode_caches``)
    """
    info = SHAPES[shape]
    B, S = info["batch"], info["seq"]
    act = dtype_of(cfg.dtype)

    def spec(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    def token_batch(seq_len: int) -> dict:
        if cfg.modality == "audio_stub":
            return {"frame_embeds": spec((B, seq_len, cfg.d_model), act)}
        batch = {"tokens": spec((B, seq_len))}
        if cfg.modality == "vision_stub":
            text = seq_len - cfg.num_patches
            if text <= 0:
                raise ValueError(f"{seq_len} positions hold no text after "
                                 f"{cfg.num_patches} patches")
            batch["tokens"] = spec((B, text))
            batch["patch_embeds"] = spec((B, cfg.num_patches, cfg.d_model), act)
        return batch

    if info["kind"] == "train":
        labels = spec((B, S, cfg.num_codebooks) if cfg.num_codebooks else (B, S))
        return {"batch": token_batch(S), "labels": labels,
                "loss_mask": spec(labels.shape, torch.float32)}
    if info["kind"] == "prefill":
        return {"batch": token_batch(S), "max_len": S}
    # decode: the cache holds S positions; the step writes position S - 1.
    caches = transformer.init_decode_caches(cfg, B, S, device="meta")
    tok = (spec((B, 1, cfg.d_model), act) if cfg.modality == "audio_stub"
           else spec((B, 1)))
    return {"caches": caches, "tokens": tok, "pos": spec(())}


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from the port's own parameter shapes (built on the
    ``meta`` device, nothing allocated), every leaf the reference has: a
    Mamba2 mixer's float32 ``A_log`` / ``dt_bias`` / ``D`` included, no
    ``post_norm`` / ``ffn`` on a layer without an FFN.  ``active_only``
    scales the routed-expert tensors by top_k / num_experts (MoE
    6·N_active·D), as the reference does."""
    params = abstract_params(cfg)
    total = 0.0
    for name, p in params.named_parameters():
        size = p.numel()
        if active_only and ".experts." in f".{name}.":
            size *= cfg.top_k / cfg.num_experts
        total += size
    return int(total)

"""Decoder assembly: embeddings -> blocks -> head, with prefill and
cached decode, for the text configurations with GQA, MLA or Mamba2
mixers and dense, MoE or no FFNs.

The port's counterpart of ``repro/models/transformer.py``.  The
reference factors the layers into ``prefix + group × G`` and
``lax.scan``s the stacked group; the port keeps one ``nn.ModuleList`` of
layers (``params["layers"]``), each built from its ``LayerSpec``, and a
Python loop over it, which a CUDA graph of the decode step
(``launch/serve.py``) flattens as ``jax.jit`` flattens the scan.  Decode
caches are a list with one dict per layer (``{"k", "v"}`` for GQA,
``{"c_kv", "k_rope"}`` for MLA, both (B, max_len, ...); ``{"conv",
"ssm"}`` for Mamba2, states with no sequence axis).  ``decode_step``
updates them in place at a position that may be a device scalar (Mamba2
layers ignore it).  A layer whose ``LayerSpec.ffn`` is ``"none"`` (the
Mamba2 blocks) has no ``post_norm`` / ``ffn`` and no FFN residual, as in
the reference.  Every function also takes the parameters as
:func:`~repro_torch.models.common.cast_params` gives them.  ``moe_impl``
is threaded to the MoE layers as in the reference.

Ported layouts: every text configuration (internlm2-1.8b, olmo-1b,
mistral-nemo-12b, qwen1.5-110b, qwen3-moe-30b-a3b, deepseek-v2-lite-16b,
mamba2-370m, jamba-1.5-large-398b).  The vision/audio stubs raise
``NotImplementedError`` naming the slice that brings them; ``lm_loss``
and training wait for the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig, layer_layout
from repro_torch.device import resolve_device
from repro_torch.models.attention import gqa, mla
from repro_torch.models.common import (cast, dense_init, dtype_of, linear,
                                       norm_apply, normal, param,
                                       rmsnorm_init, shard)
from repro_torch.models.ffn import dense_ffn, moe_ffn
from repro_torch.models.ssm import mamba

__all__ = [
    "check_supported",
    "init_params",
    "forward",
    "init_decode_caches",
    "decode_step",
    "prefill",
]


_MIXERS = {"attn": gqa, "mla": mla, "mamba": mamba}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a text
    configuration."""
    if cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.modality} frontend is not ported yet; it "
            "comes with the modality-stub slice of the model stack")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(cfg: ModelConfig, spec: LayerSpec, gen,
                device) -> nn.ModuleDict:
    parametric = cfg.norm != "nonparametric_ln"
    dt = dtype_of(cfg.param_dtype)
    p = nn.ModuleDict({
        "pre_norm": rmsnorm_init(cfg.d_model, parametric, dt, device),
        "mixer": _MIXERS[spec.mixer].init(cfg, gen, device),
    })
    if spec.ffn != "none":
        ffn = moe_ffn if spec.ffn == "moe" else dense_ffn
        p["post_norm"] = rmsnorm_init(cfg.d_model, parametric, dt, device)
        p["ffn"] = ffn.init(cfg, gen, device)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator | None,
                device=None) -> nn.ModuleDict:
    """Random parameters drawn from ``gen`` (a ``torch.Generator`` on
    ``device``; ``None`` on the ``meta`` device, for shapes only).  The
    default device is the card (``resolve_device``): without one it
    raises unless the caller asks for ``"cpu"``."""
    check_supported(cfg)
    device = resolve_device(device)
    dt = dtype_of(cfg.param_dtype)
    table = normal((cfg.padded_vocab_size, cfg.d_model), gen, device, 0.02, dt)
    params = nn.ModuleDict({
        "embedding": nn.ParameterDict({"table": param(table)}),
        "final_norm": rmsnorm_init(cfg.d_model, cfg.norm != "nonparametric_ln",
                                   dt, device),
    })
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab_size,
                                       dtype=dt, device=device)
    params["layers"] = nn.ModuleList(
        _init_layer(cfg, spec, gen, device) for spec in layer_layout(cfg))
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _embed_inputs(cfg: ModelConfig, params: nn.ModuleDict,
                  tokens: torch.Tensor) -> torch.Tensor:
    # Gather, then cast: the same values as the reference's cast-then-
    # gather, without a cast copy of the whole table.
    x = params["embedding"]["table"][tokens.long()].to(dtype_of(cfg.dtype))
    return shard(x, "batch", "seq", "embed")


def _head(cfg: ModelConfig, params: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    x = norm_apply(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = x @ cast(params["embedding"]["table"], x.dtype).T
    else:
        logits = linear(params["lm_head"], x)
    return shard(logits, "batch", "seq", "vocab")


def _ffn(cfg: ModelConfig, spec: LayerSpec, p: nn.ModuleDict, x: torch.Tensor,
         moe_impl: str) -> tuple[torch.Tensor, torch.Tensor | float]:
    """The layer's FFN with its residual (none for ``"none"``); returns
    (x, aux loss)."""
    if spec.ffn == "none":
        return x, 0.0
    h = norm_apply(p["post_norm"], x)
    if spec.ffn == "dense":
        f, aux = dense_ffn.apply(cfg, p["ffn"], h), 0.0
    else:
        f, aux = moe_ffn.apply(cfg, p["ffn"], h, impl=moe_impl)
    return shard(x + f, "batch", "seq", "embed"), aux


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def forward(cfg: ModelConfig, params: nn.ModuleDict, batch: dict,
            moe_impl: str = "gspmd") -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss): the MoE layers'
    aux losses summed in float32 (0 without MoE layers)."""
    x = _embed_inputs(cfg, params, batch["tokens"])
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for spec, p in zip(layer_layout(cfg), params["layers"]):
        mix, _ = _MIXERS[spec.mixer].apply(cfg, p["mixer"],
                                           norm_apply(p["pre_norm"], x),
                                           positions)
        x, aux = _ffn(cfg, spec, p, shard(x + mix, "batch", "seq", "embed"),
                      moe_impl)
        aux_total = aux_total + aux
    return _head(cfg, params, x), aux_total


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with caches
# ---------------------------------------------------------------------------

def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       device=None) -> list[dict]:
    """One zeroed cache per layer in the activation dtype, on ``device``
    (the card by default): ``{"k", "v"}`` of (batch, max_len, Hkv, Dh) for
    GQA, ``{"c_kv", "k_rope"}`` of (batch, max_len, kv_lora_rank / rope)
    for MLA, ``mamba.init_cache``'s ``{"conv", "ssm"}`` for Mamba2 (the
    SSM state float32)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    return [mamba.init_cache(cfg, batch, dtype, device) if spec.mixer == "mamba"
            else _MIXERS[spec.mixer].init_cache(cfg, batch, max_len, dtype,
                                                device)
            for spec in layer_layout(cfg)]


def decode_step(cfg: ModelConfig, params: nn.ModuleDict, caches: list[dict],
                tokens: torch.Tensor, pos: int | torch.Tensor,
                moe_impl: str = "gspmd") -> tuple[torch.Tensor, list[dict]]:
    """One decoding step.  tokens (B, 1); ``pos`` the index being written,
    an int or a 0-dim integer tensor on the tokens' device.  Returns
    (logits (B, 1, V), caches), the caches updated in place."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int32, device=tokens.device)
    x = _embed_inputs(cfg, params, tokens)
    for spec, p, cache in zip(layer_layout(cfg), params["layers"], caches):
        mix, _ = _MIXERS[spec.mixer].decode(cfg, p["mixer"],
                                            norm_apply(p["pre_norm"], x),
                                            cache, pos)
        x, _ = _ffn(cfg, spec, p, x + mix, moe_impl)
    return _head(cfg, params, x), caches


def prefill(cfg: ModelConfig, params: nn.ModuleDict, batch: dict,
            max_len: int,
            moe_impl: str = "gspmd") -> tuple[torch.Tensor, list[dict]]:
    """Run the prompt through the model, filling decode caches.

    Returns (last-position logits (B, 1, V), caches): each attention
    layer's cache contribution (GQA's K/V, MLA's latent and rope key)
    written into a zeroed (B, max_len, ...) cache, each Mamba2 layer's
    final ``{"conv", "ssm"}`` states kept as they are, as the reference
    does.
    """
    x = _embed_inputs(cfg, params, batch["tokens"])
    B, S, _ = x.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len={max_len}")
    positions = _positions(B, S, x.device)
    dtype = dtype_of(cfg.dtype)
    caches = []
    for spec, p in zip(layer_layout(cfg), params["layers"]):
        mix, contrib = _MIXERS[spec.mixer].apply(
            cfg, p["mixer"], norm_apply(p["pre_norm"], x), positions)
        if spec.mixer == "mamba":
            caches.append(contrib)  # final states: conv in dtype, ssm float32
        else:
            cache = {}
            for name, t in contrib.items():
                buf = torch.zeros((B, max_len) + tuple(t.shape[2:]),
                                  dtype=dtype, device=t.device)
                buf[:, :S] = t
                cache[name] = buf
            caches.append(cache)
        x, _ = _ffn(cfg, spec, p, x + mix, moe_impl)
    return _head(cfg, params, x[:, -1:, :]), caches

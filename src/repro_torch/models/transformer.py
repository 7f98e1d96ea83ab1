"""Decoder assembly: embeddings -> blocks -> head, with prefill and
KV-cache decode, for the ``attn`` + ``dense`` text configurations.

The port's counterpart of ``repro/models/transformer.py``.  The
reference factors the layers into ``prefix + group × G`` and
``lax.scan``s the stacked group; the port keeps one ``nn.ModuleList`` of
layers (``params["layers"]``) and a Python loop over it, which a CUDA
graph of the decode step (``launch/serve.py``) flattens as ``jax.jit``
flattens the scan.  Decode caches are a list with one ``{"k", "v"}``
dict per layer.  ``decode_step`` updates them in place at a position
that may be a device scalar.  Every function also takes the parameters
as :func:`~repro_torch.models.common.cast_params` gives them.

Only layouts whose every layer is ``attn`` + ``dense`` in text modality
are ported (internlm2-1.8b, olmo-1b, mistral-nemo-12b, qwen1.5-110b).
MLA, MoE, Mamba2 and the vision/audio stubs raise ``NotImplementedError``
naming the slice that brings them; ``lm_loss`` and training wait for the
training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, layer_layout
from repro_torch.device import resolve_device
from repro_torch.models.attention import gqa, mla
from repro_torch.models.common import (cast, dense_init, dtype_of, linear,
                                       norm_apply, normal, param,
                                       rmsnorm_init, shard)
from repro_torch.models.ffn import dense_ffn, moe_ffn

__all__ = [
    "check_supported",
    "init_params",
    "forward",
    "init_decode_caches",
    "decode_step",
    "prefill",
]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``cfg`` is
    ``attn`` + ``dense`` in text modality."""
    if cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.modality} frontend is not ported yet; it "
            "comes with the modality-stub slice of the model stack")
    for spec in layer_layout(cfg):
        if spec.mixer == "mamba":
            raise NotImplementedError(
                f"{cfg.name}: Mamba2 layers are not ported yet; they come with "
                "the Mamba2 SSD slice of the model stack")
        if spec.mixer == "mla":
            raise NotImplementedError(f"{cfg.name}: {mla.NOT_PORTED}")
        if spec.ffn == "moe":
            raise NotImplementedError(f"{cfg.name}: {moe_ffn.NOT_PORTED}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(cfg: ModelConfig, gen, device) -> nn.ModuleDict:
    parametric = cfg.norm != "nonparametric_ln"
    dt = dtype_of(cfg.param_dtype)
    return nn.ModuleDict({
        "pre_norm": rmsnorm_init(cfg.d_model, parametric, dt, device),
        "mixer": gqa.init(cfg, gen, device),
        "post_norm": rmsnorm_init(cfg.d_model, parametric, dt, device),
        "ffn": dense_ffn.init(cfg, gen, device),
    })


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
        _init_layer(cfg, gen, device) for _ in layer_layout(cfg))
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


def _ffn(cfg: ModelConfig, p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    h = norm_apply(p["post_norm"], x)
    return x + dense_ffn.apply(cfg, p["ffn"], h)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def forward(cfg: ModelConfig, params: nn.ModuleDict,
            batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss); aux_loss is 0
    for the dense layouts of this slice."""
    x = _embed_inputs(cfg, params, batch["tokens"])
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    for p in params["layers"]:
        mix, _ = gqa.apply(cfg, p["mixer"], norm_apply(p["pre_norm"], x),
                           positions)
        x = _ffn(cfg, p, shard(x + mix, "batch", "seq", "embed"))
    return _head(cfg, params, x), torch.zeros((), dtype=torch.float32,
                                              device=x.device)


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with caches
# ---------------------------------------------------------------------------

def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       device=None) -> list[dict]:
    """One zeroed ``{"k", "v"}`` cache of (batch, max_len, Hkv, Dh) in the
    activation dtype per layer, on ``device`` (the card by default)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    return [gqa.init_cache(cfg, batch, max_len, dtype, device)
            for _ in layer_layout(cfg)]


def decode_step(cfg: ModelConfig, params: nn.ModuleDict, caches: list[dict],
                tokens: torch.Tensor,
                pos: int | torch.Tensor) -> tuple[torch.Tensor, list[dict]]:
    """One decoding step.  tokens (B, 1); ``pos`` the index being written,
    an int or a 0-dim integer tensor on the tokens' device.  Returns
    (logits (B, 1, V), caches), the caches updated in place."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int32, device=tokens.device)
    x = _embed_inputs(cfg, params, tokens)
    for p, cache in zip(params["layers"], caches):
        mix, _ = gqa.decode(cfg, p["mixer"], norm_apply(p["pre_norm"], x),
                            cache, pos)
        x = _ffn(cfg, p, x + mix)
    return _head(cfg, params, x), caches


def prefill(cfg: ModelConfig, params: nn.ModuleDict, batch: dict,
            max_len: int) -> tuple[torch.Tensor, list[dict]]:
    """Run the prompt through the model, filling decode caches.

    Returns (last-position logits (B, 1, V), caches): each layer's prompt
    K/V written into a zeroed (B, max_len, Hkv, Dh) cache, as the
    reference does.
    """
    x = _embed_inputs(cfg, params, batch["tokens"])
    B, S, _ = x.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len={max_len}")
    positions = _positions(B, S, x.device)
    dtype = dtype_of(cfg.dtype)
    caches = []
    for p in params["layers"]:
        mix, contrib = gqa.apply(cfg, p["mixer"], norm_apply(p["pre_norm"], x),
                                 positions)
        cache = {}
        for name, t in contrib.items():
            buf = torch.zeros((B, max_len) + tuple(t.shape[2:]), dtype=dtype,
                              device=t.device)
            buf[:, :S] = t
            cache[name] = buf
        caches.append(cache)
        x = _ffn(cfg, p, x + mix)
    return _head(cfg, params, x[:, -1:, :]), caches

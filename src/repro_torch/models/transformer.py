"""Decoder assembly: embeddings -> blocks -> head, with prefill and
cached decode and the training loss, for every configuration: GQA, MLA
or Mamba2 mixers, dense, MoE or no FFNs, text, patch or frame inputs.

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

Every configuration runs.  The modality stubs are the reference's:
``vision_stub`` (internvl2-26b) projects precomputed patch embeddings
(``batch["patch_embeds"]``, (B, P, D)) through ``patch_proj`` and puts them
before the text; ``audio_stub`` (musicgen-large) reads precomputed frame
embeddings (``batch["frame_embeds"]``, (B, S, D); a (B, 1, D) frame as
``decode_step``'s ``tokens``) and has ``num_codebooks`` parallel heads
``head{c}``, its logits (B, S, C, V).

Training: :func:`lm_loss` is the reference's masked next-token
cross-entropy.  With ``cfg.remat`` (the default, as the reference's
``nothing_saveable`` checkpoint of its scan body) and grad mode on,
:func:`forward` runs each layer under ``torch.utils.checkpoint``, so only
each layer's input is kept and the layer runs again in the backward
(its flash kernel launch too); the gradients are those without remat,
bit for bit.  The layer runs again under the sharding scope it ran under
first (``sharding.current_scope``: the mesh, so EP layers recompute per
shard too), whichever thread the backward recomputes it on.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig, layer_layout
from repro_torch.device import resolve_device
from repro_torch.models.attention import gqa, mla
from repro_torch.models.common import (cast, dense_init, dtype_of, linear,
                                       norm_apply, normal, param,
                                       rmsnorm_init, shard)
from repro_torch.models.ffn import dense_ffn, moe_ffn
from repro_torch.models.ssm import mamba
from repro_torch.parallel.sharding import current_scope, scope

__all__ = [
    "init_params",
    "forward",
    "lm_loss",
    "init_decode_caches",
    "decode_step",
    "prefill",
]


_MIXERS = {"attn": gqa, "mla": mla, "mamba": mamba}


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
    device = resolve_device(device)
    dt = dtype_of(cfg.param_dtype)
    table = normal((cfg.padded_vocab_size, cfg.d_model), gen, device, 0.02, dt)
    params = nn.ModuleDict({
        "embedding": nn.ParameterDict({"table": param(table)}),
        "final_norm": rmsnorm_init(cfg.d_model, cfg.norm != "nonparametric_ln",
                                   dt, device),
    })
    if not cfg.tie_embeddings:
        heads = ([f"head{c}" for c in range(cfg.num_codebooks)]
                 if cfg.num_codebooks else ["lm_head"])
        for name in heads:
            params[name] = dense_init(gen, cfg.d_model, cfg.padded_vocab_size,
                                      dtype=dt, device=device)
    if cfg.modality == "vision_stub":
        params["patch_proj"] = dense_init(gen, cfg.d_model, cfg.d_model,
                                          dtype=dt, device=device)
    params["layers"] = nn.ModuleList(
        _init_layer(cfg, spec, gen, device) for spec in layer_layout(cfg))
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _embed_tokens(cfg: ModelConfig, params: nn.ModuleDict,
                  tokens: torch.Tensor) -> torch.Tensor:
    # Gather, then cast: the same values as the reference's cast-then-
    # gather, without a cast copy of the whole table.
    return params["embedding"]["table"][tokens.long()].to(dtype_of(cfg.dtype))


def _embed_inputs(cfg: ModelConfig, params: nn.ModuleDict,
                  batch: dict) -> torch.Tensor:
    """Token / patch / frame embedding by modality (the stub frontends)."""
    act = dtype_of(cfg.dtype)
    if cfg.modality == "audio_stub":
        x = batch["frame_embeds"].to(act)
    else:
        x = _embed_tokens(cfg, params, batch["tokens"])
        if cfg.modality == "vision_stub" and "patch_embeds" in batch:
            patches = linear(params["patch_proj"], batch["patch_embeds"].to(act))
            x = torch.cat([patches, x], dim=1)
    return shard(x, "batch", "seq", "embed")


def _head(cfg: ModelConfig, params: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
    x = norm_apply(params["final_norm"], x)
    if cfg.num_codebooks:
        logits = torch.stack([linear(params[f"head{c}"], x)
                              for c in range(cfg.num_codebooks)], dim=2)
        return shard(logits, "batch", "seq", None, "vocab")  # (B, S, C, V)
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


def _layer(cfg: ModelConfig, spec: LayerSpec, p: nn.ModuleDict,
           x: torch.Tensor, positions: torch.Tensor,
           moe_impl: str) -> tuple[torch.Tensor, torch.Tensor | float]:
    """One block of the full-sequence forward; returns (x, aux loss)."""
    mix, _ = _MIXERS[spec.mixer].apply(cfg, p["mixer"],
                                       norm_apply(p["pre_norm"], x), positions)
    return _ffn(cfg, spec, p, shard(x + mix, "batch", "seq", "embed"),
                moe_impl)


def _scoped_layer(saved: tuple, *args):
    """:func:`_layer` under the sharding scope ``saved``: a checkpointed
    layer's recompute runs on autograd's thread."""
    with scope(saved):
        return _layer(*args)


def forward(cfg: ModelConfig, params: nn.ModuleDict, batch: dict,
            moe_impl: str = "gspmd") -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward of a batch dict (``tokens``; for the vision
    stub optionally ``patch_embeds``; for the audio stub ``frame_embeds``).
    Returns (logits, aux_loss): the MoE layers' aux losses summed in
    float32 (0 without MoE layers).  With ``cfg.remat`` and grad mode on
    each layer is checkpointed (see the module docstring)."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    saved = current_scope()
    for spec, p in zip(layer_layout(cfg), params["layers"]):
        if remat:
            x, aux = checkpoint(_scoped_layer, saved, cfg, spec, p, x,
                                positions, moe_impl, use_reentrant=False)
        else:
            x, aux = _layer(cfg, spec, p, x, positions, moe_impl)
        aux_total = aux_total + aux
    return _head(cfg, params, x), aux_total


def lm_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy (labels already shifted upstream),
    over (B, S, V) logits or the audio stub's (B, S, C, V) with (B, S, C)
    labels, in float32 with a logsumexp normalizer; ``mask`` (the labels'
    shape) weights each position, the mean taken over its sum (at least
    1).  The reference takes the label logit by a one-hot contraction so
    that the vocab axis stays sharded over its mesh; the port computes the
    logits whole (``shard_activation``), and a ``take_along_dim`` gather of the label logit is the same value
    without the (..., V) one-hot."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.take_along_dim(logits, labels.long()[..., None],
                                       dim=-1)[..., 0]
    nll = lse - label_logit
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


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
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    return [mamba.init_cache(cfg, batch, dtype, device) if spec.mixer == "mamba"
            else _MIXERS[spec.mixer].init_cache(cfg, batch, max_len, dtype,
                                                device)
            for spec in layer_layout(cfg)]


def decode_step(cfg: ModelConfig, params: nn.ModuleDict, caches: list[dict],
                tokens: torch.Tensor, pos: int | torch.Tensor,
                moe_impl: str = "gspmd") -> tuple[torch.Tensor, list[dict]]:
    """One decoding step.  tokens (B, 1), or for the audio stub the frame
    embedding (B, 1, D); ``pos`` the index being written, an int or a
    0-dim integer tensor on the tokens' device.  Returns (logits (B, 1, V)
    or (B, 1, C, V), caches), the caches updated in place."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int32, device=tokens.device)
    if cfg.modality == "audio_stub":
        x = tokens.to(dtype_of(cfg.dtype))
    else:
        x = _embed_tokens(cfg, params, tokens)
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

    ``batch`` as :func:`forward` takes it.  Returns (last-position
    logits (B, 1, V), or (B, 1, C, V) for the audio stub, caches): each attention
    layer's cache contribution (GQA's K/V, MLA's latent and rope key)
    written into a zeroed (B, max_len, ...) cache, each Mamba2 layer's
    final ``{"conv", "ssm"}`` states kept as they are, as the reference
    does.
    """
    x = _embed_inputs(cfg, params, batch)
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

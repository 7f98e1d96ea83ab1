"""Shared building blocks: inits, norms, rotary embeddings.

The port's counterpart of ``repro/models/common.py``.  Parameters are
``nn.ParameterDict``s with the reference's leaf names (``w``, ``b``,
``scale``) and layouts (a dense weight is (in, out)), gathered into
``nn.ModuleDict``s by the layer modules, so a carried JAX pytree maps
onto them name for name.  Parameters are made with ``requires_grad``
off, as serving wants them; ``train.train_step.init_train_state`` turns
it on for the floating leaves.  ``shard`` is
:func:`repro_torch.parallel.sharding.shard_activation`, the reference's
hook: it resolves a layout under a mesh and returns its input.

Layers compute in the activation dtype and read each weight through
:func:`cast`, which keeps one copy of a parameter in that dtype per
version of the parameter (``Tensor._version``, bumped by every in-place
update): the cast is made once, not on every call, and is the same
deterministic cast, so the outputs are bit-identical to casting on the
fly.  Under autograd a leaf that requires grad is cast with a plain
differentiable ``.to(dtype)`` instead, never from the cache, so the
gradient reaches the float32 master parameter.  :func:`cast_params`
gives a model's whole parameter tree in the cached form, the stable
buffers a captured decode step reads.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.parallel.sharding import shard_activation as shard

__all__ = [
    "dtype_of",
    "param",
    "normal",
    "dense_init",
    "cast",
    "cast_params",
    "linear",
    "rmsnorm_init",
    "norm_apply",
    "rope_cos_sin",
    "apply_rope",
    "shard",
]


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string (``"bfloat16"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def normal(shape, gen: torch.Generator | None, device, scale: float,
           dtype=torch.float32) -> torch.Tensor:
    """``scale`` times a float32 standard normal draw, cast to ``dtype``.
    On the ``meta`` device (shapes only) no generator is used."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    # In place: no second float32 temporary (an expert stack is 12.9 GB).
    return w.mul_(scale).to(dtype)


def dense_init(gen: torch.Generator | None, in_dim: int, out_dim: int, *,
               device, scale: float = 0.02, bias: bool = False,
               dtype=torch.float32) -> nn.ParameterDict:
    p = nn.ParameterDict({"w": param(normal((in_dim, out_dim), gen, device,
                                            scale, dtype))})
    if bias:
        p["b"] = param(torch.zeros((out_dim,), dtype=dtype, device=device))
    return p


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t.to(dtype)``, made once per version of ``t`` and kept on it;
    differentiable (and not cached) when ``t`` requires grad and grad
    mode is on."""
    if t.dtype == dtype:
        return t
    if t.requires_grad and torch.is_grad_enabled():
        return t.to(dtype)
    hit = getattr(t, "_cast_copy", None)
    if hit is not None and hit[0] == t._version and hit[1] == dtype:
        return hit[2]
    out = t.detach().to(dtype)
    t._cast_copy = (t._version, dtype, out)
    return out


# Subtrees and leaves cast_params keeps as they are: the MoE router, which
# computes in float32 (``moe_ffn.route``), and the Mamba mixer's float32
# A_log, dt_bias and D (``ssm.mamba``), as in the reference.
FLOAT32_KEYS = frozenset({"router", "A_log", "dt_bias", "D"})


def cast_params(params, dtype: torch.dtype):
    """A parameter tree (``nn.ModuleDict`` / ``ParameterDict`` /
    ``ModuleList``) as nested dicts and lists of :func:`cast` copies of
    its floating leaves; the layer functions read either form.  The
    entries named in ``FLOAT32_KEYS`` are kept as they are."""
    if isinstance(params, torch.Tensor):
        return cast(params, dtype) if params.is_floating_point() else params
    if isinstance(params, (nn.ModuleList, list, tuple)):
        return [cast_params(p, dtype) for p in params]
    return {k: (v if isinstance(v, torch.Tensor) else dict(v.items()))
            if k in FLOAT32_KEYS else cast_params(v, dtype)
            for k, v in params.items()}


def linear(p: nn.ParameterDict, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b), computing in x.dtype (params through :func:`cast`)."""
    y = x @ cast(p["w"], x.dtype)
    if "b" in p:
        y = y + cast(p["b"], x.dtype)
    return y


def rmsnorm_init(d: int, parametric: bool, dtype: torch.dtype,
                 device) -> nn.ParameterDict:
    if not parametric:
        return nn.ParameterDict()
    return nn.ParameterDict(
        {"scale": param(torch.ones((d,), dtype=dtype, device=device))})


def norm_apply(p: nn.ParameterDict, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: the variance accumulates in float32 (products of the
    activation dtype are exact there), the scale multiply stays in the
    activation dtype; ``nonparametric_ln`` layers carry no scale."""
    xf = x.float()
    var = (xf * xf).sum(dim=-1, keepdim=True) / x.shape[-1]
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    if "scale" in p:
        y = y * cast(p["scale"], x.dtype)
    return y


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2), float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) with cos/sin (..., S, 1, D/2) or broadcastable."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)



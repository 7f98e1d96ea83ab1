"""Mamba2 mixer via SSD (state-space duality).

The port's counterpart of ``repro/models/ssm.py``, with its names and
numerics.  The SSD is the reference's chunked formulation in plain
torch, as the reference's is plain XLA (no kernel):

  intra:  Y_diag = (C Bᵀ ⊙ L) · X          per chunk, (cl × cl) products
  states: S_c    = Σ decay · B X           per chunk
  inter:  S_{c+1} = exp(Σa) S_c + S_c'     a Python loop over chunks (the
                                           reference's linear ``lax.scan``)
  out:    Y_off  = C · S_prev · decay

Every multi-operand contraction of the reference is written as explicit
pairwise steps, so that the order of the products is the same on every
machine (``torch.einsum`` orders more than two operands by whatever
``opt_einsum`` is installed).  ``decode`` is the O(1) recurrent update on
the (B, H, P, N) state (``_ssd_step``); it updates ``cache["conv"]`` and
``cache["ssm"]`` in place, as ``gqa.decode`` updates its K/V, so a
captured decode step (``launch/serve.py``) reads and writes the same
buffers every replay.

Parameters are an ``nn.ParameterDict`` holding both the bare float32
tensors (``A_log``, ``dt_bias``, ``D``) and the sub-dicts (``in_proj``,
``conv``, ``ssm_norm``, ``out_proj``), so ``named_parameters()`` gives the
reference's leaf paths (``A_log``, ``in_proj.w``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (cast, dense_init, dtype_of, norm_apply,
                                       normal, param, shard)

__all__ = ["mamba"]


def _conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def _in_proj_dim(cfg: ModelConfig) -> int:
    # z | x | B | C | dt
    return 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """segsum(a)[..., i, j] = sum_{k=j+1..i} a_k for i >= j else -inf (the
    reference's cumsum-difference form)."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return ss.masked_fill(~mask, -math.inf)


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           state: torch.Tensor | None = None):
    """x (B, S, C), w (W, C), b (C,).  Returns (y, new_state (B, W-1, C)).

    The W taps are summed in float32 and rounded once to x's dtype, then
    the bias is added in x's dtype, as the reference's depthwise
    ``lax.conv`` (float32 accumulation) and its bias add round."""
    W = w.shape[0]
    Bsz, S, C = x.shape
    if state is None:
        state = torch.zeros((Bsz, W - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    wx = cast(w, x.dtype).float()
    acc = xp[:, :S].float() * wx[0]
    for k in range(1, W):
        acc = acc + xp[:, k:k + S].float() * wx[k]
    y = acc.to(x.dtype) + cast(b, x.dtype)
    # A copy, not a view: a view would keep all of xp alive in the cache.
    new_state = xp[:, S:].clone() if W > 1 else state
    return y, new_state


def _ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """SSD scan.  x (b,s,h,p); dt (b,s,h) post-softplus; A (h,) negative;
    B, C (b,s,g,n).  Returns (y (b,s,h,p) in x's dtype, final_state
    (b,h,p,n) float32).  ``s`` must be a multiple of ``min(chunk, s)``."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    cl = min(chunk, s)
    if s % cl:
        raise ValueError(f"the SSD takes a sequence of a multiple of its chunk "
                         f"{cl} tokens; got {s}")
    nc = s // cl

    a = (dt * A).float()  # (b,s,h) log-decay
    xdt = (x * dt[..., None]).float()  # x's dtype times float32: float32
    Bh = B.repeat_interleave(rep, dim=2).float()  # (b,s,h,n)
    Ch = C.repeat_interleave(rep, dim=2).float()

    # chunked views
    ac = a.reshape(b, nc, cl, h).permute(0, 3, 1, 2)  # (b,h,nc,cl)
    xc = xdt.reshape(b, nc, cl, h, p)
    Bc = Bh.reshape(b, nc, cl, h, n)
    Cc = Ch.reshape(b, nc, cl, h, n)

    a_cum = torch.cumsum(ac, dim=-1)  # (b,h,nc,cl)

    # 1. intra-chunk: C·Bᵀ over n, times L, then times X over s.
    L = torch.exp(_segsum(ac))  # (b,h,nc,cl,cl)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc) * L.transpose(1, 2)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xc)

    # 2. per-chunk end states: B times its decay to the chunk's end, then
    # times X over l.
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (b,h,nc,cl)
    chunk_states = torch.einsum(
        "bclhn,bclhp->bchpn", Bc * decay_states.permute(0, 2, 3, 1)[..., None],
        xc)

    # 3. inter-chunk recurrence (linear, as the reference's scan): the
    # state before each chunk, then the final state.
    total_decay = torch.exp(a_cum[..., -1])  # (b,h,nc)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev_states = torch.empty((b, nc, h, p, n), dtype=torch.float32,
                              device=x.device)
    for c in range(nc):
        prev_states[:, c] = state
        state = state * total_decay[:, :, c, None, None] + chunk_states[:, c]

    # 4. inter-chunk contribution to outputs: C times the state over n,
    # then times its decay.
    state_decay_out = torch.exp(a_cum)  # (b,h,nc,cl)
    y_off = (torch.einsum("bclhn,bchpn->bclhp", Cc, prev_states)
             * state_decay_out.permute(0, 2, 3, 1)[..., None])

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), state


def _ssd_step(state, x, dt, A, B, C, D):
    """One recurrent SSD step (the reference's decode update), all float32:
    state (b,h,p,n); x (b,h,p); dt (b,h) post-softplus; A, D (h,); B, C
    (b,h,n).  Returns (y (b,h,p) with the D skip, new state)."""
    da = torch.exp(dt * A[None, :])  # (b,h)
    Bx = (x * dt[..., None])[..., None] * B[:, :, None, :]  # (b,h,p,n)
    state = state * da[..., None, None] + Bx
    y = torch.einsum("bhpn,bhn->bhp", state, C) + D[None, :, None] * x
    return y, state


def _uniform(shape, gen: torch.Generator | None, device, lo: float,
             hi: float) -> torch.Tensor:
    """A float32 draw uniform in [lo, hi) (``lo + u·(hi - lo)``, as
    ``jax.random.uniform``); no generator on the ``meta`` device."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return u * (hi - lo) + lo


class mamba:
    @staticmethod
    def init(cfg: ModelConfig, gen: torch.Generator | None,
             device) -> nn.ParameterDict:
        dt = dtype_of(cfg.param_dtype)
        h = cfg.ssm_heads
        conv_ch = _conv_channels(cfg)
        in_proj = dense_init(gen, cfg.d_model, _in_proj_dim(cfg), dtype=dt,
                             device=device)
        conv = nn.ParameterDict({
            "w": param(normal((cfg.ssm_conv, conv_ch), gen, device, 0.02, dt)),
            "b": param(torch.zeros((conv_ch,), dtype=dt, device=device)),
        })
        # dt bias: inverse-softplus of dt values log-uniform in [1e-3, 1e-1]
        u = _uniform((h,), gen, device, 0.0, 1.0)
        dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
        # A_log, dt_bias and D stay float32 whatever param_dtype is, as in
        # the reference's init.
        return nn.ParameterDict({
            "in_proj": in_proj,
            "conv": conv,
            "A_log": param(torch.log(_uniform((h,), gen, device, 1.0, 16.0))),
            "dt_bias": param(dt_bias),
            "D": param(torch.ones((h,), dtype=torch.float32, device=device)),
            "ssm_norm": nn.ParameterDict({
                "scale": param(torch.ones((cfg.d_inner,), dtype=dt,
                                          device=device))}),
            "out_proj": dense_init(
                gen, cfg.d_inner, cfg.d_model,
                scale=0.02 / math.sqrt(2 * cfg.num_layers), dtype=dt,
                device=device),
        })

    @staticmethod
    def _split(cfg: ModelConfig, proj: torch.Tensor):
        di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
        z = proj[..., :di]
        xBC = proj[..., di:di + di + 2 * gn]
        dt_raw = proj[..., di + di + 2 * gn:]
        return z, xBC, dt_raw

    @staticmethod
    def apply(cfg: ModelConfig, p, x: torch.Tensor, positions,
              conv_state=None, ssm_state=None) -> tuple[torch.Tensor, dict]:
        """Full-sequence SSD.  Returns (out, {"conv", "ssm"}): the final
        conv window in x's dtype and the final state in float32 (what
        prefill keeps as the layer's cache)."""
        Bsz, S, _ = x.shape
        di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        proj = x @ cast(p["in_proj"]["w"], x.dtype)
        z, xBC, dt_raw = mamba._split(cfg, proj)
        xBC = shard(xBC, "batch", "seq", "mlp")

        xBC, new_conv = _causal_depthwise_conv(
            xBC, p["conv"]["w"], p["conv"]["b"], conv_state)
        xBC = F.silu(xBC)
        xs = xBC[..., :di].reshape(Bsz, S, h, di // h)
        Bm = xBC[..., di:di + g * n].reshape(Bsz, S, g, n)
        Cm = xBC[..., di + g * n:].reshape(Bsz, S, g, n)

        dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None, :])
        A = -torch.exp(p["A_log"])
        y, final_state = _ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk,
                                      initial_state=ssm_state)
        y = y + (p["D"][:, None] * xs.float()).to(y.dtype)
        y = y.reshape(Bsz, S, di)
        y = norm_apply(p["ssm_norm"], y * F.silu(z))
        y = shard(y, "batch", "seq", "mlp")
        out = y @ cast(p["out_proj"]["w"], x.dtype)
        return out, {"conv": new_conv, "ssm": final_state}

    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
        """Zeroed states: the conv window (batch, W-1, conv channels) in
        ``dtype``, the SSM state (batch, H, P, N) in float32.  Neither has
        a sequence axis."""
        return {
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, _conv_channels(cfg)),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), dtype=torch.float32,
                               device=device),
        }

    @staticmethod
    def decode(cfg: ModelConfig, p, x: torch.Tensor, cache: dict,
               pos) -> tuple[torch.Tensor, dict]:
        """Single-step recurrent update.  x (B, 1, D); ``pos`` is unused
        (the state carries the history).  The cache's ``conv`` and ``ssm``
        are updated in place; returns (out, cache)."""
        Bsz = x.shape[0]
        di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        ph = di // h
        proj = x @ cast(p["in_proj"]["w"], x.dtype)
        z, xBC, dt_raw = mamba._split(cfg, proj)

        xBC, new_conv = _causal_depthwise_conv(
            xBC, p["conv"]["w"], p["conv"]["b"], cache["conv"])
        xBC = F.silu(xBC[:, -1:, :])  # current step only
        xs = xBC[:, 0, :di].reshape(Bsz, h, ph).float()
        Bm = xBC[:, 0, di:di + g * n].reshape(Bsz, g, n).float()
        Cm = xBC[:, 0, di + g * n:].reshape(Bsz, g, n).float()
        Bm = Bm.repeat_interleave(h // g, dim=1)  # (B,h,n)
        Cm = Cm.repeat_interleave(h // g, dim=1)

        dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"][None, :])  # (B,h)
        A = -torch.exp(p["A_log"])  # (h,)
        y, state = _ssd_step(cache["ssm"], xs, dt, A, Bm, Cm, p["D"])
        y = y.reshape(Bsz, 1, di).to(x.dtype)
        y = norm_apply(p["ssm_norm"], y * F.silu(z))
        out = y @ cast(p["out_proj"]["w"], x.dtype)
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(state)
        return out, cache

"""Optimizers: AdamW with optional int8 moment quantization, global-norm
clipping, and warmup + cosine schedules.

The port's counterpart of ``repro/train/optimizer.py``.  Memory a
parameter: float32 master 4 B, its float32 gradient 4 B, and with
``quantized=True`` the moments as int8 codes in the parameter's own shape
plus one float32 scale per last-dim row (about 2 B, against 8 B for
float32 moments).  Compute casts the parameters to the activation dtype
on the fly (``models.common.cast``), so no second copy is kept.

Codecs (as the reference's): the first moment on a SIGNED log grid
(sign and 127 log-spaced magnitudes over 7 decades), the second moment
stored as sqrt(nu) on an UNSIGNED log grid of 255 magnitudes; a value is
coded as the grid point whose midpoints bracket its ratio to the row's
abs-max.  The tables are ``exp(linspace(log 1e-7, 0, n))`` in float32,
computed here on the host: the linspace as XLA evaluates the reference's
(``start * (1 - i * (1 / (n - 1)))``, bit-equal to it), the exp in float64
rounded to float32.  XLA's float32 ``exp`` is not correctly rounded: the
reference's table differs from this one by one unit in the last place at
``ULOG_XLA_ULP`` / ``SLOG_XLA_ULP`` (entries of the table with its leading
0), and nowhere else; a ratio that falls between the two packages'
midpoints there takes neighbouring codes.

``update`` works on a large leaf in blocks of rows (``UPDATE_BLOCK``; the
scales are per row, so this is exact): one update of internvl2's 569
M-element embedding table would otherwise hold some ten float32
temporaries of it (over 20 GB).  It writes the parameters and the moments in place under
``torch.no_grad()``; that bumps each parameter's ``_version``, which is
what keeps ``cast``'s per-version copies honest.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.train.tree import named_leaves

__all__ = ["adamw", "Schedule", "warmup_cosine", "global_norm",
           "clip_by_global_norm", "AdamWState", "Optimizer", "log_table",
           "ULOG_XLA_ULP", "SLOG_XLA_ULP", "UPDATE_BLOCK"]

# Entries (with the table's leading 0) where the reference's XLA-computed
# table is one ulp off this one (tests/test_torch_train.py holds that).
ULOG_XLA_ULP = (23, 39, 42, 51, 52, 74, 75, 88, 95, 101, 115, 118, 126, 128,
                139, 171, 195, 197, 207, 217, 226, 229, 237, 239, 240, 241)
SLOG_XLA_ULP = (15, 34, 39, 49, 50, 60, 64, 65, 83, 85, 102, 103)
# Elements of a leaf updated at once, by device type: on the card large
# blocks (fewer launches; some ten float32 temporaries of 64 MB), on the
# CPU blocks whose temporaries stay in cache (half the time of 16 M).
UPDATE_BLOCK = {"cuda": 1 << 24, "cpu": 1 << 20}
# Leaf names that take no weight decay: norms, biases, the SSM's 1-D
# parameters (the reference's ``_decayable``).
_NO_DECAY = ("scale", "b", "A_log", "dt_bias", "D")


def log_table(n: int) -> np.ndarray:
    """[0, exp(linspace(log 1e-7, 0, n))] in float32 (see the module
    docstring)."""
    f32 = np.float32
    div = n - 1
    start = f32(np.log(f32(1e-7)))
    step = np.arange(div, dtype=f32) * (f32(1) / f32(div))
    lin = np.concatenate([start * (f32(1) - step), np.zeros(1, f32)])
    return np.concatenate([np.zeros(1, f32),
                           np.exp(lin.astype(np.float64)).astype(f32)])


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """The codec tables and their midpoints on ``device``."""
    out = {}
    for name, n in (("u", 255), ("s", 127)):
        table = torch.from_numpy(log_table(n))
        out[name] = table.to(device)
        out[name + "_mids"] = ((table[1:] + table[:-1]) / 2.0).to(device)
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = [t for _, t in named_leaves(tree)]
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in leaves))


def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf of ``tree`` by min(1, max_norm / norm) IN PLACE and
    return (tree, the float32 norm).  The reference returns a new tree;
    a train step's gradients are its own, and a second copy of them (17 GB
    for internvl2's first 8 layers) would not fit beside them."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for _, g in named_leaves(tree):
        g.mul_(scale.to(g.dtype))
    return tree, norm


def _row_scale(x: torch.Tensor) -> torch.Tensor:
    """abs-max over the last dim (a scalar for 0/1-D parameters)."""
    if x.dim() == 0:
        return torch.abs(x)
    return torch.amax(torch.abs(x), dim=-1)


def _ratio(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return x / (safe[..., None] if x.dim() else safe)


def _quantize_signed(x: torch.Tensor):
    """float32 parameter-shaped -> (int8 codes of the same shape, float32
    row scales): |q| <= 127 indexes the magnitude table."""
    scale = _row_scale(x)
    mag = torch.searchsorted(_tables(x.device)["s_mids"],
                             _ratio(torch.abs(x), scale).contiguous())
    q = torch.where(x < 0, -mag, mag).to(torch.int8)
    return q, scale


def _dequantize_signed(q: torch.Tensor, scale: torch.Tensor,
                       shape) -> torch.Tensor:
    mag = _tables(q.device)["s"][torch.abs(q.to(torch.int32))]
    sgn = torch.sign(q.float())
    s = scale[..., None] if len(shape) else scale
    return (sgn * mag * s).reshape(shape)


def _quantize_log_unsigned(x: torch.Tensor):
    """Non-negative float32 parameter-shaped -> (uint8 codes, float32 row
    scales)."""
    scale = _row_scale(x)
    q = torch.searchsorted(_tables(x.device)["u_mids"],
                           _ratio(x, scale).contiguous()).to(torch.uint8)
    return q, scale


def _dequantize_log_unsigned(q: torch.Tensor, scale: torch.Tensor,
                             shape) -> torch.Tensor:
    s = scale[..., None] if len(shape) else scale
    return (_tables(q.device)["u"][q.to(torch.int32)] * s).reshape(shape)


@dataclass(frozen=True)
class Schedule:
    base_lr: float
    warmup_steps: int
    total_steps: int
    min_ratio: float = 0.1

    def __call__(self, step) -> torch.Tensor:
        """The learning rate at ``step`` (an int or an integer tensor), a
        float32 tensor on the step's device."""
        step = torch.as_tensor(step).to(torch.float32)
        warm = self.base_lr * step / max(self.warmup_steps, 1)
        progress = torch.clamp(
            (step - self.warmup_steps)
            / max(self.total_steps - self.warmup_steps, 1), 0.0, 1.0)
        cos = self.base_lr * (
            self.min_ratio
            + (1 - self.min_ratio) * 0.5 * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < self.warmup_steps, warm, cos)


def warmup_cosine(base_lr: float, warmup: int, total: int) -> Schedule:
    return Schedule(base_lr, warmup, total)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-dim, on the parameters' device
    mu: dict  # leaf name -> float32 moment, or {"q": int8, "s": scales}
    nu: dict  # leaf name -> float32 moment, or {"q": uint8 of sqrt, "s"}


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], AdamWState]
    update: Callable[[Any, AdamWState, Any, Any], tuple[Any, AdamWState]]


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as (rows, last dim): a 0/1-D tensor is one row."""
    return t.reshape(1, -1) if t.dim() <= 1 else t.reshape(-1, t.shape[-1])


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, quantized: bool = False) -> Optimizer:
    """AdamW; ``quantized=True`` stores the moments as int8 codes.

    ``init(params)`` and ``update(grads, state, params, lr)`` take the
    parameters as a tree (:mod:`repro_torch.train.tree`: a model's
    ``nn.ModuleDict`` or nested dicts of tensors) and the gradients as the
    same tree or a dict by leaf name (the dotted path); the state's
    moments are dicts by leaf name.  ``update`` writes the parameters and
    moments in place and returns (params, new state)."""

    def init(params) -> AdamWState:
        mu, nu = {}, {}
        device = None
        for path, p in named_leaves(params):
            device = p.device
            zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            name = ".".join(path)
            if quantized:
                qm, sm = _quantize_signed(zeros)
                qn, sn = _quantize_log_unsigned(zeros)  # stores sqrt(nu)
                mu[name], nu[name] = {"q": qm, "s": sm}, {"q": qn, "s": sn}
            else:
                mu[name], nu[name] = zeros, zeros.clone()
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          mu, nu)

    @torch.no_grad()
    def update(grads, state: AdamWState, params, lr) -> tuple[Any, AdamWState]:
        step = state.step + 1
        t = step.to(torch.float32)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        gs = {".".join(path): g for path, g in named_leaves(grads)}
        for path, p in named_leaves(params):
            name = ".".join(path)
            decay = weight_decay and path[-1] not in _NO_DECAY
            _update_leaf(p, gs[name], state.mu[name], state.nu[name],
                         bc1, bc2, lr, decay)
        return params, AdamWState(step, state.mu, state.nu)

    def _update_leaf(p, g, mu, nu, bc1, bc2, lr, decay) -> None:
        if not p.is_contiguous():
            raise ValueError("adamw updates contiguous parameters in place")
        p2, g2 = _rows(p), _rows(g)
        if quantized:
            mq, nq = _rows(mu["q"]), _rows(nu["q"])
            ms, ns = mu["s"].reshape(-1), nu["s"].reshape(-1)
        else:
            m2, n2 = _rows(mu), _rows(nu)
        block = UPDATE_BLOCK.get(p.device.type, UPDATE_BLOCK["cuda"])
        rows = max(1, block // max(p2.shape[1], 1))
        for r0 in range(0, p2.shape[0], rows):
            blk = slice(r0, r0 + rows)
            gb = g2[blk].to(torch.float32)
            shape = gb.shape
            if quantized:
                mu_f = _dequantize_signed(mq[blk], ms[blk], shape)
                u = _dequantize_log_unsigned(nq[blk], ns[blk], shape)
                nu_f = u * u  # stored as sqrt(nu)
            else:
                mu_f, nu_f = m2[blk], n2[blk]
            mu_f = b1 * mu_f + (1 - b1) * gb
            nu_f = b2 * nu_f + (1 - b2) * gb * gb
            upd = (mu_f / bc1) / (torch.sqrt(nu_f / bc2) + eps)
            pb = p2[blk].to(torch.float32)
            if decay:
                upd = upd + weight_decay * pb
            p2[blk] = (pb - lr * upd).to(p.dtype)
            if quantized:
                mq[blk], ms[blk] = _quantize_signed(mu_f)
                nq[blk], ns[blk] = _quantize_log_unsigned(torch.sqrt(nu_f))
            else:
                m2[blk], n2[blk] = mu_f, nu_f

    return Optimizer(init=init, update=update)

"""Train step assembly: loss, gradients, (optional) cross-pod gradient
compression, clipping, optimizer update.

The port's counterpart of ``repro/train/train_step.py``.  The loss is
``lm_loss + aux`` (the MoE layers' aux loss), its gradients come from
autograd (float32 for float32 master parameters; on the card the
attention forward is the flash kernel and its gradient the plain
version's, ``kernels/flash_attention/ops.py``), a parameter the loss does
not reach (the audio stub's token table) gets a zero gradient as
``jax.grad`` gives it, and ``optimizer.update`` writes the parameters in
place.  ``grad_accum > 1`` runs the batch as that many microbatches,
summing their gradients in float32 in the reference's order and scaling
by ``1 / grad_accum``.

The model mesh.  The step runs under the mesh given to
``build_train_step(mesh=)``, or else under the one active when it is
called (``mesh_context``), as the reference reads ``current_mesh()``.
The parameters, optimizer state and batch sit whole on the mesh's first
device (:func:`state_shardings`, :func:`place_state`), so dense layers
compute whole there (``shard_activation``); what runs per shard is what
the reference runs under ``shard_map``: EP's MoE layers
(``moe_impl="ep"``: each shard's tokens through its experts, forward and
backward) and the compression cell below.

Compression (``"int8_ef"``) on a mesh with a ``"pod"`` axis: the batch is
split pod-major, ``(npods, B / npods, ...)``, and each pod's block runs
forward and backward on that pod's device (``mesh.axis_devices("pod")``)
under ``manual_axes_scope({"pod"})``, as the reference vmaps its grad
function over the pod axis.  As soon as a pod's backward ends, each
gradient leaf goes through :func:`compress_residual` (row-wise linear int8
codes of ``g + e`` with ``scale = max|g + e| / 127``, the new residual
``e`` kept), and only the running sums stay: the codes in int32 and the
scales in float32, in pod order on the first device.  So one pod's
float gradients are alive at a time.  The step then takes ``avg = q_sum *
(s_sum / npods) / npods`` (the reference's ``_compress_psum_pod``),
clips, and updates once; its metrics are the mean over pods.  Without a
``"pod"`` axis ``"int8_ef"`` is a no-op and its residuals stay zero.

Deliberate divergence: the reference keeps one parameter-shaped residual
and declares the cell's new residual replicated (its ``out_specs=P()``
with ``check=False``), so each pod's devices go on with their own
residual but a host read or a checkpoint sees only the first device's.
The port keeps one residual per pod (``err_fb`` is a list, pod ``p``'s
on its pod's device) and checkpoints all of them.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import canonical_device, resolve_device
from repro_torch.models import transformer
from repro_torch.parallel.sharding import (NamedSharding, P,
                                           apply_named_sharding, current_mesh,
                                           manual_axes_scope, mesh_context,
                                           place, record_collective)
from repro_torch.train.optimizer import (AdamWState, Optimizer, Schedule,
                                         clip_by_global_norm)
from repro_torch.train.tree import by_dotted_name, map_leaves, named_leaves

__all__ = ["TrainState", "init_train_state", "build_train_step",
           "batch_to_device", "compress_residual", "state_shardings",
           "place_state"]


class TrainState(NamedTuple):
    params: Any  # the model's nn.ModuleDict, floating leaves requiring grad
    opt_state: AdamWState
    err_fb: Any | None  # error-feedback buffers (compression only)


def trainable(params):
    """Turn ``requires_grad`` on for every floating parameter; returns
    ``params``."""
    for p in params.parameters():
        if p.is_floating_point():
            p.requires_grad_(True)
    return params


def _pods(mesh) -> list[torch.device] | None:
    """The device of each pod of ``mesh``, or None without a pod axis."""
    if mesh is None or "pod" not in mesh.shape:
        return None
    return [canonical_device(d) for d in mesh.axis_devices("pod")]


def _zero_residuals(params, device=None) -> dict:
    return {name: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device if device is None else device)
            for name, p in params.named_parameters()}


def init_train_state(cfg: ModelConfig, optimizer: Optimizer,
                     gen: torch.Generator | None, compression: str | None = None,
                     device=None, params=None, mesh=None) -> TrainState:
    """Parameters drawn from ``gen`` on ``device`` (the card by default),
    or the given ``params``, made trainable, with the optimizer's state
    and, for ``"int8_ef"``, zeroed error-feedback buffers: one dict by
    parameter name, or on a mesh (``mesh``, else the active one) with a
    ``"pod"`` axis a list of them, pod ``p``'s on its pod's device."""
    if params is None:
        params = transformer.init_params(cfg, gen, device=resolve_device(device))
    params = trainable(params)
    err = None
    if compression == "int8_ef":
        pods = _pods(mesh if mesh is not None else current_mesh())
        err = (_zero_residuals(params) if pods is None
               else [_zero_residuals(params, d) for d in pods])
    return TrainState(params, optimizer.init(params), err)


def state_shardings(state: TrainState, mesh) -> TrainState:
    """Where each leaf of ``state`` lives on ``mesh``, as a state-shaped
    tree of :class:`NamedSharding`: the parameters by
    ``apply_named_sharding``, each moment as its parameter (its row
    scales without the last dim), the step replicated, as the reference's
    dry run builds them; a residual replicated over its pod's slice of
    the mesh (``mesh.take("pod", p)``).  The port keeps each leaf whole
    on its sharding's first device (``sharding.home_device``)."""
    params = apply_named_sharding(state.params, mesh)

    def moment(name, m):
        psh = params[name]
        if not isinstance(m, dict):
            return psh
        return {"q": psh, "s": NamedSharding(mesh, P(*psh.spec[:-1]))}

    opt = AdamWState(NamedSharding(mesh, P()),
                     {n: moment(n, m) for n, m in state.opt_state.mu.items()},
                     {n: moment(n, m) for n, m in state.opt_state.nu.items()})
    err = state.err_fb
    if isinstance(err, dict):
        err = {n: NamedSharding(mesh, P()) for n in err}
    elif err is not None:
        err = [{n: NamedSharding(mesh.take("pod", p), P()) for n in e}
               for p, e in enumerate(err)]
    return TrainState(params, opt, err)


def place_state(state: TrainState, shardings: TrainState) -> TrainState:
    """``state`` with every leaf on its sharding's home device (the
    parameters moved in place; nothing moves that is there already)."""
    where = by_dotted_name(shardings)
    return map_leaves(state, lambda path, t: place(t, where.get(".".join(path))))


def batch_to_device(batch: dict, device) -> dict:
    """A pipeline batch (nested dicts of numpy arrays) as tensors on
    ``device``."""
    return {k: batch_to_device(v, device) if isinstance(v, dict)
            else torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _loss(cfg: ModelConfig, params, batch: dict, moe_impl: str):
    logits, aux = transformer.forward(cfg, params, batch["batch"], moe_impl)
    loss = transformer.lm_loss(cfg, logits, batch["labels"],
                               batch.get("loss_mask"))
    return loss + aux, loss, aux


def _take_grad(p: torch.Tensor) -> torch.Tensor:
    """``p``'s gradient, cleared from it; zeros where the loss does not
    reach ``p``."""
    g = p.grad if p.grad is not None else torch.zeros_like(p)
    p.grad = None
    return g


def _micro(batch: dict, i: int, n: int, device=None) -> dict:
    """Microbatch ``i`` of ``n`` along the leading axis of every leaf (on
    ``device`` if given)."""
    return {k: _micro(v, i, n, device) if isinstance(v, dict)
            else _to(v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)],
                     device)
            for k, v in batch.items()}


def _to(t: torch.Tensor, device) -> torch.Tensor:
    return t if device is None else t.to(device)


def _pod_params(params, device, home):
    """What the pod on ``device`` differentiates: the model itself on its
    own device ``home``, else a replica on ``device``."""
    return params if device == home else _replica(params, device)


def _replica(params, device):
    """``params`` copied to ``device`` as a tree of leaf tensors (what a
    pod on another device differentiates)."""
    if isinstance(params, torch.Tensor):
        return params.detach().to(device).requires_grad_(params.requires_grad)
    if isinstance(params, (nn.ModuleList, list)):
        return [_replica(m, device) for m in params]
    return {k: _replica(m, device) for k, m in params.items()}


def compress_residual(g: torch.Tensor, e: torch.Tensor):
    """One gradient leaf of one pod through the compression cell (the
    per-pod half of the reference's ``_compress_psum_pod``): ``gf = g +
    e`` in float32, the row scale ``max|gf| / 127`` over the last dim
    (``|gf| / 127`` for a 0-d leaf), ``safe`` = the scale where positive,
    else 1, the codes ``clip(round_half_even(gf / safe), -127, 127)`` as
    int8, each division IEEE's on either device (so the card's cell is
    bit-equal to the CPU's).  The new residual ``gf - q * safe`` is
    written into ``e``.  Returns (q, safe)."""
    gf = g.to(torch.float32) + e
    amax = (torch.amax(torch.abs(gf), dim=-1, keepdim=True) if gf.dim()
            else torch.abs(gf))
    # A tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, one rounding off IEEE division.
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(gf / safe), -127, 127).to(torch.int8)
    e.copy_(gf - q.to(torch.float32) * safe)
    return q, safe


def build_train_step(cfg: ModelConfig, optimizer: Optimizer,
                     schedule: Schedule, *, moe_impl: str = "gspmd",
                     clip_norm: float = 1.0, compression: str | None = None,
                     grad_accum: int = 1, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` is a pipeline batch (``{"batch": {...}, "labels",
    "loss_mask"}``) of tensors on the parameters' device
    (:func:`batch_to_device`).  The state is updated in place and
    returned; ``metrics`` holds float32 0-dim tensors ``loss``,
    ``aux_loss``, ``grad_norm`` (before clipping) and ``lr``.  Its
    attributes are its two halves: ``grads_and_metrics(params, batch)``
    gives (the unclipped gradients by parameter name, the loss metrics)
    and leaves the parameters untouched; ``apply_gradients(state, grads,
    metrics)`` clips the gradients in place and updates the state.

    ``mesh``: the step runs under it (see the module docstring); None
    takes the mesh active at each call, if any."""
    if compression not in (None, "int8_ef"):
        raise ValueError(f"unknown compression {compression!r}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum}")

    def grads_and_metrics(params, batch):
        """``params`` is the model or a tree of its leaves (a pod's replica)."""
        named = [(".".join(path), p) for path, p in named_leaves(params)]
        for _, p in named:
            p.grad = None
        if grad_accum == 1:
            total, loss, aux = _loss(cfg, params, batch, moe_impl)
            total.backward()
            grads = {name: _take_grad(p) for name, p in named}
            return grads, {"loss": loss.detach(),
                           "aux_loss": torch.as_tensor(aux).detach().float()}
        # float32 sums over the microbatches, from zero, as the reference.
        grads = {name: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for name, p in named}
        loss_sum = aux_sum = 0.0
        for i in range(grad_accum):
            total, loss, aux = _loss(cfg, params, _micro(batch, i, grad_accum),
                                     moe_impl)
            total.backward()
            for name, p in named:
                grads[name] += _take_grad(p).to(torch.float32)
            loss_sum = loss_sum + loss.detach()
            aux_sum = aux_sum + torch.as_tensor(aux).detach().float()
        inv = 1.0 / grad_accum
        for g in grads.values():
            g.mul_(inv)
        return grads, {"loss": loss_sum * inv, "aux_loss": aux_sum * inv}

    def pod_grads_and_metrics(params, batch, err_fb, pods):
        """int8_ef across ``pods``: each pod's block forward and backward
        on its device, its gradients compressed as soon as they exist
        (``err_fb[p]`` updated in place); returns (the decoded average
        gradients by name on the parameters' device, the mean metrics)."""
        n = len(pods)
        home = canonical_device(next(params.parameters()).device)
        q_sum, s_sum, mets = {}, {}, []
        with manual_axes_scope({"pod"}):
            for p, dev in enumerate(pods):
                tree = _pod_params(params, dev, home)
                grads, met = grads_and_metrics(tree, _micro(batch, p, n, dev))
                mets.append(met)
                for name in list(grads):
                    q, safe = compress_residual(grads.pop(name), err_fb[p][name])
                    q, safe = q.to(home, torch.int32), safe.to(home)
                    if p == 0:
                        q_sum[name], s_sum[name] = q, safe
                    else:
                        q_sum[name] += q
                        s_sum[name] = s_sum[name] + safe
                del grads, tree
        avg = {}
        for name in list(q_sum):
            q, s = q_sum.pop(name), s_sum.pop(name)
            record_collective("all-reduce", "pod", q.numel() * 4, n)
            record_collective("all-reduce", "pod", s.numel() * 4, n)
            avg[name] = q.to(torch.float32) * (s / n) / n
        metrics = {k: sum(m[k].to(home) for m in mets) / n for k in mets[0]}
        return avg, metrics

    def apply_gradients(state: TrainState, grads: dict, metrics: dict):
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = schedule(state.opt_state.step)
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params, lr)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(params, opt_state, state.err_fb), metrics

    def run(state: TrainState, batch: dict):
        pods = _pods(current_mesh()) if compression == "int8_ef" else None
        if pods is None:
            return apply_gradients(state, *grads_and_metrics(state.params,
                                                             batch))
        err = state.err_fb
        if not isinstance(err, list) or len(err) != len(pods):
            raise ValueError(
                f"int8_ef on {len(pods)} pods needs one residual per pod: "
                "make the state with init_train_state(mesh=) or under the "
                "mesh's mesh_context")
        grads, metrics = pod_grads_and_metrics(state.params, batch, err, pods)
        return apply_gradients(state, grads, metrics)

    def train_step(state: TrainState, batch: dict):
        if mesh is None:
            return run(state, batch)
        with mesh_context(mesh):
            return run(state, batch)

    train_step.grads_and_metrics = grads_and_metrics
    train_step.apply_gradients = apply_gradients
    return train_step

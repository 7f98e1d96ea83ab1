"""Train step assembly: loss, gradients, clipping, optimizer update.

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

Compression: the reference's ``"int8_ef"`` compresses pod-local
gradients across the pods of a multi-pod mesh and is a no-op without one
(the error-feedback buffers stay zero).  The port's model mesh serves
but does not train yet (ROADMAP queue 1 item 2), so ``"int8_ef"`` is
that no-op here, and asking for a mesh raises.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.train.optimizer import (AdamWState, Optimizer, Schedule,
                                         clip_by_global_norm)

__all__ = ["TrainState", "init_train_state", "build_train_step",
           "batch_to_device", "MESH_SLICE"]

MESH_SLICE = ("the train step on the model mesh and multi-pod gradient "
              "compression come with the next multi-GPU slice (ROADMAP "
              "queue 1 item 2)")


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


def init_train_state(cfg: ModelConfig, optimizer: Optimizer,
                     gen: torch.Generator | None, compression: str | None = None,
                     device=None, params=None) -> TrainState:
    """Parameters drawn from ``gen`` on ``device`` (the card by default),
    or the given ``params``, made trainable, with the optimizer's state
    (and zeroed error-feedback buffers for ``"int8_ef"``)."""
    if params is None:
        params = transformer.init_params(cfg, gen, device=resolve_device(device))
    params = trainable(params)
    err = None
    if compression == "int8_ef":
        err = {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for name, p in params.named_parameters()}
    return TrainState(params, optimizer.init(params), err)


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


def _micro(batch: dict, i: int, n: int) -> dict:
    """Microbatch ``i`` of ``n`` along the leading axis of every leaf."""
    return {k: _micro(v, i, n) if isinstance(v, dict)
            else v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
            for k, v in batch.items()}


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
    metrics)`` clips the gradients in place and updates the state."""
    if compression not in (None, "int8_ef"):
        raise ValueError(f"unknown compression {compression!r}")
    if mesh is not None:
        raise NotImplementedError(MESH_SLICE)
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum}")

    def grads_and_metrics(params, batch):
        named = list(params.named_parameters())
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

    def apply_gradients(state: TrainState, grads: dict, metrics: dict):
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = schedule(state.opt_state.step)
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params, lr)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(params, opt_state, state.err_fb), metrics

    def train_step(state: TrainState, batch: dict):
        return apply_gradients(state, *grads_and_metrics(state.params, batch))

    train_step.grads_and_metrics = grads_and_metrics
    train_step.apply_gradients = apply_gradients
    return train_step

"""The train-step checks that ``tests/test_torch_train*.py`` share.

The train-step tests are split by config family, so that ``--dist
loadfile`` runs the slow families on different workers:
``test_torch_train.py`` (the optimizer, the flash Function and the dense
configurations, the vision and audio stubs among them),
``test_torch_train_moe.py`` (MoE and MLA) and ``test_torch_train_ssm.py``
(Mamba2 and the Jamba hybrid).  The tolerances are stated in
``test_torch_train.py``'s docstring.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import REGISTRY as J_REGISTRY
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch.convert import model_params_from_numpy, reference_leaf
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS

ARCHS = sorted(J_REGISTRY)
LOSS_TOL = 1e-6
GRAD_RTOL = 1e-5
PARAM_RTOL = 2e-3
MOMENT_RTOL = 1e-4
CODE_MISMATCH = 1e-3
DEQ_RTOL = 5e-3
MOE_ARCHS = [a for a in ARCHS if M.get_config(a).family == "moe"]
SSM_ARCHS = [a for a in ARCHS if M.get_config(a).family in ("ssm", "hybrid")]
DENSE_ARCHS = [a for a in ARCHS if a not in MOE_ARCHS + SSM_ARCHS]


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.sqrt((want ** 2).mean())
    diff = np.sqrt(((got - want) ** 2).mean())
    return float(diff / den) if den > 0 else float(diff)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _reference_step(cfg, quantized, grad_accum, batch):
    """The reference's step from its ``init_params`` (key 0): with
    ``grad_accum`` 1 its jitted ``value_and_grad`` of the train loss, then
    the reference's own clip, schedule and AdamW update (what its
    ``build_train_step`` chains); with 2 its ``build_train_step``
    jitted.  Returns numpy trees (params, grads or None, loss metrics or
    None, new state, step metrics)."""
    jopt = JO.adamw(quantized=quantized)
    sched = JO.warmup_cosine(1e-2, 0, 10)
    jstate = JTS.init_train_state(cfg, jopt, jax.random.key(0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    if grad_accum == 1:
        loss_fn = JTS._make_loss_fn(cfg, "gspmd")
        (_, jmet), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jstate.params, jbatch)
        clipped, gnorm = JO.clip_by_global_norm(jgrads, 1.0)
        lr = sched(jstate.opt_state.step)
        params, opt_state = jopt.update(clipped, jstate.opt_state,
                                        jstate.params, lr)
        new = JTS.TrainState(params, opt_state, None)
        metrics = dict(jmet, grad_norm=gnorm, lr=lr)
        return (to_np(jstate.params), to_np(jgrads), to_np(jmet), to_np(new),
                to_np(metrics))
    step = JTS.build_train_step(cfg, jopt, sched, grad_accum=grad_accum)
    new, metrics = jax.jit(step)(jstate, jbatch)
    return to_np(jstate.params), None, None, to_np(new), to_np(metrics)



def check_train_step(arch, grad_accum):
    """One train step of ``arch`` (smoke) against the reference's: loss,
    gradients (grad_accum 1), clipped norm, updated parameters and AdamW
    state (int8 moments with grad_accum 1, float32 with 2)."""
    cfg = M.get_config(arch, smoke=True)
    quantized = grad_accum == 1
    batch = JPipeline(cfg, batch=4, seq=16, seed=3).next_batch()
    jparams, jgrads, jmet, jnew, jmetrics = _reference_step(
        cfg, quantized, grad_accum, batch)
    opt = O.adamw(quantized=quantized)
    state = TS.init_train_state(
        cfg, opt, None, params=model_params_from_numpy(cfg, jparams, device="cpu"))
    step = TS.build_train_step(cfg, opt, O.warmup_cosine(1e-2, 0, 10),
                               grad_accum=grad_accum)
    grads, met = step.grads_and_metrics(state.params,
                                        TS.batch_to_device(batch, "cpu"))
    assert set(grads) == {n for n, _ in state.params.named_parameters()}
    if jgrads is not None:
        assert float(met["aux_loss"]) == pytest.approx(float(jmet["aux_loss"]),
                                                       rel=1e-5, abs=1e-7)
        for name, g in grads.items():
            assert g.dtype == torch.float32
            assert rel_rms(_np(g), reference_leaf(cfg, jgrads, name)) <= GRAD_RTOL, name
    state, met = step.apply_gradients(state, grads, met)
    for key in ("loss", "grad_norm", "lr"):
        assert float(met[key]) == pytest.approx(float(jmetrics[key]), rel=LOSS_TOL)
    assert int(state.opt_state.step) == int(jnew.opt_state.step) == 1
    for name, p in state.params.named_parameters():
        want = reference_leaf(cfg, jnew.params, name)
        assert rel_rms(_np(p), want) <= PARAM_RTOL, name
        for mine, tree, deq in (
                (state.opt_state.mu[name], jnew.opt_state.mu, O._dequantize_signed),
                (state.opt_state.nu[name], jnew.opt_state.nu,
                 O._dequantize_log_unsigned)):
            theirs = reference_leaf(cfg, tree, name)
            if quantized:
                d = _np(mine["q"]).astype(np.int32) - theirs["q"].astype(np.int32)
                assert (d != 0).sum() <= max(2, CODE_MISMATCH * d.size), name
                assert rel_rms(_np(mine["s"]), theirs["s"]) <= MOMENT_RTOL, name
                got = deq(mine["q"], mine["s"], p.shape)
                want = deq(torch.from_numpy(theirs["q"]),
                           torch.from_numpy(theirs["s"]), p.shape)
                assert rel_rms(_np(got), _np(want)) <= DEQ_RTOL, name
            else:
                assert rel_rms(_np(mine), theirs) <= MOMENT_RTOL, name



def check_remat_equals_no_remat(arch):
    """The gradients and loss of one step with remat on and off, bit for
    bit."""
    cfg = M.get_config(arch, smoke=True)
    batch = TS.batch_to_device(
        JPipeline(cfg, batch=2, seq=16, seed=1).next_batch(), "cpu")
    out = []
    for remat in (True, False):
        c = cfg.with_overrides(remat=remat)
        params = T.init_params(c, torch.Generator().manual_seed(0), device="cpu")
        opt = O.adamw()
        state = TS.init_train_state(c, opt, None, params=params)
        grads, met = TS.build_train_step(c, opt, O.warmup_cosine(1e-2, 0, 10)) \
            .grads_and_metrics(state.params, batch)
        out.append((grads, met))
    (ga, ma), (gb, mb) = out
    assert torch.equal(ma["loss"], mb["loss"])
    assert ga.keys() == gb.keys()
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name

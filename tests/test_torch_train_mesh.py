"""Training on the port's model mesh against the reference and the port's
unsharded step (smoke configurations, batch 4, seq 32, numpy-seeded
pipeline batches).

Every mesh is one process over ``["cpu"] * 4``.  What is held, and how
tightly:

  * dense and SSM configurations (internlm2, mamba2) on (2, 2) and (1, 4):
    gradients, loss and one whole step (parameters, moments) bit-equal to
    the port's unsharded step: on the mesh they compute whole on the
    first device, the same kernels in the same order;
  * EP configurations (qwen3-moe, deepseek: MLA, a dense prefix layer,
    shared experts) with ``moe_impl="ep"`` on (2, 2) and (1, 4): within
    ``_torch_train_steps``' ``GRAD_RTOL`` / ``PARAM_RTOL`` / ``LOSS_TOL`` /
    ``MOMENT_RTOL`` of the reference's unsharded step (EP sums the model
    shards' outputs in float32 in another order), EP reached, and every
    expert that the reference's gradient reaches reached on the mesh;
  * five steps on a (2, 2) mesh within rtol 2e-4 of the single-device
    run's losses (the reference's own ``TestMultiDeviceParity`` bar);
  * int8_ef on a ("pod", "data") = (2, 2) mesh against the reference
    composed without a mesh (its grad function vmapped over the
    pod-major batch, ``_compress_psum_pod`` vmapped over ``"pod"``, its
    clip and AdamW): fed the reference's per-pod gradients and
    residuals, the port's cell gives codes that differ on at most a
    ``CODE_MISMATCH`` share (XLA's float32 division may differ from
    IEEE's by an ulp at a rounding midpoint), and residuals and the pod
    sums' average within one quantum of the reference's (a flipped code
    moves them by exactly that); over 3 steps the losses within ``LOSS_TOL``, the parameters within
    ``PARAM_RTOL`` and each residual leaf differing materially
    (``RESID_ATOL``) on at most a ``CODE_MISMATCH`` share (a flipped code
    moves its residual by one quantum);
  * the first int8_ef loss equal to the uncompressed step's (rtol 1e-5)
    and four within rtol 0.05 (the reference's ``TestInt8EfMultiPod``);
  * a preempted and resumed mesh run (``restore(shardings=)``) bit-equal
    to an uninterrupted one: parameters, moments, every pod's residual.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_train_steps import (CODE_MISMATCH, GRAD_RTOL, LOSS_TOL,
                                MOE_ARCHS, MOMENT_RTOL, PARAM_RTOL, _np,
                                rel_rms)
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch.convert import model_params_from_numpy, reference_leaf
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import model as M
from repro_torch.models.ffn import moe_ffn
from repro_torch.parallel.sharding import mesh_context
from repro_torch.train import checkpoint as C
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS

SHAPES = [(2, 2), (1, 4)]
SCHED = O.warmup_cosine(1e-2, 0, 10)
# int8_ef: where a code flips, a residual moves by one quantum (its row's
# safe scale) and an average by one quantum of the sum (s_sum / npods /
# npods); a residual element is "materially" different above RESID_ATOL.
AVG_QUANTA = 1.0
RESID_ATOL = 1e-6
MESH_LOSS_RTOL = 2e-4
INT8EF_FIRST_RTOL = 1e-5
INT8EF_TRACK_RTOL = 0.05


def _pod_mesh() -> Mesh:
    return Mesh(np.array(["cpu"] * 4, dtype=object).reshape(2, 2),
                ("pod", "data"))


def _batches(cfg, n: int, seed: int = 0) -> list:
    pipe = JPipeline(cfg, batch=4, seq=32, seed=seed)
    return [pipe.next_batch() for _ in range(n)]


def _state(cfg, opt, **kw):
    return TS.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                               device="cpu", **kw)


def _leaves_equal(a: TS.TrainState, b: TS.TrainState) -> None:
    for (n, p), (_, q) in zip(a.params.named_parameters(),
                              b.params.named_parameters()):
        assert torch.equal(p, q), n
    assert torch.equal(a.opt_state.step, b.opt_state.step)
    for kind in ("mu", "nu"):
        for n, m in getattr(a.opt_state, kind).items():
            other = getattr(b.opt_state, kind)[n]
            if isinstance(m, dict):
                assert all(torch.equal(m[k], other[k]) for k in m), (kind, n)
            else:
                assert torch.equal(m, other), (kind, n)


# ---------------------------------------------------------------------------
# No compression: dense / SSM bit-equal to the unsharded step, EP against
# the reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-370m"])
def test_mesh_step_bit_equal_unsharded(arch, shape):
    cfg = M.get_config(arch, smoke=True)
    batch = TS.batch_to_device(_batches(cfg, 1)[0], "cpu")
    opt = O.adamw(quantized=True)
    mesh = make_host_mesh(*shape, devices=["cpu"] * 4)
    plain, meshed = _state(cfg, opt), _state(cfg, opt)
    g0, m0 = TS.build_train_step(cfg, opt, SCHED).grads_and_metrics(
        plain.params, batch)
    step = TS.build_train_step(cfg, opt, SCHED, mesh=mesh)
    with mesh_context(mesh):
        g1, m1 = step.grads_and_metrics(meshed.params, batch)
    assert torch.equal(m0["loss"], m1["loss"])
    assert g0.keys() == g1.keys()
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    plain, _ = TS.build_train_step(cfg, opt, SCHED)(plain, batch)
    meshed, _ = step(meshed, batch)
    _leaves_equal(meshed, plain)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's unsharded step (float32 AdamW, key 0), jitted whole:
    (batch, (params, grads, loss metrics, new state, step metrics)) as
    numpy."""
    cfg = M.get_config(arch, smoke=True)
    batch = _batches(cfg, 1, seed=3)[0]
    opt = JO.adamw()
    sched = JO.warmup_cosine(1e-2, 0, 10)
    state = JTS.init_train_state(cfg, opt, jax.random.key(0))
    grad_fn = jax.value_and_grad(JTS._make_loss_fn(cfg, "gspmd"), has_aux=True)

    @jax.jit
    def step(state, b):
        (_, met), grads = grad_fn(state.params, b)
        clipped, gnorm = JO.clip_by_global_norm(grads, 1.0)
        lr = sched(state.opt_state.step)
        params, opt_state = opt.update(clipped, state.opt_state,
                                       state.params, lr)
        return (grads, met, JTS.TrainState(params, opt_state, None),
                dict(met, grad_norm=gnorm, lr=lr))

    out = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return batch, (to_np(state.params),) + tuple(to_np(t) for t in out)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ep_mesh_step_equals_reference(arch, shape, monkeypatch):
    cfg = M.get_config(arch, smoke=True)
    np_batch, (jparams, jgrads, jmet, jnew, jmetrics) = _reference(arch)
    batch = TS.batch_to_device(np_batch, "cpu")
    mesh = make_host_mesh(*shape, devices=["cpu"] * 4)
    assert cfg.num_experts % mesh.shape["model"] == 0
    calls = []
    real = moe_ffn._expert_parallel

    def spy(*a, **kw):
        calls.append(a[-1])
        return real(*a, **kw)

    monkeypatch.setattr(moe_ffn, "_expert_parallel", staticmethod(spy))
    opt = O.adamw()
    step = TS.build_train_step(cfg, opt, SCHED, moe_impl="ep", mesh=mesh)
    state = TS.init_train_state(
        cfg, opt, None, params=model_params_from_numpy(cfg, jparams, device="cpu"))
    with mesh_context(mesh):
        grads, met = step.grads_and_metrics(state.params, batch)
    assert calls and all(m is mesh for m in calls)
    assert float(met["aux_loss"]) == pytest.approx(float(jmet["aux_loss"]),
                                                   rel=1e-5, abs=1e-7)
    for name, g in grads.items():
        want = reference_leaf(cfg, jgrads, name)
        assert rel_rms(_np(g), want) <= GRAD_RTOL, name
        if ".experts." in name:
            # The gradient reaches each expert through its shard's piece.
            reached = np.abs(_np(g)).reshape(g.shape[0], -1).max(axis=1) > 0
            wanted = np.abs(want).reshape(g.shape[0], -1).max(axis=1) > 0
            assert wanted.any() and np.array_equal(reached, wanted), name
    calls.clear()
    state, metrics = step(state, batch)
    assert calls
    for key in ("loss", "grad_norm", "lr"):
        assert float(metrics[key]) == pytest.approx(float(jmetrics[key]),
                                                    rel=LOSS_TOL)
    for name, p in state.params.named_parameters():
        assert rel_rms(_np(p), reference_leaf(cfg, jnew.params, name)) \
            <= PARAM_RTOL, name
        for kind in ("mu", "nu"):
            want = reference_leaf(cfg, getattr(jnew.opt_state, kind), name)
            got = _np(getattr(state.opt_state, kind)[name])
            assert rel_rms(got, want) <= MOMENT_RTOL, (kind, name)


def test_remat_recompute_keeps_the_mesh(monkeypatch):
    """Autograd recomputes a checkpointed layer on whichever thread runs
    the backward (on the card, the device's own backward thread, where the
    caller's thread-local mesh is not set): the EP layers must recompute
    per shard there too.  Here the backward runs on another thread; its
    gradients equal those of a backward on the caller's thread."""
    import threading

    cfg = M.get_config("qwen3-moe-30b-a3b", smoke=True)
    assert cfg.remat
    batch = TS.batch_to_device(_batches(cfg, 1)[0], "cpu")
    mesh = make_host_mesh(1, 4, devices=["cpu"] * 4)
    calls = []
    real = moe_ffn._expert_parallel

    def spy(*a, **kw):
        calls.append(threading.current_thread().name)
        return real(*a, **kw)

    monkeypatch.setattr(moe_ffn, "_expert_parallel", staticmethod(spy))
    params = TS.trainable(_state(cfg, O.adamw()).params)
    grads = []
    for other_thread in (False, True):
        for p in params.parameters():
            p.grad = None
        with mesh_context(mesh):
            total, _, _ = TS._loss(cfg, params, batch, "ep")
        if other_thread:
            errors = []

            def backward():
                try:
                    total.backward()
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(e)

            t = threading.Thread(target=backward, name="backward")
            t.start()
            t.join()
            assert not errors, errors
        else:
            total.backward()
        grads.append({n: p.grad.clone() for n, p in params.named_parameters()
                      if p.grad is not None})
    assert calls.count("backward") == cfg.num_layers  # one recompute a layer
    assert grads[0].keys() == grads[1].keys()
    assert all(torch.equal(grads[0][n], grads[1][n]) for n in grads[0])


@pytest.mark.parametrize("arch, impl", [("internlm2-1.8b", "gspmd"),
                                        ("qwen3-moe-30b-a3b", "ep")])
def test_five_losses_track_single_device(arch, impl):
    cfg = M.get_config(arch, smoke=True)
    batches = [TS.batch_to_device(b, "cpu") for b in _batches(cfg, 5)]
    opt = O.adamw(weight_decay=0.01)
    sched = O.warmup_cosine(1e-3, 2, 20)
    losses = {}
    for mesh in (None, make_host_mesh(2, 2, devices=["cpu"] * 4)):
        state = _state(cfg, opt)
        step = TS.build_train_step(cfg, opt, sched, moe_impl=impl, mesh=mesh)
        out = []
        for b in batches:
            state, m = step(state, b)
            out.append(float(m["loss"]))
        losses[mesh is None] = out
    np.testing.assert_allclose(losses[False], losses[True], rtol=MESH_LOSS_RTOL)


def test_int8_ef_without_pod_axis_is_noop():
    cfg = M.get_config("internlm2-1.8b", smoke=True)
    batch = TS.batch_to_device(_batches(cfg, 1)[0], "cpu")
    opt = O.adamw()
    mesh = make_host_mesh(2, 2, devices=["cpu"] * 4)
    plain = _state(cfg, opt)
    comp = _state(cfg, opt, compression="int8_ef", mesh=mesh)
    assert isinstance(comp.err_fb, dict)
    plain, _ = TS.build_train_step(cfg, opt, SCHED)(plain, batch)
    comp, _ = TS.build_train_step(cfg, opt, SCHED, compression="int8_ef",
                                  mesh=mesh)(comp, batch)
    _leaves_equal(comp, plain)
    assert all(not e.any() for e in comp.err_fb.values())


# ---------------------------------------------------------------------------
# int8_ef across pods against the reference composed through jax.vmap.
# ---------------------------------------------------------------------------


def _reference_int8_ef(cfg, batches, npods: int):
    """The reference's int8_ef step without a mesh: per-pod gradients from
    its grad function vmapped over the pod-major batch, the cell vmapped
    over ``"pod"``, then its clip and AdamW.  Returns the initial
    parameters, per step (loss, the per-pod gradients and residuals fed
    to the cell, the cell's average and new residuals) and the final
    parameters, all numpy."""
    opt = JO.adamw(weight_decay=0.01)
    sched = JO.warmup_cosine(1e-3, 2, 20)
    state = JTS.init_train_state(cfg, opt, jax.random.key(0))
    grad_fn = jax.value_and_grad(JTS._make_loss_fn(cfg, "gspmd"), has_aux=True)
    cell = jax.jit(jax.vmap(JTS._compress_psum_pod, axis_name="pod"))

    @jax.jit
    def pod_grads(params, batch):
        micro = jax.tree_util.tree_map(
            lambda x: x.reshape((npods, x.shape[0] // npods) + x.shape[1:]),
            batch)
        (_, met), grads = jax.vmap(grad_fn, in_axes=(None, 0))(params, micro)
        return jax.tree_util.tree_map(lambda m: jnp.mean(m, axis=0), met), grads

    @jax.jit
    def finish(params, opt_state, avg):
        clipped, _ = JO.clip_by_global_norm(avg, 1.0)
        return opt.update(clipped, opt_state, params, sched(opt_state.step))

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    params, opt_state = state.params, state.opt_state
    err = jax.tree_util.tree_map(
        lambda p: jnp.zeros((npods,) + p.shape, jnp.float32), params)
    first, steps = to_np(params), []
    for b in batches:
        met, grads = pod_grads(params, jax.tree_util.tree_map(jnp.asarray, b))
        avg, new_err = cell(grads, err)
        steps.append({"loss": float(met["loss"]), "grads": to_np(grads),
                      "err_in": to_np(err),
                      "avg": to_np(jax.tree_util.tree_map(lambda a: a[0], avg)),
                      "err_out": to_np(new_err)})
        params, opt_state = finish(params, opt_state,
                                   jax.tree_util.tree_map(lambda a: a[0], avg))
        err = new_err
    return first, steps, to_np(params)


@functools.lru_cache(maxsize=None)
def _int8_ef_reference():
    cfg = M.get_config("internlm2-1.8b", smoke=True)
    batches = _batches(cfg, 3)
    return cfg, batches, _reference_int8_ef(cfg, batches, 2)


def _mismatch_ok(bad: np.ndarray) -> bool:
    return bad.sum() <= max(2, CODE_MISMATCH * bad.size)


def test_compression_cell_against_reference():
    """The port's cell on the reference's per-pod gradients and residuals
    of each step, its codes against the reference's (recovered exactly
    from its residual: ``q = (gf - e') / safe``), its residuals and the
    pod sums' average against the reference's within one quantum."""
    cfg, _, (first, steps, _) = _int8_ef_reference()
    names = [n for n, _ in model_params_from_numpy(
        cfg, first, device="cpu").named_parameters()]
    for s in steps:
        for name in names:
            q_sum = s_sum = None
            for pod in range(2):
                g = _pod_leaf(cfg, s["grads"], name, pod)
                e_in = _pod_leaf(cfg, s["err_in"], name, pod)
                e_ref = _pod_leaf(cfg, s["err_out"], name, pod)
                e = torch.from_numpy(e_in.copy())
                q, safe = TS.compress_residual(torch.from_numpy(g.copy()), e)
                quantum = _np(safe)
                gf = (g.astype(np.float32) + e_in).astype(np.float64)
                q_ref = np.rint((gf - e_ref) / quantum)
                assert _mismatch_ok(_np(q) != q_ref), name
                assert np.all(np.abs(_np(e) - e_ref) <= quantum * (1 + 1e-6)), name
                q_sum = q.to(torch.int32) if q_sum is None else q_sum + q
                s_sum = safe if s_sum is None else s_sum + safe
            avg = _np(q_sum.to(torch.float32) * (s_sum / 2) / 2)
            want = _pod_leaf(cfg, s["avg"], name, None)
            quantum = _np(s_sum / 2 / 2) * AVG_QUANTA
            assert np.all(np.abs(avg - want) <= quantum * (1 + 1e-6)), name


def _pod_leaf(cfg, tree, name, pod):
    """The reference leaf ``name`` of a per-pod stacked tree (pod axis
    leading; ``pod`` None for a tree without one), the layer's group
    slice taken after the pod's."""
    from repro_torch.convert import _array, _reference_node
    node, g = _reference_node(cfg, tree, name)
    a = np.asarray(node)
    if pod is not None:
        a = a[pod]
    return _array(a, g)


def test_int8_ef_step_against_reference():
    cfg, batches, (first, steps, last) = _int8_ef_reference()
    opt = O.adamw(weight_decay=0.01)
    sched = O.warmup_cosine(1e-3, 2, 20)
    mesh = _pod_mesh()
    state = TS.init_train_state(
        cfg, opt, None, params=model_params_from_numpy(cfg, first, device="cpu"),
        compression="int8_ef", mesh=mesh)
    assert isinstance(state.err_fb, list) and len(state.err_fb) == 2
    step = TS.build_train_step(cfg, opt, sched, compression="int8_ef",
                               mesh=mesh)
    for b, s in zip(batches, steps):
        state, met = step(state, TS.batch_to_device(b, "cpu"))
        assert float(met["loss"]) == pytest.approx(s["loss"], rel=LOSS_TOL)
    for name, p in state.params.named_parameters():
        assert rel_rms(_np(p), reference_leaf(cfg, last, name)) <= PARAM_RTOL, name
        for pod in range(2):
            want = _pod_leaf(cfg, steps[-1]["err_out"], name, pod)
            bad = np.abs(_np(state.err_fb[pod][name]) - want) > RESID_ATOL
            assert _mismatch_ok(bad), (name, pod)


def test_int8_ef_pod_replica_equals_in_place(monkeypatch):
    """A pod on another device than the parameters' differentiates a
    replica of them there (a tree of leaf tensors) and sends its codes and
    scales home.  Forced on the CPU mesh for pod 1: three steps bit-equal
    to the step that differentiates the model in place (losses,
    parameters, moments, both pods' residuals), and within the train
    tolerances of the reference."""
    cfg, batches, (first, steps, last) = _int8_ef_reference()
    opt = O.adamw(weight_decay=0.01)
    sched = O.warmup_cosine(1e-3, 2, 20)
    mesh = _pod_mesh()
    run = {}
    for replica in (False, True):
        if replica:
            pod_one = itertools.cycle([False, True])
            made = []

            def pod_params(params, dev, home):
                if not next(pod_one):
                    return params
                made.append(TS._replica(params, dev))
                return made[-1]

            monkeypatch.setattr(TS, "_pod_params", pod_params)
        state = TS.init_train_state(
            cfg, opt, None, compression="int8_ef", mesh=mesh,
            params=model_params_from_numpy(cfg, first, device="cpu"))
        step = TS.build_train_step(cfg, opt, sched, compression="int8_ef",
                                   mesh=mesh)
        losses = []
        for b in batches:
            state, met = step(state, TS.batch_to_device(b, "cpu"))
            losses.append(float(met["loss"]))
        run[replica] = (losses, state)
    assert len(made) == len(batches)
    assert all(isinstance(t, dict) for t in made)
    assert run[True][0] == run[False][0]
    _leaves_equal(run[True][1], run[False][1])
    for pod in range(2):
        for n, e in run[False][1].err_fb[pod].items():
            assert torch.equal(run[True][1].err_fb[pod][n], e), (pod, n)
    losses, state = run[True]
    for got, s in zip(losses, steps):
        assert got == pytest.approx(s["loss"], rel=LOSS_TOL)
    for name, p in state.params.named_parameters():
        assert rel_rms(_np(p), reference_leaf(cfg, last, name)) <= PARAM_RTOL, name


def test_int8_ef_needs_a_residual_per_pod():
    """A state made without the pod mesh (one residual dict) is refused on
    it, not converted: the state's tree would change under the run."""
    cfg = M.get_config("internlm2-1.8b", smoke=True)
    opt = O.adamw()
    state = _state(cfg, opt, compression="int8_ef")
    assert isinstance(state.err_fb, dict)
    step = TS.build_train_step(cfg, opt, SCHED, compression="int8_ef",
                               mesh=_pod_mesh())
    batch = TS.batch_to_device(_batches(cfg, 1)[0], "cpu")
    with pytest.raises(ValueError, match=r"init_train_state\(mesh=\)"):
        step(state, batch)


def test_int8_ef_tracks_uncompressed():
    """The reference's TestInt8EfMultiPod criterion on the port: step 1's
    loss (computed before any compression) equal, four within 5%."""
    cfg = M.get_config("internlm2-1.8b", smoke=True)
    batches = [TS.batch_to_device(b, "cpu") for b in _batches(cfg, 4)]
    opt = O.adamw(weight_decay=0.01)
    sched = O.warmup_cosine(1e-3, 2, 20)
    mesh = _pod_mesh()
    losses = {}
    for comp in ("int8_ef", None):
        state = _state(cfg, opt, compression=comp, mesh=mesh)
        step = TS.build_train_step(cfg, opt, sched, compression=comp, mesh=mesh)
        out = []
        for b in batches:
            state, m = step(state, b)
            out.append(float(m["loss"]))
        losses[comp] = out
        if comp:
            assert any(e.any() for pod in state.err_fb for e in pod.values())
    assert np.isclose(losses["int8_ef"][0], losses[None][0],
                      rtol=INT8EF_FIRST_RTOL)
    np.testing.assert_allclose(losses["int8_ef"], losses[None],
                               rtol=INT8EF_TRACK_RTOL)
    assert all(np.isfinite(losses["int8_ef"]))


# ---------------------------------------------------------------------------
# Preempt and resume on the mesh.
# ---------------------------------------------------------------------------


def test_preempt_and_resume_on_mesh_bit_equal(tmp_path):
    cfg = M.get_config("internlm2-1.8b", smoke=True)
    batches = [TS.batch_to_device(b, "cpu") for b in _batches(cfg, 4)]
    opt = O.adamw(weight_decay=0.01, quantized=True)
    mesh = _pod_mesh()
    step = TS.build_train_step(cfg, opt, SCHED, compression="int8_ef",
                               mesh=mesh)
    straight = _state(cfg, opt, compression="int8_ef", mesh=mesh)
    for b in batches:
        straight, _ = step(straight, b)
    first = _state(cfg, opt, compression="int8_ef", mesh=mesh)
    for b in batches[:2]:
        first, _ = step(first, b)
    C.save(str(tmp_path), 2, first, {"step": 2})
    fresh = _state(cfg, opt, compression="int8_ef", mesh=mesh)
    resumed, extra = C.restore(str(tmp_path), 2, fresh,
                               shardings=TS.state_shardings(fresh, mesh))
    assert extra == {"step": 2} and resumed.params is fresh.params
    for b in batches[2:]:
        resumed, _ = step(resumed, b)
    _leaves_equal(resumed, straight)
    for pod in range(2):
        for n, e in straight.err_fb[pod].items():
            assert torch.equal(resumed.err_fb[pod][n], e), (pod, n)


def test_ep_backward_ignores_rows_past_the_last_offset(monkeypatch):
    """On the card the grouped GEMM leaves the rows past its last offset
    (EP's null group: copies routed to another shard's experts) undefined,
    in its output and in its input gradient.  With the CPU's loop made to
    write NaN there too, EP's loss and gradients stay finite and equal to
    those of the loop that zeroes them."""
    from repro_torch.models import ffn

    cfg = M.get_config("qwen3-moe-30b-a3b", smoke=True)
    batch = TS.batch_to_device(_batches(cfg, 1)[0], "cpu")
    mesh = make_host_mesh(1, 4, devices=["cpu"] * 4)
    params = TS.trainable(_state(cfg, O.adamw()).params)
    step = TS.build_train_step(cfg, O.adamw(), SCHED, moe_impl="ep")
    real = ffn.grouped_swiglu_loop

    class Undefined(torch.autograd.Function):
        """Rows from ``end`` on: NaN forward and NaN input gradient."""

        @staticmethod
        def forward(ctx, y, end):
            ctx.end = end
            y = y.clone()
            y[end:] = float("nan")
            return y

        @staticmethod
        def backward(ctx, g):
            g = g.clone()
            g[ctx.end:] = float("nan")
            return g, None

    def undefined_tail(x_sorted, group_sizes, offs, *w):
        end = int(offs[-1])
        return Undefined.apply(real(Undefined.apply(x_sorted, end),
                                    group_sizes, offs, *w), end)

    with mesh_context(mesh):
        want, m0 = step.grads_and_metrics(params, batch)
        monkeypatch.setattr(ffn, "grouped_swiglu_loop", undefined_tail)
        got, m1 = step.grads_and_metrics(params, batch)
    assert torch.equal(m0["loss"], m1["loss"])
    for n in want:
        assert torch.isfinite(got[n]).all() and torch.equal(got[n], want[n]), n

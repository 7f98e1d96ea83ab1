"""The port's training path against ``repro.train`` at smoke size.

Mirrors ``tests/test_optimizer.py`` on the port (AdamW's reference math,
the int8 moments, the codecs, schedules and clipping; the two property
tests run on fixed seeds), holds the optimizer's pieces against the
reference's on the same inputs, and one train step of every
configuration against ``jax.value_and_grad`` with the reference's
clip, schedule and AdamW (``grad_accum`` 1) and its ``build_train_step``
(``grad_accum`` 2): parameters from the reference's ``init_params``
carried by ``convert.model_params_from_numpy``, the same
``TokenPipeline`` batch (bit-equal in both packages,
``tests/test_torch_modality.py``), ``grad_accum`` 1 and 2.

Tolerances (float32 throughout; the two packages differ in summation
order and in XLA's fused elementwise code):

* loss within ``LOSS_TOL`` relative (a sum over a few hundred tokens);
* each gradient leaf within ``GRAD_RTOL`` relative RMS (2e-7 - 2.1e-6
  measured, the largest Mamba2's ``A_log``), and the clipped norm within
  ``LOSS_TOL``;
* updated parameters within ``PARAM_RTOL`` relative RMS of the leaf.
  Adam's first step moves an element by lr · g / (|g| + eps), about lr
  (1e-2, half the leaf's RMS and more) wherever |g| >> eps; an element
  whose gradient is a near-cancelling sum carries an error that is small
  against the leaf's RMS but not against its own |g|, and the ratio
  shows it (measured 1e-5 - 9.2e-4, the largest an attention output
  projection of the MoE models);
* float32 moments within ``MOMENT_RTOL`` relative RMS (8.5e-6 measured);
  int8 moments: row scales within ``MOMENT_RTOL``, codes equal but for at
  most ``CODE_MISMATCH`` of them, or 2 in a small leaf (1.8e-4 measured:
  ratios within a rounding error of a midpoint, and the tiny moments of
  the elements above), and the dequantized moments within ``DEQ_RTOL``
  relative RMS (one code step moves an element by 13% of itself; 1.1e-3
  measured).

The train-step and remat tests of the MoE / MLA and Mamba2 / Jamba
configurations are in ``test_torch_train_moe.py`` and
``test_torch_train_ssm.py`` (split by config family so that ``--dist
loadfile`` spreads them over workers); the checks all three files run
are ``_torch_train_steps.py``'s, with the tolerances below.

Remat on against off is held bit for bit.  The flash autograd Function
(``kernels/flash_attention/ops.py``) is held on the CPU with its kernel
replaced by the kernel's plain version, and on the card (``cuda``
marker) against autograd through ``ref.chunked_attention``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_train_steps import (DENSE_ARCHS, PARAM_RTOL, _np,
                                check_remat_equals_no_remat, check_train_step,
                                rel_rms)
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch.convert import (model_params_from_numpy, reference_leaf,
                                 train_state_from_numpy)
from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS

def _tiny_params(seed):
    rng = np.random.default_rng(seed)
    return {
        "dense": {"w": (rng.normal(size=(32, 16)) * 0.1).astype(np.float32)},
        "norm": {"scale": np.ones((16,), np.float32)},
        "out": {"b": np.zeros((16,), np.float32)},
    }


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# tests/test_optimizer.py, on the port
# ---------------------------------------------------------------------------

class TestAdamWReference:
    def test_matches_manual_adam(self):
        params = {"w": torch.tensor([[1.0, -2.0]])}
        grads = {"w": torch.tensor([[0.5, 0.25]])}
        opt = O.adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)
        state = opt.init(params)
        new_params, state = opt.update(grads, state, params, lr=0.1)
        g = np.asarray([[0.5, 0.25]])
        m = 0.1 * g
        v = 0.001 * g * g
        upd = (m / 0.1) / (np.sqrt(v / 0.001) + 1e-8)
        np.testing.assert_allclose(_np(new_params["w"]),
                                   np.asarray([[1.0, -2.0]]) - 0.1 * upd,
                                   rtol=1e-5)
        assert int(state.step) == 1

    def test_weight_decay_skips_norms_and_biases(self):
        params = _torch_tree(_tiny_params(0))
        before = {k: {n: t.clone() for n, t in v.items()}
                  for k, v in params.items()}
        zeros = {k: {n: torch.zeros_like(t) for n, t in v.items()}
                 for k, v in params.items()}
        opt = O.adamw(weight_decay=0.5)
        state = opt.init(params)
        new_params, _ = opt.update(zeros, state, params, lr=0.1)
        assert not torch.allclose(new_params["dense"]["w"], before["dense"]["w"])
        assert torch.equal(new_params["norm"]["scale"], before["norm"]["scale"])
        assert torch.equal(new_params["out"]["b"], before["out"]["b"])


class TestQuantizedStates:
    def test_tracks_fp32_closely(self):
        target = torch.from_numpy(
            np.random.default_rng(1).normal(size=256).astype(np.float32))

        def loss_fn(x):
            return torch.sum((x - target) ** 2)

        results = {}
        for quant in (False, True):
            opt = O.adamw(weight_decay=0.0, quantized=quant)
            params = {"x": torch.zeros(256)}
            state = opt.init(params)
            for _ in range(50):
                x = params["x"].clone().requires_grad_(True)
                (g,) = torch.autograd.grad(loss_fn(x), (x,))
                params, state = opt.update({"x": g}, state, params, lr=0.05)
            results[quant] = float(loss_fn(params["x"]))
        assert results[False] < 100
        assert results[True] < results[False] * 1.3 + 1.0

    def test_memory_footprint(self):
        params = {"w": torch.zeros((4096, 256))}
        state = O.adamw(quantized=True).init(params)
        n = 4096 * 256
        nbytes = sum(t.nbytes for m in (state.mu, state.nu)
                     for leaf in m.values() for t in leaf.values())
        assert nbytes / n < 2.1

    def test_moment_codes_mirror_param_shape(self):
        params = {"w": torch.zeros((64, 32, 16))}
        state = O.adamw(quantized=True).init(params)
        assert state.mu["w"]["q"].shape == (64, 32, 16)
        assert state.mu["w"]["q"].dtype == torch.int8
        assert state.mu["w"]["s"].shape == (64, 32)
        assert state.nu["w"]["q"].shape == (64, 32, 16)
        assert state.nu["w"]["q"].dtype == torch.uint8


class TestQuantCodecs:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_signed_log_relative_error(self, seed):
        r = np.random.default_rng(seed)
        x = (10.0 ** r.uniform(-6, 0, size=(4, 512))
             * r.choice([-1, 1], size=(4, 512))).astype(np.float32)
        q, s = O._quantize_signed(torch.from_numpy(x))
        back = _np(O._dequantize_signed(q, s, x.shape))
        assert np.max(np.abs(back - x) / np.abs(x)) < 0.07
        assert np.array_equal(np.sign(back), np.sign(x))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_log_unsigned_relative_error(self, seed):
        r = np.random.default_rng(seed)
        x = (10.0 ** r.uniform(-6, 0, size=(2, 256))).astype(np.float32)
        q, s = O._quantize_log_unsigned(torch.from_numpy(x))
        back = _np(O._dequantize_log_unsigned(q, s, x.shape))
        assert np.max(np.abs(back - x) / x) < 0.07

    def test_log_unsigned_zero(self):
        q, s = O._quantize_log_unsigned(torch.zeros((3, 256)))
        back = _np(O._dequantize_log_unsigned(q, s, (3, 256)))
        np.testing.assert_array_equal(back, 0.0)

    def test_1d_param(self):
        x = torch.from_numpy(np.linspace(-2, 2, 33).astype(np.float32))
        q, s = O._quantize_signed(x)
        assert s.shape == ()
        back = _np(O._dequantize_signed(q, s, (33,)))
        np.testing.assert_allclose(back, _np(x), rtol=0.07, atol=1e-7)


class TestSchedulesAndClip:
    def test_warmup_cosine(self):
        sched = O.warmup_cosine(1.0, 10, 110)
        assert float(sched(0)) == 0.0
        assert float(sched(10)) == pytest.approx(1.0)
        assert float(sched(110)) == pytest.approx(0.1, abs=1e-6)
        assert 0.1 < float(sched(60)) < 1.0

    def test_clip(self):
        """The port clips in place (a train step's gradients are its own)."""
        tree = {"a": torch.tensor([3.0, 4.0])}
        clipped, norm = O.clip_by_global_norm(tree, 1.0)
        assert float(norm) == pytest.approx(5.0) and clipped is tree
        np.testing.assert_allclose(_np(clipped["a"]), [0.6, 0.8], rtol=1e-6)
        not_clipped, _ = O.clip_by_global_norm({"a": torch.tensor([3.0, 4.0])},
                                               10.0)
        np.testing.assert_allclose(_np(not_clipped["a"]), [3.0, 4.0])


# ---------------------------------------------------------------------------
# The optimizer's pieces against the reference's, same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, n, ulps", [
    ("_ULOG_TABLE", 255, O.ULOG_XLA_ULP), ("_SLOG_TABLE", 127, O.SLOG_XLA_ULP)])
def test_codec_tables_equal_reference_but_named_ulps(name, n, ulps):
    """The port's table equals the reference's bit for bit except at the
    named entries, each one ulp off (XLA's float32 exp)."""
    mine = O.log_table(n)
    theirs = np.asarray(getattr(JO, name))
    assert mine.dtype == theirs.dtype == np.float32 and mine.shape == (n + 1,)
    off = np.nonzero(mine != theirs)[0]
    assert tuple(off) == ulps
    steps = mine[off].view(np.int32) - theirs[off].view(np.int32)
    assert set(np.abs(steps)) == {1}


@pytest.mark.parametrize("signed", [True, False])
def test_codes_equal_reference_off_the_shifted_midpoints(signed):
    """Codes equal the reference's for every ratio except those between
    the two packages' midpoints at the named entries (hit on purpose
    here); row scales bit-equal."""
    rng = np.random.default_rng(7)
    x = (10.0 ** rng.uniform(-8, 0, size=(64, 512))).astype(np.float32)
    x[:, 0] = 1.0  # every row's scale is 1: the ratio is the value
    table = O.log_table(255 if not signed else 127)
    mids_mine = (table[1:] + table[:-1]) / np.float32(2)
    ref_table = np.asarray(JO._SLOG_TABLE if signed else JO._ULOG_TABLE)
    mids_ref = (ref_table[1:] + ref_table[:-1]) / np.float32(2)
    shifted = np.nonzero(mids_mine != mids_ref)[0]
    # Put values on both sides of every midpoint, the shifted ones too.
    near = np.concatenate([mids_mine, mids_ref])
    x[:, 1:1 + near.size] = np.resize(near, (64, near.size))
    if signed:
        x[::2] *= -1
        q, s = O._quantize_signed(torch.from_numpy(x))
        jq, js = JO._quantize_signed(jnp.asarray(x))
    else:
        q, s = O._quantize_log_unsigned(torch.from_numpy(x))
        jq, js = JO._quantize_log_unsigned(jnp.asarray(x))
    np.testing.assert_array_equal(_np(s), np.asarray(js))
    ratio = np.abs(x)
    lo = np.minimum(mids_mine[shifted], mids_ref[shifted])
    hi = np.maximum(mids_mine[shifted], mids_ref[shifted])
    between = ((ratio[..., None] >= lo) & (ratio[..., None] <= hi)).any(-1)
    diff = _np(q).astype(np.int32) != np.asarray(jq).astype(np.int32)
    assert not (diff & ~between).any()
    assert shifted.size > 0


@pytest.mark.parametrize("quantized", [False, True])
def test_update_equals_reference_on_same_inputs(quantized):
    """One AdamW update (weight decay on the matrix, not on the norm)
    from a carried reference state after one step, same gradients."""
    params_np = _tiny_params(3)
    rng = np.random.default_rng(4)
    grads_np = [{k: {n: rng.normal(size=a.shape).astype(np.float32) * 1e-2
                     for n, a in v.items()} for k, v in params_np.items()}
                for _ in range(2)]
    jopt = JO.adamw(quantized=quantized)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jstate = jopt.init(jparams)
    jparams, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads_np[0]),
                                  jstate, jparams, 1e-2)
    opt = O.adamw(quantized=quantized)
    params = _torch_tree(jax.tree_util.tree_map(np.asarray, jparams))
    state = opt.init(params)

    def carry(node):
        return ({k: torch.tensor(np.asarray(v)) for k, v in node.items()}
                if isinstance(node, dict) else torch.tensor(np.asarray(node)))
    state = O.AdamWState(
        torch.tensor(int(jstate.step), dtype=torch.int32),
        {f"{k}.{n}": carry(jstate.mu[k][n]) for k in params for n in params[k]},
        {f"{k}.{n}": carry(jstate.nu[k][n]) for k in params for n in params[k]})
    lr = JO.warmup_cosine(1e-2, 0, 10)(jnp.asarray(1))
    jparams, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads_np[1]),
                                  jstate, jparams, lr)
    params, state = opt.update(_torch_tree(grads_np[1]), state, params,
                               O.warmup_cosine(1e-2, 0, 10)(1))
    assert int(state.step) == int(jstate.step) == 2
    for k in params:
        for n in params[k]:
            assert rel_rms(_np(params[k][n]), jparams[k][n]) <= 1e-6
            mine, theirs = state.mu[f"{k}.{n}"], jstate.mu[k][n]
            if quantized:
                d = _np(mine["q"]).astype(int) - np.asarray(theirs["q"]).astype(int)
                assert np.abs(d).max() <= 1 and (d != 0).mean() <= 0.01
                assert rel_rms(_np(mine["s"]), theirs["s"]) <= 1e-6
            else:
                assert rel_rms(_np(mine), theirs) <= 1e-6


@pytest.mark.parametrize("step", [0, 5, 10, 60, 110, 200])
def test_schedule_equals_reference(step):
    mine = O.warmup_cosine(3e-3, 10, 110)(torch.tensor(step, dtype=torch.int32))
    theirs = JO.warmup_cosine(3e-3, 10, 110)(jnp.asarray(step, jnp.int32))
    assert mine.dtype == torch.float32
    assert float(mine) == pytest.approx(float(theirs), rel=1e-6, abs=1e-12)


def test_global_norm_and_clip_equal_reference():
    tree = _tiny_params(5)
    jclipped, jnorm = JO.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, tree), 0.5)
    clipped, norm = O.clip_by_global_norm(_torch_tree(tree), 0.5)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    for k in tree:
        for n in tree[k]:
            np.testing.assert_allclose(_np(clipped[k][n]),
                                       np.asarray(jclipped[k][n]), rtol=1e-6)


def test_blocked_update_equals_whole_leaf(monkeypatch):
    """A leaf updated in row blocks equals the same leaf in one block, bit
    for bit (the scales are per row)."""
    rng = np.random.default_rng(6)
    w = rng.normal(size=(37, 24)).astype(np.float32)
    gs = [rng.normal(size=w.shape).astype(np.float32) for _ in range(3)]
    out = []
    for block in (1 << 24, 24 * 5):
        monkeypatch.setattr(O, "UPDATE_BLOCK", {"cuda": block, "cpu": block})
        opt = O.adamw(quantized=True)
        params = {"w": torch.tensor(w)}
        state = opt.init(params)
        for g in gs:
            params, state = opt.update({"w": torch.tensor(g)}, state, params, 1e-2)
        out.append((params["w"], state.mu["w"]["q"], state.nu["w"]["s"]))
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# One train step of every dense configuration against the reference (the
# MoE / MLA ones: test_torch_train_moe.py; Mamba2 / Jamba:
# test_torch_train_ssm.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_train_step_equals_reference(arch, grad_accum):
    check_train_step(arch, grad_accum)


def test_train_step_is_its_two_halves():
    """``train_step`` == ``apply_gradients`` after ``grads_and_metrics``,
    bit for bit."""
    cfg = M.get_config("internvl2-26b", smoke=True)
    batch = TS.batch_to_device(
        JPipeline(cfg, batch=2, seq=16, seed=2).next_batch(), "cpu")
    out = []
    for whole in (True, False):
        opt = O.adamw(quantized=True)
        state = TS.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                    device="cpu")
        step = TS.build_train_step(cfg, opt, O.warmup_cosine(1e-2, 0, 10))
        if whole:
            state, met = step(state, batch)
        else:
            state, met = step.apply_gradients(
                state, *step.grads_and_metrics(state.params, batch))
        out.append((state, met))
    (a, ma), (b, mb) = out
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for (na, pa), (nb, pb) in zip(a.params.named_parameters(),
                                  b.params.named_parameters()):
        assert na == nb and torch.equal(pa, pb)


def test_carried_state_continues_like_reference():
    """A reference state after two steps carried by
    ``convert.train_state_from_numpy``: the port's third step equals the
    reference's."""
    cfg = M.get_config("internlm2-1.8b", smoke=True)
    jopt = JO.adamw(quantized=True)
    sched = JO.warmup_cosine(1e-2, 1, 10)
    jstep = jax.jit(JTS.build_train_step(cfg, jopt, sched))
    jstate = JTS.init_train_state(cfg, jopt, jax.random.key(1))
    pipe = JPipeline(cfg, batch=2, seq=16, seed=5)
    for _ in range(2):
        jstate, _ = jstep(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                         pipe.next_batch()))
    jstate_np = jax.tree_util.tree_map(np.asarray, jstate)
    params = model_params_from_numpy(cfg, jstate_np.params, device="cpu")
    opt = O.adamw(quantized=True)
    state = TS.TrainState(TS.trainable(params),
                          train_state_from_numpy(cfg, jstate_np.opt_state, params),
                          None)
    assert int(state.opt_state.step) == 2
    batch = pipe.next_batch()
    jnew, jmet = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch))
    state, met = TS.build_train_step(cfg, opt, O.warmup_cosine(1e-2, 1, 10))(
        state, TS.batch_to_device(batch, "cpu"))
    assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    want = jax.tree_util.tree_map(np.asarray, jnew.params)
    for name, p in state.params.named_parameters():
        assert rel_rms(_np(p), reference_leaf(cfg, want, name)) <= PARAM_RTOL, name


@pytest.mark.parametrize("arch", ["olmo-1b", "musicgen-large"])
def test_remat_equals_no_remat_bit_for_bit(arch):
    check_remat_equals_no_remat(arch)


def test_remat_checkpoints_each_layer(monkeypatch):
    """Under grad with ``cfg.remat`` each layer runs through
    ``torch.utils.checkpoint``; without grad (serving) none does."""
    cfg = M.get_config("olmo-1b", smoke=True)
    calls = []
    real = T.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(T, "checkpoint", spy)
    params = TS.trainable(T.init_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu"))
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with torch.no_grad():
        T.forward(cfg, params, {"tokens": toks})
    assert calls == []
    logits, _ = T.forward(cfg, params, {"tokens": toks})
    assert calls == [False] * cfg.num_layers
    T.forward(cfg.with_overrides(remat=False), params, {"tokens": toks})
    assert len(calls) == cfg.num_layers


def test_compression_and_mesh_arguments():
    cfg = M.get_config("olmo-1b", smoke=True)
    opt = O.adamw()
    sched = O.warmup_cosine(1e-2, 0, 10)
    with pytest.raises(ValueError, match="compression"):
        TS.build_train_step(cfg, opt, sched, compression="fp4")
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(devices=["cpu"])
    state = TS.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                                compression="int8_ef", device="cpu")
    assert set(state.err_fb) == {n for n, _ in state.params.named_parameters()}
    batch = TS.batch_to_device(
        JPipeline(cfg, batch=2, seq=8, seed=0).next_batch(), "cpu")
    # int8_ef without a "pod" axis (no mesh, or a mesh of data and model
    # only) is the reference's no-op: the residuals stay zero.
    for m in (None, mesh):
        state, met = TS.build_train_step(cfg, opt, sched, compression="int8_ef",
                                         mesh=m)(state, batch)
        assert all(not e.any() for e in state.err_fb.values())
        assert torch.isfinite(met["loss"])


def test_cast_differentiable_only_under_grad():
    """``common.cast``: a leaf that requires grad is cast with a
    differentiable ``.to`` under grad (no cached copy), and through the
    cache otherwise."""
    from repro_torch.models.common import cast

    w = torch.nn.Parameter(torch.randn(4, 3))
    y = cast(w, torch.bfloat16)
    assert y.requires_grad and y.grad_fn is not None
    assert getattr(w, "_cast_copy", None) is None
    y.float().sum().backward()
    assert torch.equal(w.grad, torch.ones(4, 3))
    with torch.no_grad():
        a = cast(w, torch.bfloat16)
        assert cast(w, torch.bfloat16) is a and not a.requires_grad
        w.add_(1.0)  # a new version: a new copy
        assert cast(w, torch.bfloat16) is not a


# ---------------------------------------------------------------------------
# The flash kernel's autograd Function
# ---------------------------------------------------------------------------

def _qkv(b, hq, hkv, s, d, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(device=device, dtype=dtype).requires_grad_(True)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def test_cpu_attention_is_chunked_under_autograd():
    q, k, v = _qkv(1, 4, 2, 33, 16, seed=0)
    out = ops.attention(q, k, v)
    assert type(out.grad_fn).__name__ != "FlashAttentionBackward"
    want = ref.chunked_attention(q, k, v, scale=0.25)
    assert torch.equal(out, want)


@pytest.mark.parametrize("hq, hkv, causal", [(4, 4, True), (6, 1, True),
                                            (4, 2, False)])
def test_function_gradient_is_chunked_gradient(hq, hkv, causal, monkeypatch):
    """The Function with its kernel replaced by the kernel's plain version
    (the CPU has no kernel): its forward is the kernel's output, and its
    q/k/v gradients equal autograd through ``ref.chunked_attention``."""
    calls = []

    def plain_kernel(q, k, v, *, scale, causal):
        calls.append(torch.is_grad_enabled())
        return ref.chunked_attention(q, k, v, scale=scale, causal=causal)

    monkeypatch.setattr(kernel, "flash_attention", plain_kernel)
    q, k, v = _qkv(2, hq, hkv, 40, 16, seed=hq)
    g = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, hq, 40, 16)).astype(np.float32))
    out = ops.FlashAttention.apply(q, k, v, 0.25, causal)
    assert calls == [False]  # the forward runs without autograd
    got = torch.autograd.grad(out, (q, k, v), g)
    want_out = ref.chunked_attention(q, k, v, scale=0.25, causal=causal)
    want = torch.autograd.grad(want_out, (q, k, v), g)
    assert torch.equal(out, want_out.detach())
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # Only the inputs that require grad get one.
    k2 = k.detach()
    (gq,) = torch.autograd.grad(ops.FlashAttention.apply(q, k2, v.detach(),
                                                         0.25, causal).sum(), (q,))
    assert gq.shape == q.shape


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, d, hq, hkv", [
    (torch.float32, 64, 4, 4), (torch.float32, 128, 6, 1),
    (torch.bfloat16, 64, 4, 4), (torch.bfloat16, 128, 12, 2)])
def test_cuda_function_launches_kernel_and_gradients_equal_chunked(
        cuda_device, dtype, d, hq, hkv):
    q, k, v = _qkv(2, hq, hkv, 300, d, seed=d + hq, dtype=dtype,
                   device=cuda_device)
    before = (kernel.flash_attention_wgmma.launches,
              kernel.flash_attention_simt.launches)
    out = ops.attention(q, k, v)
    after = (kernel.flash_attention_wgmma.launches,
             kernel.flash_attention_simt.launches)
    wgmma = dtype == torch.bfloat16
    assert after[0] - before[0] == int(wgmma)
    assert after[1] - before[1] == int(not wgmma)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    g = torch.randn(out.shape, device=cuda_device, dtype=dtype)
    got = torch.autograd.grad(out, (q, k, v), g)
    want_out = ref.chunked_attention(q, k, v, scale=d ** -0.5)
    want = torch.autograd.grad(want_out, (q, k, v), g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.abs().max() > 0
        assert torch.equal(a, b)

"""The port's Mamba2 mixer (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the CPU.

Mirrors ``tests/test_ssm.py`` (``_segsum`` values; ``_ssd_chunked``
against the float64 sequential recurrence at chunks 4/8/16/64 within atol
2e-4, chunk-size invariance and continuation from an initial state within
1e-4), then holds each function against the JAX one on the same seeded
inputs (numpy, float32): ``_segsum`` and ``_causal_depthwise_conv``
within atol 1e-6 (one float32 rounding of values of order 1; the two
packages sum the taps in their own order), ``_ssd_chunked``,
``mamba.apply`` and ``mamba.decode`` within atol 1e-5 and a relative RMS
of 1e-5 (float32 summation order only: the port contracts pairwise in a
fixed order, the reference lets XLA choose).  Prefill of S tokens then
one ``decode`` must equal ``apply`` over S+1 tokens within atol 1e-5.
``cast_params`` must keep ``A_log`` / ``dt_bias`` / ``D`` float32, and
``mamba.init`` must give the reference's leaf names, shapes and dtypes.
The ``cuda`` test (skipped without a card) holds the captured decode
step bit-equal to ``eager()`` for both smoke configurations in bfloat16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import ssm as jssm
from repro_torch.configs.base import layer_layout
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.common import cast_params
from test_ssm import _naive_ssd

ARCHS = ["mamba2-370m", "jamba-1.5-large-398b"]
ATOL = 1e-5
RTOL = 1e-5


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))


def close(got: torch.Tensor, want, atol: float = ATOL) -> None:
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol)
    assert rel_rms(got, want) <= RTOL


def ssd_inputs(b, s, h, p, g, n, seed, dt_lo=0.001):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(np.float32),
            rng.uniform(dt_lo, 0.1, size=(b, s, h)).astype(np.float32),
            -rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32),
            rng.normal(size=(b, s, g, n)).astype(np.float32))


def torch_ssd(inputs, chunk, initial_state=None):
    x, dt, A, B, C = (torch.from_numpy(a) for a in inputs)
    init = None if initial_state is None else torch.as_tensor(initial_state)
    return ssm._ssd_chunked(x, dt, A, B, C, chunk, initial_state=init)


def carried_mixer(cfg, seed=0):
    """A reference ``mamba.init`` and the port's parameters holding it."""
    jp = jax.tree_util.tree_map(np.asarray,
                                jssm.mamba.init(cfg, jax.random.key(seed)))
    p = ssm.mamba.init(cfg, None, "meta").to_empty(device="cpu")
    with torch.no_grad():
        for name, t in p.named_parameters():
            leaf = jp
            for key in name.split("."):
                leaf = leaf[key]
            t.copy_(torch.from_numpy(np.array(leaf, np.float32)))
    return jp, p


@pytest.fixture(scope="module", params=ARCHS)
def mixer(request):
    cfg = M.get_config(request.param, smoke=True)
    return (cfg, *carried_mixer(cfg))


# ---------------------------------------------------------------------------
# tests/test_ssm.py, on the port
# ---------------------------------------------------------------------------


def test_segsum_values():
    ss = ssm._segsum(torch.tensor([1.0, 2.0, 3.0])).numpy()
    assert ss[0, 0] == 0.0
    assert ss[1, 0] == 2.0
    assert ss[2, 0] == 5.0
    assert ss[2, 1] == 3.0
    assert np.isneginf(ss[0, 1])


@pytest.mark.parametrize("chunk", [4, 8, 16, 64])
def test_ssd_matches_naive_recurrence(chunk):
    inputs = ssd_inputs(2, 64, 4, 8, 1, 16, seed=42)
    y, final = torch_ssd(inputs, chunk)
    y_ref, state_ref = _naive_ssd(*inputs)
    np.testing.assert_allclose(y.numpy(), y_ref, atol=2e-4)
    np.testing.assert_allclose(final.numpy(), state_ref, atol=2e-4)


def test_ssd_chunk_size_invariance():
    inputs = ssd_inputs(1, 32, 2, 4, 1, 8, seed=43, dt_lo=0.01)
    y8, _ = torch_ssd(inputs, 8)
    y16, _ = torch_ssd(inputs, 16)
    np.testing.assert_allclose(y8.numpy(), y16.numpy(), atol=1e-4)


def test_ssd_initial_state_continuation():
    """[first half] then [second half from the carried state] equals the
    whole sequence."""
    inputs = ssd_inputs(1, 32, 2, 4, 1, 8, seed=44, dt_lo=0.01)
    first = [a[:, :16] if a.ndim > 1 else a for a in inputs]
    second = [a[:, 16:] if a.ndim > 1 else a for a in inputs]
    y_full, final_full = torch_ssd(inputs, 8)
    y1, st = torch_ssd(first, 8)
    y2, final2 = torch_ssd(second, 8, initial_state=st)
    np.testing.assert_allclose(y_full[:, :16].numpy(), y1.numpy(), atol=1e-4)
    np.testing.assert_allclose(y_full[:, 16:].numpy(), y2.numpy(), atol=1e-4)
    np.testing.assert_allclose(final_full.numpy(), final2.numpy(), atol=1e-4)


def test_ssd_rejects_a_ragged_chunk():
    """The reference asserts s % cl == 0; the port raises, naming the
    chunk, before any reshape."""
    with pytest.raises(ValueError, match="chunk 64"):
        torch_ssd(ssd_inputs(1, 100, 2, 4, 1, 8, seed=45), 64)


# ---------------------------------------------------------------------------
# Each function against the JAX one
# ---------------------------------------------------------------------------


def test_segsum_equals_jax():
    a = np.random.default_rng(46).normal(size=(2, 3, 16)).astype(np.float32)
    got = ssm._segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    live = ~np.isneginf(want)
    np.testing.assert_allclose(got[live], want[live], atol=1e-6)


@pytest.mark.parametrize("chunk, init", [(8, False), (16, True), (64, False)])
def test_ssd_equals_jax(chunk, init):
    """Four heads over two groups (B, C repeated per group), with and
    without an initial state."""
    inputs = ssd_inputs(2, 64, 4, 8, 2, 16, seed=47)
    st = (np.random.default_rng(48).normal(size=(2, 4, 8, 16)).astype(np.float32)
          if init else None)
    y, final = torch_ssd(inputs, chunk, st)
    jy, jfinal = jssm._ssd_chunked(*(jnp.asarray(a) for a in inputs), chunk,
                                   initial_state=None if st is None
                                   else jnp.asarray(st))
    assert y.dtype == torch.float32 and final.dtype == torch.float32
    close(y, jy)
    close(final, jfinal)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_depthwise_conv_equals_jax(with_state):
    rng = np.random.default_rng(49)
    x = rng.normal(size=(2, 12, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_state else None
    got, got_state = ssm._causal_depthwise_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if st is None else torch.from_numpy(st))
    want, want_state = jssm._causal_depthwise_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))


def test_mamba_apply_equals_jax(mixer):
    cfg, jp, p = mixer
    x = np.random.default_rng(50).normal(size=(2, 32, cfg.d_model)).astype(
        np.float32)
    out, states = ssm.mamba.apply(cfg, p, torch.from_numpy(x), None)
    jout, jstates = jssm.mamba.apply(cfg, jp, jnp.asarray(x), None)
    close(out, jout)
    assert set(states) == set(jstates) == {"conv", "ssm"}
    for name in states:
        close(states[name], jstates[name])


def test_mamba_decode_equals_jax(mixer):
    """One step from random states, both caches; the port's are updated
    in place."""
    cfg, jp, p = mixer
    rng = np.random.default_rng(51)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    cache = ssm.mamba.init_cache(cfg, 3, torch.float32, "cpu")
    for t in cache.values():
        t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)))
    # Copies: jnp.asarray may alias a numpy buffer the port then updates.
    jcache = {k: jnp.asarray(t.numpy().copy()) for k, t in cache.items()}
    jout, jnew = jssm.mamba.decode(cfg, jp, jnp.asarray(x), jcache, 7)
    bufs = dict(cache)
    out, new = ssm.mamba.decode(cfg, p, torch.from_numpy(x), cache, 7)
    assert new is cache and all(new[k] is bufs[k] for k in bufs)
    close(out, jout)
    for name in new:
        close(new[name], jnew[name])


def test_prefill_then_decode_equals_apply(mixer):
    """``apply`` over S tokens, then ``decode`` of token S+1 from its
    states, equals ``apply`` over the S+1 tokens (the port alone)."""
    cfg, _, p = mixer
    S = 15
    x = torch.from_numpy(np.random.default_rng(52).normal(
        size=(2, S + 1, cfg.d_model)).astype(np.float32))
    full, full_states = ssm.mamba.apply(cfg, p, x, None)
    _, states = ssm.mamba.apply(cfg, p, x[:, :S], None)
    out, cache = ssm.mamba.decode(cfg, p, x[:, S:], states, S)
    np.testing.assert_allclose(out.numpy(), full[:, S:].numpy(), atol=ATOL)
    for name in cache:
        np.testing.assert_allclose(cache[name].numpy(),
                                   full_states[name].numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_leaves_equal_reference(arch, param_dtype):
    """Leaf names, shapes and dtypes equal the reference's ``mamba.init``;
    A_log, dt_bias and D float32 under any ``param_dtype``."""
    cfg = M.get_config(arch, smoke=True).with_overrides(param_dtype=param_dtype)
    jp = jssm.mamba.init(cfg, jax.random.key(0))
    want = {jax.tree_util.keystr(path, simple=True, separator="."):
            (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    p = ssm.mamba.init(cfg, torch.Generator().manual_seed(0), "cpu")
    got = {name: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for name, t in p.named_parameters()}
    assert got == want
    for name in ("A_log", "dt_bias", "D"):
        assert p[name].dtype == torch.float32


def test_init_seeded_and_drawn_the_reference_way():
    """Equal seeds give equal parameters; dt_bias is the inverse softplus
    of a dt in [1e-3, 1e-1], A_log = log U[1, 16], D = 1."""
    cfg = M.get_config("mamba2-370m", smoke=True)
    a = ssm.mamba.init(cfg, torch.Generator().manual_seed(3), "cpu")
    b = ssm.mamba.init(cfg, torch.Generator().manual_seed(3), "cpu")
    for (na, ta), (nb, tb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(ta, tb) and not ta.requires_grad
    dt = torch.nn.functional.softplus(a["dt_bias"])
    assert bool(((dt >= 1e-3 * (1 - 1e-5)) & (dt <= 0.1 * (1 + 1e-5))).all())
    assert bool(((a["A_log"] >= 0) & (a["A_log"] <= np.log(16.0))).all())
    assert torch.equal(a["D"], torch.ones(cfg.ssm_heads))


def test_cast_params_keeps_ssm_leaves_float32():
    """The decode step reads the tree ``cast_params`` gives: A_log,
    dt_bias and D must stay the float32 parameters (as the MoE router
    does), the weights cast."""
    from repro_torch.models import transformer as T

    cfg = M.get_config("jamba-1.5-large-398b", smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tree = cast_params(params, torch.bfloat16)
    for L, spec in enumerate(layer_layout(cfg)):
        mix, own = tree["layers"][L]["mixer"], params["layers"][L]["mixer"]
        if spec.mixer != "mamba":
            continue
        for name in ("A_log", "dt_bias", "D"):
            assert mix[name] is own[name] and mix[name].dtype == torch.float32
        assert mix["in_proj"]["w"].dtype == torch.bfloat16
        assert mix["conv"]["w"].dtype == torch.bfloat16
        assert mix["ssm_norm"]["scale"].dtype == torch.bfloat16
        if spec.ffn == "moe":
            assert tree["layers"][L]["ffn"]["router"]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# On the card (skip here)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_ssm_decode_capture_equals_eager(card, arch):
    """The batched decode step with Mamba2 layers (and jamba's attention
    and MoE layers) captured as a CUDA graph: the replay bit-equal to
    ``eager()`` from identical cache copies, conv and ssm caches
    included."""
    from repro_torch import compile as tc
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    cfg = M.get_config(arch, smoke=True).with_overrides(dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                           device=card)
    b = serve.ContinuousBatcher(cfg, params, 2, 32)
    rng = np.random.default_rng(4)
    for r in range(2):
        assert b.admit(r, rng.integers(0, cfg.vocab_size, 9).astype(np.int32))
    b.step()  # captures
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 1)),
                           dtype=torch.int32, device=card)
    twin = [{n: t.clone() for n, t in c.items()} for c in b.caches]
    n = tc.compile_count()
    got, _ = b._decode(toks, 10)
    assert tc.compile_count() == n  # a replay
    programmed, b.caches = b.caches, twin
    with tc.eager():
        want, _ = b._decode(toks, 10)
    assert torch.equal(got, want)
    for a, c in zip(programmed, twin):
        assert all(torch.equal(a[k], c[k]) for k in a)
    assert any("ssm" in c for c in programmed)

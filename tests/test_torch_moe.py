"""The port's dropless MoE FFN against ``repro.models.ffn.moe_ffn``.

Mirrors ``tests/test_moe.py`` on the port (dropless dispatch against a
dense per-expert reference, no token dropped under a rigged router,
``norm_topk``, shared experts added, ``impl="ep"`` without a mesh, the
uniform-router aux loss), then holds the port against JAX on the same
weights and inputs, made from a seed with numpy:

* ``route``: the top-k expert ids exactly equal, ties included (a zero
  router makes every probability equal; JAX orders ties by expert id),
  the top-k probabilities and the aux loss within 1e-6.
* ``_dropless`` and ``apply``: within a relative RMS error of ``RTOL``
  (float32 on both sides; the two differ in summation order only, some
  1e-7 relative).  MoE outputs are small (a few 1e-3 at smoke width), so
  an absolute tolerance of 1e-4 would pass almost any output; the
  relative one does not, and a negative control (``norm_topk`` flipped,
  which rescales each token's combine weights) must fail it.

The CPU route of the grouped SwiGLU is the loop over experts; the
card's ``torch._grouped_mm`` route is held against it in the ``cuda``
tests at the end (skipped without a card).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ModelConfig as JModelConfig
from repro.models.ffn import dense_ffn as j_dense_ffn
from repro.models.ffn import moe_ffn as j_moe_ffn
from repro_torch.configs.base import ModelConfig, layer_layout
from repro_torch.models import ffn
from repro_torch.models import model as M
from repro_torch.models.common import dtype_of
from repro_torch.models.ffn import dense_ffn, moe_ffn

CFG_KW = dict(name="moe-test", family="moe", num_layers=2, d_model=32,
              vocab_size=64, num_experts=8, top_k=2, moe_d_ff=16,
              aux_loss_coef=0.01)
CFG = ModelConfig(**CFG_KW)
J_CFG = JModelConfig(**CFG_KW)
# Relative RMS error of an MoE output against JAX's (float32 both sides).
RTOL = 1e-5
SMOKE_ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"]


def j_config(cfg: ModelConfig) -> JModelConfig:
    return JModelConfig(**{f: getattr(cfg, f)
                           for f in cfg.__dataclass_fields__})


def jax_moe(cfg: ModelConfig, seed: int) -> dict:
    return j_moe_ffn.init(j_config(cfg), jax.random.key(seed))


def to_torch(tree):
    """A JAX parameter pytree as nested dicts of CPU tensors (the form
    ``cast_params`` gives the layer functions)."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def inputs(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))


def dense_reference(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """Every expert on every token, combined by the router's weights."""
    B, S, D = x.shape
    x_flat = x.reshape(-1, D)
    top_p, top_i, _ = moe_ffn.route(cfg, p, x_flat)
    out = torch.zeros_like(x_flat)
    for e in range(cfg.num_experts):
        ex = p["experts"]
        y_e = (torch.nn.functional.silu(x_flat @ ex["w_gate"][e])
               * (x_flat @ ex["w_up"][e])) @ ex["w_down"][e]
        for k in range(cfg.top_k):
            sel = top_i[:, k] == e
            out[sel] += top_p[sel, k, None] * y_e[sel]
    return out.reshape(B, S, D)


# ---------------------------------------------------------------------------
# tests/test_moe.py on the port
# ---------------------------------------------------------------------------


class TestDroplessDispatch:
    def test_matches_dense_reference(self):
        p = to_torch(jax_moe(CFG, 0))
        x = torch.from_numpy(inputs((2, 8, 32), 1))
        out, aux = moe_ffn.apply(CFG, p, x)
        np.testing.assert_allclose(out.numpy(), dense_reference(CFG, p, x).numpy(),
                                   atol=1e-6)
        assert rel_rms(out, dense_reference(CFG, p, x)) <= RTOL
        assert float(aux) > 0

    def test_no_token_dropped(self):
        """Every token routed to expert 3 still gets an output."""
        p = to_torch(jax_moe(CFG, 1))
        w = torch.zeros(32, 8)
        w[:, 3] = 10.0
        p["router"]["w"] = w
        x = torch.from_numpy(inputs((1, 16, 32), 2))
        out, _ = moe_ffn.apply(CFG, p, x)
        assert bool((out[0].norm(dim=-1) > 0).all())
        np.testing.assert_allclose(out.numpy(), dense_reference(CFG, p, x).numpy(),
                                   atol=1e-6)

    def test_norm_topk(self):
        cfg = CFG.with_overrides(norm_topk=True)
        p = to_torch(jax_moe(cfg, 0))
        x = torch.from_numpy(inputs((4, 32), 3))
        top_p, _, _ = moe_ffn.route(cfg, p, x)
        np.testing.assert_allclose(top_p.sum(-1).numpy(), 1.0, rtol=1e-5)

    def test_shared_experts_added(self):
        cfg = CFG.with_overrides(num_shared_experts=2)
        p = to_torch(jax_moe(cfg, 0))
        x = torch.from_numpy(inputs((1, 4, 32), 4))
        out_with, _ = moe_ffn.apply(cfg, p, x)
        shared = dense_ffn.apply(cfg, p["shared"], x)
        out_without, _ = moe_ffn.apply(cfg, {k: v for k, v in p.items()
                                             if k != "shared"}, x)
        np.testing.assert_allclose(out_with.numpy(),
                                   (out_without + shared).numpy(), atol=1e-6)


class TestExpertParallel:
    def test_ep_without_mesh_equals_plain(self):
        """Without a mesh ``impl="ep"`` is the plain path, as the
        reference's is when no mesh is set (the mesh: test_torch_sharding)."""
        p = to_torch(jax_moe(CFG, 2))
        x = torch.from_numpy(inputs((2, 8, 32), 5))
        plain, aux1 = moe_ffn.apply(CFG, p, x)
        ep, aux2 = moe_ffn.apply(CFG, p, x, impl="ep")
        assert torch.equal(plain, ep) and float(aux1) == float(aux2)
        with pytest.raises(ValueError, match="impl"):
            moe_ffn.apply(CFG, p, x, impl="shard_map")

    def test_aux_loss_balanced_routing_near_one(self):
        """For a uniform router the Switch aux loss is 1 (its minimum),
        and equal to JAX's."""
        cfg = CFG.with_overrides(aux_loss_coef=1.0)
        jp = jax_moe(cfg, 3)
        jp["router"]["w"] = jnp.zeros((32, 8))
        p = to_torch(jp)
        x = inputs((4, 64, 32), 6)
        _, aux = moe_ffn.apply(cfg, p, torch.from_numpy(x))
        _, jaux = j_moe_ffn.apply(j_config(cfg), jp, jnp.asarray(x))
        assert float(aux) == pytest.approx(1.0, abs=0.3)
        assert float(aux) == pytest.approx(float(jaux), abs=1e-6)


# ---------------------------------------------------------------------------
# Parity with JAX
# ---------------------------------------------------------------------------


def _route_pair(cfg, jp, x):
    jtp, jti, jaux = j_moe_ffn.route(j_config(cfg), jp, jnp.asarray(x))
    tp, ti, aux = moe_ffn.route(cfg, to_torch(jp), torch.from_numpy(x))
    return (tp, ti, aux), (np.asarray(jtp), np.asarray(jti), float(jaux))


@pytest.mark.parametrize("router", ["random", "uniform", "two_tied"])
@pytest.mark.parametrize("norm_topk", [False, True])
def test_route_equals_jax(router, norm_topk):
    cfg = CFG.with_overrides(norm_topk=norm_topk, top_k=3)
    jp = jax_moe(cfg, 4)
    if router == "uniform":  # every probability equal: ties decide
        jp["router"]["w"] = jnp.zeros((32, 8))
    elif router == "two_tied":  # experts 2 and 6 tie for first place
        w = np.zeros((32, 8), np.float32)
        w[:, 2] = w[:, 6] = 1.0
        jp["router"]["w"] = jnp.asarray(w)
    x = inputs((40, 32), 7)
    (tp, ti, aux), (jtp, jti, jaux) = _route_pair(cfg, jp, x)
    np.testing.assert_array_equal(ti.numpy(), jti)
    np.testing.assert_allclose(tp.numpy(), jtp, atol=1e-6)
    assert float(aux) == pytest.approx(jaux, abs=1e-6)
    if router == "uniform":
        np.testing.assert_array_equal(ti.numpy(), np.tile([0, 1, 2], (40, 1)))


def _smoke_moe_cfgs():
    cases = []
    for arch in SMOKE_ARCHS:
        cfg = M.get_config(arch, smoke=True)
        cases.append(pytest.param(cfg, id=arch))
        cases.append(pytest.param(
            cfg.with_overrides(num_shared_experts=1 + cfg.num_shared_experts),
            id=f"{arch}-shared{1 + cfg.num_shared_experts}"))
    return cases


@pytest.mark.parametrize("cfg", _smoke_moe_cfgs())
def test_dropless_and_apply_equal_jax(cfg):
    """At each smoke width (and with one more shared expert): the
    routing exactly, the dispatch and the layer within RTOL relative RMS,
    the aux loss within 1e-6."""
    jcfg = j_config(cfg)
    jp = jax_moe(cfg, 5)
    p = to_torch(jp)
    x = inputs((2, 24, cfg.d_model), 8)
    x_flat = x.reshape(-1, cfg.d_model)
    (tp, ti, _), (jtp, jti, _) = _route_pair(cfg, jp, x_flat)
    np.testing.assert_array_equal(ti.numpy(), jti)
    want = j_moe_ffn._dropless(jcfg, jp["experts"], jnp.asarray(x_flat),
                               jnp.asarray(jtp), jnp.asarray(jti))
    got = moe_ffn._dropless(cfg, p["experts"], torch.from_numpy(x_flat), tp, ti)
    assert rel_rms(got, want) <= RTOL
    out, aux = moe_ffn.apply(cfg, p, torch.from_numpy(x))
    jout, jaux = j_moe_ffn.apply(jcfg, jp, jnp.asarray(x))
    assert rel_rms(out, jout) <= RTOL
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)
    if "shared" in p:  # the shared experts were added, as JAX adds them
        shared = j_dense_ffn.apply(jcfg, jp["shared"], jnp.asarray(x))
        assert rel_rms(out, jout - shared) > 100 * RTOL


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_negative_control_fails_the_tolerance(arch):
    """``norm_topk`` flipped on the port's side alone must fall outside
    RTOL: the tolerance sees a wrong combine weight."""
    cfg = M.get_config(arch, smoke=True)
    jp = jax_moe(cfg, 6)
    x = inputs((2, 24, cfg.d_model), 9)
    jout, _ = j_moe_ffn.apply(j_config(cfg), jp, jnp.asarray(x))
    flipped = cfg.with_overrides(norm_topk=not cfg.norm_topk)
    out, _ = moe_ffn.apply(flipped, to_torch(jp), torch.from_numpy(x))
    assert rel_rms(out, jout) > 100 * RTOL


@pytest.mark.parametrize("arch", SMOKE_ARCHS + ["qwen3-moe-30b-a3b-bf16"])
def test_init_leaves_match_reference(arch):
    """Leaf names, shapes and dtypes equal the reference's init, so
    ``convert.model_params_from_numpy`` maps them name for name; the
    router stays float32 under a bfloat16 ``param_dtype``."""
    bf16 = arch.endswith("-bf16")
    cfg = M.get_config(arch.removesuffix("-bf16"), smoke=True)
    if bf16:
        cfg = cfg.with_overrides(param_dtype="bfloat16")
    jp = jax_moe(cfg, 0)
    want = {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    p = moe_ffn.init(cfg, torch.Generator().manual_seed(0), "cpu")
    got = {n.replace(".", "/"): (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for n, t in p.named_parameters()}
    assert got == want
    assert p["router"]["w"].dtype == torch.float32
    assert p["experts"]["w_gate"].dtype == dtype_of(cfg.param_dtype)


def test_grouped_swiglu_routes_and_offsets():
    """The shared dispatch state: group sizes and cumulative offsets,
    empty groups included; the CPU route is the loop."""
    cfg = CFG
    p = to_torch(jax_moe(cfg, 7))
    w = torch.zeros(32, 8)
    w[:, 5] = 4.0
    w[:, 1] = 2.0  # every token to experts 5 then 1; the other six empty
    p["router"]["w"] = w
    x = torch.from_numpy(np.abs(inputs((6, 32), 10)))  # positive logits
    seen = {}

    def spy(x_sorted, group_sizes, offs, *ws):
        seen.update(sizes=group_sizes.clone(), offs=offs.clone())
        return ffn.grouped_swiglu_loop(x_sorted, group_sizes, offs, *ws)

    orig = ffn.grouped_swiglu
    ffn.grouped_swiglu = spy
    try:
        top_p, top_i, _ = moe_ffn.route(cfg, p, x)
        moe_ffn._dropless(cfg, p["experts"], x, top_p, top_i)
    finally:
        ffn.grouped_swiglu = orig
    assert seen["sizes"].tolist() == [0, 6, 0, 0, 0, 6, 0, 0]
    assert seen["offs"].dtype == torch.int32
    assert seen["offs"].tolist() == [0, 6, 6, 6, 6, 12, 12, 12]
    with pytest.raises(ValueError, match="CUDA"):
        ffn.grouped_swiglu_mm(x, seen["sizes"], seen["offs"],
                              *p["experts"].values())


# ---------------------------------------------------------------------------
# On the card (skip here)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_cuda_grouped_mm_equals_loop(card, arch):
    """``torch._grouped_mm`` against the loop on the same bfloat16 sorted
    rows, within a relative RMS of 2^-6 (each side rounds every GEMM's
    output to bfloat16 once, some 2^-9 relative an element); a float32
    input raises."""
    cfg = M.get_config(arch, smoke=True)
    p = moe_ffn.init(cfg, torch.Generator(device=card).manual_seed(0), card)
    x = torch.randn(64, cfg.d_model, device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
    top_p, top_i, _ = moe_ffn.route(cfg, p, x)
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    x_sorted = x[order // cfg.top_k].to(torch.bfloat16)
    sizes = torch.bincount(flat_e, minlength=cfg.num_experts)
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    ws = [t.to(torch.bfloat16) for t in p["experts"].values()]
    n = ffn.grouped_swiglu_mm.launches
    got = ffn.grouped_swiglu(x_sorted, sizes, offs, *ws)
    assert ffn.grouped_swiglu_mm.launches == n + 1
    want = ffn.grouped_swiglu_loop(x_sorted, sizes, offs, *ws)
    assert rel_rms(got.float().cpu(), want.float().cpu()) <= 2.0 ** -6
    with pytest.raises(TypeError, match="grouped GEMM"):
        ffn.grouped_swiglu(x_sorted.float(), sizes, offs,
                           *[w.float() for w in ws])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_cuda_moe_decode_capture_equals_eager(card, arch):
    """A decode step with MoE layers (and MLA for deepseek) captured as a
    CUDA graph: the replay bit-equal to ``eager()`` from identical cache
    copies, the grouped GEMM counted through the replay."""
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
    n, launches = tc.compile_count(), ffn.grouped_swiglu_mm.launches
    got, _ = b._decode(toks, 10)
    assert tc.compile_count() == n  # a replay
    moe_layers = sum(s.ffn == "moe" for s in layer_layout(cfg))
    assert ffn.grouped_swiglu_mm.launches == launches + moe_layers
    programmed, b.caches = b.caches, twin
    with tc.eager():
        want, _ = b._decode(toks, 10)
    assert torch.equal(got, want)
    for a, c in zip(programmed, twin):
        assert all(torch.equal(a[k], c[k]) for k in a)

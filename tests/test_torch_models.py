"""The port's model stack against ``repro.models`` at smoke size.

Parameters come from the reference's ``init_params`` and are carried
into the port with ``convert.model_params_from_numpy``; the same seeded
token batches go through both.  For the four dense text architectures
(every layer ``attn`` + ``dense``), the two MoE ones
(``qwen3-moe-30b-a3b``: GQA + MoE on every layer; ``deepseek-v2-lite-16b``:
MLA, a dense layer 0, then MoE with shared experts) and the two SSM ones
(``mamba2-370m``: Mamba2 layers with no FFN, one stacked group repeated;
``jamba-1.5-large-398b``: Mamba2 and GQA at 7:1, dense and MoE FFNs
alternating) the port's ``forward`` logits and aux loss, ``prefill``
logits and caches (GQA's K/V, MLA's ``c_kv`` / ``k_rope``, Mamba2's
``conv`` / ``ssm`` states), and one ``decode_step``'s logits and caches
are held against JAX within atol 1e-4, the bound
``tests/test_models.py`` puts on decode against forward (float32 smoke
configs; the two packages differ in summation order only), and the
logits also within a relative RMS of ``LOGIT_RTOL`` (an MoE layer's
output is a few 1e-3 at smoke width, so atol alone says little; the
layer itself is held relatively in ``tests/test_torch_moe.py``).  The
aux loss is held within 1e-6.  The config registry, layer layouts and
parameter counts (total and active) are compared with the reference for
all ten configs.  The two modality stubs are held in
``tests/test_torch_modality.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import REGISTRY as J_REGISTRY
from repro.configs.base import layer_layout as j_layer_layout
from repro.configs.base import scan_grouping as j_scan_grouping
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.configs import REGISTRY
from repro_torch.configs.base import layer_layout, scan_grouping
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from _torch_threads import one_thread  # noqa: F401 (autouse)

DENSE_ARCHS = ["internlm2-1.8b", "olmo-1b", "mistral-nemo-12b", "qwen1.5-110b"]
MOE_ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"]
SSM_ARCHS = ["mamba2-370m", "jamba-1.5-large-398b"]
PORTED = DENSE_ARCHS + MOE_ARCHS + SSM_ARCHS
ATOL = 1e-4
LOGIT_RTOL = 1e-5
B, S, MAX = 2, 16, 32


def carried(arch, seed=0):
    cfg = M.get_config(arch, smoke=True)
    jparams = JT.init_params(cfg, jax.random.key(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, jparams, model_params_from_numpy(cfg, tree, device="cpu")


def tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def jax_layer_cache(cfg, jcaches, L):
    """Layer L's cache dict from the reference's tree: prefix layer L, or
    group g's ``layer{i}`` stacked on a leading axis (as
    ``convert.model_params_from_numpy`` maps the parameters)."""
    prefix, _, group = scan_grouping(cfg)
    if L < len(prefix):
        return {n: np.asarray(a) for n, a in jcaches[f"prefix{L}"].items()}
    g, i = divmod(L - len(prefix), len(group))
    return {n: np.asarray(a[g])
            for n, a in jcaches["groups"][f"layer{i}"].items()}


def cache_shapes(cfg):
    """The port's per-layer cache shapes at (B, MAX); Mamba2's states
    have no sequence axis."""
    shapes = {
        "mla": {"c_kv": (B, MAX, cfg.kv_lora_rank),
                "k_rope": (B, MAX, cfg.qk_rope_head_dim)},
        "attn": {"k": (B, MAX, cfg.num_kv_heads, cfg.head_dim),
                 "v": (B, MAX, cfg.num_kv_heads, cfg.head_dim)},
        "mamba": {"conv": (B, cfg.ssm_conv - 1,
                           cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state),
                  "ssm": (B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)},
    }
    return [shapes[s.mixer] for s in layer_layout(cfg)]


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))


def assert_logits(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert rel_rms(got.numpy(), want) <= LOGIT_RTOL


@pytest.fixture(scope="module", params=PORTED)
def arch_state(request):
    return carried(request.param)


def test_forward_logits_equal_jax(arch_state):
    cfg, jparams, params = arch_state
    toks = tokens(cfg, (B, S), seed=1)
    want, jaux = JT.forward(cfg, jparams, {"tokens": jnp.asarray(toks)})
    got, aux = T.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, cfg.padded_vocab_size)
    assert_logits(got, want)
    assert aux.dtype == torch.float32
    if cfg.num_experts:
        assert float(aux) > 0
        assert float(aux) == pytest.approx(float(jaux), abs=1e-6)
    else:
        assert float(aux) == float(jaux) == 0.0


def test_prefill_and_decode_step_equal_jax(arch_state):
    cfg, jparams, params = arch_state
    toks = tokens(cfg, (B, S + 1), seed=2)
    jl, jc = JT.prefill(cfg, jparams, {"tokens": jnp.asarray(toks[:, :S])},
                        max_len=MAX)
    tl, tc = T.prefill(cfg, params, {"tokens": torch.from_numpy(toks[:, :S])},
                       max_len=MAX)
    assert_logits(tl, jl)
    assert len(tc) == cfg.num_layers
    for L, (cache, shapes) in enumerate(zip(tc, cache_shapes(cfg))):
        want_cache = jax_layer_cache(cfg, jc, L)
        assert set(cache) == set(want_cache) == set(shapes)
        for name, want in want_cache.items():
            assert cache[name].shape == want.shape == shapes[name]
            np.testing.assert_allclose(cache[name].numpy(), want, atol=ATOL)

    nxt = toks[:, S:S + 1]
    jl2, jc2 = JT.decode_step(cfg, jparams, jc, jnp.asarray(nxt), jnp.int32(S))
    tl2, tc2 = T.decode_step(cfg, params, tc, torch.from_numpy(nxt), S)
    assert tc2 is tc  # updated in place
    assert_logits(tl2, jl2)
    for L, cache in enumerate(tc2):
        for name, want in jax_layer_cache(cfg, jc2, L).items():
            np.testing.assert_allclose(cache[name].numpy(), want, atol=ATOL)


def test_decode_matches_forward(arch_state):
    """The port alone: prefill + two decode steps == forward over the
    prompt and the two tokens."""
    cfg, _, params = arch_state
    toks = torch.from_numpy(tokens(cfg, (B, S + 2), seed=3))
    logits_pre, caches = T.prefill(cfg, params, {"tokens": toks[:, :S]},
                                   max_len=MAX)
    full, _ = T.forward(cfg, params, {"tokens": toks})
    np.testing.assert_allclose(logits_pre[:, 0].numpy(), full[:, S - 1].numpy(),
                               atol=ATOL)
    for i in range(2):
        logits, caches = T.decode_step(cfg, params, caches,
                                       toks[:, S + i:S + i + 1], S + i)
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, S + i].numpy(), atol=ATOL)


@pytest.mark.parametrize("arch", sorted(J_REGISTRY))
def test_configs_layout_and_grouping_equal_reference(arch):
    for full, jfull in zip(REGISTRY[arch], J_REGISTRY[arch]):
        assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
        assert full.padded_vocab_size == jfull.padded_vocab_size
        assert ([(s.mixer, s.ffn) for s in layer_layout(full)]
                == [(s.mixer, s.ffn) for s in j_layer_layout(jfull)])
        prefix, g, group = scan_grouping(full)
        jprefix, jg, jgroup = j_scan_grouping(jfull)
        assert g == jg
        assert [(s.mixer, s.ffn) for s in prefix + group] \
            == [(s.mixer, s.ffn) for s in jprefix + jgroup]


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", PORTED)
def test_param_count_equals_reference(arch, smoke):
    cfg = M.get_config(arch, smoke=smoke)
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(
        JM.get_config(arch, smoke=smoke))
    assert cfg.param_count() == M.count_params_analytic(cfg)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", PORTED)
def test_active_param_count_equals_reference(arch, smoke):
    """``active_only`` scales the routed experts by top_k / num_experts,
    as the reference does; without experts it changes nothing."""
    cfg = M.get_config(arch, smoke=smoke)
    n = M.count_params_analytic(cfg, active_only=True)
    assert n == JM.count_params_analytic(JM.get_config(arch, smoke=smoke),
                                         active_only=True)
    assert cfg.active_param_count() == n
    if cfg.num_experts:
        assert n < M.count_params_analytic(cfg)
    else:
        assert n == M.count_params_analytic(cfg)


def test_internlm2_full_size_count():
    """The full-width configuration the card serves: 1.89 B parameters."""
    assert M.count_params_analytic(M.get_config("internlm2-1.8b")) == 1_889_634_304


@pytest.mark.parametrize("arch, total, active", [
    ("qwen3-moe-30b-a3b", 30_532_634_624, 3_353_544_704),
    ("deepseek-v2-lite-16b", 15_706_470_400, 2_661_136_384)])
def test_moe_full_size_counts(arch, total, active):
    """The two MoE configurations the card serves, total and active."""
    cfg = M.get_config(arch)
    assert M.count_params_analytic(cfg) == total
    assert M.count_params_analytic(cfg, active_only=True) == active


@pytest.mark.parametrize("arch, total, active, layers", [
    ("mamba2-370m", 368_494_080, 368_494_080, 48),
    ("jamba-1.5-large-398b", 397_530_179_040, 93_124_371_936, 72),
    ("jamba-1.5-large-398b", 23_980_632_192, None, 5)])
def test_ssm_full_size_counts(arch, total, active, layers):
    """The SSM configurations the card serves: mamba2 whole, jamba whole
    and cut to its first 5 layers (4 Mamba2, the attention layer at
    offset 4, MoE at layers 1 and 3), the cut the card holds in bfloat16
    parameters (44.7 GiB)."""
    cfg = M.get_config(arch).with_overrides(num_layers=layers)
    assert M.count_params_analytic(cfg) == total
    if active is not None:
        assert M.count_params_analytic(cfg, active_only=True) == active
    if layers == 5:
        assert [(s.mixer, s.ffn) for s in layer_layout(cfg)] == [
            ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
            ("mamba", "moe"), ("attn", "dense")]


def test_jamba_five_layer_cut_carries_and_equals_jax():
    """The depth cut the card serves (jamba's first 5 layers) is one
    reference group of 5 layers: every leaf carries, and the forward
    equals JAX's."""
    cfg = M.get_config("jamba-1.5-large-398b", smoke=True).with_overrides(
        num_layers=5)
    prefix, groups, group = j_scan_grouping(cfg)
    assert (len(prefix), groups, len(group)) == (0, 1, 5)
    jparams = JT.init_params(cfg, jax.random.key(3))
    params = model_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    toks = tokens(cfg, (B, S), seed=4)
    want, _ = JT.forward(cfg, jparams, {"tokens": jnp.asarray(toks)})
    got, _ = T.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    assert_logits(got, want)


def test_ssm_init_layout():
    """mamba2: no post_norm / FFN on any layer, the float32 A_log /
    dt_bias / D under a bfloat16 ``param_dtype``; jamba: the caches by
    mixer, the SSM state float32 in a bfloat16 model."""
    cfg = M.get_config("mamba2-370m", smoke=True).with_overrides(
        param_dtype="bfloat16", dtype="bfloat16")
    names = dict(T.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu").named_parameters())
    assert not any(".post_norm." in n or ".ffn." in n for n in names)
    for leaf in ("A_log", "dt_bias", "D"):
        assert names[f"layers.1.mixer.{leaf}"].dtype == torch.float32
    assert names["layers.1.mixer.in_proj.w"].dtype == torch.bfloat16
    jamba = M.get_config("jamba-1.5-large-398b", smoke=True).with_overrides(
        dtype="bfloat16")
    caches = T.init_decode_caches(jamba, 2, 8, device="cpu")
    assert [sorted(c) for c in caches] == [
        ["k", "v"] if s.mixer == "attn" else ["conv", "ssm"]
        for s in layer_layout(jamba)]
    assert caches[0]["conv"].dtype == torch.bfloat16
    assert caches[0]["ssm"].dtype == torch.float32


@pytest.mark.parametrize("entry", ["init_params", "init_decode_caches"])
def test_default_device_raises_without_card(entry):
    """Both entry points default to the card, as the rest of the port."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = M.get_config("olmo-1b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "init_params":
            T.init_params(cfg, torch.Generator().manual_seed(0))
        else:
            T.init_decode_caches(cfg, 1, 8)


def test_init_params_seeded_and_shaped():
    cfg = M.get_config("qwen1.5-110b", smoke=True)
    a = T.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = T.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb) and not pa.requires_grad
    names = dict(a.named_parameters())
    assert names["layers.0.mixer.wq.w"].shape == (cfg.d_model,
                                                   cfg.num_heads * cfg.head_dim)
    assert "layers.0.mixer.wq.b" in names  # qwen1.5's QKV bias
    olmo = T.init_params(M.get_config("olmo-1b", smoke=True),
                         torch.Generator().manual_seed(0), device="cpu")
    onames = dict(olmo.named_parameters())
    assert "lm_head.w" not in onames  # tied embeddings
    assert not any("scale" in n for n in onames)  # non-parametric LN


def test_moe_mla_init_layout():
    """deepseek: layer 0 MLA + dense, the rest MLA + MoE with shared
    experts; the router float32 under a bfloat16 ``param_dtype``; the
    caches by mixer."""
    cfg = M.get_config("deepseek-v2-lite-16b", smoke=True).with_overrides(
        param_dtype="bfloat16")
    a = T.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = T.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb) and not pa.requires_grad
    names = dict(a.named_parameters())
    assert "layers.0.ffn.gate.w" in names and "layers.0.ffn.router.w" not in names
    assert names["layers.0.mixer.kv_up.w"].shape == (
        cfg.kv_lora_rank, cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim))
    for L in (1, 2):
        assert names[f"layers.{L}.ffn.router.w"].dtype == torch.float32
        assert names[f"layers.{L}.ffn.experts.w_down"].shape == (
            cfg.num_experts, cfg.moe_d_ff, cfg.d_model)
        assert names[f"layers.{L}.ffn.experts.w_down"].dtype == torch.bfloat16
        assert names[f"layers.{L}.ffn.shared.up.w"].shape == (
            cfg.d_model, cfg.moe_d_ff * cfg.num_shared_experts)
    caches = T.init_decode_caches(cfg, 2, 8, device="cpu")
    assert [sorted(c) for c in caches] == [["c_kv", "k_rope"]] * cfg.num_layers
    qwen = M.get_config("qwen3-moe-30b-a3b", smoke=True)
    caches = T.init_decode_caches(qwen, 2, 8, device="cpu")
    assert [sorted(c) for c in caches] == [["k", "v"]] * qwen.num_layers


def test_carry_rejects_mismatched_tree():
    cfg = M.get_config("olmo-1b", smoke=True)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JT.init_params(cfg, jax.random.key(0)))
    bad = dict(tree, embedding={"table": tree["embedding"]["table"][:, :8]})
    with pytest.raises(ValueError, match="shape"):
        model_params_from_numpy(cfg, bad, device="cpu")
    extra = dict(tree, lm_head={"w": np.zeros((cfg.d_model, 8), np.float32)})
    with pytest.raises(ValueError, match="leaves"):
        model_params_from_numpy(cfg, extra, device="cpu")

"""The port's model mesh against the JAX package: ``parallel/sharding.py``,
the context-parallel decode attention, expert-parallel MoE and the
continuous batcher on a mesh.

A port mesh is ``make_host_mesh(data, model, devices=["cpu"] * 4)`` (one
process, a device may repeat); a ``Mesh`` of 256 or 512 repeated
``"cpu"`` devices stands in for the reference's ``abstract_mesh`` where
only specs are resolved.  The reference's own mesh runs in one
subprocess with four forced host devices, its meshes built with
``axis_types=(AxisType.Auto,) * 2``: under jax 0.9.0 ``jax.make_mesh``
defaults to Explicit axes, on which the reference's batcher raises
(``with_sharding_constraint can only refer to Auto axes``).

Tolerances:
  * specs: equal, entry for entry;
  * within the port: ``shard_activation`` returns its input, so a
    forward under a mesh is bit-equal to one without; pieces round-trip
    bit for bit; the CP decode attention within 1e-6 of the unsharded
    one (the merge reorders float32 sums), EP within 1e-6 of the plain
    path;
  * against the reference's 4-device mesh: the CP decode attention and
    EP MoE within rtol / atol 1e-5 (the reference's own mesh tests hold
    1e-5); the batcher's greedy tokens equal and its decode logits within
    atol 1e-4 (float32 smoke configs, as ``test_torch_serve.py``).
"""

import os
import pickle
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from repro.models import model as JM
from repro.parallel import sharding as JSH
from repro.parallel.compat import abstract_mesh
from repro.parallel.compat import manual_axes_scope as j_manual_axes_scope
from repro_torch import compile as programs
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.ffn import moe_ffn
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.decode_attention import (_local_decode, cache_spec,
                                                   decode_attention)
from repro_torch.parallel.sharding import (NamedSharding, P, ShardedTensor,
                                           manual_axes, manual_axes_scope,
                                           mesh_context, shard_tensor, unshard)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = M.list_archs()
REF_TOL = 1e-5
PORT_TOL = 1e-6
SERVE_ATOL = 1e-4


def _norm(spec) -> tuple:
    """A spec as a tuple of axis-name tuples (None for replicated), so a
    jax ``PartitionSpec`` and the port's compare entry for entry."""
    out = []
    for e in spec:
        axes = () if e is None else (tuple(e) if isinstance(e, tuple) else (e,))
        out.append(axes or None)
    return tuple(out)


def _standin(shape, names) -> Mesh:
    return Mesh(np.full(shape, "cpu", dtype=object), names)


def _cpu_mesh(data: int, model: int) -> Mesh:
    return make_host_mesh(data, model, devices=["cpu"] * (data * model))


MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", sorted(SH.POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, policy):
    """Every leaf of every smoke arch, under each policy; a stacked
    reference leaf drops its leading scan dim."""
    cfg = M.get_config(arch, smoke=True)
    with JSH.policy_context(policy):
        want = JSH.param_specs(JM.abstract_params(cfg))
    with SH.policy_context(policy):
        got = SH.param_specs(T.init_params(cfg, None, device="meta"))
    assert got
    for name, spec in got.items():
        node, g = convert._reference_node(cfg, want, name)
        expect = _norm(node)[1:] if g is not None else _norm(node)
        assert _norm(spec) == expect, name


@pytest.mark.parametrize("arch", ARCHS)
def test_named_sharding_equals_reference_at_full_size(arch):
    """The published configs' leaves on the (16, 16) and (2, 16, 16)
    stand-ins: the validated specs equal the reference's
    ``validate_spec`` on its abstract meshes (divisibility drops axes)."""
    cfg = M.get_config(arch)
    shapes = JM.abstract_params(cfg)
    want = JSH.param_specs(shapes)
    params = T.init_params(cfg, None, device="meta")
    for shape, names in MESHES:
        jmesh = abstract_mesh(shape, names)
        got = SH.apply_named_sharding(params, _standin(shape, names))
        for name, sharding in got.items():
            spec, g = convert._reference_node(cfg, want, name)
            leaf, _ = convert._reference_node(cfg, shapes, name)
            if g is not None:  # the layer's slice of a stacked leaf
                spec, lshape = P(*tuple(spec)[1:]), tuple(leaf.shape)[1:]
            else:
                lshape = tuple(leaf.shape)
            assert _norm(sharding.spec) == _norm(
                JSH.validate_spec(spec, lshape, jmesh)), name


def test_rules_cover_all_archs():
    """As the reference's ``test_rules_cover_all_archs``: every matrix
    leaf of at least 64 is sharded somewhere."""
    for arch in ARCHS:
        cfg = M.get_config(arch, smoke=True)
        params = T.init_params(cfg, None, device="meta")
        specs = SH.param_specs(params)
        for name, t in params.named_parameters():
            if name.endswith(".scale") or name.endswith(".b"):
                continue
            if t.dim() >= 2 and max(t.shape) >= 64:
                assert any(e is not None for e in specs[name]), (arch, name)


# ---------------------------------------------------------------------------
# validate_spec and the activation specs
# ---------------------------------------------------------------------------

SPECS = [
    (P("model"), (8,)), (P("model"), (32,)), (P("model", "data"), (92672, 6144)),
    (P(("pod", "data"), None), (64, 3)), (P(("pod", "data"), None), (16, 3)),
    (P(("data", "model"), "model"), (512, 32)), (P("data", "data"), (32, 32)),
    (P(None, ("data", "model")), (4, 4096)), (P(), ()),
]


@pytest.mark.parametrize("shape, names", MESHES)
def test_validate_spec_equals_reference(shape, names):
    jmesh, mesh = abstract_mesh(shape, names), _standin(shape, names)
    for spec, dims in SPECS:
        jspec = jax.sharding.PartitionSpec(*spec)
        assert _norm(SH.validate_spec(spec, dims, mesh)) == _norm(
            JSH.validate_spec(jspec, dims, jmesh)), (spec, dims)


ACTS = [
    (("batch", "seq", "heads", None), (16, 128, 32, 128)),
    (("batch", "seq", "kv_heads", None), (16, 128, 8, 128)),
    (("batch", "seq", "mlp"), (1, 4096, 8192)),
    (("batch", "seq", "embed"), (32, 2048, 2048)),
    (("batch", "seq", "vocab"), (2, 64, 92544)),
    (("batch", "seq", None, "vocab"), (4, 64, 4, 2048)),
    (("batch", "kv_seq", "kv_heads", None), (8, 4096, 8, 128)),
    (("long_seq", None), (524288, 64)),
    (("experts", None, None), (128, 2048, 768)),
    ((None, "unknown"), (3, 5)),
]


def _reference_spec(monkeypatch, jmesh, dims, names):
    """The spec the reference's ``shard_activation`` constrains a tensor
    of ``dims`` to on ``jmesh`` (None when it skips the constraint)."""
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s.spec) or x)
    prev = JSH.current_mesh()
    JSH._STATE.mesh = jmesh
    try:
        JSH.shard_activation(SimpleNamespace(shape=dims), *names)
    finally:
        JSH._STATE.mesh = prev
    return _norm(seen[0]) if seen else None


@pytest.mark.parametrize("policy", sorted(SH.POLICIES))
@pytest.mark.parametrize("shape, names", MESHES)
def test_activation_spec_equals_reference(shape, names, policy, monkeypatch):
    jmesh, mesh = abstract_mesh(shape, names), _standin(shape, names)
    for manual in ((), ("pod",), ("model",), names):
        for logical_names, dims in ACTS:
            with JSH.policy_context(policy), j_manual_axes_scope(manual):
                want = _reference_spec(monkeypatch, jmesh, dims, logical_names)
            with SH.policy_context(policy), mesh_context(mesh), \
                    manual_axes_scope(manual):
                got = SH.activation_spec(dims, *logical_names)
            assert (None if got is None else _norm(got)) == want, (
                manual, logical_names, dims)


class TestManualAxes:
    """Mirrors the reference's ``TestManualAxes`` on the port's copy."""

    def test_scope_nesting_and_union(self):
        assert manual_axes() == frozenset()
        with manual_axes_scope({"pod"}):
            assert manual_axes() == frozenset({"pod"})
            with manual_axes_scope({"model"}):
                assert manual_axes() == frozenset({"pod", "model"})
            assert manual_axes() == frozenset({"pod"})
        assert manual_axes() == frozenset()

    def test_constraint_drops_manual_axes(self):
        mesh = _standin((2, 2), ("pod", "data"))
        with mesh_context(mesh):
            open_spec = SH.activation_spec((4, 4), "batch", None)
            with manual_axes_scope({"pod"}):
                scoped = SH.activation_spec((4, 4), "batch", None)
        assert "pod" in _norm(open_spec)[0]
        assert _norm(scoped) == (("data",), None)

    def test_constraint_skipped_when_all_manual(self):
        with mesh_context(_standin((2, 2), ("pod", "data"))):
            with manual_axes_scope({"pod", "data"}):
                assert SH.activation_spec((4, 4), "batch", None) is None

    def test_shards_run_with_every_axis_manual(self, monkeypatch):
        """The CP decode and EP bodies resolve specs with the whole mesh
        manual, as the reference's ``shard_map`` bodies do."""
        seen = []
        orig = _local_decode

        def spy(*a, **kw):
            seen.append(manual_axes())
            return orig(*a, **kw)

        from repro_torch.parallel import decode_attention as DA
        monkeypatch.setattr(DA, "_local_decode", spy)
        q, k, v = _decode_inputs()
        with mesh_context(_cpu_mesh(2, 2)):
            decode_attention(q, k, v, 40, scale=0.25)
        assert seen and all(s == {"data", "model"} for s in seen)
        assert manual_axes() == frozenset()


def test_shard_activation_returns_its_input():
    x = torch.ones(4, 8, 16)
    with mesh_context(_cpu_mesh(2, 2)):
        assert SH.shard_activation(x, "batch", "seq", "mlp") is x
    assert SH.shard_activation(x, "batch", "seq", "mlp") is x


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "jamba-1.5-large-398b",
                                  "deepseek-v2-lite-16b"])
def test_forward_under_a_mesh_is_bit_equal(arch):
    """The hook changes no bit of a forward pass."""
    cfg = M.get_config(arch, smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 64)))
    want, aux = T.forward(cfg, params, {"tokens": toks})
    with mesh_context(_cpu_mesh(2, 2)):
        got, aux2 = T.forward(cfg, params, {"tokens": toks})
    assert torch.equal(got, want) and torch.equal(aux, aux2)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape, spec", [
    ((2, 2), P("data", "model", None)), ((2, 2), P(None, ("data", "model"))),
    ((1, 4), P("model", None, None)), ((4, 1), P(("data", "model"))),
    ((2, 2), P(None, None, "data")), ((2, 2), P())])
def test_shard_tensor_round_trip(mesh_shape, spec):
    mesh = _cpu_mesh(*mesh_shape)
    t = torch.arange(8 * 8 * 4, dtype=torch.float32).reshape(8, 8, 4)
    st = shard_tensor(t, NamedSharding(mesh, spec))
    assert torch.equal(unshard(st), t)
    assert torch.equal(unshard(st.pieces, st.sharding, "cpu"), t)
    for piece in st.local_tensors():  # one device: every piece a view
        assert piece.untyped_storage().data_ptr() == \
            t.untyped_storage().data_ptr()
    n_blocks = 1
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n_blocks *= mesh.shape[a]
    assert len(st.blocks) == len(st.local_tensors()) == n_blocks


def test_shard_tensor_validates():
    mesh = _cpu_mesh(2, 2)
    with pytest.raises(ValueError, match="does not split"):
        shard_tensor(torch.zeros(3, 4), NamedSharding(mesh, P("data", None)))
    with pytest.raises(ValueError, match="not in the mesh"):
        NamedSharding(mesh, P("pod"))


def test_sharded_writes_equal_torch():
    """``t[i] = value`` and the device-position ``index_copy_`` the
    batcher and the decode step use, against the whole tensor's."""
    mesh = _cpu_mesh(2, 2)
    g = torch.Generator().manual_seed(0)
    t = torch.randn(4, 16, 2, 3, generator=g)
    st = shard_tensor(t.clone(), NamedSharding(mesh, cache_spec(mesh, 4, 16)))
    for pos in (0, 7, 8, 15):
        row = torch.tensor([pos])
        new = torch.randn(4, 1, 2, 3, generator=g)
        t.index_copy_(1, row, new)
        st.index_copy_(1, row, new)
        assert torch.equal(unshard(st), t)
    value = torch.randn(16, 2, 3, generator=g)
    t[3] = value
    st[3] = value
    assert torch.equal(unshard(st), t)


# ---------------------------------------------------------------------------
# The CP decode attention and EP within the port
# ---------------------------------------------------------------------------

DEC_B, DEC_S, DEC_HKV, DEC_H, DEC_DH = 4, 64, 2, 4, 16
DEC_POS = [5, 40, 63]  # 5: only the first of four sequence shards is live
DEC_MESHES = [(2, 2), (1, 4), (4, 1)]


def _decode_inputs():
    rng = np.random.default_rng(11)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 for s in [(DEC_B, DEC_H, DEC_DH),
                           (DEC_B, DEC_S, DEC_HKV, DEC_DH),
                           (DEC_B, DEC_S, DEC_HKV, DEC_DH)])


def test_cache_spec_is_the_references_axis_selection():
    assert cache_spec(None, 4, 64) is None
    assert cache_spec(_standin((4,), ("data",)), 4, 64) is None
    assert _norm(cache_spec(_cpu_mesh(2, 2), 4, 64)) == \
        (("data",), ("model",), None, None)
    assert _norm(cache_spec(_cpu_mesh(1, 4), 4, 64)) == \
        (None, ("data", "model"), None, None)
    assert _norm(cache_spec(_cpu_mesh(2, 2), 3, 64)) == \
        (None, ("data", "model"), None, None)
    assert cache_spec(_cpu_mesh(1, 4), 4, 62) is None  # S indivisible
    assert _norm(cache_spec(_standin((2, 2, 2), ("pod", "data", "model")),
                            8, 64)) == (("pod", "data"), ("model",), None, None)


@pytest.mark.parametrize("mesh_shape", DEC_MESHES)
def test_cp_decode_equals_unsharded(mesh_shape):
    q, k, v = _decode_inputs()
    mesh = _cpu_mesh(*mesh_shape)
    st_k, st_v = (shard_tensor(t, NamedSharding(
        mesh, cache_spec(mesh, DEC_B, DEC_S))) for t in (k, v))
    for pos in DEC_POS:
        want = decode_attention(q, k, v, pos, scale=0.25)
        with mesh_context(mesh):
            got = decode_attention(q, k, v, torch.tensor(pos), scale=0.25)
        torch.testing.assert_close(got, want, rtol=PORT_TOL, atol=PORT_TOL)
        assert torch.equal(decode_attention(q, st_k, st_v, torch.tensor(pos),
                                            scale=0.25), got)


def test_shard_without_live_rows_contributes_zeros():
    q, k, v = _decode_inputs()
    m, l, o = _local_decode(q, k[:, 32:], v[:, 32:], torch.tensor(5), 0.25,
                            global_offset=32, axis_names=("model",))
    assert not l.any() and not o.any()
    m, l, o = _local_decode(q, k[:, 32:], v[:, 32:], 5, 0.25,
                            global_offset=32, axis_names=("model",))
    assert not l.any() and not o.any()


def _moe_layer(seed=3):
    cfg = M.get_config("qwen3-moe-30b-a3b", smoke=True)
    rng = np.random.default_rng(seed)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": {"w": rng.normal(size=(D, E)).astype(np.float32)},
         "experts": {n: (0.1 * rng.normal(size=s)).astype(np.float32)
                     for n, s in (("w_gate", (E, D, F)), ("w_up", (E, D, F)),
                                  ("w_down", (E, F, D)))}}
    x = rng.normal(size=(2, 8, D)).astype(np.float32)
    return cfg, p, x


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_ep_equals_plain_and_runs_per_shard(mesh_shape, monkeypatch):
    cfg, p, x = _moe_layer()
    p, x = _torch_tree(p), torch.from_numpy(x)
    want, aux = moe_ffn.apply(cfg, p, x)
    calls = []
    orig = moe_ffn._dropless

    def spy(*a, **kw):
        calls.append(kw.get("local_experts"))
        return orig(*a, **kw)

    monkeypatch.setattr(moe_ffn, "_dropless", staticmethod(spy))
    with mesh_context(_cpu_mesh(*mesh_shape)):
        got, aux2 = moe_ffn.apply(cfg, p, x, impl="ep")
        plain, _ = moe_ffn.apply(cfg, p, x, impl="gspmd")
    n_model = mesh_shape[1]
    assert calls == [cfg.num_experts // n_model] * 4 + [None]
    torch.testing.assert_close(got, want, rtol=PORT_TOL, atol=PORT_TOL)
    assert torch.equal(plain, want) and torch.equal(aux, aux2)
    pieces = p["experts"]["w_gate"]._ep_pieces[2]  # placed once, views
    assert len(pieces.blocks) == n_model


def test_ep_falls_back_where_the_reference_does():
    cfg, p, x = _moe_layer()
    p, x = _torch_tree(p), torch.from_numpy(x)
    want, _ = moe_ffn.apply(cfg, p, x)
    for mesh in (_standin((4,), ("data",)), _cpu_mesh(1, 3)):  # no / 8 % 3
        with mesh_context(mesh):
            assert torch.equal(moe_ffn.apply(cfg, p, x, impl="ep")[0], want)


# ---------------------------------------------------------------------------
# Against the reference's 4-device mesh (one subprocess)
# ---------------------------------------------------------------------------

SERVE = [("internlm2-1.8b", "gspmd"), ("qwen3-moe-30b-a3b", "ep")]
SERVE_MESHES = [(2, 2), (1, 4)]
SLOTS, MAX_LEN, GEN = 2, 32, 4

_REFERENCE_MESH = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.launch import serve as S
    from repro.models import model as M, transformer as T
    from repro.models.ffn import moe_ffn
    from repro.parallel.decode_attention import decode_attention
    from repro.parallel.sharding import mesh_context

    inp = pickle.load(open(sys.argv[1], "rb"))
    out = {}

    def mesh(shape):
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)

    q, k, v = (jnp.asarray(a) for a in inp["decode"])
    for shape in inp["decode_meshes"]:
        with mesh_context(mesh(shape)):
            fn = jax.jit(lambda q, k, v, pos: decode_attention(
                q, k, v, pos, scale=inp["scale"]))
            for pos in inp["decode_pos"]:
                out[("decode", shape, pos)] = np.asarray(
                    fn(q, k, v, jnp.int32(pos)))
    cfg = M.get_config("qwen3-moe-30b-a3b", smoke=True)
    p = jax.tree_util.tree_map(jnp.asarray, inp["moe_params"])
    for shape in inp["ep_meshes"]:
        with mesh_context(mesh(shape)):
            y, aux = jax.jit(lambda p, x: moe_ffn.apply(
                cfg, p, x, impl="ep"))(p, jnp.asarray(inp["moe_x"]))
            out[("ep", shape)] = (np.asarray(y), float(aux))
    for arch, impl in inp["serve"]:
        cfg = M.get_config(arch, smoke=True)
        params = T.init_params(cfg, jax.random.key(0))
        out[("params", arch)] = jax.tree_util.tree_map(np.asarray, params)
        for shape in inp["serve_meshes"]:
            with mesh_context(mesh(shape)):
                b = S.ContinuousBatcher(cfg, params, inp["slots"],
                                        inp["max_len"], impl)
                dec, logits = b._decode, []

                def capture(*a, dec=dec, logits=logits):
                    o = dec(*a)
                    logits.append(np.asarray(o[0]))
                    return o

                b._decode = capture
                queue, done = list(range(len(inp["prompts"]))), []
                while len(done) < len(inp["prompts"]):
                    while queue and b.admit(queue[0],
                                            inp["prompts"][queue[0]]):
                        queue.pop(0)
                    b.step()
                    done += b.retire(inp["gen"])
                out[("serve", arch, shape)] = (dict(b.outputs), logits)
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's CP decode attention, EP MoE and mesh batcher on its
    4-device mesh, with the inputs they were given."""
    q, k, v = _decode_inputs()
    cfg, moe_p, moe_x = _moe_layer()
    rng = np.random.default_rng(9)
    inp = dict(decode=[t.numpy() for t in (q, k, v)],
               decode_meshes=DEC_MESHES, decode_pos=DEC_POS, scale=0.25,
               moe_params=moe_p, moe_x=moe_x, ep_meshes=[(2, 2), (1, 4)],
               serve=SERVE, serve_meshes=SERVE_MESHES, slots=SLOTS,
               max_len=MAX_LEN, gen=GEN,
               prompts=[rng.integers(0, 512, size=8).astype(np.int32)
                        for _ in range(3)])
    d = tmp_path_factory.mktemp("reference_mesh")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_MESH,
                           str(d / "in.pkl"), str(d / "out.pkl")], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(d / "out.pkl", "rb") as f:
        return inp, pickle.load(f)


@pytest.mark.parametrize("mesh_shape", DEC_MESHES)
def test_cp_decode_equals_reference_mesh(reference, mesh_shape):
    inp, out = reference
    q, k, v = (torch.from_numpy(a) for a in inp["decode"])
    with mesh_context(_cpu_mesh(*mesh_shape)):
        for pos in DEC_POS:
            got = decode_attention(q, k, v, torch.tensor(pos), scale=0.25)
            np.testing.assert_allclose(got.numpy(),
                                       out[("decode", mesh_shape, pos)],
                                       rtol=REF_TOL, atol=REF_TOL)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_ep_equals_reference_mesh(reference, mesh_shape):
    inp, out = reference
    cfg = M.get_config("qwen3-moe-30b-a3b", smoke=True)
    p, x = _torch_tree(inp["moe_params"]), torch.from_numpy(inp["moe_x"])
    with mesh_context(_cpu_mesh(*mesh_shape)):
        y, aux = moe_ffn.apply(cfg, p, x, impl="ep")
    want_y, want_aux = out[("ep", mesh_shape)]
    np.testing.assert_allclose(y.numpy(), want_y, rtol=REF_TOL, atol=REF_TOL)
    assert abs(float(aux) - want_aux) <= REF_TOL * max(1.0, abs(want_aux))


@pytest.mark.parametrize("mesh_shape", SERVE_MESHES)
@pytest.mark.parametrize("arch, impl", SERVE)
def test_batcher_on_mesh_equals_reference_mesh(reference, arch, impl,
                                               mesh_shape):
    """The port's batcher on a CPU mesh against the reference's on its
    4-device mesh: the same greedy tokens, decode logits within atol
    1e-4; its attention caches are pieces over the mesh."""
    inp, out = reference
    cfg = M.get_config(arch, smoke=True)
    params = convert.model_params_from_numpy(cfg, out[("params", arch)],
                                             device="cpu")
    with mesh_context(_cpu_mesh(*mesh_shape)):
        b = serve.ContinuousBatcher(cfg, params, SLOTS, MAX_LEN, impl)
    assert isinstance(b.caches[0]["k"], ShardedTensor)
    dec, logits = b._decode, []

    def capture(*a):
        o = dec(*a)
        logits.append(o[0].numpy())
        return o

    b._decode = capture
    queue, done = list(range(len(inp["prompts"]))), []
    while len(done) < len(inp["prompts"]):
        while queue and b.admit(queue[0], inp["prompts"][queue[0]]):
            queue.pop(0)
        b.step()
        done += b.retire(GEN)
    want_outputs, want_logits = out[("serve", arch, mesh_shape)]
    assert b.outputs == want_outputs
    assert len(logits) == len(want_logits) > 0
    for got, want in zip(logits, want_logits):
        np.testing.assert_allclose(got, want, atol=SERVE_ATOL)


# ---------------------------------------------------------------------------
# On the card: four shards on cuda:0
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_pieces_on_a_repeated_device_are_views(card):
    mesh = make_host_mesh(2, 2, devices=["cuda:0"] * 4)
    t = torch.randn(4, 64, 2, 16, device=card)
    st = shard_tensor(t, NamedSharding(mesh, cache_spec(mesh, 4, 64)))
    assert all(p.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
               for p in st.local_tensors())
    assert torch.equal(unshard(st), t)


@pytest.mark.cuda
@pytest.mark.parametrize("arch, impl", SERVE)
def test_cuda_mesh_decode_program_equals_eager(card, arch, impl):
    """The captured mesh decode step against ``eager()`` on the same
    caches: logits and every cache piece bit for bit (bf16 activations,
    the card's grouped GEMM takes no float32)."""
    cfg = M.get_config(arch, smoke=True).with_overrides(dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator(device=card).manual_seed(0),
                           device=card)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                size=(2, 16))
    mesh = make_host_mesh(1, 4, devices=["cuda:0"] * 4)
    runs = []
    for ctx in (programs.eager, lambda: torch.no_grad()):
        with mesh_context(mesh):
            b = serve.ContinuousBatcher(cfg, params, 2, 64, impl)
        for r in range(2):
            assert b.admit(r, prompts[r].astype(np.int32))
        logits = []
        with ctx():
            for _ in range(3):
                logits.append(b._decode(torch.zeros(2, 1, dtype=torch.int32,
                                                    device=card), 16)[0])
        runs.append((logits, [unshard(c["k"]) for c in b.caches
                              if isinstance(c.get("k"), ShardedTensor)]))
    (l0, c0), (l1, c1) = runs
    assert c0 and all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(c0, c1))

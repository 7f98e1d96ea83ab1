"""The port's dry run (``repro_torch.launch.dryrun``) and its inputs
against the reference's.

  * ``SHAPES`` and ``shape_applicable`` equal the reference's, for every
    arch x shape (the reason text too);
  * every ``input_specs`` leaf (the train batch, labels and loss mask;
    the prefill batch; decode's caches, tokens and ``pos``) and every
    ``abstract_params`` leaf has the reference's shape and dtype, the
    caches mapped from the reference's ``prefix{i}`` / stacked ``groups``
    onto the port's per-layer list as ``convert`` maps parameters;
  * ``param_bytes_per_device`` equals the reference's
    ``_analytic_param_bytes_per_device`` on ``compat.abstract_mesh`` for
    every arch on both production meshes (29,925,376 B for internlm2 on
    16 x 16).  Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512
    host devices, so the reference's side runs in a subprocess;
  * the three cells of ``tests/test_dryrun.py`` with its assertions,
    where the port's design allows them: the dense train cell's census
    is empty (its layers compute whole on the first device) where the
    reference counts GSPMD's all-reduces, and the decode cell counts the
    CP merges;
  * the CP decode on ``meta`` (one partial over the whole cache) counts
    the FLOPs and merges of the per-shard loop it stands for;
  * a MoE layer on ``meta`` takes the grouped GEMM (the loop would read
    the group sizes) and its FLOPs are counted.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from repro.models import model as JM
from repro_torch.convert import _reference_node
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.ffn import moe_ffn
from repro_torch.parallel.decode_attention import decode_attention
from repro_torch.parallel.sharding import (apply_named_sharding,
                                           collective_census, mesh_context)
from _torch_threads import one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = M.list_archs()


def _dtype(d) -> str:
    return str(jnp.dtype(d))


def _torch_dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def test_shapes_and_applicability_equal_reference():
    assert M.SHAPES == JM.SHAPES
    assert M.list_archs() == JM.list_archs()
    for arch in ARCHS:
        for shape in M.SHAPES:
            assert M.shape_applicable(M.get_config(arch), shape) == \
                JM.shape_applicable(JM.get_config(arch), shape), (arch, shape)


def _reference_shape(cfg, tree, name: str):
    """(shape, dtype) of the reference leaf the port's ``name`` maps to
    (a stacked group's leading axis dropped)."""
    node, g = _reference_node(cfg, tree, name)
    shape = tuple(node.shape[1:] if g is not None else node.shape)
    return shape, _dtype(node.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_abstract_params_equal_reference(arch):
    cfg, jcfg = M.get_config(arch), JM.get_config(arch)
    jparams = JM.abstract_params(jcfg)
    params = M.abstract_params(cfg)
    for name, p in params.named_parameters():
        assert p.device.type == "meta"
        assert (tuple(p.shape), _torch_dtype(p)) == \
            _reference_shape(cfg, jparams, name), name
    for shape in M.SHAPES:
        if not M.shape_applicable(cfg, shape)[0]:
            continue
        mine, theirs = M.input_specs(cfg, shape), JM.input_specs(jcfg, shape)
        assert mine.keys() == theirs.keys(), shape
        for key in mine:
            if key == "max_len":
                assert mine[key] == theirs[key]
            elif key == "caches":
                for layer, cache in enumerate(mine["caches"]):
                    for leaf, t in cache.items():
                        assert t.device.type == "meta"
                        assert (tuple(t.shape), _torch_dtype(t)) == \
                            _reference_shape(cfg, theirs["caches"],
                                             f"layers.{layer}.{leaf}"), \
                            (shape, layer, leaf)
            else:
                want = jax.tree_util.tree_map(
                    lambda s: (tuple(s.shape), _dtype(s.dtype)), theirs[key])
                got = (
                    {k: (tuple(v.shape), _torch_dtype(v))
                     for k, v in mine[key].items()}
                    if isinstance(mine[key], dict)
                    else (tuple(mine[key].shape), _torch_dtype(mine[key])))
                assert got == want, (shape, key)


REFERENCE_BYTES = textwrap.dedent("""
    import json
    from repro.launch import dryrun as D
    from repro.models import model as JM
    from repro.parallel.compat import abstract_mesh
    from repro.parallel.sharding import apply_named_sharding
    out = {}
    for multi in (False, True):
        mesh = abstract_mesh((2, 16, 16) if multi else (16, 16),
                             ("pod", "data", "model") if multi
                             else ("data", "model"))
        for arch in JM.list_archs():
            cfg = JM.get_config(arch).with_overrides(
                dtype="bfloat16", param_dtype="float32", remat=True)
            p = JM.abstract_params(cfg)
            out[f"{arch}|{int(multi)}"] = D._analytic_param_bytes_per_device(
                p, apply_named_sharding(p, mesh), mesh)
    print("BYTES", json.dumps(out))
""")


def test_param_bytes_per_device_equal_reference():
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE_BYTES], capture_output=True,
        text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    line = next(l for l in out.stdout.splitlines() if l.startswith("BYTES "))
    want = json.loads(line[len("BYTES "):])
    assert want["internlm2-1.8b|0"] == 29_925_376
    meshes = {multi: make_production_mesh(
        multi_pod=multi, devices=["meta"] * (512 if multi else 256))
        for multi in (False, True)}
    for arch in ARCHS:
        params = M.abstract_params(M.get_config(arch).with_overrides(
            dtype="bfloat16", param_dtype="float32", remat=True))
        for multi, mesh in meshes.items():
            got = D._analytic_param_bytes_per_device(
                params, apply_named_sharding(params, mesh))
            assert got == want[f"{arch}|{int(multi)}"], (arch, multi)


# ---------------------------------------------------------------------------
# The cells of tests/test_dryrun.py
# ---------------------------------------------------------------------------


def _run_dryrun(args, tmp_path, monkeypatch, capsys) -> str:
    monkeypatch.setattr(D, "RESULTS_DIR", str(tmp_path))
    D.main([*args, "--force", "--tag", "test"])
    return capsys.readouterr().out


def _report(tmp_path, name: str) -> dict:
    with open(tmp_path / name) as f:
        return json.load(f)


def test_train_cell_single_pod(tmp_path, monkeypatch, capsys):
    out = _run_dryrun(["--arch", "internlm2-1.8b", "--shape", "train_4k"],
                      tmp_path, monkeypatch, capsys)
    assert "[ok]" in out
    rep = _report(tmp_path, "internlm2-1.8b__train_4k__16x16__test.json")
    assert rep["status"] == "ok"
    assert rep["mesh"] == {"data": 16, "model": 16}
    assert rep["cost_analysis"]["flops"] > 1e12
    # The port's dense layers compute whole: no cross-shard merge.
    assert rep["collectives"] == {} and rep["num_collectives"] == 0
    # FSDP param sharding: ~1.9B params * 4B / 256 devices
    assert rep["param_bytes_per_device"] < 40e6
    mem = rep["memory_analysis"]
    assert 0 < mem["argument_size_in_bytes"] < mem["first_device_argument_bytes"]


def test_decode_cell_multi_pod(tmp_path, monkeypatch, capsys):
    out = _run_dryrun(["--arch", "olmo-1b", "--shape", "decode_32k",
                       "--multi-pod"], tmp_path, monkeypatch, capsys)
    assert "[ok]" in out
    rep = _report(tmp_path, "olmo-1b__decode_32k__2x16x16__test.json")
    assert rep["status"] == "ok"
    assert rep["mesh"] == {"pod": 2, "data": 16, "model": 16}
    # The CP decode merge: a max and two sums a layer over 'model'.
    cfg = M.get_config("olmo-1b")
    assert rep["collectives"]["all-reduce"]["count"] == 3 * cfg.num_layers


def test_long_500k_skip_for_full_attention(tmp_path, monkeypatch, capsys):
    out = _run_dryrun(["--arch", "olmo-1b", "--shape", "long_500k"],
                      tmp_path, monkeypatch, capsys)
    assert "[skipped]" in out
    rep = _report(tmp_path, "olmo-1b__long_500k__16x16__test.json")
    assert rep["status"] == "skipped"
    assert "sub-quadratic" in rep["reason"]


@pytest.mark.parametrize("batch", [4, 1])
def test_cp_decode_on_meta_counts_as_the_shards(batch):
    """On ``meta`` the CP decode takes one partial over the whole cache
    for the shards' partials: its output's shape, FLOPs and recorded
    merges equal the per-shard loop's on a CPU mesh of the same shape
    (batch 4: the batch over 'data', the sequence over 'model'; batch 1:
    the sequence over both)."""
    out = {}
    for dev in ("cpu", "meta"):
        mesh = Mesh(np.array([dev] * 4, dtype=object).reshape(2, 2),
                    ("data", "model"))
        q = torch.zeros(batch, 4, 8, device=dev)
        k, v = (torch.zeros(batch, 16, 2, 8, device=dev) for _ in range(2))
        with mesh_context(mesh), collective_census() as records, \
                FlopCounterMode(display=False) as counter:
            o = decode_attention(q, k, v, 9, scale=0.25)
        out[dev] = (tuple(o.shape), o.dtype, counter.get_total_flops(),
                    records)
    assert out["meta"] == out["cpu"]
    assert out["cpu"][2] > 0 and len(out["cpu"][3]) == 3


def test_moe_layer_on_meta_counts_grouped_gemm_flops():
    cfg = M.get_config("qwen3-moe-30b-a3b", smoke=True).with_overrides(
        dtype="bfloat16")
    p = moe_ffn.init(cfg, None, "meta")
    x = torch.empty(2, 8, cfg.d_model, dtype=torch.bfloat16, device="meta")
    D._register_grouped_mm_flops()
    with FlopCounterMode(display=False) as counter:
        out, _ = moe_ffn.apply(cfg, p, x)
    assert out.shape == x.shape and out.device.type == "meta"
    rows = 2 * 8 * cfg.top_k
    grouped = 3 * 2 * rows * cfg.d_model * cfg.moe_d_ff
    router = 2 * 16 * cfg.d_model * cfg.num_experts
    assert counter.get_total_flops() == grouped + router

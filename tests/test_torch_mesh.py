"""The port's discovery mesh against its batched path and the JAX package.

This file holds the mesh, the planner's rounding, ``execute`` and the
shard top-k; ``test_torch_mesh_routes.py`` and
``test_torch_mesh_programs.py`` every ``query_many`` route (the first by
1 and 3 shards, the second by 4, with the programs' bounds and the
four-shard gate), ``test_torch_mesh_service.py`` the service's
distributed rung; their corpus and fixtures are
``_torch_mesh_common.py``'s (split for ``--dist loadfile``).

A mesh here is ``make_host_mesh(devices=["cpu"] * n)`` for n = 1, 3 and
4: the CPU counterpart of the reference tests' forced host devices (and
of four shards on one card).  Three shards do not divide the pow-2 group
buckets, so ``_pad_group_to_shards`` runs.

Tolerances:
  * within the port, mesh against batched / partitioned executors: bit
    for bit (scores, join sizes, rankings and MI values exactly equal) —
    a shard runs the group body on its own rows, and each MI depends on
    its own joined sample only;
  * against the JAX package (its ``PartitionedLocalExecutor`` here, its
    4-device mesh ``execute`` in a subprocess): join sizes exact, MI
    within rtol/atol 1e-5 (digamma differs between the frameworks by
    ~2e-6, as in ``test_torch_discovery.py``).

The reference's own mesh ``topk`` fails under jax 0.9.0 (a sharding
type error in its ``_globalize_rows``), so everything after ``execute``
is held against the port's batched path and the reference's local one.
"""

import io
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro.core.discovery import PartitionedLocalExecutor as JPartitioned
from repro.core.discovery import stack_trains as j_stack
from repro.core.sketch import build_sketch as j_build
from repro_torch import compile as programs
from repro_torch.core.discovery import (
    BatchedExecutor,
    GroupMajorDistributedExecutor,
    PartitionedLocalExecutor,
    SketchIndex,
    _shard_topk_plan,
    distributed_topk,
    get_executor,
    make_plan,
    score_batch,
    stack_trains_host,
)
from repro_torch.core.discovery import executors as t_ex
from repro_torch.core.discovery import planner as t_planner
from repro_torch.core.discovery.planner import (
    bucket_rows,
    bucket_shortlist,
    bucket_survivors,
    fused_shortlist_spec,
    tier_spec,
)
from repro_torch.core.sketch import build_sketch as t_build
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

from _torch_mesh_common import (  # noqa: F401 (fixtures)
    TOL,
    N,
    C,
    MIN_JOIN,
    SHARDS,
    PATHS,
    ROWS_,
    KEYS,
    QUERIES,
    _sketches,
    _flat,
    _mesh,
    index,
    j_index,
)
from _torch_threads import one_thread  # noqa: F401 (autouse)


# ---------------------------------------------------------------------------
# The mesh and the planner's rounding
# ---------------------------------------------------------------------------


class TestMesh:
    def test_host_mesh_layout(self):
        mesh = make_host_mesh(devices=["cpu"] * 4)
        assert mesh.shape == {"data": 4, "model": 1}
        assert mesh.axis_devices("data") == [torch.device("cpu")] * 4
        assert mesh == _mesh(4) and hash(mesh) == hash(_mesh(4))
        assert mesh != _mesh(3)
        two = make_host_mesh(model=2, devices=["cpu"] * 4)
        assert two.shape == {"data": 2, "model": 2}
        with pytest.raises(ValueError, match="needs 8 devices"):
            make_host_mesh(data=4, model=2, devices=["cpu"] * 4)

    def test_no_card_no_default_mesh(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="devices="):
            make_host_mesh()

    def test_production_mesh(self):
        """The reference's (16, 16) / (2, 16, 16) meshes over the devices
        given (the dry run's ``meta``); like ``jax.make_mesh`` it raises
        with fewer devices than it needs, and without a card by default."""
        single = make_production_mesh(devices=["meta"] * 256)
        assert single.shape == {"data": 16, "model": 16}
        multi = make_production_mesh(multi_pod=True, devices=["meta"] * 520)
        assert multi.shape == {"pod": 2, "data": 16, "model": 16}
        assert multi.axis_devices("pod") == [torch.device("meta")] * 2
        assert multi.take("pod", 1).shape == {"data": 16, "model": 16}
        with pytest.raises(ValueError, match="needs 512 devices"):
            make_production_mesh(multi_pod=True, devices=["cpu"] * 256)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                make_production_mesh()


class TestShardTopkPlan:
    """Mirrors the reference's ``TestShardTopkPlan``."""

    def test_shard_smaller_than_topk(self):
        k_shard, k_final = _shard_topk_plan(8, 4, 10)
        assert k_shard == 2 and k_final == 8

    def test_shard_larger_than_topk(self):
        k_shard, k_final = _shard_topk_plan(1024, 4, 10)
        assert k_shard == 16 and k_final == 10
        assert all(_shard_topk_plan(1024, 4, t)[0] == 16 for t in range(9, 17))
        assert _shard_topk_plan(1024, 4, 8) == (8, 8)


def test_ladders_round_to_the_shard_count():
    """The reference's rounding: pow-2 ladders unchanged for pow-2 shard
    counts, rounded up to a multiple otherwise; per-shard widths."""
    assert bucket_rows(40, 4) == 64 and bucket_rows(40, 3) == 66
    assert bucket_shortlist(5, 3) == 9 and bucket_survivors(20, 3) == 33
    cands = {k: torch.zeros((5, 4), dtype=dt) for k, dt in
             (("keys", torch.int64), ("vals_f", torch.float32),
              ("vals_u", torch.int64), ("mask", torch.bool))}
    cands["est_id"] = torch.tensor([1, 1, 1, 2, 2])
    plan = make_plan(cands, y_discrete=False, pad_multiple=3)
    assert [gp.bucket for gp in plan.groups] == [9, 9]
    assert [list(gp.index[gp.size:]) for gp in plan.groups] == \
        [[5] * 6, [5] * 7]
    hints = t_planner.ShortlistHints()
    spec = fused_shortlist_spec(plan, hints, 4, multiple=3, sharded=True)
    # bucket_rows(9, 3) = 18: min(rung 8, 6 rows a shard) * 3 shards
    assert spec.s_buckets == (18, 18)
    assert tier_spec(plan, hints, 0.5, multiple=3).s_survivors == (18, 18)
    assert fused_shortlist_spec(plan, hints, 4).s_buckets == (8, 8)


def test_pad_group_to_shards(index):
    """Dead pad rows: sentinel ids, fenced keys, dead live mask, -1
    signature rows; a dividing bucket passes through."""
    plan = index.plan(False)
    gp = plan.groups[0]
    assert t_ex._pad_group_to_shards(gp, 4, plan.n_candidates) is gp
    pad = t_ex._pad_group_to_shards(gp, 3, plan.n_candidates)
    b = gp.bucket
    assert pad.bucket % 3 == 0 and pad.bucket > b
    assert (pad.index[b:] == plan.n_candidates).all()
    assert not pad.live[b:].any() and not pad.arrays["mask"][b:].any()
    assert (pad.arrays["keys"][b:] == 0xFFFFFFFF).all()
    assert (pad.sig[b:] == -1).all()
    assert torch.equal(pad.arrays["keys"][:b], gp.arrays["keys"])


# ---------------------------------------------------------------------------
# execute: the dense (Q, C) scores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("y_disc", [False, True])
@pytest.mark.parametrize("shards", SHARDS)
def test_execute_equals_batched_and_partitioned(index, shards, y_disc):
    trains = stack_trains_host(_sketches(t_build, y_disc), "cpu")
    plan = index.plan(y_disc)
    mi, js = GroupMajorDistributedExecutor(_mesh(shards)).execute(plan, trains)
    for ex in (BatchedExecutor(), PartitionedLocalExecutor()):
        want = ex.execute(plan, trains)
        np.testing.assert_array_equal(mi, want[0])
        np.testing.assert_array_equal(js, want[1])


@pytest.mark.parametrize("y_disc", [False, True])
def test_execute_equals_reference_partitioned(index, j_index, y_disc):
    trains = stack_trains_host(_sketches(t_build, y_disc), "cpu")
    mi, js = GroupMajorDistributedExecutor(_mesh(4)).execute(
        index.plan(y_disc), trains)
    jt = j_stack([j_index.train_arrays(sk) for sk in _sketches(j_build, y_disc)])
    j_mi, j_js = JPartitioned().execute(j_index.plan(y_disc), jt)
    np.testing.assert_array_equal(js, np.asarray(j_js))
    np.testing.assert_allclose(mi, np.asarray(j_mi), rtol=TOL, atol=TOL)


_REFERENCE_MESH = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax
    from repro.core.discovery import (
        GroupMajorDistributedExecutor, SketchIndex, stack_trains)
    from repro.core.sketch import build_sketch
    d = np.load(sys.argv[1], allow_pickle=True)
    index = SketchIndex(n=int(d["n"]))
    for name, kk, v, disc in d["rows"]:
        index.add(name, "k", "v", kk, v, bool(disc))
    mesh = jax.make_mesh((4,), ("data",))
    assert mesh.shape["data"] == 4
    out = {}
    for y_disc in (False, True):
        sks = [build_sketch(d["keys"], v, n=int(d["n"]), side="train",
                            value_is_discrete=y_disc)
               for v in d["queries_%d" % y_disc]]
        trains = stack_trains([index.train_arrays(s) for s in sks])
        mi, js = GroupMajorDistributedExecutor(mesh).execute(
            index.plan(y_disc), trains)
        out["mi_%d" % y_disc], out["js_%d" % y_disc] = mi, js
    np.savez(sys.argv[2], **out)
""")


def test_execute_equals_reference_mesh(index, tmp_path):
    """The reference's 4-device mesh ``execute`` (the one reference mesh
    path that runs on jax 0.9.0), in a subprocess: its device count is
    fixed at jax's start."""
    rows = np.empty(len(ROWS_), dtype=object)
    rows[:] = [(name, kk, v, disc) for name, _, _, kk, v, disc in ROWS_]
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, rows=rows, keys=KEYS, n=N, queries_0=QUERIES[False],
             queries_1=QUERIES[True])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_MESH, str(inp),
                           str(out)], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = np.load(out)
    ex = GroupMajorDistributedExecutor(_mesh(4))
    for y_disc in (False, True):
        trains = stack_trains_host(_sketches(t_build, y_disc), "cpu")
        mi, js = ex.execute(index.plan(y_disc), trains)
        np.testing.assert_array_equal(js, ref[f"js_{int(y_disc)}"])
        np.testing.assert_allclose(mi, ref[f"mi_{int(y_disc)}"], rtol=TOL,
                                   atol=TOL)


# ---------------------------------------------------------------------------
# top-k: the shard programs and the merge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", SHARDS)
def test_topk_matches_dense_argsort(index, shards):
    """Q=3 winners, padded to a Q bucket of 4, equal the dense ranking's
    (ties to the lowest position, as ``lax.top_k``); the pow-2 k ladder
    cuts the merge to the exact count on the host."""
    plan = index.plan(False)
    trains = stack_trains_host(_sketches(t_build, False), "cpu")
    mi, js = BatchedExecutor().execute(plan, trains)
    ex = GroupMajorDistributedExecutor(_mesh(shards))
    for top_k in (3, 5, 60):
        got = ex.topk_dispatch(plan, trains, top_k, q_bucket=4).collect()
        assert len(got) == 3
        n_live = min(top_k, C)
        for q, (v, gi, j) in enumerate(got):
            # Past the corpus the merge keeps dead rows: -inf, sentinel.
            assert (gi < C).sum() == n_live and (v[n_live:] == -np.inf).all()
            v, gi, j = v[:n_live], gi[:n_live], j[:n_live]
            order = np.argsort(-mi[q], kind="stable")[:n_live]
            np.testing.assert_array_equal(v, mi[q][order])
            assert set(gi[v > v[-1]]) == set(order[mi[q][order] > v[-1]])
            np.testing.assert_array_equal(j, js[q][gi])


def test_distributed_topk_matches_score_batch(index):
    train = index.train_arrays(_sketches(t_build, False)[0])
    cands = index.stacked(False)
    mi, js = score_batch(train, cands)
    for shards in SHARDS:
        v, gi, j = distributed_topk(train, cands, _mesh(shards), top_k=7)
        order = np.argsort(-mi.numpy(), kind="stable")[:7]
        np.testing.assert_array_equal(v, mi.numpy()[order])
        np.testing.assert_array_equal(gi, order)
        np.testing.assert_array_equal(j, js.numpy()[order])


def test_query_returns_all_valid_when_topk_exceeds_corpus():
    """Mirrors the reference's regression: 8 candidates over 4 shards,
    top_k 20 — every joinable candidate comes back."""
    ix = SketchIndex(n=N, device="cpu")
    for r in ROWS_[:8]:
        ix.add(*r)
    sk = _sketches(t_build, False)[0]
    got = ix.query(sk, top_k=20, mesh=_mesh(4), min_join=0)
    want = ix.query(sk, top_k=20, min_join=0)
    assert _flat([got]) == _flat([want]) and len(got) == 8


def test_get_executor_distributed():
    mesh = _mesh(2)
    for spec in ("distributed", None):
        ex = get_executor(spec, mesh=mesh, k=5)
        assert type(ex) is GroupMajorDistributedExecutor
        assert ex.k == 5 and ex.n_shards == 2


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_discover_cli_mesh_equals_plain():
    from repro_torch.launch import discover

    outs = []
    for extra in ([], ["--mesh"]):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert discover.main(["--synthetic", "9", "--n", "64", "--top-k",
                                  "4", "--device", "cpu", *extra]) == 0
        outs.append([ln for ln in buf.getvalue().splitlines()
                     if ln.startswith("  MI=")])
    assert outs[0] and outs[0] == outs[1]


# ---------------------------------------------------------------------------
# On the card: four shards on cuda:0
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_index():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    ix = SketchIndex(n=N, device="cuda")
    for r in ROWS_:
        ix.add(*r)
    return ix


@pytest.mark.cuda
@pytest.mark.parametrize("y_disc", [False, True])
def test_cuda_execute_four_shards_on_one_card(cuda_index, y_disc):
    from repro_torch.kernels.knn_stats import kernel

    mesh = make_host_mesh(devices=["cuda:0"] * 4)
    trains = stack_trains_host(_sketches(t_build, y_disc), "cuda")
    plan = cuda_index.plan(y_disc)
    before = kernel.radius_counts.launches
    mi, js = GroupMajorDistributedExecutor(mesh).execute(plan, trains)
    assert kernel.radius_counts.launches > before
    want = BatchedExecutor().execute(plan, trains)
    np.testing.assert_array_equal(mi, want[0])
    np.testing.assert_array_equal(js, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("path", sorted(PATHS))
def test_cuda_query_many_on_mesh(cuda_index, path):
    for shards in (3, 4):
        mesh = make_host_mesh(devices=["cuda:0"] * shards)
        for y_disc in (False, True):
            sks = _sketches(t_build, y_disc)
            kw = dict(top_k=6, min_join=MIN_JOIN, **PATHS[path])
            assert _flat(cuda_index.query_many(sks, mesh=mesh, **kw)) == \
                _flat(cuda_index.query_many(sks, **kw))


@pytest.mark.cuda
def test_cuda_default_mesh_spans_visible_cards(cuda_index):
    mesh = make_host_mesh()
    assert mesh.shape["data"] == torch.cuda.device_count()
    sks = _sketches(t_build, False)
    kw = dict(top_k=6, min_join=MIN_JOIN)
    assert _flat(cuda_index.query_many(sks, mesh=mesh, **kw)) == \
        _flat(cuda_index.query_many(sks, **kw))

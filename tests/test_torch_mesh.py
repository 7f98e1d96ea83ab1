"""The port's discovery mesh against its batched path and the JAX package.

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

from repro.core import hashing
from repro.core.discovery import PartitionedLocalExecutor as JPartitioned
from repro.core.discovery import SketchIndex as JIndex
from repro.core.discovery import stack_trains as j_stack
from repro.core.sketch import build_sketch as j_build
from repro_torch import compile as programs
from repro_torch.core.discovery import (
    BatchedExecutor,
    DiscoveryService,
    GroupMajorDistributedExecutor,
    PartitionedLocalExecutor,
    SketchIndex,
    _shard_topk_plan,
    distributed_topk,
    get_executor,
    inject_faults,
    make_plan,
    score_batch,
    stack_trains_host,
)
from repro_torch.core.discovery import executors as t_ex
from repro_torch.core.discovery import planner as t_planner
from repro_torch.core.discovery.planner import (
    build_shortlists,
    bucket_rows,
    bucket_shortlist,
    bucket_survivors,
    fused_shortlist_spec,
    tier_spec,
)
from repro_torch.core.sketch import build_sketch as t_build
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh

TOL = 1e-5
N, ROWS, C = 64, 120, 48
MIN_JOIN = 8
SHARDS = [1, 3, 4]
PATHS = {
    "dense": dict(prefilter=False),
    "staged": dict(fused=False),
    "fused": dict(),
    "gated": dict(min_containment=0.1),
}


def _corpus():
    """48 candidates over a 120-row key universe: a third share all the
    train keys, a third part of them (join sizes around ``MIN_JOIN``),
    a third none; a quarter discrete."""
    rng = np.random.default_rng(404)
    keys = hashing.murmur3_32_np(np.arange(ROWS, dtype=np.uint32),
                                 seed=np.uint32(7))
    y = rng.normal(size=ROWS).astype(np.float32)
    rows = []
    for c in range(C):
        kk = hashing.murmur3_32_np(
            np.arange((c + 1) * 1000, (c + 1) * 1000 + ROWS, dtype=np.uint32),
            seed=np.uint32(7))
        if c % 3 == 0:
            kk = keys
        elif c % 3 == 1:
            kk = np.concatenate([keys[:14 + c], kk[14 + c:]])
        a = (c % 7) / 7
        v = (a * y + (1 - a) * rng.normal(size=ROWS)).astype(np.float32)
        disc = c % 4 == 0
        if disc:
            v = np.digitize(v, [-1.0, -0.3, 0.3, 1.0]).astype(np.int64)
        rows.append((f"t{c:02d}", "k", "v", kk, v, disc))
    qs = {False: [], True: []}
    for q in range(3):
        yq = (y + 0.2 * q * rng.normal(size=ROWS)).astype(np.float32)
        qs[False].append(yq)
        qs[True].append(np.digitize(yq, [-0.5, 0.0, 0.5]).astype(np.int64))
    return rows, keys, qs


ROWS_, KEYS, QUERIES = _corpus()


def _sketches(build, y_disc):
    return [build(KEYS, v, n=N, side="train", value_is_discrete=y_disc)
            for v in QUERIES[y_disc]]


def _flat(results):
    return [[(m.table, float(mi), int(js)) for m, mi, js in r]
            for r in results]


def _mesh(n: int) -> Mesh:
    return make_host_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def index():
    ix = SketchIndex(n=N, device="cpu")
    for r in ROWS_:
        ix.add(*r)
    return ix


@pytest.fixture(scope="module")
def j_index():
    ix = JIndex(n=N)
    for r in ROWS_:
        ix.add(*r)
    return ix


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


def test_topk_ladder_bounds_programs_and_keeps_results(index):
    """Mirrors the reference's ladder tests: ``top_k`` 1-10 on the dense
    mesh path returns exactly the dense local ranking, and builds one
    shard program per (group, k bucket) — buckets {4, 8, 16, 32, 64} of
    the oversampled counts."""
    mesh = _mesh(4)
    sk = _sketches(t_build, False)[0]
    c0 = programs.compile_count()
    for t in range(1, 11):
        got = index.query(sk, top_k=t, mesh=mesh, min_join=4, prefilter=False)
        assert len(got) == t
        assert _flat([got]) == _flat(
            [index.query(sk, top_k=t, min_join=4, prefilter=False)])
    assert programs.compile_count() - c0 <= 5 * len(index.plan(False).groups)


class TestFourShardGate:
    """The reference's ``TestFourShardParity`` on a 4-shard CPU mesh:
    5 joinable and 5 disjoint candidates; gated on the mesh == ungated on
    the mesh == gated locally, cold and warm; the service's gated
    windows deliver once warm and equal the ungated submit."""

    @pytest.fixture(scope="class")
    def small(self):
        rng = np.random.default_rng(14)
        ix = SketchIndex(n=N, device="cpu", sig_width=16)
        y = rng.normal(size=ROWS).astype(np.float32)
        for i in range(5):
            ix.add(f"cont{i}", "k", "v", KEYS,
                   (y + (0.2 + i) * rng.normal(size=ROWS)).astype(np.float32),
                   False)
        for i in range(5):
            far = hashing.murmur3_32_np(
                np.arange((i + 1) * ROWS, (i + 2) * ROWS, dtype=np.uint32),
                seed=np.uint32(9))
            ix.add(f"far{i}", "k", "v", far,
                   rng.normal(size=ROWS).astype(np.float32), False)
        sks = [t_build(KEYS, (y + 0.2 * q * rng.normal(size=ROWS))
                       .astype(np.float32), n=N, side="train",
                       value_is_discrete=False) for q in range(3)]
        return ix, sks

    def test_gated_equals_ungated_cold_and_warm(self, small):
        ix, sks = small
        mesh = _mesh(4)
        for _ in range(2):
            g_mesh = ix.query(sks[0], top_k=5, min_join=4, mesh=mesh,
                              min_containment=0.05)
            p_mesh = ix.query(sks[0], top_k=5, min_join=4, mesh=mesh)
            g_loc = ix.query(sks[0], top_k=5, min_join=4,
                             min_containment=0.05)
            assert g_mesh and _flat([g_mesh]) == _flat([p_mesh]) == \
                _flat([g_loc])

    def test_service_gated_windows(self, small):
        ix, sks = small
        svc = DiscoveryService(index=ix, mesh=_mesh(4), max_q_bucket=2)
        svc.submit(sks, top_k=5, min_join=4, min_containment=0.05)
        before = svc.stats()["admission"]["gated_windows"]
        got = svc.submit(sks, top_k=5, min_join=4, min_containment=0.05)
        assert svc.stats()["admission"]["gated_windows"] - before == 2
        assert _flat(got) == _flat(svc.submit(sks, top_k=5, min_join=4))


# ---------------------------------------------------------------------------
# query / query_many on every route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("shards", SHARDS)
def test_query_many_equals_batched(index, shards, path):
    mesh = _mesh(shards)
    for y_disc in (False, True):
        sks = _sketches(t_build, y_disc)
        for top_k, min_join in ((5, MIN_JOIN), (12, 30)):
            kw = dict(top_k=top_k, min_join=min_join, **PATHS[path])
            got = index.query_many(sks, mesh=mesh, **kw)
            assert any(got)
            assert _flat(got) == _flat(index.query_many(sks, **kw))
            one = index.query(sks[1], mesh=mesh, **kw)
            assert _flat([one]) == _flat(got[1:2])


def test_query_many_executor_with_mesh(index):
    sks = _sketches(t_build, False)
    mesh = _mesh(3)
    kw = dict(top_k=6, min_join=MIN_JOIN, prefilter=False)
    got = index.query_many(sks, mesh=mesh, executor="distributed", **kw)
    assert _flat(got) == _flat(index.query_many(sks, **kw))
    with pytest.raises(ValueError, match="distributed executor's top-k"):
        index.query_many(sks, mesh=mesh, executor="batched", **kw)


def test_mesh_overflow_falls_back_to_host_shortlists(index):
    """A fused mesh window whose per-shard width is too small overflows
    its fence and is served through the host boundary on the mesh; the
    sharded rung grows and the next window stays fused."""
    ix = SketchIndex(n=N, device="cpu")
    for r in ROWS_:
        ix.add(*r)
    sks = _sketches(t_build, False)
    mesh = _mesh(4)
    want = _flat(index.query_many(sks, top_k=8, min_join=4))
    assert _flat(ix.query_many(sks, top_k=8, min_join=4, mesh=mesh)) == want
    assert ix.shortlist_hints.overflows >= 1
    keys = [key for key in ix.shortlist_hints._rungs if key[-1]]
    assert keys and all(key[-1] is True for key in keys)
    n = ix.shortlist_hints.overflows
    assert _flat(ix.query_many(sks, top_k=8, min_join=4, mesh=mesh)) == want
    assert ix.shortlist_hints.overflows == n


def test_fused_mesh_window_moves_one_transfer(index, monkeypatch):
    """The counterpart of the reference's transfer guard on the mesh: a
    warm fused dispatch builds no host shortlist and its collect moves
    the fence and the merged winners in one device-to-host transfer."""
    mesh = _mesh(4)
    sks = _sketches(t_build, False)
    for _ in range(2):
        index.query_many(sks, top_k=5, min_join=4, mesh=mesh)

    def boom(*a, **k):
        raise AssertionError("host shortlist build on the fused path")

    monkeypatch.setattr(t_planner, "build_shortlists", boom)
    calls = []
    real_host = t_ex._host
    monkeypatch.setattr(t_ex, "_host",
                        lambda t: calls.append(t.shape) or real_host(t))
    plan = index.plan(False)
    ex = index._distributed_executor(mesh)
    spec = fused_shortlist_spec(plan, index.shortlist_hints, 4, multiple=4,
                                sharded=True)
    handle = ex.fused_topk_dispatch(plan, stack_trains_host(sks, "cpu"), spec,
                                    4, 5)
    assert calls == []
    triples = handle.collect()
    assert len(calls) == 1
    assert len(triples) == 3 and all(len(t[0]) for t in triples)


def test_mesh_programs_are_bounded(index):
    """Mesh traffic through the service pads Q up the pow-2 ladder, so
    queues of 1-4 queries per target dtype build at most one fused shard
    program per (dtype, Q bucket, group, width) on the one device, and
    repeating the traffic builds none."""
    svc = DiscoveryService(index=index, mesh=_mesh(4), max_q_bucket=4)
    queues = [[sk for pair in zip(_sketches(t_build, False)[:q],
                                  _sketches(t_build, True)[:q]) for sk in pair]
              for q in (1, 2, 3)]
    built = programs.compile_count()
    for queue in queues * 2:
        svc.submit(queue, top_k=5, min_join=MIN_JOIN)
    first = programs.compile_count() - built
    groups = len(index.plan(False).groups) + len(index.plan(True).groups)
    # Q buckets {1, 2, 4}; a rung may grow once while it settles (the
    # first window overflows its initial rung and is served by the host
    # boundary, which runs eager).
    assert 0 < first <= 3 * groups * 2
    built = programs.compile_count()
    for queue in queues * 2:
        svc.submit(queue, top_k=5, min_join=MIN_JOIN)
    assert programs.compile_count() == built


def test_get_executor_distributed():
    mesh = _mesh(2)
    for spec in ("distributed", None):
        ex = get_executor(spec, mesh=mesh, k=5)
        assert type(ex) is GroupMajorDistributedExecutor
        assert ex.k == 5 and ex.n_shards == 2


# ---------------------------------------------------------------------------
# The service's distributed rung
# ---------------------------------------------------------------------------


class TestServiceOnMesh:
    @pytest.mark.parametrize("path", ["fused", "dense", "gated"])
    def test_submit_equals_looped_mesh_query(self, index, path):
        mesh = _mesh(4)
        svc = DiscoveryService(index=index, mesh=mesh, max_q_bucket=2)
        assert svc._dist is index._distributed_executor(mesh, svc.k)
        queue = [sk for pair in zip(_sketches(t_build, False),
                                    _sketches(t_build, True)) for sk in pair]
        kw = dict(top_k=6, min_join=MIN_JOIN, **PATHS[path])
        got, outcomes = svc.submit_safe(queue, **kw)
        want = [index.query(sk, mesh=mesh, **kw) for sk in queue]
        assert _flat(got) == _flat(want)
        assert _flat(got) == _flat([index.query(sk, **kw) for sk in queue])
        assert {o.rung for o in outcomes} == {"distributed"}
        assert svc.stats()["admission"]["q_buckets"] == [1, 2]

    @pytest.mark.parametrize("path", sorted(PATHS))
    @pytest.mark.parametrize("shards", SHARDS)
    def test_hybrid_submit_equals_batched_service(self, index, shards, path):
        """``rank="hybrid"`` weights each score by join size / train size
        on the device before the shard top-k and the merge, so the mesh
        ranks every candidate the batched service ranks (query 0 keeps
        t33 and t39, which rank lower by MI alone), bit for bit."""
        queue = [sk for pair in zip(_sketches(t_build, False),
                                    _sketches(t_build, True)) for sk in pair]
        kw = dict(top_k=6, min_join=MIN_JOIN, rank="hybrid", **PATHS[path])
        want = DiscoveryService(index=index).submit(queue, **kw)
        got = DiscoveryService(index=index, mesh=_mesh(shards)).submit(
            queue, **kw)
        assert _flat(got) == _flat(want)
        tables = {m.table for m, _, _ in want[0]}
        assert {"t33", "t39"} <= tables
        assert _flat(want) != _flat(DiscoveryService(index=index).submit(
            queue, **{**kw, "rank": "mi"}))

    @pytest.mark.parametrize("sites, path", [
        (("dispatch",), "dense"),
        (("fused_dispatch", "prefilter_dispatch"), "fused"),
        (("tiered_dispatch", "prefilter_dispatch"), "gated")])
    def test_fault_descends_to_batched(self, index, sites, path):
        """Every dispatch of the distributed rung failing (the recovery
        re-runs a two-phase bucket through its prefilter): the bucket
        descends to the batched rung with the same results."""
        mesh = _mesh(3)
        svc = DiscoveryService(index=index, mesh=mesh)
        queue = _sketches(t_build, False)
        kw = dict(top_k=6, min_join=MIN_JOIN, **PATHS[path])
        clean = svc.submit(queue, **kw)
        with inject_faults({f"{site}@distributed": "all" for site in sites}):
            got, outcomes = svc.submit_safe(queue, **kw)
        assert _flat(got) == _flat(clean)
        assert {o.rung for o in outcomes} == {"batched"}
        assert all(o.fallbacks == 1 and o.status == "ok" for o in outcomes)
        st = svc.stats()["admission"]
        assert st["failed_buckets"] == 1 and st["fallbacks"] == 1


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

"""The port's discovery path end to end against the JAX package.

One corpus goes through ``repro``'s ``SketchIndex`` and, both via
``add`` and via ``index_from_numpy``, through ``repro_torch``'s on the
CPU.  ``query`` and ``query_many`` run on the fused, staged
(``fused=False``) and dense (``prefilter=False``) paths, with a forced
shortlist overflow.  Candidates, join sizes, group layouts and shortlist
rows are held equal; MI within rtol/atol 1e-5 (digamma differs between
the frameworks by ~2e-6); rankings identical wherever score gaps exceed
that tolerance.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import hashing
from repro.core.discovery import SketchIndex as JIndex
from repro.core.discovery import executors as j_ex
from repro.core.discovery import planner as j_planner
from repro.core.sketch import build_sketch as j_build
from repro_torch.convert import index_from_numpy
from repro_torch.core.discovery import SketchIndex as TIndex
from repro_torch.core.discovery import executors as t_ex
from repro_torch.core.discovery import planner as t_planner
from repro_torch.core.sketch import build_sketch as t_build
from repro_torch.launch.mesh import make_host_mesh

TOL = 1e-5
N, ROWS, C = 64, 120, 48
MIN_JOIN = 8
PATHS = {
    "fused": dict(),
    "staged": dict(fused=False),
    "dense": dict(prefilter=False),
}


def _corpus():
    rng = np.random.default_rng(303)
    keys = hashing.murmur3_32_np(np.arange(ROWS, dtype=np.uint32), seed=np.uint32(3))
    y = rng.normal(size=ROWS).astype(np.float32)
    rows = []
    for c in range(C):
        if c % 3 == 0:
            kk = keys  # full overlap
        else:
            kk = hashing.murmur3_32_np(
                np.arange((c + 1) * 1000, (c + 1) * 1000 + ROWS, dtype=np.uint32),
                seed=np.uint32(3))
            if c % 3 == 1:  # partial overlap: join sizes around min_join
                kk = np.concatenate([keys[: 20 + c], kk[20 + c:]])
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
    return [[(m.table, float(mi), int(js)) for m, mi, js in r] for r in results]


def assert_same_results(got, want):
    """Equal candidates and join sizes; MI allclose; two entries may
    trade places only where their scores are within tolerance."""
    assert len(got) == len(want)
    for g, w in zip(_flat(got), _flat(want)):
        assert len(g) == len(w)
        w_by = {t: (mi, js) for t, mi, js in w}
        for (tg, mg, jg), (tw, mw, jw) in zip(g, w):
            assert np.isclose(mg, mw, rtol=TOL, atol=TOL), (tg, mg, tw, mw)
            if tg != tw:
                assert tg in w_by and np.isclose(w_by[tg][0], mw, rtol=TOL,
                                                 atol=TOL), (tg, tw)
                assert w_by[tg][1] == jg
            else:
                assert jg == jw, tg


@pytest.fixture(scope="module")
def j_index():
    ix = JIndex(n=N)
    for r in ROWS_:
        ix.add(*r)
    return ix


@pytest.fixture(scope="module")
def port_indexes(j_index):
    added = TIndex(n=N, device="cpu")
    for r in ROWS_:
        added.add(*r)
    state = {
        "n": N, "method": "tupsk", "agg": "first",
        "keys": np.stack(j_index._keys), "vals_f": np.stack(j_index._vals_f),
        "vals_u": np.stack(j_index._vals_u), "masks": np.stack(j_index._masks),
        "meta": [(m.table, m.key_column, m.value_column, m.value_is_discrete)
                 for m in j_index.meta],
    }
    return {"add": added, "convert": index_from_numpy(state, device="cpu")}


@pytest.fixture(scope="module")
def j_results(j_index):
    cache = {}

    def get(path, y_disc, single=False):
        key = (path, y_disc, single)
        if key not in cache:
            sks = _sketches(j_build, y_disc)
            if single:
                cache[key] = [j_index.query(sks[0], top_k=12, min_join=MIN_JOIN,
                                            **PATHS[path])]
            else:
                cache[key] = j_index.query_many(sks, top_k=12, min_join=MIN_JOIN,
                                                **PATHS[path])
        return cache[key]

    return get


@pytest.mark.parametrize("source", ["add", "convert"])
@pytest.mark.parametrize("y_disc", [False, True], ids=["cont_target", "disc_target"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_query_many_matches_reference(port_indexes, j_results, source, y_disc, path):
    ix = port_indexes[source]
    got = ix.query_many(_sketches(t_build, y_disc), top_k=12, min_join=MIN_JOIN,
                        **PATHS[path])
    assert_same_results(got, j_results(path, y_disc))
    assert any(len(r) > 3 for r in got)


@pytest.mark.parametrize("y_disc", [False, True], ids=["cont_target", "disc_target"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_query_matches_reference(port_indexes, j_results, y_disc, path):
    sk = _sketches(t_build, y_disc)[0]
    got = port_indexes["add"].query(sk, top_k=12, min_join=MIN_JOIN, **PATHS[path])
    assert_same_results([got], j_results(path, y_disc, single=True))


def test_forced_shortlist_overflow_falls_back(j_results):
    """A fresh index's rung (8 lanes) is too narrow for this corpus: the
    first fused batch overflows, falls back to the host boundary and
    grows the rung; the second stays fused.  Both equal the reference."""
    ix = TIndex(n=N, device="cpu")
    for r in ROWS_:
        ix.add(*r)
    sks = _sketches(t_build, False)
    first = ix.query_many(sks, top_k=12, min_join=MIN_JOIN)
    assert ix.shortlist_hints.overflows >= 1
    n_over = ix.shortlist_hints.overflows
    second = ix.query_many(sks, top_k=12, min_join=MIN_JOIN)
    assert ix.shortlist_hints.overflows == n_over
    assert _flat(first) == _flat(second)
    assert_same_results(second, j_results("fused", False))


@pytest.mark.parametrize("y_disc", [False, True])
def test_layout_join_sizes_and_shortlists_exact(j_index, port_indexes, y_disc):
    """Group layouts, phase-1 join sizes and host shortlists are equal
    integer for integer; the device compaction reproduces the host
    shortlist lanes."""
    tix = port_indexes["add"]
    jplan, tplan = j_index.plan(y_disc), tix.plan(y_disc)
    assert [(g.est_id, g.bucket, g.size) for g in jplan.groups] == \
        [(g.est_id, g.bucket, g.size) for g in tplan.groups]
    for jg, tg in zip(jplan.groups, tplan.groups):
        np.testing.assert_array_equal(jg.index, tg.index)
    j_js = j_ex.BatchedExecutor().prefilter_dispatch(
        jplan, j_ex.stack_trains_host(_sketches(j_build, y_disc))).collect()
    trains = t_ex.stack_trains_host(_sketches(t_build, y_disc), "cpu")
    t_js = t_ex.BatchedExecutor().prefilter_dispatch(tplan, trains).collect()
    for (_, a), (_, b) in zip(j_js, t_js):
        np.testing.assert_array_equal(a, b)
    j_sl = j_planner.build_shortlists(jplan, j_js, MIN_JOIN)
    t_sl = t_planner.build_shortlists(tplan, t_js, MIN_JOIN)
    assert len(j_sl) == len(t_sl)
    for a, b, (gp, js) in zip(j_sl, t_sl, t_js):
        assert (a is None) == (b is None)
        if a is None:
            continue
        for f in ("rows", "gidx", "js"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.s_bucket, a.shortlisted) == (b.s_bucket, b.shortlisted)
        rows, gidx, jsz, counts = t_ex._compact_shortlist(
            torch.from_numpy(js), gp.live, MIN_JOIN, tplan.n_candidates,
            gp.index_dev, b.s_bucket)
        np.testing.assert_array_equal(rows.numpy(), b.rows)
        np.testing.assert_array_equal(gidx.numpy(), b.gidx)
        np.testing.assert_array_equal(jsz.numpy(), b.js)
        assert int(counts.max()) <= b.s_bucket


def test_fused_dispatch_matches_host_shortlists(port_indexes):
    """At the full row bucket the device compaction never overflows, and
    the fused pass's triples equal the host-shortlist pass's, value for
    value, on both target dtypes."""
    ix = port_indexes["add"]
    ex = t_ex.BatchedExecutor()
    for y_disc in (False, True):
        plan = ix.plan(y_disc)
        trains = t_ex.stack_trains_host(_sketches(t_build, y_disc), "cpu")
        spec = t_planner.FusedSpec(tuple(gp.bucket for gp in plan.groups))
        fused = ex.fused_dispatch(plan, trains, spec, MIN_JOIN).collect()
        shortlists = t_planner.build_shortlists(
            plan, ex.prefilter_dispatch(plan, trains).collect(), MIN_JOIN)
        staged = ex.shortlist_dispatch(plan, trains, shortlists).collect()
        assert len(fused) == len(staged) == 3
        for a, b in zip(fused, staged):
            live_a, live_b = a[2] > 0, b[2] > 0
            np.testing.assert_array_equal(np.sort(a[1][live_a]), np.sort(b[1][live_b]))
            fa = dict(zip(a[1][live_a], zip(a[0][live_a], a[2][live_a])))
            fb = dict(zip(b[1][live_b], zip(b[0][live_b], b[2][live_b])))
            assert fa == fb


def test_planner_ladders_and_hints():
    for n in [0, 1, 7, 8, 9, 100, 4097]:
        assert t_planner.bucket_rows(n) == j_planner.bucket_rows(n)
        assert t_planner.bucket_shortlist(n) == j_planner.bucket_shortlist(n)
    for xd in (False, True):
        for yd in (False, True):
            assert t_planner.estimator_id(xd, yd) == j_planner.estimator_id(xd, yd)
    est = np.array([1, 0, 1, 3, 2, 0])
    for (a, ia), (b, ib) in zip(t_planner.partition_by_estimator(est),
                                j_planner.partition_by_estimator(est)):
        assert a == b and np.array_equal(ia, ib)
    th, jh = t_planner.ShortlistHints(), j_planner.ShortlistHints()
    for obs, over in [(3, False), (40, True), (39, False), (2, False), (9, False)]:
        th.observe(("k",), obs, overflowed=over)
        jh.observe(("k",), obs, overflowed=over)
        assert th.get(("k",)) == jh.get(("k",))
    assert th.overflows == jh.overflows


def test_incremental_ingest_and_plan_versions():
    ix = TIndex(n=N, device="cpu")
    for r in ROWS_[:10]:
        ix.add(*r)
    p1 = ix.plan(False)
    assert ix.plan(False) is p1  # cached until the next add
    assert ix.ingest_stats["group_h2d_rows"] == 10
    for r in ROWS_[10:13]:
        ix.add(*r)
    assert ix.ingest_stats["pending_rows"] == 3
    p2 = ix.plan(False)
    assert p2 is not p1 and p2.n_candidates == 13
    assert ix.ingest_stats["group_h2d_rows"] == 13  # only the new rows moved
    # pow-2 row growth copies the live rows into the larger store
    for r in ROWS_[13:40]:
        ix.add(*r)
    ix.plan(False)
    assert ix.ingest_stats["group_store_grows"] >= 1
    keys = ix.plan(False).groups[0].arrays["keys"]
    assert keys.dtype == torch.int64 and int(keys.max()) == 0xFFFFFFFF


def test_rejects_invalid_and_later_slices(port_indexes, j_index):
    ix = port_indexes["add"]
    sk = _sketches(t_build, False)[0]
    # The mesh is ported: a 3-shard CPU mesh ranks as the batched path.
    mesh = make_host_mesh(devices=["cpu"] * 3)
    assert _flat([ix.query(sk, top_k=12, min_join=MIN_JOIN, mesh=mesh)]) == \
        _flat([ix.query(sk, top_k=12, min_join=MIN_JOIN)])
    # The phase-0 gate is ported: a gated batch equals the reference's.
    gated = ix.query_many([sk], top_k=12, min_join=MIN_JOIN,
                          min_containment=0.1)
    assert gated[0]
    assert_same_results(gated, j_index.query_many(
        _sketches(j_build, False)[:1], top_k=12, min_join=MIN_JOIN,
        min_containment=0.1))
    with pytest.raises(ValueError, match="one target dtype"):
        ix.query_many([sk, _sketches(t_build, True)[0]])
    with pytest.raises(ValueError, match="capacity"):
        ix._build_validated(KEYS, np.zeros(ROWS, np.float32), False, None,
                            2 * N)
    assert ix.query_many([]) == []


def test_add_table_matches_reference():
    from repro.data.tables import Table as JTable
    from repro_torch.data.tables import Table as TTable

    rng = np.random.default_rng(5)
    cols = {"id": np.arange(200), "a": rng.normal(size=200).astype(np.float32),
            "b": np.array([f"c{i % 7}" for i in range(200)])}
    ji, ti = JIndex(n=N), TIndex(n=N, device="cpu")
    ji.add_table(JTable("tab", cols), "id")
    ti.add_table(TTable("tab", cols), "id")
    assert [vars(m) for m in ti.meta] == [vars(m) for m in ji.meta]
    for a, b in zip(ti._keys + ti._masks + ti._vals_f,
                    ji._keys + ji._masks + ji._vals_f):
        np.testing.assert_array_equal(a, b)


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA"):
        TIndex(n=N)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_discover_cli_on_cpu(capsys):
    from repro_torch.launch import discover

    assert discover.main(["--synthetic", "5", "--n", "64", "--top-k", "3",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "query over 5 candidates" in out and "MI=" in out
    assert discover.main(["--device", "cpu"]) == 2


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, and chip_smoke.py, import cleanly in a
    fresh interpreter without pulling in jax or the reference package."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(root, "src")
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.launch.mesh import make_host_mesh\n"
        "assert make_host_mesh(devices=['cpu'] * 2).shape['data'] == 2\n"
        "assert 'repro_torch.launch.mesh' in sys.modules\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=src)
    proc = subprocess.run([sys.executable, "-c", code, root], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15

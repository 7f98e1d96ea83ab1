"""The discovery mesh's ``query`` / ``query_many`` on every route against
the batched path, on 1 and 3 CPU shards (``test_torch_mesh_programs.py``
runs 4), the distributed executor chosen by name, the fused window's
overflow and its one transfer.  Split from ``test_torch_mesh.py`` (see
``_torch_mesh_common.py``); tolerances as there: bit for bit.
"""

import pytest

from repro_torch.core.discovery import (
    SketchIndex,
    stack_trains_host,
)
from repro_torch.core.discovery import executors as t_ex
from repro_torch.core.discovery import planner as t_planner
from repro_torch.core.discovery.planner import build_shortlists, fused_shortlist_spec
from repro_torch.core.sketch import build_sketch as t_build

from _torch_mesh_common import (  # noqa: F401 (fixtures)
    N,
    MIN_JOIN,
    PATHS,
    ROWS_,
    _sketches,
    _flat,
    _mesh,
    index,
    batched,
)
from _torch_threads import one_thread  # noqa: F401 (autouse)


# ---------------------------------------------------------------------------
# query / query_many on every route
# ---------------------------------------------------------------------------


QM_SHARDS = [1, 3]  # 4: test_torch_mesh_programs.py


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("shards", QM_SHARDS)
def test_query_many_equals_batched(index, batched, shards, path):
    mesh = _mesh(shards)
    for y_disc in (False, True):
        sks = _sketches(t_build, y_disc)
        for top_k, min_join in ((5, MIN_JOIN), (12, 30)):
            kw = dict(top_k=top_k, min_join=min_join, **PATHS[path])
            got = index.query_many(sks, mesh=mesh, **kw)
            assert any(got)
            assert _flat(got) == batched(y_disc, **kw)
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

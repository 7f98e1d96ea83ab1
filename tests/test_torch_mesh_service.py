"""The discovery service's distributed rung on CPU meshes: ``submit`` and
``submit_safe`` against looped mesh queries and the batched service
(``rank="hybrid"`` too), and the descent to the batched rung under
faults.  Split from ``test_torch_mesh.py`` (see ``_torch_mesh_common.py``);
tolerances as there: bit for bit.
"""

import pytest

from repro_torch.core.discovery import (
    DiscoveryService,
    inject_faults,
)
from repro_torch.core.sketch import build_sketch as t_build

from _torch_mesh_common import (  # noqa: F401 (fixtures)
    MIN_JOIN,
    SHARDS,
    PATHS,
    _sketches,
    _flat,
    _mesh,
    index,
)
from _torch_threads import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def batched_service(index):
    """The batched service's ``submit`` of the interleaved queue on a
    route, ranked by ``rank``: the oracle of the hybrid test, which does
    not depend on the shard count; each computed once a module."""
    memo = {}

    def run(path: str, rank: str):
        if (path, rank) not in memo:
            queue = [sk for pair in zip(_sketches(t_build, False),
                                        _sketches(t_build, True)) for sk in pair]
            memo[path, rank] = DiscoveryService(index=index).submit(
                queue, top_k=6, min_join=MIN_JOIN, rank=rank, **PATHS[path])
        return memo[path, rank]

    return run


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
    def test_hybrid_submit_equals_batched_service(self, index, batched_service,
                                                  shards, path):
        """``rank="hybrid"`` weights each score by join size / train size
        on the device before the shard top-k and the merge, so the mesh
        ranks every candidate the batched service ranks (query 0 keeps
        t33 and t39, which rank lower by MI alone), bit for bit."""
        queue = [sk for pair in zip(_sketches(t_build, False),
                                    _sketches(t_build, True)) for sk in pair]
        kw = dict(top_k=6, min_join=MIN_JOIN, rank="hybrid", **PATHS[path])
        want = batched_service(path, "hybrid")
        got = DiscoveryService(index=index, mesh=_mesh(shards)).submit(
            queue, **kw)
        assert _flat(got) == _flat(want)
        tables = {m.table for m, _, _ in want[0]}
        assert {"t33", "t39"} <= tables
        assert _flat(want) != _flat(batched_service(path, "mi"))

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

"""The discovery mesh on 4 CPU shards: ``query_many`` on every route
against the batched path (1 and 3 shards: ``test_torch_mesh_routes.py``),
the programs a service's mesh traffic builds, the top-k ladder, and the
reference's four-shard gate parity.  Split from ``test_torch_mesh.py``
(see ``_torch_mesh_common.py``); tolerances as there: bit for bit.
"""

import numpy as np
import pytest

from repro.core import hashing
from repro_torch import compile as programs
from repro_torch.core.discovery import (
    DiscoveryService,
    SketchIndex,
)
from repro_torch.core.sketch import build_sketch as t_build
from repro_torch.launch.mesh import Mesh

from _torch_mesh_common import (  # noqa: F401 (fixtures)
    N,
    ROWS,
    MIN_JOIN,
    PATHS,
    KEYS,
    _sketches,
    _flat,
    _mesh,
    index,
    batched,
)
from _torch_threads import one_thread  # noqa: F401 (autouse)


QM_SHARDS = [4]  # 1 and 3: test_torch_mesh_routes.py


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

"""Shared corpus, helpers and fixtures of the discovery-mesh tests
(``tests/test_torch_mesh*.py``): 48 candidates on a 120-row key universe,
three queries per target dtype, the routes ``PATHS``, CPU meshes of 1, 3
and 4 shards, the port's and the reference's indexes as module-scoped
fixtures, and ``batched``, the batched path's ``query_many`` results (the
oracle of every mesh route, which does not depend on the shard count)
computed once a module.  Split from ``test_torch_mesh.py`` so that
``--dist loadfile`` spreads the mesh tests over the workers; no test was
removed.
"""

import numpy as np
import pytest

from repro.core import hashing
from repro.core.discovery import SketchIndex as JIndex
from repro_torch.core.discovery import SketchIndex
from repro_torch.core.sketch import build_sketch as t_build
from repro_torch.launch.mesh import Mesh, make_host_mesh

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





@pytest.fixture(scope="module")
def batched(index):
    """``index.query_many``'s results on the batched path, flattened, for
    the target dtype's queries and the keywords given; each computed once
    a module."""
    memo = {}

    def run(y_disc: bool, **kw):
        key = (y_disc, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = _flat(index.query_many(_sketches(t_build, y_disc), **kw))
        return memo[key]

    return run

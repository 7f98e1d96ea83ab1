"""The port's ad-hoc scoring API against the JAX package's.

One corpus covering all four estimator ids (continuous and discrete
candidates against continuous and discrete targets) goes through
``repro``'s ``SketchIndex`` and through the port's, both via ``add`` and
via ``index_from_numpy``; the reference's ``stacked()`` dicts, and
hand-made, unsorted and solo-sliced ones, are carried across with
``stacked_from_numpy``.  ``score_batch``, ``score_batch_reference``,
``score_batch_partitioned`` and ``query_many(executor=)`` must give
exactly the reference's join sizes and its MI within rtol/atol 1e-5
(digamma differs between the frameworks by ~2e-6).  Within the port,
``score_batch`` must equal ``score_batch_partitioned`` bit for bit.
"""

import numpy as np
import pytest
import torch

from repro.core import hashing
from repro.core.discovery import SketchIndex as JIndex
from repro.core.discovery import executors as j_ex
from repro.core.discovery import planner as j_planner
from repro.core.sketch import build_sketch as j_build
from repro_torch.convert import index_from_numpy, stacked_from_numpy
from repro_torch.core.discovery import (
    BatchedExecutor,
    GroupMajorDistributedExecutor,
    PartitionedLocalExecutor,
    get_executor,
    make_plan,
    pack_group,
    score_batch,
    score_batch_partitioned,
    score_batch_reference,
    stack_trains,
)
from repro_torch.core.discovery import SketchIndex as TIndex
from repro_torch.core.sketch import build_sketch as t_build
from repro_torch.launch.mesh import make_host_mesh

TOL = 1e-5
N, ROWS = 64, 1200
RNG = np.random.default_rng(55)
KEYS = hashing.murmur3_32_np(np.arange(ROWS, dtype=np.uint32), seed=np.uint32(9))
Y = RNG.normal(size=ROWS).astype(np.float32)


def _corpus():
    """Candidates of both dtypes with graded dependence on Y, a partial
    key overlap and a disjoint one (an empty join)."""
    rng = np.random.default_rng(56)
    other = hashing.murmur3_32_np(np.arange(ROWS, 2 * ROWS, dtype=np.uint32),
                                  seed=np.uint32(9))
    rows = []
    for c in range(14):
        a = (c % 5) / 5
        v = (a * Y + (1 - a) * rng.normal(size=ROWS)).astype(np.float32)
        disc = c % 3 == 0
        if disc:
            v = np.digitize(v, [-0.7, 0.0, 0.7]).astype(np.int64)
        kk = KEYS if c % 4 else np.concatenate([KEYS[:300], other[300:]])
        rows.append((f"t{c:02d}", "k", "v", kk, v, disc))
    rows.append(("disjoint", "k", "v", other, Y.copy(), False))
    return rows


ROWS_ = _corpus()
TARGETS = {False: Y, True: np.digitize(Y, [-0.5, 0.5]).astype(np.int64)}


@pytest.fixture(scope="module")
def indexes():
    j = JIndex(n=N)
    t = TIndex(n=N, device="cpu")
    for r in ROWS_:
        j.add(*r)
        t.add(*r)
    state = {
        "n": N, "method": "tupsk", "agg": "first",
        "keys": np.stack(j._keys), "vals_f": np.stack(j._vals_f),
        "vals_u": np.stack(j._vals_u), "masks": np.stack(j._masks),
        "meta": [(m.table, m.key_column, m.value_column, m.value_is_discrete)
                 for m in j.meta],
    }
    return j, {"add": t, "convert": index_from_numpy(state, device="cpu")}


def _np(d: dict) -> dict:
    return {k: (v if isinstance(v, bool) else np.asarray(v)) for k, v in d.items()}


def _trains(y_disc: bool):
    j_sk = j_build(KEYS, TARGETS[y_disc], n=N, side="train",
                   value_is_discrete=y_disc)
    t_sk = t_build(KEYS, TARGETS[y_disc], n=N, side="train",
                   value_is_discrete=y_disc)
    return j_sk, t_sk


def _check(got, want):
    """Port (mi, js) tensors against reference (mi, js) arrays."""
    mi, js = (a.cpu().numpy() for a in got)
    assert mi.dtype == np.float32 and js.dtype == np.int32
    np.testing.assert_array_equal(js, np.asarray(want[1]))
    np.testing.assert_allclose(mi, np.asarray(want[0]), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("y_disc", [False, True])
@pytest.mark.parametrize("source", ["add", "convert"])
def test_stacked_equals_reference(indexes, y_disc, source):
    j, t = indexes
    want = stacked_from_numpy(_np(j.stacked(y_disc)), device="cpu")
    got = t[source].stacked(y_disc)
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


def test_all_four_estimators_present(indexes):
    _, t = indexes
    ids = set(t["add"].stacked(False)["est_id"].tolist()) \
        | set(t["add"].stacked(True)["est_id"].tolist())
    assert ids == {0, 1, 2, 3}


@pytest.mark.parametrize("y_disc", [False, True])
@pytest.mark.parametrize("scorer", ["score_batch", "score_batch_reference",
                                    "score_batch_partitioned"])
def test_scorers_match_reference(indexes, y_disc, scorer):
    j, t = indexes
    j_sk, t_sk = _trains(y_disc)
    want = getattr(j_ex, scorer)(JIndex.train_arrays(j_sk), j.stacked(y_disc))
    cands = t["add"].stacked(y_disc)
    port = {"score_batch": score_batch,
            "score_batch_reference": score_batch_reference,
            "score_batch_partitioned": score_batch_partitioned}[scorer]
    for train in (t["add"].train_arrays(t_sk),
                  stacked_from_numpy(_np(JIndex.train_arrays(j_sk)), device="cpu")):
        _check(port(train, cands), want)


@pytest.mark.parametrize("y_disc", [False, True])
def test_score_batch_bit_equal_partitioned_and_reference(indexes, y_disc):
    """score_batch == score_batch_partitioned bit for bit; on the CPU the
    materialized estimators select and count as the fused ones do, so
    score_batch_reference is bit-equal too."""
    _, t = indexes
    _, t_sk = _trains(y_disc)
    train = t["convert"].train_arrays(t_sk)
    cands = t["convert"].stacked(y_disc)
    mi, js = score_batch(train, cands)
    for other in (score_batch_partitioned(train, cands),
                  score_batch_reference(train, cands)):
        assert torch.equal(mi, other[0]) and torch.equal(js, other[1])
    assert js[-1] == 0 and mi[-1] == 0.0  # the disjoint candidate


def test_empty_join_scores_zero_on_every_estimator(indexes):
    """All-False candidate rows score exactly 0.0 with join size 0 under
    each estimator id, in both packages."""
    j, _ = indexes
    base = _np(j.stacked(False))
    C = 4
    cands = {k: np.repeat(base[k][:1], C, axis=0) for k in
             ("keys", "vals_f", "vals_u", "mask")}
    cands["mask"][:] = False
    cands["est_id"] = np.arange(C, dtype=np.int32)
    for y_disc in (False, True):
        j_sk, t_sk = _trains(y_disc)
        want = j_ex.score_batch(JIndex.train_arrays(j_sk), cands)
        t_cands = stacked_from_numpy(cands, device="cpu")
        train = stacked_from_numpy(_np(JIndex.train_arrays(j_sk)), device="cpu")
        for scorer in (score_batch, score_batch_reference,
                       score_batch_partitioned):
            mi, js = scorer(train, t_cands)
            assert torch.equal(js, torch.zeros(C, dtype=torch.int32))
            assert torch.all(mi == 0.0)
        np.testing.assert_array_equal(np.asarray(want[0]), 0.0)


def test_unsorted_hand_made_dict():
    """A hand-made dict in no key order, padding interleaved with valid
    slots, a padding key equal to a valid key and a duplicated valid key:
    the lexsort join sorts each row itself, as the reference's does."""
    rng = np.random.default_rng(9)
    C, cap = 6, 48
    train_keys = rng.choice(KEYS[:80], size=N).astype(np.uint32)
    train = {
        "keys": train_keys,
        "vals_f": rng.normal(size=N).astype(np.float32),
        "vals_u": rng.integers(0, 5, size=N).astype(np.uint32),
        "mask": rng.random(N) < 0.9,
    }
    keys = np.stack([rng.permutation(KEYS[:120])[:cap] for _ in range(C)])
    mask = rng.random((C, cap)) < 0.8
    keys[0, 1] = keys[0, 0]  # a padding slot may carry a valid key...
    mask[0, 0], mask[0, 1] = False, True
    keys[1, 3] = keys[1, 2]  # ... and a valid key may repeat
    mask[1, 2:4] = True
    cands = {
        "keys": keys.astype(np.uint32),
        "vals_f": rng.normal(size=(C, cap)).astype(np.float32),
        "vals_u": rng.integers(0, 4, size=(C, cap)).astype(np.uint32),
        "mask": mask,
        "est_id": np.array([0, 1, 2, 3, 1, 2], np.int32),
    }
    want = j_ex.score_batch(train, cands)
    want_ref = j_ex.score_batch_reference(train, cands)
    t_train = stacked_from_numpy(train, device="cpu")
    t_cands = stacked_from_numpy(cands, device="cpu")
    _check(score_batch(t_train, t_cands), want)
    _check(score_batch_reference(t_train, t_cands), want_ref)
    assert int(np.asarray(want[1]).min()) > 0


@pytest.mark.parametrize("y_disc", [False, True])
def test_solo_slices(indexes, y_disc):
    """Scoring a candidate alone gives its value in the whole batch (the
    reference's ``test_score_batch_matches_single``), and the reference's
    own solo value."""
    j, t = indexes
    j_sk, t_sk = _trains(y_disc)
    j_train = JIndex.train_arrays(j_sk)
    train = t["add"].train_arrays(t_sk)
    cands = t["add"].stacked(y_disc)
    j_cands = _np(j.stacked(y_disc))
    mi, js = score_batch(train, cands)
    for c in (0, 1, 3, 5):
        solo = {k: v[c:c + 1] for k, v in cands.items()}
        mi0, js0 = score_batch(train, solo)
        assert js0[0] == js[c]
        assert float(mi0[0]) == pytest.approx(float(mi[c]), abs=TOL)
        want = j_ex.score_batch(j_train, {k: v[c:c + 1] for k, v in j_cands.items()})
        _check((mi0, js0), want)


def test_group_padding_rows_invisible():
    """Three candidates in one group pad to the 8-row bucket with masked
    duplicates; the padding never reaches the results."""
    index = TIndex(n=N, device="cpu")
    rng = np.random.default_rng(3)
    for i in range(3):
        index.add(f"c{i}", "k", "v", KEYS,
                  (Y + i * rng.normal(size=ROWS)).astype(np.float32), False)
    train = index.train_arrays(t_build(KEYS, Y, n=N, side="train"))
    cands = index.stacked(False)
    mi_a, js_a = score_batch_partitioned(train, cands)
    mi_b, js_b = score_batch(train, cands)
    assert mi_a.shape == (3,)
    assert torch.equal(mi_a, mi_b) and torch.equal(js_a, js_b)
    plan = make_plan(cands, y_discrete=False)
    (gp,) = plan.groups
    assert (gp.size, gp.bucket) == (3, 8)
    assert not gp.arrays["mask"][3:].any()
    np.testing.assert_array_equal(gp.index, [0, 1, 2] + [3] * 5)


@pytest.mark.parametrize("y_disc", [False, True])
def test_make_plan_and_groups_override(indexes, y_disc):
    """``make_plan`` lays groups out as the reference's does, and
    ``groups=`` (in any order, as ``(est_id, indices)``) scores the
    same."""
    j, t = indexes
    _, t_sk = _trains(y_disc)
    cands = t["add"].stacked(y_disc)
    j_plan = j_planner.make_plan(j.stacked(y_disc), y_discrete=y_disc)
    plan = make_plan(cands, y_discrete=y_disc)
    assert [(g.est_id, g.size, g.bucket) for g in plan.groups] == \
        [(g.est_id, g.size, g.bucket) for g in j_plan.groups]
    for g, jg in zip(plan.groups, j_plan.groups):
        np.testing.assert_array_equal(g.index, jg.index)
        for name in ("keys", "vals_f", "vals_u", "mask"):
            np.testing.assert_array_equal(
                g.arrays[name].numpy(),
                np.asarray(jg.arrays[name]).astype(g.arrays[name].numpy().dtype))
    train = t["add"].train_arrays(t_sk)
    base = score_batch_partitioned(train, cands)
    est = cands["est_id"].numpy()
    groups = [(e, np.flatnonzero(est == e)) for e in sorted(set(est), reverse=True)]
    over = score_batch_partitioned(train, cands, groups=groups)
    assert torch.equal(base[0], over[0]) and torch.equal(base[1], over[1])


def test_pad_multiple_needs_the_mesh_slice(indexes):
    """``pad_multiple`` (a mesh's shard count) rounds every group bucket up
    to a multiple of it, laid out as the reference's: pow-2 counts leave
    the ladder as it is, 3 pads it."""
    j, t = indexes
    cands = t["add"].stacked(False)
    for mult in (2, 3):
        plan = make_plan(cands, y_discrete=False, pad_multiple=mult)
        j_plan = j_planner.make_plan(j.stacked(False), y_discrete=False,
                                     pad_multiple=mult)
        assert [(g.est_id, g.size, g.bucket) for g in plan.groups] == \
            [(g.est_id, g.size, g.bucket) for g in j_plan.groups]
        assert all(g.bucket % mult == 0 for g in plan.groups)
        for g, jg in zip(plan.groups, j_plan.groups):
            np.testing.assert_array_equal(g.index, jg.index)
            np.testing.assert_array_equal(g.arrays["mask"].numpy(),
                                          np.asarray(jg.arrays["mask"]))
    gp = pack_group(cands, 1, np.arange(3), len(cands["est_id"]),
                    pad_multiple=3)
    assert (gp.size, gp.bucket) == (3, 9)


@pytest.mark.parametrize("pad", [1, 4, 16])
def test_stacked_padding_and_cache(pad):
    """Cached per (dtype, padding) until ``add``; padded rows are empty
    MLE rows that score 0.0; a later ``add`` leaves the rows returned
    before it untouched (as the reference's immutable arrays are)."""
    index = TIndex(n=N, device="cpu")
    j = JIndex(n=N)
    for r in ROWS_[:5]:
        index.add(*r)
        j.add(*r)
    first = index.stacked(False, pad_to_multiple=pad)
    assert index.stacked(False, pad_to_multiple=pad) is first
    assert index.stacked(True, pad_to_multiple=pad) is not first
    want = stacked_from_numpy(_np(j.stacked(False, pad_to_multiple=pad)),
                              device="cpu")
    for name in want:
        assert torch.equal(first[name], want[name]), name
    C = -(-5 // pad) * pad
    assert first["keys"].shape[0] == C
    assert not first["mask"][5:].any() and torch.all(first["est_id"][5:] == 0)
    snapshot = {k: v.clone() for k, v in first.items()}
    train = index.train_arrays(t_build(KEYS, Y, n=N, side="train"))
    mi, js = score_batch(train, first)
    assert torch.all(mi[5:] == 0.0) and torch.all(js[5:] == 0)
    for r in ROWS_[5:]:
        index.add(*r)
    fresh = index.stacked(False, pad_to_multiple=pad)
    assert fresh is not first
    assert fresh["keys"].shape[0] == -(-len(ROWS_) // pad) * pad
    for name, v in snapshot.items():
        assert torch.equal(first[name], v), name
    assert index.ingest_stats["h2d_rows"] == len(ROWS_)


def test_stack_trains(indexes):
    j_sks = [_trains(False)[0], j_build(KEYS, Y[::-1].copy(), n=N, side="train")]
    t_sks = [_trains(False)[1], t_build(KEYS, Y[::-1].copy(), n=N, side="train")]
    _, t = indexes
    q1 = [t["add"].train_arrays(sk) for sk in t_sks]
    flat = [{k: (v[0] if torch.is_tensor(v) else v) for k, v in d.items()}
            for d in q1]
    want = stacked_from_numpy(_np(j_ex.stack_trains(
        [JIndex.train_arrays(sk) for sk in j_sks])), device="cpu")
    for trains in (q1, flat, [q1[0], flat[1]]):
        got = stack_trains(trains)
        assert got.keys() == want.keys()
        for name in ("keys", "vals_f", "vals_u", "mask"):
            assert torch.equal(got[name], want[name]), name
        assert got["y_discrete"] is False
    disc = t["add"].train_arrays(_trains(True)[1])
    with pytest.raises(ValueError, match="share one dtype"):
        stack_trains([q1[0], disc])
    with pytest.raises(ValueError, match="no train sketches"):
        stack_trains([])
    with pytest.raises(ValueError, match="one train sketch"):
        score_batch(stack_trains(q1), t["add"].stacked(False))


def test_get_executor():
    ex = BatchedExecutor(k=5)
    assert get_executor(ex) is ex
    assert type(get_executor("partitioned")) is PartitionedLocalExecutor
    assert type(get_executor(None)) is PartitionedLocalExecutor
    assert get_executor("batched", k=7).k == 7
    with pytest.raises(ValueError, match="requires a mesh"):
        get_executor("distributed")
    mesh = make_host_mesh(devices=["cpu"] * 2)
    for spec in ("distributed", None):
        ex = get_executor(spec, mesh=mesh, k=4)
        assert type(ex) is GroupMajorDistributedExecutor
        assert ex.mesh is mesh and ex.k == 4
    with pytest.raises(ValueError, match="unknown executor"):
        get_executor("sharded")


def _flat(results):
    return [[(m.table, float(mi), int(js)) for m, mi, js in r] for r in results]


@pytest.mark.parametrize("y_disc", [False, True])
@pytest.mark.parametrize("executor", ["batched", "partitioned"])
def test_query_many_executor(indexes, y_disc, executor):
    """``executor=`` keeps the dense path: equal to the reference's, and
    within the port equal to the dense default and to ``score_batch``."""
    j, t = indexes
    j_sks = [_trains(y_disc)[0]] * 2
    t_sks = [_trains(y_disc)[1]] * 2
    kw = dict(top_k=8, min_join=4)
    want = j.query_many(j_sks, executor=executor, prefilter=False, **kw)
    for index in t.values():
        got = index.query_many(t_sks, executor=executor, prefilter=False, **kw)
        assert [[(a, js) for a, _, js in r] for r in _flat(got)] == \
            [[(a, js) for a, _, js in r] for r in _flat(want)]
        for g, w in zip(_flat(got), _flat(want)):
            np.testing.assert_allclose([m for _, m, _ in g], [m for _, m, _ in w],
                                       rtol=TOL, atol=TOL)
        assert _flat(got) == _flat(index.query_many(t_sks, prefilter=False, **kw))
        # auto (None) with executor= serves dense, as the reference does
        assert _flat(index.query_many(t_sks, executor=executor, **kw)) == _flat(got)
        mi, _ = score_batch(index.train_arrays(t_sks[0]), index.stacked(y_disc))
        by_table = {m.table: c for c, m in enumerate(index.meta)}
        for table, m, _ in _flat(got)[0]:
            assert m == float(mi[by_table[table]])


def test_query_many_executor_rejects_two_phase_options(indexes):
    _, t = indexes
    sk = _trains(False)[1]
    index = t["add"]
    with pytest.raises(ValueError, match="incompatible with executor"):
        index.query_many([sk], min_join=4, prefilter=True, executor="batched")
    with pytest.raises(ValueError, match="requires the two-phase path"):
        index.query_many([sk], min_join=4, executor="batched",
                         min_containment=0.1)
    with pytest.raises(ValueError, match="requires the two-phase path"):
        index.query_many([sk], min_join=4, prefilter=False, min_containment=0.1)
    mesh = make_host_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="distributed executor's top-k"):
        index.query_many([sk], mesh=mesh, executor="batched")
    assert index.query_many([sk], min_join=4, mesh=mesh,
                            executor="distributed") == \
        index.query_many([sk], min_join=4, executor="batched")


# ---------------------------------------------------------------------------
# On the card: the CUDA path against the CPU path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_indexes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = {}
    for dev in ("cpu", "cuda"):
        index = TIndex(n=N, device=dev)
        for r in ROWS_:
            index.add(*r)
        out[dev] = index
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("y_disc", [False, True])
def test_cuda_score_batch_equals_cpu(cuda_indexes, y_disc):
    from repro_torch.kernels.knn_stats import kernel

    _, t_sk = _trains(y_disc)
    res = {}
    for dev, index in cuda_indexes.items():
        train, cands = index.train_arrays(t_sk), index.stacked(y_disc)
        before = kernel.radius_counts.launches
        res[dev] = score_batch(train, cands)
        if dev == "cuda":
            assert kernel.radius_counts.launches > before
            assert res[dev][0].device.type == "cuda"
            part = score_batch_partitioned(train, cands)
            assert torch.equal(res[dev][0], part[0])
            assert torch.equal(res[dev][1], part[1])
    assert torch.equal(res["cuda"][1].cpu(), res["cpu"][1])
    np.testing.assert_allclose(res["cuda"][0].cpu().numpy(),
                               res["cpu"][0].numpy(), rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_cuda_score_batch_reference_launches_pairwise_cheb(cuda_indexes):
    from repro_torch.kernels.pairwise_cheb import kernel

    _, t_sk = _trains(False)
    index = cuda_indexes["cuda"]
    train, cands = index.train_arrays(t_sk), index.stacked(False)
    before = kernel.pairwise_cheb.launches
    mi, js = score_batch_reference(train, cands)
    assert kernel.pairwise_cheb.launches > before
    fused = score_batch(train, cands)
    assert torch.equal(js, fused[1])
    np.testing.assert_allclose(mi.cpu().numpy(), fused[0].cpu().numpy(),
                               rtol=TOL, atol=TOL)

"""The port's compiled programs (``repro_torch.compile``) and the Q-axis
ladder, against the JAX package.

On the CPU a program runs its function eagerly and registers its key, so
what is held here is the bookkeeping and the padding: ``bucket_queries``
for q = 1..64 and its errors, ``pad_trains_q`` / ``_pad_rows_q`` equal to
the reference's; ``query_many`` and ``submit`` at Q = 3 and 5 (padded
lanes) with rankings and join sizes equal to the reference's and to the
port's unpadded run, and the service's ``padded_lanes`` / ``q_buckets``
equal; ``compile_count()`` deltas in both packages (a warm repeat adds
0, a new Q bucket adds at least 1); ``eager()`` giving the same results;
the decode step at a device position bit-equal to the integer-position
step it replaced and within atol 1e-4 of the JAX ``decode_step``; the
cast-once weight copies rebuilt after an in-place update; and the
capture-safe scalars bit-identical to the host-tensor ones they replace.
The ``cuda``-marked cases (replay against eager, launch counters through
replays, two in-flight dispatches, a grow between dispatch and collect)
need a card and skip here.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import hashing
from repro.core.discovery import DiscoveryService as JService
from repro.core.discovery import SketchIndex as JIndex
from repro.core.discovery import executors as j_ex
from repro.core.discovery import planner as j_planner
from repro.core.sketch import build_sketch as j_build
from repro.models import transformer as JT
from repro_torch import compile as tc
from repro_torch.convert import model_params_from_numpy
from repro_torch.core import estimators
from repro_torch.core.discovery import (
    BatchedExecutor,
    DiscoveryService,
    SketchIndex,
    bucket_queries,
    compile_count,
    fused_shortlist_spec,
    pad_trains_q,
    stack_trains_host,
)
from repro_torch.core.discovery import executors as t_ex
from repro_torch.core.join import KEY_MAX, effective_keys
from repro_torch.core.sketch import build_sketch as t_build
from repro_torch.kernels.pairwise_cheb.ops import pairwise_cheb
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.common import cast, cast_params
from _torch_threads import one_thread  # noqa: F401 (autouse)

TOL = 1e-5
ATOL = 1e-4  # the JAX decode_step bound of tests/test_torch_models.py
N, ROWS, C = 64, 120, 40
MIN_JOIN = 8
KEYS = hashing.murmur3_32_np(np.arange(ROWS, dtype=np.uint32), seed=np.uint32(5))


def _rows(seed=505):
    """C candidates: a third share the train keys, a third overlap them
    partly, a third are disjoint; a quarter are discrete."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=ROWS).astype(np.float32)
    rows = []
    for c in range(C):
        kk = KEYS if c % 3 == 0 else hashing.murmur3_32_np(
            np.arange((c + 1) * 1000, (c + 1) * 1000 + ROWS, dtype=np.uint32),
            seed=np.uint32(5))
        if c % 3 == 1:
            kk = np.concatenate([KEYS[: 20 + c], kk[20 + c:]])
        a = (c % 7) / 7
        v = (a * y + (1 - a) * rng.normal(size=ROWS)).astype(np.float32)
        disc = c % 4 == 0
        if disc:
            v = np.digitize(v, [-1.0, -0.3, 0.3, 1.0]).astype(np.int64)
        rows.append((f"t{c:02d}", "k", "v", kk, v, disc))
    return rows, y


ROWS_, Y = _rows()


def _index(cls=SketchIndex, device="cpu", rows=ROWS_):
    ix = cls(n=N, device=device) if cls is SketchIndex else cls(n=N)
    for r in rows:
        ix.add(*r)
    return ix


def _queue(q, seed=7, disc_every=0, build=t_build):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(q):
        yq = (Y + (0.1 + 0.2 * i) * rng.normal(size=ROWS)).astype(np.float32)
        disc = bool(disc_every) and i % disc_every == disc_every - 1
        v = np.digitize(yq, [-0.5, 0.0, 0.5]).astype(np.int64) if disc else yq
        out.append(build(KEYS, v, n=N, side="train", value_is_discrete=disc))
    return out


def _flat(res):
    return [(m.table, mi, js) for m, mi, js in res]


def assert_same_results(got, want):
    """Port vs JAX: equal candidates and join sizes, MI allclose; two
    entries may trade places only where their scores are within
    tolerance."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _flat(g), _flat(w)
        assert len(g) == len(w)
        w_by = {t: (mi, js) for t, mi, js in w}
        for (tg, mg, jg), (tw, mw, jw) in zip(g, w):
            assert np.isclose(mg, mw, rtol=TOL, atol=TOL), (tg, mg, tw, mw)
            assert tg in w_by and w_by[tg][1] == jg
            if tg != tw:
                assert np.isclose(w_by[tg][0], mw, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def pair():
    return _index(), _index(JIndex)


# ---------------------------------------------------------------------------
# The Q ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", range(1, 65))
def test_bucket_queries_equals_reference(q):
    assert bucket_queries(q) == j_planner.bucket_queries(q)


@pytest.mark.parametrize("q, cap", [(0, 64), (-1, 64), (65, 64), (3, 2),
                                    (5, 4), (9, 8)])
def test_bucket_queries_errors_as_reference(q, cap):
    with pytest.raises(ValueError) as got:
        bucket_queries(q, cap)
    with pytest.raises(ValueError) as want:
        j_planner.bucket_queries(q, cap)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("q, q_bucket", [(3, 4), (5, 8), (4, 4), (1, 2)])
def test_pad_trains_q_equals_reference(q, q_bucket):
    sks, j_sks = _queue(q), _queue(q, build=j_build)
    got = pad_trains_q(stack_trains_host(sks, "cpu"), q_bucket)
    want = j_ex.pad_trains_q(j_ex.stack_trains_host(j_sks), q_bucket)
    for f in ("keys", "vals_f", "vals_u", "mask"):
        g, w = got[f].numpy(), np.asarray(want[f])
        assert g.shape == w.shape == (q_bucket,) + w.shape[1:]
        if f == "vals_u":
            w = w.astype(np.int64)  # the port's zero-extended uint32 view
        if f == "keys":
            w = w.astype(np.uint32).astype(np.int64)
        np.testing.assert_array_equal(g, w)
    assert got["y_discrete"] == want["y_discrete"]
    with pytest.raises(ValueError, match="q_bucket"):
        pad_trains_q(stack_trains_host(sks, "cpu"), q - 1)


@pytest.mark.parametrize("q_bucket", [3, 4, 8])
def test_pad_rows_q_equals_reference(q_bucket):
    rows = np.arange(3 * 5, dtype=np.int32).reshape(3, 5)
    np.testing.assert_array_equal(t_ex._pad_rows_q(rows, q_bucket),
                                  j_ex._pad_rows_q(rows, q_bucket))


@pytest.mark.parametrize("q", [3, 5])
@pytest.mark.parametrize("path", ["fused", "dense"])
def test_padded_lanes_equal_unpadded_run(pair, q, path):
    """The executor at ``q_bucket`` equals its unpadded run value for
    value, and ``query_many`` equals the reference's."""
    index, j_index = pair
    sks = _queue(q)
    plan = index.plan(False)
    trains = stack_trains_host(sks, "cpu")
    ex = BatchedExecutor()
    qb = bucket_queries(q)
    if path == "dense":
        a = ex.execute(plan, trains)
        b = ex.execute(plan, trains, q_bucket=qb)
        for x, y in zip(a, b):
            assert x.shape[0] == q
            np.testing.assert_array_equal(x, y)
    else:
        spec = fused_shortlist_spec(plan, index.shortlist_hints, MIN_JOIN)
        spec = type(spec)(tuple(gp.bucket for gp in plan.groups))  # no overflow
        a = ex.fused_dispatch(plan, trains, spec, MIN_JOIN).collect()
        b = ex.fused_dispatch(plan, trains, spec, MIN_JOIN,
                              q_bucket=qb).collect()
        assert len(a) == len(b) == q
        for x, y in zip(a, b):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
    kw = dict(top_k=10, min_join=MIN_JOIN,
              **({} if path == "fused" else {"prefilter": False}))
    assert_same_results(index.query_many(sks, **kw),
                        j_index.query_many(_queue(q, build=j_build), **kw))


@pytest.mark.parametrize("q", [3, 5])
def test_submit_padded_equals_reference_and_loop(q):
    t_svc = DiscoveryService(index=_index(), max_q_bucket=8)
    j_svc = JService(index=_index(JIndex), max_q_bucket=8)
    every = {3: 0, 5: 2}[q]  # 3 continuous -> rung 4; 3 + 2 -> rungs 4, 2
    sks, j_sks = (_queue(q, disc_every=every),
                  _queue(q, disc_every=every, build=j_build))
    for _ in range(2):
        got = t_svc.submit(sks, top_k=10, min_join=MIN_JOIN)
        want = j_svc.submit(j_sks, top_k=10, min_join=MIN_JOIN)
        assert_same_results(got, want)
    t_adm, j_adm = t_svc.stats()["admission"], j_svc.stats()["admission"]
    for key in ("padded_lanes", "q_buckets", "batches", "split_batches"):
        assert t_adm[key] == j_adm[key], key
    assert t_adm["padded_lanes"] > 0
    loop = [t_svc.index.query(sk, top_k=10, min_join=MIN_JOIN) for sk in sks]
    assert [_flat(g) for g in got] == [_flat(w) for w in loop]


def test_compile_count_deltas_equal_reference():
    """A warm repeat builds nothing in either package; a new Q bucket
    builds at least one program in both."""
    t_svc = DiscoveryService(index=_index(), max_q_bucket=8)
    j_svc = JService(index=_index(JIndex), max_q_bucket=8)
    three, j_three = _queue(3), _queue(3, build=j_build)
    for _ in range(2):  # cold, then the shortlist rungs settle
        t_svc.submit(three, top_k=5, min_join=MIN_JOIN)
        j_svc.submit(j_three, top_k=5, min_join=MIN_JOIN)
    t0, j0 = compile_count(), j_ex.compile_count()
    t_svc.submit(three, top_k=5, min_join=MIN_JOIN)
    j_svc.submit(j_three, top_k=5, min_join=MIN_JOIN)
    assert compile_count() - t0 == j_ex.compile_count() - j0 == 0
    assert t_svc.stats()["compiled_programs"] == compile_count()
    t_svc.submit(_queue(5), top_k=5, min_join=MIN_JOIN)  # rung 8
    j_svc.submit(_queue(5, build=j_build), top_k=5, min_join=MIN_JOIN)
    assert compile_count() - t0 >= 1
    assert j_ex.compile_count() - j0 >= 1


def test_eager_gives_the_same_results_and_builds_nothing(pair):
    index, _ = pair
    svc = DiscoveryService(index=index)
    sks = _queue(4, disc_every=2)
    on = svc.submit(sks, top_k=10, min_join=MIN_JOIN, min_containment=0.1)
    n = compile_count()
    with tc.eager():
        off = svc.submit(sks, top_k=10, min_join=MIN_JOIN, min_containment=0.1)
        assert compile_count() == n
    assert [_flat(r) for r in on] == [_flat(r) for r in off]


# ---------------------------------------------------------------------------
# The Program wrapper
# ---------------------------------------------------------------------------


def _affine(x, y, *, w, scale):
    return x * scale + w["a"] + y["b"]


def test_program_keys_on_static_shapes_and_residents():
    p = tc.Program(_affine, static=("scale",), resident=("w",))
    w = {"a": torch.ones(3)}
    x, y = torch.arange(3.0), {"b": torch.full((3,), 2.0)}
    n = compile_count()
    assert torch.equal(p(x, y, w=w, scale=2), x * 2 + 3)
    p(x + 1, {"b": torch.zeros(3)}, w=w, scale=2)  # new values, same key
    assert compile_count() == n + 1
    p(x, y, w=w, scale=3)  # a static argument
    p(torch.arange(4.0), {"b": torch.ones(4)}, w={"a": torch.ones(4)},
      scale=3)  # shapes
    w2 = {"a": torch.ones(3)}
    p(x, y, w=w2, scale=3)  # another resident buffer
    assert compile_count() == n + 4
    with tc.eager():
        p(x, y, w={"a": torch.zeros(3)}, scale=9)
    assert compile_count() == n + 4


def test_program_drops_programs_of_freed_buffers_and_checks_arguments():
    p = tc.Program(_affine, static=("scale",), resident=("w",))
    w = {"a": torch.ones(3)}
    p(torch.ones(3), {"b": torch.ones(3)}, w=w, scale=1)
    assert len(p._entries) == 1
    del w
    p(torch.ones(3), {"b": torch.ones(3)}, w={"a": torch.ones(3)}, scale=2)
    assert len(p._entries) == 1  # the first one's buffer was freed
    with pytest.raises(TypeError, match="tensor or a dict"):
        p([torch.ones(3)], {"b": torch.ones(3)}, w={"a": torch.ones(3)},
          scale=1)
    with pytest.raises(ValueError, match="no argument"):
        tc.Program(_affine, static=("nope",))


def test_launch_counters_are_every_kernel_wrapper():
    names = [f.__name__ for f in tc.launch_counters()]
    assert names == ["radius_counts", "radius_counts_staged",
                     "radius_counts_tiled", "knn_smallest",
                     "knn_smallest_staged", "knn_smallest_tiled",
                     "ball_counts", "ball_counts_staged", "ball_counts_tiled",
                     "pairwise_cheb", "murmur3_fib", "flash_attention_simt",
                     "flash_attention_wgmma", "grouped_swiglu_mm"]
    assert all(isinstance(f.launches, int) for f in tc.launch_counters())


# ---------------------------------------------------------------------------
# Capture-safe scalars: bit-identical to the host tensors they replace
# ---------------------------------------------------------------------------


def _old_dc_stats(codes, y, mask, kk):
    """``estimators._dc_stats`` before the change (a host tensor for +inf)."""
    P = y.shape[-1]
    off = estimators._off_diagonal(P, y.device)
    same = (codes[..., :, None] == codes[..., None, :]) \
        & mask[..., :, None] & mask[..., None, :]
    n_x = estimators._count(same)
    k_eff = torch.clamp(n_x - 1, max=kk)
    _, dy, _ = pairwise_cheb(y, y, mask)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=y.device)
    dy_sorted = torch.sort(torch.where(same & off, dy, inf), dim=-1).values
    idx = torch.clamp(k_eff - 1, 0, P - 1).long()
    d_i = dy_sorted.gather(-1, idx[..., None])
    return n_x, k_eff, estimators._count((dy < d_i) & off)


@pytest.mark.parametrize("seed", [0, 1])
def test_capture_safe_scalars_bit_identical(monkeypatch, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(6, 40)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(6, 40)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 4, size=(6, 40)).astype(np.float32))
    mask = torch.from_numpy(rng.random((6, 40)) < 0.8)
    keys = torch.from_numpy(rng.integers(0, 2**32, size=(6, 40)))
    got = (estimators.ksg_mi(x, y, mask), estimators.mixed_ksg_mi(x, y, mask),
           estimators.dc_ksg_mi(codes, y, mask, impl="materialized"),
           effective_keys(keys, mask))
    monkeypatch.setattr(estimators, "_scalar", lambda v, like: torch.tensor(
        v, dtype=torch.float32, device=like.device))
    monkeypatch.setattr(estimators, "_dc_stats", _old_dc_stats)
    want = (estimators.ksg_mi(x, y, mask), estimators.mixed_ksg_mi(x, y, mask),
            estimators.dc_ksg_mi(codes, y, mask, impl="materialized"),
            torch.where(mask, keys.to(torch.int64),
                        torch.tensor(KEY_MAX, dtype=torch.int64)))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---------------------------------------------------------------------------
# Serving: the decode step at a device position, the cast-once weights
# ---------------------------------------------------------------------------


def _int_pos_decode(cfg, params, caches, tokens, pos: int):
    """``transformer.decode_step`` as it was with an integer position:
    ``torch.full`` positions, a slice-assigned cache row, a mask against
    the integer."""
    from repro_torch.configs.base import LayerSpec
    from repro_torch.models import attention as A
    from repro_torch.models.common import norm_apply
    from repro_torch.parallel import decode_attention as D

    x = T._embed_inputs(cfg, params, {"tokens": tokens})
    dense = LayerSpec("attn", "dense")
    for p, cache in zip(params["layers"], caches):
        h = norm_apply(p["pre_norm"], x)
        B = h.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.int32)
        q, k_new, v_new = A.gqa._qkv(cfg, p["mixer"], h, positions)
        cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
        out = D.decode_attention(q[:, 0], cache["k"], cache["v"], pos,
                                 scale=1.0 / np.sqrt(cfg.head_dim))
        out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
        x, _ = T._ffn(cfg, dense, p, x + A.linear(p["mixer"]["wo"], out),
                      "gspmd")
    return T._head(cfg, params, x)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmo-1b"])
def test_decode_device_pos_bit_equal_and_near_jax(arch):
    cfg = M.get_config(arch, smoke=True)
    jparams = JT.init_params(cfg, jax.random.key(0))
    params = model_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(3)
    B, S, MAX = 2, 12, 32
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    _, caches = T.prefill(cfg, params, {"tokens": torch.from_numpy(toks[:, :S])},
                          max_len=MAX)
    twin = [{n: t.clone() for n, t in c.items()} for c in caches]
    nxt = torch.from_numpy(toks[:, S:])
    got, _ = T.decode_step(cfg, params, caches, nxt,
                           torch.full((), S, dtype=torch.int32))
    want = _int_pos_decode(cfg, params, twin, nxt, S)
    assert torch.equal(got, want)
    for a, b in zip(caches, twin):
        assert all(torch.equal(a[n], b[n]) for n in a)
    _, jc = JT.prefill(cfg, jparams, {"tokens": jnp.asarray(toks[:, :S])},
                       max_len=MAX)
    jl, _ = JT.decode_step(cfg, jparams, jc, jnp.asarray(toks[:, S:]),
                           jnp.int32(S))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), atol=ATOL)


def test_batcher_decode_program_equals_eager():
    """The batcher's compiled decode step (one program for every step of
    one batcher) serves the tokens its eager step serves."""
    cfg = M.get_config("olmo-1b", smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, 6).astype(np.int32)
               for _ in range(2)]
    outs = []
    for ctx, built in ((contextlib.nullcontext, 1), (tc.eager, 0)):
        b = serve.ContinuousBatcher(cfg, params, 2, 24)
        n = compile_count()
        with ctx():
            for r, p in enumerate(prompts):
                assert b.admit(r, p)
            for _ in range(3):
                b.step()
        assert compile_count() - n == built
        outs.append(b.outputs)
    assert outs[0] == outs[1]


def test_cast_copy_made_once_and_rebuilt_after_update():
    w = torch.nn.Parameter(torch.randn(8, 4), requires_grad=False)
    a = cast(w, torch.bfloat16)
    assert cast(w, torch.bfloat16) is a  # made once
    assert torch.equal(a, w.to(torch.bfloat16))
    assert cast(w, torch.float32) is w
    with torch.no_grad():
        w.add_(1.0)  # an in-place update bumps the version
    b = cast(w, torch.bfloat16)
    assert b is not a and torch.equal(b, w.to(torch.bfloat16))
    tree = cast_params(torch.nn.ModuleDict({"l": torch.nn.ParameterDict(
        {"w": w})}), torch.bfloat16)
    assert tree["l"]["w"] is b


# ---------------------------------------------------------------------------
# On the card (skip here)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_state():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return _index(device="cuda")


def _rc_launches():
    from repro_torch.kernels.knn_stats import kernel

    return kernel.radius_counts.launches


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [0.0, 0.1])
def test_cuda_replay_equals_eager_and_counts_launches(cuda_state, gate):
    index = cuda_state
    sks = _queue(4)
    kw = dict(top_k=10, min_join=MIN_JOIN, min_containment=gate)
    for _ in range(2):  # cold (captures), then rungs settled
        index.query_many(sks, **kw)
    n = compile_count()
    before = _rc_launches()
    on = index.query_many(sks, **kw)
    replayed = _rc_launches() - before
    assert compile_count() == n
    with tc.eager():
        before = _rc_launches()
        off = index.query_many(sks, **kw)
        eager_launches = _rc_launches() - before
    assert replayed == eager_launches > 0
    assert [_flat(r) for r in on] == [_flat(r) for r in off]


@pytest.mark.cuda
def test_cuda_two_in_flight_dispatches_keep_their_outputs(cuda_state):
    index = cuda_state
    plan = index.plan(False)
    ex = BatchedExecutor()
    a, b = _queue(4, seed=1), _queue(4, seed=2)
    want = [ex.execute(plan, stack_trains_host(s, "cuda")) for s in (a, b)]
    h1 = ex.dispatch(plan, stack_trains_host(a, "cuda"))
    h2 = ex.dispatch(plan, stack_trains_host(b, "cuda"))
    for h, w in zip((h1, h2), want):
        for x, y in zip(h.collect(), w):
            np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_cuda_grow_between_dispatch_and_collect(cuda_state):
    svc = DiscoveryService(index=_index(device="cuda", rows=ROWS_[:20]))
    sks = _queue(5, disc_every=2)
    opts = dict(top_k=10, min_join=MIN_JOIN)
    solo = svc.submit(sks, **opts)
    win = svc._window_dispatch(sks, isolate=True, prefilter=None, **opts)
    grows = svc.index.ingest_stats["group_store_grows"]
    for i, r in enumerate(ROWS_[20:]):
        svc.add(f"late{i}", *r[1:])
    svc.index.plan(False), svc.index.plan(True)
    assert svc.index.ingest_stats["group_store_grows"] > grows
    res, outs = svc._window_collect(win)
    assert all(o.ok for o in outs)
    assert [_flat(r) for r in res] == [_flat(r) for r in solo]
    grown = svc.submit(sks, **opts)
    with tc.eager():
        loop = [svc.index.query(sk, **opts) for sk in sks]
    assert [_flat(g) for g in grown] == [_flat(w) for w in loop]


@pytest.mark.cuda
def test_cuda_decode_replay_bit_equal_eager(cuda_state):
    """The captured decode step against the eager step from identical
    copies of the caches: logits and caches bit-equal."""
    cfg = M.get_config("internlm2-1.8b", smoke=True).with_overrides(
        dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
    b = serve.ContinuousBatcher(cfg, params, 2, 32)
    rng = np.random.default_rng(4)
    for r in range(2):
        assert b.admit(r, rng.integers(0, cfg.vocab_size, 9).astype(np.int32))
    b.step()  # captures
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 1)),
                           dtype=torch.int32, device="cuda")
    twin = [{n: t.clone() for n, t in c.items()} for c in b.caches]
    n = compile_count()
    got, _ = b._decode(toks, 10)
    assert compile_count() == n  # a replay
    programmed, b.caches = b.caches, twin
    with tc.eager():
        want, _ = b._decode(toks, 10)
    assert torch.equal(got, want)
    for a, c in zip(programmed, twin):
        assert all(torch.equal(a[k], c[k]) for k in a)

"""The staged two-op bodies' exactness argument, on the CPU.

``csrc/knn_two_op.cu``'s staged bodies compute ``ref.knn_smallest`` and
``ref.ball_counts`` by another route, one warp a sample:

* staging compacts each sample's valid columns straight into sort keys;
  a key is a value's order (``code_key``: -0.0 folded onto +0.0, NaN
  last), and a bitonic network sorts them (padding with the largest key);
* ``knn_smallest`` sorts by (x, y) (by (code, y) in class mode) and takes
  rows in sorted order.  Joint mode walks outward from the row's position
  while |dx| < the current W-th smallest (the branch-free buffer update);
  class mode finds the row's run of equal codes by binary search and
  merges it outward from the row, kb steps, a NaN distance counting as
  +inf.  Each column then takes
  the output of the first sorted position of its own key;
* ``ball_counts`` takes rows in column order; over the sorted non-NaN
  values fl(v_i - v_j) does not increase, so each count is a range found
  by binary search on the predicate itself (the kernel's branch-free,
  power-of-two form), the row's own column taken out; j_eq is the run of
  the row's (x, y) key inside its x-tie range.

``_emulate_knn`` and ``_emulate_ball`` repeat those routes step by step in
numpy float32 and are held bit-equal to ``ref`` and to the JAX package's
``knn_smallest`` / ``ball_counts``.

The tiled bodies (P > 1024, or kb > 16 for ``knn_smallest``) read both
ops off the tiled ``radius_counts`` body's sorted orders
(``csrc/sorted_orders.cuh``, emulated in ``_torch_sorted_route``): the
band walk with a W-lane buffer (kb <= 64) or the four-stream walk (kb >
64) in joint mode, kb steps of the class merge in class mode, every
count a binary-searched range at the caller's radius.
``_tiled_emulate_knn`` and ``_tiled_emulate_ball`` repeat them and are
held bit-equal to ``ref`` and to JAX the same way.  The kernels
themselves are held against ``ref`` on the card
(``test_torch_knn_two_op.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_sorted_route import (TILED_CHUNK, WARP_P, _band_walk, _band_width,
                                 _chunk_sort, _class_runs, _class_walk,
                                 _event_walk, _row_counts, _sample_orders)
from repro.kernels.knn_stats import ops as j_ops
from repro_torch.kernels._build import build_tag, local_includes
from repro_torch.kernels.knn_stats import kernel, ref
from _torch_threads import one_thread  # noqa: F401 (autouse)

F32 = np.float32
INF = F32(np.inf)
NAN_KEY = np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# The kernel's primitives
# ---------------------------------------------------------------------------

def _code_key(v: np.ndarray) -> np.ndarray:
    """``code_key``: a float32's order as uint32, -0.0 folded onto +0.0,
    every NaN 0xFFFFFFFF."""
    v = np.where(v == 0, F32(0), v).astype(F32)
    u = v.view(np.uint32)
    key = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return np.where(np.isnan(v), NAN_KEY, key)


def _key_value(k: np.ndarray) -> np.ndarray:
    """``key_value``: the float32 of a key (-0.0 comes back as +0.0)."""
    k = k.astype(np.uint32)
    u = np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32)
    return u.view(F32)


def _pair_key(a, b) -> np.ndarray:
    return (_code_key(a).astype(np.uint64) << np.uint64(32)) \
        | _code_key(b).astype(np.uint64)


def _bitonic(keys: np.ndarray) -> np.ndarray:
    """The warp's bitonic network over the n keys padded with the
    largest key to N (a power of two, at least 32); returns the first n."""
    n = keys.size
    N = 32
    while N < n:
        N *= 2
    pad = np.iinfo(keys.dtype).max
    v = np.concatenate([keys, np.full(N - n, pad, keys.dtype)])
    t = np.arange(N // 2)
    size = 2
    while size <= N:
        stride = size // 2
        while stride > 0:
            a = 2 * t - (t & (stride - 1))
            c = a + stride
            ka, kc = v[a], v[c]
            swap = (ka > kc) == ((a & size) == 0)
            v[a], v[c] = np.where(swap, kc, ka), np.where(swap, ka, kc)
            stride //= 2
        size *= 2
    return v[:n]


def _search(pred, lo, hi):
    """The first j in [lo, hi) where the monotone ``pred(j)`` holds, one
    binary search per row (the kernel's loop, all rows in lockstep)."""
    lo, hi = np.array(lo, np.int64), np.array(hi, np.int64)
    while True:
        act = lo < hi
        if not act.any():
            return lo
        mid = (lo + hi) >> 1
        p = pred(np.where(act, mid, 0))
        hi = np.where(act & p, mid, hi)
        lo = np.where(act & ~p, mid + 1, lo)


def _search_pow2(pred, nn):
    """The kernel's branch-free form of the same search over [0, nn), all
    rows in lockstep: steps from the highest power of two <= max(nn) down
    to 1, each adding the step while the predicate fails at the step's end
    (nn may differ by row)."""
    nn = np.asarray(nn, np.int64)
    at = np.zeros(nn.shape, np.int64)
    step = 1 << (int(nn.max()).bit_length() - 1) if nn.size and nn.max() > 0 else 0
    while step:
        p = at + step
        ok = p <= nn
        fail = ~pred(np.where(ok, p - 1, 0))
        at = np.where(ok & fail, p, at)
        step >>= 1
    return at


def _insert(b: np.ndarray, d: np.ndarray, on: np.ndarray) -> None:
    """b[s] = max(b[s-1], min(b[s], d)), s = W-1..1; b[0] = min(b[0], d),
    on the rows ``on`` (fmin/fmax drop a NaN operand, as fminf/fmaxf)."""
    new = b.copy()
    new[:, 1:] = np.fmax(b[:, :-1], np.fmin(b[:, 1:], d[:, None]))
    new[:, 0] = np.fmin(b[:, 0], d)
    b[on] = new[on]


def _max_nan(a, b):
    return np.where(np.isnan(a) | np.isnan(b), F32(np.nan), np.maximum(a, b))


def _width(kb: int) -> int:
    """The joint buffer's width (kb rounded up as the kernel instantiates
    it)."""
    return 3 if kb <= 3 else 8 if kb <= 8 else 16


# ---------------------------------------------------------------------------
# The staged routes
# ---------------------------------------------------------------------------

def _joint_rows(xs, ys, kb):
    """Joint selection of every sorted row: outward from s, right then
    left, while |dx| < the W-th smallest."""
    n = xs.size
    s = np.arange(n)
    b = np.full((n, _width(kb)), INF, F32)
    for step in (1, -1):
        j = s + step
        act = (j >= 0) & (j < n)
        while act.any():
            jj = np.clip(j, 0, n - 1)
            dx = np.abs(xs - xs[jj])
            go = act & (dx < b[:, -1])
            _insert(b, _max_nan(dx, np.abs(ys - ys[jj])), go)
            j = j + step
            act = go & (j >= 0) & (j < n)
    return b[:, :kb], np.zeros(n, np.int64)


def _class_distance(yi, yj):
    d = np.abs(yi - yj)
    return np.where(np.isnan(d), INF, d)


def _class_rows(key, ys, kb):
    """Class selection of every sorted row: the run of its code by binary
    search, then kb steps of the two-pointer merge outward from s, each
    reading the next distance of either side and taking the smaller."""
    n = key.size
    s = np.arange(n)
    code = key >> np.uint64(32)
    nan_code = code == np.uint64(0xFFFFFFFF)
    code = np.where(nan_code, np.uint64(0), code)  # no search for them
    lo = _search(lambda m: key[m] >= (code << np.uint64(32)), 0, s)
    hi = _search(lambda m: key[m] >= ((code + np.uint64(1)) << np.uint64(32)),
                 s + 1, n)
    lo, hi = np.where(nan_code, s, lo), np.where(nan_code, s + 1, hi)
    l, r = s - 1, s + 1

    def side(q, ok):
        return np.where(ok, _class_distance(ys, ys[np.clip(q, 0, n - 1)]), INF)

    out = np.empty((n, kb), F32)
    for t in range(kb):
        dl, dr = side(l, l >= lo), side(r, r < hi)
        left = dl <= dr
        out[:, t] = np.where(left, dl, dr)
        l, r = np.where(left, l - 1, l), np.where(left, r, r + 1)
    return out, hi - lo - 1


def _emulate_knn_sample(x, y, m, kb, mode):
    P = x.size
    knn = np.full((P, kb), INF, F32)
    cnt = np.zeros(P, np.int32)
    cols = np.flatnonzero(m)  # staging: the valid columns, in order
    n = cols.size
    if n == 0:
        return knn, cnt
    key = _bitonic(_pair_key(x[cols], y[cols]))
    xs = _key_value(key >> np.uint64(32))
    ys = _key_value(key & np.uint64(0xFFFFFFFF))
    out, c = (_joint_rows(xs, ys, kb) if mode == "joint"
              else _class_rows(key, ys, kb))
    # Each column takes the first sorted position of its own key.
    mine = _pair_key(x[cols], y[cols])
    q = _search_pow2(lambda mid: key[mid] >= mine, np.full(n, n))
    knn[cols] = out[q]
    cnt[cols] = c[q] if mode == "class" else 0
    return knn, cnt


def _padded_search(v, nn, pred, rows):
    """The kernel's branch-free search, ``rows`` of them in lockstep: the
    sorted values v[0, nn) padded with +inf to twice the next power of
    two, steps from the highest power of two <= nn down to 1, no bounds
    test, the result clamped to nn.  For a finite v_i the padding gives
    v_i - inf = -inf, which keeps the predicate monotone (or it holds
    nowhere)."""
    N = 32
    while N < nn:
        N *= 2
    w = np.concatenate([v[:nn], np.full(2 * N - nn, INF, F32)])
    at = np.zeros(rows, np.int64)
    step = 1 << (nn.bit_length() - 1) if nn > 0 else 0
    while step:
        p = at + step
        at = np.where(pred(w[p - 1]), at, p)
        step >>= 1
    return np.minimum(at, nn)


def _range_counts(v, nn, vi, r):
    """#|fl(vi - v_j)| < r and #fl(vi - v_j) == 0 over v[0, nn) but the
    row's own column, for finite vi (rows in lockstep)."""
    n = vi.size
    a = _padded_search(v, nn, lambda w: vi - w < r, n)
    b = _padded_search(v, nn, lambda w: vi - w <= -r, n)
    lt = np.maximum(b - a, 0) - (F32(0) < r)
    a0 = _padded_search(v, nn, lambda w: vi - w <= F32(0), n)
    b0 = _padded_search(v, nn, lambda w: vi - w < F32(0), n)
    return lt, b0 - a0 - 1, a0, b0


def _emulate_ball_sample(x, y, m, r, which):
    P = y.size
    counts = np.zeros((5, P), np.int32)
    cols = np.flatnonzero(m)
    n = cols.size
    if n == 0:
        return counts
    ky = _bitonic(_code_key(y[cols]))
    nny = int(_search(lambda mid: ky[mid] >= NAN_KEY, [0], [n])[0])
    sy = _key_value(ky)
    yi, ri = y[cols], r[cols]
    fy = np.abs(yi) < INF
    with np.errstate(invalid="ignore"):
        y_lt, y_eq, _, _ = _range_counts(sy, nny, np.where(fy, yi, 0), ri)
    counts[1, cols] = np.where(fy, y_lt, 0)
    if which == "y":
        return counts
    counts[3, cols] = np.where(fy, y_eq, 0)
    kxy = _bitonic(_pair_key(x[cols], y[cols]))
    nan_x = np.uint64(0xFFFFFFFF) << np.uint64(32)
    nnx = int(_search(lambda mid: kxy[mid] >= nan_x, [0], [n])[0])
    sx = _key_value(kxy >> np.uint64(32))
    xi = x[cols]
    fx = np.abs(xi) < INF
    x_lt, x_eq, a0, b0 = _range_counts(sx, nnx, np.where(fx, xi, 0), ri)
    counts[0, cols] = np.where(fx, x_lt, 0)
    counts[2, cols] = np.where(fx, x_eq, 0)
    k = _pair_key(np.where(fx, xi, 0), np.where(fy, yi, 0))
    j_eq = (_search(lambda mid: kxy[mid] >= k + np.uint64(1), a0, b0)
            - _search(lambda mid: kxy[mid] >= k, a0, b0) - 1)
    counts[4, cols] = np.where(fx & fy, j_eq, 0)
    return counts


def _emulate_knn(x, y, mask, kb, mode):
    with np.errstate(invalid="ignore"):  # inf - inf is NaN, as on the card
        parts = [_emulate_knn_sample(x[b], y[b], mask[b], kb, mode)
                 for b in range(len(x))]
    return np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts])


def _emulate_ball(x, y, mask, r, which):
    with np.errstate(invalid="ignore"):
        return np.stack([_emulate_ball_sample(x[b], y[b], mask[b], r[b], which)
                         for b in range(len(x))], axis=1)


# ---------------------------------------------------------------------------
# The yardsticks
# ---------------------------------------------------------------------------

def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _ref_knn(x, y, mask, kb, mode):
    knn, cnt = ref.knn_smallest(*_t(x, y, mask), kb=kb, mode=mode)
    return knn.numpy(), cnt.numpy()


def _ref_ball(x, y, mask, r, which):
    return ref.ball_counts(*_t(x, y, mask, r), which=which).numpy()


def _jax_knn(x, y, mask, kb, mode):
    out = [j_ops.knn_smallest(jnp.asarray(x[b]), jnp.asarray(y[b]),
                              jnp.asarray(mask[b]), k=kb, mode=mode,
                              use_kernel=False) for b in range(len(x))]
    return (np.stack([np.asarray(k) for k, _ in out]),
            np.stack([np.asarray(c) for _, c in out]))


def _jax_ball(x, y, mask, r, which):
    out = [j_ops.ball_counts(jnp.asarray(x[b]), jnp.asarray(y[b]),
                             jnp.asarray(mask[b]), jnp.asarray(r[b]),
                             which=which, use_kernel=False)
           for b in range(len(x))]
    return np.stack([np.stack([np.asarray(f) for f in c]) for c in out], axis=1)


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)  # NaN positions equal
        assert g.tobytes() == np.asarray(w, g.dtype).tobytes()


def _samples(P, mode, seed):
    """Three samples: tie-heavy values with a ragged mask, a sample with
    two valid rows (fewer neighbours than kb), and an all-invalid one."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, P)).astype(F32)
    x[:, : P // 3] = np.round(x[:, : P // 3])
    if mode == "class":
        x = rng.integers(0, 5, size=(3, P)).astype(F32)
        x[:, 0] = 99.0  # a singleton class
    y = np.round(rng.normal(size=(3, P)), 1).astype(F32)
    mask = rng.uniform(size=(3, P)) > 0.15
    mask[0, rng.integers(P // 2, P + 1):] = False  # ragged tail
    mask[1] = False
    mask[1, :2] = True
    mask[2] = False
    return x, y, mask


def _edge_samples(P, mode, kb, seed, finite):
    """``_samples`` plus the edge rows: -0.0 beside +0.0 (codes and
    values), duplicated points, a class with fewer than kb members and,
    unless ``finite``, +-inf y clusters whose ties sit on both sides of
    each of their rows in the sort, +-inf and NaN x, NaN y and a NaN
    class code."""
    x, y, mask = _samples(P, mode, seed)
    rng = np.random.default_rng(seed + 1)
    mask[0] |= rng.uniform(size=P) > 0.5
    q = max(1, P // 8)
    x[0, 1:1 + q] = -0.0
    x[0, 1 + q:1 + 2 * q] = 0.0
    y[0, 1:1 + 2 * q:2] = -0.0
    d = P // 2
    x[0, d:d + max(2, P // 16)] = x[0, d]  # duplicated points
    y[0, d:d + max(2, P // 16)] = y[0, d]
    if mode == "class" and P > 4:
        x[0, P - 3:P - 1] = 77.0  # fewer members than kb
    if not finite:
        for v, pick in ((F32(np.inf), 0), (F32(-np.inf), 1)):
            hit = np.flatnonzero(rng.uniform(size=P) < 0.04)
            y[0, hit] = v  # a tie cluster, across classes and x values
            if mode == "class" and hit.size:
                x[0, hit[: hit.size // 2 + 1]] = F32(pick)
        hit = rng.uniform(size=P)
        y[0, hit < 0.02] = np.nan
        if mode == "joint":
            x[0, (hit >= 0.02) & (hit < 0.04)] = np.inf
            x[0, (hit >= 0.04) & (hit < 0.05)] = -np.inf
            x[0, (hit >= 0.05) & (hit < 0.06)] = np.nan
        else:
            x[0, P - 1] = np.nan
    return x, y, mask


TWO_OP_P = (1, 2, 31, 255, 256, 257, 512, 1024)


@pytest.mark.parametrize("mode", ["joint", "class"])
@pytest.mark.parametrize("kb", [1, 3, 8, 16])
@pytest.mark.parametrize("P", TWO_OP_P)
def test_knn_design_matches_ref_and_jax(P, kb, mode):
    x, y, mask = _samples(P, mode, seed=P * 10 + kb)
    got = _emulate_knn(x, y, mask, kb, mode)
    _same(got, _ref_knn(x, y, mask, kb, mode))
    _same(got, _jax_knn(x, y, mask, kb, mode))
    assert np.isinf(got[0][2]).all() and not got[1][2].any()


def _radius(kind, x, y, mask):
    if kind == "zero":
        return np.zeros(x.shape, F32)
    if kind == "inf":
        return np.full(x.shape, INF, F32)
    if kind == "nan":
        return np.full(x.shape, np.nan, F32)
    # an existing distance: each row's 3rd-nearest joint distance
    return np.ascontiguousarray(_ref_knn(x, y, mask, 3, "joint")[0][..., 2])


RADII = ["zero", "inf", "nan", "distance"]


@pytest.mark.parametrize("kind", RADII)
@pytest.mark.parametrize("which", ["all", "y"])
@pytest.mark.parametrize("P", TWO_OP_P)
def test_ball_design_matches_ref_and_jax(P, which, kind):
    x, y, mask = _samples(P, "joint", seed=P + 7)
    r = _radius(kind, x, y, mask)
    got = _emulate_ball(x, y, mask, r, which)
    _same([got], [_ref_ball(x, y, mask, r, which)])
    _same([got], [_jax_ball(x, y, mask, r, which)])
    if kind == "inf":  # every finite valid neighbour lies inside
        n = mask.sum(-1, keepdims=True) - 1
        np.testing.assert_array_equal(got[1], np.where(mask, n, 0))


EDGE_P = (40, 256, 257, 1024)


@pytest.mark.parametrize("finite", [True, False], ids=["finite", "nonfinite"])
@pytest.mark.parametrize("mode,kb", [("joint", 3), ("joint", 16),
                                     ("class", 3), ("class", 8)])
@pytest.mark.parametrize("P", EDGE_P)
def test_knn_design_edge_rows(P, mode, kb, finite):
    """-0.0/+0.0, duplicated points and a class with fewer than kb
    members (finite: held against ref and JAX); plus +-inf y tie clusters
    on both sides of their rows, non-finite x and NaN codes (non-finite:
    against ref, whose NaN rule the kernel shares)."""
    x, y, mask = _edge_samples(P, mode, kb, seed=3 * P + kb, finite=finite)
    got = _emulate_knn(x, y, mask, kb, mode)
    _same(got, _ref_knn(x, y, mask, kb, mode))
    if finite:
        _same(got, _jax_knn(x, y, mask, kb, mode))


@pytest.mark.parametrize("finite", [True, False], ids=["finite", "nonfinite"])
@pytest.mark.parametrize("kind", RADII)
@pytest.mark.parametrize("which", ["all", "y"])
@pytest.mark.parametrize("P", (40, 257))
def test_ball_design_edge_rows(P, which, kind, finite):
    x, y, mask = _edge_samples(P, "joint", 3, seed=5 * P, finite=finite)
    r = _radius(kind, x, y, mask)
    got = _emulate_ball(x, y, mask, r, which)
    _same([got], [_ref_ball(x, y, mask, r, which)])
    if finite:
        _same([got], [_jax_ball(x, y, mask, r, which)])


def test_inf_tie_cluster_on_both_sides():
    """One class worked by hand: rows whose y is +inf (or -inf) tie with
    others that the sort puts on both sides of them, so either side of
    the merge meets NaN distances (inf - inf) first and only +inf past
    them: every such row selects +inf only, as ref does, and the finite
    rows select the finite distances first."""
    y = np.array([1.0, np.inf, 2.0, np.inf, np.inf, -np.inf, 4.0, -np.inf,
                  np.nan], F32)
    x = np.zeros_like(y)
    m = np.ones((1, y.size), bool)
    knn, cnt = _emulate_knn(x[None], y[None], m, 4, "class")
    np.testing.assert_array_equal(cnt[0], np.full(y.size, y.size - 1))
    for i in np.flatnonzero(~np.isfinite(y)):
        assert np.isinf(knn[0, i]).all()
    np.testing.assert_array_equal(knn[0, 0], [1.0, 3.0, INF, INF])
    _same((knn, cnt), _ref_knn(x[None], y[None], m, 4, "class"))


def test_merge_sides_never_decrease():
    """Along either side of every row of a sorted class run, |fl(y_i -
    y_j)| with NaN as +inf does not decrease: the merge's premise, on
    values with ties, signed zeros and +-inf clusters."""
    rng = np.random.default_rng(1)
    vals = np.array([-np.inf, -1.5, -0.0, 0.0, 0.25, 1e-40, 3.0, np.inf,
                     np.nan], F32)
    with np.errstate(invalid="ignore"):
        for _ in range(50):
            ys = _key_value(np.sort(_code_key(rng.choice(vals, size=24))))
            for s in range(ys.size):
                d = _class_distance(ys[s], ys)
                right, left = d[s + 1:], d[:s][::-1]
                assert (right[1:] >= right[:-1]).all()
                assert (left[1:] >= left[:-1]).all()


def test_bitonic_network_sorts_with_padding():
    rng = np.random.default_rng(2)
    for n in (1, 2, 31, 33, 256, 257, 1000):
        keys = rng.integers(0, 8, size=n).astype(np.uint64)
        keys[rng.uniform(size=n) < 0.1] = np.iinfo(np.uint64).max
        np.testing.assert_array_equal(_bitonic(keys.copy()), np.sort(keys))


def test_key_value_inverts_code_key():
    v = np.array([-np.inf, -2.5, -1e-45, -0.0, 0.0, 1e-45, 7.0, np.inf,
                  np.nan], F32)
    back = _key_value(_code_key(v))
    np.testing.assert_array_equal(back[:3], v[:3])
    assert back[3].tobytes() == F32(0).tobytes()  # -0.0 comes back as +0.0
    np.testing.assert_array_equal(back[4:], v[4:])


@pytest.mark.parametrize("P,kb,staged", [
    (256, 3, True), (512, 3, True), (1024, 16, True), (1, 1, True),
    (1025, 3, False), (256, 17, False), (256, 128, False), (2048, 1, False),
])
def test_two_op_body_rule(P, kb, staged):
    assert kernel.takes_staged_two_op(P, kb) is staged
    assert kernel.takes_staged_two_op(P) is (P <= 1024)  # ball_counts
    assert kernel.TWO_OP_STAGED_MAX_P == 1024
    assert kernel.TWO_OP_STAGED_MAX_KB == 16


# ---------------------------------------------------------------------------
# The tiled bodies (P > 1024, or kb > 16 for knn_smallest)
# ---------------------------------------------------------------------------

def _tiled_knn_sample(x, y, m, kb, mode):
    P = x.size
    knn = np.full((P, kb), INF, F32)
    cnt = np.zeros(P, np.int32)
    W = _band_width(kb) if mode == "joint" else 0
    # The joint band walk's warp kernel sorts by (code_key(x), column) alone.
    X, Y, nnx, nny, rows, s, q = _sample_orders(x, y, m, by_column=P <= WARP_P and W)
    if rows.size == 0:
        return knn, cnt
    xi, yi = X[s, 0], X[s, 1]
    fy = np.abs(yi) < INF
    out = np.full((rows.size, kb), INF, F32)
    c = np.zeros(rows.size, np.int64)
    if mode == "joint":
        ok = (np.abs(xi) < INF) & fy  # a non-finite row selects +inf only
        if ok.any() and W:
            out[ok] = _band_walk(X[:, 0], X[:, 1], nnx, s[ok], xi[ok], yi[ok],
                                 W, runs=P > WARP_P)[:, :kb]
        elif ok.any():
            out[ok] = _event_walk(X, Y, nnx, nny, s[ok], q[ok], xi[ok], yi[ok], kb)
    else:
        run, end, c = _class_runs(X, nnx, s, xi)
        sel = ~np.isnan(xi) & fy
        if sel.any():
            out[sel] = _class_walk(X[:, 1], run[sel], end[sel], s[sel], yi[sel], kb)
    knn[rows] = out
    cnt[rows] = c
    return knn, cnt


def _tiled_ball_sample(x, y, m, r, which):
    """The y variant builds the y order only and never reads x (zeros
    here, so that nothing can depend on it).  The orders come from the
    sort launches at every P (one chunk up to TILED_CHUNK columns)."""
    counts = np.zeros((5, y.size), np.int32)
    if which == "y":
        x = np.zeros_like(y)
    X, Y, nnx, nny, rows, _, _ = _sample_orders(x, y, m, chunks=True)
    if rows.size:
        counts[:, rows] = _row_counts(X, Y, nnx, nny, x[rows], y[rows], r[rows],
                                      which)
    return counts


def _tiled_emulate_knn(x, y, mask, kb, mode):
    with np.errstate(invalid="ignore"):
        parts = [_tiled_knn_sample(x[b], y[b], mask[b], kb, mode)
                 for b in range(len(x))]
    return np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts])


def _tiled_emulate_ball(x, y, mask, r, which):
    with np.errstate(invalid="ignore"):
        return np.stack([_tiled_ball_sample(x[b], y[b], mask[b], r[b], which)
                         for b in range(len(x))], axis=1)


TILED_P = (257, 1025, 2048)
TILED_KB = (17, 32, 64, 65, 128)
# One JAX compile per (P, kb, mode) costs ~0.5-2 s: JAX holds P = 1025
# (past one sort chunk) at a band buffer of 32 lanes and at K_MAX (the
# walk; the edge rows add kb = 65); ref holds every case.
JAX_KNN = {(1025, 17), (1025, 128)}


@pytest.mark.parametrize("mode", ["joint", "class"])
@pytest.mark.parametrize("kb", TILED_KB)
@pytest.mark.parametrize("P", TILED_P)
def test_tiled_knn_design_matches_ref_and_jax(P, kb, mode):
    """The tiled route, emulated: the band buffer (kb <= 64, batches of
    W / 2) or the four-stream walk (kb > 64), the class merge for any kb,
    on tie-heavy ragged samples, one with fewer valid columns than kb and
    an all-invalid one."""
    x, y, mask = _samples(P, mode, seed=P * 10 + kb)
    got = _tiled_emulate_knn(x, y, mask, kb, mode)
    _same(got, _ref_knn(x, y, mask, kb, mode))
    if (P, kb) in JAX_KNN:
        _same(got, _jax_knn(x, y, mask, kb, mode))
    assert np.isinf(got[0][2]).all() and not got[1][2].any()


@pytest.mark.parametrize("P,kb,mode", [(256, 17, "joint"), (256, 128, "class"),
                                       (1025, 3, "joint"), (2048, 8, "class"),
                                       (1280, 3, "joint"), (2048, 1, "joint")])
def test_tiled_knn_design_outside_the_rule(P, kb, mode):
    """The tiled body takes every shape through its entry: one warp a
    sample at P = 256 (the x order keyed by the y position), and the
    narrow buffers past P = 1024 (phase 12 (b)'s padded samples)."""
    x, y, mask = _samples(P, mode, seed=P + kb)
    _same(_tiled_emulate_knn(x, y, mask, kb, mode), _ref_knn(x, y, mask, kb, mode))


@pytest.mark.parametrize("kind", RADII)
@pytest.mark.parametrize("which", ["all", "y"])
@pytest.mark.parametrize("P", TILED_P + (256,))
def test_tiled_ball_design_matches_ref_and_jax(P, which, kind):
    """Every count a binary-searched range at the caller's radius (zero,
    +inf, NaN, an existing distance); JAX at P = 1025, a distance and all
    five counts."""
    x, y, mask = _samples(P, "joint", seed=P + 11)
    r = _radius(kind, x, y, mask)
    got = _tiled_emulate_ball(x, y, mask, r, which)
    _same([got], [_ref_ball(x, y, mask, r, which)])
    if (P, which, kind) == (1025, "all", "distance"):
        _same([got], [_jax_ball(x, y, mask, r, which)])


@pytest.mark.parametrize("finite", [True, False], ids=["finite", "nonfinite"])
@pytest.mark.parametrize("P,mode,kb", [(257, "joint", 17), (1025, "joint", 65),
                                       (1025, "class", 32), (257, "class", 128),
                                       (2048, "joint", 32), (256, "joint", 65)])
def test_tiled_knn_design_edge_rows(P, mode, kb, finite):
    """``_edge_samples``' rows (-0.0 beside +0.0, duplicated points, a
    class with fewer than kb members; with ``finite=False`` +-inf y tie
    clusters, non-finite x and NaN codes) through the emulated tiled
    route: against ref, and the finite P = 1025 walk against JAX."""
    x, y, mask = _edge_samples(P, mode, kb, seed=11 * P + kb, finite=finite)
    got = _tiled_emulate_knn(x, y, mask, kb, mode)
    _same(got, _ref_knn(x, y, mask, kb, mode))
    if finite and (P, mode) == (1025, "joint"):
        _same(got, _jax_knn(x, y, mask, kb, mode))


@pytest.mark.parametrize("finite", [True, False], ids=["finite", "nonfinite"])
@pytest.mark.parametrize("kind", RADII)
@pytest.mark.parametrize("which", ["all", "y"])
@pytest.mark.parametrize("P", [40, 1025])
def test_tiled_ball_design_edge_rows(P, which, kind, finite):
    """The edge rows (-0.0 beside +0.0, duplicates, +-inf and NaN) through
    the chunked orders: one chunk at P = 40, two merged by rank at 1025."""
    x, y, mask = _edge_samples(P, "joint", 3, seed=17 + P, finite=finite)
    r = _radius(kind, x, y, mask)
    got = _tiled_emulate_ball(x, y, mask, r, which)
    _same([got], [_ref_ball(x, y, mask, r, which)])


def test_tiled_event_walk_completes_in_order():
    """The four-stream walk's completions are each row's joint distances
    (NaN ones never), ascending: on a sample with ties, +-inf and NaN
    coordinates, its first 40 lanes are the 40 smallest, +inf beyond."""
    rng = np.random.default_rng(8)
    P = 300
    x = np.round(rng.normal(size=P), 1).astype(F32)
    y = np.round(rng.normal(size=P), 1).astype(F32)
    x[:5], y[5:10] = np.inf, -np.inf
    x[10:13], y[13:16] = np.nan, np.nan
    X, Y, nnx, nny, rows, s, q = _sample_orders(x, y, np.ones(P, bool))
    ok = np.isfinite(X[s, 0]) & np.isfinite(X[s, 1])
    with np.errstate(invalid="ignore"):
        got = _event_walk(X, Y, nnx, nny, s[ok], q[ok], X[s[ok], 0],
                          X[s[ok], 1], 40)
        d = np.maximum(np.abs(x[rows[ok], None] - x[None, :]),
                       np.abs(y[rows[ok], None] - y[None, :]))
    d[np.arange(ok.sum()), rows[ok]] = np.nan  # not the row itself
    want = np.sort(np.where(np.isnan(d), INF, d), axis=1)[:, :40]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kb", [1, 3, 17, 32, 33, 65, 128])
@pytest.mark.parametrize("rows", [1, 17, 32])
def test_tiled_output_run_leaves_in_order(kb, rows):
    """``knn_smallest_rows``' copy of a warp's tile (32 rows of kb lanes
    at stride kb | 1) to its contiguous run of the output: element e =
    lane + 32 i is lane u of row r, stepped by (32 // kb, 32 % kb)
    without a division, every element written once."""
    stride = kb | 1
    tile = np.arange(32 * stride, dtype=np.int64)
    out = np.full(rows * kb, -1, np.int64)
    dr, du = 32 // kb, 32 - (32 // kb) * kb
    for lane in range(32):
        r, u = lane // kb, lane - (lane // kb) * kb
        for e in range(lane, rows * kb, 32):
            assert out[e] == -1
            out[e] = tile[r * stride + u]
            r, u = r + dr, u + du
            if u >= kb:
                u, r = u - kb, r + 1
    want = np.concatenate([tile[i * stride:i * stride + kb] for i in range(rows)])
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("W", [4, 8, 16, 32, 64])
def test_tiled_band_walk_takes_any_order_of_x_ties(W):
    """The band walk over the x order by (code_key(x), column), as the
    warp kernel sorts it for the joint walk alone, leaves every row the
    same buffer as over the order by (code_key(x), code_key(y), column):
    on x values with many ties and y in every order among them."""
    rng = np.random.default_rng(W)
    P = 256
    x = rng.integers(-4, 5, P).astype(F32)
    y = np.round(rng.normal(size=P), 1).astype(F32)
    m = rng.uniform(size=P) > 0.1
    bufs = []
    for by_column in (False, True):
        X, _, nnx, _, rows, s, _ = _sample_orders(x, y, m, by_column)
        got = _band_walk(X[:, 0], X[:, 1], nnx, s, X[s, 0], X[s, 1], W,
                         runs=not by_column)
        bufs.append(got[np.argsort(rows)])
    assert not np.array_equal(*(_sample_orders(x, y, m, b)[0] for b in (False, True)))
    np.testing.assert_array_equal(*bufs)


@pytest.mark.parametrize("W", [4, 8, 16, 32, 64])
def test_tiled_band_walk_leaves_a_spent_tie_run(W):
    """Leaving the row's own x-tie run once its |dy| reaches b[W-1] (the
    ties sorted by y) gives every row the buffer of the walk that visits
    the whole run: x with long tie runs, y with ties, +-inf and NaN."""
    rng = np.random.default_rng(10 + W)
    P = 1500
    x = rng.integers(-3, 4, P).astype(F32)
    x[: P // 3] = rng.normal(size=P // 3).astype(F32)
    y = np.round(rng.normal(size=P), 1).astype(F32)
    y[rng.uniform(size=P) < 0.02] = np.inf
    y[rng.uniform(size=P) < 0.02] = -np.inf
    y[rng.uniform(size=P) < 0.02] = np.nan
    m = rng.uniform(size=P) > 0.1
    X, _, nnx, _, rows, s, _ = _sample_orders(x, y, m)
    ok = np.isfinite(X[s, 0]) & np.isfinite(X[s, 1])
    with np.errstate(invalid="ignore"):
        args = (X[:, 0], X[:, 1], nnx, s[ok], X[s[ok], 0], X[s[ok], 1], W)
        np.testing.assert_array_equal(_band_walk(*args, runs=True),
                                      _band_walk(*args, runs=False))
    # and the runs are long enough to be left
    assert np.bincount((x[m] + 3).clip(0).astype(np.int64)).max() > 100


def test_tiled_chunk_sort_over_the_valid_span():
    """A chunk's bitonic network over the least power of two of slots
    that holds its last valid column sorts its valid (key, column) pairs
    (the slots past the span hold padding only); a chunk with no valid
    column sorts nothing."""
    rng = np.random.default_rng(3)
    for last in (0, 1, 31, 255, 256, 700, 1023):
        key = rng.integers(0, 5, TILED_CHUNK).astype(np.uint64)
        m = np.zeros(TILED_CHUNK, bool)
        m[:last + 1] = rng.uniform(size=last + 1) > 0.3
        m[last] = True
        want = sorted((int(key[j]), int(j)) for j in np.flatnonzero(m))
        assert _chunk_sort(key, m, 0) == want
    assert _chunk_sort(key, np.zeros(TILED_CHUNK, bool), 0) == []


def test_tiled_orders_take_the_chunked_route():
    """The shapes above reach both order routes (one warp a sample up to
    256 columns, chunks merged by rank beyond one chunk)."""
    assert WARP_P < 257 <= TILED_CHUNK < 1025 < 2048
    assert all(not kernel.takes_staged_two_op(P, kb)
               for P in TILED_P for kb in TILED_KB)
    assert not kernel.takes_staged_two_op(1025)  # ball_counts


def test_an_edit_to_the_shared_header_rebuilds_both_libraries(tmp_path):
    """Both sources include ``sorted_orders.cuh``, and a build's tag
    covers the source and every local header it includes (recursively),
    so an edit to the header alone gives both libraries a new tag."""
    for src in (kernel.SOURCE, kernel.TWO_OP_SOURCE):
        assert kernel.SORTED_ORDERS in local_includes(src)
    (tmp_path / "inner.cuh").write_text("// inner\n")
    (tmp_path / "orders.cuh").write_text('#include "inner.cuh"\n')
    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    a.write_text('#include <math.h>\n#include "orders.cuh"\nint a;\n')
    b.write_text('  #  include "orders.cuh"\nint b;\n')
    before = build_tag(a), build_tag(b)
    assert [p.name for p in local_includes(a)] == ["a.cu", "orders.cuh",
                                                   "inner.cuh"]
    (tmp_path / "inner.cuh").write_text("// edited\n")
    after = build_tag(a), build_tag(b)
    assert before[0] != after[0] and before[1] != after[1]
    plain = tmp_path / "plain.cu"
    plain.write_text("int c;\n")
    import hashlib
    assert build_tag(plain) == hashlib.sha1(b"int c;\n").hexdigest()[:12]

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
``knn_smallest`` / ``ball_counts``.  The kernels themselves are held
against ``ref`` on the card (``test_torch_knn_two_op.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.knn_stats import ops as j_ops
from repro_torch.kernels.knn_stats import kernel, ref

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

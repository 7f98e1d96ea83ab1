"""The staged ``radius_counts`` body's exactness argument, on the CPU.

``csrc/radius_counts.cu``'s staged body computes ``ref.radius_counts``
by another route:

* it compacts each sample's valid columns, so invalid ones are never
  visited, and sorts them by x (the class code in class mode) by value:
  -0.0 and +0.0 are one key, NaN sorts last;
* joint mode selects outward from the row's own sorted position and
  stops a side at the first |dx| >= the current W-th smallest distance
  (along a side |fl(x_i - x_j)| does not decrease, and d >= |dx|); class
  mode selects from the row's run of equal codes (a NaN code is a run of
  none); both update the buffer with a branch-free min/max network that
  drops NaN;
* the y counts sweep every column, the row's own too, and take its
  contribution out; the x counts (|dx| < r, dx == 0) are ranges of the
  sorted order found by binary search on fl(x_i - x_j), which does not
  increase along it, and j_eq walks the dx == 0 range.

``_emulate`` repeats that route step by step in numpy float32 and is held
bit-equal to ``ref.radius_counts`` and to the JAX package's
``knn_radius_counts``.  The kernel itself is held against ``ref`` on the
card (``test_torch_knn_stats.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_sorted_route import (F32, INF, TILED_CHUNK, WARP_P, _band_width,
                                 _band_radius, _bitonic_clean, _class_radius,
                                 _class_runs, _code_key, _event_radius,
                                 _insert, _row_counts, _sample_orders,
                                 _sort_network, _tiled_orders)
from repro.kernels.knn_stats import ops as j_ops
from repro_torch.kernels.knn_stats import kernel, ref
from test_torch_knn_stats import CASES, _edge_samples, _samples
from _torch_threads import one_thread  # noqa: F401 (autouse)


def _width(need: int) -> int:
    """The staged body's buffer width (need rounded up as the kernel
    instantiates it); beyond its range, exactly need."""
    for w in (3, 8, 16):
        if need <= w:
            return w
    return need


def _max_nan(a, b):
    return F32(np.nan) if np.isnan(a) or np.isnan(b) else max(a, b)


def _first(nn, pred):
    """The first j in [0, nn) where the monotone ``pred`` holds (binary
    search, as first_lt / first_le)."""
    lo, hi = 0, nn
    while lo < hi:
        mid = (lo + hi) // 2
        if pred(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo


def _emulate_sample(x, y, m, *, k, kb, kk, mode, which):
    P = x.shape[0]
    r_out = np.full(P, INF, F32)
    cnt_out = np.zeros(P, np.int32)
    counts = np.zeros((5, P), np.int32)
    cols = np.flatnonzero(m)  # staging: the valid columns, in order
    n = cols.size
    if n == 0:
        return r_out, cnt_out, counts
    keys = (_code_key(x[cols]).astype(np.uint64) << np.uint64(32)) \
        | np.arange(n, dtype=np.uint64)
    keys.sort()
    order = (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
    xs, ys, out = x[cols][order], y[cols][order], cols[order]
    nn = int((~np.isnan(xs)).sum())  # NaN x sorts last
    h = keys >> np.uint64(32)
    start = np.ones(n, bool)
    start[1:] = (h[1:] != h[:-1]) | (h[1:] == 0xFFFFFFFF)
    W = _width(k if mode == "joint" else kb)
    for s in range(n):
        xi, yi = xs[s], ys[s]
        b = np.full(W, INF, F32)
        if mode == "joint":
            for side in (range(s + 1, n), range(s - 1, -1, -1)):
                for j in side:
                    dx = abs(xi - xs[j])
                    if not dx < b[-1]:
                        break
                    _insert(b, _max_nan(dx, abs(yi - ys[j])))
            c, t = 0, k - 1
        else:
            lo = hi = s
            if xi == xi:  # the run of equal codes around s
                lo = s
                while not start[lo]:
                    lo -= 1
                hi = s + 1
                while hi < n and not start[hi]:
                    hi += 1
            for j in list(range(lo, s)) + list(range(s + 1, hi)):
                _insert(b, abs(yi - ys[j]))
            c = hi - lo - 1 if hi > lo else 0
            t = max(min(min(kk, c) - 1, kb - 1), 0)
        r = b[t]
        dy = np.abs(yi - ys)  # every column, the self pair taken out
        dys = abs(yi - yi)
        y_lt = int((dy < r).sum()) - int(dys < r)
        x_lt = x_eq = y_eq = j_eq = 0
        if which == "all":
            y_eq = int((dy <= 0).sum()) - int(dys <= 0)
            if np.isfinite(xi):
                def f(j):
                    return xi - xs[j]
                a = _first(nn, lambda j: f(j) < r)
                bb = _first(nn, lambda j: f(j) <= -r)
                a0 = _first(nn, lambda j: f(j) <= 0)
                b0 = _first(nn, lambda j: f(j) < 0)
                x_lt = max(bb - a, 0) - int(F32(0) < r)
                x_eq = b0 - a0 - 1
                j_eq = int((dy[a0:b0] <= 0).sum()) - int(dys <= 0)
        r_out[out[s]] = r
        cnt_out[out[s]] = c
        counts[:, out[s]] = (x_lt, y_lt, x_eq, y_eq, j_eq)
    return r_out, cnt_out, counts


def _emulate(x, y, mask, **kw):
    with np.errstate(invalid="ignore"):  # inf - inf is NaN, as on the card
        parts = [_emulate_sample(x[b], y[b], mask[b], **kw) for b in range(len(x))]
    return tuple(np.stack(p, axis=-2 if i == 2 else 0)
                 for i, p in enumerate(zip(*parts)))


def _ref(x, y, mask, **kw):
    got = ref.radius_counts(torch.from_numpy(x), torch.from_numpy(y),
                            torch.from_numpy(mask), **kw)
    return tuple(t.numpy() for t in got)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)  # NaN positions equal


def _jax(x, y, mask, *, k, kb, kk, mode, which):
    out = []
    for b in range(len(x)):
        r, c, cs = j_ops.knn_radius_counts(
            jnp.asarray(x[b]), jnp.asarray(y[b]), jnp.asarray(mask[b]), k=k,
            k_max=kb, kk=kk, mode=mode, which=which, use_kernel=False)
        out.append((np.asarray(r), np.asarray(c), np.stack([np.asarray(f) for f in cs])))
    return tuple(np.stack(p, axis=-2 if i == 2 else 0)
                 for i, p in enumerate(zip(*out)))


def _params(k, k_max, kk):
    kb = k if k_max is None else k_max
    return kb, (k if kk is None else kk)


@pytest.mark.parametrize("P,mode,which,k,k_max,kk", CASES)
def test_design_matches_ref_and_jax(P, mode, which, k, k_max, kk):
    x, y, mask = _samples(P, mode, seed=P * 1000 + k)
    kb, kkv = _params(k, k_max, kk)
    kw = dict(k=k, kb=kb, kk=kkv, mode=mode, which=which)
    got = _emulate(x, y, mask, **kw)
    _assert_same(got, _ref(x, y, mask, **kw))
    _assert_same(got, _jax(x, y, mask, **kw))


EDGE_CASES = [
    # P, mode, which, k, kb, kk
    (P, mode, which, k, kb, kk)
    for P in (40, 256, 512)
    for mode, which, k, kb, kk in (
        ("joint", "all", 3, 3, 3), ("joint", "y", 1, 1, 1),
        ("joint", "all", 7, 7, 7), ("class", "y", 3, 3, 3),
        ("class", "all", 3, 8, 6),
    )
]


@pytest.mark.parametrize("finite", [True, False], ids=["finite", "nonfinite"])
@pytest.mark.parametrize("P,mode,which,k,kb,kk", EDGE_CASES)
def test_design_edge_rows(P, mode, which, k, kb, kk, finite):
    """Duplicated points, -0.0 beside +0.0 codes, a singleton class and
    rows with exactly k neighbours (finite: held against ref and JAX);
    plus NaN and +-inf x or y in valid rows and a NaN class code
    (non-finite: held against ref, whose NaN rule the kernel shares)."""
    x, y, mask = _edge_samples(P, mode, k, seed=7 * P + k, finite=finite)
    kw = dict(k=k, kb=kb, kk=kk, mode=mode, which=which)
    got = _emulate(x, y, mask, **kw)
    _assert_same(got, _ref(x, y, mask, **kw))
    if finite:
        _assert_same(got, _jax(x, y, mask, **kw))


def test_self_lane_and_classes_by_value():
    """One sample worked by hand: -0.0 and +0.0 codes form one class, a
    NaN code none, a NaN y is never selected but its row is still counted,
    and the row's own column is neither selected nor counted."""
    x = np.array([-0.0, 0.0, 0.0, np.nan, 5.0, 5.0], np.float32)
    y = np.array([0.0, 1.0, 3.0, 0.0, 2.0, np.nan], np.float32)
    m = np.ones((1, 6), bool)
    kw = dict(k=1, kb=1, kk=1, mode="class", which="y")
    r, cnt, c = _emulate(x[None], y[None], m, **kw)
    np.testing.assert_array_equal(cnt[0], [2, 2, 2, 0, 1, 1])
    np.testing.assert_array_equal(r[0], [1, 1, 2, INF, INF, INF])
    _assert_same((r, cnt, c), _ref(x[None], y[None], m, **kw))


def test_network_drops_nan():
    """The branch-free insertion keeps the W smallest, and a NaN leaves
    the buffer as it was."""
    rng = np.random.default_rng(0)
    vals = np.round(rng.normal(size=(64, 40)), 1).astype(F32)
    vals[rng.uniform(size=vals.shape) < 0.2] = np.nan
    for row in vals:
        buf = np.full(4, INF, F32)
        for d in row:
            before = buf.copy()
            _insert(buf, d)
            if np.isnan(d):
                np.testing.assert_array_equal(buf, before)
        want = np.sort(np.where(np.isnan(row), INF, row))[:4]
        np.testing.assert_array_equal(buf, want)


@pytest.mark.parametrize("P,mode,k,kb,staged", [
    (256, "joint", 3, 3, True),
    (40, "class", 3, 3, True),
    (1024, "joint", 16, 16, True),
    (1024, "class", 3, 16, True),
    (1025, "joint", 3, 3, False),
    (2048, "class", 3, 3, False),
    (256, "joint", 17, 17, False),
    (256, "joint", 3, 128, True),  # joint mode's buffer holds k
    (256, "class", 3, 17, False),  # class mode's holds kb
    (256, "class", 3, 128, False),
])
def test_body_rule(P, mode, k, kb, staged):
    assert kernel.takes_staged(P, mode, k, kb) is staged
    assert kernel.STAGED_MAX_P == 1024 and kernel.STAGED_MAX_W == 16


def test_every_case_has_a_body():
    """The synthetic cases reach both bodies (the card-side test runs
    them all)."""
    bodies = {kernel.takes_staged(P, mode, k, _params(k, k_max, kk)[0])
              for P, mode, _, k, k_max, kk in CASES}
    assert bodies == {True, False}


# ---------------------------------------------------------------------------
# The tiled body (P > 1024, or a buffer wider than 16)
# ---------------------------------------------------------------------------
#
# ``csrc/radius_counts.cu``'s tiled body sorts each sample's valid columns
# twice: by (code_key(y), column), and by (code_key(x), code_key(y),
# column).  A sample of at most 256 columns is sorted whole (the x order
# by (code_key(x), position in the y order), the same permutation); a
# longer one in chunks of ``kernel.TILED_CHUNK`` columns, each sorted by
# (key, column) pairs and merged by rank: an entry's place is its place
# in its chunk plus, in every other chunk, the number of pairs below it.
# Then one row at a time:
#
# * joint mode, k <= 64: the band |dx| < b[W-1] along the x order with a
#   W-lane buffer (W = 4, 8, 16, 32, 64 >= k); up to 8 lanes one
#   candidate at a time (the min/max network), wider buffers in batches
#   of G = min(W / 2, 32) from each side in turn, each batch sorted and
#   merged (min against the reversed batch, then a bitonic clean);
# * joint mode, k > 64: four streams outward from the row along both
#   orders; an entry completes at its larger distance, in increasing
#   joint distance, and the (k)-th completion is the radius;
# * class mode: the row's run of equal codes, sorted by y, merged from
#   both sides for t + 1 steps;
# * every count is a range of one order found by binary search (a NaN
#   sorts last and meets both predicates), j_eq within the x-tie range,
#   which is sorted by y.
#
# ``_torch_sorted_route`` holds the route's steps (``csrc/sorted_orders.cuh``,
# shared with the two-op tiled bodies); ``_tiled_emulate`` repeats it in
# numpy float32, vectorised over a sample's rows, and is held bit-equal to
# ``ref.radius_counts`` and to the JAX package's ``knn_radius_counts``.

def _tiled_sample(x, y, m, *, k, kb, kk, mode, which):
    P = len(x)
    r_out = np.full(P, INF, F32)
    cnt_out = np.zeros(P, np.int32)
    counts = np.zeros((5, P), np.int32)
    X, Y, nnx, nny, rows, s, q = _sample_orders(x, y, m)
    if len(rows) == 0:
        return r_out, cnt_out, counts
    xi, yi = X[s, 0], X[s, 1]
    fx, fy = np.abs(xi) < INF, np.abs(yi) < INF
    R = len(rows)
    r = np.full(R, INF, F32)
    cnt = np.zeros(R, np.int64)
    if mode == "joint":
        W = _band_width(k)
        ok = fx & fy
        if ok.any():
            t = np.full(int(ok.sum()), k - 1)
            args = (nnx, s[ok], xi[ok], yi[ok], t)
            r[ok] = (_band_radius(X[:, 0], X[:, 1], *args, W, P > WARP_P) if W else
                     _event_radius(X, Y, nnx, nny, s[ok], q[ok], xi[ok], yi[ok], t))
    else:
        run, end, cnt = _class_runs(X, nnx, s, xi)
        t = np.clip(np.minimum(kk, cnt) - 1, 0, kb - 1)
        sel = ~np.isnan(xi) & fy
        if sel.any():
            r[sel] = _class_radius(X[:, 1], run[sel], end[sel], s[sel], yi[sel], t[sel])
    r_out[rows] = r
    cnt_out[rows] = cnt
    counts[:, rows] = _row_counts(X, Y, nnx, nny, xi, yi, r, which)
    return r_out, cnt_out, counts


def _tiled_emulate(x, y, mask, **kw):
    with np.errstate(invalid="ignore"):
        parts = [_tiled_sample(x[b], y[b], mask[b], **kw) for b in range(len(x))]
    return tuple(np.stack(p, axis=-2 if i == 2 else 0)
                 for i, p in enumerate(zip(*parts)))


TILED_DESIGN_CASES = [
    # P, mode, which, k, kb (kk = kb)
    (P, mode, which, need if mode == "joint" else 3, need)
    for P in (1025, 2048)
    for need in (17, 32, 128)
    for mode, which in (("joint", "all"), ("class", "y"), ("class", "all"))
] + [(2048, "joint", "y", 64, 64)]


@pytest.mark.parametrize("P,mode,which,k,kb", TILED_DESIGN_CASES)
def test_tiled_design_matches_ref_and_jax(P, mode, which, k, kb):
    """The tiled route, emulated, bit-equal to ``ref`` on every case and
    to JAX at P = 1025 with k or kb = 17 (one compile per mode)."""
    assert not kernel.takes_staged(P, mode, k, kb)
    x, y, mask = _samples(P, mode, seed=P * 1000 + kb)
    kw = dict(k=k, kb=kb, kk=kb, mode=mode, which=which)
    got = _tiled_emulate(x, y, mask, **kw)
    _assert_same(got, _ref(x, y, mask, **kw))
    if P == 1025 and kb == 17:
        _assert_same(got, _jax(x, y, mask, **kw))


@pytest.mark.parametrize("finite", [True, False], ids=["finite", "nonfinite"])
@pytest.mark.parametrize("P,mode,which,k,kb", [
    (1025, "joint", "all", 17, 17), (1025, "joint", "y", 40, 40),
    (2048, "joint", "all", 3, 3), (1025, "class", "y", 3, 32),
    (2048, "class", "all", 3, 17), (256, "joint", "all", 32, 32),
    (256, "joint", "all", 60, 60),
])
def test_tiled_design_edge_rows(P, mode, which, k, kb, finite):
    """``_edge_samples``' rows (duplicates, -0.0 beside +0.0 codes, a
    singleton class, rows with exactly k neighbours; NaN and +-inf x or y
    with ``finite=False``) through the emulated tiled route, bit-equal to
    ``ref``; the finite P = 1025 joint case to JAX too."""
    x, y, mask = _edge_samples(P, mode, k, seed=7 * P + k, finite=finite)
    kw = dict(k=k, kb=kb, kk=kb, mode=mode, which=which)
    got = _tiled_emulate(x, y, mask, **kw)
    _assert_same(got, _ref(x, y, mask, **kw))
    if finite and (P, mode, k) == (1025, "joint", 17):
        _assert_same(got, _jax(x, y, mask, **kw))


def test_tiled_orders_merge_by_rank():
    """The chunked sort merged by rank gives the whole sample's orders:
    the x order by (x, y, column) value keys, the y order by (y,
    column); NaN last, -0.0 and +0.0 one key."""
    rng = np.random.default_rng(5)
    P = 3 * TILED_CHUNK + 77
    x = rng.integers(-3, 4, P).astype(np.float32)
    y = rng.integers(-2, 3, P).astype(np.float32)
    x[rng.uniform(size=P) < 0.05] = np.nan
    y[rng.uniform(size=P) < 0.05] = -0.0
    m = rng.uniform(size=P) > 0.2
    xo, yo = _tiled_orders(x, y, m)
    cols = np.flatnonzero(m)
    hx, hy = _code_key(x), _code_key(y)
    np.testing.assert_array_equal(xo, cols[np.lexsort((cols, hy[cols], hx[cols]))])
    np.testing.assert_array_equal(yo, cols[np.lexsort((cols, hy[cols]))])
    # A short sample takes the whole-sample route to the same orders.
    short = np.arange(P) < WARP_P
    xs, ys = _tiled_orders(x[short], y[short], m[short])
    c = cols[cols < WARP_P]
    np.testing.assert_array_equal(xs, c[np.lexsort((c, hy[c], hx[c]))])
    np.testing.assert_array_equal(ys, c[np.lexsort((c, hy[c]))])


def test_tiled_band_merge_keeps_the_smallest():
    """A sorted batch merged into a sorted buffer (min against the
    reversed batch, then the bitonic clean) leaves the W smallest of
    both, in order."""
    rng = np.random.default_rng(6)
    for W in (16, 32, 64):
        G = min(W // 2, 32)
        b = np.sort(np.round(rng.exponential(size=(50, W)), 1).astype(F32), 1)
        c = np.round(rng.exponential(size=(50, G)), 1).astype(F32)
        want = np.sort(np.concatenate([b, c], 1), 1)[:, :W]
        _sort_network(c)
        np.testing.assert_array_equal(c, np.sort(c, 1))
        b[:, W - G:] = np.fmin(b[:, W - G:], c[:, ::-1])
        _bitonic_clean(b)
        np.testing.assert_array_equal(b, want)

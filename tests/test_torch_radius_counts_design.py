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

import bisect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.knn_stats import ops as j_ops
from repro_torch.kernels.knn_stats import kernel, ref
from test_torch_knn_stats import CASES, _edge_samples, _samples

F32 = np.float32
INF = F32(np.inf)


def _width(need: int) -> int:
    """The staged body's buffer width (need rounded up as the kernel
    instantiates it); beyond its range, exactly need."""
    for w in (3, 8, 16):
        if need <= w:
            return w
    return need


def _code_key(v: np.ndarray) -> np.ndarray:
    """The kernel's ``code_key``: a float32's order as uint32, -0.0 folded
    onto +0.0, every NaN 0xFFFFFFFF."""
    v = np.where(v == 0, F32(0), v).astype(F32)
    u = v.view(np.uint32)
    key = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return np.where(np.isnan(v), np.uint32(0xFFFFFFFF), key)


def _insert(b: np.ndarray, d) -> None:
    """b[s] = max(b[s-1], min(b[s], d)), s = W-1..1; b[0] = min(b[0], d)
    (fmin/fmax drop a NaN operand, as fminf/fmaxf do)."""
    b[1:] = np.fmax(b[:-1], np.fmin(b[1:], d))
    b[0] = np.fmin(b[0], d)


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
# ``_tiled_emulate`` repeats that route in numpy float32, vectorised over
# a sample's rows, and is held bit-equal to ``ref.radius_counts`` and to
# the JAX package's ``knn_radius_counts``.

TILED_CHUNK = kernel.TILED_CHUNK
WARP_P = 256  # radius_counts.cu, tiled::kWarpP: one warp a sample up to here
DONE = np.uint64(0xFFFFFFFF)


def _pair_order(key, cols):
    """``cols`` sorted by (key, column) pairs."""
    return cols[np.lexsort((cols, key[cols]))]


def _tiled_orders(x, y, m):
    """The x and y orders of one sample (arrays of columns)."""
    P = len(x)
    cols = np.flatnonzero(m)
    hx = _code_key(x).astype(np.uint64)
    hy = _code_key(y).astype(np.uint64)
    if P <= WARP_P:
        yo = _pair_order(hy, cols)
        ypos = np.arange(len(yo))
        xo = yo[np.lexsort((ypos, hx[yo]))]  # by (code_key(x), y position)
        return xo, yo
    kxy = (hx << np.uint64(32)) | hy
    orders = []
    for key in (kxy, hy):
        pairs = [[(int(key[j]), int(j)) for j in _pair_order(
                     key, cols[(cols >= c0) & (cols < c0 + TILED_CHUNK)])]
                 for c0 in range(0, P, TILED_CHUNK)]
        out = np.empty(len(cols), np.int64)
        for c, chunk in enumerate(pairs):
            for p, pair in enumerate(chunk):
                out[p + sum(bisect.bisect_left(other, pair)
                            for d, other in enumerate(pairs) if d != c)] = pair[1]
        orders.append(out)
    return orders[0], orders[1]


def _search(arr, lo, hi, vi, t, le):
    """Per row, the first position in [lo, hi) of ``arr`` where
    !(vi - arr > t) (le) or !(vi - arr >= t): a binary search."""
    lo, hi = lo.copy(), hi.copy()
    while np.any(lo < hi):
        go = lo < hi
        mid = (lo + hi) // 2
        f = vi - arr[np.minimum(mid, len(arr) - 1)]
        pred = ~(f > t) if le else ~(f >= t)
        hi = np.where(go & pred, mid, hi)
        lo = np.where(go & ~pred, mid + 1, lo)
    return lo


def _bitonic_clean(b):
    """Sorts each row of a bitonic (R, W) array ascending, stage by stage."""
    W = b.shape[1]
    stride = W // 2
    while stride:
        for i in range(W):
            j = i ^ stride
            if j > i:
                lo, hi = np.fmin(b[:, i], b[:, j]), np.fmax(b[:, i], b[:, j])
                b[:, i], b[:, j] = lo, hi
        stride //= 2


def _sort_network(c):
    """Sorts each row of (R, G) ascending by the kernel's bitonic network."""
    G = c.shape[1]
    size = 2
    while size <= G:
        stride = size // 2
        while stride:
            for i in range(G):
                j = i ^ stride
                if j > i:
                    a, d = (i, j) if (i & size) == 0 else (j, i)
                    lo, hi = np.fmin(c[:, a], c[:, d]), np.fmax(c[:, a], c[:, d])
                    c[:, a], c[:, d] = lo, hi
            stride //= 2
        size *= 2


def _band_radius(xs, ys, nnx, s, xi, yi, t, W):
    """Joint selection along the x band with a W-lane buffer."""
    R = len(s)
    b = np.full((R, W), INF, F32)
    n = len(xs)
    if W <= 8:
        for step_dir in (1, -1):
            j = s + step_dir
            live = (j >= 0) & (j < nnx)
            while np.any(live):
                e = np.clip(j, 0, n - 1)
                dx = np.abs(xi - xs[e])
                live &= dx < b[:, -1]
                d = np.maximum(dx, np.abs(yi - ys[e]))
                nb = b.copy()
                _insert(nb.T, d)  # the network, one candidate a row
                b = np.where(live[:, None], nb, b)
                j = j + step_dir
                live &= (j >= 0) & (j < nnx)
        return b[np.arange(R), t]
    G = min(W // 2, 32)
    jr, jl = s + 1, s - 1
    right, left = jr < nnx, jl >= 0
    while np.any(right | left):
        for side in (0, 1):
            j0 = jl if side else jr
            live = left if side else right
            e0 = np.clip(j0, 0, n - 1)
            live = live & (np.abs(xi - xs[e0]) < b[:, -1])
            c = np.full((R, G), INF, F32)
            for u in range(G):
                j = j0 - u if side else j0 + u
                inside = (j >= 0) if side else (j < nnx)
                e = np.clip(j, 0, n - 1)
                d = np.maximum(np.abs(xi - xs[e]), np.abs(yi - ys[e]))
                c[:, u] = np.where(inside & ~np.isnan(d), d, INF)
            _sort_network(c)
            nb = b.copy()
            nb[:, W - G:] = np.fmin(nb[:, W - G:], c[:, ::-1])
            _bitonic_clean(nb)
            b = np.where(live[:, None], nb, b)
            if side:
                jl = np.where(live, jl - G, jl)
                left = live & (jl >= 0)
            else:
                jr = np.where(live, jr + G, jr)
                right = live & (jr < nnx)
    return b[np.arange(R), t]


def _heads(xo_, yo_, p, xi, yi, x_stream, inside):
    """Stream heads: (value bits << 1 | completes), DONE past the end."""
    e = np.clip(p, 0, len(xo_) - 1)
    ax = np.abs(xi - xo_[e]).astype(F32)
    ay = np.abs(yi - yo_[e]).astype(F32)
    if x_stream:
        v, done = ax, ay <= ax
    else:
        v, done = ay, ax < ay
    key = (v.view(np.uint32).astype(np.uint64) << np.uint64(1)) | done.astype(np.uint64)
    return np.where(inside, key, DONE)


def _event_radius(X, Y, nnx, nny, s, q, xi, yi, t):
    """Joint selection for any t: the four-stream walk."""
    R = len(s)
    p = [s - 1, s + 1, q - 1, q + 1]
    lim = [None, nnx, None, nny]
    arr = [X, X, Y, Y]
    h = [_heads(arr[i][:, 0], arr[i][:, 1], p[i], xi, yi, i < 2,
                (p[i] >= 0) if i % 2 == 0 else (p[i] < lim[i])) for i in range(4)]
    got = np.zeros(R, np.int64)
    r = np.full(R, INF, F32)
    busy = np.ones(R, bool)
    while np.any(busy):
        m = np.minimum(np.minimum(h[0], h[1]), np.minimum(h[2], h[3]))
        busy &= m != DONE
        got = got + (busy & ((m & np.uint64(1)) == 1))
        hit = busy & (got > t)
        r = np.where(hit, (m >> np.uint64(1)).astype(np.uint32).view(F32), r)
        busy &= ~hit
        idx = np.where(h[0] == m, 0, np.where(h[1] == m, 1, np.where(h[2] == m, 2, 3)))
        for i in range(4):
            move = busy & (idx == i)
            np_ = p[i] + (1 if i % 2 else -1)
            inside = (np_ >= 0) if i % 2 == 0 else (np_ < lim[i])
            nh = _heads(arr[i][:, 0], arr[i][:, 1], np_, xi, yi, i < 2, inside)
            p[i] = np.where(move, np_, p[i])
            h[i] = np.where(move, nh, h[i])
    return r


def _class_radius(ys, lo, hi, s, yi, t):
    """Class selection: the run, sorted by y, merged outward for t + 1."""
    def key(p, inside):
        d = np.abs(yi - ys[np.clip(p, 0, len(ys) - 1)]).astype(F32)
        ok = inside & ~np.isnan(d)
        return np.where(ok, d.view(np.uint32).astype(np.uint64), DONE)

    p0, p1 = s - 1, s + 1
    h0, h1 = key(p0, p0 >= lo), key(p1, p1 < hi)
    r = np.full(len(s), INF, F32)
    busy = np.ones(len(s), bool)
    got = 0
    while np.any(busy):
        m = np.minimum(h0, h1)
        busy &= m != DONE
        hit = busy & (got == t)
        r = np.where(hit, m.astype(np.uint32).view(F32), r)
        busy &= ~hit
        left = h0 == m
        p0 = np.where(busy & left, p0 - 1, p0)
        p1 = np.where(busy & ~left, p1 + 1, p1)
        h0 = np.where(busy & left, key(p0, p0 >= lo), h0)
        h1 = np.where(busy & ~left, key(p1, p1 < hi), h1)
        got += 1
    return r


def _tiled_sample(x, y, m, *, k, kb, kk, mode, which):
    P = len(x)
    r_out = np.full(P, INF, F32)
    cnt_out = np.zeros(P, np.int32)
    counts = np.zeros((5, P), np.int32)
    xo, yo = _tiled_orders(x, y, m)
    n = len(xo)
    if n == 0:
        return r_out, cnt_out, counts
    X = np.stack([x[xo], y[xo]], 1)
    Y = np.stack([x[yo], y[yo]], 1)
    nnx, nny = int((~np.isnan(X[:, 0])).sum()), int((~np.isnan(Y[:, 1])).sum())
    pos_x = np.empty(P, np.int64)
    pos_x[xo] = np.arange(n)
    pos_y = np.empty(P, np.int64)
    pos_y[yo] = np.arange(n)
    rows = np.flatnonzero(m)
    s, q = pos_x[rows], pos_y[rows]
    xi, yi = X[s, 0], X[s, 1]
    fx, fy = np.abs(xi) < INF, np.abs(yi) < INF
    R = len(rows)
    r = np.full(R, INF, F32)
    cnt = np.zeros(R, np.int64)
    zero = np.zeros(R, np.int64)
    if mode == "joint":
        W = next((w for w in (4, 8, 16, 32, 64) if k <= w), 0)
        ok = fx & fy
        if ok.any():
            t = np.full(int(ok.sum()), k - 1)
            args = (nnx, s[ok], xi[ok], yi[ok], t)
            r[ok] = (_band_radius(X[:, 0], X[:, 1], *args, W) if W else
                     _event_radius(X, Y, nnx, nny, s[ok], q[ok], xi[ok], yi[ok], t))
    else:
        ok = ~np.isnan(xi)
        run = _run_bound(X[:, 0], zero, s, xi, strict=True)
        end = _run_bound(X[:, 0], s + 1, np.full(R, nnx), xi, strict=False)
        cnt = np.where(ok, end - run - 1, 0)
        t = np.clip(np.minimum(kk, cnt) - 1, 0, kb - 1)
        sel = ok & fy
        if sel.any():
            r[sel] = _class_radius(X[:, 1], run[sel], end[sel], s[sel], yi[sel], t[sel])
    y_lt = np.where(fy, np.maximum(_search(Y[:, 1], zero, np.full(R, nny), yi, -r, True)
                                   - _search(Y[:, 1], zero, np.full(R, nny), yi, r, False), 0)
                    - (F32(0) < r), 0)
    out = [zero, y_lt, zero, zero, zero]
    if which == "all":
        ny = np.full(R, nny)
        out[3] = np.where(fy, _search(Y[:, 1], zero, ny, yi, F32(0), False)
                          - _search(Y[:, 1], zero, ny, yi, F32(0), True) - 1, 0)
        nx = np.full(R, nnx)
        a0 = _search(X[:, 0], zero, nx, xi, F32(0), True)
        b0 = _search(X[:, 0], zero, nx, xi, F32(0), False)
        out[0] = np.where(fx, np.maximum(_search(X[:, 0], zero, nx, xi, -r, True)
                                         - _search(X[:, 0], zero, nx, xi, r, False), 0)
                          - (F32(0) < r), 0)
        out[2] = np.where(fx, b0 - a0 - 1, 0)
        out[4] = np.where(fx & fy, _search(X[:, 1], a0, b0, yi, F32(0), False)
                          - _search(X[:, 1], a0, b0, yi, F32(0), True) - 1, 0)
    r_out[rows] = r
    cnt_out[rows] = cnt
    counts[:, rows] = np.stack(out)
    return r_out, cnt_out, counts


def _run_bound(xs, lo, hi, xi, strict):
    """The class run's ends: the first position in [lo, hi) where
    !(xs < xi) (strict) or !(xs <= xi), as the kernel's two loops."""
    lo, hi = lo.copy(), hi.copy()
    while np.any(lo < hi):
        go = lo < hi
        mid = (lo + hi) // 2
        v = xs[np.minimum(mid, len(xs) - 1)]
        move = (v < xi) if strict else (v <= xi)
        lo = np.where(go & move, mid + 1, lo)
        hi = np.where(go & ~move, mid, hi)
    return lo


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

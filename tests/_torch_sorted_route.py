"""The sorted route of the tiled kNN bodies, emulated in numpy float32.

``csrc/sorted_orders.cuh`` holds what the tiled bodies of
``csrc/radius_counts.cu`` and ``csrc/knn_two_op.cu`` share: each sample's
valid columns sorted twice, by (code_key(y), column) and by (code_key(x),
code_key(y), column) (a sample of at most 256 columns sorted whole, the x
order keyed by (code_key(x), position in the y order), or, for the joint
band walk alone, by (code_key(x), column); a longer one in chunks of
``kernel.TILED_CHUNK`` columns, each sorted by (key, column) pairs by a
bitonic network over the least power of two of slots that holds its last
valid column, and merged by rank), then one row at a time:

* the band walk along the x order with a W-lane buffer (W = 4, 8, 16, 32,
  64); up to 8 lanes one candidate at a time (the min/max network), wider
  buffers in batches of G = min(W / 2, 32) from each side in turn, each
  batch sorted and merged (min against the reversed batch, then a bitonic
  clean);
* the four-stream walk along both orders: an entry completes at its
  larger distance, so completions come in increasing joint distance;
* the class merge: the row's run of equal codes, sorted by y, merged from
  both sides;
* every count a range of one order found by binary search (a NaN sorts
  last and meets both predicates), j_eq within the x-tie range, which is
  sorted by y.

``test_torch_radius_counts_design.py`` and ``test_torch_two_op_design.py``
hold these steps, vectorised over a sample's rows, bit-equal to ``ref``
and to the JAX package.
"""

import bisect

import numpy as np

from repro_torch.kernels.knn_stats import kernel

F32 = np.float32
INF = F32(np.inf)
TILED_CHUNK = kernel.TILED_CHUNK
WARP_P = 256  # sorted_orders.cuh, orders::kWarpP: one warp a sample up to here
DONE = np.uint64(0xFFFFFFFF)
# The joint band buffer's widths (past the last, the four-stream walk).
BAND_WIDTHS = (4, 8, 16, 32, 64)


def _code_key(v: np.ndarray) -> np.ndarray:
    """The kernels' ``code_key``: a float32's order as uint32, -0.0 folded
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


def _band_width(need: int) -> int:
    """The joint buffer's lanes for ``need`` (0: the four-stream walk)."""
    return next((w for w in BAND_WIDTHS if need <= w), 0)


def _pair_order(key, cols):
    """``cols`` sorted by (key, column) pairs."""
    return cols[np.lexsort((cols, key[cols]))]


def _chunk_sort(key, m, c0):
    """The chunk of ``TILED_CHUNK`` columns from c0 as the sort launch
    leaves it: (key, column) pairs in slots by column, padding (~0, ~0)
    for the invalid ones, sorted by the bitonic network over the least
    power of two of slots that holds the last valid column; its first nv
    pairs, as (key, column) tuples."""
    cols = np.arange(c0, c0 + TILED_CHUNK)  # slots past the sample: padding
    valid = np.zeros(TILED_CHUNK, bool)
    inside = cols < len(key)
    valid[inside] = m[cols[inside]]
    if not valid.any():
        return []
    k = np.where(valid, key[np.minimum(cols, len(key) - 1)],
                 np.uint64(2**64 - 1)).astype(np.uint64)
    c = np.where(valid, cols, 2**32 - 1).astype(np.int64)
    span = 1
    while span <= np.flatnonzero(valid)[-1]:
        span *= 2
    k, c = k[:span].copy(), c[:span].copy()
    t = np.arange(span // 2)
    size = 2
    while size <= span:
        stride = size // 2
        while stride:
            a = 2 * t - (t & (stride - 1))
            d = a + stride
            below = (k[d] < k[a]) | ((k[d] == k[a]) & (c[d] < c[a]))
            swap = below == ((a & size) == 0)
            k[a], k[d] = np.where(swap, k[d], k[a]), np.where(swap, k[a], k[d])
            c[a], c[d] = np.where(swap, c[d], c[a]), np.where(swap, c[a], c[d])
            stride //= 2
        size *= 2
    return [(int(kk), int(cc)) for kk, cc in zip(k[:valid.sum()], c[:valid.sum()])]


def _tiled_orders(x, y, m, by_column=False, chunks=False):
    """The x and y orders of one sample (arrays of columns): up to WARP_P
    columns as one warp sorts them, unless ``chunks`` (the sort launches
    at every P, as ``ball_counts``' tiled body takes them); with
    ``by_column`` (P <= 256) the x order alone, by (code_key(x), column),
    as the joint band walk's warp kernel sorts it."""
    P = len(x)
    cols = np.flatnonzero(m)
    hx = _code_key(x).astype(np.uint64)
    hy = _code_key(y).astype(np.uint64)
    if P <= WARP_P and not chunks:
        if by_column:
            return _pair_order(hx, cols), None
        yo = _pair_order(hy, cols)
        ypos = np.arange(len(yo))
        xo = yo[np.lexsort((ypos, hx[yo]))]  # by (code_key(x), y position)
        return xo, yo
    kxy = (hx << np.uint64(32)) | hy
    orders = []
    for key in (kxy, hy):
        pairs = [_chunk_sort(key, m, c0) for c0 in range(0, P, TILED_CHUNK)]
        out = np.empty(len(cols), np.int64)
        for c, chunk in enumerate(pairs):
            for p, pair in enumerate(chunk):
                out[p + sum(bisect.bisect_left(other, pair)
                            for d, other in enumerate(pairs) if d != c)] = pair[1]
        orders.append(out)
    return orders[0], orders[1]


def _sample_orders(x, y, m, by_column=False, chunks=False):
    """One sample's orders as the row kernels read them: X and Y, (n, 2)
    arrays of (x, y) in x and y order, the leading nnx / nny with a number
    for x / y, and the valid rows (columns) with their x and y positions
    (``by_column``, ``chunks``: as ``_tiled_orders``; with ``by_column`` Y
    is X, unread)."""
    xo, yo = _tiled_orders(x, y, m, by_column, chunks)
    yo = xo if yo is None else yo
    n, P = len(xo), len(x)
    X = np.stack([x[xo], y[xo]], 1)
    Y = np.stack([x[yo], y[yo]], 1)
    nnx, nny = int((~np.isnan(X[:, 0])).sum()), int((~np.isnan(Y[:, 1])).sum())
    pos_x = np.empty(P, np.int64)
    pos_x[xo] = np.arange(n)
    pos_y = np.empty(P, np.int64)
    pos_y[yo] = np.arange(n)
    rows = np.flatnonzero(m)
    return X, Y, nnx, nny, rows, pos_x[rows], pos_y[rows]


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


KWALK = 4  # sorted_orders.cuh, orders::kWalk


def _past_run(xs, nnx, j, dir_, xi):
    """``past_run``: right, the first q >= j with xs[q] > xi (nnx if none);
    left, the last q <= j with xs[q] < xi (-1 if none); per row."""
    if dir_ > 0:
        lo, hi = j.copy(), np.full_like(j, nnx)
        while np.any(lo < hi):
            go = lo < hi
            mid = (lo + hi) // 2
            up = xs[np.clip(mid, 0, len(xs) - 1)] > xi
            hi = np.where(go & up, mid, hi)
            lo = np.where(go & ~up, mid + 1, lo)
        return lo
    lo, hi = np.zeros_like(j), np.maximum(j + 1, 0)
    while np.any(lo < hi):
        go = lo < hi
        mid = (lo + hi) // 2
        below = xs[np.clip(mid, 0, len(xs) - 1)] < xi
        lo = np.where(go & below, mid + 1, lo)
        hi = np.where(go & ~below, mid, hi)
    return lo - 1


def _run_spent(tx, ty, xi, yi, worst):
    """``run_spent``: the entry ties xi and its |dy| is not below b[W-1]."""
    return (tx == xi) & ~(np.abs(yi - ty) < worst)


def _band_walk(xs, ys, nnx, s, xi, yi, W, runs):
    """Joint selection along the x band with a W-lane buffer: each row's
    W smallest joint distances, ascending, +inf beyond (R, W).  ``runs``
    (the row kernels past WARP_P, whose x ties are sorted by y): up to 8
    lanes KWALK candidates at a time, and the walk leaves the row's own
    tie run once it is spent; else one candidate at a time."""
    R = len(s)
    b = np.full((R, W), INF, F32)
    n = len(xs)
    if W <= 8:
        K = KWALK if runs else 1
        for dir_ in (1, -1):
            j = s + dir_
            live = np.ones(R, bool)
            while np.any(live):
                for u in range(K):
                    q = j + dir_ * u
                    inside = (q >= 0) & (q < nnx)
                    e = np.clip(q, 0, n - 1)
                    cx = np.where(inside, xs[e], F32(np.nan))
                    cy = np.where(inside, ys[e], F32(np.nan))
                    dx = np.abs(xi - cx)
                    live &= dx < b[:, -1]
                    nb = b.copy()
                    _insert(nb.T, np.maximum(dx, np.abs(yi - cy)))
                    b = np.where(live[:, None], nb, b)
                j = j + dir_ * K
                if runs:
                    spent = live & _run_spent(cx, cy, xi, yi, b[:, -1])
                    if spent.any():
                        j = np.where(spent, _past_run(xs, nnx, j, dir_, xi), j)
        return b
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
            tail_in = (j >= 0) if side else (j < nnx)
            tx = np.where(tail_in, xs[e], F32(np.nan))
            ty = np.where(tail_in, ys[e], F32(np.nan))
            _sort_network(c)
            nb = b.copy()
            nb[:, W - G:] = np.fmin(nb[:, W - G:], c[:, ::-1])
            _bitonic_clean(nb)
            b = np.where(live[:, None], nb, b)
            spent = live & runs & _run_spent(tx, ty, xi, yi, b[:, -1])
            if side:
                jl = np.where(live, jl - G, jl)
                jl = np.where(spent, _past_run(xs, nnx, jl, -1, xi), jl)
                left = live & (jl >= 0)
            else:
                jr = np.where(live, jr + G, jr)
                jr = np.where(spent, _past_run(xs, nnx, jr, 1, xi), jr)
                right = live & (jr < nnx)
    return b


def _band_radius(xs, ys, nnx, s, xi, yi, t, W, runs):
    """The band walk's lane t of each row."""
    return _band_walk(xs, ys, nnx, s, xi, yi, W, runs)[np.arange(len(s)), t]


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


def _event_walk(X, Y, nnx, nny, s, q, xi, yi, count):
    """The four-stream walk: each row's first ``count`` completions in
    order, +inf where the streams ran out first (R, count)."""
    R = len(s)
    p = [s - 1, s + 1, q - 1, q + 1]
    lim = [None, nnx, None, nny]
    arr = [X, X, Y, Y]
    h = [_heads(arr[i][:, 0], arr[i][:, 1], p[i], xi, yi, i < 2,
                (p[i] >= 0) if i % 2 == 0 else (p[i] < lim[i])) for i in range(4)]
    got = np.zeros(R, np.int64)
    out = np.full((R, count), INF, F32)
    busy = np.ones(R, bool)
    while np.any(busy):
        m = np.minimum(np.minimum(h[0], h[1]), np.minimum(h[2], h[3]))
        busy &= m != DONE
        hit = busy & ((m & np.uint64(1)) == 1)
        lane = np.flatnonzero(hit)
        out[lane, got[lane]] = (m[lane] >> np.uint64(1)).astype(np.uint32).view(F32)
        got = got + hit
        busy &= got < count
        idx = np.where(h[0] == m, 0, np.where(h[1] == m, 1, np.where(h[2] == m, 2, 3)))
        for i in range(4):
            move = busy & (idx == i)
            np_ = p[i] + (1 if i % 2 else -1)
            inside = (np_ >= 0) if i % 2 == 0 else (np_ < lim[i])
            nh = _heads(arr[i][:, 0], arr[i][:, 1], np_, xi, yi, i < 2, inside)
            p[i] = np.where(move, np_, p[i])
            h[i] = np.where(move, nh, h[i])
    return out


def _event_radius(X, Y, nnx, nny, s, q, xi, yi, t):
    """Joint selection for any t: the (t + 1)-th completion of the walk."""
    count = int(np.max(t)) + 1 if len(s) else 1
    return _event_walk(X, Y, nnx, nny, s, q, xi, yi, count)[np.arange(len(s)), t]


def _class_walk(ys, lo, hi, s, yi, count):
    """Class selection: the run, sorted by y, merged outward from the row;
    its first ``count`` |dy| ascending, +inf beyond (R, count)."""
    def key(p, inside):
        d = np.abs(yi - ys[np.clip(p, 0, len(ys) - 1)]).astype(F32)
        ok = inside & ~np.isnan(d)
        return np.where(ok, d.view(np.uint32).astype(np.uint64), DONE)

    p0, p1 = s - 1, s + 1
    h0, h1 = key(p0, p0 >= lo), key(p1, p1 < hi)
    out = np.full((len(s), count), INF, F32)
    for got in range(count):
        m = np.minimum(h0, h1)
        busy = m != DONE
        if not busy.any():
            break
        out[:, got] = np.where(busy, m.astype(np.uint32).view(F32), INF)
        left = h0 == m
        p0 = np.where(busy & left, p0 - 1, p0)
        p1 = np.where(busy & ~left, p1 + 1, p1)
        h0 = np.where(busy & left, key(p0, p0 >= lo), h0)
        h1 = np.where(busy & ~left, key(p1, p1 < hi), h1)
    return out


def _class_radius(ys, lo, hi, s, yi, t):
    """Class selection: the merge's lane t of each row."""
    count = int(np.max(t)) + 1 if len(s) else 1
    return _class_walk(ys, lo, hi, s, yi, count)[np.arange(len(s)), t]


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


def _class_runs(X, nnx, s, xi):
    """Each row's run [run, end) of equal codes in the x order, and cnt
    (its length less one; 0 for a NaN code)."""
    R = len(s)
    run = _run_bound(X[:, 0], np.zeros(R, np.int64), s, xi, strict=True)
    end = _run_bound(X[:, 0], s + 1, np.full(R, nnx), xi, strict=False)
    return run, end, np.where(~np.isnan(xi), end - run - 1, 0)


def _row_counts(X, Y, nnx, nny, xi, yi, r, which):
    """x_lt, y_lt, x_eq, y_eq, j_eq of each row at radius r: ranges of
    the orders found by binary search, the self pair taken out (only
    y_lt for which == "y")."""
    R = len(xi)
    fx, fy = np.abs(xi) < INF, np.abs(yi) < INF
    zero = np.zeros(R, np.int64)
    ny = np.full(R, nny)
    y_lt = np.where(fy, np.maximum(_search(Y[:, 1], zero, ny, yi, -r, True)
                                   - _search(Y[:, 1], zero, ny, yi, r, False), 0)
                    - (F32(0) < r), 0)
    out = [zero, y_lt, zero, zero, zero]
    if which == "all":
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
    return np.stack(out)

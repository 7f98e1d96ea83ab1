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

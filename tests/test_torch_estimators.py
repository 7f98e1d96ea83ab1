"""The port's MI estimators against ``repro.core.estimators``.

Same inputs (numpy, seeded) through both packages.  Dense ranks are
held exactly; MI within rtol 1e-5 / atol 1e-5, because
``torch.special.digamma`` and jax's digamma differ by up to ~2e-6 and
float sums are taken in another order.

``impl="materialized"`` is held against the reference's materialized
MI (1e-5, for the same reason) and against the port's own fused MI.
The latter holds bit for bit on the CPU: both impls produce equal
radii and counts and run the same tails on the same batch shape, so
the tests assert equality (tolerance 0), stricter than the 1e-6 the
card is held to (``chip_smoke.py``), where the tails' reductions may
split differently.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import estimators as je
from repro_torch.core import estimators as te

RTOL = ATOL = 1e-5
B, P = 4, 256


def _data(seed, discrete_x=False, discrete_y=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, P)).astype(np.float32)
    y = (0.6 * x + rng.normal(size=(B, P))).astype(np.float32)
    x[:, :50] = np.round(x[:, :50])  # repeated values (mixture regime)
    if discrete_x:
        x = rng.integers(0, 6, size=(B, P)).astype(np.int64)
    if discrete_y:
        y = (rng.integers(0, 4, size=(B, P)) + (x > 2)).astype(np.int64)
    mask = rng.uniform(size=(B, P)) > 0.2
    mask[3] = False
    mask[3, :5] = True  # fewer valid rows than k + 1
    return x, y, mask


def _j(a):
    a = np.asarray(a)
    return jnp.asarray(a.astype(np.uint32) if a.dtype == np.int64 else a)


def _close(got, fn, *arrays):
    want = np.array([np.asarray(fn(*(_j(a[b]) for a in arrays)))
                     for b in range(B)])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


T = torch.from_numpy


@pytest.mark.parametrize("kind", ["float", "codes", "ties"])
def test_dense_rank_exact(kind):
    rng = np.random.default_rng(7)
    if kind == "float":
        v = rng.normal(size=(B, P)).astype(np.float32)
        v[:, ::7] = -0.0
        v[:, 1::7] = 0.0
    elif kind == "codes":  # uint32 codes above 2**31 must order unsigned
        v = rng.integers(0, 2**32, size=(B, P), dtype=np.uint64).astype(np.int64)
    else:
        v = rng.integers(0, 5, size=(B, P)).astype(np.int64)
    mask = rng.uniform(size=(B, P)) > 0.3
    got = te.dense_rank(T(v), T(mask))
    assert got.dtype == torch.int32
    for b in range(B):
        np.testing.assert_array_equal(
            got[b].numpy(), np.asarray(je.dense_rank(_j(v[b]), jnp.asarray(mask[b]))))


def test_discrete_entropy_and_mle():
    x, y, m = _data(1, discrete_x=True, discrete_y=True)
    _close(te.discrete_entropy(T(x), T(m)), je.discrete_entropy, x, m)
    _close(te.mle_mi(T(x), T(y), T(m)), je.mle_mi, x, y, m)
    _close(te.mle_mi_smoothed(T(x), T(y), T(m)), je.mle_mi_smoothed, x, y, m)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_ksg_and_mixed_ksg(k):
    x, y, m = _data(2 + k)
    _close(te.ksg_mi(T(x), T(y), T(m), k=k),
           lambda a, b, c: je.ksg_mi(a, b, c, k=k), x, y, m)
    _close(te.mixed_ksg_mi(T(x), T(y), T(m), k=k),
           lambda a, b, c: je.mixed_ksg_mi(a, b, c, k=k), x, y, m)


@pytest.mark.parametrize("k,k_i", [(3, None), (3, 7), (8, 2)])
def test_dc_ksg(k, k_i):
    x, y, m = _data(5, discrete_x=True)
    codes = te.dense_rank(T(x), T(m))
    _close(te.dc_ksg_mi(codes, T(y), T(m), k=k, k_i=k_i),
           lambda a, b, c: je.dc_ksg_mi(je.dense_rank(a, c), b, c, k=k, k_i=k_i),
           x, y, m)


@pytest.mark.parametrize("xd,yd,method", [
    (False, False, "auto"), (True, True, "auto"), (True, False, "auto"),
    (False, True, "auto"), (False, False, "ksg"), (True, True, "mle_smoothed"),
])
def test_estimate_mi_dispatch(xd, yd, method):
    x, y, m = _data(9, discrete_x=xd, discrete_y=yd)
    got = te.estimate_mi(T(x), T(y), T(m), x_discrete=xd, y_discrete=yd,
                         method=method)
    _close(got, lambda a, b, c: je.estimate_mi(
        a, b, c, x_discrete=xd, y_discrete=yd, method=method), x, y, m)


def test_budget_and_method_errors():
    x, y, m = _data(11)
    with pytest.raises(ValueError, match="k_i=129"):
        te.dc_ksg_mi(T(x), T(y), T(m), k_i=129)
    with pytest.raises(ValueError):
        te.estimate_mi(T(x), T(y), T(m), x_discrete=False, y_discrete=False,
                       method="nope")


def _je_materialized(name, k, k_i=None):
    if name == "dc_ksg_mi":
        return lambda a, b, c: je.dc_ksg_mi(je.dense_rank(a, c), b, c, k=k,
                                            impl="materialized", k_i=k_i)
    return lambda a, b, c: getattr(je, name)(a, b, c, k=k, impl="materialized")


def _te(name, x, y, m, k, impl, k_i=None):
    if name == "dc_ksg_mi":
        codes = te.dense_rank(T(x), T(m))
        return te.dc_ksg_mi(codes, T(y), T(m), k=k, impl=impl, k_i=k_i)
    return getattr(te, name)(T(x), T(y), T(m), k=k, impl=impl)


MATERIALIZED_CASES = [
    ("ksg_mi", 3, None), ("ksg_mi", 8, None), ("mixed_ksg_mi", 1, None),
    ("mixed_ksg_mi", 3, None), ("dc_ksg_mi", 3, None), ("dc_ksg_mi", 3, 7),
]


@pytest.mark.parametrize("name,k,k_i", MATERIALIZED_CASES)
def test_materialized_matches_reference_and_fused(name, k, k_i):
    x, y, m = _data(20 + k, discrete_x=name == "dc_ksg_mi")
    got = _te(name, x, y, m, k, "materialized", k_i)
    _close(got, _je_materialized(name, k, k_i), x, y, m)
    fused = _te(name, x, y, m, k, "fused", k_i)
    assert torch.equal(got, fused)  # bit-exact on the CPU


def test_materialized_chunks_agree(monkeypatch):
    """A chunk of 1 sample (forced) gives the same MI as one chunk."""
    x, y, m = _data(31)
    whole = te.mixed_ksg_mi(T(x), T(y), T(m), impl="materialized")
    monkeypatch.setattr(te, "_MATERIALIZED_ELEMS", P * P)
    assert torch.equal(te.mixed_ksg_mi(T(x), T(y), T(m), impl="materialized"),
                       whole)


def test_unknown_impl_rejected():
    x, y, m = _data(12)
    for fn in (te.ksg_mi, te.mixed_ksg_mi, te.dc_ksg_mi):
        with pytest.raises(ValueError, match="impl"):
            fn(T(x), T(y), T(m), impl="streamed")

"""The port's fused radius+count against the JAX package, exactly.

The plain PyTorch version (``repro_torch.kernels.knn_stats.ref``, the
CPU path of ``ops.knn_radius_counts``) is held bit-equal on radii, class
counts and all five ball/tie counts against ``repro``'s
``knn_radius_counts`` through both JAX paths: the default scan path and
the Pallas kernel in interpret mode.  The CUDA kernel is held against
the plain version on the card by the ``cuda``-marked test (skipped
without a card) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.knn_stats import ops as j_ops
from repro_torch.kernels.knn_stats import kernel, ref
from repro_torch.kernels.knn_stats import ops as t_ops
from _torch_threads import one_thread  # noqa: F401 (autouse)

B = 3  # samples per case, batched on the port's side


def _samples(P, mode, seed):
    """Tie-heavy values, ragged masks, and one sample with only a few
    valid rows (fewer neighbours than k)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, P)).astype(np.float32)
    x[:, : P // 3] = np.round(x[:, : P // 3])
    if mode == "class":
        x = rng.integers(0, 5, size=(B, P)).astype(np.float32)
        x[:, 0] = 99.0  # a singleton class
    y = np.round(rng.normal(size=(B, P)), 1).astype(np.float32)
    mask = rng.uniform(size=(B, P)) > 0.15
    mask[1, rng.integers(P // 2, P):] = False  # ragged tail
    mask[2] = False
    mask[2, :3] = True  # two neighbours only
    return x, y, mask


def _edge_samples(P, mode, k, seed, finite=True):
    """``_samples`` plus edge rows: a run of duplicated points (all-zero
    distances), -0.0 beside +0.0 class codes (and ``_samples``' singleton
    class), and one sample whose k+1 valid rows have exactly k neighbours
    each; with ``finite=False`` also NaN and +-inf x or y in valid rows
    and a NaN class code."""
    x, y, mask = _samples(P, mode, seed)
    rng = np.random.default_rng(seed + 1)
    d0 = P // 2
    d1 = min(P, d0 + max(2, P // 16))
    x[:, d0:d1] = x[:, d0:d0 + 1]
    y[:, d0:d1] = y[:, d0:d0 + 1]
    if mode == "class":
        q = max(1, P // 16)
        x[:, 1:1 + q] = -0.0
        x[:, 1 + q:1 + 2 * q] = 0.0
    mask[2] = np.arange(P) < k + 1
    if not finite:
        for v in (x, y):
            hit = rng.uniform(size=v.shape) < 0.03
            v[hit] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32),
                                size=int(hit.sum()))
        if mode == "class":
            x[:, P - 1] = np.nan
    return x, y, mask


CASES = [
    # P, mode, which, k, k_max, kk
    (256, "joint", "all", 1, None, None),
    (256, "joint", "all", 3, None, None),
    (256, "joint", "all", 8, None, None),
    (256, "joint", "y", 3, None, None),
    (256, "class", "y", 3, None, None),
    (256, "class", "all", 8, None, None),
    (256, "class", "y", 3, 8, 6),  # kk > k with a widened buffer
    (256, "joint", "all", j_ops.K_MAX, None, None),
    (512, "joint", "all", 3, None, None),
    (512, "class", "y", 3, None, None),
    (40, "joint", "all", 3, None, None),  # P below one tile
]


def _torch_stats(x, y, mask, **kw):
    r, cnt, c = t_ops.knn_radius_counts(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask), **kw)
    return r.numpy(), cnt.numpy(), np.stack([f.numpy() for f in c])


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["jax_scan", "jax_pallas_interpret"])
@pytest.mark.parametrize("P,mode,which,k,k_max,kk", CASES)
def test_matches_jax_exactly(P, mode, which, k, k_max, kk, use_kernel):
    x, y, mask = _samples(P, mode, seed=P * 1000 + k)
    kw = dict(k=k, k_max=k_max, mode=mode, which=which, kk=kk)
    r, cnt, c = _torch_stats(x, y, mask, **kw)
    assert r.dtype == np.float32 and cnt.dtype == np.int32 and c.dtype == np.int32
    for b in range(B):
        jr, jcnt, jc = j_ops.knn_radius_counts(
            jnp.asarray(x[b]), jnp.asarray(y[b]), jnp.asarray(mask[b]),
            use_kernel=use_kernel, **kw)
        assert r[b].tobytes() == np.asarray(jr).tobytes()
        np.testing.assert_array_equal(cnt[b], np.asarray(jcnt))
        np.testing.assert_array_equal(c[:, b], np.stack([np.asarray(f) for f in jc]))


def test_invalid_rows_and_radius_tail():
    x, y, mask = _samples(64, "joint", seed=3)
    r, _, c = _torch_stats(x, y, mask, k=3)
    assert np.all(np.isinf(r[~mask]))
    assert not c[:, ~mask].any()
    # sample 2 has two valid rows: each has one neighbour < k=3 -> +inf
    assert np.all(np.isinf(r[2, :3]))


def test_leading_dims_and_chunking(monkeypatch):
    """(2, 3, P) batches equal the flat batch, also when the plain
    version splits the batch into many chunks."""
    x, y, mask = _samples(64, "joint", seed=4)
    xs, ys, ms = (np.concatenate([a, a[::-1]]) for a in (x, y, mask))
    flat = _torch_stats(xs, ys, ms, k=3)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 64 * 64)
    shaped = _torch_stats(xs.reshape(2, 3, 64), ys.reshape(2, 3, 64),
                          ms.reshape(2, 3, 64), k=3)
    np.testing.assert_array_equal(shaped[0].reshape(6, 64), flat[0])
    np.testing.assert_array_equal(shaped[2].reshape(5, 6, 64), flat[2])


def test_nan_is_never_selected():
    """The NaN rule the CUDA kernel shares: a NaN distance is treated as
    +inf for selection and fails every count."""
    x = torch.tensor([[0.0, float("nan"), 1.0, 2.0, 4.0]])
    y = torch.zeros(1, 5)
    m = torch.ones(1, 5, dtype=torch.bool)
    r, _, c = t_ops.knn_radius_counts(x, y, m, k=1)
    assert r[0, 0] == 1.0 and torch.isinf(r[0, 1])
    assert c.x_lt[0, 1] == 0 and c.y_eq[0, 1] == 4 and c.j_eq[0, 1] == 0


@pytest.mark.parametrize("kw", [
    dict(k=3, k_max=2), dict(k=3, k_max=j_ops.K_MAX + 1),
    dict(k=3, kk=5), dict(k=3, mode="bogus"), dict(k=3, which="x"),
])
def test_value_errors_match_reference(kw):
    x = np.zeros(8, np.float32)
    m = np.ones(8, bool)
    with pytest.raises(ValueError) as want:
        j_ops.knn_radius_counts(jnp.asarray(x), jnp.asarray(x), jnp.asarray(m), **kw)
    with pytest.raises(ValueError) as got:
        t_ops.knn_radius_counts(torch.from_numpy(x[None]),
                                torch.from_numpy(x[None]),
                                torch.from_numpy(m[None]), **kw)
    assert str(got.value) == str(want.value)
    assert t_ops.K_MAX == j_ops.K_MAX


def test_kernel_refuses_cpu_tensors():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.radius_counts(x, x, x > 0, k=1, kb=1, kk=1, mode="joint",
                             which="all")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# The card-side cases: CASES, then cases that reach the tiled body beyond
# the staged body's columns (P=2048) and past its buffer (k=17, kb=32),
# the staged body at its widest buffer (k=16), then the edge rows (finite
# and not) at P = 40, 256 and 512.
CUDA_CASES = [c + (None,) for c in CASES] + [
    (2048, "joint", "all", 3, None, None, None),
    (2048, "class", "y", 3, None, None, None),
    (256, "joint", "all", 17, None, None, None),
    (256, "class", "all", 3, 32, None, None),
    (256, "joint", "all", 16, None, None, None),
    (2048, "class", "all", 3, None, None, False),
] + [
    (P, mode, which, k, k_max, kk, finite)
    for P in (40, 256, 512)
    for mode, which, k, k_max, kk in (("joint", "all", 3, None, None),
                                      ("class", "y", 3, None, None),
                                      ("class", "all", 3, 8, 6))
    for finite in (True, False)
]


@pytest.mark.cuda
@pytest.mark.parametrize("P,mode,which,k,k_max,kk,finite", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda_device, P, mode, which, k, k_max, kk,
                                   finite):
    """On the card: the CUDA kernel bit-equal to the plain version, through
    the body ``kernel.takes_staged`` names (``finite`` None: ``_samples``;
    else ``_edge_samples``)."""
    if finite is None:
        x, y, mask = _samples(P, mode, seed=P + k)
    else:
        x, y, mask = _edge_samples(P, mode, k, seed=P + k, finite=finite)
    kb = k if k_max is None else k_max
    kkv = k if kk is None else kk
    args = dict(k=k, kb=kb, kk=kkv, mode=mode, which=which)
    T = [torch.from_numpy(a).to(cuda_device) for a in (x, y, mask)]
    body = (kernel.radius_counts_staged if kernel.takes_staged(P, mode, k, kb)
            else kernel.radius_counts_tiled)
    before = kernel.radius_counts.launches
    before_body = body.launches
    got = kernel.radius_counts(*T, **args)
    want = ref.radius_counts(*T, **args)
    torch.cuda.synchronize()
    assert kernel.radius_counts.launches == before + 1
    assert body.launches == before_body + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # and through ops, which dispatches CUDA tensors to the kernel
    r, _, _ = t_ops.knn_radius_counts(*T, k=k, k_max=k_max, mode=mode,
                                      which=which, kk=kk)
    assert torch.equal(r, want[0])
    assert kernel.radius_counts.launches == before + 2


def _batch_samples(B, P, mode, k, seed, finite):
    """B samples of ``_samples``' kind at any B: tie-heavy x (class codes
    0-4 in class mode, -0.0 beside +0.0) and y, ragged masks; from B = 3
    on, the last sample all invalid and the one before it with only
    k // 2 + 1 valid columns (fewer neighbours than k).  ``finite=False``
    adds NaN and +-inf x or y in valid rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, P)).astype(np.float32)
    x[:, : P // 3] = np.round(x[:, : P // 3])
    if mode == "class":
        x = rng.integers(0, 5, size=(B, P)).astype(np.float32)
    x[:, 1::7][x[:, 1::7] == 0] = -0.0
    y = np.round(rng.normal(size=(B, P)), 1).astype(np.float32)
    y[:, 2::5][y[:, 2::5] == 0] = -0.0
    mask = rng.uniform(size=(B, P)) > 0.15
    if B >= 3:
        mask[-1] = False
        mask[-2] = False
        mask[-2, rng.choice(P, size=min(P, k // 2 + 1), replace=False)] = True
    if not finite:
        for v in (x, y):
            hit = rng.uniform(size=v.shape) < 0.03
            v[hit] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32),
                                size=int(hit.sum()))
    return x, y, mask


# The tiled body's card cases: long samples at B = 1 and B = 64, wide
# buffers at P = 256 (B = 4096), 700 (one sort chunk) and 2048, each
# mode; finite and not.
TILED_CASES = [
    (B, P, mode, which, 3, None, None, finite)
    for P in (1025, 4096, 10000, 40000)
    for B in (1, 64)
    for mode, which in (("joint", "all"), ("class", "y"), ("class", "all"))
    for finite in (True, False)
    if P < 40000 or (B == 1 or (mode, finite) == ("joint", False))
] + [
    (B, P, mode, which, k, k_max, kk, finite)
    for B, P in ((4096, 256), (64, 700), (4, 2048))
    for need in (17, 32, 64, 128)
    for mode, which, k, k_max, kk in (("joint", "all", need, None, None),
                                      ("joint", "y", need, None, None),
                                      ("class", "y", 3, need, need),
                                      ("class", "all", 5, need, 3))
    for finite in (True, False)
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,P,mode,which,k,k_max,kk,finite", TILED_CASES)
def test_cuda_tiled_body_matches_plain(cuda_device, B, P, mode, which, k,
                                       k_max, kk, finite):
    """On the card: every case outside the staged body's range, bit-equal
    to the plain version through the tiled body, one count a call."""
    kb = k if k_max is None else k_max
    assert not kernel.takes_staged(P, mode, k, kb)
    x, y, mask = _batch_samples(B, P, mode, kb, seed=B + P + kb, finite=finite)
    args = dict(k=k, kb=kb, kk=k if kk is None else kk, mode=mode, which=which)
    T = [torch.from_numpy(a).to(cuda_device) for a in (x, y, mask)]
    before = kernel.radius_counts_tiled.launches
    got = kernel.radius_counts(*T, **args)
    want = ref.radius_counts(*T, **args)
    torch.cuda.synchronize()
    assert kernel.radius_counts_tiled.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)

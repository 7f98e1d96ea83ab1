"""The port's two-op kNN API against the JAX package, exactly.

``knn_smallest``, ``ball_counts`` and ``knn_with_counts`` of
``repro_torch.kernels.knn_stats.ops`` (on the CPU: the plain PyTorch
version in ``ref.py``) are held bit-equal on kNN buffers, class counts,
radii and all five ball/tie counts against ``repro``'s functions of the
same names through both JAX paths: the scan path (``use_kernel=False``)
and the Pallas kernels in interpret mode (``use_kernel=True``).  The
composition is also held against the port's fused ``knn_radius_counts``.
The CUDA kernels are held against the plain version on the card by the
``cuda``-marked tests (skipped without a card) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.knn_stats import ops as j_ops
from repro_torch.kernels.knn_stats import kernel, ref
from repro_torch.kernels.knn_stats import ops as t_ops
from test_torch_knn_stats import _batch_samples
from _torch_threads import one_thread  # noqa: F401 (autouse)

B = 4  # samples per case, batched on the port's side
USE_KERNEL = pytest.mark.parametrize("use_kernel", [False, True],
                                     ids=["jax_scan", "jax_pallas_interpret"])


def _samples(P, mode, seed):
    """Tie-heavy values, ragged masks, a sample with only a few valid
    rows (fewer neighbours than k) and an all-invalid sample."""
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
    mask[3] = False  # no valid row at all
    return x, y, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


KNN_CASES = [
    # P, mode, k, k_max
    (256, "joint", 3, None),
    (256, "class", 3, None),
    (256, "class", 3, 8),  # buffer wider than k
    (300, "joint", 4, None),  # ragged P
    (512, "joint", 3, None),  # the LV2SK/PRISK 2n capacity
    (512, "class", 3, None),
    (40, "joint", j_ops.K_MAX, None),  # k = 128 > P: +inf tails
]


@USE_KERNEL
@pytest.mark.parametrize("P,mode,k,k_max", KNN_CASES)
def test_knn_smallest_matches_jax_exactly(P, mode, k, k_max, use_kernel):
    x, y, mask = _samples(P, mode, seed=P * 100 + k)
    knn, cnt = t_ops.knn_smallest(*_t(x, y, mask), k=k, k_max=k_max, mode=mode)
    kb = k if k_max is None else k_max
    assert knn.shape == (B, P, kb) and knn.dtype == torch.float32
    assert cnt.shape == (B, P) and cnt.dtype == torch.int32
    for b in range(B):
        jk, jc = j_ops.knn_smallest(*_j(x[b], y[b], mask[b]), k=k, k_max=k_max,
                                    mode=mode, use_kernel=use_kernel)
        assert knn[b].numpy().tobytes() == np.asarray(jk).tobytes()
        np.testing.assert_array_equal(cnt[b].numpy(), np.asarray(jc))
    assert torch.isinf(knn[3]).all() and not cnt[3].any()


def _radii(kind, x, y, mask, rng):
    if kind == "random":
        return rng.uniform(0, 2, size=x.shape).astype(np.float32)
    if kind == "zero":
        return np.zeros(x.shape, np.float32)
    if kind == "inf":
        return np.full(x.shape, np.inf, np.float32)
    # an existing distance: each row's 2nd-nearest joint distance
    knn, _ = t_ops.knn_smallest(*_t(x, y, mask), k=2)
    return knn[..., 1].numpy()


@USE_KERNEL
@pytest.mark.parametrize("which", ["all", "y"])
@pytest.mark.parametrize("kind", ["random", "zero", "inf", "distance"])
def test_ball_counts_match_jax_exactly(kind, which, use_kernel):
    P = 200
    x, y, mask = _samples(P, "joint", seed=7)
    r = _radii(kind, x, y, mask, np.random.default_rng(8))
    got = t_ops.ball_counts(*_t(x, y, mask, r), which=which)
    assert all(c.shape == (B, P) and c.dtype == torch.int32 for c in got)
    for b in range(B):
        want = j_ops.ball_counts(*_j(x[b], y[b], mask[b], r[b]), which=which,
                                 use_kernel=use_kernel)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    if kind == "inf":  # every valid neighbour lies inside an infinite ball
        n = mask.sum(-1, keepdims=True) - 1
        np.testing.assert_array_equal(got.y_lt.numpy(), np.where(mask, n, 0))


def _dc_radius(kk, kb, mask):
    """DC-KSG's clipped within-class extraction (the radius rule
    ``knn_radius_counts`` fuses in class mode)."""
    def radius(knn, cnt):
        n_x = cnt + mask.to(torch.int32)
        idx = (torch.clamp(n_x - 1, max=kk) - 1).clamp(0, kb - 1)
        return knn.gather(-1, idx.to(torch.int64)[..., None])[..., 0]
    return radius


def _j_dc_radius(kk, kb, mask):
    m = jnp.asarray(mask).astype(jnp.int32)

    def radius(knn, cnt):
        idx = jnp.clip(jnp.minimum(kk, cnt + m - 1) - 1, 0, kb - 1)
        return jnp.take_along_axis(knn, idx[:, None], axis=1)[:, 0]
    return radius


KWC_CASES = [
    # P, mode, which, k, k_max, kk (class radius budget; None: default radius)
    (256, "joint", "all", 3, None, None),
    (256, "joint", "y", 3, None, None),
    (256, "class", "y", 3, None, 3),
    (256, "class", "all", 3, 8, 6),  # k_max wider than k, budget kk > k
    (300, "class", "y", 4, None, 4),
    (512, "joint", "all", 3, None, None),
]


@USE_KERNEL
@pytest.mark.parametrize("P,mode,which,k,k_max,kk", KWC_CASES)
def test_knn_with_counts_matches_jax_and_fused(P, mode, which, k, k_max, kk,
                                               use_kernel):
    """The two-op composition equals the JAX package's on every output,
    and its radius and counts equal the port's fused kernel path."""
    x, y, mask = _samples(P, mode, seed=P + 31 * k)
    kb = k if k_max is None else k_max
    xt, yt, mt = _t(x, y, mask)
    radius = None if kk is None else _dc_radius(kk, kb, mt)
    knn, cnt, counts = t_ops.knn_with_counts(
        xt, yt, mt, k=k, k_max=k_max, mode=mode, which=which, radius=radius)
    for b in range(B):
        jrad = None if kk is None else _j_dc_radius(kk, kb, mask[b])
        jk, jc, jcounts = j_ops.knn_with_counts(
            *_j(x[b], y[b], mask[b]), k=k, k_max=k_max, mode=mode,
            which=which, radius=jrad, use_kernel=use_kernel)
        assert knn[b].numpy().tobytes() == np.asarray(jk).tobytes()
        np.testing.assert_array_equal(cnt[b].numpy(), np.asarray(jc))
        for g, w in zip(counts, jcounts):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    r = knn[..., k - 1] if radius is None else radius(knn, cnt)
    fr, fcnt, fcounts = t_ops.knn_radius_counts(
        xt, yt, mt, k=k, k_max=k_max, mode=mode, which=which, kk=kk)
    assert r.numpy().tobytes() == fr.numpy().tobytes()
    assert torch.equal(cnt, fcnt)
    for g, w in zip(counts, fcounts):
        assert torch.equal(g, w)


@USE_KERNEL
def test_custom_radius_callable(use_kernel):
    """A caller's radius (here the 1-NN distance) is applied between the
    two ops, as in the reference (tests/test_knn_stats.py)."""
    P = 64
    x, y, mask = _samples(P, "joint", seed=5)
    knn, _, got = t_ops.knn_with_counts(*_t(x, y, mask), k=3,
                                        radius=lambda knn, cnt: knn[..., 0])
    want = t_ops.ball_counts(*_t(x, y, mask), knn[..., 0])
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    for b in range(B):
        _, _, jc = j_ops.knn_with_counts(
            *_j(x[b], y[b], mask[b]), k=3, radius=lambda knn, cnt: knn[:, 0],
            use_kernel=use_kernel)
        for g, w in zip(got, jc):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


def test_ties_keep_their_multiplicity():
    """A run of equal distances fills as many buffer lanes as it has
    members, in both modes."""
    x = torch.tensor([[0.0, 1.0, 1.0, 1.0, 2.0, 5.0]])
    y = torch.zeros(1, 6)
    m = torch.ones(1, 6, dtype=torch.bool)
    knn, _ = t_ops.knn_smallest(x, y, m, k=5)
    assert knn[0, 0].tolist() == [1.0, 1.0, 1.0, 2.0, 5.0]
    codes = torch.tensor([[0.0, 0.0, 0.0, 0.0, 1.0, 1.0]])
    yc = torch.tensor([[0.0, 0.5, 0.5, 0.5, 3.0, 3.0]])
    knn, cnt = t_ops.knn_smallest(codes, yc, m, k=4, mode="class")
    assert knn[0, 0].tolist() == [0.5, 0.5, 0.5, float("inf")]
    assert cnt[0].tolist() == [3, 3, 3, 3, 1, 1]


def test_nan_is_never_selected():
    """The NaN rule ``radius_counts`` shares: a NaN distance is never
    selected and fails every count."""
    x = torch.tensor([[0.0, float("nan"), 1.0, 2.0, 4.0]])
    y = torch.zeros(1, 5)
    m = torch.ones(1, 5, dtype=torch.bool)
    knn, _ = t_ops.knn_smallest(x, y, m, k=4)
    assert knn[0, 0].tolist() == [1.0, 2.0, 4.0, float("inf")]
    assert torch.isinf(knn[0, 1]).all()
    c = t_ops.ball_counts(x, y, m, torch.full((1, 5), 10.0))
    assert c.x_lt[0].tolist() == [3, 0, 3, 3, 3]
    assert c.y_eq[0, 1] == 4 and c.j_eq[0, 1] == 0


def test_leading_dims_and_chunking(monkeypatch):
    """(2, 2, P) batches equal the flat batch, also when the plain
    version splits the batch into many chunks."""
    x, y, mask = _samples(64, "class", seed=4)
    flat = t_ops.knn_with_counts(*_t(x, y, mask), k=3, mode="class")
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 64 * 64)
    shaped = t_ops.knn_with_counts(
        *_t(x.reshape(2, 2, 64), y.reshape(2, 2, 64), mask.reshape(2, 2, 64)),
        k=3, mode="class")
    assert torch.equal(shaped[0].reshape(B, 64, 3), flat[0])
    assert torch.equal(shaped[1].reshape(B, 64), flat[1])
    for g, w in zip(shaped[2], flat[2]):
        assert torch.equal(g.reshape(B, 64), w)


@pytest.mark.parametrize("fn,kw", [
    ("knn_smallest", dict(k=3, k_max=2)),
    ("knn_smallest", dict(k=3, k_max=j_ops.K_MAX + 1)),
    ("knn_smallest", dict(k=3, mode="bogus")),
    ("ball_counts", dict(which="x")),
    ("knn_with_counts", dict(k=3, k_max=2)),
    ("knn_with_counts", dict(k=3, mode="bogus")),
    ("knn_with_counts", dict(k=3, which="x")),
])
def test_value_errors_match_reference(fn, kw):
    x = np.zeros(8, np.float32)
    m = np.ones(8, bool)
    args = (x, x, m, x) if fn == "ball_counts" else (x, x, m)
    with pytest.raises(ValueError) as want:
        getattr(j_ops, fn)(*_j(*args), **kw)
    with pytest.raises(ValueError) as got:
        getattr(t_ops, fn)(*_t(*(a[None] for a in args)), **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fn", ["knn_smallest", "ball_counts",
                                "knn_with_counts"])
def test_other_devices_raise(fn):
    """Only CPU (plain) and CUDA (kernel) tensors have an implementation."""
    x = torch.zeros(1, 8, device="meta")
    args = (x, x, x > 0, x) if fn == "ball_counts" else (x, x, x > 0)
    kw = {} if fn == "ball_counts" else {"k": 1}
    with pytest.raises(ValueError, match="implementation for meta"):
        getattr(t_ops, fn)(*args, **kw)


def test_kernels_refuse_cpu_tensors():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.knn_smallest(x, x, x > 0, kb=1, mode="joint")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ball_counts(x, x, x > 0, x, which="y")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# The card-side cases: KNN_CASES plus the edges of the staged bodies'
# range (P = 1024, kb = 16) and past them (P = 1025, kb = 17 and 128), so
# that each body of each op is reached; and the tiled body's walks (kb =
# 64 with the band buffer, 65 with the four-stream walk) past one sort
# chunk.
CUDA_KNN_CASES = KNN_CASES + [
    (1024, "joint", 16, None),
    (1024, "class", 3, 16),
    (1025, "joint", 3, None),
    (1025, "class", 3, None),
    (256, "joint", 17, None),
    (256, "class", 3, j_ops.K_MAX),
    (2048, "joint", 64, None),
    (2048, "joint", 65, None),
    (2048, "class", 3, 65),
]


def _bodies(name):
    """The dispatching wrapper and its two bodies."""
    return [getattr(kernel, name + s) for s in ("", "_staged", "_tiled")]


@pytest.mark.cuda
@pytest.mark.parametrize("P,mode,k,k_max", CUDA_KNN_CASES)
def test_cuda_knn_smallest_matches_plain(cuda_device, P, mode, k, k_max):
    """On the card: the dispatching kernel reaches the body the rule
    names, and it and every body that takes the shape are bit-equal to
    the plain version."""
    x, y, mask = _samples(P, mode, seed=P + k)
    kb = k if k_max is None else k_max
    T = [t.to(cuda_device) for t in _t(x, y, mask)]
    staged = kernel.takes_staged_two_op(P, kb)
    wrapper, st, ti = _bodies("knn_smallest")
    body = st if staged else ti
    before = (wrapper.launches, body.launches)
    got = wrapper(*T, kb=kb, mode=mode)
    want = ref.knn_smallest(*T, kb=kb, mode=mode)
    torch.cuda.synchronize()
    assert (wrapper.launches, body.launches) == (before[0] + 1, before[1] + 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(ti(*T, kb=kb, mode=mode), want):  # the tiled body takes all
        assert torch.equal(g, w)
    if not staged:
        with pytest.raises(RuntimeError, match="launch failed"):
            st(*T, kb=kb, mode=mode)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [300, 1024, 1025, 2048])
@pytest.mark.parametrize("which", ["all", "y"])
@pytest.mark.parametrize("kind", ["random", "zero", "inf", "distance"])
def test_cuda_ball_counts_match_plain(cuda_device, kind, which, P):
    x, y, mask = _samples(P, "joint", seed=9)
    r = _radii(kind, x, y, mask, np.random.default_rng(10))
    T = [t.to(cuda_device) for t in _t(x, y, mask, r)]
    staged = kernel.takes_staged_two_op(P)
    wrapper, st, ti = _bodies("ball_counts")
    body = st if staged else ti
    before = (wrapper.launches, body.launches)
    got = wrapper(*T, which=which)
    want = ref.ball_counts(*T, which=which)
    torch.cuda.synchronize()
    assert (wrapper.launches, body.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want)
    assert torch.equal(ti(*T, which=which), want)
    if not staged:
        with pytest.raises(RuntimeError, match="launch failed"):
            st(*T, which=which)


# The tiled bodies' card cases (``_batch_samples``: ties, -0.0 beside
# +0.0, ragged masks; from B = 3 on an all-invalid sample and one with
# fewer valid columns than kb; NaN and +-inf x or y with finite=False):
# long samples at B = 1 and 64 (P = 40,000 at B = 64 once: its plain
# version takes ~30 GB a sample), every width of the tiled route at
# P = 256 (B = 4096, one warp a sample) and at P = 2048 (past one chunk).
TILED_KNN_CASES = [
    (B, P, mode, 3, finite)
    for P in (2048, 10000, 40000)
    for B in (1, 64)
    for mode in ("joint", "class")
    for finite in (True, False)
    if P < 40000 or B == 1 or (mode, finite) == ("joint", False)
] + [
    (B, P, mode, kb, finite)
    for B, P in ((4096, 256), (64, 2048))
    for kb in (17, 32, 64, 65, 128)
    for mode in ("joint", "class")
    for finite in (True, False)
]
TILED_BALL_CASES = [
    (B, P, which, kind, finite)
    for B, P, kinds in ((4096, 256, ("random", "zero", "inf", "nan", "distance")),
                        (1, 2048, ("random", "zero", "inf", "nan", "distance")),
                        (64, 2048, ("random", "zero", "inf", "nan", "distance")),
                        (1, 10000, ("random", "distance")),
                        (64, 10000, ("random", "distance")),
                        (1, 40000, ("random", "distance")))
    for which in ("all", "y")
    for kind in kinds
    for finite in (True, False)
]


def _device_radii(kind, T, rng):
    """r on the card, as ``_radii`` (and NaN); the distance from the plain
    version on the card."""
    x, y, mask = T
    if kind == "distance":
        return ref.knn_smallest(x, y, mask, kb=2, mode="joint")[0][..., 1].contiguous()
    fill = {"zero": 0.0, "inf": float("inf"), "nan": float("nan")}
    if kind in fill:
        return torch.full_like(x, fill[kind])
    return torch.from_numpy(
        rng.uniform(0, 2, size=tuple(x.shape)).astype(np.float32)).to(x.device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,P,mode,kb,finite", TILED_KNN_CASES)
def test_cuda_tiled_knn_smallest_matches_plain(cuda_device, B, P, mode, kb,
                                               finite):
    """On the card: the body the rule names (one count a call) and the
    tiled body, each bit-equal to the plain version."""
    x, y, mask = _batch_samples(B, P, mode, kb, seed=B + P + kb, finite=finite)
    T = [torch.from_numpy(a).to(cuda_device) for a in (x, y, mask)]
    want = ref.knn_smallest(*T, kb=kb, mode=mode)
    wrapper, st, ti = _bodies("knn_smallest")
    body = st if kernel.takes_staged_two_op(P, kb) else ti
    before = (wrapper.launches, body.launches)
    got = wrapper(*T, kb=kb, mode=mode)
    torch.cuda.synchronize()
    assert (wrapper.launches, body.launches) == (before[0] + 1, before[1] + 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(ti(*T, kb=kb, mode=mode), want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,P,which,kind,finite", TILED_BALL_CASES)
def test_cuda_tiled_ball_counts_match_plain(cuda_device, B, P, which, kind,
                                            finite):
    """On the card: the body the rule names and the tiled body (which ==
    y through the launch that is given no x), each bit-equal to the plain
    version at the radius ``kind``."""
    x, y, mask = _batch_samples(B, P, "joint", 3, seed=B * 7 + P, finite=finite)
    T = [torch.from_numpy(a).to(cuda_device) for a in (x, y, mask)]
    r = _device_radii(kind, T, np.random.default_rng(P))
    want = ref.ball_counts(*T, r, which=which)
    wrapper, st, ti = _bodies("ball_counts")
    body = st if kernel.takes_staged_two_op(P) else ti
    before = (wrapper.launches, body.launches)
    got = wrapper(*T, r, which=which)
    torch.cuda.synchronize()
    assert (wrapper.launches, body.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want)
    assert torch.equal(ti(*T, r, which=which), want)


@pytest.mark.cuda
@pytest.mark.parametrize("P,mode,which,k,k_max,kk", KWC_CASES)
def test_cuda_knn_with_counts_two_launches(cuda_device, P, mode, which, k,
                                           k_max, kk):
    """Through ops on the card: one launch of each kernel, each of its
    staged body (P <= 1024, kb <= 16), and the radius and counts of the
    fused kernel."""
    x, y, mask = _samples(P, mode, seed=P + 3 * k)
    kb = k if k_max is None else k_max
    xt, yt, mt = (t.to(cuda_device) for t in _t(x, y, mask))
    radius = None if kk is None else _dc_radius(kk, kb, mt)
    counters = (kernel.knn_smallest, kernel.ball_counts,
                kernel.knn_smallest_staged, kernel.ball_counts_staged)
    n0 = [f.launches for f in counters]
    knn, cnt, counts = t_ops.knn_with_counts(
        xt, yt, mt, k=k, k_max=k_max, mode=mode, which=which, radius=radius)
    assert [f.launches for f in counters] == [n + 1 for n in n0]
    r = knn[..., k - 1] if radius is None else radius(knn, cnt)
    fr, fcnt, fcounts = t_ops.knn_radius_counts(
        xt, yt, mt, k=k, k_max=k_max, mode=mode, which=which, kk=kk)
    assert torch.equal(r, fr) and torch.equal(cnt, fcnt)
    for g, w in zip(counts, fcounts):
        assert torch.equal(g, w)

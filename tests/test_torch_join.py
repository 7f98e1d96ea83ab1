"""Parity of the port's sketch joins with the JAX package: join sizes,
match masks and gathered value views held exactly equal, including
padding, probe keys equal to the 0xFFFFFFFF fence and empty joins."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import hashing
from repro.core import join as j_join
from repro.core.sketch import build_sketch as j_build
from repro_torch.core import join as t_join
from repro_torch.core.sketch import build_sketch as t_build
from _torch_threads import one_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(202)
FENCE = np.uint32(0xFFFFFFFF)


def _cand_rows(n_rows, cap, fence_valid=False, empty=False):
    """(n_rows, cap) sorted candidate key rows, valid prefix first."""
    keys = np.full((n_rows, cap), FENCE, np.uint32)
    mask = np.zeros((n_rows, cap), bool)
    for r in range(n_rows):
        size = 0 if empty else int(RNG.integers(0, cap + 1))
        ks = np.sort(RNG.choice(200, size=size, replace=False).astype(np.uint32) * 7)
        if fence_valid and size:
            ks[-1] = FENCE  # a valid key that IS the fence value
        keys[r, :size] = ks
        mask[r, :size] = True
        # padding need not be fenced in the raw arrays
        keys[r, size:] = RNG.integers(0, 2**32, size=cap - size,
                                      dtype=np.uint64).astype(np.uint32)
    return keys, mask


def _train_row(n, fence_probe=False):
    keys = (RNG.integers(0, 200, size=n).astype(np.uint32) * 7)
    if fence_probe:
        keys[:5] = FENCE
    mask = RNG.uniform(size=n) > 0.2
    return keys, mask


@pytest.mark.parametrize("fence_valid", [False, True])
@pytest.mark.parametrize("fence_probe", [False, True])
@pytest.mark.parametrize("empty", [False, True])
def test_presorted_join_matches_reference(fence_valid, fence_probe, empty):
    cap, n, G = 32, 40, 12
    ck, cm = _cand_rows(G, cap, fence_valid=fence_valid, empty=empty)
    tk, tm = _train_row(n, fence_probe=fence_probe)
    cvf = RNG.normal(size=(G, cap)).astype(np.float32)
    cvu = RNG.integers(0, 2**32, size=(G, cap), dtype=np.uint64).astype(np.uint32)
    tvf = RNG.normal(size=n).astype(np.float32)
    tvu = RNG.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)

    T = lambda a: torch.from_numpy(np.asarray(a).astype(  # noqa: E731
        np.int64 if a.dtype == np.uint32 else a.dtype))
    (xf, xu), (yf, yu), match = t_join.sketch_join_presorted(
        T(tk)[None], T(tm)[None], T(ck), T(cm), (T(cvf), T(cvu)),
        (T(tvf)[None], T(tvu)[None]),
    )
    js = t_join.presorted_join_size(T(tk)[None], T(tm)[None],
                                    t_join.effective_keys(T(ck), T(cm)), T(cm))
    assert js.dtype == torch.int32
    for g in range(G):
        (rxf, rxu), (ryf, ryu), rm = j_join.sketch_join_presorted(
            jnp.asarray(tk), jnp.asarray(tm), jnp.asarray(ck[g]),
            jnp.asarray(cm[g]), (jnp.asarray(cvf[g]), jnp.asarray(cvu[g])),
            (jnp.asarray(tvf), jnp.asarray(tvu)),
        )
        np.testing.assert_array_equal(match[g].numpy(), np.asarray(rm))
        assert xf[g].numpy().tobytes() == np.asarray(rxf).tobytes()
        np.testing.assert_array_equal(xu[g].numpy(), np.asarray(rxu).astype(np.int64))
        assert yf[g].numpy().tobytes() == np.asarray(ryf).tobytes()
        np.testing.assert_array_equal(yu[g].numpy(), np.asarray(ryu).astype(np.int64))
        assert int(js[g]) == int(j_join.presorted_join_size(
            jnp.asarray(tk), jnp.asarray(tm), jnp.asarray(ck[g]),
            jnp.asarray(cm[g]), keys_effective=False))


def test_join_sizes_cross_product_broadcast():
    """(Q, 1, n) trains against (1, G, n) candidates == looped pairs."""
    cap, n, G, Q = 16, 24, 9, 4
    ck, cm = _cand_rows(G, cap)
    rows = [_train_row(n) for _ in range(Q)]
    tk = torch.from_numpy(np.stack([r[0] for r in rows]).astype(np.int64))
    tm = torch.from_numpy(np.stack([r[1] for r in rows]))
    eff = t_join.effective_keys(torch.from_numpy(ck.astype(np.int64)),
                                torch.from_numpy(cm))
    js = t_join.presorted_join_size(tk[:, None], tm[:, None], eff[None],
                                    torch.from_numpy(cm)[None])
    assert js.shape == (Q, G)
    for q in range(Q):
        for g in range(G):
            ref = j_join.presorted_join_size(
                jnp.asarray(rows[q][0]), jnp.asarray(rows[q][1]),
                jnp.asarray(ck[g]), jnp.asarray(cm[g]), keys_effective=False)
            assert int(js[q, g]) == int(ref)


def test_effective_keys_fence_and_idempotence():
    keys = torch.tensor([3, 9, 2**32 - 1, 5], dtype=torch.int64)
    mask = torch.tensor([True, True, True, False])
    eff = t_join.effective_keys(keys, mask)
    assert eff.tolist() == [3, 9, 2**32 - 1, 2**32 - 1]
    assert torch.equal(t_join.effective_keys(eff, mask), eff)
    ref = j_join.effective_keys(jnp.asarray(keys.numpy().astype(np.uint32)),
                                jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(eff.numpy(), np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("method", ["tupsk", "lv2sk", "csk"])
def test_host_sketch_join_and_full_join(method):
    raw = RNG.integers(0, 150, size=600).astype(np.uint32)
    keys = hashing.murmur3_32_np(raw, seed=1)
    y = RNG.normal(size=600).astype(np.float32)
    ck = hashing.murmur3_32_np(np.arange(0, 150, 2, dtype=np.uint32), seed=1)
    cv = RNG.normal(size=len(ck)).astype(np.float32)
    kw = dict(n=64, method=method)
    a = t_join.sketch_join(t_build(keys, y, side="train", **kw),
                           t_build(ck, cv, side="cand", **kw))
    b = j_join.sketch_join(j_build(keys, y, side="train", **kw),
                           j_build(ck, cv, side="cand", **kw))
    for f in ("x", "y", "mask"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert a.size == b.size
    fa = t_join.full_left_join(keys, y, ck, cv, agg="avg")
    fb = j_join.full_left_join(keys, y, ck, cv, agg="avg")
    for f in ("x", "y", "mask"):
        assert getattr(fa, f).tobytes() == getattr(fb, f).tobytes(), f
    assert (fa.x_is_discrete, fa.y_is_discrete) == (fb.x_is_discrete, fb.y_is_discrete)
    with pytest.raises(ValueError):
        t_join.sketch_join(t_build(keys, y, side="train", **kw),
                           t_build(keys, y, side="train", **kw))

"""The plain reference against the port's own CPU paths, and the control
that must fail the comparison: the reference computed in bfloat16."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import control, tiny
from portbench.reference import check, estimators, murmur3, sketch


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_murmur3_matches_the_port():
    from repro_torch.core import hashing

    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    seeds = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    want = hashing.murmur3_32_np(words, seed=seeds)
    got = murmur3.murmur3_32(torch.from_numpy(words.astype(np.int64)),
                             torch.from_numpy(seeds.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    fib = murmur3.fibonacci32(torch.from_numpy(want.astype(np.int64)))
    assert np.array_equal(fib.numpy(),
                          hashing.fibonacci32_np(want).astype(np.int64))


def _tables(rng, C, R, n_keys):
    raw = rng.zipf(1.5, size=(C, R)) % n_keys
    keys = murmur3.murmur3_32(torch.from_numpy(raw), 11)
    vals = torch.from_numpy(rng.normal(size=(C, R)).astype(np.float32))
    return keys, vals


@pytest.mark.parametrize("R,n", [(300, 64), (40, 64)])
def test_sketches_and_joins_match_the_port(R, n):
    from repro_torch.core.join import sketch_join
    from repro_torch.core.sketch import build_sketch

    rng = np.random.default_rng(R)
    keys, vals = _tables(rng, 12, R, 90)
    ck, cv = sketch.cand_sketches(keys, vals, n)
    tk, ty = sketch.train_sketch(keys[0], vals[0], n)
    _, _, js = sketch.join(tk, ck, cv)
    host_k = keys.numpy().astype(np.uint32)
    train = build_sketch(host_k[0], vals[0].numpy(), n=n, side="train",
                         value_is_discrete=False)
    assert sorted(train.key_hashes[train.mask]) == sorted(tk.numpy())
    for c in range(12):
        cand = build_sketch(host_k[c], vals[c].numpy(), n=n, side="cand",
                            value_is_discrete=False)
        m = int(cand.mask.sum())
        assert np.array_equal(cand.key_hashes[:m], ck[c, :m].numpy())
        assert np.array_equal(cand.values[:m], cv[c, :m].numpy())
        assert (ck[c, m:] == sketch.FENCE).all()
        assert sketch_join(train, cand).size == int(js[c])


def _samples(rng, B, P, x_disc, y_disc):
    m = torch.from_numpy(rng.random((B, P)) < 0.8)
    m[:2, 3:] = False  # samples of three points and fewer
    x = rng.integers(0, 5, (B, P)) if x_disc else np.round(
        rng.normal(size=(B, P)), 1)  # rounded: ties and zero radii
    y = rng.integers(0, 4, (B, P)) if y_disc else rng.normal(size=(B, P))
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(y.astype(np.float32)), m)


@pytest.mark.parametrize("x_disc,y_disc", [(False, False), (True, True),
                                           (True, False), (False, True)])
def test_estimators_match_the_port(x_disc, y_disc):
    from repro_torch.core import estimators as port

    x, y, m = _samples(np.random.default_rng(7), 40, 48, x_disc, y_disc)
    kind = check.ESTIMATORS[(x_disc, y_disc)]
    got = check._estimate(kind, x, y, m, 3, torch.float32, torch.float64)
    if kind == "mixed":
        want = port.mixed_ksg_mi(x, y, m, k=3)
    elif kind == "mle":
        want = port.mle_mi(x.long(), y.long(), m)
    elif kind == "dc_x":
        want = port.dc_ksg_mi(port.dense_rank(x.long(), m), y, m, k=3)
    else:
        want = port.dc_ksg_mi(port.dense_rank(y.long(), m), x, m, k=3)
    assert torch.allclose(got, want.double(), atol=2e-5, rtol=1e-5)
    if kind != "mle":
        assert (got[:2] == 0).all()


def test_bfloat16_distances_move_the_estimate():
    x, y, m = _samples(np.random.default_rng(3), 16, 64, False, False)
    x = x + 1.0 / 3  # values that bfloat16 rounds
    f32 = estimators.mixed_ksg(x, y, m, 3)
    bf16 = estimators.mixed_ksg(x, y, m, 3, torch.bfloat16, torch.float32)
    assert (f32 - bf16.double()).abs().max() > 1e-2


@pytest.mark.parametrize("name", ["lake64k-serve", "lake4k-n1024-serve"])
def test_control_fails_the_comparison(name):
    cell = tiny.cell(name)
    r = control.readings(cell, 2**31 + 5, "cpu")
    limits = cell.config["limits"]
    assert r["checked"] == cell.config["check_queries"]
    assert r["join_mismatch"] == 0
    assert r["mi_gap"] > limits["mi_gap"] or r["rank_gap"] > limits["rank_gap"]

"""The port's synthetic data (paper Section V-A) against the JAX package's.

The same ``Generator`` seed goes through ``repro.core.synthetic`` and
``repro_torch.core.synthetic``: parameters, arrays, true MI and the
KeyInd / KeyDep decompositions must be bit-equal.  Then the reference's
own checks of the generators (Section V-B1) run on the port, with its
estimators on the CPU, and the two packages' estimates of the same full
joins agree within rtol/atol 1e-5 (digamma differs between the
frameworks by ~2e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import estimators as j_est
from repro.core import synthetic as j_syn
from repro_torch.core import estimators as t_est
from repro_torch.core import synthetic as t_syn

TOL = 1e-5


def _rngs(seed: int):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _assert_pairs_equal(a, b):
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype
    assert a.true_mi == b.true_mi
    assert (a.x_is_discrete, a.y_is_discrete) == (b.x_is_discrete, b.y_is_discrete)
    assert a.params == b.params


@pytest.mark.parametrize("seed", [0, 11, 2024])
@pytest.mark.parametrize("target", [0.3, 1.0, 2.0, 3.5])
def test_trinomial_params_bit_equal(seed, target):
    rj, rt = _rngs(seed)
    assert j_syn.trinomial_params_for_mi(target, rj) == \
        t_syn.trinomial_params_for_mi(target, rt)
    assert rj.bit_generator.state == rt.bit_generator.state


@pytest.mark.parametrize("m", [1, 16, 64, 512])
def test_true_trinomial_mi_equal(m):
    rng = np.random.default_rng(m)
    for _ in range(3):
        p1, p2 = t_syn.trinomial_params_for_mi(rng.uniform(0.2, 2.5), rng)
        assert t_syn.true_trinomial_mi(m, p1, p2) == \
            j_syn.true_trinomial_mi(m, p1, p2)


def test_true_trinomial_mi_independent_of_call_order():
    """The reference caches one log-factorial table grown on demand; the
    port builds one per call.  A large m first, then a small one, must
    give the reference's values either way."""
    p1, p2 = 0.4, 0.3
    big_j = j_syn.true_trinomial_mi(1024, p1, p2)
    small_j = j_syn.true_trinomial_mi(7, p1, p2)
    assert t_syn.true_trinomial_mi(7, p1, p2) == small_j
    assert t_syn.true_trinomial_mi(1024, p1, p2) == big_j


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n_rows,m,target", [(5000, 512, 2.0), (800, 64, 0.5),
                                             (1, 8, 1.0)])
def test_gen_trinomial_bit_equal(seed, n_rows, m, target):
    rj, rt = _rngs(seed)
    _assert_pairs_equal(j_syn.gen_trinomial(n_rows, m, target, rj),
                        t_syn.gen_trinomial(n_rows, m, target, rt))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("n_rows,m", [(10_000, 64), (300, 1000), (50, 2)])
def test_gen_cdunif_bit_equal(seed, n_rows, m):
    rj, rt = _rngs(seed)
    _assert_pairs_equal(j_syn.gen_cdunif(n_rows, m, rj),
                        t_syn.gen_cdunif(n_rows, m, rt))
    assert t_syn.cdunif_true_mi(m) == j_syn.cdunif_true_mi(m)


@pytest.mark.parametrize("dist", ["trinomial", "cdunif"])
@pytest.mark.parametrize("scheme", ["keyind", "keydep"])
def test_decompose_bit_equal(dist, scheme):
    rj, rt = _rngs(17)
    gen = {"trinomial": lambda s, r: s.gen_trinomial(3000, 128, 1.5, r),
           "cdunif": lambda s, r: s.gen_cdunif(3000, 32, r)}[dist]
    pj, pt = gen(j_syn, rj), gen(t_syn, rt)
    (tj, cj), (tt, ct) = (j_syn.decompose(pj, scheme, rj),
                          t_syn.decompose(pt, scheme, rt))
    for a, b in ((tj, tt), (cj, ct)):
        assert a.keys() == b.keys()
        for key in ("key_hashes", "values"):
            np.testing.assert_array_equal(np.asarray(a[key]), b[key])
            assert np.asarray(a[key]).dtype == b[key].dtype
        assert a["value_is_discrete"] == b["value_is_discrete"]


def test_decompose_errors():
    rng = np.random.default_rng(1)
    pair = t_syn.gen_cdunif(100, 8, rng)
    cont = t_syn.GeneratedPair(pair.y, pair.y, 0.0, False, False, {})
    with pytest.raises(ValueError, match="KeyDep requires a discrete X"):
        t_syn.decompose(cont, "keydep", rng)
    with pytest.raises(ValueError, match="unknown decomposition"):
        t_syn.decompose(pair, "keyrand", rng)


# ---------------------------------------------------------------------------
# The reference's checks of the generators, on the port
# ---------------------------------------------------------------------------

def test_param_selection_hits_target():
    rng = np.random.default_rng(11)
    for target in [0.3, 1.0, 2.0]:
        p1, p2 = t_syn.trinomial_params_for_mi(target, rng)
        assert t_syn.true_trinomial_mi(512, p1, p2) == pytest.approx(target, abs=0.25)


def test_marginals_binomial():
    pair = t_syn.gen_trinomial(20_000, 64, 1.0, np.random.default_rng(11))
    p1 = pair.params["p1"]
    assert np.mean(pair.x) == pytest.approx(64 * p1, rel=0.05)
    assert np.var(pair.x) == pytest.approx(64 * p1 * (1 - p1), rel=0.1)


def test_cdunif_formula_matches_paper_example():
    assert t_syn.cdunif_true_mi(256) == pytest.approx(4.85, abs=0.01)  # paper: ≈ 4.85


def test_keydep_key_frequency_follows_x():
    rng = np.random.default_rng(11)
    pair = t_syn.gen_trinomial(5000, 64, 1.0, rng)
    train, _ = t_syn.decompose(pair, "keydep", rng)
    assert len(np.unique(train["key_hashes"])) == len(np.unique(pair.x))


def test_keyind_unique_keys():
    rng = np.random.default_rng(11)
    pair = t_syn.gen_cdunif(5000, 32, rng)
    train, cand = t_syn.decompose(pair, "keyind", rng)
    assert len(np.unique(train["key_hashes"])) == 5000
    assert len(np.unique(cand["key_hashes"])) == 5000


def _t(a):
    return torch.as_tensor(np.asarray(a))[None]


def test_full_sample_mle_close_to_true_and_to_jax():
    """Section V-B1: full-join MLE against the analytic truth (the
    reference's bound), and the port's MLE against the JAX package's."""
    rng = np.random.default_rng(11)
    errs = []
    for target in [0.5, 1.5, 2.5]:
        pair = t_syn.gen_trinomial(10_000, 512, target, rng)
        mask = np.ones(10_000, bool)
        mi = float(t_est.mle_mi(_t(pair.x), _t(pair.y), _t(mask))[0])
        mi_j = float(j_est.mle_mi(jnp.asarray(pair.x), jnp.asarray(pair.y),
                                  jnp.asarray(mask)))
        assert mi == pytest.approx(mi_j, rel=TOL, abs=TOL)
        errs.append(mi - pair.true_mi)
    assert np.sqrt(np.mean(np.square(errs))) < 0.15


@pytest.mark.parametrize("case", ["cdunif-mixed", "cdunif-dc", "trinomial-mixed"])
def test_full_sample_ksg_matches_jax(case):
    """The KSG-family estimators on a full join of generated data: the
    port within 1e-5 of the JAX package, both near the truth."""
    rng = np.random.default_rng(12)
    n_rows = 1500
    if case.startswith("cdunif"):
        pair = t_syn.gen_cdunif(n_rows, 16, rng)
        x = pair.x.astype(np.float32)
        y = pair.y
    else:  # both sides perturbed (the paper's tie-breaking, scale 1e-3)
        pair = t_syn.gen_trinomial(n_rows, 512, 1.0, rng)
        x = (pair.x + rng.normal(scale=1e-3, size=n_rows)).astype(np.float32)
        y = (pair.y + rng.normal(scale=1e-3, size=n_rows)).astype(np.float32)
    mask = np.ones(n_rows, bool)
    if case.endswith("dc"):
        got = float(t_est.dc_ksg_mi(
            t_est.dense_rank(_t(pair.x), _t(mask)), _t(y), _t(mask))[0])
        want = float(j_est.dc_ksg_mi(
            j_est.dense_rank(jnp.asarray(pair.x), jnp.asarray(mask)),
            jnp.asarray(y), jnp.asarray(mask)))
    else:
        got = float(t_est.mixed_ksg_mi(_t(x), _t(y), _t(mask))[0])
        want = float(j_est.mixed_ksg_mi(jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(mask)))
    assert got == pytest.approx(want, rel=TOL, abs=TOL)
    assert got == pytest.approx(pair.true_mi, abs=0.2)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_full_join_takes_the_tiled_body(cuda_device):
    """DC-KSG on a 10,000-row full join (the paper's Section V-B size):
    P = 10,000 reaches radius_counts' tiled body, one launch, and the
    card agrees with the CPU path within 1e-5."""
    from repro_torch.core.estimators import estimate_mi
    from repro_torch.core.join import full_left_join
    from repro_torch.kernels.knn_stats import kernel

    rng = np.random.default_rng(4)
    pair = t_syn.gen_cdunif(10_000, 64, rng)
    train, cand = t_syn.decompose(pair, "keyind", rng)
    fj = full_left_join(train["key_hashes"], train["values"],
                        cand["key_hashes"], cand["values"])
    assert fj.size == 10_000
    assert not kernel.takes_staged(10_000, "class", 3, 3)
    out = {}
    for dev in ("cpu", cuda_device):
        args = [torch.as_tensor(a, device=dev)[None] for a in (fj.x, fj.y, fj.mask)]
        before = (kernel.radius_counts_tiled.launches,
                  kernel.radius_counts_staged.launches)
        out[str(dev)] = float(estimate_mi(*args, x_discrete=True,
                                          y_discrete=False)[0])
        after = (kernel.radius_counts_tiled.launches,
                 kernel.radius_counts_staged.launches)
        if dev != "cpu":
            assert after == (before[0] + 1, before[1])
    assert out["cuda"] == pytest.approx(out["cpu"], rel=TOL, abs=TOL)

"""The port's ``AugmentedTabularPipeline`` and the two ``_torch`` examples
against the JAX package.

The same tables go into ``repro.data.pipeline.AugmentedTabularPipeline``
and ``repro_torch.data.pipeline.AugmentedTabularPipeline`` (on the CPU):
the ranked features (table and column, in order) must be identical, the
feature matrices bit-equal (the joins and the standardization are host
numpy once the ranking agrees), and the ranking MI within rtol/atol 1e-5
(digamma differs between the frameworks by ~2e-6; the names print MI to
three decimals, so those may differ by one in the last digit).
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core import estimators as j_est
from repro.core import hashing
from repro.core import synthetic as j_syn
from repro.core.discovery import SketchIndex as JIndex
from repro.core.join import full_left_join as j_full_join
from repro.core.join import sketch_join as j_sketch_join
from repro.core.sketch import build_sketch as j_build
from repro.data.pipeline import AugmentedTabularPipeline as JPipe
from repro_torch.core.discovery import SketchIndex as TIndex
from repro_torch.core.sketch import build_sketch as t_build
from repro_torch.data.pipeline import AugmentedTabularPipeline as TPipe

TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


def _reference_case(rng):
    """The reference test's data: a strong and a noise feature, shuffled."""
    n = 3000
    keys = hashing.murmur3_32_np(np.arange(n, dtype=np.uint32), seed=np.uint32(2))
    y = rng.normal(size=n).astype(np.float32)
    cols = []
    for name, col in [
        ("good", (y * 2 + 0.1 * rng.normal(size=n)).astype(np.float32)),
        ("noise", rng.normal(size=n).astype(np.float32)),
    ]:
        perm = rng.permutation(n)
        cols.append((name, "v", keys[perm], col[perm], False))
    return keys, y, False, cols, dict(n=128, agg="avg"), dict(top_k=2, min_join=16)


def _mixed_case(rng):
    """Discrete target; candidates of both dtypes, some covering only part
    of the keys (missing values imputed), repeated keys aggregated, more
    joinable candidates than ``top_k``."""
    n = 2500
    keys = hashing.murmur3_32_np(np.arange(n, dtype=np.uint32), seed=np.uint32(5))
    z = rng.normal(size=n)
    y = np.digitize(z, [-0.8, 0.0, 0.8]).astype(np.int64)
    cols = []
    for c in range(7):
        a = c / 7
        v = (a * z + (1 - a) * rng.normal(size=n)).astype(np.float32)
        disc = c % 2 == 0
        if disc:
            v = np.digitize(v, [-0.5, 0.5]).astype(np.int64)
        take = rng.permutation(n)[: n - 400 * (c % 3)]
        kk, vv = keys[take], v[take]
        if c == 3:  # many-to-one: every key twice
            kk, vv = np.concatenate([kk, kk]), np.concatenate([vv, vv])
        cols.append((f"t{c}", f"col{c}", kk, vv, disc))
    return keys, y, True, cols, dict(n=64, agg="first"), dict(top_k=4, min_join=8)


def _build_both(case):
    keys, y, y_disc, cols, index_kw, pipe_kw = case
    j_index = JIndex(**index_kw)
    t_index = TIndex(device="cpu", **index_kw)
    tables = {}
    for table, column, kk, vv, disc in cols:
        j_index.add(table, "k", column, kk, vv, disc)
        t_index.add(table, "k", column, kk, vv, disc)
        tables[(table, column)] = (kk, vv)
    j_pipe = JPipe(index=j_index, tables=tables, **pipe_kw)
    t_pipe = TPipe(index=t_index, tables=tables, **pipe_kw)
    return j_pipe.build(keys, y, y_disc), t_pipe.build(keys, y, y_disc), \
        (j_index, t_index, keys, y, y_disc, index_kw, pipe_kw)


def _split(names):
    parts = [n.split("|mi=") for n in names]
    return [p[0] for p in parts], [float(p[1]) for p in parts]


@pytest.mark.parametrize("make_case", [_reference_case, _mixed_case])
def test_build_matches_jax_pipeline(make_case):
    (xj, nj), (xt, nt), (j_index, t_index, keys, y, y_disc, index_kw,
                         pipe_kw) = _build_both(make_case(np.random.default_rng(0)))
    cols_j, mi_j = _split(nj)
    cols_t, mi_t = _split(nt)
    assert cols_t == cols_j and len(cols_t) > 0
    np.testing.assert_allclose(mi_t, mi_j, atol=1e-3 + 1e-9)
    assert xt.dtype == np.float32 and xt.shape == np.asarray(xj).shape
    np.testing.assert_array_equal(xt, np.asarray(xj))
    # The ranking the pipeline reads: equal tables and join sizes, MI
    # within tolerance.
    kw = dict(n=index_kw["n"], method="tupsk", side="train",
              value_is_discrete=y_disc)
    rj = j_index.query(j_build(keys, y, **kw), **pipe_kw)
    rt = t_index.query(t_build(keys, y, **kw), **pipe_kw)
    assert [(m.table, m.value_column, js) for m, _, js in rt] == \
        [(m.table, m.value_column, js) for m, _, js in rj]
    np.testing.assert_allclose([mi for _, mi, _ in rt], [mi for _, mi, _ in rj],
                               rtol=TOL, atol=TOL)


def test_discovery_to_features():
    """The reference's ``TestAugmentedTabular`` checks, on the port."""
    keys, y, _, cols, index_kw, pipe_kw = _reference_case(np.random.default_rng(0))
    index = TIndex(device="cpu", **index_kw)
    tables = {}
    for table, column, kk, vv, disc in cols:
        index.add(table, "k", column, kk, vv, disc)
        tables[(table, column)] = (kk, vv)
    x, names = TPipe(index=index, tables=tables, **pipe_kw).build(keys, y)
    assert x.shape == (len(y), 2)
    assert "good.v" in names[0]  # strongest MI ranked first
    np.testing.assert_allclose(x.mean(axis=0), 0.0, atol=1e-3)
    np.testing.assert_allclose(x.std(axis=0), 1.0, atol=1e-2)
    assert abs(np.corrcoef(x[:, 0], y)[0, 1]) > 0.95


def test_no_candidate_passes():
    """A ``min_join`` above every join size yields an empty feature
    matrix of the right length, as in the reference."""
    case = _reference_case(np.random.default_rng(1))[:5] \
        + (dict(top_k=2, min_join=10**6),)
    (xj, nj), (xt, nt), _ = _build_both(case)
    assert nt == nj == [] and xt.shape == np.asarray(xj).shape == (3000, 0)


# ---------------------------------------------------------------------------
# The examples
# ---------------------------------------------------------------------------

def _load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_import_neither_jax_nor_reference():
    code = (
        "import importlib.util, os, sys\n"
        "for name in ('quickstart_torch', 'taxi_demand_augmentation_torch',\n"
        "             'train_lm_100m_torch', 'discovery_service_torch'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, os.path.join(sys.argv[1], name + '.py'))\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    assert callable(mod.main)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code, EXAMPLES], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_quickstart_matches_jax_recipe():
    """The quickstart's numbers against the same recipe run through the
    JAX package (the reference example, at a smaller size)."""
    got = _load_example("quickstart_torch").main("cpu", n_rows=4000, m=128)
    rng = np.random.default_rng(0)
    pair = j_syn.gen_trinomial(4000, 128, 2.0, rng)
    train, cand = j_syn.decompose(pair, "keydep", rng)
    st = j_build(train["key_hashes"], train["values"], n=256, side="train")
    sc = j_build(cand["key_hashes"], cand["values"], n=256, side="cand")
    js = j_sketch_join(st, sc)
    fj = j_full_join(train["key_hashes"], train["values"],
                     cand["key_hashes"], cand["values"])

    def mle(j):
        import jax.numpy as jnp
        return float(j_est.estimate_mi(jnp.asarray(j.x), jnp.asarray(j.y),
                                       jnp.asarray(j.mask), x_discrete=True,
                                       y_discrete=True))

    assert got["true_mi"] == pair.true_mi
    assert (got["sketch_join_size"], got["full_join_size"]) == (js.size, fj.size)
    assert got["sketch_mi"] == pytest.approx(mle(js), rel=TOL, abs=TOL)
    assert got["full_mi"] == pytest.approx(mle(fj), rel=TOL, abs=TOL)


def test_taxi_example_on_cpu():
    """The example at its own size: population and a weather column are
    discovered, and augmentation lowers the test MAE (``main`` raises
    otherwise)."""
    out = _load_example("taxi_demand_augmentation_torch").main("cpu")
    cols, _ = _split(out["names"])
    assert "demographics.population" in cols
    assert any(c.startswith("weather.") for c in cols)
    assert out["mae_aug"] < out["mae_base"]

"""Parity of the port's host sketch layer with the JAX package: hashing,
aggregation, the five sketch methods on both sides, and tables.  All of
it is numpy on both sides, so every array is held byte-equal."""

import numpy as np
import pytest

from repro.core import aggregate as j_aggregate
from repro.core import hashing as j_hashing
from repro.core import sketch as j_sketch
from repro.data import tables as j_tables
from repro_torch.core import aggregate as t_aggregate
from repro_torch.core import hashing as t_hashing
from repro_torch.core import sketch as t_sketch
from repro_torch.data import tables as t_tables
from _torch_threads import one_thread  # noqa: F401 (autouse)

RNG = np.random.default_rng(101)


def _keys(n, distinct):
    raw = RNG.integers(0, distinct, size=n).astype(np.uint32)
    return j_hashing.murmur3_32_np(raw, seed=7)


class TestHashing:
    def test_murmur3_and_fibonacci(self):
        k = RNG.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
        seed = RNG.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
        np.testing.assert_array_equal(
            t_hashing.murmur3_32_np(k, seed), j_hashing.murmur3_32_np(k, seed))
        np.testing.assert_array_equal(
            t_hashing.murmur3_32_np(k, 5), j_hashing.murmur3_32_np(k, 5))
        np.testing.assert_array_equal(
            t_hashing.fibonacci32_np(k), j_hashing.fibonacci32_np(k))

    def test_murmur3_matches_jax_vectorized(self):
        """The numpy twin equals the reference's jitted uint32 hash."""
        k = RNG.integers(0, 2**32, size=512, dtype=np.uint64).astype(np.uint32)
        s = RNG.integers(0, 2**32, size=512, dtype=np.uint64).astype(np.uint32)
        np.testing.assert_array_equal(
            t_hashing.murmur3_32_np(k, s), np.asarray(j_hashing.murmur3_32(k, s)))

    @pytest.mark.parametrize("data", [b"", b"a", b"ab", b"abc", b"abcd",
                                      "naïve-ключ".encode(), b"x" * 37])
    def test_murmur3_bytes(self, data):
        for seed in (0, 1, 0xDEADBEEF):
            assert t_hashing.murmur3_bytes(data, seed) == \
                j_hashing.murmur3_bytes(data, seed)

    def test_hash_strings_and_occurrence_index(self):
        vals = np.array([f"k{i % 17}" for i in range(300)])
        np.testing.assert_array_equal(
            t_hashing.hash_strings(vals, 3), j_hashing.hash_strings(vals, 3))
        keys = RNG.integers(0, 20, size=500)
        np.testing.assert_array_equal(
            t_hashing.occurrence_index(keys), j_hashing.occurrence_index(keys))
        assert t_hashing.occurrence_index(np.zeros(0)).shape == (0,)


@pytest.mark.parametrize("agg", sorted(j_aggregate.AGG_FUNCTIONS))
def test_aggregate_by_key(agg):
    keys = _keys(700, 90)
    vals = RNG.normal(size=700).astype(np.float32)
    if agg in ("mode", "first", "min", "max"):
        vals = RNG.integers(0, 6, size=700).astype(np.int64)
    uk, uv = t_aggregate.aggregate_by_key(keys, vals, agg)
    jk, jv = j_aggregate.aggregate_by_key(keys, vals, agg)
    np.testing.assert_array_equal(uk, jk)
    assert uv.dtype == jv.dtype
    np.testing.assert_array_equal(uv, jv)
    for disc in (False, True):
        assert t_aggregate.output_is_discrete(agg, disc) == \
            j_aggregate.output_is_discrete(agg, disc)


@pytest.mark.parametrize("method", j_sketch.SKETCH_METHODS)
@pytest.mark.parametrize("side", ["train", "cand"])
@pytest.mark.parametrize("discrete", [False, True])
def test_build_sketch_byte_equal(method, side, discrete):
    keys = _keys(900, 150)
    if discrete:
        vals = RNG.integers(0, 9, size=900).astype(np.int64)
    else:
        vals = RNG.normal(size=900).astype(np.float32)
    kw = dict(n=64, method=method, side=side, value_is_discrete=discrete)
    if side == "cand":
        kw["agg"] = "first"
    a = t_sketch.build_sketch(keys, vals, **kw)
    b = j_sketch.build_sketch(keys, vals, **kw)
    for field in ("key_hashes", "values", "mask"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        assert x.tobytes() == y.tobytes(), field
    assert (a.method, a.n, a.side, a.value_is_discrete, a.source_rows,
            a.source_distinct_keys) == (b.method, b.n, b.side,
                                        b.value_is_discrete, b.source_rows,
                                        b.source_distinct_keys)
    # The uint32 value view travels zero-extended to int64.
    (af, au), (bf, bu) = a.value_views(), b.value_views()
    assert af.tobytes() == bf.tobytes()
    assert au.dtype == np.int64
    np.testing.assert_array_equal(au, bu.astype(np.int64))


class TestTables:
    @pytest.mark.parametrize("data", [
        np.arange(-50, 250, dtype=np.int64),  # integral, negative included
        np.linspace(-3.5, 7.25, 300),  # non-integral floats
        np.arange(300, dtype=np.float32) - 100.0,  # integral-valued floats
        np.array([-(2**40), -1, 0, 1, 2**40], dtype=np.int64),
    ])
    def test_numeric_key_codes(self, data):
        a = t_tables.Column("k", data).key_codes()
        b = j_tables.Column("k", data).key_codes()
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(a, b)

    def test_string_columns_and_csv(self, tmp_path):
        path = tmp_path / "t.csv"
        path.write_text("key,city,pop\na,x,1.5\nb,y,2\nc,x,3.25\n")
        ta = t_tables.Table.from_csv("t", str(path))
        tb = j_tables.Table.from_csv("t", str(path))
        assert ta.column_names() == tb.column_names()
        for name in ta.column_names():
            assert ta[name].ctype.value == tb[name].ctype.value
            np.testing.assert_array_equal(ta[name].key_codes(),
                                          tb[name].key_codes())
            np.testing.assert_array_equal(ta[name].value_array(),
                                          tb[name].value_array())
        assert list(ta.pairs("key")) == list(tb.pairs("key"))
        with pytest.raises(ValueError):
            t_tables.Table("bad", {"a": np.zeros(2), "b": np.zeros(3)})

"""The port's hashing and ``hash_keys`` against the JAX package, exactly.

The tensor half of ``repro_torch.core.hashing`` (``murmur3_32``,
``fibonacci32``, ``to_unit``, ``combine_key_occurrence``) and
``repro_torch.kernels.murmur3.ops.hash_keys`` (on the CPU: the plain
version in ``ref.py``) are held bit-equal to ``repro``'s functions on the
same seeded words, through the reference's Pallas kernel in interpret
mode (``use_kernel=True``) and its plain path (``use_kernel=False``), and
to the numpy hashes the sketches are built with.  The CUDA kernel is
held against the plain version on the card by the ``cuda``-marked tests
(skipped without a card) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import hashing as j_hash
from repro.kernels.murmur3.ops import hash_keys as j_hash_keys
from repro_torch.core import hashing as t_hash
from repro_torch.core.sketch import build_sketch
from repro_torch.kernels.murmur3 import kernel, ref
from repro_torch.kernels.murmur3.ops import hash_keys
from _torch_threads import one_thread  # noqa: F401 (autouse)

EDGE = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xFFFFFF7F,
                 0xFFFFFF80, 0xFFFFFFC0, 0x00FFFFFF, 0x01000001], np.uint32)
CONSTANTS = [0xCC9E2D51, 0x1B873593, 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9]
USE_KERNEL = pytest.mark.parametrize("use_kernel", [True, False],
                                     ids=["jax_pallas_interpret", "jax_plain"])


def _words(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGE, rng.integers(0, 2**32, size=n, dtype=np.uint32)])


def _j(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("c", CONSTANTS)
def test_mul32_at_the_extreme_words(c):
    """The split multiply: (a * c) mod 2^32 exactly, as Python computes
    it, for the words where an int64 product would overflow."""
    a = torch.tensor([0xFFFFFFFF, 0xFFFF0000, 0x8000_0001, 0xDEADBEEF, 1, 0])
    want = [(int(v) * c) & 0xFFFFFFFF for v in a]
    assert t_hash._mul32(a, c).tolist() == want


@pytest.mark.parametrize("seeds", ["scalar", "per_element"])
def test_murmur3_32_matches_jax_and_numpy(seeds):
    w = _words(4000, seed=1)
    s = 17 if seeds == "scalar" else _words(4000, seed=2)
    ts = s if seeds == "scalar" else torch.from_numpy(s)
    got = t_hash.murmur3_32(torch.from_numpy(w), ts)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _j(j_hash.murmur3_32(
        jnp.asarray(w), s if seeds == "scalar" else jnp.asarray(s))))
    np.testing.assert_array_equal(got.numpy(), t_hash.murmur3_32_np(w, s))


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.uint32])
def test_key_words_of_any_integer_dtype(dtype):
    """Keys are taken as uint32 words (the low 32 bits), as the
    reference's ``astype(uint32)`` takes them."""
    w = np.array([0, 1, -1, -(2**31), 2**31 - 1, 12345], np.int64)
    t = torch.from_numpy(w).to(dtype) if dtype != torch.uint32 \
        else torch.from_numpy((w & 0xFFFFFFFF).astype(np.uint32))
    want = _j(j_hash.murmur3_32(jnp.asarray(w.astype(np.int32)), 5))
    np.testing.assert_array_equal(t_hash.murmur3_32(t, 5).numpy(), want)


def test_fibonacci32_and_to_unit_match_jax_bit_for_bit():
    w = _words(4000, seed=3)
    tw = torch.from_numpy(w)
    np.testing.assert_array_equal(t_hash.fibonacci32(tw).numpy(),
                                  _j(j_hash.fibonacci32(jnp.asarray(w))))
    u = t_hash.to_unit(tw).numpy()
    want = np.asarray(j_hash.to_unit(jnp.asarray(w)))
    assert u.dtype == np.float32 and u.tobytes() == want.tobytes()
    # words near 2^32 round up to 1.0, as in the reference
    assert u[list(EDGE).index(0xFFFFFFFF)] == 1.0
    assert u[list(EDGE).index(0xFFFFFF80)] == 1.0
    assert u[list(EDGE).index(0xFFFFFF7F)] < 1.0


def test_combine_key_occurrence_matches_jax():
    key_hash = _words(3000, seed=4)
    j = np.random.default_rng(5).integers(1, 50, size=key_hash.size)
    got = t_hash.combine_key_occurrence(torch.from_numpy(key_hash),
                                        torch.from_numpy(j))
    want = j_hash.combine_key_occurrence(jnp.asarray(key_hash), jnp.asarray(j))
    np.testing.assert_array_equal(got.numpy(), _j(want))


@USE_KERNEL
@pytest.mark.parametrize("fibonacci", [True, False])
@pytest.mark.parametrize("n", [1, 7, 128, 1000, 32769])
def test_hash_keys_matches_jax(n, fibonacci, use_kernel):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    seeds = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    got = hash_keys(torch.from_numpy(keys), torch.from_numpy(seeds),
                    fibonacci=fibonacci)
    want = j_hash_keys(jnp.asarray(keys), jnp.asarray(seeds),
                       fibonacci=fibonacci, use_kernel=use_kernel)
    np.testing.assert_array_equal(got.numpy(), _j(want))


@USE_KERNEL
def test_hash_keys_scalar_seed_and_edge_words(use_kernel):
    keys = np.concatenate([EDGE, np.arange(5000, dtype=np.uint32)])
    for fib in (True, False):
        got = hash_keys(torch.from_numpy(keys), 17, fibonacci=fib)
        want = j_hash_keys(jnp.asarray(keys), 17, fibonacci=fib,
                           use_kernel=use_kernel)
        np.testing.assert_array_equal(got.numpy(), _j(want))


def test_empty_keys_follow_the_plain_reference():
    """n = 0 gives an empty int64 result, as the reference's plain path
    does; its kernel path cannot take n = 0 (a zero-row grid)."""
    got = hash_keys(torch.zeros(0, dtype=torch.int64), 3)
    want = j_hash_keys(jnp.zeros(0, jnp.uint32), 3, use_kernel=False)
    assert got.shape == (0,) and got.dtype == torch.int64
    assert np.asarray(want).shape == (0,)


def test_hash_keys_matches_host_pipeline():
    """The numpy ingestion-path hashes: the key hash, and the TUPSK
    tuple-key re-hash and rank the sketches are built from."""
    raw = _words(2048, seed=6)
    key_hash = t_hash.murmur3_32_np(raw, seed=np.uint32(9))
    got = hash_keys(torch.from_numpy(raw), 9, fibonacci=False)
    np.testing.assert_array_equal(got.numpy(), key_hash)
    np.testing.assert_array_equal(
        hash_keys(torch.from_numpy(raw), 9).numpy(),
        t_hash.fibonacci32_np(key_hash))
    j = t_hash.occurrence_index(key_hash % 97)  # repeated keys: j > 1
    tuple_h = hash_keys(torch.from_numpy(j), torch.from_numpy(key_hash % 97),
                        fibonacci=False)
    np.testing.assert_array_equal(tuple_h.numpy(), t_hash.murmur3_32_np(
        j.astype(np.uint32), seed=key_hash % 97))


def test_hash_keys_gives_tupsk_ranks_of_a_sketch():
    """A TUPSK train sketch keeps the n rows of smallest
    ``hash_keys(j, key_hash)`` rank."""
    rng = np.random.default_rng(7)
    key_hash = t_hash.murmur3_32_np(rng.integers(0, 60, size=400).astype(np.uint32))
    values = rng.normal(size=400).astype(np.float32)
    j = t_hash.occurrence_index(key_hash)
    ranks = hash_keys(torch.from_numpy(j), torch.from_numpy(key_hash)).numpy()
    sk = build_sketch(key_hash, values, n=64, side="train",
                      value_is_discrete=False)
    kept = values[np.argsort(ranks, kind="stable")[:64]]
    np.testing.assert_array_equal(np.sort(sk.values[sk.mask]), np.sort(kept))


def test_hash_keys_shape_and_devices():
    keys = torch.arange(12).reshape(3, 4)
    got = hash_keys(keys, torch.tensor(5))
    assert got.shape == (3, 4)
    assert torch.equal(got.reshape(-1), hash_keys(torch.arange(12), 5))
    with pytest.raises(ValueError, match="implementation for meta"):
        hash_keys(torch.zeros(4, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="seeds lie on"):
        hash_keys(torch.zeros(4, dtype=torch.int64, device="meta"),
                  torch.zeros(4, dtype=torch.int64))


def test_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kernel.murmur3_fib(torch.zeros(4, dtype=torch.int64), None, 0,
                           fibonacci=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fibonacci", [True, False])
@pytest.mark.parametrize("n", [0, 1, 127, 32769, 1 << 20])
def test_cuda_kernel_matches_plain(cuda_device, n, fibonacci):
    """On the card: bit-equal to the plain version, scalar and
    per-element seeds; one launch each (none for n = 0)."""
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(0, 2**32, size=n)).to(cuda_device)
    seeds = torch.from_numpy(rng.integers(0, 2**32, size=n)).to(cuda_device)
    before = kernel.murmur3_fib.launches
    for s in (seeds, 0xFFFFFFFF):
        got = hash_keys(keys, s, fibonacci=fibonacci)
        want = ref.murmur3_fib_ref(keys, s, fibonacci=fibonacci)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert kernel.murmur3_fib.launches == before + (2 if n else 0)

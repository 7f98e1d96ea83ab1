"""Hashing primitives for coordinated sampling sketches.

The port's own copy of ``repro.core.hashing`` (the reference's module
imports jax at top level, so the port never imports it): a numpy half
that sketches are built with on the host, and a tensor half
(:func:`murmur3_32`, :func:`fibonacci32`, :func:`to_unit`,
:func:`combine_key_occurrence`) that runs on any device and is the plain
version of the ``murmur3`` kernel.

  * ``h``   — MurmurHash3 (x86, 32-bit): :func:`murmur3_32_np` over one
    uint32 word with a per-element seed, :func:`murmur3_bytes` over a
    byte string (string join keys), :func:`hash_strings` for arrays.
  * ``h_u`` — Fibonacci (Knuth multiplicative) hashing kept as a raw
    uint32 (:func:`fibonacci32_np`), so min-value selection is exact
    integer arithmetic.

Tensor words follow the port's uint32 rule: a uint32 word is carried as
int64, zero-extended, because torch has no uint32 shift on the CPU.
Every multiply, add and left shift is masked back to 32 bits, and a
multiply by a 32-bit constant is split into 16-bit halves so that no
int64 product overflows.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "murmur3_32",
    "murmur3_32_np",
    "fibonacci32",
    "fibonacci32_np",
    "to_unit",
    "murmur3_bytes",
    "hash_strings",
    "occurrence_index",
    "combine_key_occurrence",
]

# MurmurHash3 x86/32 constants.
_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)
_MIX1 = np.uint32(0x85EBCA6B)
_MIX2 = np.uint32(0xC2B2AE35)
_M5 = np.uint32(5)
_N = np.uint32(0xE6546B64)

# Knuth's multiplicative constant: floor(2^32 / phi), odd.
_FIB32 = np.uint32(0x9E3779B9)

_MASK = 0xFFFFFFFF


def _word(v) -> torch.Tensor:
    """Any integer tensor (or Python int) as uint32 words in int64: the
    low 32 bits, zero-extended, as the reference's ``astype(uint32)``."""
    return torch.as_tensor(v).to(torch.int64) & _MASK


def _mul32(a: torch.Tensor, c) -> torch.Tensor:
    """(a * c) mod 2^32 for words a and a 32-bit constant c, in int64
    without overflow: each half-product stays below 2^48."""
    c = int(c)
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def murmur3_32(key, seed=0) -> torch.Tensor:
    """MurmurHash3 (x86, 32-bit) of one uint32 word per element.

    ``key`` is any integer tensor, taken as uint32 words; ``seed`` a
    Python int or a tensor broadcastable to ``key`` (per-element seeds
    combine a key hash with an occurrence index, see
    :func:`combine_key_occurrence`).  Returns int64 words in [0, 2^32)
    on ``key``'s device, bit-equal to :func:`murmur3_32_np`.
    """
    k = _word(key)
    h = torch.broadcast_to(_word(seed).to(k.device), k.shape)

    k = _mul32(k, _C1)
    k = _rotl32(k, 15)
    k = _mul32(k, _C2)

    h = h ^ k
    h = _rotl32(h, 13)
    h = (h * int(_M5) + int(_N)) & _MASK

    # Finalization (length = 4 bytes).
    h = h ^ 4
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX2)
    return h ^ (h >> 16)


def fibonacci32(h) -> torch.Tensor:
    """Fibonacci (multiplicative) hashing of uint32 words, as int64 words:
    order-isomorphic to the unit-range value ``h / 2**32``."""
    return _mul32(_word(h), _FIB32)


def to_unit(h) -> torch.Tensor:
    """A uint32 word as a float32 in [0, 1]: the word rounded to float32
    (to nearest, so words near 2^32 round up to 1.0, as in the
    reference), times 2^-32."""
    return _word(h).to(torch.float32) * (2.0 ** -32)


def combine_key_occurrence(key_hash, j) -> torch.Tensor:
    """Hash of the derived TUPSK tuple-key <k, j>:
    ``murmur3_32(j, seed=h(k))``."""
    return murmur3_32(j, seed=key_hash)


def murmur3_32_np(key: np.ndarray, seed: np.ndarray | int = 0) -> np.ndarray:
    """MurmurHash3 (x86, 32-bit) of a single uint32 word per element.

    Matches the reference implementation for a 4-byte little-endian
    input; ``seed`` may be a scalar or an array broadcastable to ``key``.
    """
    with np.errstate(over="ignore"):
        k = np.asarray(key).astype(np.uint32)
        h = np.broadcast_to(np.asarray(seed).astype(np.uint32), k.shape).copy()
        k = k * _C1
        k = (k << np.uint32(15)) | (k >> np.uint32(17))
        k = k * _C2
        h ^= k
        h = (h << np.uint32(13)) | (h >> np.uint32(19))
        h = h * _M5 + _N
        h ^= np.uint32(4)
        h ^= h >> np.uint32(16)
        h = h * _MIX1
        h ^= h >> np.uint32(13)
        h = h * _MIX2
        h ^= h >> np.uint32(16)
    return h


def fibonacci32_np(h: np.ndarray) -> np.ndarray:
    """Fibonacci hashing uint32 -> uint32 (order-isomorphic to h/2**32)."""
    with np.errstate(over="ignore"):
        return np.asarray(h).astype(np.uint32) * _FIB32


def murmur3_bytes(data: bytes, seed: int = 0) -> int:
    """Reference MurmurHash3 (x86, 32-bit) over a byte string."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    length = len(data)
    h = seed & 0xFFFFFFFF
    rounded = length & ~0x3
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= length
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def hash_strings(values: np.ndarray, seed: int = 0) -> np.ndarray:
    """Hash an array of strings/bytes to uint32 codes, one Python-level
    hash per *distinct* value broadcast through an inverse index."""
    values = np.asarray(values)
    uniq, inv = np.unique(values, return_inverse=True)
    codes = np.empty(len(uniq), dtype=np.uint32)
    for i, v in enumerate(uniq):
        b = v if isinstance(v, bytes) else str(v).encode("utf-8")
        codes[i] = murmur3_bytes(b, seed)
    return codes[inv]


def occurrence_index(keys: np.ndarray) -> np.ndarray:
    """1-based occurrence index j of each key value, in sequence order:
    the <k, j> tuple-key derivation TUPSK samples on."""
    keys = np.asarray(keys)
    n = len(keys)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    new_run = np.empty(n, dtype=bool)
    new_run[0] = True
    new_run[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_id = np.cumsum(new_run) - 1
    run_start = np.flatnonzero(new_run)
    j_sorted = np.arange(n, dtype=np.int64) - run_start[run_id] + 1
    j = np.empty(n, dtype=np.int64)
    j[order] = j_sorted
    return j

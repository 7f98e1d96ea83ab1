"""Host-side hashing primitives for coordinated sampling sketches.

The numpy half of ``repro.core.hashing``, kept here so the port never
imports the reference (whose module imports jax at top level).

  * ``h``   — MurmurHash3 (x86, 32-bit): :func:`murmur3_32_np` over one
    uint32 word with a per-element seed, :func:`murmur3_bytes` over a
    byte string (string join keys), :func:`hash_strings` for arrays.
  * ``h_u`` — Fibonacci (Knuth multiplicative) hashing kept as a raw
    uint32 (:func:`fibonacci32_np`), so min-value selection is exact
    integer arithmetic.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "murmur3_32_np",
    "fibonacci32_np",
    "murmur3_bytes",
    "hash_strings",
    "occurrence_index",
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

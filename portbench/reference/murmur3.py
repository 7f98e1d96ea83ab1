"""Frozen MurmurHash3 (x86, 32-bit) of one uint32 word, and Fibonacci
hashing, in plain PyTorch.

Words travel as int64 tensors holding uint32 values, so every product
is split into 16-bit halves to stay inside 63 bits.  This is the hash of
MurmurHash3_x86_32 over the word's four little-endian bytes; the
benchmark keys its lakes with it and the reference rebuilds the TUPSK
ranks with it, independently of the program's own hashing.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
C1, C2 = 0xCC9E2D51, 0x1B873593
MIX1, MIX2 = 0x85EBCA6B, 0xC2B2AE35
FIB32 = 0x9E3779B9  # floor(2^32 / phi), odd


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for uint32 words a held in int64."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & MASK


def rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def murmur3_32(key: torch.Tensor, seed) -> torch.Tensor:
    """MurmurHash3_x86_32 of one 4-byte word per element; ``seed`` is an
    int or a tensor broadcastable to ``key``."""
    k = key.to(torch.int64) & MASK
    h = torch.as_tensor(seed, dtype=torch.int64, device=k.device) & MASK
    h = h.expand_as(k)
    k = mul32(rotl32(mul32(k, C1), 15), C2)
    h = rotl32(h ^ k, 13)
    h = (mul32(h, 5) + 0xE6546B64) & MASK
    h = h ^ 4
    h = h ^ (h >> 16)
    h = mul32(h, MIX1)
    h = h ^ (h >> 13)
    h = mul32(h, MIX2)
    return h ^ (h >> 16)


def fibonacci32(h: torch.Tensor) -> torch.Tensor:
    """Fibonacci hashing of uint32 words: (h * FIB32) mod 2^32."""
    return mul32(h, FIB32)

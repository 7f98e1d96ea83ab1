"""Plain PyTorch murmur3(+Fibonacci): the CPU path and the kernel's
oracle, built from the tensor half of :mod:`repro_torch.core.hashing` as
``repro.kernels.murmur3.ref`` is built from ``repro.core.hashing``."""

from __future__ import annotations

import torch

from repro_torch.core import hashing

__all__ = ["murmur3_fib_ref"]


def murmur3_fib_ref(keys: torch.Tensor, seeds, *,
                    fibonacci: bool = True) -> torch.Tensor:
    """MurmurHash3 of each key word with its seed (a Python int or a
    tensor broadcastable to ``keys``), then optionally Fibonacci
    hashing; int64 words in [0, 2^32)."""
    h = hashing.murmur3_32(keys, seed=seeds)
    return hashing.fibonacci32(h) if fibonacci else h

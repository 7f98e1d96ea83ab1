"""Fused MurmurHash3 + Fibonacci hashing of uint32 key words.

``ops.py`` is the public entry, ``ref.py`` the plain PyTorch version,
``kernel.py`` the ctypes binding of ``csrc/murmur3_fib.cu``.
"""

from repro_torch.kernels.murmur3.ops import hash_keys

__all__ = ["hash_keys"]

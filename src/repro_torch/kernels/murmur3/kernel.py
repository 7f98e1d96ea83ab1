"""CUDA binding of the fused murmur3 + Fibonacci kernel
(``csrc/murmur3_fib.cu``).

The source is built at first use by :mod:`repro_torch.kernels._build`
(``nvcc`` for ``sm_90a`` into ``build/kernels/``, loaded with ``ctypes``).
A failed build raises; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import BuiltLibrary, build

__all__ = ["SOURCE", "load_library", "murmur3_fib"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "murmur3_fib.cu"


@functools.lru_cache(maxsize=None)
def load_library() -> BuiltLibrary:
    """Build (once per source version) and load the kernel library."""
    built = build(SOURCE)
    fn = built.lib.murmur3_fib_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return built


def murmur3_fib(keys: torch.Tensor, seeds: torch.Tensor | None, seed: int = 0,
                *, fibonacci: bool) -> torch.Tensor:
    """Launch the kernel on n key words: the same contract as
    ``ref.murmur3_fib_ref``.  ``keys`` is int64 (n,) holding uint32 words,
    contiguous on a CUDA device; ``seeds`` is int64 (n,) on the same
    device, or None to hash every key with the scalar ``seed``.  Returns
    int64 (n,) words in [0, 2^32).  ``murmur3_fib.launches`` counts the
    launches."""
    if keys.device.type != "cuda":
        raise ValueError(f"murmur3_fib kernel needs CUDA tensors, got {keys.device}")
    if keys.dim() != 1 or keys.dtype != torch.int64 or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous int64 (n,) tensor")
    if seeds is not None and (seeds.shape != keys.shape or seeds.dtype != torch.int64
                              or not seeds.is_contiguous()
                              or seeds.device != keys.device):
        raise ValueError("seeds must be a contiguous int64 tensor shaped and "
                         "placed as keys")
    built = load_library()
    n = keys.numel()
    out = torch.empty_like(keys)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = built.lib.murmur3_fib_launch(
            keys.data_ptr(), 0 if seeds is None else seeds.data_ptr(),
            int(seed) & 0xFFFFFFFF, n, int(fibonacci), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"murmur3_fib launch failed: CUDA error {err}")
    if n:  # the C entry launches nothing for no keys
        murmur3_fib.launches += 1
    return out


murmur3_fib.launches = 0

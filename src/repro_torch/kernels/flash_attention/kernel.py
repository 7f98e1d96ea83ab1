"""CUDA binding of the flash attention kernel (``csrc/flash_attention.cu``).

The source is built at first use by :mod:`repro_torch.kernels._build`
(``nvcc`` for ``sm_90a`` into ``build/kernels/``, loaded with ``ctypes``).
A failed build or launch raises; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import BuiltLibrary, build

__all__ = ["SOURCE", "MAX_HEAD_DIM", "load_library", "flash_attention"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


@functools.lru_cache(maxsize=None)
def load_library() -> BuiltLibrary:
    """Build (once per source version) and load the kernel library."""
    built = build(SOURCE)
    fn = built.lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_int64] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return built


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True) -> torch.Tensor:
    """Launch the kernel: the contract of ``ref.chunked_attention``.

    q (B, Hq, S, Dk), k (B, Hkv, S, Dk), v (B, Hkv, S, Dv), one CUDA
    device, one dtype (float32, float16 or bfloat16), Hq a multiple of
    Hkv, Dk and Dv multiples of 8 up to 256, the last axis contiguous
    (any strides elsewhere).  Returns a contiguous (B, Hq, S, Dv) tensor
    in q's dtype.  ``flash_attention.launches`` counts the launches.
    """
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(_DTYPES)}: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    B, Hq, S, Dk = q.shape
    Hkv, Dv = k.shape[1], v.shape[-1]
    if (k.shape != (B, Hkv, S, Dk) or v.shape[:3] != (B, Hkv, S)
            or Hkv == 0 or Hq % Hkv):
        raise ValueError(f"shapes do not agree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, d in (("Dk", Dk), ("Dv", Dv)):
        if d <= 0 or d > MAX_HEAD_DIM or d % 8:
            raise ValueError(f"{name}={d}: the kernel takes multiples of 8 "
                             f"up to {MAX_HEAD_DIM}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the last axis of q, k, v must be contiguous")
    if B > 65535 or Hq > 65535 or S >= 2**31:
        raise ValueError(f"B={B}, Hq={Hq}, S={S} exceed the kernel's grid")
    built = load_library()
    out = torch.empty((B, Hq, S, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = built.lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Hq, Hkv, S, Dk, Dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

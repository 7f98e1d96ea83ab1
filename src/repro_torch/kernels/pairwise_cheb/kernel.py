"""CUDA binding of the pairwise Chebyshev kernel (``csrc/pairwise_cheb.cu``).

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

__all__ = ["SOURCE", "load_library", "pairwise_cheb"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "pairwise_cheb.cu"


@functools.lru_cache(maxsize=None)
def load_library() -> BuiltLibrary:
    """Build (once per source version) and load the kernel library."""
    built = build(SOURCE)
    fn = built.lib.pairwise_cheb_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return built


def pairwise_cheb(
    x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on B samples: the same contract as
    ``ref.pairwise_cheb`` (x, y float32 (B, P), mask bool (B, P), all
    contiguous on one CUDA device).  Returns (DX, DY, DJ), each float32
    (B, P, P).  ``pairwise_cheb.launches`` counts the launches."""
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_cheb kernel needs CUDA tensors, got {x.device}")
    if x.dim() != 2 or x.shape != y.shape or x.shape != mask.shape:
        raise ValueError(
            f"x, y, mask must share one (B, P) shape: "
            f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(mask.shape)}"
        )
    if x.dtype != torch.float32 or y.dtype != torch.float32 \
            or mask.dtype != torch.bool:
        raise TypeError("x, y must be float32 and mask bool")
    if not (x.is_contiguous() and y.is_contiguous() and mask.is_contiguous()):
        raise ValueError("x, y, mask must be contiguous")
    if y.device != x.device or mask.device != x.device:
        raise ValueError("x, y, mask must lie on one device")
    B, P = x.shape
    if B >= 2**31:
        raise ValueError(f"B={B} exceeds the kernel's grid range")
    built = load_library()
    out = [torch.empty((B, P, P), dtype=torch.float32, device=x.device)
           for _ in range(3)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = built.lib.pairwise_cheb_launch(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), B, P,
            *(o.data_ptr() for o in out), stream,
        )
    if err != 0:
        raise RuntimeError(f"pairwise_cheb launch failed: CUDA error {err}")
    if B * P:  # the C entry launches nothing for an empty batch
        pairwise_cheb.launches += 1
    return out[0], out[1], out[2]


pairwise_cheb.launches = 0

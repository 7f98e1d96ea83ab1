"""CUDA binding of the fused radius+count kernel (``csrc/radius_counts.cu``).

The source is built at first use by :mod:`repro_torch.kernels._build`
(``nvcc`` for ``sm_90a`` into ``build/kernels/``, loaded with ``ctypes``).
A failed build raises; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import BuiltLibrary, build, find_nvcc

__all__ = ["SOURCE", "BuiltLibrary", "find_nvcc", "load_library", "radius_counts"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "radius_counts.cu"


@functools.lru_cache(maxsize=None)
def load_library() -> BuiltLibrary:
    """Build (once per source version) and load the kernel library."""
    built = build(SOURCE)
    fn = built.lib.radius_counts_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4
    )
    fn.restype = ctypes.c_int
    return built


def radius_counts(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    *,
    k: int,
    kb: int,
    kk: int,
    mode: str,
    which: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on B samples: the same contract as
    ``ref.radius_counts`` (x, y float32 (B, P), mask bool (B, P), all
    contiguous on one CUDA device).  Returns (r (B, P) float32, cnt
    (B, P) int32, counts (5, B, P) int32).  ``radius_counts.launches``
    counts the launches.  Only what protects the foreign call is checked
    here; parameter ranges are ``ops.knn_radius_counts``'s to check."""
    if x.device.type != "cuda":
        raise ValueError(f"radius_counts kernel needs CUDA tensors, got {x.device}")
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
    if B * P >= 2**31:
        raise ValueError(f"B*P={B * P} exceeds the kernel's int32 range")
    built = load_library()
    r = torch.empty((B, P), dtype=torch.float32, device=x.device)
    cnt = torch.empty((B, P), dtype=torch.int32, device=x.device)
    counts = torch.empty((5, B, P), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = built.lib.radius_counts_launch(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), B, P, int(k),
            int(kb), int(kk), int(mode == "joint"), int(which == "all"),
            r.data_ptr(), cnt.data_ptr(), counts.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"radius_counts launch failed: CUDA error {err}")
    if B * P:  # the C entry launches nothing for an empty batch
        radius_counts.launches += 1
    return r, cnt, counts


radius_counts.launches = 0

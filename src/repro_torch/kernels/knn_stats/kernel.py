"""CUDA bindings of the kNN-statistics kernels: the fused radius+count
kernel (``csrc/radius_counts.cu``) and the two-op kernels ``knn_smallest``
and ``ball_counts`` (``csrc/knn_two_op.cu``).

Each source is built at first use by :mod:`repro_torch.kernels._build`
(``nvcc`` for ``sm_90a`` into ``build/kernels/``, loaded with ``ctypes``).
A failed build raises; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import BuiltLibrary, build, find_nvcc

__all__ = ["SOURCE", "TWO_OP_SOURCE", "BuiltLibrary", "ball_counts",
           "find_nvcc", "knn_smallest", "load_library", "load_two_op_library",
           "radius_counts"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "radius_counts.cu"
TWO_OP_SOURCE = Path(__file__).resolve().parent / "csrc" / "knn_two_op.cu"


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


@functools.lru_cache(maxsize=None)
def load_two_op_library() -> BuiltLibrary:
    """Build (once per source version) and load the two-op library."""
    built = build(TWO_OP_SOURCE)
    fn = built.lib.knn_smallest_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    fn = built.lib.ball_counts_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return built


def _check_batch(name: str, x, y, mask, *extra) -> tuple[int, int]:
    """What protects the foreign call: x, y (and each of ``extra``)
    float32, mask bool, all (B, P), contiguous, on one CUDA device.
    Parameter ranges are ``ops``'s to check."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {x.device}")
    floats = (x, y) + extra
    if x.dim() != 2 or any(t.shape != x.shape for t in floats + (mask,)):
        raise ValueError(
            f"x, y, mask must share one (B, P) shape: "
            f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(mask.shape)}"
        )
    if any(t.dtype != torch.float32 for t in floats) or mask.dtype != torch.bool:
        raise TypeError("x, y must be float32 and mask bool")
    if not all(t.is_contiguous() for t in floats + (mask,)):
        raise ValueError("x, y, mask must be contiguous")
    if any(t.device != x.device for t in floats + (mask,)):
        raise ValueError("x, y, mask must lie on one device")
    B, P = x.shape
    if B * P >= 2**31:
        raise ValueError(f"B*P={B * P} exceeds the kernel's int32 range")
    return B, P


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


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
    counts the launches."""
    B, P = _check_batch("radius_counts", x, y, mask)
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
    _raise_on("radius_counts", err)
    if B * P:  # the C entry launches nothing for an empty batch
        radius_counts.launches += 1
    return r, cnt, counts


radius_counts.launches = 0


def knn_smallest(
    x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, *, kb: int, mode: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on B samples: the same contract as
    ``ref.knn_smallest``.  Returns (knn (B, P, kb) float32, cnt (B, P)
    int32).  ``knn_smallest.launches`` counts the launches."""
    B, P = _check_batch("knn_smallest", x, y, mask)
    built = load_two_op_library()
    knn = torch.empty((B, P, kb), dtype=torch.float32, device=x.device)
    cnt = torch.empty((B, P), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = built.lib.knn_smallest_launch(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), B, P, int(kb),
            int(mode == "joint"), knn.data_ptr(), cnt.data_ptr(), stream,
        )
    _raise_on("knn_smallest", err)
    if B * P:
        knn_smallest.launches += 1
    return knn, cnt


knn_smallest.launches = 0


def ball_counts(
    x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, r: torch.Tensor, *,
    which: str,
) -> torch.Tensor:
    """Launch the kernel on B samples: the same contract as
    ``ref.ball_counts`` (r float32 (B, P) like y).  Returns counts (5, B,
    P) int32; ``which="y"`` launches the variant that never reads x (its
    pointer is not passed).  ``ball_counts.launches`` counts the
    launches."""
    B, P = _check_batch("ball_counts", x, y, mask, r)
    built = load_two_op_library()
    counts = torch.empty((5, B, P), dtype=torch.int32, device=x.device)
    every = which == "all"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = built.lib.ball_counts_launch(
            x.data_ptr() if every else None, y.data_ptr(), mask.data_ptr(),
            r.data_ptr(), B, P, int(every), counts.data_ptr(), stream,
        )
    _raise_on("ball_counts", err)
    if B * P:
        ball_counts.launches += 1
    return counts


ball_counts.launches = 0

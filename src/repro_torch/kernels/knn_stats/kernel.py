"""CUDA bindings of the kNN-statistics kernels: the fused radius+count
kernel (``csrc/radius_counts.cu``, two bodies) and the two-op kernels
``knn_smallest`` and ``ball_counts`` (``csrc/knn_two_op.cu``).

:func:`radius_counts` sends each call to one body of the fused kernel by
a fixed rule on its parameters (:func:`takes_staged`): the staged body
(:func:`radius_counts_staged`: one warp a sample, its valid columns
sorted by x in shared memory, selection along the sorted order) or the
tiled body (:func:`radius_counts_tiled`: column tiles, one row a thread,
any P and buffers up to ``K_MAX``).  Both are bit-equal to
``ref.radius_counts``.

Each source is built at first use by :mod:`repro_torch.kernels._build`
(``nvcc`` for ``sm_90a`` into ``build/kernels/``, loaded with ``ctypes``).
A failed build or launch raises; nothing falls back to another body or
to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import BuiltLibrary, build, find_nvcc

__all__ = ["SOURCE", "STAGED_MAX_P", "STAGED_MAX_W", "TWO_OP_SOURCE",
           "BuiltLibrary", "ball_counts", "find_nvcc", "knn_smallest",
           "load_library", "load_two_op_library", "radius_counts",
           "radius_counts_staged", "radius_counts_tiled", "takes_staged"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "radius_counts.cu"
TWO_OP_SOURCE = Path(__file__).resolve().parent / "csrc" / "knn_two_op.cu"

# The staged body's range (radius_counts.cu, staged::kMaxP / kMaxW): the
# whole sample in one warp's shared memory, and a register buffer of at
# most 16 lanes.
STAGED_MAX_P = 1024
STAGED_MAX_W = 16


@functools.lru_cache(maxsize=None)
def load_library() -> BuiltLibrary:
    """Build (once per source version) and load the kernel library (both
    bodies' entries)."""
    built = build(SOURCE)
    for name in ("radius_counts_launch", "radius_counts_tiled_launch"):
        fn = getattr(built.lib, name)
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


def takes_staged(P: int, mode: str, k: int, kb: int) -> bool:
    """The dispatch rule of :func:`radius_counts`: the staged body when
    the sample fits one warp's shared memory (``P <= STAGED_MAX_P``) and
    the buffer of the ``need`` smallest distances fits its registers
    (``need <= STAGED_MAX_W``, need = k in joint mode, kb in class mode);
    the tiled body otherwise."""
    need = k if mode == "joint" else kb
    return P <= STAGED_MAX_P and need <= STAGED_MAX_W


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
    (B, P) int32, counts (5, B, P) int32).  The body is the one
    :func:`takes_staged` names; ``radius_counts.launches`` counts the
    launches of both, each body's own ``launches`` its own."""
    if x.device.type != "cuda":
        raise ValueError(f"radius_counts kernel needs CUDA tensors, got {x.device}")
    body = (radius_counts_staged if takes_staged(x.shape[-1], mode, k, kb)
            else radius_counts_tiled)
    out = body(x, y, mask, k=k, kb=kb, kk=kk, mode=mode, which=which)
    if x.numel():  # the C entries launch nothing for an empty batch
        radius_counts.launches += 1
    return out


def _launch_rc(entry: str, x, y, mask, k, kb, kk, mode, which):
    B, P = _check_batch("radius_counts", x, y, mask)
    built = load_library()
    r = torch.empty((B, P), dtype=torch.float32, device=x.device)
    cnt = torch.empty((B, P), dtype=torch.int32, device=x.device)
    counts = torch.empty((5, B, P), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(built.lib, entry)(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), B, P, int(k),
            int(kb), int(kk), int(mode == "joint"), int(which == "all"),
            r.data_ptr(), cnt.data_ptr(), counts.data_ptr(), stream,
        )
    _raise_on(entry, err)
    return (r, cnt, counts), int(B * P > 0)


def radius_counts_staged(x, y, mask, *, k, kb, kk, mode, which):
    """The staged body (``radius_counts_launch``): the contract of
    :func:`radius_counts` within :func:`takes_staged`'s range (outside it
    the launch is refused and this raises).
    ``radius_counts_staged.launches`` counts its launches."""
    out, launched = _launch_rc("radius_counts_launch", x, y, mask, k, kb, kk,
                               mode, which)
    radius_counts_staged.launches += launched
    return out


def radius_counts_tiled(x, y, mask, *, k, kb, kk, mode, which):
    """The tiled body (``radius_counts_tiled_launch``): the contract of
    :func:`radius_counts` for any P and kb up to ``K_MAX``.
    ``radius_counts_tiled.launches`` counts its launches."""
    out, launched = _launch_rc("radius_counts_tiled_launch", x, y, mask, k,
                               kb, kk, mode, which)
    radius_counts_tiled.launches += launched
    return out


radius_counts.launches = 0
radius_counts_staged.launches = 0
radius_counts_tiled.launches = 0


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

"""CUDA bindings of the kNN-statistics kernels: the fused radius+count
kernel (``csrc/radius_counts.cu``, two bodies) and the two-op kernels
``knn_smallest`` and ``ball_counts`` (``csrc/knn_two_op.cu``, two bodies
each).

:func:`radius_counts` sends each call to one body of the fused kernel by
a fixed rule on its parameters (:func:`takes_staged`): the staged body
(:func:`radius_counts_staged`: one warp a sample, its valid columns
sorted by x in shared memory, selection along the sorted order) or the
tiled body (:func:`radius_counts_tiled`: column tiles, one row a thread,
any P and buffers up to ``K_MAX``).  Both are bit-equal to
``ref.radius_counts``.  :func:`knn_smallest` and :func:`ball_counts` are
sent the same way (:func:`takes_staged_two_op`): to a staged body (one
warp a sample, sorted by value, selection and counts along the sorted
orders) or to a tiled body (one row a thread over column tiles), each
bit-equal to its ``ref`` function.

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
           "TWO_OP_STAGED_MAX_KB", "TWO_OP_STAGED_MAX_P", "BuiltLibrary",
           "ball_counts", "ball_counts_staged", "ball_counts_tiled",
           "find_nvcc", "knn_smallest", "knn_smallest_staged",
           "knn_smallest_tiled", "load_library", "load_two_op_library",
           "radius_counts", "radius_counts_staged", "radius_counts_tiled",
           "takes_staged", "takes_staged_two_op"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "radius_counts.cu"
TWO_OP_SOURCE = Path(__file__).resolve().parent / "csrc" / "knn_two_op.cu"

# The staged body's range (radius_counts.cu, staged::kMaxP / kMaxW): the
# whole sample in one warp's shared memory, and a register buffer of at
# most 16 lanes.
STAGED_MAX_P = 1024
STAGED_MAX_W = 16
# The two-op staged bodies' range (knn_two_op.cu, staged::kMaxP / kMaxKb):
# the whole sample in one warp's shared memory, and at most 16 kNN lanes.
TWO_OP_STAGED_MAX_P = 1024
TWO_OP_STAGED_MAX_KB = 16


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
    """Build (once per source version) and load the two-op library (both
    bodies' entries of each op)."""
    built = build(TWO_OP_SOURCE)
    for name in ("knn_smallest_launch", "knn_smallest_tiled_launch"):
        fn = getattr(built.lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    for name in ("ball_counts_launch", "ball_counts_tiled_launch"):
        fn = getattr(built.lib, name)
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


def takes_staged_two_op(P: int, kb: int = 1) -> bool:
    """The dispatch rule of :func:`knn_smallest` and :func:`ball_counts`:
    the staged body when the sample fits one warp's shared memory
    (``P <= TWO_OP_STAGED_MAX_P``) and, for ``knn_smallest``, the kb lanes
    fit its buffer (``kb <= TWO_OP_STAGED_MAX_KB``; ``ball_counts`` has no
    kb); the tiled body otherwise."""
    return P <= TWO_OP_STAGED_MAX_P and kb <= TWO_OP_STAGED_MAX_KB


def knn_smallest(
    x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, *, kb: int, mode: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on B samples: the same contract as
    ``ref.knn_smallest``.  Returns (knn (B, P, kb) float32, cnt (B, P)
    int32).  The body is the one :func:`takes_staged_two_op` names;
    ``knn_smallest.launches`` counts the launches of both, each body's own
    ``launches`` its own."""
    if x.device.type != "cuda":
        raise ValueError(f"knn_smallest kernel needs CUDA tensors, got {x.device}")
    body = (knn_smallest_staged if takes_staged_two_op(x.shape[-1], kb)
            else knn_smallest_tiled)
    out = body(x, y, mask, kb=kb, mode=mode)
    if x.numel():  # the C entries launch nothing for an empty batch
        knn_smallest.launches += 1
    return out


def _launch_knn(entry: str, x, y, mask, kb, mode):
    B, P = _check_batch("knn_smallest", x, y, mask)
    built = load_two_op_library()
    knn = torch.empty((B, P, kb), dtype=torch.float32, device=x.device)
    cnt = torch.empty((B, P), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(built.lib, entry)(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), B, P, int(kb),
            int(mode == "joint"), knn.data_ptr(), cnt.data_ptr(), stream,
        )
    _raise_on(entry, err)
    return (knn, cnt), int(B * P > 0)


def knn_smallest_staged(x, y, mask, *, kb, mode):
    """The staged body (``knn_smallest_launch``): the contract of
    :func:`knn_smallest` within :func:`takes_staged_two_op`'s range
    (outside it the launch is refused and this raises).
    ``knn_smallest_staged.launches`` counts its launches."""
    out, launched = _launch_knn("knn_smallest_launch", x, y, mask, kb, mode)
    knn_smallest_staged.launches += launched
    return out


def knn_smallest_tiled(x, y, mask, *, kb, mode):
    """The tiled body (``knn_smallest_tiled_launch``): the contract of
    :func:`knn_smallest` for any P and kb up to ``K_MAX``.
    ``knn_smallest_tiled.launches`` counts its launches."""
    out, launched = _launch_knn("knn_smallest_tiled_launch", x, y, mask, kb,
                                mode)
    knn_smallest_tiled.launches += launched
    return out


knn_smallest.launches = 0
knn_smallest_staged.launches = 0
knn_smallest_tiled.launches = 0


def ball_counts(
    x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, r: torch.Tensor, *,
    which: str,
) -> torch.Tensor:
    """Launch the kernel on B samples: the same contract as
    ``ref.ball_counts`` (r float32 (B, P) like y).  Returns counts (5, B,
    P) int32; ``which="y"`` launches the variant that never reads x (its
    pointer is not passed).  The body is the one
    :func:`takes_staged_two_op` names; ``ball_counts.launches`` counts the
    launches of both, each body's own ``launches`` its own."""
    if x.device.type != "cuda":
        raise ValueError(f"ball_counts kernel needs CUDA tensors, got {x.device}")
    body = (ball_counts_staged if takes_staged_two_op(x.shape[-1])
            else ball_counts_tiled)
    out = body(x, y, mask, r, which=which)
    if x.numel():
        ball_counts.launches += 1
    return out


def _launch_bc(entry: str, x, y, mask, r, which):
    B, P = _check_batch("ball_counts", x, y, mask, r)
    built = load_two_op_library()
    counts = torch.empty((5, B, P), dtype=torch.int32, device=x.device)
    every = which == "all"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(built.lib, entry)(
            x.data_ptr() if every else None, y.data_ptr(), mask.data_ptr(),
            r.data_ptr(), B, P, int(every), counts.data_ptr(), stream,
        )
    _raise_on(entry, err)
    return counts, int(B * P > 0)


def ball_counts_staged(x, y, mask, r, *, which):
    """The staged body (``ball_counts_launch``): the contract of
    :func:`ball_counts` for P up to ``TWO_OP_STAGED_MAX_P`` (beyond it
    the launch is refused and this raises).
    ``ball_counts_staged.launches`` counts its launches."""
    out, launched = _launch_bc("ball_counts_launch", x, y, mask, r, which)
    ball_counts_staged.launches += launched
    return out


def ball_counts_tiled(x, y, mask, r, *, which):
    """The tiled body (``ball_counts_tiled_launch``): the contract of
    :func:`ball_counts` for any P.  ``ball_counts_tiled.launches``
    counts its launches."""
    out, launched = _launch_bc("ball_counts_tiled_launch", x, y, mask, r,
                               which)
    ball_counts_tiled.launches += launched
    return out


ball_counts.launches = 0
ball_counts_staged.launches = 0
ball_counts_tiled.launches = 0

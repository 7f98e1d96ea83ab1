"""CUDA binding of the pairwise Chebyshev kernel (``csrc/pairwise_cheb.cu``).

A launch takes one rung of ``ROW_STEPS``, the thread rows of a block
(every rung leaves every output bit as the default 8 leaves it: each
element is computed alone).  ``rung=None`` asks
:mod:`repro_torch.kernels.autotune` (key ``pairwise_cheb``, the card, the
P bucket); with ``REPRO_AUTOTUNE`` unset and no cache file that is the
default.  A value off the ladder raises.

The source is built at first use by :mod:`repro_torch.kernels._build`
(``nvcc`` for ``sm_90a`` into ``build/kernels/``, loaded with ``ctypes``).
A failed build raises; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels._build import BuiltLibrary, build

__all__ = ["ROW_STEPS", "ROW_STEP_DEFAULT", "SOURCE", "load_library",
           "pairwise_cheb"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "pairwise_cheb.cu"
# Thread rows a block (pairwise_cheb.cu kRowSteps; the C entry refuses any
# other value) and the default, the body's constant before it was tuned.
ROW_STEPS = (4, 8, 16, 32)
ROW_STEP_DEFAULT = 8


@functools.lru_cache(maxsize=None)
def load_library() -> BuiltLibrary:
    """Build (once per source version) and load the kernel library."""
    built = build(SOURCE)
    fn = built.lib.pairwise_cheb_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return built


def _launch(x, y, mask, rung: int) -> list[torch.Tensor]:
    """One launch at ``rung`` (on the ladder), uncounted."""
    B, P = x.shape
    built = load_library()
    out = [torch.empty((B, P, P), dtype=torch.float32, device=x.device)
           for _ in range(3)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = built.lib.pairwise_cheb_launch(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), B, P,
            *(o.data_ptr() for o in out), rung, stream,
        )
    if err != 0:
        raise RuntimeError(f"pairwise_cheb launch failed: CUDA error {err}")
    return out


def _measure(P: int, device, bucket: int, default: int):
    """The autotuner's measure factory: one launch at the calling launch's
    P (the bucket is only the cache key) over the materialized
    estimators' chunk there (``core.estimators``: 2048 samples at
    P = 256), all columns valid.  Uncounted."""
    from repro_torch.core.estimators import _MATERIALIZED_ELEMS

    B = max(1, _MATERIALIZED_ELEMS // (P * P))
    i = torch.arange(B * P, device=device).reshape(B, P)
    x = torch.sin(i.to(torch.float32))
    y = torch.cos(1.7 * i.to(torch.float32))
    m = torch.ones((B, P), dtype=torch.bool, device=device)

    def measure(rung: int) -> float:
        return autotune.time_launch(lambda: _launch(x, y, m, rung))

    return measure


def _rung(rung, P: int, device) -> int:
    """The launch's thread rows a block: ``rung`` when given (on
    ``ROW_STEPS``), else the autotuner's for this P on this card."""
    return autotune.pick("pairwise_cheb", rung, ladder=ROW_STEPS,
                         default=ROW_STEP_DEFAULT, shape=P, device=device,
                         measure=_measure, args=(P, device))


def pairwise_cheb(
    x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, *, rung=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on B samples: the same contract as
    ``ref.pairwise_cheb`` (x, y float32 (B, P), mask bool (B, P), all
    contiguous on one CUDA device).  Returns (DX, DY, DJ), each float32
    (B, P, P).  ``rung``: thread rows a block, one of ``ROW_STEPS`` (None:
    the autotuner's).  ``pairwise_cheb.launches`` counts the launches."""
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
    out = _launch(x, y, mask, _rung(rung, P, x.device))
    if B * P:  # the C entry launches nothing for an empty batch
        pairwise_cheb.launches += 1
    return out[0], out[1], out[2]


pairwise_cheb.launches = 0

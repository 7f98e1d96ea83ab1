"""CUDA bindings of the two flash attention kernels.

* ``csrc/flash_wgmma.cu`` (:func:`flash_attention_wgmma`): the Hopper
  kernel (wgmma, a TMA-fed K/V ring, warp specialisation) for bfloat16 and
  float16 at the head dims in ``WGMMA_HEAD_DIMS``.  It rounds each softmax
  weight to the input dtype before P·V, the rule of
  ``ref.chunked_attention(p_dtype=...)``.
* ``csrc/flash_attention.cu`` (:func:`flash_attention_simt`): float32
  products and sums on the CUDA cores, for every other input.  It has two
  bodies with one contract, picked by :func:`takes_regtile`: the
  register-tiled body (:func:`flash_attention_simt_regtile`; float32 at
  Dk, Dv <= ``REGTILE_MAX_D``, 16-byte aligned rows: ``REGTILE_ROWS``
  packed query rows of all the KV head's query heads a block, K/V tiles of
  ``REGTILE_KEYS`` keys copied asynchronously, 16-byte operand reads) and
  the basic body (:func:`flash_attention_simt_basic`; the rest, among them
  16-bit inputs and head dims above 128).

:func:`flash_attention` sends each call to one of them by a fixed rule on
its inputs (see there).  Each source is built at first use by
:mod:`repro_torch.kernels._build` (``nvcc`` for ``sm_90a`` into
``build/kernels/``, loaded with ``ctypes``).  A failed build or launch
raises; nothing falls back to another kernel, another body or the plain
version.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import BuiltLibrary, build

__all__ = ["SOURCE", "WGMMA_SOURCE", "MAX_HEAD_DIM", "WGMMA_HEAD_DIMS",
           "REGTILE_ROWS", "REGTILE_KEYS", "REGTILE_MAX_D",
           "load_library", "load_wgmma_library", "takes_wgmma",
           "takes_regtile", "flash_attention", "flash_attention_simt",
           "flash_attention_simt_regtile", "flash_attention_simt_basic",
           "flash_attention_wgmma"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "flash_attention.cu"
WGMMA_SOURCE = _CSRC / "flash_wgmma.cu"
MAX_HEAD_DIM = 256
# (Dk, Dv) instantiated in flash_wgmma.cu: the serving path's 128, 64, and
# MLA's 192/128.
WGMMA_HEAD_DIMS = frozenset({(128, 128), (64, 64), (192, 128)})
# The register-tiled body (flash_attention.cu, namespace rt): packed query
# rows a block (the G = Hq/Hkv heads of one KV head, REGTILE_ROWS // G rows
# each), keys a K/V tile, and the widest Dk and Dv it takes.
REGTILE_ROWS = 128
REGTILE_KEYS = 64
REGTILE_MAX_D = 128
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_WGMMA_DTYPES = (torch.float16, torch.bfloat16)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _load(source: Path, *entries: str) -> BuiltLibrary:
    built = build(source)
    for entry in entries:
        fn = getattr(built.lib, entry)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return built


@functools.lru_cache(maxsize=None)
def load_library() -> BuiltLibrary:
    """Build (once per source version) and load the CUDA-core kernel (both
    bodies)."""
    built = _load(SOURCE, "flash_attention_regtile_launch",
                  "flash_attention_basic_launch")
    built.lib.flash_attention_regtile_smem.argtypes = [ctypes.c_int] * 2
    built.lib.flash_attention_regtile_smem.restype = ctypes.c_longlong
    return built


@functools.lru_cache(maxsize=None)
def load_wgmma_library() -> BuiltLibrary:
    """Build (once per source version) and load the Hopper kernel."""
    return _load(WGMMA_SOURCE, "flash_wgmma_launch")


def _aligned16(t: torch.Tensor) -> bool:
    """A (B, H, S, D) tensor that 16-byte copies can address: a 16-byte
    aligned base and strides in multiples of 16 bytes on every axis longer
    than 1 (TMA's rules; cp.async's too)."""
    B, H, S, _ = t.shape
    sb, sh, ss, _ = t.stride()
    n = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0 and (B == 1 or sb % n == 0)
            and (H == 1 or sh % n == 0) and (S == 1 or ss % n == 0))


def takes_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The dispatch rule of :func:`flash_attention`: bfloat16 or float16,
    (Dk, Dv) in ``WGMMA_HEAD_DIMS``, and q, k, v TMA-addressable (16-byte
    aligned, strides in multiples of 8 elements)."""
    return (q.dtype in _WGMMA_DTYPES and q.dim() == k.dim() == v.dim() == 4
            and (q.shape[-1], v.shape[-1]) in WGMMA_HEAD_DIMS
            and _aligned16(q) and _aligned16(k) and _aligned16(v))


def takes_regtile(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The body rule of :func:`flash_attention_simt`: the register-tiled
    body for float32 q, k, v with Dk and Dv up to ``REGTILE_MAX_D``, at most
    ``REGTILE_ROWS`` query heads a KV head, and 16-byte aligned rows (base
    and every stride of more than one element a multiple of 4 elements);
    the basic body for the rest (16-bit inputs, Dk or Dv above 128)."""
    return (q.dtype == k.dtype == v.dtype == torch.float32
            and q.dim() == k.dim() == v.dim() == 4
            and q.shape[-1] <= REGTILE_MAX_D and v.shape[-1] <= REGTILE_MAX_D
            and k.shape[1] > 0 and q.shape[1] % k.shape[1] == 0
            and q.shape[1] // k.shape[1] <= REGTILE_ROWS
            and _aligned16(q) and _aligned16(k) and _aligned16(v))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dtypes) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if q.dtype not in dtypes or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(dtypes)}: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    B, Hq, S, Dk = q.shape
    Hkv = k.shape[1]
    if (k.shape != (B, Hkv, S, Dk) or v.shape[:3] != (B, Hkv, S)
            or Hkv == 0 or Hq % Hkv):
        raise ValueError(f"shapes do not agree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the last axis of q, k, v must be contiguous")


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Element strides of the (B, H, S) axes; an axis of length 1 gets the
    packed stride, since its index is always 0 and its own stride may be
    any value (TMA takes only multiples of 16 bytes)."""
    B, H, S, D = t.shape
    sb, sh, ss, _ = t.stride()
    return (sb if B > 1 else H * S * D, sh if H > 1 else S * D,
            ss if S > 1 else D)


def _launch(built: BuiltLibrary, entry: str, q, k, v, scale: float,
            causal: bool) -> torch.Tensor:
    B, Hq, S, _ = q.shape
    out = torch.empty((B, Hq, S, v.shape[-1]), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # The launch goes to the current device: make it q's (a no-op, and no
    # context switch, when it already is).
    with torch.cuda.device(q.device.index):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(built.lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Hq, k.shape[1], S, q.shape[-1], v.shape[-1],
            *_strides(q), *_strides(k), *_strides(v),
            float(scale), int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True) -> torch.Tensor:
    """Launch one of the two kernels, by a fixed rule on the inputs
    (:func:`takes_wgmma`): bfloat16 or float16 at a (Dk, Dv) in
    ``WGMMA_HEAD_DIMS``, TMA-addressable, goes to
    :func:`flash_attention_wgmma`; everything else (float32, other head
    dims) to :func:`flash_attention_simt`.  There is no ``try``: a failed
    build or a refused launch raises."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got {q.device}")
    if takes_wgmma(q, k, v):
        return flash_attention_wgmma(q, k, v, scale=scale, causal=causal)
    return flash_attention_simt(q, k, v, scale=scale, causal=causal)


def _check_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _check(q, k, v, _DTYPES)
    B, Hq, S, Dk = q.shape
    Dv = v.shape[-1]
    for name, d in (("Dk", Dk), ("Dv", Dv)):
        if d <= 0 or d > MAX_HEAD_DIM or d % 8:
            raise ValueError(f"{name}={d}: the kernel takes multiples of 8 "
                             f"up to {MAX_HEAD_DIM}")
    if B > 65535 or Hq > 65535 or S >= 2**31:
        raise ValueError(f"B={B}, Hq={Hq}, S={S} exceed the kernel's grid")


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         scale: float, causal: bool = True) -> torch.Tensor:
    """The CUDA-core kernel: the contract of ``ref.chunked_attention``.

    q (B, Hq, S, Dk), k (B, Hkv, S, Dk), v (B, Hkv, S, Dv), one CUDA
    device, one dtype (float32, float16 or bfloat16), Hq a multiple of
    Hkv, Dk and Dv multiples of 8 up to 256, the last axis contiguous
    (any strides elsewhere).  Returns a contiguous (B, Hq, S, Dv) tensor
    in q's dtype.  The body is the one :func:`takes_regtile` names;
    ``flash_attention_simt.launches`` counts the launches of both, each
    body's own ``launches`` its own (each body checks the inputs).
    """
    body = (flash_attention_simt_regtile if takes_regtile(q, k, v)
            else flash_attention_simt_basic)
    out = body(q, k, v, scale=scale, causal=causal)
    flash_attention_simt.launches += 1
    return out


def flash_attention_simt_regtile(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, scale: float,
                                 causal: bool = True) -> torch.Tensor:
    """The register-tiled body (``flash_attention_regtile_launch``): the
    contract of :func:`flash_attention_simt` within :func:`takes_regtile`'s
    range; outside it this raises.
    ``flash_attention_simt_regtile.launches`` counts its launches."""
    _check_simt(q, k, v)
    if not takes_regtile(q, k, v):
        raise ValueError(
            f"the register-tiled body takes float32 with Dk, Dv <= "
            f"{REGTILE_MAX_D}, at most {REGTILE_ROWS} query heads a KV head "
            f"and 16-byte aligned rows: {q.dtype}, q {tuple(q.shape)} "
            f"{q.stride()}, k {tuple(k.shape)} {k.stride()}, v "
            f"{tuple(v.shape)} {v.stride()}")
    out = _launch(load_library(), "flash_attention_regtile_launch", q, k, v,
                  scale, causal)
    flash_attention_simt_regtile.launches += 1
    return out


def flash_attention_simt_basic(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, scale: float,
                               causal: bool = True) -> torch.Tensor:
    """The basic body (``flash_attention_basic_launch``, the first design):
    the whole contract of :func:`flash_attention_simt`.
    ``flash_attention_simt_basic.launches`` counts its launches."""
    _check_simt(q, k, v)
    out = _launch(load_library(), "flash_attention_basic_launch", q, k, v,
                  scale, causal)
    flash_attention_simt_basic.launches += 1
    return out


def flash_attention_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          scale: float, causal: bool = True) -> torch.Tensor:
    """The Hopper kernel: the contract of ``ref.chunked_attention(...,
    p_dtype=q.dtype)`` (its key tile is ``ref.KEY_TILE``).

    q (B, Hq, S, Dk), k (B, Hkv, S, Dk), v (B, Hkv, S, Dv) in bfloat16 or
    float16 on one CUDA device, Hq a multiple of Hkv, (Dk, Dv) in
    ``WGMMA_HEAD_DIMS``, the last axis contiguous, 16-byte aligned, every
    other stride a multiple of 8 elements.  Returns a contiguous
    (B, Hq, S, Dv) tensor in q's dtype.  ``flash_attention_wgmma.launches``
    counts the launches.
    """
    _check(q, k, v, _WGMMA_DTYPES)
    dims = (q.shape[-1], v.shape[-1])
    if dims not in WGMMA_HEAD_DIMS:
        raise ValueError(f"(Dk, Dv)={dims}: the wgmma kernel is built for "
                         f"{sorted(WGMMA_HEAD_DIMS)}")
    if not all(_aligned16(t) for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned with strides in "
                         "multiples of 8 elements (TMA)")
    if q.shape[2] >= 2**31:
        raise ValueError(f"S={q.shape[2]} exceeds the kernel's range")
    out = _launch(load_wgmma_library(), "flash_wgmma_launch", q, k, v, scale,
                  causal)
    flash_attention_wgmma.launches += 1
    return out


flash_attention_simt.launches = 0
flash_attention_simt_regtile.launches = 0
flash_attention_simt_basic.launches = 0
flash_attention_wgmma.launches = 0

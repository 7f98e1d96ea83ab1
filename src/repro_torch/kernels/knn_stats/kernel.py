"""CUDA bindings of the kNN-statistics kernels: the fused radius+count
kernel (``csrc/radius_counts.cu``, two bodies) and the two-op kernels
``knn_smallest`` and ``ball_counts`` (``csrc/knn_two_op.cu``, two bodies
each).

:func:`radius_counts` sends each call to one body of the fused kernel by
a fixed rule on its parameters (:func:`takes_staged`): the staged body
(:func:`radius_counts_staged`: one warp a sample, its valid columns
sorted by x in shared memory, selection along the sorted order) or the
tiled body (:func:`radius_counts_tiled`: any P and any k, kb; each
sample's valid columns sorted by y and by x, then one thread a row:
selection along the sorted orders, every count a binary-searched
range).  Both are bit-equal to ``ref.radius_counts``.
:func:`knn_smallest` and :func:`ball_counts` are sent the same way
(:func:`takes_staged_two_op`): to a staged body (one warp a sample,
sorted by value, selection and counts along the sorted orders) or to a
tiled body (the tiled ``radius_counts`` body's sorted orders,
``csrc/sorted_orders.cuh``, then one thread a row: selection along the
orders, every count a binary-searched range), each bit-equal to its
``ref`` function.

Each staged body launches at one rung of its launch-shape ladder (its
cap on samples a block, ``STAGED_WARPS``).  Every rung leaves every
output bit as the default rung (the body's constant before it was tuned)
leaves it.  A body's ``rung=None`` asks
:mod:`repro_torch.kernels.autotune` (key: the body's name, the card, the
P bucket); with ``REPRO_AUTOTUNE`` unset and no cache file that is the
default.  A value off the ladder raises.  The tiled bodies have no
ladder.

Each source is built at first use by :mod:`repro_torch.kernels._build`
(``nvcc`` for ``sm_90a`` into ``build/kernels/``, loaded with ``ctypes``).
A failed build or launch raises; nothing falls back to another body or
to the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels._build import BuiltLibrary, build, find_nvcc

__all__ = ["SORTED_ORDERS", "SOURCE", "STAGED_MAX_P", "STAGED_MAX_W",
           "STAGED_WARPS", "TILED_CHUNK", "TUNED", "TWO_OP_SOURCE",
           "TWO_OP_STAGED_MAX_KB", "TWO_OP_STAGED_MAX_P", "BuiltLibrary",
           "ball_counts", "ball_counts_staged", "ball_counts_tiled",
           "find_nvcc", "knn_smallest", "knn_smallest_staged",
           "knn_smallest_tiled", "load_library", "load_two_op_library",
           "radius_counts", "radius_counts_staged", "radius_counts_tiled",
           "takes_staged", "takes_staged_two_op"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "radius_counts.cu"
TWO_OP_SOURCE = Path(__file__).resolve().parent / "csrc" / "knn_two_op.cu"
# The sorted route both tiled bodies include.
SORTED_ORDERS = Path(__file__).resolve().parent / "csrc" / "sorted_orders.cuh"

# The staged body's range (radius_counts.cu, staged::kMaxP / kMaxW): the
# whole sample in one warp's shared memory, and a register buffer of at
# most 16 lanes.
STAGED_MAX_P = 1024
STAGED_MAX_W = 16
# The tiled bodies' sort chunk (sorted_orders.cuh, orders::kChunk): a
# sample of up to 256 columns is sorted by one warp in registers, a
# longer one in chunks of this many columns, sorted in shared memory and
# merged by rank in device scratch.
TILED_CHUNK = 1024
# The two-op staged bodies' range (knn_two_op.cu, staged::kMaxP / kMaxKb):
# the whole sample in one warp's shared memory, and at most 16 kNN lanes.
TWO_OP_STAGED_MAX_P = 1024
TWO_OP_STAGED_MAX_KB = 16

# Launch-shape ladders (the C entries refuse any other value): samples
# (warps) a block at most, as many as fit 48 KB below it (radius_counts.cu
# and knn_two_op.cu, staged::kWarpRungs); one warp a sample, so no rung
# changes an output bit.
STAGED_WARPS = (1, 2, 4, 8)
# Each tuned body's autotuner key name -> (ladder, default rung).
TUNED = {"radius_counts_staged": (STAGED_WARPS, 8),
         "knn_two_op_staged": (STAGED_WARPS, 8)}
# The entries each key's measure times, and the key of each entry.
_ENTRIES = {"radius_counts_staged": ("radius_counts_launch",),
            "knn_two_op_staged": ("knn_smallest_launch", "ball_counts_launch")}
_KEY = {e: name for name, entries in _ENTRIES.items() for e in entries}


@functools.lru_cache(maxsize=None)
def load_library() -> BuiltLibrary:
    """Build (once per source version) and load the kernel library (both
    bodies' entries)."""
    built = build(SOURCE)
    # Before the stream, the staged entry takes its cap on samples a
    # block, the tiled entry its scratch buffer.
    for name, extra in (("radius_counts_launch", ctypes.c_int),
                        ("radius_counts_tiled_launch", ctypes.c_void_p)):
        fn = getattr(built.lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
            + [extra, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    built.lib.radius_counts_tiled_scratch.argtypes = [ctypes.c_int] * 2
    built.lib.radius_counts_tiled_scratch.restype = ctypes.c_longlong
    return built


@functools.lru_cache(maxsize=None)
def load_two_op_library() -> BuiltLibrary:
    """Build (once per source version) and load the two-op library (both
    bodies' entries of each op)."""
    built = build(TWO_OP_SOURCE)
    # Before the stream, a staged entry takes its cap on samples a block,
    # a tiled entry its scratch buffer.
    for op, extra in (("", ctypes.c_int), ("_tiled", ctypes.c_void_p)):
        fn = getattr(built.lib, f"knn_smallest{op}_launch")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p] * 2 + [extra, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(built.lib, f"ball_counts{op}_launch")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p, extra, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for op in ("knn_smallest", "ball_counts"):
        fn = getattr(built.lib, f"{op}_tiled_scratch")
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_longlong
    return built


def _check_batch(name: str, x, y, mask, *extra) -> tuple[int, int]:
    """What protects the foreign call: x, y (and each of ``extra``)
    float32, mask bool, all (B, P), contiguous, on one CUDA device.
    Parameter ranges are ``ops``'s to check."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {x.device}")
    # Plain loops: a call at B = 1 pays for every host step.
    tensors = (x, y, *extra, mask)
    shape, device = x.shape, x.device
    for t in tensors:
        if len(shape) != 2 or t.shape != shape:
            raise ValueError(
                f"x, y, mask must share one (B, P) shape: "
                f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(mask.shape)}"
            )
    for t in tensors[:-1]:
        if t.dtype != torch.float32:
            raise TypeError("x, y must be float32 and mask bool")
    if mask.dtype != torch.bool:
        raise TypeError("x, y must be float32 and mask bool")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("x, y, mask must be contiguous")
    for t in tensors:
        if t.device != device:
            raise ValueError("x, y, mask must lie on one device")
    B, P = shape
    if B * P >= 2**31:
        raise ValueError(f"B*P={B * P} exceeds the kernel's int32 range")
    return B, P


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _rung(entry: str, rung, B: int, P: int, device, k: int, kb: int) -> int:
    """The launch shape of ``entry``'s body: ``rung`` when given (on its
    ladder), else the autotuner's for this P on this card."""
    name = _KEY[entry]
    ladder, default = TUNED[name]
    return autotune.pick(name, rung, ladder=ladder, default=default,
                         shape=P, device=device, measure=_measure,
                         args=(name, B, P, k, kb, device))


def _tune_samples(B: int, P: int, device) -> dict:
    """Deterministic synthetic samples for a sweep, (B, P) on ``device``:
    continuous x and y, class codes and discrete values (8 levels each),
    sample b valid on its first P - (37 b mod P/2) columns (join sizes
    spread over [P/2, P]) and radii of 0.05."""
    i = torch.arange(B * P, device=device).reshape(B, P).to(torch.float32)
    x, y = torch.sin(i), torch.cos(1.7 * i)
    n = P - (37 * torch.arange(B, device=device)) % max(P // 2, 1)
    mask = torch.arange(P, device=device)[None, :] < n[:, None]
    return {"x": x, "y": y, "codes": torch.floor(4 * x),
            "yd": torch.floor(4 * y), "mask": mask,
            "r": torch.full((B, P), 0.05, device=device)}


def _measure(name: str, B: int, P: int, k: int, kb: int, device,
             bucket: int, default: int):
    """The autotuner's measure factory for the tuned body ``name``: the
    body at the calling launch's B, P (as the caller padded it; the
    bucket is only the cache key), k and kb, timed over the launches the
    discovery path makes on it: for radius_counts the three KSG modes of
    a warm ``query_many`` (MixedKSG's joint/all on continuous data;
    DC-KSG's class/y on a continuous and on a discrete target), for the
    two-op bodies both ``knn_smallest`` modes and both ``ball_counts``
    sets (kb 3, the discovery path's, when a ``ball_counts`` launch
    resolves the key).  None of these launches is counted by the
    wrappers."""
    t = _tune_samples(B, P, device)
    x, y, yd, codes, m, r = (t[n] for n in ("x", "y", "yd", "codes", "mask",
                                            "r"))
    if name == "radius_counts_staged":
        entry, = _ENTRIES[name]
        calls = [functools.partial(_launch_rc, entry, x, y, m, k, k, k,
                                   "joint", "all"),
                 functools.partial(_launch_rc, entry, codes, y, m, k, kb, k,
                                   "class", "y"),
                 functools.partial(_launch_rc, entry, codes, yd, m, k, kb, k,
                                   "class", "y")]
    else:
        knn, ball = _ENTRIES[name]
        calls = [functools.partial(_launch_knn, knn, x, y, m, kb, "joint"),
                 functools.partial(_launch_knn, knn, codes, y, m, kb, "class"),
                 functools.partial(_launch_bc, ball, x, y, m, r, "all"),
                 functools.partial(_launch_bc, ball, x, y, m, r, "y")]

    def measure(rung: int) -> float:
        return sum(autotune.time_launch(functools.partial(c, rung=rung))
                   for c in calls)

    return measure


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


def _on(device):
    """The device context a launch needs: none when ``device`` is the
    current one (a call at B = 1 pays for every host step)."""
    return (contextlib.nullcontext() if device.index == torch.cuda.current_device()
            else torch.cuda.device(device))


def _scratch(nbytes: int, device):
    """A tiled body's device scratch (the chunks' sorted pairs and the
    sorted orders): a buffer and its pointer, or neither."""
    if not nbytes:
        return None, None
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return scratch, scratch.data_ptr()


def _launch_rc(entry: str, x, y, mask, k, kb, kk, mode, which, rung=None):
    B, P = _check_batch("radius_counts", x, y, mask)
    built = load_library()
    if entry == "radius_counts_tiled_launch":
        scratch, extra = _scratch(built.lib.radius_counts_tiled_scratch(B, P),
                                  x.device)
    else:
        extra = _rung(entry, rung, B, P, x.device, k, kb)
    # r, cnt and the 5 count planes are views of one allocation, so that a
    # call at B = 1 pays one allocator call for them, not three.
    n = B * P
    out = torch.empty(28 * n, dtype=torch.uint8, device=x.device)
    r = out[:4 * n].view(torch.float32).view(B, P)
    cnt = out[4 * n:8 * n].view(torch.int32).view(B, P)
    counts = out[8 * n:].view(torch.int32).view(5, B, P)
    with _on(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(built.lib, entry)(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), B, P, int(k),
            int(kb), int(kk), int(mode == "joint"), int(which == "all"),
            r.data_ptr(), cnt.data_ptr(), counts.data_ptr(), extra, stream,
        )
    _raise_on(entry, err)
    return (r, cnt, counts), int(B * P > 0)


def radius_counts_staged(x, y, mask, *, k, kb, kk, mode, which, rung=None):
    """The staged body (``radius_counts_launch``): the contract of
    :func:`radius_counts` within :func:`takes_staged`'s range (outside it
    the launch is refused and this raises).  ``rung``: samples a block at
    most, one of ``STAGED_WARPS`` (None: the autotuner's).
    ``radius_counts_staged.launches`` counts its launches."""
    out, launched = _launch_rc("radius_counts_launch", x, y, mask, k, kb, kk,
                               mode, which, rung)
    radius_counts_staged.launches += launched
    return out


def radius_counts_tiled(x, y, mask, *, k, kb, kk, mode, which):
    """The tiled body (``radius_counts_tiled_launch``): the contract of
    :func:`radius_counts` for any P, k and kb.  One call makes one CUDA
    launch up to P = 256, and three or four beyond (the chunks' sort,
    past ``TILED_CHUNK`` their merge by rank, the placing, the rows,
    through device scratch); ``radius_counts_tiled.launches`` counts the
    call once, as ``radius_counts.launches`` does."""
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


def _two_op_extra(entry: str, rung, B: int, P: int, device, kb: int):
    """What a two-op entry takes before the stream: a tiled entry its
    scratch (the buffer is returned beside it, to outlive the launch), a
    staged one its rung."""
    if entry.endswith("_tiled_launch"):
        size = getattr(load_two_op_library().lib,
                       entry.replace("_launch", "_scratch"))
        return _scratch(size(B, P), device)
    return None, _rung(entry, rung, B, P, device, kb, kb)


def _launch_knn(entry: str, x, y, mask, kb, mode, rung=None):
    B, P = _check_batch("knn_smallest", x, y, mask)
    scratch, extra = _two_op_extra(entry, rung, B, P, x.device, kb)
    built = load_two_op_library()
    # knn and cnt are views of one allocation (one allocator call at B = 1).
    n = B * P
    out = torch.empty(4 * n * (kb + 1), dtype=torch.uint8, device=x.device)
    knn = out[:4 * n * kb].view(torch.float32).view(B, P, kb)
    cnt = out[4 * n * kb:].view(torch.int32).view(B, P)
    with _on(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(built.lib, entry)(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), B, P, int(kb),
            int(mode == "joint"), knn.data_ptr(), cnt.data_ptr(), extra,
            stream,
        )
    _raise_on(entry, err)
    return (knn, cnt), int(B * P > 0)


def knn_smallest_staged(x, y, mask, *, kb, mode, rung=None):
    """The staged body (``knn_smallest_launch``): the contract of
    :func:`knn_smallest` within :func:`takes_staged_two_op`'s range
    (outside it the launch is refused and this raises).  ``rung``:
    samples a block at most, one of ``STAGED_WARPS`` (None: the
    autotuner's).  ``knn_smallest_staged.launches`` counts its launches."""
    out, launched = _launch_knn("knn_smallest_launch", x, y, mask, kb, mode,
                                rung)
    knn_smallest_staged.launches += launched
    return out


def knn_smallest_tiled(x, y, mask, *, kb, mode):
    """The tiled body (``knn_smallest_tiled_launch``): the contract of
    :func:`knn_smallest` for any P and kb up to ``K_MAX``.  One call makes
    one CUDA launch up to P = 256, and two to four beyond for each slice
    of the batch (the sorted orders through device scratch, then the rows;
    40 bytes a column, the batch sliced so that the scratch stays within
    1 GiB); ``knn_smallest_tiled.launches`` counts the call once."""
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


def _launch_bc(entry: str, x, y, mask, r, which, rung=None):
    B, P = _check_batch("ball_counts", x, y, mask, r)
    scratch, extra = _two_op_extra(entry, rung, B, P, x.device, 3)
    built = load_two_op_library()
    counts = torch.empty((5, B, P), dtype=torch.int32, device=x.device)
    every = which == "all"
    with _on(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(built.lib, entry)(
            x.data_ptr() if every else None, y.data_ptr(), mask.data_ptr(),
            r.data_ptr(), B, P, int(every), counts.data_ptr(), extra, stream,
        )
    _raise_on(entry, err)
    return counts, int(B * P > 0)


def ball_counts_staged(x, y, mask, r, *, which, rung=None):
    """The staged body (``ball_counts_launch``): the contract of
    :func:`ball_counts` for P up to ``TWO_OP_STAGED_MAX_P`` (beyond it
    the launch is refused and this raises).  ``rung``: samples a block at
    most, one of ``STAGED_WARPS`` (None: the autotuner's).
    ``ball_counts_staged.launches`` counts its launches."""
    out, launched = _launch_bc("ball_counts_launch", x, y, mask, r, which,
                               rung)
    ball_counts_staged.launches += launched
    return out


def ball_counts_tiled(x, y, mask, r, *, which):
    """The tiled body (``ball_counts_tiled_launch``): the contract of
    :func:`ball_counts` for any P.  One call makes two CUDA launches up
    to P = 1024, and four beyond, for each slice of the batch, through
    scratch as :func:`knn_smallest_tiled`'s;
    ``ball_counts_tiled.launches`` counts the call once."""
    out, launched = _launch_bc("ball_counts_tiled_launch", x, y, mask, r,
                               which)
    ball_counts_tiled.launches += launched
    return out


ball_counts.launches = 0
ball_counts_staged.launches = 0
ball_counts_tiled.launches = 0

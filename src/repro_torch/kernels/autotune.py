"""Launch-shape autotuner of the port, with a persistent cross-process
cache: the port's copy of ``repro/kernels/autotune.py``.

Each tuned Hopper kernel body has a ladder of launch shapes (samples or
thread rows a block, columns staged a step), every rung of which
leaves every output bit as the default rung leaves it.  This module picks
one rung per (kernel, backend, dtype, shape-bucket) key: it sweeps the
ladder once on the card, persists the winner to a JSON cache and reuses
it across processes.  The kernels' ``kernel.py`` wrappers ask it through
:func:`pick`, on their CUDA branch only: a CPU tensor never reaches it.

Determinism contract, as the reference's:

  * Within one process, :func:`resolve` is memoized: the same key always
    returns the same rung, so a captured program and the eager path it
    was captured from launch one shape.
  * ``REPRO_AUTOTUNE=off`` short-circuits to the caller's default, with
    no file I/O at all.
  * ``REPRO_AUTOTUNE=on`` sweeps on a cache miss and persists the winner;
    every later process (any mode but ``off``) reads it back.
  * Unset (``auto``, the default) never sweeps: cache hit or caller
    default.  A corrupt, stale or unreadable cache, or an entry that
    holds a value off the ladder, degrades to the default with a warning,
    never an exception.

The cache lives at ``results/autotune_cache.json`` relative to the
working directory; ``REPRO_AUTOTUNE_CACHE`` overrides the path.  The
variables, the file's layout (``version`` 1, an ``entries`` table) and
the key format are the reference's, so one setting governs both packages
and one file may hold both packages' entries: the port's kernel names
(``radius_counts_staged``, ``knn_two_op_staged``, ...) never meet the
reference's.

Where the port differs: ``backend=None`` is the card's name
(``torch.cuda.get_device_name``) or ``"cpu"``, not ``jax.default_backend()``;
a miss while the current CUDA stream is capturing a graph never sweeps (it
takes the cached value or the default and pins it in the memo); and
:func:`time_launch` times a rung with CUDA events.  A sweep's launches go
to the bodies' C entries directly, so the kernel wrappers' ``launches``
counters (and the counts ``compile.py`` records per capture) never see
them; :data:`sweep_launches` counts them instead.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import warnings
from pathlib import Path
from typing import Callable, Iterable, Sequence

import torch

__all__ = [
    "LADDER",
    "backend_of",
    "cache_path",
    "clear_memo",
    "mode",
    "pick",
    "resolve",
    "shape_bucket",
    "sweep",
    "time_launch",
]

# The reference's candidate tile widths, kept as a name for parity.  No
# body of the port tunes a tile width on this ladder: each passes its own
# ladder as ``candidates``.
LADDER: tuple[int, ...] = (64, 128, 256, 512, 1024)

_ENV_MODE = "REPRO_AUTOTUNE"
_ENV_CACHE = "REPRO_AUTOTUNE_CACHE"
_CACHE_VERSION = 1

# (kernel, backend, dtype, bucket) -> chosen rung.  Process-lifetime.
_memo: dict[tuple[str, str, str, int], int] = {}
_cache_loaded: dict[str, dict] | None = None
_cache_loaded_from: Path | None = None
# One miss at a time (the scheduler's loop thread and callers may resolve
# together); a hit takes no lock.
_LOCK = threading.RLock()

# device -> backend_of(device), for pick's memo lookup.
_backends: dict = {}

# Sweeps run and kernel launches they made, in this process.
sweeps = 0
sweep_launches = 0


def mode() -> str:
    """Normalized tuning mode: "off", "on", or "auto" (cache-read only)."""
    raw = os.environ.get(_ENV_MODE, "").strip().lower()
    if raw in ("off", "0", "false", "disabled"):
        return "off"
    if raw in ("on", "1", "true", "enabled"):
        return "on"
    return "auto"


def cache_path() -> Path:
    override = os.environ.get(_ENV_CACHE, "").strip()
    if override:
        return Path(override)
    return Path("results") / "autotune_cache.json"


def shape_bucket(n: int) -> int:
    """Pow-2 bucket (>= 64) a padded problem size falls into: the cache
    granularity."""
    b = 64
    while b < n:
        b *= 2
    return b


def clear_memo() -> None:
    """Drop the per-process memo and the loaded cache (a new process's
    view: the next resolve reads the file again)."""
    global _cache_loaded, _cache_loaded_from
    with _LOCK:
        _memo.clear()
        _cache_loaded = None
        _cache_loaded_from = None


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def backend_of(device=None) -> str:
    """The backend part of a key: the card's name for a CUDA device (the
    current one when ``device`` is None and a card is present), else
    ``"cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return _card_name(device.index if device.index is not None
                      else torch.cuda.current_device())


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (a sweep would
    record events and synchronize inside it)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _key_str(kernel: str, backend: str, dtype: str, bucket: int) -> str:
    return f"{kernel}|{backend}|{dtype}|{bucket}"


def _load_cache() -> dict[str, dict]:
    """Entries of the on-disk cache; {} (with one warning) if corrupt."""
    global _cache_loaded, _cache_loaded_from
    path = cache_path()
    if _cache_loaded is not None and _cache_loaded_from == path:
        return _cache_loaded
    entries: dict[str, dict] = {}
    if path.exists():
        try:
            raw = json.loads(path.read_text())
            if not isinstance(raw, dict) or raw.get("version") != _CACHE_VERSION:
                raise ValueError(f"unsupported cache layout: {type(raw).__name__}")
            got = raw.get("entries")
            if not isinstance(got, dict):
                raise ValueError("missing 'entries' table")
            entries = got
        except (ValueError, OSError) as e:
            warnings.warn(
                f"autotune cache {path} is corrupt or stale ({e}); "
                "falling back to built-in block defaults",
                stacklevel=3,
            )
            entries = {}
    _cache_loaded = entries
    _cache_loaded_from = path
    return entries


def _store(key: str, entry: dict) -> None:
    global _cache_loaded, _cache_loaded_from
    path = cache_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        entries = dict(_load_cache())
        entries[key] = entry
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(
            json.dumps({"version": _CACHE_VERSION, "entries": entries},
                       indent=2, sort_keys=True)
        )
        tmp.replace(path)
        _cache_loaded = entries
        _cache_loaded_from = path
    except OSError as e:
        warnings.warn(f"could not persist autotune cache to {path}: {e}",
                      stacklevel=3)


def _cached_block(key: str, candidates: Sequence[int]) -> int | None:
    entry = _load_cache().get(key)
    if entry is None:
        return None
    block = entry.get("block") if isinstance(entry, dict) else None
    if not isinstance(block, int) or block not in candidates:
        warnings.warn(
            f"autotune cache entry {key!r} holds an invalid block "
            f"{block!r} (not in the candidate ladder); using the default",
            stacklevel=3,
        )
        return None
    return block


def sweep(
    measure: Callable[[int], float],
    candidates: Iterable[int],
) -> tuple[int, dict[str, float]]:
    """Run ``measure(rung) -> seconds`` over the ladder; return the winner
    and the per-candidate timings.  Candidates that raise are skipped;
    ties break toward the smaller rung (deterministic)."""
    global sweeps
    sweeps += 1
    results: dict[str, float] = {}
    best: tuple[float, int] | None = None
    for c in candidates:
        try:
            t = float(measure(c))
        except Exception as e:  # an unservable rung is not an error
            results[str(c)] = float("inf")
            warnings.warn(f"autotune candidate block={c} failed: {e}",
                          stacklevel=2)
            continue
        results[str(c)] = t
        if best is None or (t, c) < best:
            best = (t, c)
    if best is None:
        raise RuntimeError("every autotune candidate failed")
    return best[1], results


def resolve(
    kernel: str,
    *,
    shape: int,
    default: int,
    backend: str | None = None,
    dtype: str = "float32",
    candidates: Sequence[int] = LADDER,
    measure: Callable[[int, int], Callable[[int], float]] | None = None,
    device=None,
) -> int:
    """Resolve the rung for one kernel-body invocation.

    ``shape`` is the padded problem size (bucketed pow-2); ``measure`` is
    a factory ``(bucket, default) -> (rung -> seconds)`` invoked only in
    ``on`` mode on a cache miss, never while the current stream captures.
    ``backend`` defaults to :func:`backend_of` ``(device)``.  Always
    deterministic per process (memoized), and exactly ``default`` when
    tuning is off, the cache misses in auto mode, or the cache is corrupt.
    """
    if backend is None:
        backend = backend_of(device)
    bucket = shape_bucket(shape)
    memo_key = (kernel, backend, dtype, bucket)
    hit = _memo.get(memo_key)
    if hit is not None:
        return hit
    with _LOCK:
        hit = _memo.get(memo_key)
        if hit is not None:
            return hit
        m = mode()
        block = default
        if m != "off":
            key = _key_str(kernel, backend, dtype, bucket)
            cached = _cached_block(key, candidates)
            if cached is not None:
                block = cached
            elif m == "on" and measure is not None and not _capturing():
                winner, timings = sweep(measure(bucket, default), candidates)
                _store(key, {"block": winner, "seconds": timings,
                             "default": default})
                block = winner
        _memo[memo_key] = block
        return block


def pick(
    kernel: str,
    rung: int | None,
    *,
    ladder: Sequence[int],
    default: int,
    shape: int,
    device,
    dtype: str = "float32",
    measure: Callable[..., Callable[[int], float]] | None = None,
    args: tuple = (),
) -> int:
    """The rung a tuned body launches with: ``rung`` itself when given (it
    must lie on ``ladder``: a value off it raises, there is no clamp),
    else :func:`resolve`'s for this ``shape`` on ``device``.  The memo is
    looked up first; only on a miss is ``measure(*args, bucket, default)``
    made :func:`resolve`'s measure factory."""
    if rung is not None:
        if rung not in ladder:
            raise ValueError(f"{kernel}: {rung!r} is not on its ladder "
                             f"{tuple(ladder)}")
        return int(rung)
    # A CUDA tensor's device has its index; any other is resolved anew.
    indexed = isinstance(device, torch.device) and device.index is not None
    backend = _backends.get(device) if indexed else None
    if backend is None:
        backend = backend_of(device)
        if indexed:
            _backends[device] = backend
    hit = _memo.get((kernel, backend, dtype, shape_bucket(shape)))
    if hit is not None:
        return hit
    return resolve(kernel, shape=shape, default=default, backend=backend,
                   dtype=dtype, candidates=tuple(ladder),
                   measure=None if measure is None
                   else functools.partial(measure, *args))


def time_launch(run: Callable[[], object], launches: int = 1) -> float:
    """Seconds one ``run()`` takes on the card, by CUDA events on the
    current stream: one warm call outside the timing, then the best of 3.
    ``launches``, the kernel launches one call makes, are added to
    :data:`sweep_launches` for each of the 4 calls."""
    global sweep_launches
    run()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    sweep_launches += 4 * launches
    return best

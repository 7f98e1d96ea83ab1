"""Compiled programs: the port's counterpart of ``jax.jit``'s cache.

:func:`program` wraps a function into a :class:`Program`, which keeps
one compiled program per key, where the reference's ``jax.jit`` keeps
one compiled executable per trace.  The key is the function, the values
of its static arguments (the reference's ``static_argnames``), the
shapes, dtypes and device of its tensor inputs, and the identity
(address and layout) of the persistent device buffers it reads in place
(``resident`` arguments: the index's group stores, a model's weights
and KV caches).  What the reference traces as a scalar (``min_join``,
the staged ``min_containment``) is a 0-dim device tensor input, so a
new value is a new input, not a new program.

On a CUDA device the first call at a key runs the function eagerly on a
side stream (the warm-up, whose results it returns), releases the
allocator's cached blocks, then captures it into a
``torch.cuda.CUDAGraph`` that reads copies of the inputs held in static
buffers.  Each later call copies its inputs into those buffers
(device copies, no host sync), replays the graph and returns copies of
its outputs, so a handle that collects later never sees the next
replay's results.  On the CPU the function runs eagerly, and the key is
still registered, so :func:`compile_count` and the tests behave alike on
both devices.  Inside :func:`eager` (the counterpart of
``jax.disable_jit``) every program runs as plain eager code and
registers nothing.

Replays do not call the kernels' Python wrappers, so a capture records
how far each wrapper's ``launches`` counter rose while it was captured
(and sets the counters back: capturing launches nothing) and each
replay adds those amounts: the counters still count the launches the
device made.

Every program captured on one stream shares one graph memory pool.
That is safe because every capture and replay on a stream is enqueued
under one lock, so the graphs run one after another; every replay's
outputs are copied out before anything else is enqueued on that stream;
and a graph's static outputs stay allocated while it lives, so a later
capture reuses only memory an earlier one freed.  The pool is then as
large as the largest program's temporaries, not their sum.

A resident buffer is held by weak reference: a program whose buffer was
freed (a store that grew, a model that was dropped) is destroyed at the
next capture; a pool whose every graph was destroyed is released with
them, and the next capture on its stream starts a new one.  Its key can only match a live buffer at the same address
and layout, which is then the buffer a replay reads.  A capture that
fails raises; nothing retries eagerly.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import threading
import time
import weakref

import torch

__all__ = ["Program", "program", "eager", "compile_count", "compile_stats",
           "launch_counters"]

_LOCK = threading.RLock()
_PROGRAMS: list["Program"] = []
_EAGER = 0
_BUILT = 0
_BUILD_S = 0.0
_POOLS: dict[tuple, object] = {}


@functools.cache
def launch_counters() -> tuple:
    """Every kernel wrapper that counts its launches (``.launches``), and
    the MoE layers' grouped GEMM (a library call, counted the same way)."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.knn_stats import kernel as rc
    from repro_torch.kernels.murmur3 import kernel as mm
    from repro_torch.kernels.pairwise_cheb import kernel as pc
    from repro_torch.models import ffn

    return (rc.radius_counts, rc.radius_counts_staged, rc.radius_counts_tiled,
            rc.knn_smallest, rc.knn_smallest_staged, rc.knn_smallest_tiled,
            rc.ball_counts, rc.ball_counts_staged, rc.ball_counts_tiled,
            pc.pairwise_cheb, mm.murmur3_fib, fa.flash_attention_simt,
            fa.flash_attention_wgmma, ffn.grouped_swiglu_mm)


@contextlib.contextmanager
def eager():
    """Run every program as plain eager code while the context is open,
    in every thread (the counterpart of ``jax.disable_jit``)."""
    global _EAGER
    with _LOCK:
        _EAGER += 1
    try:
        yield
    finally:
        with _LOCK:
            _EAGER -= 1


def compile_count() -> int:
    """Programs built so far (captured on a card, registered on the
    CPU), across every :class:`Program`."""
    return _BUILT


def compile_stats() -> dict:
    """Programs built, programs alive, and the seconds spent building
    them (warm-up and capture)."""
    with _LOCK:
        return {"built": _BUILT,
                "alive": sum(len(p._entries) for p in _PROGRAMS),
                "build_s": _BUILD_S}


def _leaves(obj) -> list:
    """The tensors of a nested structure of dicts, lists and tuples (a
    :class:`~repro_torch.parallel.sharding.ShardedTensor` gives its
    distinct pieces)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    local = getattr(obj, "local_tensors", None)
    if local is not None:
        return list(local())
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _leaves(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _leaves(v)]
    raise TypeError(f"a program argument must hold tensors, got {type(obj)}")


def _map(fn, obj):
    """``obj`` with every tensor ``t`` replaced by ``fn(t)``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(fn, v) for v in obj)
    return obj


def _input_key(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.dtype, t.device)


def _resident_key(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


class _Entry:
    """One captured program: its graph, its static input buffers and
    outputs, the launches it makes and weak references to the resident
    buffers it reads."""

    __slots__ = ("graph", "inputs", "outputs", "launches", "refs", "pool")

    def __init__(self, graph, inputs, outputs, launches, residents,
                 pool=None):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.refs = [weakref.ref(t) for t in residents]
        self.pool = pool  # the _POOLS key of the graph's memory pool

    def stale(self) -> bool:
        return any(r() is None for r in self.refs)


class Program:
    """A function run as one compiled program per key (see the module
    docstring).  ``static`` names the keyword arguments whose values key
    the program; ``resident`` names the arguments (tensors or nested
    dicts and lists of them) read in place; every other argument is an
    input: a tensor or a dict of tensors, copied into the program's
    static buffers on each call."""

    def __init__(self, fn, static=(), resident=()):
        self.fn = fn
        self._sig = inspect.signature(fn)
        self._static = frozenset(static)
        self._resident = frozenset(resident)
        unknown = (self._static | self._resident) - set(self._sig.parameters)
        if unknown:
            raise ValueError(f"{fn.__name__} has no argument {sorted(unknown)}")
        self._entries: dict[tuple, _Entry | None] = {}
        with _LOCK:
            _PROGRAMS.append(self)

    def __call__(self, *args, **kwargs):
        if _EAGER:
            return self.fn(*args, **kwargs)
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        key, inputs, residents, device = self._key(bound.arguments)
        if device is None or device.type != "cuda":
            self._register(key, residents)
            return self.fn(*args, **kwargs)
        with _LOCK:
            entry = self._entries.get(key)
            if entry is None:
                return self._build(key, bound, inputs, residents, device)
            return self._replay(entry, inputs)

    def _key(self, arguments: dict):
        key, inputs, residents, device = [], {}, [], None
        for name, value in arguments.items():
            if name in self._static:
                key.append((name, value))
            elif name in self._resident:
                leaves = _leaves(value)
                residents += leaves
                key.append((name, tuple(_resident_key(t) for t in leaves)))
            else:
                flat = {"": value} if isinstance(value, torch.Tensor) else value
                if not (isinstance(flat, dict) and flat and all(
                        isinstance(t, torch.Tensor) for t in flat.values())):
                    raise TypeError(
                        f"input {name!r} of {self.fn.__name__} must be a "
                        f"tensor or a dict of tensors")
                inputs[name] = value
                key.append((name, tuple((k, _input_key(t))
                                        for k, t in flat.items())))
                device = device or next(iter(flat.values())).device
        if device is not None and device.type == "cuda":
            key.append(("stream", torch.cuda.current_stream(device).stream_id))
        return tuple(key), inputs, residents, device

    def _register(self, key: tuple, residents: list) -> None:
        """CPU: count a new key as a program built."""
        global _BUILT
        with _LOCK:
            if key not in self._entries:
                _sweep()
                self._entries[key] = _Entry(None, None, None, None, residents)
                _BUILT += 1

    def _build(self, key, bound, inputs, residents, device):
        """Warm up on a side stream, capture, and return the warm-up's
        results."""
        global _BUILT, _BUILD_S
        t0 = time.perf_counter()
        _sweep()
        cur = torch.cuda.current_stream(device)
        static = {name: _map(lambda t: t.detach().clone(
            memory_format=torch.contiguous_format), v)
            for name, v in inputs.items()}
        bound.arguments.update(static)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm = self.fn(*bound.args, **bound.kwargs)
        cur.wait_stream(side)
        _map(lambda t: t.record_stream(cur), warm)
        # The capture allocates its temporaries again, from the graph
        # pool, and a capture cannot free cached blocks (no cudaFree while
        # capturing): release the warm-up's now, or a large program needs
        # twice its working set on the card.
        torch.cuda.empty_cache()

        counters = launch_counters()
        before = [f.launches for f in counters]
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(cur)
        pool_key = (device, cur.stream_id)
        if pool_key not in _POOLS:
            _POOLS[pool_key] = torch.cuda.graph_pool_handle()
        pool = _POOLS[pool_key]
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    outputs = self.fn(*bound.args, **bound.kwargs)
                finally:
                    graph.capture_end()
        finally:
            launches = [f.launches - b for f, b in zip(counters, before)]
            for f, b in zip(counters, before):
                f.launches = b
        cur.wait_stream(side)
        self._entries[key] = _Entry(graph, static, outputs, launches,
                                    residents, pool_key)
        _BUILT += 1
        _BUILD_S += time.perf_counter() - t0
        return warm

    @staticmethod
    def _replay(entry: _Entry, inputs: dict):
        for name, value in inputs.items():
            dst = entry.inputs[name]
            if isinstance(value, torch.Tensor):
                dst.copy_(value, non_blocking=True)
            else:
                for k, v in value.items():
                    dst[k].copy_(v, non_blocking=True)
        entry.graph.replay()
        for f, n in zip(launch_counters(), entry.launches):
            f.launches += n
        return _map(torch.clone, entry.outputs)


def _sweep() -> None:
    """Drop every program whose resident buffers were freed, and the
    pools no program uses any more: the allocator releases a pool with
    its last graph, so its handle cannot take another capture."""
    for p in _PROGRAMS:
        for key in [k for k, e in p._entries.items() if e.stale()]:
            del p._entries[key]
    used = {e.pool for p in _PROGRAMS for e in p._entries.values()}
    for key in [k for k in _POOLS if k not in used]:
        del _POOLS[key]


def program(fn, static=(), resident=()) -> Program:
    """``fn`` as a :class:`Program` (the counterpart of ``jax.jit(fn,
    static_argnames=static)``)."""
    return Program(fn, static, resident)

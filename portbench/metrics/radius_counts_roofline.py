"""Kernel: the ``radius_counts`` kernel's share of its roofline, in
percent: the least time of the launches that the window's first round
of queries makes, at the window's buckets (``roofline.launch_bound_s``),
over their time as a CUDA graph timed by CUDA events."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from portbench import roofline

KERNEL = "radius_counts"
GRAPH_REPS = 20


def launches() -> int:
    from repro_torch.kernels.knn_stats import kernel

    return kernel.radius_counts.launches


def _launches_of(index, batches: list, cfg: dict) -> list:
    """The launches of one eager ``query_many`` per bucket: each
    launch's inputs and arguments, as the main path made them."""
    from repro_torch import compile as programs
    from repro_torch.kernels.knn_stats import kernel, ops

    seen = []

    def spy(x, y, mask, **args):
        seen.append((x.clone(), y.clone(), mask.clone(), args))
        return kernel.radius_counts(x, y, mask, **args)

    ops.kernel = SimpleNamespace(radius_counts=spy)
    try:
        with programs.eager():
            for b in batches:
                index.query_many(b, top_k=cfg["top_k"],
                                 min_join=cfg["min_join"], k=cfg["k"])
    finally:
        ops.kernel = kernel
    torch.cuda.synchronize()
    return seen


def capture(index, batches: list, cfg: dict) -> dict:
    from repro_torch.kernels.knn_stats import kernel

    seen = _launches_of(index, batches, cfg)

    def once():
        for x, y, mask, args in seen:
            kernel.radius_counts(x, y, mask, **args)

    return {"launches": len(seen),
            "queries": sum(len(b) for b in batches),
            "bound_s": sum(roofline.launch_bound_s(m, a) for _, _, m, a in seen),
            "measured_s": roofline.graph_seconds(once, GRAPH_REPS) if seen
            else 0.0}


def read(ctx):
    rf = ctx.captured
    if not rf or not rf["launches"] or rf["measured_s"] <= 0:
        return None
    return 100.0 * rf["bound_s"] / rf["measured_s"]

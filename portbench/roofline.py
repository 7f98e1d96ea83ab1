"""The ``radius_counts`` kernel's least time, and a CUDA graph's time.

Peaks are NVIDIA's data sheet for one H100 SXM: 3.35 TB/s of HBM and 67
TFLOP/s of float32 outside the tensor cores, counting a fused
multiply-add as two, so a plain float instruction (subtract, abs, max,
compare) issues at half that; an SM has half as many INT32 lanes.

A launch's least time is the larger of its bytes over the HBM rate
(inputs read once: x, y float32 and the mask byte; outputs written
once: r float32, the class count and five counts int32, 37 bytes a
sample column) and its operations over the issue rates, by the cheaper
of the two sorted routes of the kernel's design, counted from the
launch's inputs alone (its B, each sample's valid P, k and the mode):

* one sort by x (log2(n!) compares a sample) and a y sweep over every
  valid (i, j != i) pair, RC_NEED_Y (float, int) a pair, and with
  ``which == "all"`` four binary searches a row (RC_NEED_STEP a step);
* two sorts (by y, then x) and RC_ROUTE_SEARCHES binary searches a row,
  and in class mode RC_ROUTE_RUN_SEARCHES more.

The terms that need the launch's radius (the band of joint selection,
the class merge, the x ties) are left out: the bound is a lower bound
on the work, so the share can read low, never high.  Nothing here asks
which body ran.
"""

from __future__ import annotations

import math

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
INT32_INSTR_PER_S = FP32_INSTR_PER_S / 2
RC_BYTES_PER_COLUMN = 9 + 28
RC_NEED_Y = {"all": (4, 2), "y": (3, 1)}
RC_NEED_SEARCHES, RC_NEED_STEP = 4, (2, 0)
RC_ROUTE_SEARCHES = {"all": 10, "y": 2}
RC_ROUTE_RUN_SEARCHES = 2


def _ops_s(f: float, i: float) -> float:
    return max((f + i) / FP32_INSTR_PER_S, i / INT32_INSTR_PER_S)


def launch_bound_s(mask: torch.Tensor, args: dict) -> float:
    """Least seconds for one launch on samples with this mask."""
    which = args["which"]
    n = mask.sum(-1, dtype=torch.float64)
    pairs = float((n * (n - 1)).sum())
    sort = float((torch.lgamma(n + 1) / math.log(2)).sum())
    search = float((n * torch.ceil(torch.log2(n + 1))).sum())
    step = RC_NEED_STEP[0]
    yf, yi = RC_NEED_Y[which]
    x_f = sort + pairs * yf + (RC_NEED_SEARCHES * search * step
                               if which == "all" else 0.0)
    two_f = 2 * sort + RC_ROUTE_SEARCHES[which] * search * step
    if args["mode"] == "class":
        two_f += RC_ROUTE_RUN_SEARCHES * search * step
    ops = min(_ops_s(x_f, pairs * yi), _ops_s(two_f, 0.0))
    return max(ops, mask.numel() * RC_BYTES_PER_COLUMN / HBM_BYTES_PER_S)


def graph_seconds(once, reps: int) -> float:
    """Seconds for one call of ``once`` (which launches work on the
    card): a CUDA graph of it, replayed ``reps`` times between CUDA
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        once()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        once()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / reps

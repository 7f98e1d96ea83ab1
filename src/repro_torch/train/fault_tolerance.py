"""Fault-tolerance utilities: preemption-safe shutdown, straggler
detection, elastic-rescale planning.

The port's copy of ``repro/train/fault_tolerance.py`` (plain Python).
What "fault tolerance" means here:

  * crash/restart   — ``CheckpointManager.try_resume`` + atomic saves; the
    training loop is a function of (state, data step), so a killed run
    resumes where its last checkpoint left it.
  * preemption      — a SIGTERM handler flips a flag; the train loop saves
    a final checkpoint at the next step boundary and exits
    ``PREEMPTED_EXIT_CODE`` (43; the launcher restarts it).
  * stragglers      — per-step wall-time EWMA; steps slower than
    ``threshold × EWMA`` increment a counter per host.  Here it logs and
    exposes metrics (the policy is unit-tested against synthetic
    timings).
  * elastic rescale — checkpoints hold full arrays, so a restart may use
    another device count; ``plan_batch_for_mesh`` rescales the per-shard
    microbatch to keep the global batch invariant.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

__all__ = ["PREEMPTED_EXIT_CODE", "PreemptionGuard", "StragglerMonitor",
           "plan_batch_for_mesh"]

PREEMPTED_EXIT_CODE = 43


class PreemptionGuard:
    """SIGTERM-aware flag for graceful checkpoint-and-exit."""

    def __init__(self, install: bool = True):
        self.requested = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handler)
            except ValueError:  # not the main thread (tests)
                pass

    def _handler(self, signum, frame):
        self.requested = True

    def trigger(self) -> None:  # for tests / simulated preemption
        self.requested = True


@dataclass
class StragglerMonitor:
    """EWMA step-time monitor with an outlier policy: a host whose times
    exceed ``threshold × EWMA`` for ``patience`` consecutive steps is
    flagged."""

    alpha: float = 0.1
    threshold: float = 2.0
    patience: int = 3
    ewma: float = 0.0
    _streaks: dict = field(default_factory=dict)
    flagged: list = field(default_factory=list)
    _t0: float | None = None

    def step_start(self) -> None:
        self._t0 = time.perf_counter()

    def step_end(self, host_id: int = 0, duration: float | None = None) -> bool:
        """Record a step; returns True if this host just got flagged."""
        if duration is None:
            assert self._t0 is not None, "step_start not called"
            duration = time.perf_counter() - self._t0
        if self.ewma == 0.0:
            self.ewma = duration
        slow = duration > self.threshold * self.ewma
        # Slow steps do not drag the baseline up.
        if not slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * duration
        streak = self._streaks.get(host_id, 0) + 1 if slow else 0
        self._streaks[host_id] = streak
        if streak >= self.patience and host_id not in self.flagged:
            self.flagged.append(host_id)
            return True
        return False


def plan_batch_for_mesh(global_batch: int, mesh_shape: dict) -> dict:
    """Keep the global batch invariant across mesh sizes: returns
    {'per_data_shard', 'grad_accum', 'dp'}; where the batch does not
    divide the data-parallel width, gradient accumulation makes up the
    difference."""
    dp = mesh_shape.get("pod", 1) * mesh_shape.get("data", 1)
    for accum in range(1, 65):
        if global_batch % accum:
            continue
        micro = global_batch // accum
        if micro % dp == 0:
            return {"per_data_shard": micro // dp, "grad_accum": accum,
                    "dp": dp}
    raise ValueError(f"global batch {global_batch} unsplittable over dp={dp}")

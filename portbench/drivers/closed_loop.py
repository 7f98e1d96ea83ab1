"""Closed loop through the service's micro-batch tier.

``callers`` clients each keep one query in flight through
``DiscoveryService.submit_async`` and send the next as soon as the last
is answered.  One client thread holds every caller: it waits on the
oldest query in flight, then collects every query that is done and
sends those callers' next queries in one ``submit_async`` call (callers
answered together ask again together, instead of one at a time behind
the client's own bookkeeping).  A query's time runs from just before
its ``submit_async`` to the client's first look after it resolved.
"""

from __future__ import annotations

import time
from collections import deque

from portbench.drivers import Window, compact, pool_order

_DRAIN_S = 60.0
_POLL_S = 0.05


class ClosedLoop:
    def __init__(self, index, cfg, traffic, sketches, discrete, seed):
        from repro_torch.core.discovery import DiscoveryService

        self.svc = DiscoveryService(index=index, k=cfg["k"],
                                    max_q_bucket=traffic["max_q_bucket"])
        self.sched = self.svc.scheduler(
            window_ms=traffic["window_ms"],
            pipeline_depth=traffic["pipeline_depth"],
            max_depth=traffic["max_depth"])
        self.opts = dict(priority=traffic["priority"], top_k=cfg["top_k"],
                         min_join=cfg["min_join"],
                         min_containment=traffic["min_containment"])
        self.callers = self.round_size = traffic["callers"]
        self.bucket = traffic["max_q_bucket"]
        self.sketches, self.discrete = sketches, discrete
        self.order = pool_order(discrete, seed)

    def _submit(self, n: int) -> list:
        """``n`` callers' next queries, in one ``submit_async`` call: the
        callers a window answered ask again together."""
        qs = [next(self.order) for _ in range(n)]
        t0 = time.perf_counter()
        handles = self.svc.submit_async([self.sketches[q] for q in qs],
                                        **self.opts)
        return [[q, t0, h] for q, h in zip(qs, handles)]

    @staticmethod
    def _answer(q, t0, handle, t1):
        out = handle.outcome()
        return (q, t0, t1, out.ok, compact(handle.result()) if out.ok else [])

    def run(self, seconds: float, tick=None) -> Window:
        start = time.perf_counter()
        win = Window(start, start + seconds)
        flight, done = self._submit(self.callers), []
        while True:
            now = time.perf_counter()
            if tick is not None:
                tick(now)
            if now >= win.end:
                break
            try:
                flight[0][2].wait(min(_POLL_S, win.end - now))
            except TimeoutError:
                continue
            t1 = time.perf_counter()
            ready, waiting = [], []
            for e in flight:
                (ready if e[2].done() else waiting).append(e)
            flight = waiting
            done += [(*e, t1) for e in ready]
            if t1 < win.end:
                flight += self._submit(len(ready))
        win.answers = [self._answer(*d) for d in done]
        for q, t0, handle in flight:
            try:
                handle.wait(_DRAIN_S)
            except TimeoutError:
                win.lost += 1
                continue
            win.late.append(self._answer(q, t0, handle, time.perf_counter()))
        return win

    def counters(self) -> dict:
        s = self.sched.stats_
        return {"windows": s.windows,
                "dispatched_buckets": s.dispatched_buckets,
                "coalesced_queries": s.coalesced_queries,
                "overlapped_windows": s.overlapped_windows}

    def close(self):
        self.svc.close()


def make(index, cfg, traffic, sketches, discrete, seed):
    return ClosedLoop(index, cfg, traffic, sketches, discrete, seed)

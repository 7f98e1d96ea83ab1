"""One caller calling ``SketchIndex.query_many`` back to back.

Each call carries ``batch`` queries of one target type, the types of
the pool taking turns call by call; every query of a call is timed from the call
to its return (the results are host lists, so the call has waited for
the device).  The service and scheduler layer is bypassed.
"""

from __future__ import annotations

import time

from portbench.drivers import Window, compact, pool_order


class BatchLoop:
    def __init__(self, index, cfg, traffic, sketches, discrete, seed):
        self.index, self.cfg = index, cfg
        self.batch = traffic["batch"]
        self.sketches = sketches
        self.orders = [pool_order(discrete, seed + i, dtype)
                       for i, dtype in enumerate(sorted(set(discrete.tolist())))]
        self.turn = 0
        self.round_size = self.bucket = self.batch

    def _call(self, ids):
        t0 = time.perf_counter()
        try:
            res = self.index.query_many(
                [self.sketches[q] for q in ids], top_k=self.cfg["top_k"],
                min_join=self.cfg["min_join"], k=self.cfg["k"])
        except RuntimeError:
            t1 = time.perf_counter()
            return [(q, t0, t1, False, []) for q in ids]
        t1 = time.perf_counter()
        return [(q, t0, t1, True, compact(r)) for q, r in zip(ids, res)]

    def run(self, seconds: float, tick=None) -> Window:
        start = time.perf_counter()
        win = Window(start, start + seconds)
        while True:
            now = time.perf_counter()
            if tick is not None:
                tick(now)
            if now >= win.end:
                return win
            order = self.orders[self.turn]
            self.turn = (self.turn + 1) % len(self.orders)
            answers = self._call([next(order) for _ in range(self.batch)])
            (win.answers if answers[0][2] <= win.end else win.late).extend(answers)

    def counters(self) -> dict:
        return {}

    def close(self):
        pass


def make(index, cfg, traffic, sketches, discrete, seed):
    return BatchLoop(index, cfg, traffic, sketches, discrete, seed)

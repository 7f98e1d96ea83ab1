"""Traffic drivers: ``<name>.py`` holds ``make(index, cfg, traffic,
sketches, discrete, seed)``, which returns a driver with

* ``run(seconds, tick=None)`` -> :class:`Window`: drive the traffic for
  ``seconds`` on the client's clock, calling ``tick(now)`` between
  waits, and return every answer observed in that time;
* ``counters()``: the service layer's counters ({} where it has none);
* ``close()``;

and the attributes ``round_size`` (the queries a caller or the callers
send at once: the window's first round) and ``bucket`` (the most
queries of one target type that one program call takes).

Each answer is (pool id, submitted, answered, ok, [(table, mi, join
size), ...]) with ``time.perf_counter`` stamps taken by the client.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Window:
    start: float
    end: float
    answers: list = field(default_factory=list)
    late: list = field(default_factory=list)  # answered after the close
    lost: int = 0  # never answered


def pool_order(discrete: np.ndarray, seed: int, dtype: bool | None = None):
    """An endless order of pool ids drawn from the seed: whole shuffled
    passes over the pool (or over its ``dtype`` half), so every seed
    sends the same mix in another order."""
    rng = np.random.default_rng(seed)
    ids = np.arange(len(discrete)) if dtype is None else \
        np.flatnonzero(discrete == dtype)
    while True:
        yield from rng.permutation(ids).tolist()


def window_buckets(answers: list, discrete, round_size: int,
                   bucket: int) -> list:
    """The pool ids of the window's first round of answers, split by
    target type and cut into buckets as the program takes them."""
    first = [a[0] for a in answers[:round_size]]
    out = []
    for dtype in sorted({bool(discrete[q]) for q in first}):
        ids = [q for q in first if bool(discrete[q]) == dtype]
        out += [ids[i:i + bucket] for i in range(0, len(ids), bucket)]
    return out


def compact(result) -> list:
    return [(meta.table, float(mi), int(js)) for meta, mi, js in result]

"""A lake of equal-sized columns in three containment classes.

The tiered-gate lake of the reference package's discovery benchmark
(``benchmarks/discovery_scale.py``, ``_TIERED_BENCH_SCRIPT``), drawn on
the card: C columns of R rows, keyed by murmur3 hashes (``key_seed``) of
raw row numbers, and one query table keyed 0..R-1 with a target y ~
N(0, 1).  By column index c:

* a hit (c % (C // ``hits``) == 0) shares the query's R keys, with
  values a * y + (1 - a) * noise, a ~ U(``alpha_min``, ``alpha_max``);
* a mid (else c % (C // ``mids``) == 0) shares ``mid_shared_rows`` raw
  rows of the query's and has R - ``mid_shared_rows`` of its own;
* a far column has R raw rows of its own.

The j-th column that is no hit (j = 1, 2, ...) owns raw rows j * R
onwards.  Every value is continuous, noise N(0, 1).  The query pool is
``query_pool`` targets a * y + (1 - a) * noise, a drawn as for a hit.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.lakes import Lake
from portbench.reference.murmur3 import murmur3_32


def make(cfg: dict, seed: int, device) -> Lake:
    C, R = cfg["n_candidates"], cfg["rows_per_table"]
    shared, pool = cfg["mid_shared_rows"], cfg["query_pool"]
    lo, hi = cfg["alpha_min"], cfg["alpha_max"]
    g = torch.Generator(device=device).manual_seed(seed)

    c = torch.arange(C, device=device)
    hit = c % (C // cfg["hits"]) == 0
    mid = ~hit & (c % (C // cfg["mids"]) == 0)
    own = torch.cumsum((~hit).long(), 0)  # j of the j-th column not a hit
    r = torch.arange(R, device=device)
    words = own[:, None] * R + r
    words = torch.where(mid[:, None] & (r < shared), r, words)
    words = torch.where(mid[:, None] & (r >= shared), words - shared, words)
    words = torch.where(hit[:, None], r, words)
    keys = murmur3_32(words, cfg["key_seed"])

    y = torch.randn(R, generator=g, device=device)
    a = lo + (hi - lo) * torch.rand(C, 1, generator=g, device=device)
    noise = torch.randn(C, R, generator=g, device=device)
    values = torch.where(hit[:, None], a * y + (1 - a) * noise, noise)

    qa = lo + (hi - lo) * torch.rand(pool, 1, generator=g, device=device)
    targets = qa * y + (1 - qa) * torch.randn(pool, R, generator=g,
                                              device=device)
    query_keys = murmur3_32(r, cfg["key_seed"])
    return Lake([f"t{i:05d}" for i in range(C)], keys, values.contiguous(),
                np.zeros(C, dtype=bool), query_keys, targets.contiguous(),
                np.zeros(pool, dtype=bool))

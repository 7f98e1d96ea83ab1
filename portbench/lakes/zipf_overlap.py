"""A lake of large tables with skewed keys and partial overlap.

The analogue of arXiv:2403.15553 Table II's lakes that the reference
package builds (``benchmarks/paper_tables.py``, ``bench_table2_corpus``),
laid out as one query table and C candidates:

* keys are Zipf(``zipf_a``) draws, truncated at ``zipf_max``, taken
  modulo the table's distinct-key count n_c ~ U{``keys_min``,
  ``keys_max``}; the query table's count is ``query_keys``;
* a candidate overlaps the query's key domain with probability o ~
  U(``overlap_min``, ``overlap_max``); otherwise its keys are shifted by
  the query's key count out of it (the analogue's shift: the train
  side's key count);
* every value depends on a per-key base signal by alpha ~ U(0, 1):
  alpha * base[key] + (1 - alpha) * noise; one candidate in
  ``discrete_every`` is discrete, floor(2x);
* the query pool is ``query_pool`` continuous targets, as the
  analogue's train side always is.

Key counts, keys, overlaps and the query table's keys are drawn from
``layout_seed``, as the analogue draws its pairs from one fixed seed;
the run seed permutes the candidates and draws every value.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.lakes import Lake
from portbench.reference.murmur3 import murmur3_32


def _zipf(cdf: torch.Tensor, shape, g) -> torch.Tensor:
    u = torch.rand(shape, generator=g, dtype=torch.float64, device=cdf.device)
    return torch.searchsorted(cdf, u * cdf[-1]).clamp_(max=cdf.numel() - 1) + 1


def make(cfg: dict, seed: int, device) -> Lake:
    C, R = cfg["n_candidates"], cfg["rows_per_table"]
    pool, shift = cfg["query_pool"], cfg["query_keys"]
    # The sizes (key counts, keys, overlaps) come from the layout seed, so
    # every run seed joins the same sizes; the run seed orders the
    # candidates and draws the values.
    s = torch.Generator(device=device).manual_seed(cfg["layout_seed"])
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.arange(1, cfg["zipf_max"] + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(v ** -cfg["zipf_a"], 0)

    n_c = torch.randint(cfg["keys_min"], cfg["keys_max"] + 1, (C, 1),
                        generator=s, device=device)
    raw = _zipf(cdf, (C, R), s) % n_c
    lo, hi = cfg["overlap_min"], cfg["overlap_max"]
    overlap = lo + (hi - lo) * torch.rand(C, 1, generator=s, device=device,
                                          dtype=torch.float64)
    outside = torch.rand(C, 1, generator=s, device=device,
                         dtype=torch.float64) >= overlap
    raw = raw + outside * shift
    disc = torch.arange(C, device=device) % cfg["discrete_every"] == 0
    q_raw = _zipf(cdf, (R,), s) % shift
    order = torch.randperm(C, generator=g, device=device)
    raw, disc = raw[order], disc[order]

    base = torch.randn(2 * shift, generator=g, device=device)
    alpha = torch.rand(C, 1, generator=g, device=device)
    values = alpha * base[raw] + (1 - alpha) * torch.randn(
        C, R, generator=g, device=device)
    values = torch.where(disc[:, None], torch.floor(2 * values), values)
    q_alpha = torch.rand(pool, 1, generator=g, device=device)
    targets = q_alpha * base[q_raw] + (1 - q_alpha) * torch.randn(
        pool, R, generator=g, device=device)
    key_seed = cfg["key_seed"]
    return Lake([f"t{i:05d}" for i in range(C)], murmur3_32(raw, key_seed),
                values.contiguous(), disc.cpu().numpy(),
                murmur3_32(q_raw, key_seed), targets.contiguous(),
                np.zeros(pool, dtype=bool))

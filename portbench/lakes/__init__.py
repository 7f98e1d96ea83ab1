"""Lake generators: ``<name>.py`` holds ``make(cfg, seed, device)``, which
returns a :class:`Lake` drawn from the seed, on ``device``."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Lake:
    """Raw tables of one lake, one row a table, and its query table.

    ``keys`` (C, R) int64 hold uint32 key hashes, ``values`` (C, R)
    float32 (a discrete table's codes are small integers); ``query_keys``
    (Rq,) is the query table's key column and ``query_values`` (Q, Rq)
    the pool of query targets, ``query_discrete`` (Q,) their types.
    """

    names: list
    keys: torch.Tensor
    values: torch.Tensor
    discrete: np.ndarray
    query_keys: torch.Tensor
    query_values: torch.Tensor
    query_discrete: np.ndarray

    def host_tables(self):
        """(keys (C, R) uint32, values (C, R) float32) as numpy."""
        return (self.keys.cpu().numpy().astype(np.uint32),
                self.values.cpu().numpy())


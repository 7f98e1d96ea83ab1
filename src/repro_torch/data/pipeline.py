"""Training data pipelines of the PyTorch port.

  * :class:`AugmentedTabularPipeline` — the paper's use case: a base
    table is augmented with the top-k features discovered by MI sketches
    (:mod:`repro_torch.core.discovery`), and (features, target) rows are
    served for model training.  It is the bridge between the discovery
    layer and a model.

The reference's ``TokenPipeline`` (the synthetic language-model stream)
waits for the training slice of the port (ROADMAP.md, queue 1: training).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.discovery import SketchIndex
from repro_torch.core.join import full_left_join
from repro_torch.core.sketch import build_sketch

__all__ = ["AugmentedTabularPipeline"]


@dataclass
class AugmentedTabularPipeline:
    """Discovery-driven relational augmentation feeding model training.

    Given a base table (key, target) and a repository index, it ranks the
    candidate features by sketch-estimated MI (the index's ``query``, on
    the index's device), materializes ONLY the top-k joins on the host
    (the paper's point: k ≪ |repository|), and returns standardized
    features with missing values imputed by column means.
    """

    index: SketchIndex
    tables: dict  # (table, column) -> (key_hashes, values) to materialize
    top_k: int = 8
    min_join: int = 64

    def build(self, base_key_hashes: np.ndarray, target: np.ndarray,
              target_is_discrete: bool = False):
        """Returns (features (rows, k) float32, names), the names as
        ``"table.column|mi=..."`` in ranked order."""
        train_sk = build_sketch(
            base_key_hashes, target, n=self.index.n, method=self.index.method,
            side="train", value_is_discrete=target_is_discrete,
        )
        ranked = self.index.query(train_sk, top_k=self.top_k,
                                  min_join=self.min_join)
        feats, names = [], []
        for meta, mi, _join_size in ranked:
            key_hashes, values = self.tables[(meta.table, meta.value_column)]
            fj = full_left_join(base_key_hashes, target, key_hashes, values,
                                agg=self.index.agg)
            feats.append(np.where(fj.mask, fj.x, np.nan).astype(np.float32))
            names.append(f"{meta.table}.{meta.value_column}|mi={mi:.3f}")
        x = np.stack(feats, axis=1) if feats else np.zeros((len(target), 0))
        # Standardize, imputing missing values with the column means.
        mean = np.nanmean(x, axis=0) if x.size else np.zeros(x.shape[1])
        std = np.nanstd(x, axis=0) + 1e-6 if x.size else np.ones(x.shape[1])
        x = np.where(np.isnan(x), mean, x)
        x = (x - mean) / std
        return x.astype(np.float32), names

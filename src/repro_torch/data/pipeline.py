"""Training data pipelines of the PyTorch port.

  * :class:`TokenPipeline` — the deterministic synthetic LM stream of
    ``repro/data/pipeline.py``.  Batches are a pure function of (seed,
    step) through the same murmur3 hashing the sketches use (numpy, on
    the host, as the reference), so a restart resumes exactly (the
    iterator state is one integer, saved in every checkpoint) and each
    data host makes only its rows of the global batch.  Tokens follow a
    noisy affine recurrence over the vocab, so a model has structure to
    learn; the audio and vision batches carry the stubs' frame and patch
    embeddings from numpy generators.  Every batch equals the reference's
    bit for bit.

  * :class:`AugmentedTabularPipeline` — the paper's use case: a base
    table is augmented with the top-k features discovered by MI sketches
    (:mod:`repro_torch.core.discovery`), and (features, target) rows are
    served for model training.  It is the bridge between the discovery
    layer and a model.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import hashing
from repro_torch.core.discovery import SketchIndex
from repro_torch.core.join import full_left_join
from repro_torch.core.sketch import build_sketch

__all__ = ["TokenPipeline", "AugmentedTabularPipeline"]


class TokenPipeline:
    """Deterministic synthetic token batches for a configuration and shape:
    ``next_batch()`` gives ``{"batch": {...}, "labels", "loss_mask"}`` as
    numpy arrays (``batch`` holds ``tokens``, plus ``patch_embeds`` for the
    vision stub, or ``frame_embeds`` alone for the audio stub)."""

    def __init__(self, cfg: ModelConfig, *, batch: int, seq: int, seed: int = 0,
                 num_hosts: int = 1, host_id: int = 0):
        assert batch % num_hosts == 0, (batch, num_hosts)
        self.cfg = cfg
        self.global_batch = batch
        self.seq = seq
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.step = 0

    # -- checkpointable iterator state ------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        assert int(state["seed"]) == self.seed, "pipeline seed mismatch"

    # -- generation --------------------------------------------------------
    def _tokens(self, step: int, rows: np.ndarray, seq: int) -> np.ndarray:
        """(step, row) -> token sequences: with probability 1/8 the next
        token is a hash-random jump, otherwise tok_{t+1} = (5 tok_t + 1)
        mod V, so a model that learns the map nears H = (1/8) ln V."""
        V = max(self.cfg.vocab_size - 1, 2)
        a = 5
        n = len(rows)
        base = hashing.murmur3_32_np(rows.astype(np.uint32),
                                     seed=np.uint32(self.seed ^ step))
        toks = np.empty((n, seq), dtype=np.int64)
        toks[:, 0] = base % V
        for t in range(1, seq):
            h = hashing.murmur3_32_np(base ^ np.uint32(t),
                                      seed=np.uint32(self.seed))
            jump = (h >> np.uint32(3)) % V
            noisy = (h % np.uint32(8)) == 0
            toks[:, t] = np.where(noisy, jump, (a * toks[:, t - 1] + 1) % V)
        return toks.astype(np.int32)

    def next_batch(self) -> dict:
        cfg = self.cfg
        per_host = self.global_batch // self.num_hosts
        rows = np.arange(per_host) + self.host_id * per_host \
            + self.step * self.global_batch
        seq = self.seq
        step = self.step
        self.step += 1

        if cfg.modality == "audio_stub":
            rng = np.random.default_rng(self.seed * 1_000_003 + step)
            frames = rng.normal(size=(per_host, seq, cfg.d_model)).astype(np.float32)
            labels = rng.integers(
                0, cfg.vocab_size, size=(per_host, seq, cfg.num_codebooks)
            ).astype(np.int32)
            return {"batch": {"frame_embeds": frames}, "labels": labels,
                    "loss_mask": np.ones(labels.shape, np.float32)}

        toks = self._tokens(step, rows, seq + 1)
        inputs, labels = toks[:, :-1], toks[:, 1:]

        if cfg.modality == "vision_stub":
            P = cfg.num_patches
            rng = np.random.default_rng(self.seed * 7_000_003 + step)
            patches = rng.normal(size=(per_host, P, cfg.d_model)).astype(np.float32)
            # The logits cover patches + text; patch positions are masked
            # out of the loss.
            labels_full = np.concatenate(
                [np.zeros((per_host, P), np.int32), toks[:, 1:seq - P + 1]],
                axis=1)
            mask_full = np.concatenate(
                [np.zeros((per_host, P), np.float32),
                 np.ones((per_host, seq - P), np.float32)], axis=1)
            return {"batch": {"tokens": inputs[:, :seq - P],
                              "patch_embeds": patches},
                    "labels": labels_full, "loss_mask": mask_full}

        return {"batch": {"tokens": inputs}, "labels": labels,
                "loss_mask": np.ones(labels.shape, np.float32)}


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

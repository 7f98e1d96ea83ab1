"""State carry: build the port's index from a corpus held as numpy.

This system has no weights; its state is the sketch corpus.
:func:`index_from_numpy` takes the per-candidate host arrays a
``SketchIndex`` of either package keeps — keys, the two value views,
masks, discreteness and the candidate metadata — and commits them to a
port index without re-sketching, so both packages score the identical
corpus.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.discovery.index import CandidateMeta, SketchIndex

__all__ = ["index_from_numpy"]


def index_from_numpy(state: dict, device=None) -> SketchIndex:
    """A port :class:`SketchIndex` holding the corpus in ``state``.

    ``state`` keys: ``n``, ``method``, ``agg``; ``keys`` (C, cap) uint32
    key hashes; ``vals_f`` (C, cap) float32; ``vals_u`` (C, cap) uint32
    (or int64 already zero-extended); ``masks`` (C, cap) bool;
    ``meta``: C tuples (table, key_column, value_column,
    value_is_discrete).  Candidate keys must satisfy the sorted-at-ingest
    invariant (valid keys strictly ascending); this is checked.
    """
    index = SketchIndex(n=state["n"], method=state["method"],
                        agg=state["agg"], device=device)
    keys = np.asarray(state["keys"], dtype=np.uint32)
    vals_f = np.asarray(state["vals_f"], dtype=np.float32)
    vals_u = np.asarray(state["vals_u"]).astype(np.int64) & 0xFFFFFFFF
    masks = np.asarray(state["masks"], dtype=bool)
    meta = list(state["meta"])
    C = len(meta)
    for name, a in (("keys", keys), ("vals_f", vals_f), ("vals_u", vals_u),
                    ("masks", masks)):
        if a.ndim != 2 or a.shape[0] != C:
            raise ValueError(f"{name} has shape {a.shape}, expected ({C}, cap)")
    for c in range(C):
        size = int(masks[c].sum())
        if not masks[c, :size].all() or not np.all(
            np.diff(keys[c, :size].astype(np.int64)) > 0
        ):
            raise ValueError(
                f"candidate {c} violates the sorted-at-ingest key invariant"
            )
        index._commit_arrays(
            CandidateMeta(*meta[c][:3], bool(meta[c][3])),
            keys[c], vals_f[c], vals_u[c], masks[c],
        )
    return index

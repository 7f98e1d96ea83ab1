"""State carry: build the port's state from the reference's, held as numpy.

:func:`index_from_numpy` carries the discovery engine's state, the sketch
corpus; :func:`stacked_from_numpy` carries the ad-hoc scorers' inputs, a
stacked candidate dict or a train dict; :func:`model_params_from_numpy`
carries a model's weights.

:func:`index_from_numpy` takes the per-candidate host arrays a
``SketchIndex`` of either package keeps — keys, the two value views,
masks, discreteness and the candidate metadata — and commits them to a
port index without re-sketching, so both packages score the identical
corpus.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, scan_grouping
from repro_torch.core.discovery.index import CandidateMeta, SketchIndex
from repro_torch.device import resolve_device
from repro_torch.models import transformer

__all__ = ["index_from_numpy", "model_params_from_numpy", "stacked_from_numpy"]


def index_from_numpy(state: dict, device=None) -> SketchIndex:
    """A port :class:`SketchIndex` holding the corpus in ``state``.

    ``state`` keys: ``n``, ``method``, ``agg``; ``keys`` (C, cap) uint32
    key hashes; ``vals_f`` (C, cap) float32; ``vals_u`` (C, cap) uint32
    (or int64 already zero-extended); ``masks`` (C, cap) bool;
    ``meta``: C tuples (table, key_column, value_column,
    value_is_discrete); optional ``sig_width`` (default 16), the phase-0
    signature width of the index mirrored.  Candidate keys must satisfy
    the sorted-at-ingest invariant (valid keys strictly ascending); this
    is checked.
    """
    index = SketchIndex(n=state["n"], method=state["method"],
                        agg=state["agg"], device=device,
                        sig_width=state.get("sig_width", 16))
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


def stacked_from_numpy(d: dict, device=None) -> dict:
    """The port's tensors for a reference stacked candidate dict or train
    dict, read as numpy (any leading shape).

    ``keys`` and ``vals_u`` (uint32) become zero-extended int64,
    ``vals_f`` float32, ``mask`` bool and ``est_id``, when present,
    int32; ``y_discrete``, when present, passes as a bool.  No key order
    is assumed or checked, so hand-made and unsorted dicts carry as they
    are.
    """
    dev = resolve_device(device)
    out = {
        "keys": np.asarray(d["keys"]).astype(np.int64) & 0xFFFFFFFF,
        "vals_f": np.asarray(d["vals_f"], dtype=np.float32),
        "vals_u": np.asarray(d["vals_u"]).astype(np.int64) & 0xFFFFFFFF,
        "mask": np.asarray(d["mask"], dtype=bool),
    }
    if "est_id" in d:
        out["est_id"] = np.asarray(d["est_id"], dtype=np.int32)
    tensors = {name: torch.tensor(a, device=dev) for name, a in out.items()}
    if "y_discrete" in d:
        tensors["y_discrete"] = bool(d["y_discrete"])
    return tensors


def _leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaves(v) for v in tree.values())
    return 1


def model_params_from_numpy(cfg: ModelConfig, tree: dict, device=None):
    """The port's parameters (``transformer.init_params`` layout) holding
    the weights of a reference parameter pytree.

    ``tree`` is the reference's ``init_params`` output as nested dicts of
    numpy arrays: ``embedding/table``, ``final_norm``, ``lm_head`` (unless
    tied), ``prefix{i}`` layers and ``groups/layer{i}`` stacked on a
    leading axis of ``num_groups``.  Layer ``L`` of the port is prefix
    layer ``L`` or, after the prefix, group ``g``'s ``layer{i}`` with
    ``g, i = divmod(L - len(prefix), len(group))``.  Leaves map name for
    name, a Mamba2 mixer's bare ``A_log`` / ``dt_bias`` / ``D`` beside its
    ``in_proj`` / ``conv`` / ``ssm_norm`` / ``out_proj``.  Weights keep the
    reference's (in, out) layout, so every leaf is a copy, never a
    transpose.  Shapes are checked, and every leaf must be used.
    """
    dev = resolve_device(device)
    prefix, num_groups, group = scan_grouping(cfg)
    params = transformer.init_params(cfg, None, device="meta").to_empty(device=dev)
    used = 0
    for name, p in params.named_parameters():
        parts = name.split(".")
        sub, g = tree, None
        if parts[0] == "layers":
            L = int(parts[1])
            if L < len(prefix):
                sub = tree[f"prefix{L}"]
            else:
                g, i = divmod(L - len(prefix), len(group))
                sub = tree["groups"][f"layer{i}"]
            parts = parts[2:]
        for key in parts:
            sub = sub[key]
        a = np.asarray(sub if g is None else np.asarray(sub)[g])
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape}, expected {tuple(p.shape)}")
        if a.dtype.name == "bfloat16":  # numpy has no bfloat16; exact via f32
            a = a.astype(np.float32)
        with torch.no_grad():
            p.copy_(torch.tensor(a))
        used += g in (None, 0)  # a stacked leaf counts once
    if used != _leaves(tree):
        raise ValueError(f"the tree holds {_leaves(tree)} leaves; "
                         f"{used} map onto the port's parameters")
    return params

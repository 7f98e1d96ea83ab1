"""State carry: build the port's state from the reference's, held as numpy.

:func:`index_from_numpy` carries the discovery engine's state, the sketch
corpus; :func:`stacked_from_numpy` carries the ad-hoc scorers' inputs, a
stacked candidate dict or a train dict; :func:`model_params_from_numpy`
carries a model's weights and :func:`train_state_from_numpy` its AdamW
state.

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

__all__ = ["index_from_numpy", "model_params_from_numpy", "reference_leaf",
           "stacked_from_numpy", "train_state_from_numpy"]


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


def _reference_node(cfg: ModelConfig, tree: dict, name: str):
    """(node, g): the subtree of the reference tree ``tree`` (parameters or
    a moment tree of the same structure) that the port's parameter
    ``name`` maps to, and the group index ``g`` to take from each of its
    arrays (None outside the stacked groups); see
    :func:`model_params_from_numpy`."""
    prefix, _, group = scan_grouping(cfg)
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
    return sub, g


def _array(a, g) -> np.ndarray:
    a = np.asarray(a if g is None else np.asarray(a)[g])
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16; exact via f32
        a = a.astype(np.float32)
    return a


def reference_leaf(cfg: ModelConfig, tree: dict, name: str):
    """The numpy array (or dict of arrays: a quantized moment) of the
    reference tree ``tree`` that the port's parameter ``name`` maps to,
    its layer's slice of a stacked group taken."""
    node, g = _reference_node(cfg, tree, name)

    def take(n):
        return {k: take(v) for k, v in n.items()} if isinstance(n, dict) \
            else _array(n, g)
    return take(node)


def model_params_from_numpy(cfg: ModelConfig, tree: dict, device=None):
    """The port's parameters (``transformer.init_params`` layout) holding
    the weights of a reference parameter pytree.

    ``tree`` is the reference's ``init_params`` output as nested dicts of
    numpy arrays: ``embedding/table``, ``final_norm``, ``lm_head`` (unless
    tied; the audio stub's ``head{c}`` instead), the vision stub's
    ``patch_proj``, ``prefix{i}`` layers and ``groups/layer{i}`` stacked
    on a leading axis of ``num_groups``.  Layer ``L`` of the port is
    prefix layer ``L`` or, after the prefix, group ``g``'s ``layer{i}``
    with ``g, i = divmod(L - len(prefix), len(group))``.  Leaves map name
    for name, a Mamba2 mixer's bare ``A_log`` / ``dt_bias`` / ``D`` beside
    its ``in_proj`` / ``conv`` / ``ssm_norm`` / ``out_proj``.  Weights keep
    the reference's (in, out) layout, so every leaf is a copy, never a
    transpose.  Shapes are checked, and every leaf must be used.
    """
    dev = resolve_device(device)
    params = transformer.init_params(cfg, None, device="meta").to_empty(device=dev)
    used = 0
    for name, p in params.named_parameters():
        sub, g = _reference_node(cfg, tree, name)
        a = _array(sub, g)
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape}, expected {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.tensor(a))
        used += g in (None, 0)  # a stacked leaf counts once
    if used != _leaves(tree):
        raise ValueError(f"the tree holds {_leaves(tree)} leaves; "
                         f"{used} map onto the port's parameters")
    return params


def train_state_from_numpy(cfg: ModelConfig, opt_state, params):
    """The port's AdamW state (``train.optimizer.AdamWState``) for the
    parameters ``params`` (a port model, on its device) holding a
    reference ``AdamWState`` read as numpy: ``step`` and the moment trees
    ``mu`` / ``nu``, shaped as the reference's parameters, whose leaves
    are float32 moments or, quantized, ``{"q": codes, "s": row scales}``.
    Leaves map as :func:`model_params_from_numpy` maps parameters."""
    from repro_torch.train.optimizer import AdamWState

    def carry(node, dev):
        if isinstance(node, dict):
            return {k: carry(v, dev) for k, v in node.items()}
        return torch.from_numpy(node.copy()).to(dev)

    mu, nu = {}, {}
    for name, p in params.named_parameters():
        for out, tree in ((mu, opt_state.mu), (nu, opt_state.nu)):
            out[name] = carry(reference_leaf(cfg, tree, name), p.device)
    dev = next(params.parameters()).device
    step = torch.tensor(int(np.asarray(opt_state.step)), dtype=torch.int32,
                        device=dev)
    return AdamWState(step, mu, nu)

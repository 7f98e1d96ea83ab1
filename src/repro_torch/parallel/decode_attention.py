"""One-token attention against a KV cache (decode), context-parallel on
a mesh.

The port's counterpart of ``repro/parallel/decode_attention.py``, in
plain torch (the reference has no Pallas kernel here; XLA fuses it).

At decode time the KV cache dominates memory and bandwidth, so on a mesh
the cache *sequence* is split over shards (flash-decoding): every shard
attends over its own KV rows and the partial (max, denominator,
weighted value) triples merge with one max and two sums of O(B·H·Dh),
independent of S.  The reference runs the shards under ``shard_map`` and
merges with ``pmax`` / ``psum``; the port runs one computation per shard
on the shard's device and merges the partials on the mesh's first
device, in shard order.  Only the partials move between devices.

Axis selection (the reference's, :func:`cache_spec`):
  * the batch divides ('pod', 'data') -> batch over those, the KV
    sequence over 'model';
  * otherwise the sequence over every axis ('pod', 'data', 'model');
  * a sequence the shard count does not divide, or a mesh without
    'model', computes unsharded.

A cache the batcher keeps on a mesh is a
:class:`~repro_torch.parallel.sharding.ShardedTensor` laid out by
:func:`cache_spec`; a whole cache under a mesh is split on the fly (views
where the shards share its device).  Without a mesh the same math runs
whole.  On ``meta`` (the dry run) one partial over the whole cache stands
for the shards' partials: the same FLOPs and merges, no loop.
"""

from __future__ import annotations

import torch

from repro_torch.device import canonical_device
from repro_torch.parallel.sharding import (NamedSharding, P, ShardedTensor,
                                           _blocks_per_dim, current_mesh,
                                           manual_axes_scope,
                                           record_collective, shard_tensor)

__all__ = ["decode_attention", "cache_spec"]

_NEG_INF = -1e30


def _local_decode(q, k, v, pos, scale, *, global_offset: int = 0,
                  axis_names: tuple = ()):
    """Attention over a (local) KV slice.

    q (B, H, Dh); k / v (B, S_l, Hkv, Dh) holding global rows
    ``global_offset`` onwards; ``pos`` the last live row, an int or a
    0-dim tensor on k's device.  Without ``axis_names`` returns the
    output (B, H, Dh) in q's dtype.  With them (the shard's mesh axes)
    returns the partial (m (B, Hkv, g), l (B, Hkv, g), o (B, Hkv, g, Dh))
    in float32 that :func:`_merge` combines across those axes; a slice
    with no live row contributes exact zeros (its masked scores would
    give exp(0) = 1 everywhere).
    """
    B, S_l, Hkv, Dh = k.shape
    H = q.shape[1]
    qf = q.reshape(B, Hkv, H // Hkv, Dh).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * scale
    live = (global_offset + torch.arange(S_l, device=k.device)) <= pos
    scores = torch.where(live, scores, torch.full_like(scores, _NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    if axis_names:
        any_live = global_offset <= pos
        if isinstance(any_live, torch.Tensor):
            p = torch.where(any_live, p, torch.zeros_like(p))
        elif not any_live:
            p = torch.zeros_like(p)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    if axis_names:
        return m[..., 0], l, o
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, Dh).to(q.dtype)


def _merge(parts: list) -> torch.Tensor:
    """The partials of one batch block's shards, in shard order, on one
    device: the reference's ``pmax`` then two ``psum``; (B, Hkv, g, Dh)."""
    m_glob = parts[0][0]
    for m, _l, _o in parts[1:]:
        m_glob = torch.maximum(m_glob, m)
    l_sum = o_sum = None
    for m, l, o in parts:
        corr = torch.exp(m - m_glob)
        lc, oc = l * corr, o * corr[..., None]
        l_sum = lc if l_sum is None else l_sum + lc
        o_sum = oc if o_sum is None else o_sum + oc
    return o_sum / torch.clamp_min(l_sum, 1e-30)[..., None]


def cache_spec(mesh, B: int, S: int):
    """The reference's layout of a (B, S, Hkv, Dh) cache on ``mesh``: a
    spec, or None where the attention computes unsharded."""
    if mesh is None or "model" not in mesh.shape:
        return None
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    batch_div = 1
    for a in batch_axes:
        batch_div *= mesh.shape[a]
    if B % batch_div == 0 and batch_div > 1:
        seq_axes = ("model",)
    else:
        batch_axes = ()
        seq_axes = tuple(a for a in ("pod", "data", "model")
                         if a in mesh.shape)
    seq_div = 1
    for a in seq_axes:
        seq_div *= mesh.shape[a]
    if S % seq_div:
        return None  # the reference computes unsharded (replicated)
    return P(batch_axes or None,
             seq_axes if len(seq_axes) > 1 else seq_axes[0], None, None)


def _cp_decode(q, k: ShardedTensor, v: ShardedTensor, pos, scale):
    """One partial per (batch block, sequence block) on the block's
    device, merged per batch block on the mesh's first device in
    sequence-block order; the batch blocks concatenated in order."""
    mesh = k.sharding.mesh
    first = canonical_device(mesh.devices.flat[0])
    B, H, Dh = q.shape
    nb = k.shape[0] // k.block_shape[0]
    ns = k.shape[1] // k.block_shape[1]
    Bl, Sl = k.block_shape[:2]
    seq_axes = k.sharding.spec[1]
    seq_axes = seq_axes if isinstance(seq_axes, tuple) else (seq_axes,)
    outs = []
    with manual_axes_scope(mesh.axis_names):
        for b in range(nb):
            parts = []
            for s in range(ns):
                kp, vp = k.block((b, s, 0, 0)), v.block((b, s, 0, 0))
                dev = kp.device
                p_dev = pos.to(dev) if isinstance(pos, torch.Tensor) else pos
                part = _local_decode(q[b * Bl:(b + 1) * Bl].to(dev), kp, vp,
                                     p_dev, scale, global_offset=s * Sl,
                                     axis_names=seq_axes)
                parts.append(tuple(t.to(first) for t in part))
            outs.append(_merge(parts))
    _record_merge(parts[0], seq_axes, ns)
    out = outs[0] if nb == 1 else torch.cat(outs)
    return out.reshape(B, H, Dh).to(q.dtype)


def _record_merge(part, seq_axes: tuple, ns: int, nb: int = 1) -> None:
    """The reference's pmax of m and psums of l and o over the sequence
    axes, each of one batch block's float32 partial (``part`` holds ``nb``
    batch blocks)."""
    for t in part:
        record_collective("all-reduce", seq_axes, t.numel() // nb * 4, ns)


def _meta_cp_decode(q, k, v, pos, scale, sharding: NamedSharding):
    """:func:`_cp_decode` on ``meta`` (the dry run), where no value
    exists: one partial over the whole cache stands for the shards'
    partials (their einsums are blocks of its einsums, so the FLOPs are
    the same) and the same merges are recorded, with no loop over the
    shards."""
    nb, ns = _blocks_per_dim(sharding, k.dim())[:2]
    seq_axes = sharding.spec[1]
    seq_axes = seq_axes if isinstance(seq_axes, tuple) else (seq_axes,)
    part = _local_decode(q, k, v, pos, scale, axis_names=seq_axes)
    _record_merge(part, seq_axes, ns, nb)
    return _merge([part]).reshape(q.shape).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache, v_cache,
                     pos: int | torch.Tensor, *, scale: float) -> torch.Tensor:
    """q (B, H, Dh); caches (B, S, Hkv, Dh), tensors or
    :class:`ShardedTensor`s; ``pos`` the last valid index, an int or a
    0-dim tensor on q's device (a captured decode step's).  Returns
    (B, H, Dh) in q's dtype; softmax in float32.  Context-parallel over
    the active mesh (see the module docstring)."""
    if isinstance(k_cache, ShardedTensor):
        return _cp_decode(q, k_cache, v_cache, pos, scale)
    mesh = current_mesh()
    spec = cache_spec(mesh, k_cache.shape[0], k_cache.shape[1])
    if spec is None:
        return _local_decode(q, k_cache, v_cache, pos, scale)
    sh = NamedSharding(mesh, spec)
    if k_cache.device.type == "meta":
        return _meta_cp_decode(q, k_cache, v_cache, pos, scale, sh)
    return _cp_decode(q, shard_tensor(k_cache, sh), shard_tensor(v_cache, sh),
                      pos, scale)

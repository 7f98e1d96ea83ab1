"""Logical-axis sharding: path-convention parameter specs, activation
hooks and the placement of a tensor's pieces on a mesh.

The port's counterpart of ``repro/parallel/sharding.py``, with the same
names.  A mesh is :class:`repro_torch.launch.mesh.Mesh` (one process over
a grid of devices, a device may repeat), or any object with an
``axis_names`` tuple and a ``shape`` mapping: a ``Mesh`` of 256 repeated
``"cpu"`` devices stands in for the reference's ``abstract_mesh((16,
16))`` when only specs are resolved.

Parallelism dimensions (the reference's; the port runs the explicit
ones as one computation per shard):

  * DP   — batch over ('pod', 'data').
  * FSDP — parameters over 'data' (embed-dim for matrices).
  * TP   — heads / mlp / vocab over 'model'.
  * EP   — MoE experts over 'model' (``models/ffn.py``, ``impl="ep"``:
           per shard, its token slice through its own experts).
  * SP/CP— the decode KV cache's sequence over 'model', or over every
           axis for a batch the batch axes do not divide
           (``repro_torch.parallel.decode_attention``).

Every spec is validated against divisibility when it is applied: axes
that do not divide a dimension are dropped (replication), e.g. kv_heads
8 on model 16 replicates the KV projections.

Where the reference leaves the layout to GSPMD (``shard_activation``,
the parameter specs under ``jit``), a spec fixes a layout and not a
value.  The port computes those tensors whole on the mesh's first
device, so :func:`shard_activation` resolves the spec and returns its
input; the pieces of the explicit sites are placed with
:func:`shard_tensor`, whose pieces on a repeated device are views of one
tensor, and reassembled with :func:`unshard`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
import threading
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.device import canonical_device

__all__ = [
    "P",
    "PartitionSpec",
    "NamedSharding",
    "ShardedTensor",
    "mesh_context",
    "current_mesh",
    "shard_activation",
    "activation_spec",
    "logical",
    "param_specs",
    "apply_named_sharding",
    "validate_spec",
    "shard_tensor",
    "unshard",
    "manual_axes",
    "manual_axes_scope",
    "ShardingPolicy",
    "POLICIES",
    "policy_context",
    "current_policy",
]

_STATE = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of names (major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 \
            else f"P({self[0]!r})"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec over its axis names."""

    mesh: Any
    spec: PartitionSpec

    def __post_init__(self):
        for entry in self.spec:
            for a in _axes(entry):
                if a not in self.mesh.shape:
                    raise ValueError(
                        f"spec {self.spec} names axis {a!r}, not in the mesh "
                        f"{tuple(self.mesh.shape)}")


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def current_mesh():
    return getattr(_STATE, "mesh", None)


# ---------------------------------------------------------------------------
# Manual axes: the port's copy of the two parts of the reference's
# ``parallel/compat.py`` that mean something here.  The reference's
# ``shard_map`` shim marks every mesh axis manual while a shard's body is
# traced; the port's per-shard computations (the CP decode attention, EP)
# open the same scope around each shard's work.
# ---------------------------------------------------------------------------

_MANUAL = threading.local()


def manual_axes() -> frozenset:
    """Mesh axes manual in the innermost scope open on this thread (the
    union across nested scopes); empty outside."""
    stack = getattr(_MANUAL, "stack", None)
    if not stack:
        return frozenset()
    return frozenset().union(*stack)


@contextlib.contextmanager
def manual_axes_scope(names):
    """Declare ``names`` manual for the scope: activation specs resolved
    inside it leave those axes out."""
    stack = getattr(_MANUAL, "stack", None)
    if stack is None:
        stack = _MANUAL.stack = []
    stack.append(frozenset(names))
    try:
        yield
    finally:
        stack.pop()


# ---------------------------------------------------------------------------
# Sharding policies (the reference's; they change the specs, not values).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    name: str = "tp"
    batch_axes: tuple = ("pod", "data")
    tp_params: bool = True     # shard weights over 'model'
    fsdp_params: bool = True   # shard weights over 'data'
    shard_experts: bool = True  # EP expert sharding survives regardless


POLICIES = {
    "tp": ShardingPolicy("tp", ("pod", "data"), True, True),
    "zero3_dp": ShardingPolicy("zero3_dp", ("pod", "data", "model"), True, True),
    "ddp_zero1": ShardingPolicy(
        "ddp_zero1", ("pod", "data", "model"), False, False
    ),
}


def current_policy() -> ShardingPolicy:
    return getattr(_STATE, "policy", POLICIES["tp"])


@contextlib.contextmanager
def policy_context(policy: ShardingPolicy | str):
    if isinstance(policy, str):
        policy = POLICIES[policy]
    prev = current_policy()
    _STATE.policy = policy
    try:
        yield policy
    finally:
        _STATE.policy = prev


@contextlib.contextmanager
def mesh_context(mesh):
    """Activate ``mesh`` (or none) for this thread's model code."""
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


# Logical activation axes -> mesh axes (tried in order; missing mesh axes
# are skipped, non-dividing axes dropped).
ACT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "kv_seq": ("model",),     # decode cache CP
    "heads": ("model",),
    "kv_heads": ("model",),
    "embed": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "long_seq": ("data", "model"),  # single-sequence long-context decode
}


def _mesh_axes_for(logical_name: str | None, mesh) -> tuple[str, ...]:
    if logical_name is None:
        return ()
    if logical_name == "batch":
        axes = current_policy().batch_axes
    else:
        axes = ACT_RULES.get(logical_name, ())
    return tuple(a for a in axes if a in mesh.shape)


def validate_spec(spec, shape: tuple[int, ...], mesh) -> PartitionSpec:
    """Drop mesh axes that don't divide the corresponding dim size, and
    dedup axes across dims (first dim wins) — a policy may map batch over
    'model' while a TP rule also claims 'model'; the batch mapping takes
    precedence by position."""
    out = []
    used: set[str] = set()
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = [a for a in _axes(entry) if a in mesh.shape and a not in used]
        keep: list[str] = []
        denom = 1
        for a in axes:
            if shape[i] % (denom * mesh.shape[a]) == 0:
                keep.append(a)
                denom *= mesh.shape[a]
        used.update(keep)
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return P(*out)


def logical(*names: str | None) -> PartitionSpec:
    """A spec of logical activation-axis names (unresolved — resolved
    against the active mesh in :func:`shard_activation`)."""
    return P(*names)


def activation_spec(shape: tuple[int, ...], *names: str | None):
    """The spec the reference's ``shard_activation`` would constrain a
    tensor of ``shape`` to under the active mesh: each logical name's
    mesh axes, less the manual ones, validated against ``shape``.  None
    without a mesh, or when a manual scope leaves no axis (the reference
    then skips the constraint)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return _activation_spec(tuple(shape), names, mesh, current_policy(),
                            manual_axes())


@functools.lru_cache(maxsize=4096)
def _activation_spec(shape: tuple, names: tuple, mesh, policy, manual):
    """:func:`activation_spec`'s resolution, kept per (shape, names, mesh,
    policy, manual axes): a prefill resolves the same few specs in every
    layer."""
    entries = []
    for n in names:
        axes = tuple(a for a in _mesh_axes_for(n, mesh) if a not in manual)
        entries.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    spec = validate_spec(P(*entries), tuple(shape), mesh)
    if manual and not any(e is not None for e in spec):
        return None
    return spec


def shard_activation(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """The reference's activation hook: resolves the spec as the
    reference does (:func:`activation_spec`) and returns ``x`` itself.

    In the reference the hook is a ``with_sharding_constraint``: it tells
    GSPMD how to lay ``x`` out across the mesh and leaves every value as
    it is.  The port computes these activations whole on the mesh's
    first device (tensor parallelism over dense layers is not ported), so
    the layout has nothing to act on: no copy and no launch, and a
    captured program is the same with or without a mesh.  Without a mesh
    it returns at once."""
    if current_mesh() is not None:
        activation_spec(x.shape, *names)
    return x


# ---------------------------------------------------------------------------
# Parameter specs by path convention.
# ---------------------------------------------------------------------------

# (regex on the '/'-joined param path, spec for the *trailing* dims).
# Matrices are (in, out); FSDP shards the embed-side dim over 'data',
# TP shards heads/mlp/vocab over 'model'.  A leaf with more dims than its
# rule is padded with leading None.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embedding/table$", (("model",), ("data",))),         # (V, D)
    (r"lm_head/w$", (("data",), ("model",))),               # (D, V)
    (r"(wq|wqkv)/w$", (("data",), ("model",))),             # (D, H·dh)
    (r"(wk|wv)/w$", (("data",), ("model",))),               # (D, Hkv·dh)
    (r"wo/w$", (("model",), ("data",))),                    # (H·dh, D)
    (r"(wq|wk|wv|wqkv)/b$", (("model",),)),
    (r"wo/b$", (("data",),)),
    (r"(gate|up)/w$", (("data",), ("model",))),             # (D, F)
    (r"down/w$", (("model",), ("data",))),                  # (F, D)
    (r"router/w$", (("data",), None)),                      # (D, E)
    (r"experts/(w_gate|w_up)$", (("model",), ("data",), None)),  # (E, D, F)
    (r"experts/w_down$", (("model",), None, ("data",))),    # (E, F, D)
    (r"q_down/w$", (("data",), None)),                      # MLA
    (r"q_up/w$", (None, ("model",))),
    (r"kv_down/w$", (("data",), None)),
    (r"kv_up/w$", (None, ("model",))),
    (r"in_proj/w$", (("data",), ("model",))),               # mamba
    (r"out_proj/w$", (("model",), ("data",))),
    (r"conv/w$", (None, ("model",))),
    (r"conv/b$", (("model",),)),
    (r"(A_log|dt_bias|D)$", (("model",),)),
    (r"ssm_norm/scale$", (("model",),)),
    (r"(scale|b)$", (None,)),                               # norms / misc bias
    (r"patch_proj/w$", (None, ("data",))),
    (r"head\d*/w$", (("data",), ("model",))),               # audio codebook heads
]


def _spec_for_path(path: str, ndim: int) -> PartitionSpec:
    policy = current_policy()
    for pattern, trailing in _PARAM_RULES:
        if re.search(pattern, path):
            pad = ndim - len(trailing)
            if pad < 0:  # rule longer than leaf rank: trim leading rule dims
                trailing = trailing[-ndim:]
                pad = 0
            entries = list(trailing)
            is_expert = "experts/" in path
            if not (policy.tp_params or (is_expert and policy.shard_experts)):
                entries = [None if e and "model" in _axes(e) else e
                           for e in entries]
            if not policy.fsdp_params:
                entries = [None if e and "data" in _axes(e) else e
                           for e in entries]
            return P(*([None] * pad + entries))
    return P(*([None] * ndim))


def _path_str(name: str) -> str:
    """A ``named_parameters()`` name as the rules' '/'-joined path
    (``layers.0.mixer.wq.w`` -> ``layers/0/mixer/wq/w``)."""
    return name.replace(".", "/")


def param_specs(params: nn.Module) -> dict[str, PartitionSpec]:
    """The spec of every parameter by its ``named_parameters()`` name."""
    return {name: _spec_for_path(_path_str(name), t.dim())
            for name, t in params.named_parameters()}


def apply_named_sharding(params: nn.Module, mesh) -> dict[str, NamedSharding]:
    """A :class:`NamedSharding` per parameter name, its spec validated
    against the leaf's shape on ``mesh``."""
    specs = param_specs(params)
    return {name: NamedSharding(mesh, validate_spec(specs[name],
                                                    tuple(t.shape), mesh))
            for name, t in params.named_parameters()}


# ---------------------------------------------------------------------------
# Placement: a tensor's pieces on the mesh.
# ---------------------------------------------------------------------------


def _blocks_per_dim(sharding: NamedSharding, ndim: int) -> list[int]:
    shape = sharding.mesh.shape
    spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    return [int(np.prod([shape[a] for a in _axes(e)], dtype=np.int64))
            for e in spec]


def _block_index(sharding: NamedSharding, ndim: int, pos: tuple) -> tuple:
    """The block a mesh position holds along each tensor dim: the
    mixed-radix index of its coordinates on the dim's axes, the first
    axis major (0 along a replicated dim)."""
    mesh = sharding.mesh
    spec = tuple(sharding.spec) + (None,) * (ndim - len(sharding.spec))
    out = []
    for entry in spec:
        idx = 0
        for a in _axes(entry):
            idx = idx * mesh.shape[a] + pos[mesh.axis_names.index(a)]
        out.append(idx)
    return tuple(out)


class ShardedTensor:
    """A tensor laid out on a mesh: ``pieces`` is an object array shaped
    like ``sharding.mesh.devices``, each entry the block that mesh
    position holds, on that position's device.  Positions that hold the
    same block on the same device share one tensor; ``blocks`` maps each
    block index (one per dim) to its pieces, in block order."""

    __slots__ = ("pieces", "sharding", "shape", "dtype", "blocks",
                 "block_shape", "_offsets")

    def __init__(self, pieces: np.ndarray, sharding: NamedSharding,
                 shape: tuple, blocks: dict):
        self.pieces = pieces
        self.sharding = sharding
        self.shape = tuple(shape)
        self.blocks = blocks
        first = next(iter(blocks.values()))[0]
        self.dtype = first.dtype
        self.block_shape = tuple(first.shape)
        self._offsets = {b: tuple(i * n for i, n in zip(b, self.block_shape))
                         for b in blocks}

    def block(self, index: tuple) -> torch.Tensor:
        """The first piece of block ``index`` (the one on the lowest mesh
        position that holds it)."""
        return self.blocks[tuple(index)][0]

    def offsets(self, index: tuple) -> tuple:
        """Where block ``index`` starts along each dim."""
        return self._offsets[tuple(index)]

    def _region(self, b: tuple, skip: int | None = None) -> tuple:
        """Block ``b``'s slices of the whole tensor (all of dim ``skip``)."""
        return tuple(slice(None) if d == skip else slice(o, o + s)
                     for d, (o, s) in enumerate(zip(self.offsets(b),
                                                    self.block_shape)))

    def __setitem__(self, i: int, value: torch.Tensor) -> None:
        """``t[i] = value`` along dim 0 (``value`` whole, shaped like
        ``t[i]``): written into every piece that holds row ``i``."""
        for b, pieces in self.blocks.items():
            o = self.offsets(b)[0]
            if not o <= i < o + self.block_shape[0]:
                continue
            src = value[self._region(b)[1:]]
            for piece in pieces:
                piece[i - o].copy_(src)

    def index_copy_(self, dim: int, index: torch.Tensor,
                    source: torch.Tensor) -> "ShardedTensor":
        """``t.index_copy_(dim, index, source)`` for a one-element device
        ``index``, with nothing read on the host (a captured decode
        step's write at its device position): along a split ``dim`` the
        block that owns the row writes it and every other block rewrites
        its own (clamped) row unchanged."""
        split = self.shape[dim] != self.block_shape[dim]
        n = self.block_shape[dim]
        for b, pieces in self.blocks.items():
            off = self.offsets(b)[dim]
            src = source[self._region(b, skip=dim)]
            for piece in pieces:
                s = src.to(piece.device, piece.dtype)
                idx = index.to(piece.device)
                if split:
                    local = idx - off
                    inside = ((local >= 0) & (local < n)).reshape(())
                    idx = local.clamp(0, n - 1)
                    s = torch.where(inside, s, piece.index_select(dim, idx))
                piece.index_copy_(dim, idx, s)
        return self

    def clone(self) -> "ShardedTensor":
        """A copy with the same layout: the pieces of one new tensor (on
        the mesh's first device, copies on the others)."""
        return shard_tensor(unshard(self), self.sharding)

    def local_tensors(self) -> list[torch.Tensor]:
        """Every distinct piece (what a compiled program reads in place)."""
        seen, out = set(), []
        for ts in self.blocks.values():
            for t in ts:
                if id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, spec={self.sharding.spec}, "
                f"blocks={len(self.blocks)})")


def shard_tensor(t: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """``t``'s pieces laid out like ``sharding``: each mesh position gets
    its block, a view of ``t`` where the position's device is ``t``'s and
    one copy per (block, device) elsewhere.  Every sharded dim must be
    divisible by its axes (pass the spec through :func:`validate_spec`
    first)."""
    mesh = sharding.mesh
    counts = _blocks_per_dim(sharding, t.dim())
    for d, (n, c) in enumerate(zip(t.shape, counts)):
        if n % c:
            raise ValueError(f"dim {d} of size {n} does not split into "
                             f"{c} blocks ({sharding.spec})")
    size = [n // c for n, c in zip(t.shape, counts)]
    home = canonical_device(t.device)
    pieces = np.empty(mesh.devices.shape, dtype=object)
    made: dict = {}
    blocks: dict = {}
    for pos, dev in np.ndenumerate(mesh.devices):
        b = _block_index(sharding, t.dim(), pos)
        piece = made.get((b, dev))
        if piece is None:
            piece = t[tuple(slice(i * s, (i + 1) * s) for i, s in zip(b, size))]
            if canonical_device(dev) != home:
                piece = piece.to(dev)
            made[(b, dev)] = piece
            blocks.setdefault(b, []).append(piece)
        pieces[pos] = piece
    blocks = {b: blocks[b] for b in sorted(blocks)}
    return ShardedTensor(pieces, sharding, tuple(t.shape), blocks)


def unshard(pieces, sharding: NamedSharding | None = None,
            device=None) -> torch.Tensor:
    """The whole tensor from its pieces (a :class:`ShardedTensor`, or the
    pieces array with its ``sharding``), on ``device`` (the mesh's first
    device by default): each block copied once into place."""
    st = pieces if isinstance(pieces, ShardedTensor) else None
    if st is None:
        mesh = sharding.mesh
        blocks: dict = {}
        ndim = pieces.flat[0].dim()
        for pos in np.ndindex(*mesh.devices.shape):
            blocks.setdefault(_block_index(sharding, ndim, pos),
                              []).append(pieces[pos])
        counts = _blocks_per_dim(sharding, ndim)
        shape = tuple(n * c for n, c in zip(pieces.flat[0].shape, counts))
        st = ShardedTensor(pieces, sharding, shape, blocks)
    if device is None:
        device = st.sharding.mesh.devices.flat[0]
    out = torch.empty(st.shape, dtype=st.dtype, device=device)
    for b, ts in st.blocks.items():
        region = tuple(slice(o, o + s)
                       for o, s in zip(st.offsets(b), st.block_shape))
        out[region].copy_(ts[0])
    return out

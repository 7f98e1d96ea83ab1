"""FFN layers: dense SwiGLU and the dropless mixture of experts.

The port's counterpart of ``repro/models/ffn.py``.  MoE dispatch is the
reference's sort-based dropless formulation: the top_k·T token copies are
sorted by routed expert id and pushed through one grouped SwiGLU (the
reference's ``lax.ragged_dot``), so no capacity factor and no dropped
token.  The grouped SwiGLU (:func:`grouped_swiglu`) has two routes,
chosen by the tensors' device as the kernels' ``ops.py`` choose theirs:

* CPU: :func:`grouped_swiglu_loop`, a loop over the experts on slices of
  the sorted rows, with the group sizes read to the host.
* CUDA: :func:`grouped_swiglu_mm`, three ``torch._grouped_mm`` calls
  (the library's grouped GEMM) with device offsets, bfloat16 or float16
  only.  A CUDA tensor never takes the loop, and nothing falls back: a
  missing ``torch._grouped_mm`` or another dtype raises.  Its backward
  is the library's (two more grouped GEMMs per call).
* meta (the dry run: shapes only): the same three ``torch._grouped_mm``
  calls, which the loop cannot take (it reads the group sizes).

Everything around the GEMMs (the route, the sort, the inverse
permutation, the group sizes and offsets, the combine) is one code path
for both devices, and none of it reads a device value on the host, so a
decode step with MoE layers is captured as a CUDA graph
(``launch/serve.py``).  Ties in the router's probabilities are broken as
``jax.lax.top_k`` breaks them, lowest expert id first (a stable
descending sort; ``torch.topk`` orders ties otherwise).

``impl="ep"`` is the reference's expert parallelism: under a mesh
with a ``"model"`` axis that divides the expert count, every (data,
model) shard runs its slice of the tokens (split over ``("pod",
"data")``) through its own ``E / model`` experts (``_dropless`` with
``expert_offset`` / ``local_experts``), and the shards' outputs are
summed over ``"model"`` in shard order on the mesh's first device, where
the reference runs ``shard_map`` and one ``psum``.  The expert pieces
are placed once per weight version (:func:`_expert_pieces`), views of
the weight where a shard shares its device.  Otherwise ``"ep"`` computes
the plain path, as the reference does.  Under autograd (a train step on
the mesh) the pieces are differentiable slices of the expert weights, so
each expert's gradient arrives through its shard's piece.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import canonical_device
from repro_torch.models.common import (cast, dense_init, dtype_of, linear,
                                       normal, param, shard)
from repro_torch.parallel.sharding import (NamedSharding, P, current_mesh,
                                           manual_axes_scope,
                                           record_collective, shard_tensor)

__all__ = ["dense_ffn", "moe_ffn", "grouped_swiglu", "grouped_swiglu_loop",
           "grouped_swiglu_mm"]

# The dtypes the card's grouped GEMM takes.
GROUPED_MM_DTYPES = (torch.bfloat16, torch.float16)


class dense_ffn:
    @staticmethod
    def init(cfg: ModelConfig, gen: torch.Generator | None, device,
             d_ff: int | None = None) -> nn.ModuleDict:
        d_ff = d_ff or cfg.d_ff
        kw = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        return nn.ModuleDict({
            "gate": dense_init(gen, cfg.d_model, d_ff, **kw),
            "up": dense_init(gen, cfg.d_model, d_ff, **kw),
            "down": dense_init(gen, d_ff, cfg.d_model,
                               scale=0.02 / math.sqrt(2 * cfg.num_layers), **kw),
        })

    @staticmethod
    def apply(cfg: ModelConfig, p: nn.ModuleDict, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(linear(p["gate"], x)) * linear(p["up"], x)
        h = shard(h, "batch", "seq", "mlp")
        return linear(p["down"], h)


def grouped_swiglu_loop(x_sorted: torch.Tensor, group_sizes: torch.Tensor,
                        offs: torch.Tensor, w_gate: torch.Tensor,
                        w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The plain version: one SwiGLU per expert over its rows of
    ``x_sorted`` (T·k, D), the group sizes read to the host.  Weights
    (E, D, F) / (E, F, D) in x's dtype; returns (T·k, D)."""
    out = torch.zeros_like(x_sorted)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            rows = x_sorted[start:start + n]
            h = F.silu(rows @ w_gate[e]) * (rows @ w_up[e])
            out[start:start + n] = h @ w_down[e]
        start += n
    return out


def grouped_swiglu_mm(x_sorted: torch.Tensor, group_sizes: torch.Tensor,
                      offs: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The card's route: ``torch._grouped_mm`` with ``offs`` (E,) int32,
    the cumulative group ends on the device, so nothing is read to the
    host.  ``grouped_swiglu_mm.launches`` counts the calls (three grouped
    GEMMs each)."""
    if x_sorted.device.type != "cuda":
        raise ValueError(f"grouped_swiglu_mm needs CUDA tensors, got "
                         f"{x_sorted.device}")
    if x_sorted.dtype not in GROUPED_MM_DTYPES:
        raise TypeError(f"the card's grouped GEMM takes {GROUPED_MM_DTYPES}, "
                        f"got {x_sorted.dtype}")
    grouped_mm = getattr(torch, "_grouped_mm", None)
    if grouped_mm is None:
        raise RuntimeError(f"torch {torch.__version__} has no _grouped_mm: "
                           "the MoE layers need it on the card")
    h = (F.silu(grouped_mm(x_sorted, w_gate, offs=offs))
         * grouped_mm(x_sorted, w_up, offs=offs))
    out = grouped_mm(h, w_down, offs=offs)
    grouped_swiglu_mm.launches += 1
    return out


grouped_swiglu_mm.launches = 0


def grouped_swiglu(x_sorted: torch.Tensor, group_sizes: torch.Tensor,
                   offs: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU over expert-sorted rows (the reference's
    ``_expert_ffn_ragged``): the loop on a CPU tensor, the grouped GEMM on
    a CUDA tensor."""
    if x_sorted.device.type == "cpu":
        return grouped_swiglu_loop(x_sorted, group_sizes, offs, w_gate, w_up,
                                   w_down)
    if x_sorted.device.type == "cuda":
        return grouped_swiglu_mm(x_sorted, group_sizes, offs, w_gate, w_up,
                                 w_down)
    if x_sorted.device.type == "meta":
        mm = torch._grouped_mm
        h = (F.silu(mm(x_sorted, w_gate, offs=offs))
             * mm(x_sorted, w_up, offs=offs))
        return mm(h, w_down, offs=offs)
    raise ValueError(f"no grouped SwiGLU for {x_sorted.device}")


def _expert_pieces(w: torch.Tensor, mesh):
    """``w`` (E, ...) split over the mesh's ``"model"`` axis (spec
    ``("model", None, None)``), made once per version of ``w`` and mesh
    and kept on it, as :func:`~repro_torch.models.common.cast` keeps its
    copies (not cached for a leaf that autograd tracks)."""
    tracked = w.requires_grad and torch.is_grad_enabled()
    hit = None if tracked else getattr(w, "_ep_pieces", None)
    if hit is not None and hit[0] == w._version and hit[1] == mesh:
        return hit[2]
    pieces = shard_tensor(w, NamedSharding(mesh, P("model", None, None)))
    if not tracked:
        w._ep_pieces = (w._version, mesh, pieces)
    return pieces


class moe_ffn:
    @staticmethod
    def init(cfg: ModelConfig, gen: torch.Generator | None,
             device) -> nn.ModuleDict:
        E, D, Fd = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
        dt = dtype_of(cfg.param_dtype)
        down_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
        p = nn.ModuleDict({
            # The router stays float32 whatever param_dtype is, as in the
            # reference's init.
            "router": dense_init(gen, D, E, dtype=torch.float32, device=device),
            "experts": nn.ParameterDict({
                "w_gate": param(normal((E, D, Fd), gen, device, 0.02, dt)),
                "w_up": param(normal((E, D, Fd), gen, device, 0.02, dt)),
                "w_down": param(normal((E, Fd, D), gen, device, down_scale, dt)),
            }),
        })
        if cfg.num_shared_experts:
            p["shared"] = dense_ffn.init(
                cfg, gen, device, d_ff=cfg.moe_d_ff * cfg.num_shared_experts)
        return p

    @staticmethod
    def route(cfg: ModelConfig, p, x_flat: torch.Tensor):
        """Router: top-k probabilities and expert ids (T, k) and the Switch
        aux loss (before ``aux_loss_coef``).  x_flat (T, D).  The logits
        and softmax are float32; ties go to the lowest expert id."""
        logits = x_flat.float() @ cast(p["router"]["w"], torch.float32)
        probs = torch.softmax(logits, dim=-1)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_i = top_p[:, :cfg.top_k], top_i[:, :cfg.top_k]
        if cfg.norm_topk:
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        # Load-balancing aux loss (Switch-style): E * sum_e f_e * P_e, the
        # dispatch counts by scatter_add_ (no host read, unlike one_hot).
        E = cfg.num_experts
        counts = torch.zeros(E, dtype=torch.float32, device=x_flat.device)
        counts.scatter_add_(0, top_i[:, 0], torch.ones_like(top_p[:, 0]))
        f = counts / x_flat.shape[0]
        pbar = probs.mean(dim=0)
        aux = E * (f * pbar).sum()
        return top_p, top_i, aux

    @staticmethod
    def _dropless(cfg: ModelConfig, experts, x_flat: torch.Tensor,
                  top_p: torch.Tensor, top_i: torch.Tensor,
                  expert_offset: int = 0,
                  local_experts: int | None = None) -> torch.Tensor:
        """Sort-based dropless dispatch: the token copies sorted by expert
        id (stable, as ``jnp.argsort``), the grouped SwiGLU over them, the
        inverse gather, the combine weight multiplied in the activation
        dtype, and the sum over k.

        With ``local_experts`` set, ``experts`` holds experts
        ``expert_offset`` onwards; copies routed elsewhere are parked in a
        trailing null group, which no GEMM computes, and contribute
        zeros."""
        T, D = x_flat.shape
        k = cfg.top_k
        E = local_experts or cfg.num_experts
        flat_e = top_i.reshape(-1)  # (T·k,)
        flat_w = top_p.reshape(-1)
        local = None
        if local_experts is not None:
            flat_e = flat_e - expert_offset
            local = (flat_e >= 0) & (flat_e < E)
            flat_e = torch.where(local, flat_e, E)  # the null group's id
            flat_w = torch.where(local, flat_w, 0.0)
        order = torch.argsort(flat_e, stable=True)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(T * k, device=order.device)
        # Row j of the reference's repeat(x, k)[order] is x[order[j] // k].
        x_rep = x_flat[order // k]
        if local is not None:
            # The null group's rows lie past the last offset, where the
            # grouped GEMM leaves its outputs (and, in the backward, their
            # input gradients) undefined: zeroed here, nothing of them
            # reaches x's gradient.
            x_rep = torch.where(local[order][:, None], x_rep,
                                torch.zeros_like(x_rep))
        # E + 1 bins, as the reference's (its last is the mesh path's null
        # group, empty here).
        sizes = torch.zeros(E + 1, dtype=torch.int64, device=x_flat.device)
        sizes.scatter_add_(0, flat_e, torch.ones_like(flat_e))
        group_sizes = sizes[:E]
        offs = torch.cumsum(group_sizes, dim=0).to(torch.int32)
        y_sorted = grouped_swiglu(
            x_rep, group_sizes, offs,
            cast(experts["w_gate"], x_flat.dtype),
            cast(experts["w_up"], x_flat.dtype),
            cast(experts["w_down"], x_flat.dtype))
        y = y_sorted[inv] * flat_w[:, None].to(x_flat.dtype)
        if local is not None:
            # The null group's rows are past the last offset: the grouped
            # GEMM leaves them undefined (the loop and ragged_dot zero).
            y = torch.where(local[:, None], y, torch.zeros_like(y))
        return y.reshape(T, k, D).sum(dim=1)

    @staticmethod
    def _expert_parallel(cfg: ModelConfig, experts, x_flat: torch.Tensor,
                         top_p: torch.Tensor, top_i: torch.Tensor,
                         mesh) -> torch.Tensor:
        """The reference's EP ``shard_map`` body, one computation per
        (data, model) shard on the shard's device: the tokens split over
        ``("pod", "data")`` (pod major), experts over ``"model"``; each
        data block's outputs summed over the model shards in order on the
        mesh's first device, the blocks concatenated in order."""
        T = x_flat.shape[0]
        names = mesh.axis_names
        data_axes = [a for a in ("pod", "data") if a in mesh.shape]
        n_data = 1
        for a in data_axes:
            n_data *= mesh.shape[a]
        if T % n_data:
            raise ValueError(f"{T} tokens do not split over the mesh's "
                             f"{n_data} data shards")
        n_model = mesh.shape["model"]
        e_local = cfg.num_experts // n_model
        dt = x_flat.dtype
        pieces = [_expert_pieces(cast(experts[n], dt), mesh)
                  for n in ("w_gate", "w_up", "w_down")]
        first = canonical_device(mesh.devices.flat[0])
        Tl = T // n_data
        outs = []
        with manual_axes_scope(names):
            for d in range(n_data):
                coord = {"model": 0}
                rest = d
                for a in reversed(data_axes):
                    coord[a] = rest % mesh.shape[a]
                    rest //= mesh.shape[a]
                rows = slice(d * Tl, (d + 1) * Tl)
                acc = None
                for m in range(n_model):
                    coord["model"] = m
                    pos = tuple(coord.get(a, 0) for a in names)
                    dev = mesh.devices[pos]
                    w = dict(zip(("w_gate", "w_up", "w_down"),
                                 (st.pieces[pos] for st in pieces)))
                    out = moe_ffn._dropless(
                        cfg, w, x_flat[rows].to(dev), top_p[rows].to(dev),
                        top_i[rows].to(dev), expert_offset=m * e_local,
                        local_experts=e_local).to(first)
                    acc = out if acc is None else acc + out
                outs.append(acc)
        record_collective("all-reduce", "model", Tl * x_flat.shape[1]
                          * x_flat.element_size(), n_model)
        return outs[0] if n_data == 1 else torch.cat(outs)

    @staticmethod
    def apply(cfg: ModelConfig, p, x: torch.Tensor,
              impl: str = "gspmd") -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (out, aux_loss · aux_loss_coef).  x (B, S, D).  ``impl``
        is ``"gspmd"`` or ``"ep"``; ``"ep"`` runs expert parallelism under
        a mesh whose ``"model"`` axis divides the expert count, and the
        plain path otherwise, as ``"gspmd"`` always does."""
        if impl not in ("gspmd", "ep"):
            raise ValueError(f"unknown MoE impl {impl!r}")
        B, S, D = x.shape
        x_flat = x.reshape(B * S, D)
        top_p, top_i, aux = moe_ffn.route(cfg, p, x_flat)
        mesh = current_mesh()
        if (impl == "ep" and mesh is not None and "model" in mesh.shape
                and cfg.num_experts % mesh.shape["model"] == 0):
            out = moe_ffn._expert_parallel(cfg, p["experts"], x_flat, top_p,
                                           top_i, mesh)
        else:
            out = moe_ffn._dropless(cfg, p["experts"], x_flat, top_p, top_i)
        out = out.reshape(B, S, D)
        if "shared" in p:
            out = out + dense_ffn.apply(cfg, p["shared"], x)
        return out, aux * cfg.aux_loss_coef

"""Multi-pod dry run of the port: every (architecture x input-shape x
mesh) cell traced on the ``meta`` device, nothing allocated and no data.

The port's counterpart of ``repro/launch/dryrun.py``, with its CLI.  Per
cell, on the production mesh (``make_production_mesh`` over ``["meta"] *
256`` or ``* 512``) with the full-size configuration:

  * ``shape_applicable`` (a skipped cell gives the reference's reason);
  * every parameter, optimizer-state, batch and cache spec built as the
    reference's ``_batch_shardings`` / ``_cache_shardings`` /
    ``_opt_state_shardings`` build them, and validated on the mesh (each
    sharded dim divisible by its axes);
  * the train, prefill or decode step run once on ``meta`` inputs under
    ``torch.utils.flop_counter.FlopCounterMode``.

The report (``results/dryrun_torch/<arch>__<shape>__<mesh>.json``) keeps
the reference's keys.  Their contents here:

  * ``param_bytes_per_device``: the reference's formula (every
    parameter's bytes over the shards its spec splits it into).
  * ``memory_analysis``: ``argument_size_in_bytes``, the step's argument
    bytes per device by spec, and ``first_device_argument_bytes``, what
    the port's placement puts on the mesh's first device today (every
    argument whole).  No temp or peak figure: there is no compiler to ask.
  * ``cost_analysis.flops``: the FLOPs of the whole step as the port runs
    it (forward, backward with remat's second forward, for training), as
    ``FlopCounterMode`` counts them: every matmul-like call, the plain
    attention's chunks over all S^2 pairs (causal or not), the MoE's
    grouped GEMMs by :func:`_grouped_mm_flops`.
  * ``collectives`` / ``num_collectives``: the port's own cross-shard
    merges, counted where they happen (``sharding.record_collective``):
    EP's sum over ``"model"``, the CP decode merge, int8_ef's code and
    scale sums.  A dense cell has none: its layers compute whole on the
    first device (``shard_activation``).
  * ``trace_s`` takes the place of ``lower_s`` / ``compile_s``.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
from torch.utils import flop_counter

from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.parallel.sharding import (POLICIES, NamedSharding, P,
                                           apply_named_sharding,
                                           collective_census, current_policy,
                                           mesh_context, policy_context,
                                           validate_spec)
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from repro_torch.train.tree import by_dotted_name, map_leaves, named_leaves

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


# ---------------------------------------------------------------------------
# Sharding specs, built as the reference builds them
# ---------------------------------------------------------------------------


def _batch_axes(mesh, batch: int) -> tuple:
    """Policy batch axes, greedily trimmed to divisibility."""
    axes = tuple(a for a in current_policy().batch_axes if a in mesh.shape)
    while axes and batch % math.prod(mesh.shape[a] for a in axes):
        axes = axes[:-1]
    return axes if axes and math.prod(mesh.shape[a] for a in axes) > 1 else ()


def _entry(axes: tuple):
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _batch_shardings(mesh, tree, batch: int):
    """Dim 0 (the global batch) of every leaf over ('pod', 'data')."""
    entry = _entry(_batch_axes(mesh, batch))

    def spec(_path, leaf):
        s = P(*([entry] + [None] * (leaf.dim() - 1)))
        return NamedSharding(mesh, validate_spec(s, tuple(leaf.shape), mesh))

    return map_leaves(tree, spec)


def _cache_shardings(mesh, caches, batch: int):
    """KV caches: batch over ('pod', 'data') when divisible, sequence over
    'model' (or over every axis for the single-sequence long-context
    cell), as the CP decode attention lays them out; the SSM states'
    channels / heads over 'model'.  The port's caches are one dict per
    layer, with no stacked group dim."""
    baxes = _batch_axes(mesh, batch)
    seq_axes = ("model",) if baxes else tuple(
        a for a in ("pod", "data", "model") if a in mesh.shape)
    bentry, sentry = _entry(baxes), _entry(seq_axes)
    rules = {"k": [bentry, sentry, None, None], "v": [bentry, sentry, None, None],
             "c_kv": [bentry, sentry, None], "k_rope": [bentry, sentry, None],
             "conv": [bentry, None, "model"], "ssm": [bentry, "model", None, None]}

    def spec(path, leaf):
        ent = rules.get(path[-1], [])[:leaf.dim()]
        ent += [None] * (leaf.dim() - len(ent))
        return NamedSharding(mesh, validate_spec(P(*ent), tuple(leaf.shape),
                                                 mesh))

    return map_leaves(caches, spec)


def _check(sharding: NamedSharding, shape: tuple, name: str) -> None:
    """Every dim of ``shape`` divisible by the mesh axes its spec names."""
    for d, entry in enumerate(sharding.spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n = math.prod(sharding.mesh.shape[a] for a in axes)
        if shape[d] % n:
            raise ValueError(f"{name}: dim {d} of {shape} does not split over "
                             f"{axes} ({n} shards)")


def _shards(sharding: NamedSharding) -> int:
    return math.prod(sharding.mesh.shape[a] for e in sharding.spec
                     if e is not None
                     for a in (e if isinstance(e, tuple) else (e,)))


def _argument_bytes(pairs) -> tuple[float, float]:
    """(bytes per device by spec, bytes whole) over (tensor, sharding)
    pairs; each spec checked on the way."""
    per_device = whole = 0.0
    for name, t, sh in pairs:
        _check(sh, tuple(t.shape), name)
        n = t.numel() * t.element_size()
        per_device += n / _shards(sh)
        whole += n
    return per_device, whole


def _pairs(tree, shardings) -> list:
    """[(name, tensor, sharding)] of the tensor leaves of ``tree``, each
    with its sharding from the like-shaped ``shardings``."""
    where = by_dotted_name(shardings)
    out = []
    for path, t in named_leaves(tree):
        if isinstance(t, torch.Tensor):
            out.append((".".join(path), t, where[".".join(path)]))
    return out


def _analytic_param_bytes_per_device(params, shardings: dict) -> float:
    """The reference's formula: each parameter's bytes over its shards."""
    return sum(p.numel() * p.element_size() / _shards(shardings[name])
               for name, p in params.named_parameters())


# ---------------------------------------------------------------------------
# FLOPs of the MoE's grouped GEMM (FlopCounterMode has no formula for it)
# ---------------------------------------------------------------------------


def _grouped_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """2 M K N for ``torch._grouped_mm``'s forms: (M, K) x (G, K, N) (the
    forward and the input gradient), (K, M) x (M, N) grouped along M (the
    weight gradient), batched (G, M, K) x (G, K, N)."""
    if len(a_shape) == 2:
        return 2 * a_shape[0] * a_shape[1] * b_shape[-1]
    return 2 * math.prod(a_shape) * b_shape[-1]


def _register_grouped_mm_flops() -> None:
    op = torch.ops.aten._grouped_mm
    if op not in flop_counter.flop_registry:
        flop_counter.register_flop_formula(op)(_grouped_mm_flops)


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------


def _census(records: list) -> dict:
    summary: dict[str, dict] = {}
    for c in records:
        s = summary.setdefault(c["op"], {"count": 0, "bytes": 0.0,
                                         "traffic_per_device": 0.0})
        s["count"] += 1
        s["bytes"] += c["bytes"]
        s["traffic_per_device"] += c["traffic_per_device"]
    return summary


def lower_cell(arch: str, shape: str, *, multi_pod: bool = False,
               moe_impl: str = "gspmd", dtype: str = "bfloat16",
               param_dtype: str = "float32", remat: bool = True,
               policy: str = "tp", grad_accum: int = 1,
               extra_overrides: dict | None = None) -> dict:
    """Trace one cell on ``meta``; returns the report dict."""
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * (512 if multi_pod else 256))
    cfg = M.get_config(arch).with_overrides(
        dtype=dtype, param_dtype=param_dtype, remat=remat,
        **(extra_overrides or {}))
    ok, reason = M.shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": list(mesh.shape.values()),
                "status": "skipped", "reason": reason}
    _register_grouped_mm_flops()
    specs = M.input_specs(cfg, shape)
    kind = M.SHAPES[shape]["kind"]
    B = M.SHAPES[shape]["batch"]

    with policy_context(policy), mesh_context(mesh), \
            collective_census() as records:
        params = M.abstract_params(cfg)
        param_sh = apply_named_sharding(params, mesh)
        if kind == "train":
            opt = O.adamw(quantized=True)
            sched = O.warmup_cosine(3e-4, 2000, 100_000)
            state = TS.init_train_state(cfg, opt, None, params=params)
            batch = {k: specs[k] for k in ("batch", "labels", "loss_mask")}
            args = (_pairs(state, TS.state_shardings(state, mesh))
                    + _pairs(batch, _batch_shardings(mesh, batch, B)))
            step = TS.build_train_step(cfg, opt, sched, moe_impl=moe_impl,
                                       grad_accum=grad_accum)

            def run():
                step(state, batch)
        elif kind == "prefill":
            batch = specs["batch"]
            args = (_pairs(params, param_sh)
                    + _pairs(batch, _batch_shardings(mesh, batch, B)))

            def run():
                with torch.no_grad():
                    T.prefill(cfg, params, batch, max_len=specs["max_len"],
                              moe_impl=moe_impl)
        else:
            caches, tokens, pos = specs["caches"], specs["tokens"], specs["pos"]
            args = (_pairs(params, param_sh)
                    + _pairs(caches, _cache_shardings(mesh, caches, B))
                    + _pairs(tokens, _batch_shardings(mesh, tokens, B))
                    + [("pos", pos, NamedSharding(mesh, P()))])

            def run():
                with torch.no_grad():
                    T.decode_step(cfg, params, caches, tokens, pos,
                                  moe_impl=moe_impl)

        per_device, whole = _argument_bytes(args)
        with flop_counter.FlopCounterMode(display=False) as counter:
            run()
        t_trace = time.time() - t0

    return {
        "arch": arch, "shape": shape, "kind": kind, "mesh": dict(mesh.shape),
        "moe_impl": moe_impl, "policy": policy, "status": "ok",
        "trace_s": round(t_trace, 1),
        "params": M.count_params_analytic(cfg),
        "active_params": M.count_params_analytic(cfg, active_only=True),
        "param_bytes_per_device": _analytic_param_bytes_per_device(params,
                                                                   param_sh),
        "memory_analysis": {"argument_size_in_bytes": per_device,
                            "first_device_argument_bytes": whole},
        "cost_analysis": {"flops": float(counter.get_total_flops())},
        "collectives": _census(records),
        "num_collectives": len(records),
    }


def cell_path(arch: str, shape: str, multi_pod: bool, tag: str = "") -> str:
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    suffix = f"__{tag}" if tag else ""
    return os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh_tag}{suffix}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(M.SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--moe-impl", default="gspmd", choices=["gspmd", "ep"])
    ap.add_argument("--policy", default="tp", choices=sorted(POLICIES))
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = M.list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(M.SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(RESULTS_DIR, exist_ok=True)
    failures = []
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                out = cell_path(arch, shape, multi_pod, args.tag)
                if os.path.exists(out) and not args.force:
                    print(f"[skip] {out} exists")
                    continue
                label = f"{arch} × {shape} × {'2x16x16' if multi_pod else '16x16'}"
                print(f"[dryrun] {label} ...", flush=True)
                try:
                    rep = lower_cell(arch, shape, multi_pod=multi_pod,
                                     moe_impl=args.moe_impl,
                                     policy=args.policy,
                                     grad_accum=args.grad_accum)
                except Exception:
                    traceback.print_exc()
                    failures.append(label)
                    continue
                with open(out, "w") as f:
                    json.dump(rep, f, indent=1)
                status = rep["status"]
                extra = (f" trace={rep.get('trace_s')}s "
                         f"flops={rep['cost_analysis']['flops']:.3e} "
                         f"colls={rep.get('num_collectives')}"
                         if status == "ok" else f" ({rep.get('reason', '')})")
                print(f"[{status}] {label}{extra}", flush=True)
    if failures:
        print("FAILURES:", *failures, sep="\n  ")
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()

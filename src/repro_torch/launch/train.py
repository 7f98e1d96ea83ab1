"""Training launcher of the port: the end-to-end entry point.

Wires together: config registry -> data pipeline -> train step on the
mesh -> checkpoint manager (auto-resume, async saves) -> preemption guard
-> straggler monitor, as ``repro/launch/train.py`` does.  It runs on the
card by default (``--device cuda``; without one it raises) and on the CPU
when asked (``--device cpu``).

``--mesh``: ``host`` (the default, as in the reference) is
``make_host_mesh()``, every visible card (with ``--device cpu`` a (1, 1)
mesh over the CPU); ``production`` is ``make_production_mesh(multi_pod=)``
(256 / 512 cards; with ``--device cpu`` that many shards of the CPU);
``none`` trains without a mesh.  The state is placed by
``train_step.state_shardings`` (whole on the mesh's first device, each
int8_ef pod residual on its pod's), and a resume restores it there
(``try_resume(shardings=)``).  Deviation from the reference: a periodic
checkpoint is labelled by the number of steps done (the reference labels
it by the step just run, one less, so a resume from it would run one step
twice).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch olmo-1b --smoke --steps 20 --batch 4 --seq 32 --device cpu

Logs ``[train] step=N loss=... gnorm=... lr=...`` every ``--log-every``
steps; with ``--ckpt-dir`` it resumes from the latest checkpoint, saves
every ``--save-every`` steps and at the end; ``--simulate-preemption-at
N`` checkpoints before step N and exits ``PREEMPTED_EXIT_CODE`` (43).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.parallel.sharding import mesh_context
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from repro_torch.train.fault_tolerance import (PREEMPTED_EXIT_CODE,
                                               PreemptionGuard,
                                               StragglerMonitor,
                                               plan_batch_for_mesh)

# Configurations the launcher takes beside the registry's, as (registry
# base, overrides): the ~100M dense decoder of the 100M example
# (``examples/train_lm_100m_torch.py``; the reference's
# ``examples/train_lm_100m.py`` defines the same ``ModelConfig``):
# OLMo-style non-parametric LN and tied embeddings.
PRESETS = {
    "olmo-100m": ("olmo-1b", dict(
        name="olmo-100m", num_layers=8, d_model=768, vocab_size=32_000,
        num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072,
        max_seq_len=1024, dtype="float32", param_dtype="float32")),
}


def get_config(arch: str, smoke: bool = False):
    """A registry configuration, or a preset of :data:`PRESETS`."""
    if arch in PRESETS:
        base, overrides = PRESETS[arch]
        return M.get_config(base).with_overrides(**overrides)
    return M.get_config(arch, smoke=smoke)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="a registry configuration or one of PRESETS")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["host", "production", "none"],
                    default="host")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--moe-impl", default="gspmd", choices=["gspmd", "ep"])
    ap.add_argument("--quantized-opt", action="store_true")
    ap.add_argument("--compression", default=None, choices=[None, "int8_ef"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--simulate-preemption-at", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    on_card = dev.type == "cuda"
    if args.mesh == "production":
        need = 512 if args.multi_pod else 256
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    devices=None if on_card else [dev] * need)
    elif args.mesh == "host":
        mesh = make_host_mesh(devices=None if on_card else [dev])
    else:
        mesh = None
    plan = plan_batch_for_mesh(args.batch, dict(mesh.shape) if mesh else {})
    print(f"[train] {cfg.name} params={M.count_params_analytic(cfg):,} "
          f"mesh={dict(mesh.shape) if mesh else None} plan={plan} device={dev}")

    opt = O.adamw(weight_decay=0.01, quantized=args.quantized_opt)
    sched = O.warmup_cosine(args.lr, args.warmup, args.steps)
    step_fn = TS.build_train_step(cfg, opt, sched, moe_impl=args.moe_impl,
                                  compression=args.compression)
    pipe = TokenPipeline(cfg, batch=args.batch, seq=args.seq, seed=args.seed)
    guard = PreemptionGuard()
    monitor = StragglerMonitor()
    with mesh_context(mesh):
        return _loop(args, cfg, mesh, dev, opt, step_fn, pipe, guard, monitor)


def _loop(args, cfg, mesh, dev, opt, step_fn, pipe, guard, monitor) -> int:
    """The training loop of :func:`main`, under its mesh."""
    state = TS.init_train_state(
        cfg, opt, torch.Generator(device=dev).manual_seed(args.seed),
        compression=args.compression, device=dev)
    shardings = None
    if mesh is not None:
        shardings = TS.state_shardings(state, mesh)
        state = TS.place_state(state, shardings)
        dev = next(state.params.parameters()).device

    manager = None
    start_step = 0
    if args.ckpt_dir:
        manager = ckpt.CheckpointManager(args.ckpt_dir,
                                         save_every=args.save_every)
        resumed = manager.try_resume(state, shardings=shardings)
        if resumed is not None:
            state, extra, start_step = resumed
            pipe.load_state_dict(extra["pipeline"])
            print(f"[train] resumed from step {start_step} (pipeline step "
                  f"{pipe.step})")

    t_start = time.time()
    for step in range(start_step, args.steps):
        if args.simulate_preemption_at == step:
            guard.trigger()
        if guard.requested:
            if manager:
                manager.maybe_save(step, state, {"pipeline": pipe.state_dict()},
                                   blocking=True, force=True)
            print(f"[train] preempted at step {step}; checkpointed")
            return PREEMPTED_EXIT_CODE

        monitor.step_start()
        batch = TS.batch_to_device(pipe.next_batch(), dev)
        state, metrics = step_fn(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step={step} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e}", flush=True)
        if monitor.step_end(host_id=0):
            print(f"[train] WARNING straggler flagged host=0 "
                  f"(ewma={monitor.ewma:.3f}s)")
        if manager:
            # Labelled by the steps done, so that a resume from it runs the
            # next one (the reference labels it one step early).
            manager.maybe_save(step + 1, state, {"pipeline": pipe.state_dict()})

    if manager:
        manager.maybe_save(args.steps, state, {"pipeline": pipe.state_dict()},
                           blocking=True, force=True)
        manager.wait()
    dt = time.time() - t_start
    print(f"[train] done: {args.steps - start_step} steps in {dt:.1f}s "
          f"({(args.steps - start_step) / max(dt, 1e-9):.2f} steps/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

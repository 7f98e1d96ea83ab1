"""End-to-end training example (PyTorch port): train a ~100M-parameter LM
for a few hundred steps on the synthetic Markov stream, with
checkpointing, auto-resume and the int8-quantized AdamW: the code path
``python -m repro_torch.launch.train`` runs, at laptop scale.

    PYTHONPATH=src python examples/train_lm_100m_torch.py            # the card
    PYTHONPATH=src python examples/train_lm_100m_torch.py --device cpu --steps 20

The model is ``olmo-100m`` (``repro_torch.launch.train.PRESETS``: 8 layers,
d_model 768, 12 heads of 64, d_ff 3072, vocab 32,000, non-parametric LN,
tied embeddings; the reference example's configuration).  The data is
generated in process from a seed; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.train import get_config
from repro_torch.models.model import count_params_analytic
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS

CFG = get_config("olmo-100m")


def main(argv=None) -> dict:
    """Train; returns {"first_loss", "last_loss", "steps"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (auto-resume); none by default")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print(f"[example] {CFG.name}: {count_params_analytic(CFG) / 1e6:.1f}M "
          f"params, {args.steps} steps @ batch {args.batch} x seq {args.seq} "
          f"on {dev}")
    opt = O.adamw(weight_decay=0.01, quantized=True)
    step_fn = TS.build_train_step(CFG, opt, O.warmup_cosine(3e-3, 30, args.steps))
    pipe = TokenPipeline(CFG, batch=args.batch, seq=args.seq, seed=0)
    state = TS.init_train_state(CFG, opt, torch.Generator(device=dev).manual_seed(0),
                                device=dev)
    manager = None
    start = 0
    if args.ckpt_dir:
        manager = ckpt.CheckpointManager(args.ckpt_dir, save_every=100)
        resumed = manager.try_resume(state)
        if resumed is not None:
            state, extra, start = resumed
            pipe.load_state_dict(extra["pipeline"])
            print(f"[example] resumed from step {start}")

    t0 = time.time()
    first_loss = last_loss = None
    for step in range(start, args.steps):
        batch = TS.batch_to_device(pipe.next_batch(), dev)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        first_loss = first_loss if first_loss is not None else loss
        last_loss = loss
        if step % 25 == 0 or step == args.steps - 1:
            tok_s = (step - start + 1) * args.batch * args.seq \
                / max(time.time() - t0, 1e-9)
            print(f"[example] step {step:4d}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  {tok_s:,.0f} tok/s")
        if manager:
            manager.maybe_save(step + 1, state, {"pipeline": pipe.state_dict()})
    if manager:
        manager.wait()
    if first_loss is not None:
        print(f"[example] loss {first_loss:.3f} -> {last_loss:.3f} "
              f"in {time.time() - t0:.0f}s")
    return {"first_loss": first_loss, "last_loss": last_loss,
            "steps": args.steps - start}


if __name__ == "__main__":
    main()

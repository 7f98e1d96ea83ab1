"""Serving launcher (PyTorch port): continuous-batching decode loop.

Prefill each admitted prompt (causal attention through the flash
kernel on the card, Mamba2 layers through the chunked SSD), then run the
single-token decode step over a fixed set of slots; finished sequences
release their slot to queued requests.  A Mamba2 prompt's length must be
a multiple of ``min(ssm_chunk, length)`` (64 at the published configs),
as the reference's SSD asserts; another length raises ``ValueError``.
The decode step is a compiled program (:mod:`repro_torch.compile`, the
reference's ``jax.jit`` of it): on the card it is captured once as a
CUDA graph over the batched caches and the weights cast once to the
activation dtype, and replayed every step.  The prefill runs eager.

``--mesh host`` serves under ``mesh_context(make_host_mesh())``, a mesh
over every visible card (it raises without one): each GQA layer's KV
cache is laid out as pieces over the mesh (the sequence over ``"model"``,
the slots over ``"data"`` where they divide it;
:func:`repro_torch.parallel.decode_attention.cache_spec`) and the decode
attention is context-parallel.  Everything else computes whole on the
mesh's first card (``parallel/sharding.py``); a batcher made with
``moe_impl="ep"`` under a mesh runs its MoE layers expert-parallel.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --smoke \
      --requests 12 --slots 4 --prompt-len 32 --gen-len 16 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
      --smoke --mesh host

The default device is ``cuda``, which raises without a card.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.compile import program
from repro_torch.configs.base import layer_layout
from repro_torch.device import canonical_device, resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.common import cast_params, dtype_of
from repro_torch.parallel.decode_attention import cache_spec
from repro_torch.parallel.sharding import (NamedSharding, current_mesh,
                                           mesh_context, shard_tensor)


def _decode_step(tokens, pos, *, cfg, moe_impl, mesh, params, caches):
    """The batched decode step's body under ``mesh`` (or none): logits
    (B, 1, V); ``caches`` updated in place at the device position
    ``pos``."""
    with mesh_context(mesh):
        logits, _ = T.decode_step(cfg, params, caches, tokens, pos,
                                  moe_impl=moe_impl)
    return logits


_decode_program = program(_decode_step, static=("cfg", "moe_impl", "mesh"),
                          resident=("params", "caches"))


class ContinuousBatcher:
    """Slot-based scheduler: fixed decode batch, dynamic request swap-in.

    The counterpart of ``repro/launch/serve.py::ContinuousBatcher``.  Two
    differences of mechanism, none of result: a prompt's cache is spliced
    into the batched cache with an in-place ``copy_`` of that slot's entry
    of every cache tensor (an attention layer's (max_len, ...) rows, a
    Mamba2 layer's conv window and SSM state, which have no sequence
    axis; the reference rebuilds the whole cache tree), and the decode
    step updates the caches in place.  The reference's shared ``pos``
    frontier is kept exactly: every slot writes and attends at the
    largest position among the active slots, so a slot admitted with a
    shorter history attends over zero rows between its own end and the
    frontier; Mamba2 layers ignore the position.  Per-slot positions
    would be a feature the reference lacks.  A vision-stub model is served
    text prompts, as the reference serves it; the audio stub raises.
    The decode step reads the weights as :func:`cast_params` gives them
    (cast to the activation dtype once per parameter version), so a
    parameter updated in place is cast anew and the step is captured
    anew.

    The batcher serves under the mesh active when it is made
    (``mesh_context``), as the reference's does under its caller's: each
    GQA layer's KV cache becomes a
    :class:`~repro_torch.parallel.sharding.ShardedTensor` laid out by
    ``cache_spec`` (pieces on a repeated device are views of one cache
    tensor, which stays put, so the captured step replays), the splice
    and the decode step write into the pieces that own the rows, and
    prefill and decode run under the mesh.  MLA and Mamba2 caches stay
    whole, as the reference gives them no ``shard_map``.
    """

    def __init__(self, cfg, params, slots: int, max_len: int,
                 moe_impl: str = "gspmd"):
        if cfg.modality == "audio_stub":
            raise NotImplementedError(
                f"{cfg.name}: the batcher serves token prompts, and the audio "
                "stub reads frame embeddings (the reference's batcher fails "
                "on it too)")
        self.cfg, self.params = cfg, params
        self.moe_impl = moe_impl
        self.mesh = current_mesh()
        self.device = params["embedding"]["table"].device
        if self.mesh is not None and canonical_device(self.device) != \
                canonical_device(self.mesh.devices.flat[0]):
            raise ValueError(f"the parameters are on {self.device}, the "
                             f"mesh's first device is "
                             f"{self.mesh.devices.flat[0]}")
        self.slots = slots
        self.max_len = max_len
        self.caches = T.init_decode_caches(cfg, slots, max_len, self.device)
        spec = cache_spec(self.mesh, slots, max_len)
        if spec is not None:
            sharding = NamedSharding(self.mesh, spec)
            for layer, cache in zip(layer_layout(cfg), self.caches):
                if layer.mixer == "attn":
                    for name in ("k", "v"):
                        cache[name] = shard_tensor(cache[name], sharding)
        self.pos = np.zeros(slots, np.int32)
        self.active = np.zeros(slots, bool)
        self.outputs: dict[int, list[int]] = {}
        self.slot_req = [-1] * slots

    def _decode(self, toks: torch.Tensor, pos: int):
        """One compiled decode step at the shared frontier ``pos``;
        returns (logits, caches)."""
        weights = cast_params(self.params, dtype_of(self.cfg.dtype))
        pos_t = torch.full((), pos, dtype=torch.int32, device=self.device)
        logits = _decode_program(toks, pos_t, cfg=self.cfg,
                                 moe_impl=self.moe_impl, mesh=self.mesh,
                                 params=weights, caches=self.caches)
        return logits, self.caches

    def admit(self, req_id: int, prompt: np.ndarray) -> bool:
        free = np.flatnonzero(~self.active)
        if len(free) == 0:
            return False
        slot = int(free[0])
        tokens = torch.as_tensor(np.asarray(prompt)[None, :], device=self.device)
        with mesh_context(self.mesh):
            logits, cache1 = T.prefill(self.cfg, self.params,
                                       {"tokens": tokens},
                                       max_len=self.max_len,
                                       moe_impl=self.moe_impl)
        for batched, one in zip(self.caches, cache1):
            for name, buf in batched.items():
                buf[slot] = one[name][0]
        tok = int(torch.argmax(logits[0, -1]))
        self.pos[slot] = len(prompt)
        self.active[slot] = True
        self.slot_req[slot] = req_id
        self.outputs[req_id] = [tok]
        return True

    def step(self) -> None:
        """One decode step for every active slot."""
        toks = np.zeros((self.slots, 1), np.int32)
        for s in range(self.slots):
            if self.active[s]:
                toks[s, 0] = self.outputs[self.slot_req[s]][-1]
        # Slots share a common `pos` frontier, as in the reference.
        pos = int(self.pos[self.active].max()) if self.active.any() else 0
        if pos >= self.max_len:
            raise ValueError(f"decode position {pos} is past max_len={self.max_len}")
        logits, self.caches = self._decode(
            torch.as_tensor(toks, device=self.device), pos)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for s in range(self.slots):
            if self.active[s]:
                self.outputs[self.slot_req[s]].append(int(nxt[s]))
                self.pos[s] += 1

    def retire(self, gen_len: int) -> list[int]:
        done = []
        for s in range(self.slots):
            rid = self.slot_req[s]
            if self.active[s] and len(self.outputs[rid]) >= gen_len:
                self.active[s] = False
                done.append(rid)
        return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["host", "none"], default="none")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    mesh = make_host_mesh() if args.mesh == "host" else None
    dev = (canonical_device(mesh.devices.flat[0]) if mesh is not None
           else resolve_device(args.device))
    cfg = M.get_config(args.arch, smoke=args.smoke)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=dev)

    with mesh_context(mesh):
        batcher = ContinuousBatcher(cfg, params, args.slots, args.max_len)
    queue = list(range(args.requests))
    prompts = {
        r: rng.integers(0, cfg.vocab_size, size=args.prompt_len).astype(np.int32)
        for r in queue
    }
    finished = []
    t0 = time.time()
    steps = 0
    while len(finished) < args.requests:
        while queue and batcher.admit(queue[0], prompts[queue[0]]):
            print(f"[serve] admitted request {queue.pop(0)}")
        batcher.step()
        steps += 1
        for rid in batcher.retire(args.gen_len):
            finished.append(rid)
            print(f"[serve] finished request {rid}: "
                  f"{batcher.outputs[rid][:8]}...")
    dt = time.time() - t0
    print(f"[serve] {args.requests} requests, {steps} decode steps, "
          f"{steps * args.slots / dt:.1f} tok/s aggregate (device={dev}, "
          f"mesh={mesh})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

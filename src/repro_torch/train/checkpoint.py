"""Checkpointing: atomic, async-capable, in the reference's layout.

The port's counterpart of ``repro/train/checkpoint.py``.  Layout (one
directory per step), as the reference writes it:

    ckpt_dir/
      step_00000123/
        MANIFEST.json        # step, extra metadata, each leaf's name,
                             # file, shape and dtype
        leaf_00000.npy ...   # one file per leaf (the full array)
      LATEST                 # atomic pointer file

A tree is a :mod:`repro_torch.train.tree` tree: the model's
``nn.ModuleDict``, the optimizer's state, nested dicts, lists and named
tuples of tensors, numpy arrays and Python scalars; a leaf's name is its
path joined by ``/``.  Leaves are matched by name on restore, so a
checkpoint the reference wrote of a plain dict tree restores here.  A
bfloat16 leaf (numpy has no such dtype) is stored as its uint16 bits with
``"bfloat16"`` in the manifest.

  * atomicity — writes go to ``step_X.tmp-<pid>`` and are renamed into
    place; ``LATEST`` is updated only after the rename, so a preemption
    mid-save never corrupts the restore path.
  * async — ``save(..., blocking=False)`` copies every leaf to host memory
    before it returns and writes the files on a daemon thread.
  * placement — restore puts each leaf in the dtype of the leaf it
    replaces in ``like``, on that leaf's device or, with ``shardings=``
    (a tree of ``NamedSharding``s shaped like ``like``, or any part of
    it: ``train_step.state_shardings``), where the port keeps a leaf of
    that sharding: whole on the first device of the sharding's mesh
    (``sharding.home_device``).  For a state on the model mesh that is
    where ``train --mesh`` puts a fresh one: parameters and moments on
    the mesh's first device, each pod's int8_ef residual on its pod's.
    Leaves are stored whole, so a checkpoint restores onto another mesh
    (the reference's elastic resharding).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.parallel.sharding import home_device
from repro_torch.train.tree import by_dotted_name, map_leaves, named_leaves

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(numpy array, manifest dtype) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().copy(), "bfloat16"
        return t.numpy().copy(), str(t.numpy().dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None,
         *, blocking: bool = True) -> threading.Thread | None:
    """Write one checkpoint.  ``extra`` holds JSON-able metadata (the data
    iterator's state, seeds, ...)."""
    # Snapshot to host memory now (device tensors change next step).
    host = [("/".join(path), *_to_host(leaf))
            for path, leaf in named_leaves(tree)]

    def _write():
        os.makedirs(ckpt_dir, exist_ok=True)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = f"{final}.tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for i, (name, arr, dtype) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({"name": name, "file": fname,
                                       "shape": list(arr.shape),
                                       "dtype": dtype})
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        ptr_tmp = os.path.join(ckpt_dir, f".LATEST.tmp-{os.getpid()}")
        with open(ptr_tmp, "w") as f:
            f.write(str(step))
        os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        return int(f.read().strip())


def _load(final: str, entry: dict) -> np.ndarray:
    arr = np.load(os.path.join(final, entry["file"]))
    return arr.view(np.uint16) if entry["dtype"] == "bfloat16" else arr


def _placed(arr: np.ndarray, entry: dict, like, device=None):
    """``arr`` in the type and dtype of the ``like`` leaf, on ``device``
    (a tensor), else on ``like``'s device."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(arr, order="C"))
        if entry["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        if device is None:
            device = like.device if like.device.type != "meta" else "cpu"
        return t.to(device=device, dtype=like.dtype)
    if isinstance(like, np.ndarray) or hasattr(like, "dtype"):
        return arr.astype(like.dtype)
    return type(like)(arr.item())


def restore(ckpt_dir: str, step: int, like: Any, *,
            shardings: Any | None = None) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (a tree of tensors, numpy
    arrays, scalars; a tensor on the ``meta`` device stands for shape and
    dtype only and comes back on the CPU).  Each leaf is checked against
    ``like``'s shape and put in its dtype on its device, or on its
    sharding's home device where ``shardings`` names it (see the module
    docstring); an ``nn.Module`` in ``like`` gets its parameters written
    in place.  Returns (tree, extra)."""
    where = {} if shardings is None else {
        n: sh for n, sh in by_dotted_name(shardings).items() if sh is not None}
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "MANIFEST.json")) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest["leaves"]}
    values = {}
    leaves = named_leaves(like)
    unknown = set(where) - {".".join(path) for path, _ in leaves}
    if unknown:
        raise KeyError(f"shardings for leaves not in like: {sorted(unknown)[:5]}")
    for path, ref in leaves:
        name = "/".join(path)
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        entry = by_name[name]
        arr = _load(final, entry)
        shape = tuple(ref.shape) if hasattr(ref, "shape") else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                             f"expected {shape}")
        sh = where.get(".".join(path))
        values[path] = _placed(arr, entry, ref,
                               None if sh is None else home_device(sh))
    return map_leaves(like, lambda path, _: values[path]), manifest["extra"]


class CheckpointManager:
    """Rolling checkpoints + auto-resume: the restart path of the
    fault-tolerance story."""

    def __init__(self, ckpt_dir: str, keep: int = 3, save_every: int = 100):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.save_every = save_every
        self._pending: threading.Thread | None = None

    def maybe_save(self, step: int, tree: Any, extra: dict | None = None,
                   *, blocking: bool = False, force: bool = False) -> bool:
        if not force and (step == 0 or step % self.save_every):
            return False
        self.wait()
        self._pending = save(self.ckpt_dir, step, tree, extra,
                             blocking=blocking)
        self._gc()
        return True

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        if not os.path.isdir(self.ckpt_dir):
            return
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_") and "tmp" not in d)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def try_resume(self, like: Any, shardings: Any | None = None):
        """(tree, extra, step) from the latest checkpoint, or None."""
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None
        tree, extra = restore(self.ckpt_dir, step, like, shardings=shardings)
        return tree, extra, step

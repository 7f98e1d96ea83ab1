"""Device meshes of the port: the counterpart of ``repro.launch.mesh``.

The reference's ``jax.sharding.Mesh`` is single-controller: one process
drives every device and ``shard_map`` runs a shard's program on each.
:class:`Mesh` keeps that control model in one PyTorch process: a
``numpy`` object array of ``torch.device`` shaped like the axes, plus the
axis names.  The discovery mesh (:class:`~repro_torch.core.discovery
.executors.GroupMajorDistributedExecutor`) puts shard ``s`` of the
``"data"`` axis on ``mesh.devices`` along that axis; launches on
different devices overlap because CUDA launches are asynchronous.

A device may repeat: four shards on ``cuda:0`` are the card's
counterpart of the reference tests' four forced host devices, and
``["cpu"] * 4`` the CPU tests'.  One process cannot span hosts, so a
multi-host mesh is out of scope.

:func:`make_production_mesh` builds the reference's (16, 16) / (2, 16,
16) meshes: over 256 / 512 visible cards, or over the devices given (the
dry run passes ``["meta"] * n``: shapes only, nothing allocated).  The
model mesh serves (``serve --mesh host``), trains (``train --mesh``) and
dry-runs (``launch/dryrun.py``) on the same :class:`Mesh`
(``repro_torch.parallel.sharding``).

    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh()                          # every visible card
    mesh = make_host_mesh(devices=["cuda:0"] * 4)    # 4 shards, one card
    mesh = make_host_mesh(devices=["cpu"] * 4)       # 4 shards on the CPU
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import canonical_device

__all__ = ["Mesh", "make_host_mesh", "make_production_mesh"]


class Mesh:
    """Devices laid out along named axes.

    ``devices`` is an object array of ``torch.device`` with one dimension
    per name in ``axis_names``; ``shape`` maps each axis to its size, as
    the reference's ``mesh.shape["data"]`` does.  Equal meshes hash
    equal, so executors and programs can be cached per mesh.
    """

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(
                f"{arr.ndim}-D device array for axes {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(arr.shape, dtype=object)
        for pos, d in np.ndenumerate(arr):
            self.devices[pos] = canonical_device(d)
        self.axis_names = names
        self.shape = dict(zip(names, arr.shape))
        # A mesh is not changed after it is made: its key and hash are
        # kept (model code looks specs up per mesh on every call).
        self._k = (names, self.devices.shape,
                   tuple(str(d) for d in self.devices.flat))
        self._h = hash(self._k)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The device of each index along ``axis``, the other axes at 0:
        where shard ``s`` of a computation sharded over ``axis`` and
        replicated over the rest runs."""
        a = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for s in range(self.devices.shape[a]):
            index[a] = s
            out.append(self.devices[tuple(index)])
        return out

    def take(self, axis: str, index: int) -> "Mesh":
        """The sub-mesh at ``index`` along ``axis`` (that axis dropped):
        one pod of a multi-pod mesh."""
        a = self.axis_names.index(axis)
        names = self.axis_names[:a] + self.axis_names[a + 1:]
        return Mesh(np.take(self.devices, index, axis=a), names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and (
            self is other or (self._h == other._h and self._k == other._k))

    def __hash__(self) -> int:
        return self._h

    def __repr__(self) -> str:
        axes = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        return f"Mesh({axes}; {[str(d) for d in self.devices.flat]})"


def make_host_mesh(data: int | None = None, model: int = 1,
                   devices=None) -> Mesh:
    """A ``(data, model)`` mesh over local devices.

    ``devices`` defaults to every visible CUDA device and raises without
    one (a mesh is never built on the CPU unless asked for); a device
    may repeat.  ``data`` defaults to ``len(devices) // model``; the
    first ``data * model`` devices are used, row-major.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_host_mesh: torch.cuda.is_available() is False; pass "
                "devices=[...] (e.g. ['cpu'] * 4) to build a CPU mesh "
                "explicitly")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if data is None:
        data = len(devices) // model
    if data < 1 or model < 1 or data * model > len(devices):
        raise ValueError(
            f"a ({data}, {model}) mesh needs {data * model} devices; "
            f"got {len(devices)}")
    grid = np.empty((data, model), dtype=object)
    for i in range(data * model):
        grid[i // model, i % model] = devices[i]
    return Mesh(grid, ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The reference's production mesh: ``(data=16, model=16)``, or
    ``(pod=2, data=16, model=16)`` with ``multi_pod``, row-major over
    ``devices``.  ``devices`` defaults to the visible cards, and like
    ``jax.make_mesh`` it raises when there are fewer than the mesh needs
    (more are left unused); a device may repeat."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < need:
            raise RuntimeError(
                f"make_production_mesh(multi_pod={multi_pod}) needs {need} "
                f"CUDA devices; {n} are visible (pass devices=[...], e.g. "
                f"['meta'] * {need} for the dry run)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) < need:
        raise ValueError(f"a {shape} mesh needs {need} devices; got "
                         f"{len(devices)}")
    return Mesh(np.array(devices[:need], dtype=object).reshape(shape), axes)

"""PyTorch/CUDA port of the MI-sketch discovery engine.

A second package beside ``repro`` (the JAX reference).  It imports
``torch`` and numpy only — never ``jax`` and nothing of ``repro`` — and
keeps its own copies of the reference's numpy modules.  Every entry
point takes an explicit ``device`` that defaults to ``"cuda"``; asking
for the card on a machine without one raises (see :mod:`.device`), it
never drops to the CPU.  Tests pass ``device="cpu"``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

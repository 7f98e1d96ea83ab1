"""Device resolution for every entry point of the port.

The default is the card.  ``"cuda"`` (or ``None``) on a machine where
``torch.cuda.is_available()`` is false raises: a discovery query that
silently ran on the CPU would report CPU numbers under the card's name.
Callers that want the CPU ask for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "canonical_device", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The ``torch.device`` to run on; raises if a CUDA device is asked
    for and none is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU explicitly"
        )
    return dev


def canonical_device(device: str | torch.device) -> torch.device:
    """``device`` with a CUDA index resolved (``"cuda"`` is the current
    card), so that ``"cuda"`` and ``"cuda:0"`` compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

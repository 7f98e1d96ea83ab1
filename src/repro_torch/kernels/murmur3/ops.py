"""Public murmur3 API of the port: :func:`hash_keys`.

It dispatches by the keys' device: a CPU tensor takes the plain PyTorch
version (``ref.py``); a CUDA tensor launches the hand-written kernel
(``kernel.py``) or raises.  A CUDA tensor never takes the plain path.
The reference pads the keys to (rows, 128) tiles for its VMEM blocks;
the kernel takes any n, so nothing is padded.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.murmur3 import kernel, ref

__all__ = ["hash_keys"]

_MASK = 0xFFFFFFFF


def hash_keys(keys: torch.Tensor, seeds: torch.Tensor | int = 0, *,
              fibonacci: bool = True) -> torch.Tensor:
    """Fused murmur3(+Fibonacci) over integer key words of any shape.

    ``keys`` is taken as uint32 words (the low 32 bits).  ``seeds`` is a
    Python int or a tensor broadcastable to ``keys`` on the same device
    (per-element seeds are the TUPSK <k, j> tuple-key hash in one call:
    ``hash_keys(j, seeds=key_hashes, fibonacci=False)``).  Returns int64
    words in [0, 2^32) of ``keys``'s shape.
    """
    # Both paths take the low 32 bits of each word themselves.
    k = keys.to(torch.int64)
    if isinstance(seeds, torch.Tensor) and seeds.dim() > 0:
        if seeds.device != keys.device:
            raise ValueError(f"seeds lie on {seeds.device}, keys on {keys.device}")
        s, scalar = torch.broadcast_to(seeds.to(torch.int64), k.shape), 0
    else:
        s, scalar = None, int(seeds) & _MASK
    if k.device.type == "cpu":
        return ref.murmur3_fib_ref(k, scalar if s is None else s,
                                   fibonacci=fibonacci)
    if k.device.type != "cuda":
        raise ValueError(f"no hash_keys implementation for {k.device}")
    flat = k.reshape(-1).contiguous()
    sf = None if s is None else s.reshape(-1).contiguous()
    return kernel.murmur3_fib(flat, sf, scalar,
                              fibonacci=fibonacci).reshape(k.shape)

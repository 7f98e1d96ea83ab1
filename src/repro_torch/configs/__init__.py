"""Assigned-architecture registry: ``REGISTRY[arch_id] = (full, smoke)``.

The port keeps its own copy of the reference's ten config modules, as
data; the model stack of the port runs all ten.

Full configs carry the exact published numbers (see each module's
docstring for the source); smoke variants shrink every dimension for
CPU tests while preserving the *structure* (layer pattern, GQA grouping,
MoE routing, MLA ranks, SSD heads).
"""

from repro_torch.configs import (
    deepseek_v2_lite_16b,
    internlm2_1_8b,
    internvl2_26b,
    jamba_1_5_large_398b,
    mamba2_370m,
    mistral_nemo_12b,
    musicgen_large,
    olmo_1b,
    qwen1_5_110b,
    qwen3_moe_30b_a3b,
)

_MODULES = [
    mistral_nemo_12b,
    qwen1_5_110b,
    internlm2_1_8b,
    olmo_1b,
    jamba_1_5_large_398b,
    qwen3_moe_30b_a3b,
    deepseek_v2_lite_16b,
    internvl2_26b,
    mamba2_370m,
    musicgen_large,
]

REGISTRY = {m.CONFIG.name: (m.CONFIG, m.SMOKE) for m in _MODULES}

__all__ = ["REGISTRY"]

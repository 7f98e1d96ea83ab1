"""InternVL2-26B [arXiv:2404.16821] — InternViT-6B + InternLM2-20B.

Assigned as the transformer BACKBONE (InternLM2-20B: 48L, d_model 6144,
48 heads GQA kv=8, d_ff 16384, vocab 92553) with the vision frontend as
a STUB: ``input_specs`` provides 256 precomputed patch embeddings
(InternViT + pixel-shuffle output) that a trainable projector prepends
to the text sequence."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    vocab_size=92_553,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    modality="vision_stub",
    num_patches=256,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
    dtype="bfloat16",
)

SMOKE = CONFIG.with_overrides(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, num_patches=8,
    dtype="float32", param_dtype="float32", max_seq_len=256,
)

"""Mistral-NeMo-12B [hf:mistralai/Mistral-Nemo-Base-2407].

Dense decoder: 40L, d_model 5120, 32 heads (GQA kv=8, head_dim 128 —
explicit, not d_model/heads), d_ff 14336, vocab 131072, 128k context
(rope theta 1e6)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    vocab_size=131_072,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    rope_theta=1_000_000.0,
    max_seq_len=131_072,
    dtype="bfloat16",
)

SMOKE = CONFIG.with_overrides(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, dtype="float32", param_dtype="float32",
    max_seq_len=256,
)

"""InternLM2-1.8B [arXiv:2403.17297].

Dense decoder: 24L, d_model 2048, 16 heads (GQA kv=8), d_ff 8192,
vocab 92544."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    vocab_size=92_544,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
    dtype="bfloat16",
)

SMOKE = CONFIG.with_overrides(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, dtype="float32", param_dtype="float32",
    max_seq_len=256,
)

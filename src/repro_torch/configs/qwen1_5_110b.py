"""Qwen1.5-110B [hf:Qwen/Qwen1.5-110B family].

Dense decoder: 80L, d_model 8192, 64 heads (GQA kv=8), d_ff 49152,
vocab 152064, QKV bias (the Qwen1.5 signature)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    vocab_size=152_064,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=49_152,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
    dtype="bfloat16",
)

SMOKE = CONFIG.with_overrides(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=512, dtype="float32", param_dtype="float32",
    max_seq_len=256,
)

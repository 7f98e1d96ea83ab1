"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B].

MoE decoder: 48L, d_model 2048, 32 heads (GQA kv=4), 128 experts top-8
(norm_topk_prob), expert d_ff 768, vocab 151936; every layer MoE."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    vocab_size=151_936,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    num_experts=128,
    top_k=8,
    moe_d_ff=768,
    moe_layer_period=1,
    norm_topk=True,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
    dtype="bfloat16",
)

SMOKE = CONFIG.with_overrides(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=64, num_experts=8, top_k=2, moe_d_ff=64, vocab_size=512,
    dtype="float32", param_dtype="float32", max_seq_len=256,
)

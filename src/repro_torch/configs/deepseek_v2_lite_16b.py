"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434].

MLA + MoE decoder: 27L, d_model 2048, 16 heads of multi-head latent
attention (kv_lora_rank 512, qk_nope 128 + qk_rope 64, v_head 128),
layer 0 dense (d_ff 10944), layers 1–26 MoE with 64 routed experts
(top-6) + 2 shared experts, expert d_ff 1408, vocab 102400.

Note: the assignment line reads "MoE 64e top-6 — 2 shared+160 routed";
160 routed is the full V2 — V2-*Lite* has 64 routed (paper §B), which
matches the assignment's own "64e".  We implement 64."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    vocab_size=102_400,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,  # qk_nope + qk_rope (bookkeeping; MLA uses the split dims)
    d_ff=10_944,   # the single dense layer
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    moe_layer_period=1,
    first_dense_layers=1,
    max_seq_len=32_768,
    dtype="bfloat16",
)

SMOKE = CONFIG.with_overrides(
    num_layers=3, d_model=64, num_heads=4, head_dim=24,
    d_ff=160, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, num_experts=8, num_shared_experts=2, top_k=2,
    moe_d_ff=64, vocab_size=512,
    dtype="float32", param_dtype="float32", max_seq_len=256,
)

"""Jamba-1.5-Large (398B total / 94B active) [arXiv:2403.19887].

Hybrid Mamba+attention decoder: 72L with a 1:7 attn:mamba interleave
(one attention layer per period-8 group, offset 4), MoE (16 experts,
top-2) every other layer, d_model 8192, 64 heads (GQA kv=8), expert
d_ff 24576, vocab 65536.  Mamba layers: d_state 16, conv 4, expand 2 —
realized through the SSD (matmul) formulation, see DESIGN.md
§Hardware-adaptation."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    vocab_size=65_536,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    num_experts=16,
    top_k=2,
    moe_d_ff=24_576,
    moe_layer_period=2,
    attn_layer_period=8,
    attn_layer_offset=4,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=128,
    ssm_groups=1,
    ssm_chunk=64,
    max_seq_len=262_144,
    dtype="bfloat16",
)

SMOKE = CONFIG.with_overrides(
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, num_experts=4, top_k=2, moe_d_ff=64,
    ssm_state=16, ssm_head_dim=16, vocab_size=512,
    dtype="float32", param_dtype="float32", max_seq_len=256,
)

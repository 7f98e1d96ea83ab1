"""Mamba2-370M [arXiv:2405.21060].

Attention-free SSM decoder: 48L, d_model 1024, SSD with state 128,
head_dim 64 (32 SSD heads at expand=2), conv width 4, vocab 50280,
tied embeddings."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    vocab_size=50_280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=64,
    tie_embeddings=True,
    max_seq_len=1_048_576,
    dtype="bfloat16",
)

SMOKE = CONFIG.with_overrides(
    num_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16,
    vocab_size=512, dtype="float32", param_dtype="float32",
    max_seq_len=256,
)

"""OLMo-1B [arXiv:2402.00838].

Dense decoder: 16L, d_model 2048, 16 heads (kv=16, i.e. MHA), d_ff 8192,
vocab 50304, *non-parametric* LayerNorm (no learnable scale — the OLMo
signature) and tied embeddings."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    vocab_size=50_304,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    norm="nonparametric_ln",
    tie_embeddings=True,
    max_seq_len=4096,
    dtype="bfloat16",
)

SMOKE = CONFIG.with_overrides(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, dtype="float32", param_dtype="float32",
    max_seq_len=256,
)

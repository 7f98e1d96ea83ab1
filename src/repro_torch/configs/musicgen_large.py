"""MusicGen-Large [arXiv:2306.05284].

Decoder-only LM over EnCodec tokens: 48L, d_model 2048, 32 heads
(kv=32, MHA, head_dim 64), d_ff 8192, vocab 2048 per codebook with 4
parallel codebook heads (delay pattern handled by the data pipeline).
The EnCodec frontend is a STUB: ``input_specs`` provides precomputed
frame embeddings (the summed codebook embeddings)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    vocab_size=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    modality="audio_stub",
    num_codebooks=4,
    max_seq_len=16_384,
    dtype="bfloat16",
)

SMOKE = CONFIG.with_overrides(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, dtype="float32", param_dtype="float32",
    max_seq_len=256,
)

"""Model configuration schema for all assigned architectures (the port's
own copy of ``repro/configs/base.py``; it imports neither jax nor the
reference package).

One dataclass covers the whole pool (dense / MoE / MLA / SSM / hybrid /
VLM-stub / audio-stub); per-arch modules in this package instantiate it
with the exact published numbers plus a reduced ``smoke`` variant used
by CPU tests.  The layer *layout* (which mixer / which FFN at each
depth) is derived here so the model code can scan over repeated groups.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace

__all__ = ["ModelConfig", "LayerSpec", "layer_layout", "scan_grouping"]


@dataclass(frozen=True)
class LayerSpec:
    """One decoder layer: mixer ∈ {attn, mla, mamba}, ffn ∈ {dense, moe}."""

    mixer: str
    ffn: str


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    # --- attention ---
    num_heads: int = 0  # 0 => attention-free
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # --- ffn ---
    d_ff: int = 0
    # --- norm / embeddings ---
    norm: str = "rmsnorm"  # rmsnorm | nonparametric_ln
    tie_embeddings: bool = False
    # --- MLA (DeepSeek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1  # MoE every k-th layer (offset 1), else dense
    first_dense_layers: int = 0
    norm_topk: bool = False
    aux_loss_coef: float = 0.001
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 64
    attn_layer_period: int = 0  # hybrid: one attn layer per period
    attn_layer_offset: int = 0
    # --- modality stubs ---
    modality: str = "text"  # text | vision_stub | audio_stub
    num_patches: int = 0  # vision_stub: patch embeddings prepended
    num_codebooks: int = 0  # audio_stub: parallel codebook heads
    # --- numerics / scale ---
    dtype: str = "float32"  # activations
    param_dtype: str = "float32"
    remat: bool = True
    max_seq_len: int = 131_072
    # --- attention impl selection (perf knob, see §Perf) ---
    attn_chunk: int = 1024  # KV chunk for the portable online-softmax path

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding table
        and lm_head shard over any mesh axis (e.g. InternVL2's 92553)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:
        """SSM inner width (expand * d_model)."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)


def layer_layout(cfg: ModelConfig) -> list[LayerSpec]:
    """Mixer/FFN assignment for every layer, matching published configs."""
    specs = []
    for i in range(cfg.num_layers):
        # mixer
        if cfg.family == "ssm":
            mixer = "mamba"
        elif cfg.attn_layer_period:  # hybrid: sparse attention layers
            mixer = (
                "attn"
                if i % cfg.attn_layer_period == cfg.attn_layer_offset
                else "mamba"
            )
        elif cfg.use_mla:
            mixer = "mla"
        else:
            mixer = "attn"
        # ffn
        if cfg.num_experts and i >= cfg.first_dense_layers and (
            (i + 1) % cfg.moe_layer_period == 0
        ):
            ffn = "moe"
        elif cfg.d_ff > 0:
            ffn = "dense"
        else:
            ffn = "none"  # SSM blocks (Mamba2) carry no separate FFN
        specs.append(LayerSpec(mixer, ffn))
    return specs


def scan_grouping(cfg: ModelConfig) -> tuple[list[LayerSpec], int, list[LayerSpec]]:
    """Split layers into (prefix, repeated group × count).

    Returns (prefix_specs, num_groups, group_specs) such that
    prefix + group × num_groups == layer_layout(cfg).  The repeated group
    is what ``lax.scan`` iterates — it keeps the compiled HLO size
    O(group) instead of O(num_layers).
    """
    layout = layer_layout(cfg)
    prefix: list[LayerSpec] = []
    rest = layout
    if cfg.first_dense_layers:
        prefix = layout[: cfg.first_dense_layers]
        rest = layout[cfg.first_dense_layers :]
    # Find the smallest period that tiles `rest`.
    n = len(rest)
    for g in range(1, n + 1):
        if n % g:
            continue
        if all(rest[i] == rest[i % g] for i in range(n)):
            return prefix, n // g, rest[:g]
    return prefix, 1, rest

"""ModelConfig: one dataclass covering every assigned architecture family.

The PyTorch copy of ``repro.configs.base``: the same fields and defaults, so
a config built here compares field by field with the JAX one. The ``jnp``
dtype properties become ``torch_dtype`` / ``param_torch_dtype``.

Each ``configs/<arch>.py`` exports ``CONFIG`` (full size) and
``smoke_config()`` (reduced same-family config for CPU tests).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention ---
    attention_type: str = "gqa"      # gqa | mla
    attention_bias: bool = False     # Qwen-style QKV bias
    causal: bool = True              # False for encoder-only
    rope_theta: float = 1e4
    mrope: bool = False              # Qwen2-VL multimodal RoPE
    attn_chunk: int = 1024           # online-softmax KV chunk
    attn_bf16: bool = False          # bf16 q/k/v chunk operands

    # --- MLA (DeepSeek-V3) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mla_absorbed: bool = False

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    moe_mode: str = "scatter"        # scatter | eval_all
    moe_capacity_factor: float = 1.25
    moe_sigmoid_router: bool = False
    moe_a2a_bits: int = 0

    # --- block pattern (hybrid / recurrent) ---
    block_pattern: Tuple[str, ...] = ("attn",)

    # --- SSM / recurrent dims ---
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128

    # --- embeddings / head / misc ---
    tie_embeddings: bool = False
    embedding_onehot: bool = False
    norm_eps: float = 1e-5
    mtp_depth: int = 0
    frontend: Optional[str] = None   # "audio" | "vision" stubs

    # --- numerics ---
    dtype: str = "bfloat16"          # activations/compute
    param_dtype: str = "float32"
    loss_chunk: int = 0

    # --- distribution defaults ---
    shard_heads: bool = True
    remat: str = "block"             # none | block | full

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    @property
    def torch_dtype(self) -> torch.dtype:
        """Compute (activation) dtype."""
        return _DTYPES[self.dtype]

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: the cycled block pattern."""
        return tuple(self.block_pattern[i % len(self.block_pattern)]
                     for i in range(self.num_layers))

    def is_moe_layer(self, idx: int) -> bool:
        if not self.num_experts:
            return False
        if idx < self.first_k_dense:
            return False
        return (idx - self.first_k_dense - self.moe_offset) % self.moe_every == 0

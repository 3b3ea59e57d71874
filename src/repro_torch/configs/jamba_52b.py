"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
vocab=65536. Mamba:attention 7:1 interleave (attn at offset 4, period 8),
MoE 16 experts top-2 on every other layer (offset 1). [arXiv:2403.19887]

Hybrid: only 4 attention layers hold a KV cache; the 28 Mamba layers carry
O(1) SSM state — so this arch RUNS the long_500k cell."""
from .base import ModelConfig

_PERIOD = ("mamba", "mamba", "mamba", "mamba",
           "attn", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=_PERIOD,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=14336,
    moe_every=2,
    moe_offset=1,
    ssm_state_dim=16,
    ssm_conv_dim=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256,
        block_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        num_experts=4, experts_per_token=2, moe_d_ff=96,
        moe_every=2, moe_offset=1, moe_mode="eval_all",
        ssm_state_dim=8, ssm_conv_dim=4, ssm_expand=2, ssm_head_dim=16,
        ssm_chunk=32, dtype="float32", attn_chunk=64)

"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 (expert), vocab=202048, MoE 128 routed experts top-1 + 1 shared,
interleaved MoE every other layer (dense layers use d_ff=16384).
[hf:meta-llama/Llama-4-Maverick-17B-128E]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=16384,              # dense (non-MoE) layers
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    num_shared_experts=1,
    moe_d_ff=8192,           # per routed expert
    moe_every=2,             # interleaved: MoE on every other layer
    moe_offset=1,
    rope_theta=5e5,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke", family="moe",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=160, vocab_size=256,
        num_experts=4, experts_per_token=1, num_shared_experts=1,
        moe_d_ff=96, moe_every=2, moe_offset=1, moe_mode="eval_all",
        dtype="float32", attn_chunk=64)

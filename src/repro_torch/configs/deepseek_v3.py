"""deepseek-v3-671b [moe]: 61L d_model=7168 128H, MLA attention
(q_lora 1536, kv_lora 512, nope 128 + rope 64 / v 128), MoE: first 3 layers
dense (d_ff=18432), then 256 routed experts (top-8, sigmoid router,
moe_d_ff=2048) + 1 shared expert, MTP depth 1, vocab=129280.
[arXiv:2412.19437]

The MLA latent (kv_lora_rank + rope_dim = 576/token) IS the KV cache — the
arch where the paper's per-layer "data" quantization bites hardest at decode.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,              # the 3 leading dense layers
    vocab_size=129280,
    attention_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    first_k_dense=3,
    moe_sigmoid_router=True,
    mtp_depth=1,
    rope_theta=1e4,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-smoke", family="moe",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=256,
        attention_type="mla", q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        num_experts=4, experts_per_token=2, num_shared_experts=1,
        moe_d_ff=48, first_k_dense=1, moe_sigmoid_router=True,
        mtp_depth=1, moe_mode="eval_all",
        dtype="float32", attn_chunk=64)

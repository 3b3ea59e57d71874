"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
M-RoPE, tied embeddings. [arXiv:2409.12191]

Vision frontend (dynamic-resolution ViT patchifier) is a STUB per the
assignment: ``input_specs()`` supplies precomputed patch/token embeddings and
(B, S, 3) M-RoPE position ids; the LM backbone is fully real."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    attention_bias=True,
    mrope=True,
    rope_theta=1e6,
    tie_embeddings=True,
    frontend="vision",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b-smoke", family="vlm",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, attention_bias=True, mrope=True,
        rope_theta=1e6, tie_embeddings=True, frontend="vision",
        dtype="float32", attn_chunk=64)

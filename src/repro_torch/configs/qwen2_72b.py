"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, QKV bias. [arXiv:2407.10671]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    attention_bias=True,
    rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-smoke", family="dense",
        num_layers=4, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=192, vocab_size=256, attention_bias=True, rope_theta=1e6,
        dtype="float32", attn_chunk=64)

"""qwen1.5-32b [dense]: 64L d_model=5120 40H (GQA kv=40 = MHA) d_ff=27392
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-32B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    attention_bias=True,
    rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b-smoke", family="dense",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=256, attention_bias=True, rope_theta=1e6,
        dtype="float32", attn_chunk=64)

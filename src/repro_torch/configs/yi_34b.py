"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
llama-arch GQA. [arXiv:2403.04652]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5e6,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke", family="dense",
        num_layers=4, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=128, vocab_size=256, rope_theta=5e6,
        dtype="float32", attn_chunk=64)

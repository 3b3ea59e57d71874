"""hubert-xlarge [audio]: 48L d_model=1280 16H d_ff=5120 vocab=504 (unit
targets), encoder-only (bidirectional), w2v2-style backbone.
[arXiv:2106.07447]

Modality frontend (conv feature extractor) is a STUB per the assignment:
``input_specs()`` supplies precomputed frame embeddings (B, S, 1280); the
backbone transformer is fully real. Decode shapes are skipped (no
autoregressive decode for an encoder)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    frontend="audio",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", family="encoder",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=32, causal=False, frontend="audio",
        dtype="float32", attn_chunk=64)

"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 (no separate FFN; the
mLSTM/sLSTM blocks carry their own up/down projections) vocab=50304.
xLSTM[7:1] layer mix: one sLSTM block per 8 layers. [arXiv:2405.04517]

O(1)-in-sequence recurrent state, so this arch RUNS the long_500k cell."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm",
                   "mlstm", "mlstm", "mlstm", "slstm"),
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-smoke", family="ssm",
        num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
        d_ff=0, vocab_size=128,
        block_pattern=("mlstm", "slstm"),
        ssm_expand=2, ssm_chunk=32, tie_embeddings=True,
        dtype="float32")

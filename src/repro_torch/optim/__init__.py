"""Training optimizers of the port: AdamW (optionally int8 moments), the
learning-rate schedules and gradient compression with error feedback."""
from .adamw import AdamWConfig, adamw_init, adamw_update
from .compress import (CompressionConfig, compress_gradients,
                       error_feedback_init, quantized_allreduce)
from .schedule import constant_lr, cosine_warmup, linear_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "constant_lr", "cosine_warmup", "linear_warmup",
           "CompressionConfig", "error_feedback_init",
           "quantized_allreduce", "compress_gradients"]

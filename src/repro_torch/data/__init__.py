"""Datasets: the paper's CNN experiment (procedural, pure numpy) and the
synthetic LM corpus of the trainer, with its data pipeline."""
from .lm import LMDataConfig, lm_batch, lm_eval_stream
from .pipeline import DataPipeline, PipelineConfig
from .synthetic import digits_dataset, shapes32_dataset

__all__ = ["DataPipeline", "LMDataConfig", "PipelineConfig",
           "digits_dataset", "lm_batch", "lm_eval_stream",
           "shapes32_dataset"]

"""Datasets of the paper's CNN experiment (procedural, pure numpy)."""
from .synthetic import digits_dataset, shapes32_dataset

__all__ = ["digits_dataset", "shapes32_dataset"]

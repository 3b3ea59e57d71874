"""Cells cut to a size a CPU test can run: every width small, float32,
the same files otherwise (the cell's driver, mix kind and metrics)."""
from __future__ import annotations

import copy

from bench import core

SMALL_DIMS = {"hidden_size": 64, "intermediate_size": 128,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "vocab_size": 512, "torch_dtype": "float32"}


def small(spec: core.CellSpec, layers: int = 2) -> core.CellSpec:
    """``spec`` at CPU-test size, by its driver."""
    spec.config = dict(spec.config, num_hidden_layers=layers, **SMALL_DIMS)
    if spec.cell["driver"] == "train_loop":
        spec.config["num_key_value_heads"] = spec.config[
            "num_attention_heads"]
        spec.mix = dict(spec.mix, rows=4, seq=32)
        return spec
    spec.config["serve"] = dict(spec.config["serve"], slots=4,
                                num_pages=400, prefill_bucket=16)
    mix = copy.deepcopy(spec.mix)
    mix["documents"].update(count=3, length={"median": 48, "sigma": 0.5,
                                             "min": 24, "max": 80})
    mix["question"] = {"median": 8, "sigma": 0.5, "min": 4, "max": 16}
    mix["answer"] = {"median": 32, "sigma": 0.3, "min": 24, "max": 48}
    spec.mix = mix
    spec.cell = dict(spec.cell, rate_rps=12.0, ramp_s=0.3, follow_s=20,
                     trace_s=0.3)
    spec.cell["serve"] = dict(spec.cell["serve"], sample_tokens=100)
    return spec


def serve_spec(layers: int = 2) -> core.CellSpec:
    return small(core.load_cell("qwen2-72b-x20.docqa-shared"), layers)


def train_spec(layers: int = 2) -> core.CellSpec:
    return small(core.load_cell("deepseek-7b-x8.train-w10d12"), layers)

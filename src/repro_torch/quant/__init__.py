"""Glue between precision policies and the transformer stack."""
from .apply import (build_model_quant, transformer_layer_names,
                    transformer_traffic_model, quantize_param_tree,
                    policy_footprint_report)

__all__ = ["build_model_quant", "transformer_layer_names",
           "transformer_traffic_model", "quantize_param_tree",
           "policy_footprint_report"]

"""Numerics core: fixed-point formats, bit packing, precision policies,
range calibration and the precision searches, and the paged quantized KV
pool. The package re-exports the reference package's public names."""
from .fixedpoint import (FixedPointFormat, fake_quant, fake_quant_ste,
                         format_params, quantize, dequantize,
                         quantization_error, required_int_bits)
from .qtensor import QuantizedTensor, pack_bits, unpack_bits, values_per_word
from .policy import FIELDS, LayerPolicy, PrecisionPolicy
from .traffic import LayerTraffic, TrafficModel, BASELINE_BITS
from .calibrate import RangeStats, calibrated_policy, int_bits_for
from .search import (SearchPoint, SearchResult, greedy_pareto_search,
                     sensitivity_profile, sensitivity_search)

__all__ = [
    "FixedPointFormat", "fake_quant", "fake_quant_ste", "format_params",
    "quantize", "dequantize", "quantization_error", "required_int_bits",
    "QuantizedTensor", "pack_bits", "unpack_bits", "values_per_word",
    "FIELDS", "LayerPolicy", "PrecisionPolicy",
    "LayerTraffic", "TrafficModel", "BASELINE_BITS",
    "RangeStats", "calibrated_policy", "int_bits_for",
    "SearchPoint", "SearchResult", "greedy_pareto_search",
    "sensitivity_profile", "sensitivity_search",
]

"""Numerics core: fixed-point formats, bit packing, precision policies,
range calibration and the precision searches, and the paged quantized KV
pool."""

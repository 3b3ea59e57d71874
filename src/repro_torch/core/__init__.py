"""Numerics core: fixed-point formats, bit packing, precision policies
and the paged quantized KV pool."""

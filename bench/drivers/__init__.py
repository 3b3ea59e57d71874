"""Drivers of the benchmark: one module per driver kind named in a cell file."""

"""Benchmarks of the port: kernels on the card against their oracles."""

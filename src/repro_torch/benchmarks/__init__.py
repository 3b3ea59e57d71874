"""Benchmarks of the port: kernels on the card against their oracles, and
the paper's CNN precision experiment (Fig. 2-5 / Table 2)."""

"""CPU tests of the benchmark harness (card-only ones skip here)."""

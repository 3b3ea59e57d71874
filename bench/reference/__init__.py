"""The plain reference of the benchmark's cells: plain PyTorch in float32
with TF32 off, importing nothing of the program (``repro_torch``) and
nothing of the JAX package."""

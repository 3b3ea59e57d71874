"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit). A share of a roofline or of a peak is held
against these, with the card's power limit reported beside it."""

BF16_FLOPS = 989e12      # bf16 / fp16 tensor-core FLOP/s
FP32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BYTES = 3.35e12      # HBM3 bytes/s

"""Train a small LM twice with the paper's per-layer precision as a
training feature, through the port's launcher (``launch.train``):

  1. the float-boundary baseline,
  2. per-layer quantized: 10-bit weights, 12-bit data, int8 KV, int8
     optimizer moments and the int8 gradient wire with error feedback,

and compare the final losses: the quantized run should track the
baseline while its boundary tensors carry 3x fewer bits. The weight and
data fake-quant are straight-through estimators, so every block matrix
learns in the quantized run.

The model is the ``--arch`` smoke config (deepseek-7b's by default;
every arch of the registry trains, ``--arch xlstm-350m`` too, whose
mLSTM memories sit on the layers' KV grid at each chunk boundary in the
quantized run), batch 8 x 256 tokens.

    python -m repro_torch.examples.train_lm_mixed_precision \\
        [--steps N] [--device cpu]

Runs on the CUDA card by default and raises without one.
"""
import argparse

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    common = ["--arch", args.arch, "--smoke", "--steps", str(args.steps),
              "--batch-size", "8", "--seq-len", "256", "--lr", "1e-3",
              "--log-every", "20", "--device", args.device]

    print("=== baseline (fp boundaries) ===")
    base = train_mod.main(common)

    print("=== per-layer quantized (W10/D12/KV8 + int8 moments + "
          "int8 grad wire) ===")
    quant = train_mod.main(common + [
        "--weight-bits", "10", "--data-bits", "12", "--kv-bits", "8",
        "--int8-moments", "--grad-compress"])

    b, q = base[-1]["loss"], quant[-1]["loss"]
    print(f"\nfinal loss: baseline={b:.4f} quantized={q:.4f} "
          f"(+{(q - b) / b:+.2%})")
    print("boundary bits: weights 32->10, data 32->12, KV 32->8, "
          "optimizer moments 32->8(+scale), grad wire 32->8")
    return base, quant


if __name__ == "__main__":
    main()

"""PyTorch/CUDA port of ``repro`` (the JAX package stays the reference).

The subpackages mirror ``repro``'s (``configs``, ``core``, ``quant``,
``models``, ``kernels``, ``launch``, ``runtime``), one port module per
reference module of the same name. Nothing here imports ``jax`` or
``repro``. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; they never fall back to the CPU on their own.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device`` with its index filled in ("cuda"
    names the current card, so it compares equal to a tensor's device);
    raises when CUDA is asked for and no card is present (the CPU path
    must be requested explicitly)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

"""Glue between the paper's PrecisionPolicy and the transformer stack.

* ``transformer_layer_names`` — the policy's layer-name space for an arch.
* ``build_model_quant`` — policy -> :class:`ModelQuant`, uniform KV
  container branch: each layer's KV cache inherits the layer's *data*
  format, clipped to the container width.
* ``kv_profile_key`` — the canonical string of a KV quantization setup.

Per-layer KV containers (``per_layer_kv``), weight and residual-stream
fake-quant, the traffic model and ``quantize_param_tree`` are still to port
(ROADMAP queue A items 2 and 8).
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..core.policy import PrecisionPolicy
from ..models.transformer import ModelQuant

# the reference's stand-in format for a layer without a data format
# (``PrecisionPolicy.stacked_arrays``): Q16.14
_NO_FORMAT = (16, 14)


def transformer_layer_names(cfg) -> Tuple[str, ...]:
    return tuple(f"layer_{i:03d}" for i in range(cfg.num_layers))


def build_model_quant(policy: Optional[PrecisionPolicy], cfg,
                      *, quantize_kv: bool = True,
                      quantize_activations: bool = True,
                      kv_container: str = "int8",
                      per_layer_kv: bool = False,
                      kv_scale_mode: str = "static") -> Optional[ModelQuant]:
    """PrecisionPolicy -> ModelQuant. Policy layer i == transformer layer i.

    The KV cache of layer i stores on the grid of the layer's data format
    clipped to the container width: ``tot = clip(I + F, 2, cap)``,
    ``I' = min(I, tot - 1)``, ``F' = tot - I'`` (the reference's arithmetic,
    on python ints)."""
    if policy is None:
        return None
    if len(policy) != cfg.num_layers:
        raise ValueError(f"policy has {len(policy)} layers, model has "
                         f"{cfg.num_layers}")
    if per_layer_kv:
        raise NotImplementedError(
            "per-layer KV containers (--kv-profile) are not ported yet: "
            "ROADMAP queue A item 8")
    if any(lp.weight is not None for lp in policy.layers):
        raise NotImplementedError(
            "weight fake-quant is not ported yet: ROADMAP queue A item 2")
    if quantize_activations and any(lp.data is not None
                                    for lp in policy.layers):
        raise NotImplementedError(
            "residual-stream fake-quant is not ported yet: ROADMAP queue A "
            "item 2")
    if not quantize_kv:
        return ModelQuant()
    cap = {"int4": 4, "int8": 8, "int16": 16}[kv_container]
    kv_int, kv_frac = [], []
    for lp in policy.layers:
        a_i, a_f = ((lp.data.int_bits, lp.data.frac_bits)
                    if lp.data is not None else _NO_FORMAT)
        tot = min(max(a_i + a_f, 2), cap)
        i = min(a_i, tot - 1)
        kv_int.append(i)
        kv_frac.append(tot - i)
    return ModelQuant(kv_int=tuple(kv_int), kv_frac=tuple(kv_frac),
                      kv_container=kv_container, kv_scale_mode=kv_scale_mode)


def kv_layer_container(data_fmt) -> str:
    """Storage container for one layer's KV under its data format."""
    if data_fmt is None:
        return "fp"
    return "int4" if data_fmt.total_bits <= 4 else "int8"


def kv_profile_key(policy: Optional[PrecisionPolicy], *,
                   kv_bits: int = 0, kv_scale_mode: str = "static") -> str:
    """Canonical string identifying a KV quantization configuration (the
    reference's prefix-cache namespace key)."""
    if policy is not None:
        per = ",".join(
            f"{kv_layer_container(lp.data)}"
            + (f":Q{lp.data.int_bits}.{lp.data.frac_bits}" if lp.data else "")
            for lp in policy.layers)
    else:
        per = f"uniform{kv_bits}"
    return f"{per}|scale={kv_scale_mode}"

"""Glue between the paper's PrecisionPolicy and the transformer stack.

* ``transformer_layer_names`` — the policy's layer-name space for an arch.
* ``build_model_quant`` — policy -> :class:`ModelQuant`, uniform KV
  container branch: each layer's KV cache inherits the layer's *data*
  format, clipped to the container width.
* ``kv_profile_key`` — the canonical string of a KV quantization setup.
* ``quantize_param_tree`` — a dense model's weights as QuantizedTensors.

Per-layer KV containers (``per_layer_kv``), weight and residual-stream
fake-quant and the traffic model are still to port (ROADMAP queue A items
2 and 8).
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..core.policy import PrecisionPolicy
from ..core.qtensor import QuantizedTensor
from ..models.transformer import ModelQuant, Transformer

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


def quantize_param_tree(model: Transformer, policy: PrecisionPolicy, *,
                        pack: bool = True) -> dict:
    """A dense model's weights on their integer grids, one QuantizedTensor
    per floating weight of rank >= 2 of every layer; every other leaf
    (embedding, head, norm scales, biases) passes through as the model's
    tensor.

    The format is the reference's: a dense model is one segment, and every
    layer gets the maximum int and frac bits over the segment's weight
    formats (Q2.6 when no layer has one); grids of at most 8 bits are
    lane-packed when ``pack``. Returns ``{"embed": {"table"},
    "final_norm": {"scale"}, "head": {"kernel"} (untied only), "layers":
    [per layer {"mixer": {wq, wk, wv, wo[, bq, bk, bv]}, "ffn": {w_gate,
    w_up, w_down}, "norm1": {"scale"}, "norm2": {"scale"}}]}``: the
    reference's leaf names, with its scan-stacked segment split into one
    dict per layer.

    Orientation: the port stores every projection as the reference does,
    ``(d_in, d_out)`` (``x @ w``), so each grid here is the reference's
    slice for that layer, and an unpacked grid goes to ``ops.qmatmul`` as
    ``wq (K, N)`` unchanged, with scales ``2^-F``."""
    cfg = model.cfg
    if len(policy) != cfg.num_layers:
        raise ValueError(f"policy has {len(policy)} layers, model has "
                         f"{cfg.num_layers}")
    fmts = [lp.weight for lp in policy.layers if lp.weight is not None]
    ib = max((f.int_bits for f in fmts), default=2)
    fb = max((f.frac_bits for f in fmts), default=6)
    packed = pack and ib + fb <= 8

    def q(t):
        if t.dim() >= 2 and t.is_floating_point():
            return QuantizedTensor.from_float(t, ib, fb, pack=packed)
        return t

    attn = ["wq", "wk", "wv", "wo"]
    if cfg.attention_bias:
        attn += ["bq", "bk", "bv"]
    out = {"embed": {"table": model.embed},
           "final_norm": {"scale": model.final_norm}}
    if model.head is not None:
        out["head"] = {"kernel": model.head}
    out["layers"] = [{
        "mixer": {n: q(getattr(blk.attn, n)) for n in attn},
        "ffn": {n: q(getattr(blk.mlp, n))
                for n in ("w_gate", "w_up", "w_down")},
        "norm1": {"scale": blk.norm1}, "norm2": {"scale": blk.norm2},
    } for blk in model.layers]
    return out

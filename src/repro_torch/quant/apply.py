"""Glue between the paper's PrecisionPolicy and the transformer stack.

* ``transformer_layer_names`` — the policy's layer-name space for an arch.
* ``build_model_quant`` — policy -> :class:`ModelQuant`: per-layer weight,
  residual-data and KV formats, in one uniform KV container or, with
  ``per_layer_kv``, one container per layer (``--kv-profile``).
* ``transformer_traffic_model`` — the paper's §2.4 access counting applied
  to a transformer workload (train / prefill / decode);
  ``policy_footprint_report`` prices a policy with it.
* ``kv_layer_container`` — a layer's KV container under its data format;
  ``kv_profile_key`` — the canonical string of a KV quantization setup
  (the prefix cache's namespace).
* ``quantize_param_tree`` — a model's weights as QuantizedTensors, one
  format per layer segment.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..configs.counting import (kv_bytes_per_token, layer_param_count,
                                layer_segments, layer_signatures)
from ..core.policy import PrecisionPolicy
from ..core.qtensor import QuantizedTensor
from ..core.traffic import LayerTraffic, TrafficModel
from ..models.transformer import ModelQuant, Transformer, block_leaves


def transformer_layer_names(cfg) -> Tuple[str, ...]:
    return tuple(f"layer_{i:03d}" for i in range(cfg.num_layers))


def _ints(t) -> Tuple[int, ...]:
    return tuple(int(v) for v in t.tolist())


def build_model_quant(policy: Optional[PrecisionPolicy], cfg,
                      *, quantize_kv: bool = True,
                      quantize_activations: bool = True,
                      kv_container: str = "int8",
                      per_layer_kv: bool = False,
                      kv_scale_mode: str = "static") -> Optional[ModelQuant]:
    """PrecisionPolicy -> ModelQuant. Policy layer i == transformer layer i.

    Formats come from ``policy.stacked_arrays``, so a layer without a
    format holds the Q16.14 sentinel. Weight fake-quant is on when ANY
    layer has a weight format, and then covers every layer, sentinel ones
    included; so does residual-stream fake-quant with data formats (off
    with ``quantize_activations=False``, which leaves the data bits to the
    KV cache alone). The KV cache of layer i stores on the grid of the
    layer's data format clipped to the container width:
    ``tot = clip(I + F, 2, cap)``, ``I' = min(I, tot - 1)``,
    ``F' = tot - I'`` (the reference's arithmetic, on python ints).

    ``per_layer_kv=True`` gives each layer its own container from its data
    bits (:func:`kv_layer_container`: <= 4 bits "int4", <= 8 "int8", a
    float layer "fp", whose pool stores float pages) and clips each
    layer's grid to its container (cap 8 for "fp", whose grid is unused).
    The reference's ``kv_unroll`` has no counterpart: it picks one of two
    XLA lowerings, and the port's forward is one per-layer loop. An MLA
    layer's KV spec applies to its latent (``ModelQuant.layer_kv``), the
    whole of its cache."""
    if policy is None:
        return None
    if len(policy) != cfg.num_layers:
        raise ValueError(f"policy has {len(policy)} layers, model has "
                         f"{cfg.num_layers}")
    w_i, w_f, w_en = policy.stacked_arrays("weight")
    a_i, a_f, a_en = policy.stacked_arrays("data")
    w_on = bool(w_en.any())
    act_on = quantize_activations and bool(a_en.any())
    kv_int = kv_frac = kv_containers = None
    if quantize_kv:
        if per_layer_kv:
            kv_containers = tuple(kv_layer_container(lp.data)
                                  for lp in policy.layers)
            caps = [{"int4": 4, "int8": 8, "fp": 8}[c] for c in kv_containers]
        else:
            caps = [{"int4": 4, "int8": 8, "int16": 16}[kv_container]] \
                * len(policy)
        kv_int, kv_frac = [], []
        for i, f, cap in zip(_ints(a_i), _ints(a_f), caps):
            tot = min(max(i + f, 2), cap)
            kv_int.append(min(i, tot - 1))
            kv_frac.append(tot - kv_int[-1])
        kv_int, kv_frac = tuple(kv_int), tuple(kv_frac)
    return ModelQuant(
        w_int=_ints(w_i) if w_on else None,
        w_frac=_ints(w_f) if w_on else None,
        a_int=_ints(a_i) if act_on else None,
        a_frac=_ints(a_f) if act_on else None,
        kv_int=kv_int, kv_frac=kv_frac, kv_container=kv_container,
        kv_containers=kv_containers, kv_scale_mode=kv_scale_mode)


def kv_layer_container(data_fmt) -> str:
    """Storage container for one layer's KV under its data format."""
    if data_fmt is None:
        return "fp"
    return "int4" if data_fmt.total_bits <= 4 else "int8"


def kv_profile_key(policy: Optional[PrecisionPolicy], *,
                   kv_bits: int = 0, kv_scale_mode: str = "static") -> str:
    """Canonical string identifying a KV quantization configuration. The
    prefix cache namespaces its trie by it, so pages are shared only
    between identically quantized configurations."""
    if policy is not None:
        per = ",".join(
            f"{kv_layer_container(lp.data)}"
            + (f":Q{lp.data.int_bits}.{lp.data.frac_bits}" if lp.data else "")
            for lp in policy.layers)
    else:
        per = f"uniform{kv_bits}"
    return f"{per}|scale={kv_scale_mode}"


def transformer_traffic_model(cfg, *, batch: int, seq_len: int,
                              mode: str = "train") -> TrafficModel:
    """Access counts per layer for the paper's traffic accounting.

    train/prefill: weights once per batch; data = residual in+out per
    token. decode: per generated token, weights once and the KV history
    read once (the dominant term the paper's 'batch' analysis predicts)."""
    names = transformer_layer_names(cfg)
    sigs = layer_signatures(cfg)
    layers = []
    tok = batch * seq_len
    D = cfg.d_model
    for i, n in enumerate(names):
        w = layer_param_count(cfg, i, active_only=True)
        if mode in ("train", "prefill"):
            d_in = tok * D
            d_out = tok * D
        elif mode == "decode":
            kind, _ = sigs[i]
            kv_hist = 0
            if kind == "attn":
                kv_hist = (seq_len * (cfg.kv_lora_rank
                                      + cfg.qk_rope_head_dim)
                           if cfg.attention_type == "mla"
                           else seq_len * 2 * cfg.num_kv_heads
                           * cfg.head_dim)
            d_in = batch * (D + kv_hist)
            d_out = batch * D
        else:
            raise ValueError(mode)
        layers.append(LayerTraffic(n, w, d_in, d_out))
    return TrafficModel(tuple(layers))


def policy_footprint_report(policy: PrecisionPolicy, cfg, *, batch: int,
                            seq_len: int) -> dict:
    """Bytes summary: weights / KV / residual data under the policy
    against float32 and 16-bit baselines (decode traffic)."""
    tm = transformer_traffic_model(cfg, batch=batch, seq_len=seq_len,
                                   mode="decode")
    tr = tm.traffic_ratio(policy, batch_size=1)
    w_bits = [lp.weight.total_bits if lp.weight else 32
              for lp in policy.layers]
    d_bits = [lp.data.total_bits if lp.data else 32 for lp in policy.layers]
    return {
        "traffic_ratio_vs_fp32": tr,
        "traffic_ratio_vs_16b": tr * 2.0,
        "mean_weight_bits": float(np.mean(w_bits)),
        "mean_data_bits": float(np.mean(d_bits)),
        "kv_bytes_per_token_fp32": kv_bytes_per_token(cfg, 4.0),
        "kv_bytes_per_token_policy": kv_bytes_per_token(
            cfg, float(np.mean(d_bits)) / 8.0),
    }


def _nest(leaves) -> dict:
    """{path tuple: value} -> the nested dict those paths name."""
    out: dict = {}
    for path, v in leaves:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def quantize_param_tree(model: Transformer, policy: PrecisionPolicy, *,
                        pack: bool = True) -> dict:
    """A model's weights on their integer grids, one QuantizedTensor per
    floating weight of rank >= 2 of every layer (expert stacks, router,
    shared expert and MLA projections included); every other leaf
    (embedding, head, norm scales, biases, the ``mtp`` module) passes
    through as the model's tensor.

    The formats are the reference's: each layer segment
    (``layer_segments``) takes the maximum int and frac bits over its own
    layers' weight formats (Q2.6 when none of them has one), and its grids
    of at most 8 bits are lane-packed when ``pack``. Returns ``{"embed":
    {"table"}, "final_norm": {"scale"}, "head": {"kernel"} (untied only),
    "layers": [per layer {"mixer": {...}, "ffn": {...}, "norm1":
    {"scale"}, "norm2": {"scale"}}], "mtp": {...} (with MTP only)}``: the
    reference's leaf names (``block_leaves``), with its scan-stacked
    segments split into one dict per layer.

    Orientation: the port stores every projection as the reference does,
    ``(d_in, d_out)`` (``x @ w``), so each grid here is the reference's
    slice for that layer, and an unpacked 2-D grid goes to
    ``ops.qmatmul`` as ``wq (K, N)`` unchanged, with scales ``2^-F``."""
    cfg = model.cfg
    if len(policy) != cfg.num_layers:
        raise ValueError(f"policy has {len(policy)} layers, model has "
                         f"{cfg.num_layers}")
    layers = [None] * cfg.num_layers
    for pattern, periods, start in layer_segments(cfg):
        idx = range(start, start + periods * len(pattern))
        fmts = [policy.layers[i].weight for i in idx
                if policy.layers[i].weight is not None]
        ib = max((f.int_bits for f in fmts), default=2)
        fb = max((f.frac_bits for f in fmts), default=6)
        packed = pack and ib + fb <= 8

        def q(t):
            if t.dim() >= 2 and t.is_floating_point():
                return QuantizedTensor.from_float(t, ib, fb, pack=packed)
            return t
        for li in idx:
            layers[li] = _nest((path, q(t)) for path, t in
                               block_leaves(model.layers[li], cfg))
    out = {"embed": {"table": model.embed},
           "final_norm": {"scale": model.final_norm}}
    if model.head is not None:
        out["head"] = {"kernel": model.head}
    out["layers"] = layers
    if model.mtp is not None:
        out["mtp"] = {"proj": model.mtp.proj,
                      "block": _nest(block_leaves(model.mtp.block, cfg)),
                      "norm": {"scale": model.mtp.norm}}
    return out

"""Analytic parameter counting: feeds the transformer traffic model and
``ModelConfig.param_count``. Plain arithmetic on the config, for every
family of the registry. Also the layer structure the models,
converter and quantized trees share: ``layer_signatures``,
``layer_segments`` and ``segment_layers``."""
from __future__ import annotations

from typing import Iterator, List, Tuple


def layer_signatures(cfg) -> Tuple[Tuple[str, str], ...]:
    """Per-layer (kind, ffn) with ffn in {mlp, moe, none}: the reference's
    ``models.transformer.layer_signatures``."""
    sigs = []
    kinds = cfg.layer_kinds
    for i in range(cfg.num_layers):
        kind = kinds[i]
        if kind in ("mlstm", "slstm"):
            ffn = "none"
        elif cfg.is_moe_layer(i):
            ffn = "moe"
        else:
            ffn = "mlp"
        sigs.append((kind, ffn))
    return tuple(sigs)


def layer_segments(cfg) -> List[Tuple[Tuple[Tuple[str, str], ...], int,
                                      int]]:
    """The reference's ``models.transformer.layer_segments``: the layers
    split at ``first_k_dense`` into ``(pattern, periods, start)`` segments
    whose ``pattern`` repeats exactly ``periods`` times. Layer
    ``start + p * len(pattern) + j`` has signature ``pattern[j]``."""
    sigs = layer_signatures(cfg)
    bounds = [0]
    if 0 < cfg.first_k_dense < cfg.num_layers:
        bounds.append(cfg.first_k_dense)
    bounds.append(cfg.num_layers)
    segments = []
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        seg = sigs[b0:b1]
        n = len(seg)
        period = n
        for p in range(1, n + 1):
            if n % p == 0 and all(seg[i] == seg[i % p] for i in range(n)):
                period = p
                break
        segments.append((tuple(seg[:period]), n // period, b0))
    return segments


def segment_layers(cfg) -> Iterator[Tuple[int, int, int, int]]:
    """Every layer as ``(layer, si, j, p)`` in layer order: pattern
    position ``j`` of segment ``si`` (:func:`layer_segments`), period
    ``p``, is layer ``start + p * len(pattern) + j``."""
    for si, (pattern, periods, start) in enumerate(layer_segments(cfg)):
        for p in range(periods):
            for j in range(len(pattern)):
                yield start + p * len(pattern) + j, si, j, p


def _attn_params(cfg) -> int:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.attention_type == "mla":
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        return (D * qr + qr * H * (dn + dr) + D * (kvr + dr)
                + kvr * H * (dn + dv) + H * dv * D)
    n = D * H * hd + 2 * D * KV * hd + H * hd * D
    if cfg.attention_bias:
        n += H * hd + 2 * KV * hd
    return n


def _mlp_params(cfg) -> int:
    if cfg.family == "encoder":
        return 2 * cfg.d_model * cfg.d_ff + cfg.d_ff + cfg.d_model
    return 3 * cfg.d_model * cfg.d_ff


def _moe_params(cfg, active_only: bool) -> int:
    D, F = cfg.d_model, cfg.moe_d_ff
    e = cfg.experts_per_token if active_only else cfg.num_experts
    n = cfg.d_model * cfg.num_experts          # router
    n += e * 3 * D * F                          # routed experts
    n += cfg.num_shared_experts * 3 * D * (F * cfg.num_shared_experts)
    return n


def _mamba_params(cfg) -> int:
    D = cfg.d_model
    di = cfg.ssm_expand * D
    nh = di // cfg.ssm_head_dim
    N = cfg.ssm_state_dim
    return (D * (2 * di + 2 * N + nh) + cfg.ssm_conv_dim * di + di
            + 2 * nh + di * D)


def _mlstm_params(cfg) -> int:
    D = cfg.d_model
    di = cfg.ssm_expand * D
    return D * 2 * di + 3 * di * di + 2 * di * cfg.num_heads + di * D


def _slstm_params(cfg) -> int:
    D = cfg.d_model
    nh = cfg.num_heads
    hd = D // nh
    return D * 4 * D + nh * hd * 4 * hd + D * D


def layer_param_count(cfg, idx: int, active_only: bool = False) -> int:
    kind, ffn = layer_signatures(cfg)[idx]
    n = 2 * cfg.d_model  # norms
    if kind == "attn":
        n += _attn_params(cfg)
    elif kind == "mamba":
        n += _mamba_params(cfg)
    elif kind == "mlstm":
        n += _mlstm_params(cfg)
    elif kind == "slstm":
        n += _slstm_params(cfg)
    if ffn == "mlp":
        n += _mlp_params(cfg)
    elif ffn == "moe":
        n += _moe_params(cfg, active_only)
    return n


def count_params(cfg, active_only: bool = False) -> int:
    n = cfg.vocab_size * cfg.d_model           # embed
    if not cfg.tie_embeddings:
        n += cfg.d_model * cfg.vocab_size       # head
    n += cfg.d_model                            # final norm
    for i in range(cfg.num_layers):
        n += layer_param_count(cfg, i, active_only)
    return n


def kv_bytes_per_token(cfg, bytes_per_elem: float = 2.0) -> float:
    """KV/state bytes appended per generated token (decode traffic model)."""
    total = 0.0
    for kind, _ in layer_signatures(cfg):
        if kind == "attn":
            if cfg.attention_type == "mla":
                total += (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
            else:
                total += 2 * cfg.num_kv_heads * cfg.head_dim
    return total * bytes_per_elem

"""Model FLOPs of a dense GQA decoder (the configuration's widths): the
matmuls' 2 FLOPs a weight a token, and attention's 4 * heads * head_dim
FLOPs a layer for each key a query reads (QK^T and PV). Norms, RoPE,
softmax and the embedding's gather are not counted."""
from __future__ import annotations


def layer_matmul_params(d) -> int:
    """Weights of one layer's matmuls (Q, K, V, O, gate, up, down)."""
    hq, hk = d.heads * d.head_dim, d.kv_heads * d.head_dim
    return d.d_model * (hq + 2 * hk) + hq * d.d_model + 3 * d.d_model * d.d_ff


def matmul_params(d, head: bool = True) -> int:
    """Weights of every matmul of a forward; ``head`` adds the LM head."""
    return d.layers * layer_matmul_params(d) + (d.d_model * d.vocab
                                                if head else 0)


def attn_flops_per_key(d) -> int:
    return 4 * d.heads * d.head_dim * d.layers


def forward_flops(d, *, tokens: int, keys: int, head: bool) -> float:
    """A forward of ``tokens`` tokens whose queries read ``keys`` keys in
    all (summed over tokens; a causal query at position p reads p + 1)."""
    return (2.0 * matmul_params(d, head) * tokens
            + float(attn_flops_per_key(d)) * keys)


def causal_keys(seq: int) -> int:
    """Keys read by a whole causal sequence of ``seq`` tokens."""
    return seq * (seq + 1) // 2


def train_step_flops(d, *, rows: int, seq: int) -> float:
    """One training step: forward and backward (3x the forward) of
    ``rows`` sequences of ``seq`` tokens, the head's matmul included."""
    return 3.0 * forward_flops(d, tokens=rows * seq,
                               keys=rows * causal_keys(seq), head=True)

"""The assigned input shapes, the rules for which arch runs which, and the
data batch of a train or prefill forward: its keys, shapes and dtypes
(:func:`batch_specs`) and a seeded draw of it (:func:`make_batch`).

Four shapes per LM arch:
  train_4k     seq 4096,   global_batch 256   -> train step
  prefill_32k  seq 32768,  global_batch 32    -> serve prefill (encoder
                                                 forward for encoder-only
                                                 archs)
  decode_32k   seq 32768,  global_batch 128   -> serve step (1 new token,
                                                 KV cache holding seq_len)
  long_500k    seq 524288, global_batch 1     -> serve step; only for archs
                                                 with sub-quadratic state
                                                 (ssm / hybrid)

A frontend arch (hubert-xlarge's audio, qwen2-vl-2b's vision) takes a stub
frontend's precomputed embeddings in place of token ids; an M-RoPE arch
also takes (B, S, 3) temporal / height / width position ids. The decode
shapes' cache specs go with the HLO tools (ROADMAP queue A item 13).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether ``cfg`` runs ``shape``: an encoder has no autoregressive
    decode, and only the SSM and hybrid archs run the 500k context."""
    if shape.kind == "decode" and cfg.family == "encoder":
        return False
    if shape.name == "long_500k":
        return cfg.family in ("ssm", "hybrid")
    return True


def applicable_shapes(cfg: ModelConfig):
    return [s for s in SHAPES.values() if applicable(cfg, s)]


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                batch_override: Optional[int] = None
                ) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """The data batch of a train or prefill forward, key -> (shape,
    dtype): ``embeds`` (B, S, d_model) in the compute dtype for a
    frontend arch, else ``tokens`` (B, S) int32; ``mrope_positions``
    (B, S, 3) int32 for an M-RoPE arch; ``labels`` (B, S) int32 for a
    train shape and for an encoder (its per-frame unit targets)."""
    B = batch_override if batch_override is not None else shape.global_batch
    S = shape.seq_len
    specs: Dict[str, Tuple[tuple, torch.dtype]] = {}
    if cfg.frontend is not None:
        specs["embeds"] = ((B, S, cfg.d_model), cfg.torch_dtype)
    else:
        specs["tokens"] = ((B, S), torch.int32)
    if cfg.mrope:
        specs["mrope_positions"] = ((B, S, 3), torch.int32)
    if shape.kind == "train" or cfg.family == "encoder":
        specs["labels"] = ((B, S), torch.int32)
    return specs


def mrope_ids(grid: Tuple[int, int, int], text: int, *,
              start: int = 0) -> torch.Tensor:
    """(t*h*w + text, 3) M-RoPE ids in Qwen2-VL's layout: a (t, h, w)
    patch grid from ``start`` (row-major, each patch its frame, row and
    column), then ``text`` positions whose three ids are equal, counting
    on from one past the grid's largest id."""
    t, h, w = grid
    tt, hh, ww = torch.meshgrid(torch.arange(t), torch.arange(h),
                                torch.arange(w), indexing="ij")
    vis = torch.stack([tt, hh, ww], dim=-1).reshape(-1, 3) + start
    nxt = int(vis.max()) + 1 if vis.numel() else start
    txt = torch.arange(nxt, nxt + text)[:, None].expand(text, 3)
    return torch.cat([vis, txt]).to(torch.int32)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, *,
               generator: torch.Generator, device,
               batch_override: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
    """A seeded draw of :func:`batch_specs` on ``device``, standing in for
    the stub frontend: ``embeds`` N(0, 1) (drawn in float32, cast),
    ``tokens`` and ``labels`` uniform over the vocabulary, and
    ``mrope_positions`` the largest square patch grid that fits the
    sequence at frame 0 followed by text positions (:func:`mrope_ids`),
    the same for every row. ``generator`` lives on ``device``."""
    out: Dict[str, torch.Tensor] = {}
    for key, (shp, dt) in batch_specs(cfg, shape,
                                      batch_override=batch_override).items():
        if key == "embeds":
            out[key] = torch.randn(shp, generator=generator, device=device,
                                   dtype=torch.float32).to(dt)
        elif key == "mrope_positions":
            B, S, _ = shp
            side = math.isqrt(S)
            ids = mrope_ids((1, side, side), S - side * side)
            out[key] = ids.to(device)[None].expand(B, S, 3).contiguous()
        else:
            out[key] = torch.randint(0, cfg.vocab_size, shp,
                                     generator=generator, device=device,
                                     dtype=dt)
    return out

"""AdamW with optionally int8-quantized moments (the reference's
``optim/adamw.py``: the paper's bounded memory applied to the optimizer
state).

int8 moments: the first moment m on a signed int8 grid with a per-row
absmax scale; the second moment v stored as int8 of sqrt(v), per-row
absmax scale. One scale per row of the last dim, a single scale for a 1-D
leaf. Every update computes in float32.

Parameters, gradients and moments are ``name -> tensor`` mappings (a
module's ``named_parameters``); the update writes the parameters and the
moments in place, a leaf of more than ``ROW_BLOCK`` elements in blocks of
whole rows, so the float32 transients stay bounded (the update is
elementwise and the int8 scales are per row, so blocking changes no
value). Weight decay applies to the leaves named in ``decay`` (default:
rank >= 2); a model's trainer passes the leaves the reference decays,
whose stacked layout gives every layer leaf, 1-D norm scales and biases
included, a leading period axis
(``launch.steps.reference_decay``).

Under a mesh each leaf is this rank's shard (``launch.steps.
shard_train_state``) and ``shards`` (``parallel.hints.ShardReductions``)
takes the update's two whole-leaf reductions over the ranks: the grad
norm counts each element once, and an int8 moment's per-row absmax is
maxed over the axis that shards the leaf's last dim.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterable, Optional

import torch

ROW_BLOCK = 1 << 24        # elements of one update block (64 MiB float32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    quantize_moments: bool = False


# ---------------------------------------------------------------------------
# int8 moment container
# ---------------------------------------------------------------------------
def _q8_encode(x: torch.Tensor, row_max=None):
    """float32 -> (int8 q, float32 scale), per-row absmax over the last
    dim (keepdim), passed through ``row_max`` when given (the max over
    the ranks that hold the rest of each row). Divides by tensors (see
    ``optim.compress._q_encode``); ``torch.round`` is half to even, as
    ``jnp.round``."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    if row_max is not None:
        absmax = row_max(absmax)
    scale = torch.clamp(absmax, min=1e-12) / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _q8_decode(q, scale):
    return q.to(torch.float32) * scale


def _encode_moment(x, signed_sqrt: bool, row_max=None):
    if signed_sqrt:
        x = torch.sqrt(torch.clamp(x, min=0.0))
    return _q8_encode(x, row_max)


def _decode_moment(q, scale, signed_sqrt: bool):
    x = _q8_decode(q, scale)
    if signed_sqrt:
        x = x * x
    return x


def _named(params) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters()) if hasattr(
        params, "named_parameters") else dict(params)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """{"step": int32 0, "m": ..., "v": ...}: float32 zeros per leaf, or
    ``{"q": int8, "scale": float32}`` of zeros with int8 moments."""
    params = _named(params)
    dev = next(iter(params.values())).device

    def zero(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if not cfg.quantize_moments:
            return z
        q, s = _q8_encode(z)
        return {"q": q, "scale": s}

    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": {n: zero(p) for n, p in params.items()},
            "v": {n: zero(p) for n, p in params.items()}}


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.to(torch.float32))) for g in grads])))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as (rows, last dim); a 1-D leaf is one row."""
    return t.reshape(1, -1) if t.dim() <= 1 else t.reshape(-1, t.shape[-1])


@torch.no_grad()
def adamw_update(params, grads: Dict[str, Optional[torch.Tensor]],
                 state: dict, lr, cfg: AdamWConfig, *, decay=None,
                 shards=None):
    """One AdamW step, in place. ``grads[name]`` None counts as zeros (a
    leaf no loss term reached). ``lr`` is a float or float32 scalar;
    ``decay`` the set of leaf names that take weight decay (default: rank
    >= 2); ``shards`` the whole-leaf reductions of a sharded state (see
    the module's docstring). Returns (params, state, {"grad_norm",
    "clip"})."""
    params = _named(params)
    dev = next(iter(params.values())).device
    f32 = dict(dtype=torch.float32, device=dev)
    state["step"] = state["step"] + 1
    step = state["step"]
    present = [(n, g) for n, g in grads.items() if g is not None]
    if not present:
        gnorm = torch.zeros((), **f32)
    elif shards is None:
        gnorm = global_norm([g for _, g in present])
    else:
        gnorm = shards.global_norm(*zip(*present))
    clip = torch.clamp(torch.full((), cfg.grad_clip_norm, **f32)
                       / torch.clamp(gnorm, min=1e-12), max=1.0)
    sf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full((), cfg.b1, **f32), sf)
    bc2 = 1.0 - torch.pow(torch.full((), cfg.b2, **f32), sf)
    lr_t = torch.as_tensor(lr, dtype=torch.float32).to(dev)
    for name, p in params.items():
        g = grads.get(name)
        wd = (p.dim() >= 2) if decay is None else (name in decay)
        pr = _rows(p.data)
        gr = None if g is None else _rows(g)
        mc, vc = state["m"][name], state["v"][name]
        row_max = (None if shards is None
                   else functools.partial(shards.row_max, name))
        step_rows = max(1, ROW_BLOCK // pr.shape[1])
        for r0 in range(0, pr.shape[0], step_rows):
            sl = slice(r0, r0 + step_rows)
            gb = (torch.zeros(pr[sl].shape, **f32) if gr is None
                  else gr[sl].to(torch.float32) * clip)
            if cfg.quantize_moments:
                m = _decode_moment(_rows(mc["q"])[sl], _rows(mc["scale"])[sl],
                                   False)
                v = _decode_moment(_rows(vc["q"])[sl], _rows(vc["scale"])[sl],
                                   True)
            else:
                m, v = _rows(mc)[sl], _rows(vc)[sl]
            m = cfg.b1 * m + (1.0 - cfg.b1) * gb
            v = cfg.b2 * v + (1.0 - cfg.b2) * gb * gb
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            pb = pr[sl]
            if wd:
                delta = delta + cfg.weight_decay * pb.to(torch.float32)
            pb.copy_((pb.to(torch.float32) - lr_t * delta).to(p.dtype))
            if cfg.quantize_moments:
                for cont, x, sq in ((mc, m, False), (vc, v, True)):
                    q, s = _encode_moment(x, sq, row_max)
                    _rows(cont["q"])[sl] = q
                    _rows(cont["scale"])[sl] = s
            else:
                _rows(mc)[sl] = m
                _rows(vc)[sl] = v
    return params, state, {"grad_norm": gnorm, "clip": clip}

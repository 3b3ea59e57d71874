"""Plain reference of the training cell: the decoder of ``decoder.py`` (no
bias, no cache) trained in float32 with TF32 off. The paper's fake-quant
is applied as the configuration states it: every matrix of a layer on
the weight grid, the embedding's output and each layer's output on the
data grid, each a straight-through estimator (round half away from zero
forward; the gradient passes where the value lies inside the grid's
range). The loss is the mean token cross-entropy; the optimizer AdamW
(global-norm clipping, bias correction, decoupled weight decay on every
layer leaf and the embedding and head) with both moments stored as int8
per row of the last dim (the second as int8 of its square root), round
half to even. Weights come from ``weights.py``, drawn again from the
seed in float32.

Options for the runs that set a limit's upper reading: ``control="fp8"``
rounds every matmul's operands through float8 e4m3 (weights per output
column, activations per row); ``fault="half_batch"`` takes the loss over
the first half of the rows only.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .decoder import fp8_columns, no_tf32, rmsnorm, rope
from .weights import Dims, make_embed, make_head, make_layer

LAYER_MATS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def fake_quant_ste(x: torch.Tensor, fmt: Optional[Tuple[int, int]]):
    if fmt is None:
        return x
    i, f = fmt
    s = 2.0 ** f
    lo, hi = -2.0 ** (i + f - 1), 2.0 ** (i + f - 1) - 1
    xs = x * s
    q = torch.clamp(torch.trunc(xs + torch.copysign(
        torch.full_like(xs, 0.5), xs)), lo, hi) / s
    inside = (xs >= lo) & (xs <= hi)
    return torch.where(inside, x + (q - x).detach(), q.detach())


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _ste(x, fn):
    return x + (fn(x.detach()) - x).detach()


class RefModel:
    """The reference's float32 leaves, named ``layers.<i>.<leaf>``,
    ``embed``, ``head`` and ``final_norm``."""

    def __init__(self, dims: Dims, seed: int, device):
        self.dims = dims
        p: Dict[str, torch.Tensor] = {}
        for li in range(dims.layers):
            for n, t in make_layer(dims, seed, li, torch.float32,
                                   device).items():
                p[f"layers.{li}.{n}"] = t.clone()
        p["embed"] = make_embed(dims, seed, torch.float32, device)
        p["head"] = make_head(dims, seed, torch.float32, device)
        p["final_norm"] = torch.ones(dims.d_model, device=device)
        for t in p.values():
            t.requires_grad_(True)
        self.params = p

    def decayed(self, name: str) -> bool:
        return name != "final_norm"

    def loss(self, tokens, labels, *, w_fmt, a_fmt, control=None):
        d, p = self.dims, self.params
        mm = ((lambda x, w: _ste(x, _fp8_rows) @ _ste(w, fp8_columns))
              if control == "fp8" else (lambda x, w: x @ w))
        B, S = tokens.shape
        x = fake_quant_ste(p["embed"][tokens.long()], a_fmt)
        pos = torch.arange(S, device=x.device)
        hd = d.head_dim
        mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        for li in range(d.layers):
            w = {n: fake_quant_ste(p[f"layers.{li}.{n}"], w_fmt)
                 for n in LAYER_MATS}
            h = rmsnorm(x, p[f"layers.{li}.norm1"], d.norm_eps)
            q = mm(h, w["wq"]).view(B * S, d.heads, hd)
            k = mm(h, w["wk"]).view(B * S, d.kv_heads, hd)
            v = mm(h, w["wv"]).view(B, S, d.kv_heads, hd)
            q = rope(q, pos.repeat(B), d.rope_theta).view(B, S, d.heads, hd)
            k = rope(k, pos.repeat(B), d.rope_theta).view(B, S, d.kv_heads,
                                                          hd)
            G = d.heads // d.kv_heads
            k = k.repeat_interleave(G, dim=2)
            v = v.repeat_interleave(G, dim=2)
            sc = torch.einsum("bshd,bthd->bhst", q, k) / hd ** 0.5
            sc = sc.masked_fill(~mask, float("-inf"))
            o = torch.einsum("bhst,bthd->bshd", torch.softmax(sc, -1), v)
            x = x + mm(o.reshape(B, S, -1), w["wo"])
            h = rmsnorm(x, p[f"layers.{li}.norm2"], d.norm_eps)
            g = torch.nn.functional.silu(mm(h, w["w_gate"])) * mm(h,
                                                                  w["w_up"])
            x = fake_quant_ste(x + mm(g, w["w_down"]), a_fmt)
        h = rmsnorm(x, p["final_norm"], d.norm_eps)
        logits = mm(h, p["head"])
        return torch.nn.functional.cross_entropy(
            logits.reshape(B * S, -1), labels.reshape(-1).long(),
            ignore_index=-100)


def _q8(x: torch.Tensor):
    rows = x.reshape(1, -1) if x.dim() <= 1 else x.reshape(-1, x.shape[-1])
    scale = torch.clamp(rows.abs().amax(dim=-1, keepdim=True),
                        min=1e-12) / 127.0
    q = torch.clamp(torch.round(rows / scale), -127, 127)
    return q, scale


def _dq8(q, scale, shape):
    return (q * scale).reshape(shape)


@torch.no_grad()
def adamw_int8(params: Dict[str, torch.Tensor], state: dict, lr: float, *,
               b1: float, b2: float, eps: float, wd: float, clip_norm: float,
               decayed) -> None:
    """One AdamW step with int8 moments, in place."""
    state["t"] += 1
    t = state["t"]
    gn = torch.sqrt(sum(torch.sum(p.grad * p.grad)
                        for p in params.values()))
    clip = torch.clamp(clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    for n, p in params.items():
        g = p.grad * clip
        if n in state["m"]:
            m = _dq8(*state["m"][n], p.shape)
            v = _dq8(*state["v"][n], p.shape) ** 2
        else:
            m = torch.zeros_like(p)
            v = torch.zeros_like(p)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if decayed(n):
            delta = delta + wd * p
        p -= lr * delta
        state["m"][n] = _q8(m)
        state["v"][n] = _q8(torch.sqrt(torch.clamp(v, min=0.0)))


def moment_grad_norms(state: dict, shapes: Dict[str, tuple],
                      b1: float) -> Dict[str, float]:
    """Each leaf's first gradient as the optimizer took it (clipped),
    worked out from the first moment after one step: m / (1 - b1)."""
    return {n: float(torch.linalg.vector_norm(
        _dq8(*state["m"][n], shapes[n]))) / (1.0 - b1) for n in shapes}


def train_reference(dims: Dims, seed: int, batches: Sequence[dict],
                    lrs: Sequence[float], *, w_fmt, a_fmt, adam: dict,
                    device, control: Optional[str] = None,
                    fault: Optional[str] = None) -> dict:
    """Len(batches) reference steps. Returns the losses, each leaf's first
    gradient (from the state after step 1, and straight from autograd),
    and each leaf's change after the last step."""
    no_tf32()
    model = RefModel(dims, seed, device)
    p0 = {n: t.detach().clone() for n, t in model.params.items()}
    state = {"t": 0, "m": {}, "v": {}}
    losses: List[float] = []
    g1 = g1_raw = None
    for i, (batch, lr) in enumerate(zip(batches, lrs)):
        tok, lab = batch["tokens"], batch["labels"]
        if fault == "half_batch":
            tok, lab = tok[: tok.shape[0] // 2], lab[: lab.shape[0] // 2]
        for t in model.params.values():
            t.grad = None
        loss = model.loss(tok, lab, w_fmt=w_fmt, a_fmt=a_fmt,
                          control=control)
        loss.backward()
        losses.append(float(loss.detach()))
        if i == 0:
            g1_raw = {n: float(torch.linalg.vector_norm(t.grad))
                      for n, t in model.params.items()}
        adamw_int8(model.params, state, lr, decayed=model.decayed, **adam)
        if i == 0:
            g1 = moment_grad_norms(
                state, {n: t.shape for n, t in model.params.items()},
                adam["b1"])
    change = {n: float(torch.linalg.vector_norm(t.detach() - p0[n]))
              for n, t in model.params.items()}
    return {"losses": losses, "g1": g1, "g1_raw": g1_raw, "change": change}

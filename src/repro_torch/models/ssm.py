"""Recurrent mixers: Mamba (Jamba's SSM) and xLSTM (mLSTM and sLSTM), the
reference's ``repro.models.ssm`` on torch tensors.

* Mamba is the chunked SSD form (Mamba-2 style, one scalar decay per
  head): within a chunk an attention-like product masked below the
  diagonal, across chunks a recurrence over the (B, nh, N, P) state.
* The mLSTM is the same chunked machinery (gated linear attention with a
  normalizer, which rides as the ``hd + 1``-th column of the memory).
* The sLSTM is an exact loop over time.

A sequence of S tokens runs as chunks of ``Lc = min(cfg.ssm_chunk, S)``;
S must be a multiple of Lc. The recurrent states are float32 whatever the
compute dtype (Mamba's conv window is in the compute dtype). Masks go in
the exponent, before ``exp``. ``state_quant`` = (I, F) puts the Mamba and
mLSTM states on the Q(I,F) grid at every chunk boundary (the paper's
"data" applied to a recurrent state), rounding half to even as
``jnp.round``, with a straight-through gradient under autograd; the
sLSTM's states stay float, as in the reference. An
apply returns new state tensors and never writes the state it is given
(the server keeps the states of slots it is not prefilling by that).

Parameters live in small modules (:class:`Mamba`, :class:`MLSTM`,
:class:`SLSTM`), projections in the compute dtype and the reference's
float32 leaves (decays, biases, norm scales, the sLSTM's recurrent
weight, which it reads in float32) in float32. The reference's ``constrain``
sharding hint is a no-op without a mesh and has no counterpart here.

Under a tensor-parallel plan (``parallel.hints``) a mixer runs whole on
every rank, on whole activations: the reference's column shards of
``in_proj``, ``up_proj``, ``w_in`` and the mLSTM's ``wq``/``wk``/``wv``
cut across fused outputs ([x, z, B, C, dt]; [x, z]; the i, f, z, o
gates), not along heads, so their products are gathered whole; the
conv, the sLSTM's ``r`` and every per-layer 1-D leaf are gathered whole;
the recurrent states (replicated in the pool) stay whole; and the
row-parallel output projection takes this rank's piece of the mixer's
output, its partial product summed by the block (``reduce_rows``).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.fixedpoint import format_params
from ..parallel.hints import full, gather_cols, row_piece
from .common import dense_init_, frozen, rmsnorm

State = Dict[str, torch.Tensor]

SLSTM_M0 = -1e30          # the sLSTM stabilizer's initial value


def _state_grid(x: torch.Tensor, quant: Tuple[int, int]) -> torch.Tensor:
    """``x`` on the Q(I,F) grid of ``quant``, rounding half to even
    (``torch.round``, as the reference's ``jnp.round``) and clipping, in
    float32; returned in x's dtype."""
    scale, qmin, qmax = format_params(*quant)
    q = torch.clamp(torch.round(x.to(torch.float32) * scale), qmin, qmax)
    return (q / scale).to(x.dtype)


class _StateGridSTE(torch.autograd.Function):
    """Straight-through state grid: the forward is :func:`_state_grid`;
    the gradient passes unchanged where ``x * 2^F`` lies inside the grid's
    range and is 0 where it clips (``core.fixedpoint.fake_quant_ste``'s
    rule)."""

    @staticmethod
    def forward(ctx, x, quant):
        scale, qmin, qmax = format_params(*quant)
        s = x.to(torch.float32) * scale
        ctx.save_for_backward((s >= qmin) & (s <= qmax))
        return _state_grid(x, quant)

    @staticmethod
    def backward(ctx, g):
        (in_range,) = ctx.saved_tensors
        return torch.where(in_range, g, torch.zeros_like(g)), None


def _maybe_fake_quant(x: torch.Tensor,
                      quant: Optional[Tuple[int, int]]) -> torch.Tensor:
    """``x`` on the Q(I,F) grid of ``quant`` (None: unchanged), as
    :func:`_state_grid`. Under autograd the grid is straight-through
    (:class:`_StateGridSTE`): its values are the same bit for bit, and the
    gradient reaches the state before the boundary. (The reference rounds
    with ``jnp.round``, whose derivative is 0, so its gradient stops at
    every chunk boundary under a KV format: ROADMAP C8.)"""
    if quant is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _StateGridSTE.apply(x, quant)
    return _state_grid(x, quant)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)``, exact at every x as ``jax.nn.softplus``
    (``F.softplus`` switches to ``x`` above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -_softplus(-x)


def _silu32(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x.to(torch.float32))


def _chunks(t: torch.Tensor, nc: int, Lc: int) -> torch.Tensor:
    """(B, S, ...) -> (nc, B, Lc, ...)."""
    B = t.shape[0]
    return t.reshape(B, nc, Lc, *t.shape[2:]).movedim(1, 0)


def _chunk_len(cfg, S: int, what: str) -> Tuple[int, int]:
    Lc = min(cfg.ssm_chunk, S)
    if S % Lc:
        raise ValueError(f"seq {S} not divisible by {what} {Lc}")
    return Lc, S // Lc


def _lower_tri(Lc: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=device))


# ---------------------------------------------------------------------------
# Mamba (SSD / Mamba-2 style, ngroups = 1)
# ---------------------------------------------------------------------------
class Mamba(nn.Module):
    """``in_proj`` (D, 2 di + 2 N + nh) emits [x, z, B, C, dt]; the
    depthwise causal conv ``conv_w`` (k, di) and ``conv_b``; per-head
    ``A_log``, ``dt_bias`` and ``D_skip``; the gated norm's ``norm``;
    ``out_proj`` (di, D)."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        D = cfg.d_model
        di = cfg.ssm_expand * D
        nh = di // cfg.ssm_head_dim
        N = cfg.ssm_state_dim
        mk = lambda *shape, dt=dtype: frozen(torch.empty(  # noqa: E731
            shape, dtype=dt, device=device))
        f32 = torch.float32
        self.in_proj = mk(D, 2 * di + 2 * N + nh)
        self.conv_w = mk(cfg.ssm_conv_dim, di)
        self.conv_b = mk(di)
        self.A_log = mk(nh, dt=f32)
        self.dt_bias = mk(nh, dt=f32)
        self.D_skip = mk(nh, dt=f32)
        self.norm = mk(di, dt=f32)
        self.out_proj = mk(di, D)


def init_mamba(p: Mamba, g: torch.Generator) -> None:
    """The reference's init: fan-in truncated normals (the conv at std
    0.5, ``out_proj`` at 1/sqrt(di)), a zero conv bias, ``A_log`` =
    log(linspace(1, nh)), zero ``dt_bias``, unit ``D_skip`` and norm."""
    nh = p.A_log.shape[0]
    dense_init_(p.in_proj, g)
    dense_init_(p.conv_w, g, scale=0.5)
    p.conv_b.zero_()
    p.A_log.copy_(torch.log(torch.linspace(1.0, float(nh), nh,
                                           dtype=torch.float32)))
    p.dt_bias.zero_()
    p.D_skip.fill_(1.0)
    p.norm.fill_(1.0)
    dense_init_(p.out_proj, g, scale=1.0 / np.sqrt(p.out_proj.shape[0]))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time, as ``k`` shifted adds. x: (B, S,
    di); w: (k, di); ``state``: the (B, k - 1, di) trailing inputs of the
    previous segment (None: zeros). Returns (y, new state)."""
    B, S, di = x.shape
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((B, k - 1, di))
    xx = torch.cat([state.to(x.dtype), x], dim=1)      # (B, S + k - 1, di)
    y = x.new_zeros((B, S, di))
    for i in range(k):
        y = y + xx[:, i:i + S, :] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    return y, (xx[:, S:, :] if k > 1 else state)


def mamba_apply(p, u: torch.Tensor, *, cfg, state: Optional[State] = None,
                state_quant: Optional[Tuple[int, int]] = None):
    """u: (B, S, D); ``state``: None (from zero) or {"conv": (B, k-1, di),
    "ssm": (B, nh, N, P)}. Returns (y, new state)."""
    B, S, D = u.shape
    cd = u.dtype
    f32 = torch.float32
    di = cfg.ssm_expand * D
    P = cfg.ssm_head_dim
    nh = di // P
    N = cfg.ssm_state_dim
    proj = gather_cols(u @ p.in_proj.to(cd), p.in_proj)
    x, z, Bm, Cm, dt = torch.split(proj, [di, di, N, N, nh], dim=-1)
    x, new_conv = _causal_conv(x, full(p.conv_w), full(p.conv_b),
                               None if state is None else state["conv"])
    x = _silu32(x)
    Bm, Cm = Bm.to(f32), Cm.to(f32)                    # (B, S, N)
    dt = _softplus(dt.to(f32) + full(p.dt_bias))       # (B, S, nh)
    A = -torch.exp(full(p.A_log))                      # (nh,)
    xh = x.reshape(B, S, nh, P)
    h = (state["ssm"].to(f32) if state is not None
         else u.new_zeros((B, nh, N, P), dtype=f32))
    Lc, nc = _chunk_len(cfg, S, "ssm chunk")
    tri = _lower_tri(Lc, u.device)[None, :, :, None]
    ys = []
    for xj, Bj, Cj, dtj in zip(_chunks(xh, nc, Lc), _chunks(Bm, nc, Lc),
                               _chunks(Cm, nc, Lc), _chunks(dt, nc, Lc)):
        a = dtj * A                                    # (B, Lc, nh) log decay
        Sa = torch.cumsum(a, dim=1)
        # intra-chunk: W[t, s] = exp(Sa_t - Sa_s) (C_t . B_s), s <= t
        G = torch.einsum("btn,bsn->bts", Cj, Bj)
        Mlog = Sa[:, :, None, :] - Sa[:, None, :, :]   # (B, Lc, Lc, nh)
        Mlog = torch.where(tri, Mlog, -torch.inf)
        W = torch.exp(Mlog) * G[..., None]
        xdt = xj * dtj[..., None]                      # (B, Lc, nh, P)
        y_intra = torch.einsum("btsh,bshp->bthp", W, xdt)
        # inter-chunk: C_t exp(Sa_t) h
        hC = torch.einsum("btn,bhnp->bthp", Cj, h)
        y_inter = hC * torch.exp(Sa)[..., None]
        # carry: h' = exp(sum a) h + sum_s exp(Sa_last - Sa_s) dt B x
        decay_all = torch.exp(Sa[:, -1, :])            # (B, nh)
        w_s = torch.exp(Sa[:, -1:, :] - Sa)            # (B, Lc, nh)
        dh = torch.einsum("bsn,bshp->bhnp", Bj, xdt * w_s[..., None])
        h = _maybe_fake_quant(h * decay_all[:, :, None, None] + dh,
                              state_quant)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(B, S, nh, P)
    y = y + xh * full(p.D_skip)[None, None, :, None]
    y = rmsnorm(full(p.norm), y.reshape(B, S, di).to(cd), cfg.norm_eps)
    y = y * _silu32(z).to(cd)
    y = row_piece(y, p.out_proj) @ p.out_proj.to(cd)
    return y, {"conv": new_conv, "ssm": h}


def init_mamba_state(batch: int, cfg, dtype, device) -> State:
    """Zero states: the conv window in ``dtype``, the SSM state float32."""
    D = cfg.d_model
    di = cfg.ssm_expand * D
    nh = di // cfg.ssm_head_dim
    return {"conv": torch.zeros((batch, cfg.ssm_conv_dim - 1, di),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, nh, cfg.ssm_state_dim,
                                cfg.ssm_head_dim), dtype=torch.float32,
                               device=device)}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (chunked matrix memory) and sLSTM (sequential scalar memory)
# ---------------------------------------------------------------------------
class MLSTM(nn.Module):
    """``up_proj`` (D, 2 di) emits [x, z]; ``wq``/``wk``/``wv`` (di, di);
    the gate projections ``w_i``/``w_f`` (di, nh); ``f_bias``; ``norm``;
    ``down_proj`` (di, D)."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        D = cfg.d_model
        di = cfg.ssm_expand * D
        nh = cfg.num_heads
        mk = lambda *shape, dt=dtype: frozen(torch.empty(  # noqa: E731
            shape, dtype=dt, device=device))
        self.up_proj = mk(D, 2 * di)
        self.wq = mk(di, di)
        self.wk = mk(di, di)
        self.wv = mk(di, di)
        self.w_i = mk(di, nh)
        self.w_f = mk(di, nh)
        self.f_bias = mk(nh, dt=torch.float32)
        self.norm = mk(di, dt=torch.float32)
        self.down_proj = mk(di, D)


def init_mlstm(p: MLSTM, g: torch.Generator) -> None:
    """The reference's init: fan-in truncated normals (gates at std 0.02,
    ``down_proj`` at 1/sqrt(di)), forget biases at 3 (open gates), a unit
    norm."""
    dense_init_(p.up_proj, g)
    for w in (p.wq, p.wk, p.wv):
        dense_init_(w, g)
    dense_init_(p.w_i, g, scale=0.02)
    dense_init_(p.w_f, g, scale=0.02)
    p.f_bias.fill_(3.0)
    p.norm.fill_(1.0)
    dense_init_(p.down_proj, g, scale=1.0 / np.sqrt(p.down_proj.shape[0]))


def mlstm_apply(p, u: torch.Tensor, *, cfg, state: Optional[State] = None,
                state_quant: Optional[Tuple[int, int]] = None):
    """Chunked mLSTM. ``state``: None (from zero) or {"C": (B, nh, hd,
    hd + 1), "m": (B, nh)}, the matrix memory with the normalizer as its
    last column and the running stabilizer. Returns (y, new state)."""
    B, S, D = u.shape
    cd = u.dtype
    f32 = torch.float32
    di = cfg.ssm_expand * D
    nh = cfg.num_heads
    hd = di // nh
    x, z = torch.chunk(gather_cols(u @ p.up_proj.to(cd), p.up_proj), 2,
                       dim=-1)
    q, k, v = (gather_cols(x @ w.to(cd), w).reshape(B, S, nh, hd)
               for w in (p.wq, p.wk, p.wv))
    # log-space gates: log f in (-inf, 0], log i unconstrained
    logf = _log_sigmoid((x @ p.w_f.to(cd)).to(f32) + full(p.f_bias))
    logi = (x @ p.w_i.to(cd)).to(f32)                  # (B, S, nh)
    qf = q.to(f32) / np.sqrt(hd)
    kf = k.to(f32)
    # v with a column of ones carries the normalizer through the memory
    vf = torch.cat([v.to(f32), u.new_ones((B, S, nh, 1), dtype=f32)], -1)
    if state is None:
        C = u.new_zeros((B, nh, hd, hd + 1), dtype=f32)
        m = u.new_zeros((B, nh), dtype=f32)
    else:
        C, m = state["C"].to(f32), state["m"]
    Lc, nc = _chunk_len(cfg, S, "chunk")
    tri = _lower_tri(Lc, u.device)[None, :, :, None]
    ys = []
    for qj, kj, vj, lfj, lij in zip(*(_chunks(t, nc, Lc)
                                      for t in (qf, kf, vf, logf, logi))):
        Sa = torch.cumsum(lfj, dim=1)                  # (B, Lc, nh)
        # intra weights exp(Sa_t - Sa_s + li_s), masked in the exponent
        Wlog = Sa[:, :, None, :] - Sa[:, None, :, :] + lij[:, None, :, :]
        Wlog = torch.where(tri, Wlog, -torch.inf)
        inter_log = Sa + m[:, None, :]                 # carry weights
        m_t = torch.maximum(Wlog.amax(dim=2), inter_log)   # stabilizer
        Wn = torch.exp(Wlog - m_t[:, :, None, :])
        G = torch.einsum("bthd,bshd->bhts", qj, kj)    # (B, nh, Lc, Lc)
        GW = G * Wn.movedim(3, 1)
        y_intra = torch.einsum("bhts,bshp->bthp", GW, vj)
        inter_w = torch.exp(inter_log - m_t)           # (B, Lc, nh)
        y_inter = torch.einsum("bthd,bhdp->bthp", qj * inter_w[..., None], C)
        ys.append(y_intra + y_inter)                   # (B, Lc, nh, hd + 1)
        # chunk-final memory, restabilized to m_last
        m_last = m_t[:, -1, :]
        decay = torch.exp(Sa[:, -1:, :] + m[:, None, :]
                          - m_last[:, None, :])[:, 0]
        w_s = torch.exp(Sa[:, -1:, :] - Sa + lij - m_last[:, None, :])
        dC = torch.einsum("bshd,bshp->bhdp", kj * w_s[..., None], vj)
        C = _maybe_fake_quant(C * decay[:, :, None, None] + dC, state_quant)
        m = m_last
    y = torch.stack(ys, 1).reshape(B, S, nh, hd + 1)
    num, den = y[..., :hd], y[..., hd:]
    h = num / torch.clamp(torch.abs(den), min=1.0)
    h = rmsnorm(full(p.norm), h.reshape(B, S, di).to(cd), cfg.norm_eps)
    h = h * _silu32(z).to(cd)
    h = row_piece(h, p.down_proj) @ p.down_proj.to(cd)
    return h, {"C": C, "m": m}


def init_mlstm_state(batch: int, cfg, dtype, device) -> State:
    """A zero memory and a zero stabilizer, float32."""
    di = cfg.ssm_expand * cfg.d_model
    nh = cfg.num_heads
    hd = di // nh
    return {"C": torch.zeros((batch, nh, hd, hd + 1), dtype=torch.float32,
                             device=device),
            "m": torch.zeros((batch, nh), dtype=torch.float32,
                             device=device)}


class SLSTM(nn.Module):
    """``w_in`` (D, 4D) emits the i, f, z, o pre-activations; the
    head-wise recurrent weight ``r`` (nh, hd, 4 hd), float32 as the
    reference reads it; ``b`` (4D); ``norm``; ``out_proj`` (D, D)."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        D = cfg.d_model
        nh = cfg.num_heads
        hd = D // nh
        mk = lambda *shape, dt=dtype: frozen(torch.empty(  # noqa: E731
            shape, dtype=dt, device=device))
        f32 = torch.float32
        self.w_in = mk(D, 4 * D)
        self.r = mk(nh, hd, 4 * hd, dt=f32)
        self.b = mk(4 * D, dt=f32)
        self.norm = mk(D, dt=f32)
        self.out_proj = mk(D, D)


def init_slstm(p: SLSTM, g: torch.Generator) -> None:
    """The reference's init: fan-in truncated normals (``r`` at
    1/sqrt(hd), ``out_proj`` at 1/sqrt(D)), zero biases, a unit norm."""
    dense_init_(p.w_in, g)
    dense_init_(p.r, g, scale=1.0 / np.sqrt(p.r.shape[1]))
    p.b.zero_()
    p.norm.fill_(1.0)
    dense_init_(p.out_proj, g, scale=1.0 / np.sqrt(p.out_proj.shape[0]))


def slstm_apply(p, u: torch.Tensor, *, cfg, state: Optional[State] = None,
                state_quant: Optional[Tuple[int, int]] = None):
    """Sequential sLSTM (exact loop over time). ``state``: None (zeros,
    the stabilizer ``m`` at -1e30) or {"h", "c", "n", "m"}, each (B, nh,
    hd). ``state_quant`` is accepted and unused: the reference's sLSTM
    keeps its states float. Returns (y, new state)."""
    del state_quant
    B, S, D = u.shape
    cd = u.dtype
    f32 = torch.float32
    nh = cfg.num_heads
    hd = D // nh
    pre = ((gather_cols(u @ p.w_in.to(cd), p.w_in)).to(f32)
           + full(p.b)).reshape(B, S, 4, nh, hd)
    if state is None:
        state = init_slstm_state(B, cfg, cd, u.device)
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    r = full(p.r).to(f32)
    hs = []
    for t in range(S):
        x_t = pre[:, t]
        rec = torch.einsum("bnh,nhk->bnk", h, r).reshape(B, nh, 4, hd)
        zi = x_t[:, 0] + rec[:, :, 0]
        zf = x_t[:, 1] + rec[:, :, 1]
        zz = x_t[:, 2] + rec[:, :, 2]
        zo = x_t[:, 3] + rec[:, :, 3]
        # exponential gating with a stabilizer (xLSTM eq. 15-17)
        log_i, log_f = zi, _log_sigmoid(zf)
        m_new = torch.maximum(log_f + m, log_i)
        i_g = torch.exp(log_i - m_new)
        f_g = torch.exp(log_f + m - m_new)
        c = f_g * c + i_g * torch.tanh(zz)
        n = f_g * n + i_g
        h = torch.sigmoid(zo) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, 1).reshape(B, S, D).to(cd)
    y = rmsnorm(full(p.norm), y, cfg.norm_eps)
    y = row_piece(y, p.out_proj) @ p.out_proj.to(cd)
    return y, {"h": h, "c": c, "n": n, "m": m}


def init_slstm_state(batch: int, cfg, dtype, device) -> State:
    """Zero h, c, n and the stabilizer ``m`` at -1e30, float32."""
    nh = cfg.num_heads
    hd = cfg.d_model // nh
    z = lambda: torch.zeros((batch, nh, hd), dtype=torch.float32,  # noqa
                            device=device)
    return {"h": z(), "c": z(), "n": z(),
            "m": torch.full((batch, nh, hd), SLSTM_M0, dtype=torch.float32,
                            device=device)}


class Mixer(NamedTuple):
    """A recurrent layer kind's parameter module, its init, its apply and
    its initial state."""

    module: type
    init: Callable
    apply: Callable
    init_state: Callable


MIXERS = {"mamba": Mixer(Mamba, init_mamba, mamba_apply, init_mamba_state),
          "mlstm": Mixer(MLSTM, init_mlstm, mlstm_apply, init_mlstm_state),
          "slstm": Mixer(SLSTM, init_slstm, slstm_apply, init_slstm_state)}

"""The LM precision bench (the reference's ``benchmarks/lm_precision.py``):
the paper's per-layer precision machinery applied to a transformer LM
trained on the synthetic Markov corpus, and the serving side: token
agreement between two decode runs of the same requests, the accuracy gate
a reduced-precision run must pass against its reference, and the
decode-step wrappers that teacher-force one run by another's tokens on the
card.

``train_small_lm`` trains a reduced LM with AdamW; ``lm_topk_accuracy`` is
its held-out next-token top-1 (the LM analogue of the paper's
classification top-1); ``run`` descends per-layer weight and data bits
with the greedy search, the transformer traffic model pricing decode
traffic, and writes ``results/torch_lm_precision.json``.
``decode_agreement`` and ``accuracy_gate`` are the reference's, with its
defaults.

Why teacher forcing: at random init two equal bf16 runs on a card agree
only ~0.7 free-running, because one early flip of a near-tie derails the
rest of a request. :class:`DecodeTap` (the separate decode step) and
:class:`FusedTap` (the fused step) feed a run the reference run's token
g - 1 at its generation step g > 0, so both decode on identical inputs
and their choices compare step by step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..configs.registry import get_smoke_config
from ..core.fixedpoint import FixedPointFormat
from ..core.policy import PrecisionPolicy
from ..core.search import greedy_pareto_search
from ..data.lm import LMDataConfig, lm_batch, lm_eval_stream
from ..launch.steps import reference_decay
from ..models.transformer import forward, init_model, train_loss
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..quant.apply import (build_model_quant, transformer_layer_names,
                           transformer_traffic_model)
from .common import save_json


def _on(batch: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in batch.items()}


def train_small_lm(cfg, dcfg, steps=300, lr=1e-3, verbose=True, *,
                   device="cuda", model=None):
    """AdamW (weight decay 0.01) on ``lm_batch(dcfg, i)`` for ``steps``
    steps from a random trainable model of seed 0 (or ``model``, trained
    in place). Returns the model."""
    dev = resolve_device(device)
    if model is None:
        model = init_model(cfg, seed=0, device=dev, trainable=True)
    acfg = AdamWConfig(weight_decay=0.01)
    state = adamw_init(model, acfg)
    decay = reference_decay(model, cfg)
    params = dict(model.named_parameters())
    for i in range(steps):
        for p in params.values():
            p.grad = None
        loss, _ = train_loss(model, _on(lm_batch(dcfg, i), dev), cfg)
        loss.backward()
        adamw_update(params, {n: p.grad for n, p in params.items()}, state,
                     lr, acfg, decay=decay)
        if verbose and i % 100 == 0:
            print(f"  [lm] step {i} loss {float(loss.detach()):.4f}")
    for p in params.values():
        p.grad = None
    return model


@torch.no_grad()
def lm_topk_accuracy(model, cfg, dcfg, quant=None, batches=2):
    """Held-out next-token top-1 over ``batches`` eval batches (the last
    position, whose label is -100, left out)."""
    hits = tot = 0
    for b in lm_eval_stream(dcfg, batches):
        b = _on(b, model.device)
        _, logits, _, _ = forward(model, b["tokens"], cfg, quant=quant)
        pred = torch.argmax(logits[:, :-1], dim=-1)
        lab = b["labels"][:, :-1]
        hits += int(torch.sum(pred == lab))
        tot += lab.numel()
    return hits / tot


def run(*, verbose=True, arch="deepseek-7b", steps=200, device="cuda"):
    """Train the reduced LM (``arch``'s smoke config cut to 4 layers,
    float32), then the greedy per-layer search over weight-fraction, data
    integer and data-fraction bits against its top-1, decode traffic
    priced at batch 16 x 2048; results to
    ``results/torch_lm_precision.json``."""
    cfg = dataclasses.replace(get_smoke_config(arch), num_layers=4,
                              dtype="float32")
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=96, batch_size=12,
                        num_mixtures=2, branching=8, seed=11)
    if verbose:
        print(f"[lm_precision] training reduced {arch} LM "
              f"({cfg.num_layers}L d={cfg.d_model})")
    model = train_small_lm(cfg, dcfg, steps=steps, verbose=verbose,
                           device=device)
    base = lm_topk_accuracy(model, cfg, dcfg)
    if verbose:
        print(f"  baseline next-token top-1: {base:.4f}")

    names = transformer_layer_names(cfg)
    init = PrecisionPolicy.uniform(names, FixedPointFormat(2, 10),
                                   FixedPointFormat(6, 6))
    tm = transformer_traffic_model(cfg, batch=16, seq_len=2048, mode="decode")

    def eval_fn(policy):
        quant = build_model_quant(policy, cfg, quantize_kv=False)
        return lm_topk_accuracy(model, cfg, dcfg, quant=quant, batches=1)

    res = greedy_pareto_search(eval_fn, tm, init, baseline_accuracy=base,
                               fields=("weight_frac", "data_int",
                                       "data_frac"),
                               max_steps=16, stop_rel_acc=0.15)
    out = {"arch": arch, "baseline_topk1": base,
           "evaluations": res.evaluations, "tolerances": {}}
    for t in (0.01, 0.02, 0.05, 0.10):
        p = res.select(t)
        if p:
            out["tolerances"][f"{t:.0%}"] = {
                "traffic_ratio": p.traffic_ratio, "accuracy": p.accuracy,
                "policy": p.policy.short()}
            if verbose:
                print(f"  tol={t:.0%} TR={p.traffic_ratio:.3f} "
                      f"acc={p.accuracy:.4f}")
    # per-layer variance in the chosen config (the paper's key result,
    # on a transformer)
    p1 = res.select(0.05)
    if p1:
        wbits = [lp.weight.total_bits for lp in p1.policy.layers if lp.weight]
        out["weight_bits_spread"] = max(wbits) - min(wbits) if wbits else 0
    save_json("lm_precision.json", out)
    return out


def decode_agreement(ref_outs, test_outs):
    """Token agreement between two decode runs of the SAME requests
    (parallel lists of generated-token sequences): per-request agreement
    over the common length, and the token-weighted overall rate."""
    per_request, hits, total = [], 0, 0
    for ref, test in zip(ref_outs, test_outs):
        ref, test = np.asarray(ref), np.asarray(test)
        n = min(len(ref), len(test))
        h = int(np.sum(ref[:n] == test[:n]))
        per_request.append(h / max(n, 1))
        hits += h
        total += n
    return {"overall": hits / max(total, 1), "per_request": per_request}


def accuracy_gate(ref_outs, test_outs, *, min_agreement=0.9,
                  request_floor=0.5, allowed_below_floor=0.0):
    """Gate a decode run against its reference: overall agreement must
    reach ``min_agreement`` AND at most an ``allowed_below_floor`` fraction
    of requests may fall below ``request_floor`` (near-uniform logits of a
    random-init model can flip an argmax tie and derail one short request
    entirely; a systematic failure still trips the overall floor).
    Returns the agreement stats with a ``violations`` count, 0 = passed."""
    agg = decode_agreement(ref_outs, test_outs)
    below = sum(1 for a in agg["per_request"] if a < request_floor)
    allowance = int(allowed_below_floor * len(agg["per_request"]))
    violations = max(0, below - allowance)
    if agg["overall"] < min_agreement:
        violations += 1
    return {"agreement": agg["overall"],
            "per_request": agg["per_request"],
            "min_agreement": min_agreement,
            "request_floor": request_floor,
            "below_floor": below,
            "allowed_below_floor": allowance,
            "violations": violations,
            "passed": violations == 0}


class DecodeTap:
    """Wraps a server's decode step: records each live request's logits at
    each generation step and, given ``forced`` (rid -> a reference run's
    tokens), feeds request rid the reference's token g - 1 at its step
    g > 0 in place of its own (teacher forcing). Two routes then decode on
    identical inputs, so their choices and logits compare step by step and
    one early flip of a near-tie cannot derail the rest of a request.
    ``record=False`` keeps no logits."""

    def __init__(self, srv, forced=None, record=True):
        self.srv, self.fn, self.forced = srv, srv.decode, forced
        self.record = record
        self.logits = {}            # (rid, step) -> (V,) logits

    def __call__(self, model, tokens, pos, caches, page_table):
        srv = self.srv
        live = [(i, r) for i, r in enumerate(srv.slots) if r is not None]
        if self.forced is not None:
            idx = [i for i, _ in live if srv.slot_gen[i] > 0]
            if idx:
                tokens = tokens.clone()
                tokens[idx] = torch.tensor(
                    [self.forced[srv.slots[i].rid][srv.slot_gen[i] - 1]
                     for i in idx], dtype=tokens.dtype, device=tokens.device)
        nxt, logits, caches = self.fn(model, tokens, pos, caches, page_table)
        if self.record:
            for i, r in live:
                self.logits[(r.rid, srv.slot_gen[i])] = logits[i]
        return nxt, logits, caches


class FusedTap:
    """:class:`DecodeTap` for the fused step (``fused="on"``): its decode
    rows are the live slots whose prompt is consumed (a prefilling slot
    still has prompt tokens to feed). It forces their tokens as
    :class:`DecodeTap` does and records each one's logits: row i's in the
    steady state (every row emits), the k-th emitted row's in an admission
    round."""

    def __init__(self, srv, forced=None, record=True):
        self.srv, self.fn, self.forced = srv, srv._fused, forced
        self.record = record
        self.logits = {}

    def __call__(self, model, tokens, start, valid, caches, page_table,
                 emit):
        srv = self.srv
        dec = [(i, r) for i, r in enumerate(srv.slots) if r is not None
               and srv.pos[i] >= len(r.prompt) - 1]
        if self.forced is not None:
            idx = [i for i, _ in dec if srv.slot_gen[i] > 0]
            if idx:
                tokens = tokens.clone()
                tokens[idx, 0] = torch.tensor(
                    [self.forced[srv.slots[i].rid][srv.slot_gen[i] - 1]
                     for i in idx], dtype=tokens.dtype, device=tokens.device)
        nxt, logits, caches = self.fn(model, tokens, start, valid, caches,
                                      page_table, emit)
        steady = emit is srv._arange_dev
        for k, (i, r) in enumerate(dec if self.record else ()):
            self.logits[(r.rid, srv.slot_gen[i])] = logits[i if steady
                                                           else k]
        return nxt, logits, caches


def teacher_force(srv, forced):
    """Wrap ``srv``'s decode step (or its fused step) so every request is
    fed ``forced[rid]``'s tokens after its first (see module docstring).
    Returns the tap."""
    if srv.fused:
        srv._fused = tap = FusedTap(srv, forced, record=False)
    else:
        srv.decode = tap = DecodeTap(srv, forced, record=False)
    return tap

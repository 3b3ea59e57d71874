"""The serving side of the LM precision bench: token agreement between two
decode runs of the same requests, the accuracy gate a reduced-precision
run must pass against its reference, and the decode-step wrappers that
teacher-force one run by another's tokens on the card.

``decode_agreement`` and ``accuracy_gate`` are the reference's
(``benchmarks/lm_precision.py``), with its defaults. The LM training and
the per-layer search on it (``train_small_lm``, ``lm_topk_accuracy``,
``run``) belong to the training slice and are not ported yet (ROADMAP
queue A item 12).

Why teacher forcing: at random init two equal bf16 runs on a card agree
only ~0.7 free-running, because one early flip of a near-tie derails the
rest of a request. :class:`DecodeTap` (the separate decode step) and
:class:`FusedTap` (the fused step) feed a run the reference run's token
g - 1 at its generation step g > 0, so both decode on identical inputs
and their choices compare step by step.
"""
from __future__ import annotations

import numpy as np
import torch


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

"""Synthetic LM corpus: a mixture of order-2 Markov chains over the vocab
(the reference's ``data/lm.py``).

Each mixture has a hash-based sparse successor set per (prev, cur) state
and a Dirichlet distribution over its ``branching`` candidates, so a model
has a real, learnable next-token signal. A batch is a pure function of
(config, step): that makes the data pipeline checkpointable by its step
alone.

The tables are the reference's exactly (``numpy.default_rng(seed)``), and
so is the successor hash, including its int32 wraparound: the reference
asks for int64 but runs with JAX's 64-bit mode off, where the hash
multiplies and adds in int32 and wraps, then takes a floor-mod by
2^31 - 1. The random draws (mixture, first two tokens, branch choices)
come from a ``torch.Generator`` seeded from (seed, step); JAX's
``jax.random`` stream cannot be reproduced here, so the token stream
differs from the reference's while every transition lies in the same
successor sets.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_P = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    num_mixtures: int = 4
    branching: int = 32     # candidate next-tokens per (prev, cur) state
    seed: int = 1234


def _tables(cfg: LMDataConfig):
    """Per-mixture hash constants ``a``, ``b`` (K,) int64 and branch
    probabilities (K, branching) float32, the reference's draws."""
    rng = np.random.default_rng(cfg.seed)
    K, B = cfg.num_mixtures, cfg.branching
    a = rng.integers(1, 2**31 - 1, size=(K,), dtype=np.int64)
    b = rng.integers(1, 2**31 - 1, size=(K,), dtype=np.int64)
    probs = rng.dirichlet(np.full(B, 0.5), size=K).astype(np.float32)
    return a, b, probs


def _wrap32(x):
    """int64 values reduced to int32 two's-complement wraparound."""
    return ((x + 2**31) % 2**32) - 2**31


def successor(a, b, prev, cur, choice, vocab: int):
    """Candidate ``choice`` of state (prev, cur) under hash constants
    (a, b), int64 arrays or tensors of one shape: the reference's
    ``(a * (prev * V + cur + 1) + b * (choice + 1)) % (2^31 - 1) % V`` with
    every product and sum wrapped to int32 (``%`` is a floor-mod for both
    numpy and torch, as ``jnp``'s)."""
    t = _wrap32(_wrap32(prev * vocab) + cur + 1)
    h = _wrap32(_wrap32(a * t) + _wrap32(b * (choice + 1)))
    return h % _P % vocab


def _generator(cfg: LMDataConfig, step: int) -> torch.Generator:
    seed = np.random.SeedSequence([cfg.seed, int(step)]).generate_state(1)[0]
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g


def lm_batch(cfg: LMDataConfig, step: int) -> dict:
    """Batch for ``step``: {"tokens": (B, S), "labels": (B, S)} int32 on
    the CPU; labels[t] = tokens[t + 1], the final label -100 (ignored by
    ``cross_entropy``)."""
    a_np, b_np, probs_np = _tables(cfg)
    V, B, S = cfg.vocab_size, cfg.batch_size, cfg.seq_len
    g = _generator(cfg, step)
    mix = torch.randint(0, cfg.num_mixtures, (B,), generator=g)
    init = torch.randint(0, V, (B, 2), generator=g)
    choice = torch.multinomial(torch.from_numpy(probs_np)[mix], S,
                               replacement=True, generator=g)   # (B, S)
    mix, init, choice = mix.numpy(), init.numpy(), choice.numpy()
    a, b = a_np[mix], b_np[mix]
    prev, cur = init[:, 0], init[:, 1]
    toks = np.empty((B, S), np.int64)
    for s in range(S):
        prev, cur = cur, successor(a, b, prev, cur, choice[:, s], V)
        toks[:, s] = cur
    tokens = torch.from_numpy(toks.astype(np.int32))
    labels = torch.cat([tokens[:, 1:],
                        torch.full((B, 1), -100, dtype=torch.int32)], dim=1)
    return {"tokens": tokens, "labels": labels}


def lm_eval_stream(cfg: LMDataConfig, num_batches: int,
                   start_step: int = 10**6):
    """Held-out batches (a step range disjoint from training)."""
    for i in range(num_batches):
        yield lm_batch(cfg, start_step + i)

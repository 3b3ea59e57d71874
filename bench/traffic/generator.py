"""The one traffic generator: it reads a mix (a JSON file beside it) and a
seed, and makes requests or batches.

The draws are seeded copies of the program's ``core/traffic.py`` ideas
(lognormal lengths clipped to a range, Zipf popularity, Poisson
arrivals), moved onto the wall clock: a request is due at a time in
seconds from the stream's start, not at a decode step. Every seed gets
the same set of sizes and the same set of gaps between arrivals, in
another order: the stream is cut into blocks of ``stratum`` requests,
and in every block the lengths are the lognormal's quantiles at the
midpoints of equal strata, the gaps the exponential's, and a document's
share of the requests its Zipf weight rounded to whole requests. The
seed permutes each block and draws every token, so two seeds do the same
work in another order, any stretch of a few blocks (a window) holds
nearly the same work, and the spread between seeds is the system's, not
the sample's.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import List

import numpy as np

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    """The mix ``<name>.json`` beside this file."""
    with open(HERE / f"{name}.json") as f:
        return json.load(f)


def lognormal_quantiles(spec: dict, n: int) -> np.ndarray:
    """n lengths: the lognormal's quantiles (median ``median``, log-sd
    ``sigma``) at the midpoints of n equal strata, rounded and clipped to
    [``min``, ``max``]."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def exponential_gaps(rate: float, n: int) -> np.ndarray:
    """n gaps in seconds: the exponential's (mean 1 / rate) quantiles at
    the midpoints of n equal strata."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def zipf_counts(k: int, s: float, n: int) -> np.ndarray:
    """n requests over k items of Zipf weights 1 / rank^s, by largest
    remainder: item 0 is the most popular."""
    w = 1.0 / np.arange(1, k + 1) ** s
    exact = n * w / w.sum()
    c = np.floor(exact).astype(np.int64)
    c[np.argsort(-(exact - c), kind="stable")[:n - c.sum()]] += 1
    return c


@dataclasses.dataclass
class DocRequest:
    rid: int
    due_s: float           # seconds from the stream's start
    doc: int               # document index (0 = the most popular)
    question: np.ndarray   # int64 tokens
    max_new: int


@dataclasses.dataclass
class DocStream:
    docs: List[np.ndarray]           # int64 tokens of each document
    requests: List[DocRequest]       # in due order

    def prompt(self, r: DocRequest) -> np.ndarray:
        return np.concatenate([self.docs[r.doc], r.question])


def shared_documents(mix: dict, *, seed: int, rate: float, n: int,
                     vocab: int) -> DocStream:
    """``n`` requests of the "shared_documents" mix at ``rate`` per
    second: each asks about one of the mix's documents (Zipf popularity),
    a unique question after it, and an answer of a fixed length.
    Documents keep one length per popularity rank (the quantiles in a
    fixed interleave), whatever the seed."""
    rng = np.random.default_rng(seed)
    dspec = mix["documents"]
    k = dspec["count"]
    lens = lognormal_quantiles(dspec["length"], k)
    # popularity rank r takes the quantile next to the median on
    # alternating sides (k = 8: 4, 3, 5, 2, 6, 1, 7, 0), so the hot
    # documents are the middling ones, not all long or all short
    mid = k // 2
    order = [mid + (r + 1) // 2 if r % 2 == 0 else mid - (r + 1) // 2
             for r in range(k)]
    doc_lens = lens[np.clip(order, 0, k - 1)]
    docs = [rng.integers(0, vocab, int(m)) for m in doc_lens]
    b = int(mix["stratum"])
    block = (np.repeat(np.arange(k), zipf_counts(k, dspec["zipf_s"], b)),
             lognormal_quantiles(mix["question"], b),
             lognormal_quantiles(mix["answer"], b), exponential_gaps(rate, b))
    doc_of, qlen, alen, gaps = (
        np.concatenate([rng.permutation(a) for _ in range(-(-n // b))])[:n]
        for a in block)
    due = np.cumsum(gaps) - gaps[0]
    reqs = [DocRequest(rid=i, due_s=float(due[i]), doc=int(doc_of[i]),
                       question=rng.integers(0, vocab, int(qlen[i])),
                       max_new=int(alen[i])) for i in range(n)]
    return DocStream(docs=docs, requests=reqs)


def max_prompt_tokens(mix: dict) -> int:
    """The longest document + question + answer the mix can draw."""
    return (mix["documents"]["length"]["max"] + mix["question"]["max"]
            + mix["answer"]["max"])


def train_batch(mix: dict, *, seed: int, step: int, vocab: int, device):
    """Step ``step``'s batch of the "uniform_tokens" mix: ``rows`` x
    ``seq`` tokens drawn uniformly from the vocabulary on ``device`` by a
    generator seeded with (seed, step); labels are the next tokens.
    Returns {"tokens", "labels"} int32 (rows, seq)."""
    import torch
    from ..reference.weights import leaf_seed
    rows, seq = mix["rows"], mix["seq"]
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, f"batch{step}"))
    t = torch.randint(0, vocab, (rows, seq + 1), generator=g, device=device,
                      dtype=torch.int64).to(torch.int32)
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}

"""The traffic generator: one stream per seed, the same sizes and gaps for
every seed, due times in seconds."""
import numpy as np
import pytest

from bench.traffic import generator as gen

SEEDS = [0, 7, 2 ** 31 + 12345]


def _stream(seed, n=192, rate=4.0):
    return gen.shared_documents(gen.load_mix("docqa-shared"), seed=seed,
                                rate=rate, n=n, vocab=152064)


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_stream(seed):
    a, b = _stream(seed), _stream(seed)
    assert all(np.array_equal(x, y) for x, y in zip(a.docs, b.docs))
    for r, s in zip(a.requests, b.requests):
        assert (r.due_s, r.doc, r.max_new) == (s.due_s, s.doc, s.max_new)
        assert np.array_equal(r.question, s.question)


def test_seeds_share_sizes_and_gaps_in_another_order():
    a, b = _stream(1), _stream(2)
    key = lambda s: (sorted(r.max_new for r in s.requests),
                     sorted(len(r.question) for r in s.requests),
                     sorted(r.doc for r in s.requests),
                     [len(d) for d in s.docs])
    assert key(a) == key(b)
    assert [r.max_new for r in a.requests] != [r.max_new for r in b.requests]
    assert not np.array_equal(a.docs[0], b.docs[0])


def test_due_times_are_seconds_at_the_rate():
    rate, n = 4.0, 384
    s = _stream(3, n=n, rate=rate)
    due = np.array([r.due_s for r in s.requests])
    assert due[0] == 0.0 and np.all(np.diff(due) > 0)
    # n - 1 gaps of mean 1 / rate (the stratified set's mean is exact up
    # to the one gap dropped at the start)
    assert abs(due[-1] / (n - 1) - 1 / rate) < 0.05 / rate


def test_every_block_holds_the_same_work():
    mix = gen.load_mix("docqa-shared")
    b = mix["stratum"]
    s = _stream(5, n=4 * b)
    blocks = [s.requests[i:i + b] for i in range(0, 4 * b, b)]
    key = lambda blk: (sorted(r.max_new for r in blk),
                       sorted(len(r.question) for r in blk),
                       sorted(r.doc for r in blk))
    assert all(key(blk) == key(blocks[0]) for blk in blocks)
    assert [r.max_new for r in blocks[0]] != [r.max_new for r in blocks[1]]


def test_lengths_within_the_mix():
    mix = gen.load_mix("docqa-shared")
    s = _stream(4)
    lo, hi = mix["documents"]["length"]["min"], mix["documents"]["length"]["max"]
    assert all(lo <= len(d) <= hi for d in s.docs)
    assert all(mix["answer"]["min"] <= r.max_new <= mix["answer"]["max"]
               for r in s.requests)
    assert gen.max_prompt_tokens(mix) == hi + mix["question"]["max"] + \
        mix["answer"]["max"]


def test_zipf_counts_sum_and_order():
    c = gen.zipf_counts(8, 1.0, 400)
    assert c.sum() == 400 and np.all(np.diff(c) <= 0)


def test_train_batches_differ_by_step_and_repeat_by_seed():
    import torch
    mix = gen.load_mix("train-w10d12")
    a = gen.train_batch(mix, seed=5, step=0, vocab=1000, device="cpu")
    b = gen.train_batch(mix, seed=5, step=0, vocab=1000, device="cpu")
    c = gen.train_batch(mix, seed=5, step=1, vocab=1000, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (mix["rows"], mix["seq"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    rows = {tuple(r.tolist()) for r in a["tokens"]}
    assert len(rows) == mix["rows"]

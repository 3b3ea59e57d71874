"""The frozen counts against ``torch.utils.flop_counter`` on the plain
reference at small sizes, and B1's byte count against a brute count."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench.counts import decoder as counts
from bench.counts import paged_attention
from bench.reference import decoder as ref
from bench.reference import train as ref_train
from bench.reference.weights import Dims

DIMS = Dims(layers=2, d_model=64, heads=4, kv_heads=2, head_dim=16,
            d_ff=96, vocab=200, qkv_bias=True, rope_theta=1e4,
            norm_eps=1e-6)


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("prefix,suffix", [(0, 24), (40, 1), (40, 9)])
def test_forward_flops_match_the_flop_counter(prefix, suffix):
    """The reference computes every score of a block (masking after), so
    its attention reads prefix + suffix keys for each suffix query and
    prefix keys for each prefix query."""
    rng = np.random.default_rng(0)
    group = (rng.integers(0, DIMS.vocab, prefix),
             [(rng.integers(0, DIMS.vocab, suffix), 0)])
    got = _flops(lambda: ref.group_logits(DIMS, 1, [group], device="cpu",
                                          served_dtype=torch.float32,
                                          kv_fmt=(2, 6)))
    tokens = prefix + suffix
    keys = prefix * prefix + suffix * (prefix + suffix)
    want = (counts.forward_flops(DIMS, tokens=tokens, keys=keys, head=False)
            + 2.0 * DIMS.d_model * DIMS.vocab * suffix)
    assert got == want


def test_train_step_flops_are_three_forwards():
    d = Dims(**{**DIMS.__dict__, "qkv_bias": False, "kv_heads": 4})
    rows, seq = 2, 16
    tok = torch.randint(0, d.vocab, (rows, seq))
    model = ref_train.RefModel(d, 3, "cpu")

    def step():
        loss = model.loss(tok, tok, w_fmt=(2, 8), a_fmt=(4, 8))
        loss.backward()

    got = _flops(step)
    # the reference's attention computes all seq x seq scores: count them
    full = 3.0 * counts.forward_flops(d, tokens=rows * seq,
                                      keys=rows * seq * seq, head=True)
    assert got == full
    causal = counts.train_step_flops(d, rows=rows, seq=seq)
    assert causal < full


def test_b1_call_cost_counts_aliased_pages_once():
    ps, kv, hd, H = 4, 2, 8, 4
    pt = np.array([[1, 2, 3, 0], [1, 2, 4, 5]])      # pages 1, 2 shared
    kv_len = np.array([10, 14])
    q_start = kv_len - 1
    f, b = paged_attention.call_cost(
        B=2, S=1, H=H, hd=hd, q_itemsize=2, kv_heads=kv, page_size=ps,
        bits=8, page_table=pt, q_start=q_start, kv_len=kv_len)
    assert f == 4 * H * hd * (10 + 14)
    distinct = 5                                     # 1, 2, 3, 4, 5
    page = 2 * ps * kv * hd + 8
    want = (distinct * page + 2 * H * hd * 2 + 2 * H * hd * 4
            + (3 + 4) * 4 + 2 * 2 * 4)
    assert b == want


def test_b1_chunk_keys_are_causal():
    f, _ = paged_attention.call_cost(
        B=1, S=8, H=1, hd=1, q_itemsize=2, kv_heads=1, page_size=4, bits=8,
        page_table=np.arange(8)[None], q_start=np.array([10]),
        kv_len=np.array([15]))
    # 5 real queries at positions 10..14 read 11..15 keys
    assert f == 4 * sum(range(11, 16))

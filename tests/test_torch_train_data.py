"""The trainer's data (``repro_torch.data.lm``, ``data.pipeline``) against
the reference's ``repro.data``: the same tables, the same successor hash
with the reference's int32 wraparound (its ``jnp.int64`` runs as int32
with JAX's 64-bit mode off), batches pure in the step, and the pipeline's
step-only state.

The random draws differ by design (``torch.Generator`` against
``jax.random``), so the token streams are compared by their transitions:
every transition of a reference batch lies in the port's successor set of
one mixture."""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.data import lm as jlm
from repro.data import pipeline as jpipe
from repro_torch.data.lm import (LMDataConfig, _tables, lm_batch,
                                 lm_eval_stream, successor)
from repro_torch.data.pipeline import DataPipeline, PipelineConfig

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

CFGS = [dict(vocab_size=256, seq_len=32, batch_size=4),
        dict(vocab_size=102400, seq_len=48, batch_size=3, seed=7),
        dict(vocab_size=512, seq_len=40, batch_size=5, num_mixtures=2,
             branching=8, seed=11)]


def _mixture_of(tokens, cfg):
    """The mixtures whose successor sets hold every transition of each
    row of ``tokens`` (B, S)."""
    a, b, _ = _tables(cfg)
    choices = np.arange(cfg.branching)
    out = []
    for row in np.asarray(tokens, np.int64):
        ok = []
        for m in range(cfg.num_mixtures):
            cands = successor(a[m], b[m], row[:-2, None], row[1:-1, None],
                              choices[None, :], cfg.vocab_size)
            if (cands == row[2:, None]).any(axis=1).all():
                ok.append(m)
        out.append(ok)
    return out


@pytest.mark.parametrize("kw", CFGS)
def test_tables_equal_the_reference(kw):
    for got, want in zip(_tables(LMDataConfig(**kw)),
                         jlm._tables(jlm.LMDataConfig(**kw))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", CFGS)
def test_reference_transitions_lie_in_the_port_successor_sets(kw):
    """Each row of the reference's batches follows one mixture's
    successor sets as the port computes them (at vocab 102400 the int32
    wraparound decides every candidate)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the reference's int64 warning
        for step in (0, 5):
            b = jlm.lm_batch(jlm.LMDataConfig(**kw), step)
            mixes = _mixture_of(np.asarray(b["tokens"]), LMDataConfig(**kw))
            assert all(len(m) >= 1 for m in mixes), mixes


def test_the_hash_wraps_as_int32():
    """Without the wraparound (exact integers) the candidate differs."""
    cfg = LMDataConfig(vocab_size=102400, seq_len=8, batch_size=1)
    a, b, _ = _tables(cfg)
    prev, cur, ch = np.int64(90000), np.int64(12345), np.int64(7)
    got = successor(a[0], b[0], prev, cur, ch, cfg.vocab_size)
    plain = (int(a[0]) * (int(prev) * 102400 + int(cur) + 1)
             + int(b[0]) * (int(ch) + 1)) % (2 ** 31 - 1) % 102400
    assert got != plain
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        import jax.numpy as jnp
        h = (jnp.asarray(a)[0] * (jnp.int64(prev) * jnp.int64(102400)
                                  + jnp.int64(cur) + 1)
             + jnp.asarray(b)[0] * (jnp.int64(ch) + 1)) \
            % jnp.int64(2 ** 31 - 1)
        assert int(got) == int(h % 102400)


@pytest.mark.parametrize("kw", CFGS)
def test_port_batches_follow_their_mixtures_and_label_layout(kw):
    cfg = LMDataConfig(**kw)
    b = lm_batch(cfg, 3)
    B, S = cfg.batch_size, cfg.seq_len
    assert b["tokens"].shape == b["labels"].shape == (B, S)
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32
    assert int(b["tokens"].min()) >= 0
    assert int(b["tokens"].max()) < cfg.vocab_size
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -100).all()
    assert all(len(m) >= 1 for m in _mixture_of(b["tokens"], cfg))


def test_batches_are_pure_in_the_step():
    cfg = LMDataConfig(**CFGS[0])
    a, b = lm_batch(cfg, 4), lm_batch(cfg, 4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], lm_batch(cfg, 5)["tokens"])
    other = LMDataConfig(**dict(CFGS[0], seed=99))
    assert not torch.equal(a["tokens"], lm_batch(other, 4)["tokens"])


def test_eval_stream_is_held_out():
    cfg = LMDataConfig(**CFGS[0])
    got = list(lm_eval_stream(cfg, 2, start_step=100))
    assert len(got) == 2
    assert torch.equal(got[1]["tokens"], lm_batch(cfg, 101)["tokens"])
    first = next(lm_eval_stream(cfg, 1))
    assert torch.equal(first["tokens"], lm_batch(cfg, 10 ** 6)["tokens"])


def test_pipeline_state_restore_and_prefetch():
    """As the reference's: the state is the next step to produce (the
    prefetched batches counted), restore drops the queue and replays from
    the given step."""
    cfg = LMDataConfig(**CFGS[0])
    calls = []

    def fn(step):
        calls.append(step)
        return lm_batch(cfg, step)

    pipe = DataPipeline(fn, device="cpu", start_step=3)
    first = next(pipe)
    assert torch.equal(first["tokens"], lm_batch(cfg, 3)["tokens"])
    assert calls == [3, 4, 5] and pipe.state == {"step": 6}
    ref = jpipe.DataPipeline(lambda s: {"s": s}, start_step=3)
    next(ref)
    assert ref.state == pipe.state
    pipe.restore({"step": 10})
    assert torch.equal(next(pipe)["tokens"], lm_batch(cfg, 10)["tokens"])
    deep = DataPipeline(fn, cfg=PipelineConfig(prefetch=0))
    next(deep)
    assert deep.state == {"step": 1}


def test_pipeline_places_batches_on_its_device():
    cfg = LMDataConfig(**CFGS[0])
    pipe = DataPipeline(lambda s: lm_batch(cfg, s),
                        device=torch.device("meta"))
    b = next(pipe)
    assert all(v.device.type == "meta" for v in b.values())

"""The check that decides ``correct``, on the CPU at small sizes: the
program agrees with the plain reference, and a run whose timed path is
broken underneath (a token altered where it is produced, a pool write or
an optimizer step that leaves its state unchanged, half of the batch left
out) comes out not correct. The harness's look for a card is skipped;
everything else is a whole run of the cell's driver."""
import pytest
import torch

from bench import core
from bench.tests import smoke

SEED = 2 ** 31 + 99


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _serve():
    return core.run_cell(smoke.serve_spec(), seed=SEED, seconds=1.0,
                         trace=False, device="cpu")


def _train():
    return core.run_cell(smoke.train_spec(), seed=SEED, seconds=0.5,
                         trace=False, device="cpu")


def test_served_tokens_agree_with_the_reference():
    res = _serve()
    assert res["correct"]
    assert res["checks"]["logit_gap"]["value"] < 1e-4
    assert res["attempted"] >= 5 and res["failed"] == 0
    sample = res["notes"]["sample"]
    assert len(sample["tokens"]) >= 2 and min(sample["tokens"]) >= 24
    assert res["checks"]["mean_logit_gap"]["value"] < 1e-5


def test_training_agrees_with_the_reference():
    res = _train()
    assert res["correct"]
    c = res["checks"]
    assert res["notes"]["notes"]["loss_gap"] < 1e-4
    assert c["grad_gap"]["value"] < 1e-2
    assert c["change_gap"]["value"] < 1e-2


def test_a_token_altered_where_produced_is_caught(monkeypatch):
    import repro_torch.launch.serve as serve
    make = serve.make_decode_step

    def broken(cfg, **kw):
        step = make(cfg, **kw)
        calls = [0]

        def wrapped(model, tokens, pos, caches, page_table):
            nxt, logits, caches = step(model, tokens, pos, caches,
                                       page_table)
            calls[0] += 1
            if calls[0] % 5 == 0:
                nxt = nxt.clone()
                nxt[:] = torch.argmin(logits, dim=-1).to(nxt.dtype)
            return nxt, logits, caches
        return wrapped

    monkeypatch.setattr(serve, "make_decode_step", broken)
    res = _serve()
    assert not res["correct"]
    assert not res["checks"]["logit_gap"]["ok"]


def test_a_pool_write_that_leaves_the_state_unchanged_is_caught(
        monkeypatch):
    import repro_torch.models.attention as attn
    write = attn.paged_cache_update
    calls = [0]

    def skip(cache, k, v, page_table, pos, quant=None, valid_len=None):
        calls[0] += 1
        if k.shape[1] == 1 and calls[0] > 40:
            return cache                      # decode writes dropped
        return write(cache, k, v, page_table, pos, quant,
                     valid_len=valid_len)

    monkeypatch.setattr(attn, "paged_cache_update", skip)
    assert not _serve()["correct"]


def test_an_optimizer_step_that_changes_nothing_is_caught(monkeypatch):
    import repro_torch.launch.steps as steps
    update = steps.adamw_update

    def frozen(params, grads, state, lr, cfg, **kw):
        keep = {n: p.detach().clone() for n, p in params.items()}
        out = update(params, grads, state, lr, cfg, **kw)
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(keep[n])
        return out

    monkeypatch.setattr(steps, "adamw_update", frozen)
    res = _train()
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_caught(monkeypatch):
    import repro_torch.launch.steps as steps
    lg = steps.loss_and_grads

    def half(model, batch, cfg, **kw):
        rows = batch["tokens"].shape[0] // 2
        return lg(model, {k: v[:rows] for k, v in batch.items()}, cfg, **kw)

    monkeypatch.setattr(steps, "loss_and_grads", half)
    res = _train()
    assert not res["correct"]
    assert not res["checks"]["change_gap"]["ok"]

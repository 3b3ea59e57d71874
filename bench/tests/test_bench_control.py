"""The control of each cell's ``correct`` at a size a CPU test holds: a
step below the configuration's precision reads above the limit on at
least one number where the program itself passes. For training it is
the reference put in the program's place in float8 e4m3 operands (below
bf16), against the cell's own limits; for serving the program's own
int4 KV path (below int8), and the reference with float8 e4m3 weights
(below bf16) in the program's place. ``bench/tools/control.py`` reads
them at the cells' own sizes on the card."""
import pytest
import torch

from bench import core
from bench.tests import smoke

TINY_TRAIN = {"hidden_size": 32, "num_attention_heads": 2,
              "num_key_value_heads": 2, "intermediate_size": 64,
              "vocab_size": 256}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_training_control_fails_a_number(seed):
    spec = smoke.train_spec()
    spec.config.update(TINY_TRAIN)
    spec.overrides["controls"] = ["fp8"]
    res = core.run_cell(spec, seed=seed, seconds=0.1, trace=False,
                        device="cpu")
    assert res["correct"]
    ctl = res["notes"]["control_fp8"]
    assert any(ctl[k] > c["limit"] for k, c in res["checks"].items()), ctl


@pytest.mark.parametrize("seed", [1, 2])
def test_serving_control_fails_the_gap(seed):
    """The serving control is the program's own int4 KV path (a step below
    the configuration's int8). At this size the program reads 0 (float32
    on both sides) and the int4 path 0.39-0.72 on four seeds, where the
    card at the cell's size reads 0.09-0.20 and 2.3-2.8 against a limit
    of 0.8; the limit at this size, set by the same rule, is 0.1."""
    spec = smoke.serve_spec()
    spec.cell["serve"]["limits"] = {"logit_gap": 0.1}
    assert core.run_cell(spec, seed=seed, seconds=1.0, trace=False,
                         device="cpu")["correct"]
    spec.overrides["program"] = {"kv_bits": 4}
    res = core.run_cell(spec, seed=seed, seconds=1.0, trace=False,
                        device="cpu")
    assert not res["correct"]


@pytest.mark.parametrize("seed", [1, 2])
def test_serving_float8_control_fails_the_mean_gap(seed):
    """The reference with float8 weights, reading the token it puts first
    at each served position. At this size the program reads 0 and this
    control's mean gap 0.015-0.025 on four seeds (the card at the cell's
    size: 0.0045-0.0082 and 0.054-0.067); the limit at this size, set by
    the same rule, is 0.005."""
    spec = smoke.serve_spec()
    spec.cell["serve"]["limits"] = {"logit_gap": 0.1, "mean_logit_gap": 0.005}
    spec.overrides["control"] = True
    res = core.run_cell(spec, seed=seed, seconds=1.0, trace=False,
                        device="cpu")
    assert res["correct"]
    limit = res["checks"]["mean_logit_gap"]["limit"]
    assert res["notes"]["control_mean_logit_gap"] > limit

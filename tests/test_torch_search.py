"""The port's precision searches and range calibration against the JAX
package's, and the paper's greedy search end to end on LeNet.

The searches are host logic: driven by one deterministic ``eval_fn`` (the
``synthetic_eval`` of tests/test_policy_search.py, which reads only format
fields, so both packages' policies can feed it) they must give identical
results, point for point. End to end, LeNet is trained in the port on the
CPU, its weights handed to the reference through ``cnn_params_to_numpy``,
and both packages' greedy searches must pick the same per-layer policy at
every step (ROADMAP queue A item 1's gate).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import nhwc  # noqa: E402  (JAX on CPU, 1 thread)
from test_policy_search import synthetic_eval
from repro.core import calibrate as jcal, search as jsearch
from repro.core.fixedpoint import (FixedPointFormat as JF,
                                   required_int_bits as j_required)
from repro.core.policy import FIELDS, PrecisionPolicy as JP
from repro.core.traffic import LayerTraffic as JLT, TrafficModel as JTM
from repro.data.synthetic import digits_dataset
from repro.models import cnn as J
from repro_torch.benchmarks import common as tcommon
from repro_torch.core import calibrate as tcal, search as tsearch
from repro_torch.core.fixedpoint import (FixedPointFormat as TF,
                                         required_int_bits as t_required)
from repro_torch.core.policy import PrecisionPolicy as TP
from repro_torch.core.traffic import LayerTraffic as TLT, TrafficModel as TTM
from repro_torch.models import cnn as T

# the configurations of tests/test_policy_search.py: layer names,
# sensitivities, (weight, data in, data out) elements a layer, the start
# (weight I.F, data I.F), greedy max_steps, sensitivity tolerance
CONFIGS = {
    "four_layers": (("l1", "l2", "l3", "l4"), [2.0, 0.125, 0.5, 0.125],
                    (4000, 1000, 1000), ((2, 10), (6, 6)), 60, 0.10),
    "mixed_beats_uniform": (("a", "b", "c"), [4.0, 0.1, 0.1],
                            (10000, 2000, 2000), ((2, 12), (6, 6)), 80, 0.10),
    "pareto": (("a", "b"), [1.0, 0.2], (100, 10, 10), ((2, 8), (6, 4)), 40,
               0.10),
    "six_layers": (tuple(f"l{i}" for i in range(6)),
                   [2.0, 1.0, 0.5, 0.25, 0.125, 0.125], (5000, 1000, 1000),
                   ((2, 10), (6, 6)), 100, 0.01),
    "tolerance": (("a", "b", "c"), [1.0, 0.3, 0.1], (1000, 100, 100),
                  ((2, 10), (6, 6)), 60, 0.05),
}
THREE_FIELDS = ("weight_frac", "data_int", "data_frac")
TOLERANCES = (0.01, 0.02, 0.05, 0.10)


def both(name):
    """(reference traffic, init), (port traffic, init), eval_fn, steps, tol."""
    names, sens, elems, (w, d), steps, tol = CONFIGS[name]
    jt = JTM(tuple(JLT(n, *elems) for n in names))
    tt = TTM(tuple(TLT(n, *elems) for n in names))
    ji = JP.uniform(names, JF(*w), JF(*d))
    ti = TP.uniform(names, TF(*w), TF(*d))
    return (jt, ji), (tt, ti), synthetic_eval(sens), steps, tol


def points(res):
    return [(p.policy.to_json(), p.accuracy, p.traffic_ratio, p.move)
            for p in res.trajectory]


def assert_identical(t, j):
    assert points(t) == points(j)
    assert t.evaluations == j.evaluations
    assert t.baseline_accuracy == j.baseline_accuracy
    assert [(p.policy.to_json(), p.accuracy) for p in t.pareto()] == \
        [(p.policy.to_json(), p.accuracy) for p in j.pareto()]
    for tol in TOLERANCES:
        ts, js = t.select(tol), j.select(tol)
        assert (ts is None) == (js is None)
        if ts is not None:
            assert (ts.policy.to_json(), ts.traffic_ratio, ts.move) == \
                (js.policy.to_json(), js.traffic_ratio, js.move)
    assert t.table() == j.table()
    td, jd = t.as_dict(), j.as_dict()
    td.pop("wall_seconds"), jd.pop("wall_seconds")
    assert td == jd


# ---------------------------------------------------------------------------
# the searches under a shared eval_fn
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fields", [FIELDS, THREE_FIELDS],
                         ids=["four_fields", "three_fields"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_search_is_identical(name, fields):
    (jt, ji), (tt, ti), ev, steps, _ = both(name)
    j = jsearch.greedy_pareto_search(ev, jt, ji, fields=fields,
                                     max_steps=steps)
    t = tsearch.greedy_pareto_search(ev, tt, ti, fields=fields,
                                     max_steps=steps)
    assert len(t.trajectory) > 1
    assert_identical(t, j)


@pytest.mark.parametrize("fields", [FIELDS, THREE_FIELDS],
                         ids=["four_fields", "three_fields"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sensitivity_search_is_identical(name, fields):
    (jt, ji), (tt, ti), ev, _, tol = both(name)
    assert tsearch.sensitivity_profile(ev, ti, fields=fields) == \
        jsearch.sensitivity_profile(ev, ji, fields=fields)
    j = jsearch.sensitivity_search(ev, jt, ji, fields=fields, tolerance=tol,
                                   batch_size=50)
    t = tsearch.sensitivity_search(ev, tt, ti, fields=fields, tolerance=tol,
                                   batch_size=50)
    assert_identical(t, j)


def test_greedy_ties_keep_the_first_best_move():
    """Every move scores the same: the strict ``>`` keeps the first one,
    so the search walks (layer 0, first field) down, as the reference."""
    (jt, ji), (tt, ti), _, _, _ = both("pareto")
    j = jsearch.greedy_pareto_search(lambda p: 0.5, jt, ji, max_steps=5)
    t = tsearch.greedy_pareto_search(lambda p: 0.5, tt, ti, max_steps=5)
    assert [p.move for p in t.trajectory[1:]] == [(0, "weight_int")] + \
        [(0, "weight_frac")] * 4
    assert_identical(t, j)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
def test_required_int_bits_at_powers_of_two_and_zero():
    xs = np.array([0.0] + [2.0 ** k for k in range(-30, 31)], np.float32)
    got = t_required(torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_required(xs)))
    # 2^(I-1) >= x: exactly k + 1 at x = 2^k (1 for x <= 1/2), 1 at 0
    assert got[0] == 1
    np.testing.assert_array_equal(
        got[1:], [max(k + 1, 1) for k in range(-30, 31)])


def test_required_int_bits_near_a_power_of_two():
    """A known difference (ROADMAP queue C): I = ceil(log2 x) + 1 in
    float32, and where log2 x lies within float32 ULPs above an integer the
    two packages' log2 round differently, so I may differ by one (either
    way). Everywhere else, and one ULP below each power of two, they agree."""
    pw = (np.float32(2.0) ** np.arange(-30, 31)).astype(np.float32)
    above = np.nextafter(pw, np.float32(np.inf))
    below = np.nextafter(pw, np.float32(0))
    x = np.random.default_rng(0).uniform(1e-3, 1e3, 20000).astype(np.float32)
    for xs in (below, above, x):
        got = t_required(torch.from_numpy(xs)).numpy()
        ref = np.asarray(j_required(xs))
        diff = got != ref
        assert np.all(np.abs(got - ref) <= 1)
        lg = np.log2(xs[diff].astype(np.float64))
        assert np.all(lg - np.floor(lg) < 1e-6), xs[diff]
        if xs is below:
            assert not diff.any()


def range_arrays():
    rng = np.random.default_rng(3)
    return {"a": [rng.normal(0, 3, (64, 9)).astype(np.float32),
                  np.zeros((5,), np.float32)],
            "b": [np.array([0.25, -4.0, 2.0, 0.0], np.float32),
                  rng.uniform(-1, 1, 300).astype(np.float32)],
            "c": [np.zeros((7, 3), np.float32)],
            "d": [np.array([-8.0, 1.0], np.float32), np.zeros((0,),
                                                               np.float32)]}


def test_range_stats_are_equal():
    js, ts = jcal.RangeStats(), tcal.RangeStats()
    for name, arrs in range_arrays().items():
        for a in arrs:
            js.update(name, jnp.asarray(a))
            ts.update(name, torch.from_numpy(a))
    assert ts.max_abs == js.max_abs and ts.pctl_abs == js.pctl_abs
    for name in list(range_arrays()) + ["missing"]:
        for pct in (False, True):
            for margin in (0, 2):
                assert tcal.int_bits_for(ts, name, use_percentile=pct,
                                         margin_bits=margin) == \
                    jcal.int_bits_for(js, name, use_percentile=pct,
                                      margin_bits=margin)


def test_calibrated_policy_is_equal():
    names = ("l1", "l2", "l3", "l4", "l5")
    wr = {"l1": 0.0, "l2": 1.0, "l3": 0.37, "l5": 8.0}     # l4 weightless
    dr = {"l1": 4.0, "l2": 0.0, "l3": 1000.0, "l4": 0.5}    # l5 absent
    for kw in ({}, {"frac_bits_weight": 8, "frac_bits_data": 2,
                    "weightless": ("l3",)}):
        t = tcal.calibrated_policy(names, wr, dr, **kw)
        j = jcal.calibrated_policy(names, wr, dr, **kw)
        assert t.to_json() == j.to_json()


# ---------------------------------------------------------------------------
# end to end on LeNet, on weights trained in the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lenet_trained():
    params, _ = tcommon.train_cnn("lenet", device="cpu", steps=150,
                                  verbose=False)
    return T.cnn_params_to_numpy(params, T.LENET)


def calibrate(pkg, cal, forward, weights):
    """The example's calibration: weight ranges directly, data ranges from
    truncated-prefix forwards (``forward(sub_spec)``)."""
    spec = pkg.LENET
    sw, sd = cal.RangeStats(), cal.RangeStats()
    for i, l in enumerate(spec.layers):
        sw.update(l.name, weights[l.name]["w"])
        sub = dataclasses.replace(spec, layers=spec.layers[:i + 1])
        sd.update(l.name, forward(sub))
    return cal.calibrated_policy(spec.layer_names, sw.max_abs, sd.max_abs,
                                 frac_bits_weight=8, frac_bits_data=2)


def test_lenet_greedy_search_picks_the_same_policy_every_step(lenet_trained):
    tree = lenet_trained
    tparams = T.cnn_params_from_numpy(tree, T.LENET, "cpu")
    x, y = digits_dataset(256, seed=99)
    xt, yt = T.images_nchw(x, "cpu"), torch.from_numpy(y).long()
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    tpol = calibrate(T, tcal, lambda sub: nhwc(T.cnn_forward(
        tparams, xt[:64], sub)), tparams)
    jpol = calibrate(J, jcal, lambda sub: np.asarray(J.cnn_forward(
        tree, xj[:64], sub)), tree)
    assert tpol.to_json() == jpol.to_json()

    def t_eval(pol):
        return T.cnn_accuracy(tparams, xt, yt, T.LENET, pol)

    def j_eval(pol):
        return J.cnn_accuracy(tree, xj, yj, J.LENET, pol)

    base = t_eval(None)
    assert base == j_eval(None) and base > 0.5
    t = tsearch.greedy_pareto_search(
        t_eval, T.cnn_traffic_model(T.LENET), tpol, baseline_accuracy=base,
        fields=THREE_FIELDS, batch_size=50, max_steps=20)
    j = jsearch.greedy_pareto_search(
        j_eval, J.cnn_traffic_model(J.LENET), jpol, baseline_accuracy=base,
        fields=THREE_FIELDS, batch_size=50, max_steps=20)
    assert len(t.trajectory) == 21
    assert [p.policy.to_json() for p in t.trajectory] == \
        [p.policy.to_json() for p in j.trajectory]
    assert_identical(t, j)

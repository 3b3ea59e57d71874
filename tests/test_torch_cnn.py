"""The port's CNN experiment against the JAX package, module by module:
datasets, the three CNNs (weights, forward, accuracy), the traffic models
and the Fig. 4 accounting (loss, gradients and training steps are in
tests/test_torch_cnn_train.py). Same seeded numpy inputs through both
packages, one process, single-threaded torch.

Tolerances: float32 logits 1e-4 (rtol and atol, as tests/test_kernels.py);
quantized grids exactly, except counted one-step flips where the packages'
float ULPs put a value on either side of a rounding tie.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cnn_images as images, cnn_ref_tree as ref_tree  # noqa: E402
from _torch_parity import cnn_port as port, nhwc  # noqa: E402
import benchmarks.common as jcommon
import benchmarks.traffic as jtraffic
from repro.core.fixedpoint import FixedPointFormat as JF
from repro.core.policy import LayerPolicy as JL, PrecisionPolicy as JP
from repro.data import synthetic as jsynth
from repro.models import cnn as J
from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import traffic as ttraffic
from repro_torch.core.policy import PrecisionPolicy as TP
from repro_torch.data import synthetic as tsynth
from repro_torch.models import cnn as T

NETS = ["lenet", "convnet", "alexnet_small"]
TOL = dict(rtol=1e-4, atol=1e-4)


def policies(net):
    """Three uniform policies and a mixed one whose first layer is float32
    (the (-1, -1) sentinel) beside weight-only and data-only layers."""
    names = J.SPECS[net].layer_names
    out = [JP.uniform(names, JF(1, 8), JF(6, 4)),
           JP.uniform(names, JF(1, 6), JF(4, 2)),
           JP.uniform(names, JF(1, 4), JF(3, 1))]
    mixed = [JL(None, None), JL(JF(2, 6), None)] + \
        [JL(JF(1, 7), JF(5, 3))] * (len(names) - 3) + [JL(None, JF(6, 6))]
    out.append(JP(names, tuple(mixed)))
    return out


def to_port(jpol):
    return None if jpol is None else TP.from_json(jpol.to_json())


# ---------------------------------------------------------------------------
# data, shapes, traffic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["digits_dataset", "shapes32_dataset"])
@pytest.mark.parametrize("seed", [3, 99])
def test_datasets_are_byte_identical(name, seed):
    xr, yr = getattr(jsynth, name)(48, seed=seed)
    xt, yt = getattr(tsynth, name)(48, seed=seed)
    assert xt.dtype == xr.dtype and yt.dtype == yr.dtype
    assert xt.tobytes() == xr.tobytes() and yt.tobytes() == yr.tobytes()


@pytest.mark.parametrize("net", NETS)
def test_shapes_and_traffic_model_equal(net):
    assert T._shapes_through(T.SPECS[net]) == J._shapes_through(J.SPECS[net])
    tm, jm = T.cnn_traffic_model(T.SPECS[net]), J.cnn_traffic_model(J.SPECS[net])
    assert [dataclasses.astuple(l) for l in tm.layers] == \
        [dataclasses.astuple(l) for l in jm.layers]
    for mode in ("single", "batch"):
        assert tm.accesses(50, mode) == jm.accesses(50, mode)


def test_fig4_accounting_equal():
    assert ttraffic.cnn_traffic() == jtraffic.cnn_traffic()
    assert ttraffic.lm_traffic() == jtraffic.lm_traffic()


def test_training_recipe_is_the_reference_s():
    assert tcommon._TRAIN_STEPS == jcommon._TRAIN_STEPS
    assert tcommon._LR == jcommon._LR
    assert {k: f.__name__ for k, f in tcommon._DATASETS.items()} == \
        {k: f.__name__ for k, (f, _) in jcommon._DATASETS.items()}


# ---------------------------------------------------------------------------
# weights and forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("net", NETS)
def test_params_round_trip_bitwise(net):
    tree, params = ref_tree(net), port(net)
    back = T.cnn_params_to_numpy(params, T.SPECS[net])
    for d in params.values():          # the arrays are copies
        for v in d.values():
            v.add_(1.0)
    assert back.keys() == tree.keys()
    for k in tree:
        for kk in ("w", "b"):
            assert back[k][kk].dtype == tree[k][kk].dtype
            assert back[k][kk].tobytes() == tree[k][kk].tobytes()


def test_params_from_numpy_rejects_a_wrong_shape():
    tree = {k: dict(v) for k, v in ref_tree("lenet").items()}
    tree["layer2"]["w"] = tree["layer2"]["w"][..., :-1]
    with pytest.raises(ValueError, match="layer2"):
        T.cnn_params_from_numpy(tree, T.LENET, "cpu")


def flipped_rows(net, x, jpol):
    """Images whose quantized output grid differs between the packages at
    some layer. Each package runs its own prefix of the network; at the
    first layer where an image differs, it must differ by exactly one grid
    step (a float ULP across a rounding tie)."""
    jspec, tspec = J.SPECS[net], T.SPECS[net]
    tparams, xt = port(net), T.images_nchw(x, "cpu")
    flipped = np.zeros(len(x), bool)
    for i, lp in enumerate(jpol.layers):
        if lp.data is None:
            continue
        names = jspec.layer_names[:i + 1]
        jsub = dataclasses.replace(jspec, layers=jspec.layers[:i + 1])
        tsub = dataclasses.replace(tspec, layers=tspec.layers[:i + 1])
        jp = JP(names, jpol.layers[:i + 1])
        jo = np.asarray(J.cnn_forward({n: ref_tree(net)[n] for n in names},
                                      jnp.asarray(x), jsub, jp))
        to = nhwc(T.cnn_forward(tparams, xt, tsub, to_port(jp)))
        steps = (np.abs(jo - to) * 2.0 ** lp.data.frac_bits).reshape(
            len(x), -1).max(1)
        new = (steps > 0) & ~flipped
        assert np.all(steps[new] == 1.0), (i, steps[new])
        flipped |= new
    return flipped


@pytest.mark.parametrize("net", NETS)
def test_forward_matches_reference(net):
    x, _ = images(net, 64, seed=5)
    tparams, xt = port(net), T.images_nchw(x, "cpu")
    ref = np.asarray(J.cnn_forward(ref_tree(net), jnp.asarray(x), J.SPECS[net]))
    got = T.cnn_forward(tparams, xt, T.SPECS[net]).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    for jpol in policies(net):
        ref = np.asarray(J.cnn_forward(ref_tree(net), jnp.asarray(x),
                                       J.SPECS[net], jpol))
        got = T.cnn_forward(tparams, xt, T.SPECS[net], to_port(jpol)).numpy()
        np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))
        if not np.allclose(got, ref, **TOL):
            flips = flipped_rows(net, x, jpol)
            assert 0 < flips.sum() <= 2, flips.sum()   # counted, and rare
            np.testing.assert_allclose(got[~flips], ref[~flips], **TOL)


@pytest.mark.parametrize("net", NETS)
def test_forward_bits_equals_forward_bitwise(net):
    x, _ = images(net, 16, seed=6)
    tparams, xt = port(net), T.images_nchw(x, "cpu")
    spec = T.SPECS[net]
    for pol in [None] + [to_port(p) for p in policies(net)]:
        wb, db = T.policy_bit_arrays(spec, pol)
        assert isinstance(wb, np.ndarray) and isinstance(db, np.ndarray)
        a = T.cnn_forward(tparams, xt, spec, pol)
        b = T.cnn_forward_bits(tparams, xt, spec, wb, db)
        assert torch.equal(a, b)


@pytest.mark.parametrize("net", NETS)
def test_policy_bit_arrays_equal(net):
    for jpol in [None] + policies(net):
        jw, jd = J.policy_bit_arrays(J.SPECS[net], jpol)
        tw, td = T.policy_bit_arrays(T.SPECS[net], to_port(jpol))
        np.testing.assert_array_equal(tw, np.asarray(jw))
        np.testing.assert_array_equal(td, np.asarray(jd))


def test_fp32_exact_restores_the_settings():
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
             mm.allow_tf32)
    try:
        cudnn.benchmark, cudnn.deterministic = True, False
        cudnn.allow_tf32 = mm.allow_tf32 = True
        with T.fp32_exact():
            assert (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
                    mm.allow_tf32) == (False, True, False, False)
        assert (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
                mm.allow_tf32) == (True, False, True, True)
    finally:
        (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
         mm.allow_tf32) = saved


def test_init_is_seeded_truncated_and_scaled():
    spec = T.ALEXNET_SMALL
    a = T.init_cnn(torch.Generator().manual_seed(4), spec, device="cpu")
    b = T.init_cnn(torch.Generator().manual_seed(4), spec, device="cpu")
    shapes = T._weight_shapes(spec)
    for l, (shape, fan_in) in zip(spec.layers, shapes):
        w = a[l.name]["w"]
        assert torch.equal(w, b[l.name]["w"])
        assert not a[l.name]["b"].any()
        tree_shape = T.cnn_params_to_numpy(a, spec)[l.name]["w"].shape
        assert tree_shape == shape
        std = np.sqrt(2.0 / fan_in)
        assert float(w.abs().max()) <= 2.0 * std * (1 + 1e-6)
        # the normal truncated to [-2, 2] has std 0.8796
        assert abs(float(w.std()) / std - 0.8796) < 0.05


# ---------------------------------------------------------------------------
# accuracy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("net", NETS)
def test_accuracy_matches_reference(net):
    x, y = images(net, 256, seed=8)
    xt, yt = T.images_nchw(x, "cpu"), torch.from_numpy(y).long()
    tparams = port(net)
    off = 0
    for jpol in [None] + policies(net):
        ref = J.cnn_accuracy(ref_tree(net), jnp.asarray(x), jnp.asarray(y),
                             J.SPECS[net], jpol)
        got = T.cnn_accuracy(tparams, xt, yt, T.SPECS[net], to_port(jpol),
                             batch=100)
        assert isinstance(got, float)
        assert abs(got - ref) * 256 <= 1.0 + 1e-9, (jpol, got, ref)
        off += round(abs(got - ref) * 256)
    assert off <= 1, off

"""Port parity, fixed-point numerics: formats, quantize / dequantize /
fake_quant in every rounding mode, the straight-through gradient,
QuantizedTensor and quantize_param_tree, against the JAX package on the
same numpy inputs. Grid ops are exact; stochastic rounding is held to the
reference's property test (its noise comes from another generator)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import perturbed_jax_params, t, torch_model  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fixedpoint as jfp  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.core import qtensor as jqt  # noqa: E402
from repro.quant import apply as japply  # noqa: E402
from repro_torch.core import fixedpoint as tfp  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core import qtensor as tqt  # noqa: E402
from repro_torch.quant import apply as tapply  # noqa: E402

FORMATS = [(1, 0), (2, 6), (1, 3), (4, 4), (3, 5), (8, 8), (2, 14), (12, 10)]
_CONTAINERS = {torch.int8: jnp.int8, torch.int16: jnp.int16,
               torch.int32: jnp.int32}


def _inputs(seed: int, frac_bits: int, n: int = 400) -> np.ndarray:
    """Random values at several scales, exact grid ties, the largest
    float32 below a half step on both sides, signed zeros, and values
    past both ends of every format's range. (Subnormal inputs are held
    apart: see test_subnormal_inputs_are_kept.)"""
    rng = np.random.default_rng(seed)
    step = np.float32(2.0 ** -frac_bits)
    below_half = np.nextafter(np.float32(0.5), np.float32(0))  # 0.49999997
    special = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, below_half,
                        -below_half, 1 + below_half, -(1 + below_half), 0.0,
                        -0.0], np.float32) * step
    extreme = np.array([1e9, -1e9, np.inf, -np.inf, 1.2e-38, -1.2e-38],
                       np.float32)
    body = np.concatenate([rng.normal(0, s, n // 4) for s in
                           (0.01, 1.0, 8.0, 300.0)]).astype(np.float32)
    return np.concatenate([special, extreme, body])


@pytest.mark.parametrize("i,f", FORMATS)
def test_format_properties_match_reference(i, f):
    a, b = tfp.FixedPointFormat(i, f), jfp.FixedPointFormat(i, f)
    for name in ("total_bits", "scale", "qmin", "qmax", "max_value",
                 "min_value", "resolution"):
        assert getattr(a, name) == getattr(b, name), name
    assert _CONTAINERS[a.container_dtype()] == b.container_dtype()
    assert a.short() == b.short()
    assert tfp.FixedPointFormat.parse(b.short()) == a
    assert tfp.FixedPointFormat.parse(f" q{i}.{f}") == a


@pytest.mark.parametrize("rounding", ["nearest", "floor"])
@pytest.mark.parametrize("i,f", FORMATS)
def test_quantize_dequantize_fake_quant_exact(rounding, i, f):
    x = _inputs(i * 31 + f, f)
    q = tfp.quantize(t(x), i, f, rounding=rounding)
    jq = jfp.quantize(jnp.asarray(x), i, f, rounding=rounding)
    assert q.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        tfp.dequantize(q, i, f).numpy(),
        np.asarray(jfp.dequantize(jq, i, f)))
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        y = tfp.fake_quant(t(x).to(tdt), i, f, rounding=rounding)
        jy = jfp.fake_quant(jnp.asarray(x).astype(jdt), i, f,
                            rounding=rounding)
        assert y.dtype == tdt
        np.testing.assert_array_equal(y.float().numpy(),
                                      np.asarray(jy, np.float32))


def test_nearest_rounds_half_away_from_zero():
    """Ties go away from zero, and 0.49999997 of a step goes to 0 (s + 0.5
    rounds up to 1.0 in float32 there, which trunc then keeps)."""
    half = np.float32(0.5)
    below = np.nextafter(half, np.float32(0))
    x = np.array([half, -half, 1.5, -1.5, 2.5, below, -below], np.float32)
    got = tfp.quantize(t(x) / 8, 4, 3).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfp.quantize(
        jnp.asarray(x) / 8, 4, 3)))
    np.testing.assert_array_equal(got[:5], [1, -1, 2, -2, 3])


def test_stochastic_rounding_on_grid_and_unbiased():
    """The reference's property test: on the grid, within one step of the
    input, unbiased (mean of 20000 draws of 0.3 on a 0.25 grid)."""
    g = torch.Generator().manual_seed(0)
    x = torch.full((20000,), 0.3)
    y = tfp.fake_quant(x, 4, 2, rounding="stochastic", generator=g)
    assert abs(float(y.mean()) - 0.3) < 5e-3
    jy = jfp.fake_quant(jnp.full((20000,), 0.3), 4, 2, rounding="stochastic",
                        key=jax.random.PRNGKey(0))
    assert abs(float(jy.mean()) - 0.3) < 5e-3
    r = np.random.default_rng(1).normal(0, 2, 5000).astype(np.float32)
    q = tfp.quantize(t(r), 3, 4, rounding="stochastic", generator=g)
    assert torch.equal(q, torch.round(q))
    s = torch.clamp(t(r) * 16, -64, 63)
    assert bool(((q - s).abs() < 1).all())
    with pytest.raises(ValueError, match="Generator"):
        tfp.quantize(t(r), 3, 4, rounding="stochastic")


def test_subnormal_inputs_are_kept():
    """A known difference, not a fault: XLA on the CPU flushes float32
    subnormals to zero, so the reference floors -3e-39 to -0; the port
    keeps IEEE subnormals (as the card does without fast math) and floors
    it to -1. Normal inputs agree exactly (the tests above)."""
    x = np.array([3e-39, -3e-39], np.float32)
    got = tfp.quantize(t(x), 1, 0, rounding="floor").numpy()
    np.testing.assert_array_equal(got, [0.0, -1.0])
    want = np.asarray(jfp.quantize(jnp.asarray(x), 1, 0, rounding="floor"))
    np.testing.assert_array_equal(want, [0.0, 0.0])
    np.testing.assert_array_equal(tfp.quantize(t(x), 1, 0).numpy(),
                                  np.asarray(jfp.quantize(jnp.asarray(x), 1,
                                                          0)))


@pytest.mark.parametrize("i,f", [(4, 3), (2, 6), (1, 0)])
def test_ste_gradient_matches_reference(i, f):
    x = _inputs(7, f, n=80)
    x = x[np.isfinite(x)]
    xt = t(x).requires_grad_(True)
    y = tfp.fake_quant_ste(xt, i, f)
    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    (y * t(w)).sum().backward()
    jg = jax.grad(lambda v: (jfp.fake_quant_ste(v, i, f) * w).sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(jfp.fake_quant(jnp.asarray(x), i, f)))


def test_quantization_error_and_required_int_bits():
    x = np.random.default_rng(3).normal(0, 3, 1000).astype(np.float32)
    for i, f in ((2, 6), (4, 4), (1, 3)):
        np.testing.assert_allclose(
            float(tfp.quantization_error(t(x), i, f)),
            float(jfp.quantization_error(jnp.asarray(x), i, f)), rtol=1e-6)
    m = np.array([0.0, 1e-9, 0.3, 0.5, 1.0, 1.5, 2.0, 3.9, 4.0, 1000.0],
                 np.float32)
    np.testing.assert_array_equal(tfp.required_int_bits(t(m)).numpy(),
                                  np.asarray(jfp.required_int_bits(m)))


@pytest.mark.parametrize("i,f,pack", [(2, 6, False), (1, 3, True),
                                      (4, 4, True), (1, 2, True),
                                      (8, 8, False), (8, 8, True),
                                      (12, 10, False)])
def test_quantized_tensor_matches_reference(i, f, pack):
    """Stored grid bytes, container, footprint and dequantized values equal
    the reference's, with a ragged last dim (packing pads it)."""
    x = np.random.default_rng(i * 10 + f).normal(0, 2, (3, 5, 37)).astype(
        np.float32)
    a = tqt.QuantizedTensor.from_float(t(x), i, f, pack=pack)
    b = jqt.QuantizedTensor.from_float(jnp.asarray(x), i, f, pack=pack)
    assert a.packed == b.packed and a.shape == b.shape
    assert _CONTAINERS[a.data.dtype] == b.data.dtype
    np.testing.assert_array_equal(a.data.numpy(), np.asarray(b.data))
    assert a.nbytes == b.nbytes
    assert a.footprint_ratio == b.footprint_ratio
    np.testing.assert_array_equal(a.dequantize().numpy(),
                                  np.asarray(b.dequantize()))
    assert a.dequantize(torch.bfloat16).dtype == torch.bfloat16
    if not pack:
        return
    with pytest.raises(ValueError):
        tqt.QuantizedTensor.from_float(t(x), 12, 10, pack=True)


def _policies(names):
    fmt = tfp.FixedPointFormat
    yield tpol.PrecisionPolicy.uniform(names, fmt(1, 3), fmt(2, 6))
    yield tpol.PrecisionPolicy(tuple(names), tuple(
        tpol.LayerPolicy(w, None) for w in
        (fmt(2, 6), fmt(1, 5), None, fmt(3, 4))))
    yield tpol.PrecisionPolicy.uniform(names, None, None)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_quantize_param_tree_matches_reference(which):
    """qwen2-72b smoke weights carried by params_from_numpy: each layer's
    grid equals the reference tree's slice for that layer (packed at Q1.3
    and the Q2.6 default, int16 at the mixed policy's Q3.6), and the other
    leaves pass through unchanged."""
    jcfg, tcfg, jparams, tree = perturbed_jax_params("qwen2-72b")
    model = torch_model(tree, tcfg)
    names = tapply.transformer_layer_names(tcfg)
    tp = list(_policies(names))[which]
    jp = jpol.PrecisionPolicy.from_json(tp.to_json())
    got = tapply.quantize_param_tree(model, tp)
    want = japply.quantize_param_tree(jparams, jp, jcfg)
    np.testing.assert_array_equal(got["embed"]["table"].numpy(),
                                  np.asarray(want["embed"]["table"]))
    seg = want["segments"][0][0]
    for li, layer in enumerate(got["layers"]):
        for group in ("mixer", "ffn", "norm1", "norm2"):
            assert set(layer[group]) == set(seg[group])
            for name, leaf in layer[group].items():
                ref = seg[group][name]
                if isinstance(ref, jqt.QuantizedTensor):
                    assert isinstance(leaf, tqt.QuantizedTensor)
                    assert (leaf.int_bits, leaf.frac_bits, leaf.packed) == \
                        (ref.int_bits, ref.frac_bits, ref.packed)
                    assert leaf.shape == tuple(ref.shape[1:])
                    np.testing.assert_array_equal(
                        leaf.data.numpy(), np.asarray(ref.data[li]))
                else:
                    np.testing.assert_array_equal(leaf.numpy(),
                                                  np.asarray(ref[li]))
    with pytest.raises(ValueError, match="layers"):
        tapply.quantize_param_tree(model, tpol.PrecisionPolicy.uniform(
            names[:2], None, None))

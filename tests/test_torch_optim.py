"""The port's optimizers (``repro_torch.optim``) against the reference's
``repro.optim``: the reference's own unit cases, then AdamW, gradient
compression and the schedules fed the same inputs on both sides.

Adam turns a sign into a step (at step 1, delta ~ sign(g)), so parity is
held on shared gradients made with numpy, never on gradients each package
computes: float32 parameters and moments within 1e-6, int8 moment grids
equal except one grid step at a counted rounding tie."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.compress import (CompressionConfig,
                                        compress_gradients,
                                        error_feedback_init,
                                        quantized_allreduce)
from repro_torch.optim.schedule import (constant_lr, cosine_warmup,
                                        linear_warmup)

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

TIGHT = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the reference's own cases (tests/test_optim.py), on the port
# ---------------------------------------------------------------------------
def _quadratic_problem():
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros(3, requires_grad=True),
              "m": torch.ones((2, 3), requires_grad=True)}

    def loss(p):
        return torch.sum((p["w"] - target) ** 2) + torch.sum(p["m"] ** 2) * 0.1

    return params, loss, target


@pytest.mark.parametrize("quantized", [False, True])
def test_adamw_converges_on_quadratic(quantized):
    cfg = AdamWConfig(weight_decay=0.0, quantize_moments=quantized)
    params, loss, target = _quadratic_problem()
    state = adamw_init(params, cfg)
    for _ in range(400):
        grads = torch.autograd.grad(loss(params), list(params.values()))
        adamw_update(params, dict(zip(params, grads)), state, 0.05, cfg)
    np.testing.assert_allclose(params["w"].detach().numpy(), target.numpy(),
                               atol=0.05)
    assert float(params["m"].detach().abs().max()) < 0.05


def test_quantized_moments_are_int8():
    cfg = AdamWConfig(quantize_moments=True)
    state = adamw_init({"w": torch.ones((4, 8))}, cfg)
    assert state["m"]["w"]["q"].dtype == torch.int8
    assert state["v"]["w"]["q"].dtype == torch.int8
    # footprint: int8 q + one float32 scale per row
    assert state["m"]["w"]["q"].numel() == 32
    assert state["m"]["w"]["scale"].numel() == 4
    # a 1-D leaf has a single scale
    assert adamw_init({"b": torch.ones(8)}, cfg)["m"]["b"]["scale"].shape \
        == (1,)


def test_grad_clipping():
    cfg = AdamWConfig(grad_clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    state = adamw_init(params, cfg)
    _, _, metrics = adamw_update(params, {"w": torch.full((4,), 100.0)},
                                 state, 0.1, cfg)
    assert float(metrics["grad_norm"]) > 100
    assert float(metrics["clip"]) < 0.01


def test_schedules():
    f = linear_warmup(1.0, 10)
    assert float(f(0)) == pytest.approx(0.1)
    assert float(f(9)) == pytest.approx(1.0)
    g = cosine_warmup(1.0, 10, 110, final_frac=0.1)
    assert float(g(109)) == pytest.approx(0.1, abs=0.02)
    assert float(constant_lr(0.3)(5)) == pytest.approx(0.3)


def test_compress_gradients_error_feedback():
    cfg = CompressionConfig(bits=8, error_feedback=True)
    grads = {"w": torch.tensor([0.001, 1.0, -0.5, 0.3])}
    acc = torch.zeros(4)
    res = error_feedback_init(grads)
    for _ in range(64):
        c, res = compress_gradients(grads, res, cfg)
        acc = acc + c["w"]
    np.testing.assert_allclose((acc / 64).numpy(), grads["w"].numpy(),
                               atol=2e-3)


def test_compress_bits_reduce_error_monotonically():
    g = {"w": torch.from_numpy(
        np.random.default_rng(0).normal(size=256).astype(np.float32))}
    errs = []
    for bits in (4, 8, 16):
        c, _ = compress_gradients(g, error_feedback_init(g),
                                  CompressionConfig(bits=bits,
                                                    error_feedback=False))
        errs.append(float((c["w"] - g["w"]).abs().max()))
    assert errs[0] > errs[1] > errs[2]


def test_quantized_allreduce_is_not_ported():
    """The name predates the port of the ring (its multi-rank parity is
    ``tests/test_torch_dist_train.py``'s): outside an active plan, or
    over an axis its mesh lacks, it raises; over an axis of one rank it
    returns its input, as the reference's does."""
    from repro_torch.parallel.hints import activation_hints
    from repro_torch.parallel.sharding import AbstractMesh, plan_for_mesh
    x = torch.arange(4, dtype=torch.float32)
    with pytest.raises(ValueError, match="needs an active plan"):
        quantized_allreduce(x, "data")
    plan = plan_for_mesh(AbstractMesh((1, 2), ("data", "model")))
    with activation_hints(plan):
        assert quantized_allreduce(x, "data") is x
        with pytest.raises(ValueError, match="'pod'"):
            quantized_allreduce(x, "pod")


# ---------------------------------------------------------------------------
# parity on shared inputs
# ---------------------------------------------------------------------------
SHAPES = {"embed": (24, 16), "norm": (16,), "wq": (16, 12),
          "experts": (3, 16, 8), "bias": (12,)}


def _leaves(rng, scale=1.0):
    return {n: (rng.normal(size=s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _grads(rng, step):
    """Gradients with a spread of magnitudes, some tiny and some zero."""
    g = _leaves(rng, 0.05 * (step + 1))
    g["wq"][0] = 0.0
    g["embed"][3] *= 1e-6
    return g


def _tie_flips(got, want, scaled):
    """int8 grids that may differ by one step where the port's pre-round
    value sits at a rounding tie; returns the count of such flips."""
    diff = got.astype(np.int64) - want.astype(np.int64)
    tie = np.abs(np.abs(scaled % 1.0) - 0.5) < 1e-3
    bad = (np.abs(diff) > 1) | ((diff != 0) & ~tie)
    assert not bad.any(), (int(bad.sum()), diff[bad][:8])
    return int((diff != 0).sum())


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("decay", ["rank", "set"])
def test_adamw_matches_reference_on_shared_gradients(quantized, decay):
    """Four AdamW steps of both packages from the same parameters and the
    same gradients (clipping active on the later steps): parameters
    within 1e-6 each step; float32 moments within 1e-6; int8 moment grids
    equal except counted one-step flips at rounding ties, their scales
    within 1e-6. ``decay`` "set" decays the named leaves (the trainer's
    stacked-leaf rule): the reference is given the same leaves at rank
    2 by a leading axis of one."""
    rng = np.random.default_rng(3)
    p0 = _leaves(rng)
    cfg = AdamWConfig(quantize_moments=quantized)
    jcfg = jadamw.AdamWConfig(quantize_moments=quantized)
    names = set(SHAPES)
    if decay == "set":
        names = {"embed", "wq", "experts", "norm"}  # "norm" decayed at 1-D
    lift = (lambda n, a: a[None] if n in names and a.ndim == 1
            else a) if decay == "set" else (lambda n, a: a)
    tp = {n: _t(a) for n, a in p0.items()}
    jp = {n: jnp.asarray(lift(n, a)) for n, a in p0.items()}
    ts, js = adamw_init(tp, cfg), jadamw.adamw_init(jp, jcfg)
    jstep = jax.jit(lambda p, g, s: jadamw.adamw_update(p, g, s, 1e-2, jcfg))
    flips = 0
    for step in range(4):
        g = _grads(rng, step)
        jp, js, jm = jstep(jp, {n: jnp.asarray(lift(n, a))
                                for n, a in g.items()}, js)
        _, ts, tm = adamw_update(tp, {n: _t(a) for n, a in g.items()}, ts,
                                 1e-2, cfg,
                                 decay=None if decay == "rank" else names)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["clip"]) == pytest.approx(float(jm["clip"]),
                                                  rel=1e-6)
        for n in SHAPES:
            want = np.asarray(jp[n]).reshape(SHAPES[n])
            np.testing.assert_allclose(tp[n].numpy(), want, **TIGHT)
            for k in ("m", "v"):
                tw, jw = ts[k][n], js[k][n]
                if not quantized:
                    np.testing.assert_allclose(
                        tw.numpy(), np.asarray(jw).reshape(SHAPES[n]),
                        **TIGHT)
                    continue
                sc = np.asarray(jw["scale"]).reshape(tw["scale"].shape)
                np.testing.assert_allclose(tw["scale"].numpy(), sc, **TIGHT)
                # the reference's pre-round value, on its own grid
                m = jnp.asarray(jw["q"], jnp.float32) * jw["scale"]
                flips += _tie_flips(
                    tw["q"].numpy(), np.asarray(jw["q"]).reshape(
                        tw["q"].shape), np.asarray(m / jw["scale"])
                    .reshape(tw["q"].shape))
    assert int(ts["step"]) == int(js["step"]) == 4
    assert flips <= 4, flips


def test_adamw_row_blocks_change_no_value(monkeypatch):
    """A leaf updated in row blocks (``ROW_BLOCK`` cut to 2 rows) equals
    the leaf updated whole, int8 moments included."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(5)
    p0, g = _leaves(rng), _grads(rng, 0)
    out = []
    for block in (1 << 24, 2 * 16):
        monkeypatch.setattr(adamw, "ROW_BLOCK", block)
        cfg = AdamWConfig(quantize_moments=True)
        tp = {n: _t(a) for n, a in p0.items()}
        st = adamw_init(tp, cfg)
        for _ in range(2):
            adamw_update(tp, {n: _t(a) for n, a in g.items()}, st, 1e-2, cfg)
        out.append((tp, st))
    (pa, sa), (pb, sb) = out
    for n in SHAPES:
        assert torch.equal(pa[n], pb[n])
        for k in ("m", "v"):
            assert torch.equal(sa[k][n]["q"], sb[k][n]["q"])
            assert torch.equal(sa[k][n]["scale"], sb[k][n]["scale"])


def test_missing_gradients_count_as_zeros():
    cfg = AdamWConfig()
    rng = np.random.default_rng(0)
    p0 = _leaves(rng)
    a = {n: _t(x) for n, x in p0.items()}
    b = {n: _t(x) for n, x in p0.items()}
    g = {n: _t(x) for n, x in _grads(rng, 0).items()}
    ga = dict(g, bias=None)
    gb = dict(g, bias=torch.zeros(SHAPES["bias"]))
    adamw_update(a, ga, adamw_init(a, cfg), 1e-2, cfg)
    adamw_update(b, gb, adamw_init(b, cfg), 1e-2, cfg)
    for n in SHAPES:
        assert torch.equal(a[n], b[n])


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("feedback", [True, False])
def test_compression_matches_reference_exactly(bits, feedback):
    """Three steps of ``compress_gradients`` on shared gradients: the
    compressed gradients (on the int grid) and the residuals equal the
    reference's exactly."""
    rng = np.random.default_rng(bits)
    cfg = CompressionConfig(bits=bits, error_feedback=feedback)
    jcfg = jcompress.CompressionConfig(bits=bits, error_feedback=feedback)
    g0 = _leaves(rng)
    tr = error_feedback_init({n: _t(a) for n, a in g0.items()})
    jr = jcompress.error_feedback_init({n: jnp.asarray(a)
                                        for n, a in g0.items()})
    for step in range(3):
        g = _grads(rng, step)
        tc, tr = compress_gradients({n: _t(a) for n, a in g.items()}, tr,
                                    cfg)
        jc, jr = jcompress.compress_gradients(
            {n: jnp.asarray(a) for n, a in g.items()}, jr, jcfg)
        for n in SHAPES:
            np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))
            np.testing.assert_array_equal(tr[n].numpy(), np.asarray(jr[n]))


def test_compressed_gradient_keeps_the_gradient_dtype():
    g = {"w": torch.randn(8, 4, dtype=torch.bfloat16)}
    c, r = compress_gradients(g, error_feedback_init(g), CompressionConfig())
    assert c["w"].dtype == torch.bfloat16 and r["w"].dtype == torch.float32


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    leaves = _leaves(rng)
    want = float(jadamw._global_norm({n: jnp.asarray(a)
                                      for n, a in leaves.items()}))
    got = float(global_norm([_t(a) for a in leaves.values()]))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name,args", [
    ("constant_lr", (3e-4,)), ("linear_warmup", (3e-4, 7)),
    ("cosine_warmup", (3e-4, 5, 20)), ("cosine_warmup", (1e-3, 20, 20)),
    ("cosine_warmup", (1.0, 10, 110))])
def test_schedules_match_reference(name, args):
    """Every step of the schedule within 1e-6 relative of the reference's
    (a few float32 ULPs: XLA's and numpy's cos round apart, and XLA may
    fuse the products); each is float32."""
    got_f = globals()[name](*args)
    want_f = getattr(jschedule, name)(*args)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for s in range(0, 30):
            got = got_f(s)
            assert got.dtype == np.float32
            want = np.float32(want_f(jnp.int32(s)))
            assert float(got) == pytest.approx(float(want), rel=1e-6), \
                (s, got, want)

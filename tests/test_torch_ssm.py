"""Port parity, the recurrent mixers: ``models.ssm`` against the
reference's ``repro.models.ssm`` on the reference's init (biases, skips
and norm scales redrawn from a numpy seed) and numpy-seeded inputs, in
float32 —

* ``mamba_apply``, ``mlstm_apply`` and ``slstm_apply`` from the initial
  state and from a given state, at S = chunk, 2 chunks and 1: outputs and
  new states within 1e-4; with the Mamba and mLSTM states on a Q(I,F)
  grid, the states equal but for one grid step at a float rounding tie;
* inside the port, a chunked run equals the same tokens fed one at a
  time through the returned states, within 1e-4;
* the state fake-quant equals the reference's exactly on equal inputs,
  ties (half to even) and clipping included;
* the chunk-length refusal uses the reference's words, and the initial
  states (the sLSTM stabilizer at -1e30) equal the reference's;
* the exact softplus (a parity trap: ``F.softplus`` switches to x past
  its threshold)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (JAX on the CPU, one torch thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jsmoke  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
XLSTM, JAMBA = "xlstm-350m", "jamba-v0.1-52b"
ARCH = {"mamba": JAMBA, "mlstm": XLSTM, "slstm": XLSTM}
_J = {"mamba": (jssm.init_mamba, jssm.mamba_apply, jssm.init_mamba_state),
      "mlstm": (jssm.init_mlstm, jssm.mlstm_apply, jssm.init_mlstm_state),
      "slstm": (jssm.init_slstm, jssm.slstm_apply, jssm.init_slstm_state)}
# the fields the reference's init leaves at constants, redrawn here
_REDRAW = {"conv_b": (0.0, 0.5), "dt_bias": (0.0, 0.5), "D_skip": (1.0, 0.3),
           "f_bias": (2.0, 1.0), "b": (0.0, 0.5)}


def _pair(kind, seed=0):
    """(jax cfg, port cfg, reference params, port module)."""
    jcfg, tcfg = jsmoke(ARCH[kind]), get_smoke_config(ARCH[kind])
    tree = jax.tree_util.tree_map(
        np.asarray, _J[kind][0](jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    for name, (mean, std) in _REDRAW.items():
        if name in tree:
            tree[name] = rng.normal(mean, std,
                                    tree[name].shape).astype(np.float32)
    tree["norm"]["scale"] = rng.uniform(
        0.5, 1.5, tree["norm"]["scale"].shape).astype(np.float32)
    mod = tssm.MIXERS[kind].module(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        for name, p in mod.named_parameters():
            src = tree[name]["scale"] if name == "norm" else tree[name]
            p.copy_(torch.from_numpy(np.array(src, np.float32)))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, mod


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)


def _t_state(state):
    return None if state is None else {
        k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def _states_match(got, want, quant, label):
    """Float states within 1e-4; a state on a grid (``quant``) equal but
    for single grid steps at rounding ties (at most 1% of the values)."""
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        if quant is None or k not in ("ssm", "C"):
            np.testing.assert_allclose(g, w, err_msg=f"{label} {k}", **TOL)
            continue
        step = 2.0 ** -quant[1]
        d = np.abs(g - w)
        flips = d > 1e-6
        assert np.all(np.abs(d[flips] - step) <= 1e-6), (label, k)
        assert flips.mean() <= 0.01, (label, k, int(flips.sum()))


def _given_state(kind, jcfg, B, jparams, seed):
    """A state reached by running the reference over 16 random tokens."""
    _, st = _J[kind][1](jparams, jnp.asarray(_x(jcfg, B, 16, seed)),
                        cfg=jcfg)
    return st


@pytest.mark.parametrize("quant", [None, (4, 12)], ids=["float", "q4.12"])
@pytest.mark.parametrize("start", ["initial", "given"])
@pytest.mark.parametrize("S", [32, 64, 1])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_mixer_matches_reference(kind, S, start, quant):
    jcfg, tcfg, jparams, mod = _pair(kind)
    B = 2
    assert tcfg.ssm_chunk == 32
    x = _x(jcfg, B, S, seed=S)
    state = (_given_state(kind, jcfg, B, jparams, 5) if start == "given"
             else None)
    jy, jst = _J[kind][1](jparams, jnp.asarray(x), cfg=jcfg, state=state,
                          state_quant=quant)
    ty, tst = tssm.MIXERS[kind].apply(mod, torch.from_numpy(x), cfg=tcfg,
                                   state=_t_state(state), state_quant=quant)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert set(tst) == set(jst)
    _states_match(tst, jst, quant, (kind, S, start))


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_chunked_run_equals_token_by_token(kind):
    """Two chunks at once, then the same 64 tokens one at a time through
    the returned states, from a given state."""
    jcfg, tcfg, jparams, mod = _pair(kind, seed=1)
    x = torch.from_numpy(_x(jcfg, 2, 64, seed=9))
    st0 = _t_state(_given_state(kind, jcfg, 2, jparams, 6))
    apply = tssm.MIXERS[kind].apply
    y, st = apply(mod, x, cfg=tcfg, state=st0)
    ys, s = [], st0
    for i in range(64):
        yi, s = apply(mod, x[:, i:i + 1], cfg=tcfg, state=s)
        ys.append(yi)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(), **TOL)
    for k in st:
        np.testing.assert_allclose(s[k].numpy(), st[k].numpy(), **TOL)


def test_state_fake_quant_equals_reference_exactly():
    """Equal inputs, equal grids: values at every half-step tie round half
    to even (torch.round, as jnp.round; the fixed-point module's own
    rounding goes half away), and out-of-range values clip."""
    rng = np.random.default_rng(0)
    for fmt in [(2, 6), (4, 12), (1, 3)]:
        step = 2.0 ** -fmt[1]
        ties = (np.arange(-300, 300) + 0.5) * step
        x = np.concatenate([ties, rng.normal(0, 3, 4096)]).astype(np.float32)
        got = tssm._maybe_fake_quant(torch.from_numpy(x), fmt).numpy()
        want = np.asarray(jssm._maybe_fake_quant(jnp.asarray(x), fmt))
        np.testing.assert_array_equal(got, want)
        k = np.round(ties / step)
        assert np.all(k % 2 == 0)          # numpy's round is half to even
    x = torch.tensor([0.5 * 2.0 ** -6, 1.5 * 2.0 ** -6])
    assert tssm._maybe_fake_quant(x, (2, 6)).tolist() == [0.0, 2 * 2.0 ** -6]
    assert tssm._maybe_fake_quant(x, None) is x


@pytest.mark.parametrize("kind,words", [("mamba", "ssm chunk"),
                                        ("mlstm", "chunk")])
def test_chunk_refusal_uses_the_reference_words(kind, words):
    jcfg, tcfg, jparams, mod = _pair(kind)
    x = _x(jcfg, 1, 40, seed=0)
    with pytest.raises(ValueError) as ref:
        _J[kind][1](jparams, jnp.asarray(x), cfg=jcfg)
    with pytest.raises(ValueError) as port:
        tssm.MIXERS[kind].apply(mod, torch.from_numpy(x), cfg=tcfg)
    assert str(port.value) == str(ref.value) == \
        f"seq 40 not divisible by {words} 32"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_initial_states_equal_reference(kind, dtype):
    """Shapes, dtypes and values: Mamba's conv window in the compute
    dtype, every other state float32; the sLSTM stabilizer at -1e30."""
    jcfg = dataclasses.replace(jsmoke(ARCH[kind]), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH[kind]), dtype=dtype)
    want = _J[kind][2](3, jcfg, jcfg.compute_jnp_dtype)
    got = tssm.MIXERS[kind].init_state(3, tcfg, tcfg.torch_dtype, "cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).split(".")[-1] == str(w.dtype), k
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    if kind == "slstm":
        assert float(got["m"].max()) == np.float32(-1e30)


def test_exact_softplus():
    """``logaddexp(x, 0)`` as ``jax.nn.softplus`` at every x (float32)."""
    x = np.linspace(-60, 60, 4801, dtype=np.float32)
    got = tssm._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=2e-7, atol=0)
    np.testing.assert_allclose(
        tssm._log_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.log_sigmoid(x)), rtol=2e-7, atol=1e-30)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_init_distributions(kind):
    """The port's init: the reference's shapes and dtypes, A_log its
    linspace, constant leaves at the reference's constants, and the drawn
    weights at the reference's scales."""
    jcfg, tcfg = jsmoke(ARCH[kind]), get_smoke_config(ARCH[kind])
    want = _J[kind][0](jax.random.PRNGKey(0), jcfg)
    mod = tssm.MIXERS[kind].module(tcfg, torch.float32, "cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        tssm.MIXERS[kind].init(mod, g)
    for name, p in mod.named_parameters():
        w = np.asarray(want[name]["scale"] if name == "norm" else want[name])
        assert tuple(p.shape) == w.shape, name
        if p.dim() == 1:
            np.testing.assert_allclose(p.numpy(), w, rtol=1e-6, atol=0,
                                       err_msg=name)
        else:
            # sample stds of n draws differ by ~1/sqrt(2n) relatively
            rel = 0.05 + 4.0 / np.sqrt(2 * w.size)
            assert abs(float(p.std()) - float(w.std())) <= rel * float(
                w.std()), name

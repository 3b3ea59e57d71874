"""Port parity, the recurrent mixers under autograd: ``models.ssm``'s
``mamba_apply``, ``mlstm_apply`` and ``slstm_apply`` against the
reference's ``jax.grad`` at the smoke widths, in float32, on the
reference's init (biases, skips and norm scales redrawn from a numpy
seed) and numpy-seeded inputs —

* each mixer from the initial state and from a given state, at S = 2
  chunks: the loss (its output and its returned state, each weighted by
  a fixed numpy draw) within 1e-5, and the gradient of every parameter,
  of the input and of the given state within 1e-4 of the leaf's largest
  magnitude;
* C8: under a KV format the reference's state grid (``jnp.round``, whose
  derivative is 0) stops the gradient at every chunk boundary, so the
  gradient through the state across a boundary is exactly 0; the port's
  grid is straight-through, and it equals the reference with the
  reference's ``ssm._maybe_fake_quant`` replaced (by this test) with a
  straight-through version of itself;
* the straight-through grid's forward is the plain grid bit for bit,
  with and without autograd (no served value moves)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (JAX on the CPU, one torch thread)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import ref_state_grid_ste  # noqa: E402
from test_torch_ssm import _J, _given_state, _pair, _x  # noqa: E402

from repro.core.fixedpoint import format_params as jformat  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

B, S = 2, 64                    # two chunks of the smoke configs' 32
KV8 = (2, 6)                    # the KV format of --kv-bits 8: Q2.6
GRID = {"mamba": "ssm", "mlstm": "C"}   # the state each grid holds


def _weights(shapes, seed):
    """Fixed numpy weights for the loss: one per output leaf."""
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 1, s).astype(np.float32)
            for k, s in shapes.items()}


def _ref_grads(kind, jparams, jcfg, x, state, quant, wy, ws):
    """(loss, grads of params, of x, of the state or None)."""
    apply = _J[kind][1]

    def loss(p, u, st):
        y, new = apply(p, u, cfg=jcfg, state=st, state_quant=quant)
        out = jnp.sum(y * wy)
        for k, w in ws.items():
            out = out + jnp.sum(new[k] * w)
        return out

    args = (jparams, jnp.asarray(x),
            None if state is None else {k: jnp.asarray(v)
                                        for k, v in state.items()})
    argnums = (0, 1) if state is None else (0, 1, 2)
    val, grads = jax.jit(jax.value_and_grad(loss, argnums=argnums))(*args)
    grads = [jax.tree_util.tree_map(np.asarray, g) for g in grads]
    return float(val), grads[0], grads[1], (grads[2] if state else None)


def _port_grads(kind, mod, tcfg, x, state, quant, wy, ws):
    for p in mod.parameters():
        p.requires_grad_(True)
        p.grad = None
    u = torch.from_numpy(x).requires_grad_(True)
    st = None if state is None else {
        k: torch.from_numpy(np.array(v)).requires_grad_(True)
        for k, v in state.items()}
    y, new = tssm.MIXERS[kind].apply(mod, u, cfg=tcfg, state=st,
                                     state_quant=quant)
    loss = (y * torch.from_numpy(wy)).sum()
    for k, w in ws.items():
        loss = loss + (new[k] * torch.from_numpy(w)).sum()
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in mod.named_parameters()}
    return (float(loss.detach()), grads, u.grad.numpy(),
            None if st is None else {k: v.grad.numpy()
                                     for k, v in st.items()})


def _close(got, want, label, tol=1e-4):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, (label, err, scale)


def _parity(kind, start, quant, seed=0):
    jcfg, tcfg, jparams, mod = _pair(kind, seed)
    x = _x(jcfg, B, S, seed=S + seed)
    state = (jax.tree_util.tree_map(np.asarray, _given_state(
        kind, jcfg, B, jparams, 5)) if start == "given" else None)
    y0, st0 = _J[kind][1](jparams, jnp.asarray(x), cfg=jcfg)
    wy = _weights({"y": y0.shape}, seed + 11)["y"]
    ws = _weights({k: v.shape for k, v in st0.items()}, seed + 12)
    ref = _ref_grads(kind, jparams, jcfg, x, state, quant, wy, ws)
    got = _port_grads(kind, mod, tcfg, x, state, quant, wy, ws)
    assert got[0] == pytest.approx(ref[0], rel=1e-5)
    for name, g in got[1].items():
        want = ref[1][name]["scale"] if name == "norm" else ref[1][name]
        _close(g, want, (kind, start, name))
    _close(got[2], ref[2], (kind, start, "input"))
    if state is not None:
        assert set(got[3]) == set(ref[3])
        for k, g in got[3].items():
            _close(g, ref[3][k], (kind, start, "state", k))


@pytest.mark.parametrize("start", ["initial", "given"])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_mixer_gradients_match_reference(kind, start):
    """Float states: the loss within 1e-5; every parameter's, the
    input's and the given state's gradient within 1e-4 of its largest
    magnitude."""
    _parity(kind, start, None)


# ---------------------------------------------------------------------------
# C8: the state grid's derivative
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_c8_reference_state_gradient_stops_at_the_chunk_boundary(kind):
    """The fault: from a given state under Q2.6, the gradient of the
    second chunk's outputs with respect to the given state's grid leaf
    reaches them only through the state at the boundary, and the
    reference's is exactly 0 there (nonzero with float states); the
    port's is nonzero."""
    jcfg, tcfg, jparams, mod = _pair(kind)
    x = _x(jcfg, B, S, seed=3)
    state = jax.tree_util.tree_map(np.asarray, _given_state(
        kind, jcfg, B, jparams, 5))
    Lc = jcfg.ssm_chunk
    leaf = GRID[kind]

    def ref(quant):
        def loss(st):
            y, _ = _J[kind][1](jparams, jnp.asarray(x), cfg=jcfg, state=st,
                               state_quant=quant)
            return jnp.sum(y[:, Lc:])
        return np.asarray(jax.grad(loss)(
            {k: jnp.asarray(v) for k, v in state.items()})[leaf])

    assert not ref(KV8).any()
    assert np.abs(ref(None)).max() > 0
    st = {k: torch.from_numpy(np.array(v)).requires_grad_(k == leaf)
          for k, v in state.items()}
    y, _ = tssm.MIXERS[kind].apply(mod, torch.from_numpy(x), cfg=tcfg,
                                   state=st, state_quant=KV8)
    y[:, Lc:].sum().backward()
    assert float(st[leaf].grad.abs().max()) > 0


@pytest.mark.parametrize("start", ["initial", "given"])
@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_c8_port_gradients_equal_the_reference_with_ste(kind, start,
                                                        monkeypatch):
    """With the reference's ``ssm._maybe_fake_quant`` replaced by a
    straight-through version of itself (by this test, not the package),
    the reference's loss and every gradient equal the port's under Q2.6
    within the stated tolerances."""
    monkeypatch.setattr(jssm, "_maybe_fake_quant", ref_state_grid_ste)
    _parity(kind, start, KV8)


def test_state_grid_forward_is_bit_for_bit():
    """Under autograd the straight-through grid returns the plain grid's
    values exactly (ties half to even, clipping), which equal the
    reference's; its gradient is 1 inside the range and 0 where it
    clips."""
    rng = np.random.default_rng(0)
    for fmt in [KV8, (4, 12)]:
        step = 2.0 ** -fmt[1]
        ties = (np.arange(-400, 400) + 0.5) * step
        x = np.concatenate([ties, rng.normal(0, 3, 4096)]).astype(np.float32)
        plain = tssm._maybe_fake_quant(torch.from_numpy(x), fmt)
        xg = torch.from_numpy(x).requires_grad_(True)
        ste = tssm._maybe_fake_quant(xg, fmt)
        assert ste.requires_grad
        assert torch.equal(ste.detach(), plain)
        np.testing.assert_array_equal(
            plain.numpy(), np.asarray(jssm._maybe_fake_quant(
                jnp.asarray(x), fmt)))
        ste.sum().backward()
        scale, qmin, qmax = jformat(*fmt)
        inside = (x * scale >= qmin) & (x * scale <= qmax)
        assert inside.any() and not inside.all()
        np.testing.assert_array_equal(xg.grad.numpy(),
                                      inside.astype(np.float32))

"""Port parity, the dense decoder's entry points and the paper's per-layer
fake-quant: on the qwen2-72b smoke config with the JAX init converted by
``params_from_numpy``, the port's ``prefill`` into dense caches,
``decode_step`` (scalar and per-row positions), the cache-free forward
(both ``attend_full`` and the chunked online softmax) and the forward
with weight and residual-stream fake-quant give the reference's logits
within 1e-4 (float32). Also the parity traps of this slice: the dense
store rounds half to even, ``fake_quant`` half away from zero and keeps
the input dtype, and layers without a format are still fake-quantized on
the Q16.14 sentinel grid."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (perturbed_jax_params, quantized_blocks_match,  # noqa: E402,E501
                           t, torch_model)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.fixedpoint import FixedPointFormat as JFormat  # noqa: E402
from repro.core.fixedpoint import fake_quant as jfake_quant  # noqa: E402
from repro.core.policy import LayerPolicy as JLayer  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.launch.steps import make_prefill_step as jmake_prefill  # noqa: E402,E501
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.quant.apply import build_model_quant as jbuild  # noqa: E402
from repro_torch.core.fixedpoint import FixedPointFormat  # noqa: E402
from repro_torch.core.fixedpoint import fake_quant  # noqa: E402
from repro_torch.core.policy import LayerPolicy, PrecisionPolicy  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.quant.apply import build_model_quant  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = [f"layer_{i:03d}" for i in range(4)]


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg, jparams, tree = perturbed_jax_params("qwen2-72b", seed=3)
    return jcfg, tcfg, jparams, torch_model(tree, tcfg)


def _policies(w, d, *, enabled=range(4)):
    """The same policy in both packages: layers in ``enabled`` get the
    (I, F) formats ``w`` / ``d`` (None: no format), the others none."""
    def mk(fmt_cls, layer_cls, policy_cls):
        fw = fmt_cls(*w) if w else None
        fd = fmt_cls(*d) if d else None
        return policy_cls(tuple(NAMES), tuple(
            layer_cls(fw, fd) if i in enabled else layer_cls(None, None)
            for i in range(4)))
    return (mk(FixedPointFormat, LayerPolicy, PrecisionPolicy),
            mk(JFormat, JLayer, JPolicy))


def _quants(jcfg, tcfg, w=None, d=None, *, kv=True, acts=False,
            enabled=range(4)):
    tp, jp = _policies(w, d, enabled=enabled)
    return (build_model_quant(tp, tcfg, quantize_kv=kv,
                              quantize_activations=acts),
            jbuild(jp, jcfg, quantize_kv=kv, quantize_activations=acts))


def _tokens(rng, vocab, B, S):
    return rng.integers(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("kv", [None, (2, 6), (4, 4)],
                         ids=["fp", "int8-q2.6", "int8-q4.4"])
def test_prefill_and_decode_match_reference(models, kv):
    """Whole-prompt prefill into fresh dense caches, then decode steps at
    a shared scalar position and at per-row positions."""
    jcfg, tcfg, jparams, model = models
    tq, jq = _quants(jcfg, tcfg, None, kv) if kv else (None, None)
    rng = np.random.default_rng(11)
    tok = _tokens(rng, tcfg.vocab_size, 2, 9)
    tlog, tcaches, tS = ttr.prefill(model, t(tok), tcfg, quant=tq,
                                    max_len=16)
    jlog, jcaches, jS = jtr.prefill(jparams, {"tokens": jnp.asarray(tok)},
                                    jcfg, quant=jq, max_len=16)
    assert tS == jS == 9
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    want = torch.int8 if kv else torch.float32
    assert all(c["k"].dtype == want and c["k"].shape == (2, 16, 2, 8)
               for c in tcaches)
    for step, pos in enumerate([9, np.array([10, 10], np.int32),
                                np.array([11, 11], np.int32)]):
        nxt = _tokens(rng, tcfg.vocab_size, 2, 1)[:, 0]
        tl, tcaches = ttr.decode_step(model, t(nxt), t(pos), tcaches, tcfg,
                                      quant=tq)
        jl, jcaches = jtr.decode_step(jparams, jnp.asarray(nxt),
                                      jnp.asarray(pos), jcaches, jcfg,
                                      quant=jq)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jslabs = [c for c in jcaches[0][0]["k"]]      # (L, B, T, KV, hd)
    for li, c in enumerate(tcaches):
        np.testing.assert_allclose(c["k"][:, :12].to(torch.float32).numpy(),
                                   np.asarray(jslabs[li][:, :12], np.float32),
                                   **TOL)


def test_prefill_step_matches_reference(models):
    jcfg, tcfg, jparams, model = models
    tq, jq = _quants(jcfg, tcfg, None, (2, 6))
    tok = _tokens(np.random.default_rng(5), tcfg.vocab_size, 3, 7)
    tl, tc = make_prefill_step(tcfg, max_len=12, quant=tq)(model, t(tok))
    jl, _ = jmake_prefill(jcfg, max_len=12, quant=jq)(
        jparams, {"tokens": jnp.asarray(tok)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert len(tc) == tcfg.num_layers and tc[0]["k"].shape[:2] == (3, 12)


@pytest.mark.parametrize("S", [12, 72], ids=["full", "chunked"])
def test_cache_free_forward_matches_reference(models, S):
    """No cache: S^2 <= attn_chunk^2 takes ``attend_full``, S = 72 the
    chunked online softmax (72 keys in chunks of 64, the last padded)."""
    jcfg, tcfg, jparams, model = models
    tok = _tokens(np.random.default_rng(S), tcfg.vocab_size, 2, S)
    th, tlog, tc, _ = ttr.forward(model, t(tok), tcfg)
    jh, jlog, jc, _ = jtr.forward(jparams, {"tokens": jnp.asarray(tok)},
                                  jcfg)
    assert tc is None and jc is None
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


_POLICIES = pytest.mark.parametrize("w,d,enabled", [
    ((2, 6), (4, 12), range(4)),
    ((2, 6), None, range(4)),
    (None, (4, 12), range(4)),
    ((2, 6), (4, 12), [1]),
], ids=["w2.6-d4.12", "weights-only", "data-only", "layer1-only"])


@_POLICIES
def test_quantized_blocks_match_reference(models, w, d, enabled):
    """Weight fake-quant of every >= 2-D weight of a block, residual
    fake-quant of the embedding output and of each block's output; a
    policy with one enabled layer still quantizes the others on the
    sentinel grid. Each block gets the reference's own input, so one
    value that the two packages' GEMMs (which differ by float ULPs) put on
    opposite sides of a rounding tie moves one grid step in that block
    only, instead of feeding the next (ROADMAP queue C). Every value agrees
    within 1e-4, except at most 1% of a block's values that differ by
    exactly one grid step (2^-12 = 2.4e-4 at Q4.12); 1-3 of 1280 do."""
    jcfg, tcfg, jparams, model = models
    quantized_blocks_match(jcfg, tcfg, jparams, model,
                           *_quants(jcfg, tcfg, w, d, kv=False, acts=True,
                                    enabled=enabled))


def test_weight_quantized_forward_matches_reference(models):
    """End to end with weight fake-quant on every layer (Q2.6) and the KV
    cache off: the weights land on identical grids, so the forward stays
    within 1e-4 of the reference's through all layers."""
    jcfg, tcfg, jparams, model = models
    tq, jq = _quants(jcfg, tcfg, (2, 6), None, kv=False, acts=True)
    tok = _tokens(np.random.default_rng(9), tcfg.vocab_size, 2, 10)
    th, tlog, _, _ = ttr.forward(model, t(tok), tcfg, quant=tq)
    jh, jlog, _, _ = jtr.forward(jparams, {"tokens": jnp.asarray(tok)},
                                 jcfg, quant=jq)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    plain, _, _, _ = ttr.forward(model, t(tok), tcfg)
    assert not torch.equal(plain, th)      # the quant really ran


def test_residual_quant_replays_exactly(models, monkeypatch):
    """Given the same float inputs, every residual-stream fake-quant the
    port's forward makes (embedding output and each block's output, Q4.12)
    stores exactly what the reference's ``fake_quant`` stores."""
    jcfg, tcfg, _, model = models
    tq, _ = _quants(jcfg, tcfg, (2, 6), (4, 12), kv=False, acts=True)
    seen = []
    real = ttr.fake_quant_ste

    def recording(x, i, f):
        y = real(x, i, f)
        if x.dim() == 3:                   # the residual stream (B, S, D)
            seen.append((x.clone(), y.clone(), i, f))
        return y

    monkeypatch.setattr(ttr, "fake_quant_ste", recording)
    tok = _tokens(np.random.default_rng(9), tcfg.vocab_size, 2, 10)
    ttr.forward(model, t(tok), tcfg, quant=tq)
    assert len(seen) == 1 + tcfg.num_layers
    for x, y, i, f in seen:
        assert (i, f) == (4, 12)
        ref = jfake_quant(jnp.asarray(x.numpy()), i, f)
        np.testing.assert_array_equal(y.numpy(), np.asarray(ref))


def test_quantized_serving_forward_with_dense_cache(models):
    """Weight, residual and KV quant together through prefill + decode."""
    jcfg, tcfg, jparams, model = models
    tq, jq = _quants(jcfg, tcfg, (2, 6), (4, 4), kv=True, acts=True)
    tok = _tokens(np.random.default_rng(2), tcfg.vocab_size, 2, 6)
    tl, tc, _ = ttr.prefill(model, t(tok), tcfg, quant=tq, max_len=10)
    jl, jc, _ = jtr.prefill(jparams, {"tokens": jnp.asarray(tok)}, jcfg,
                            quant=jq, max_len=10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt = np.asarray([3, 200], np.int32)
    tl, _ = ttr.decode_step(model, t(nxt), 6, tc, tcfg, quant=tq)
    jl, _ = jtr.decode_step(jparams, jnp.asarray(nxt), 6, jc, jcfg, quant=jq)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_disabled_layers_use_the_sentinel_grid(models):
    """Trap: ``stacked_arrays`` gives a layer without a format Q16.14, and
    weight quant is on once ANY layer has a format, so a disabled layer's
    weights land on a 2^-14 grid. Small values move; the port moves them
    as the reference does."""
    jcfg, tcfg, _, model = models
    tq, jq = _quants(jcfg, tcfg, (2, 6), (4, 12), kv=False, acts=True,
                     enabled=[0])
    assert tq.layer_weight(2) == (16, 14) and tq.layer_data(3) == (16, 14)
    assert np.asarray(jq.w_int)[2] == 16 and np.asarray(jq.w_frac)[2] == 14
    blk = model.layers[2]
    view = ttr._quant_weights(blk.attn, tq.layer_weight(2))
    assert not torch.equal(view.wq, blk.attn.wq)
    assert torch.equal(view.bq, blk.attn.bq)           # 1-D: untouched
    small = torch.tensor([1.2345e-5, -3.0e-5, 2.0 ** -15, 3 * 2.0 ** -15,
                          0.3], dtype=torch.float32)
    got = fake_quant(small, 16, 14)
    ref = jfake_quant(jnp.asarray(small.numpy()), 16, 14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[0] == 0 and got[2] == 2.0 ** -14 and got[3] == 2.0 ** -13
    for dt in (torch.float32, torch.bfloat16):
        x = small.to(dt)
        assert not torch.equal(fake_quant(x, 16, 14), x)


def test_store_rounds_half_to_even_fake_quant_half_away():
    """Trap: the dense KV store uses ``torch.round`` (half to even, as
    ``jnp.round``); ``fake_quant`` (weights, residual) rounds half away
    from zero. Inputs sit exactly on .5 steps of the grid."""
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, -127.5],
                      np.float32)
    x = (halves / 16.0).astype(np.float32)          # Q4.4 grid: scale 16
    spec = tattn.KVQuantSpec(4, 4, "int8")
    jspec = jattn.KVQuantSpec(4, 4, "int8")
    got = tattn._q_store(torch.from_numpy(x), spec)
    ref = np.asarray(jattn._q_store(jnp.asarray(x), jspec))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(),
                                  [0, 2, 2, 0, -2, -2, 4, 126, -128])
    fq = fake_quant(torch.from_numpy(x), 4, 4)
    np.testing.assert_array_equal(fq.numpy(),
                                  np.asarray(jfake_quant(jnp.asarray(x), 4,
                                                         4)))
    np.testing.assert_array_equal((fq * 16).numpy(),
                                  [1, 2, 3, -1, -2, -3, 4, 127, -128])
    back = tattn._q_load(got, spec, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jattn._q_load(jnp.asarray(ref), jspec,
                                               jnp.float32)))


def test_fake_quant_keeps_the_input_dtype():
    """Trap: bf16 stays bf16 (arithmetic in float32), equal to the
    reference on the same bf16 values."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1.5, 257).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got = fake_quant(xb, 2, 6)
    assert got.dtype == torch.bfloat16
    ref = jfake_quant(jnp.asarray(xb.to(torch.float32).numpy()).astype(
        jnp.bfloat16), 2, 6)
    assert ref.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert torch.equal(fake_quant(got, 2, 6), got)        # on the grid


@pytest.mark.parametrize("pos", [3, [0, 5, 2], [14, 2, 15]],
                         ids=["scalar", "per-row", "clamped"])
def test_seq_update_matches_reference(pos):
    """Dense writes at a scalar or per-row offset; a start past T - S is
    clamped to it, as ``lax.dynamic_update_slice`` does."""
    rng = np.random.default_rng(1)
    buf = rng.normal(size=(3, 16, 2, 4)).astype(np.float32)
    new = rng.normal(size=(3, 2, 2, 4)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    got = tattn.seq_update(torch.from_numpy(buf.copy()),
                           torch.from_numpy(new),
                           int(p) if p.ndim == 0 else torch.from_numpy(p))
    ref = jattn.seq_update(jnp.asarray(buf), jnp.asarray(new),
                           jnp.asarray(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_attend_full_matches_reference():
    rng = np.random.default_rng(8)
    B, S, T, H, KV, hd = 2, 5, 9, 4, 2, 8
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    qpos = (np.arange(S)[None] + np.array([[2], [4]])).astype(np.int32)
    for causal in (True, False):
        got = tattn.attend_full(t(q), t(k), t(v), t(qpos), torch.arange(T),
                                causal=causal)
        ref = jattn.attend_full(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(qpos),
                                jnp.arange(T), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_dense_int4_refused(models):
    """int4 exists only lane-packed in pages: a dense int4 cache raises, as
    in the reference; dense caches need their batch and length."""
    jcfg, tcfg, _, _ = models
    tp, _ = _policies(None, (2, 2))
    q4 = build_model_quant(tp, tcfg, quantize_activations=False,
                           kv_container="int4")
    with pytest.raises(ValueError, match="int4"):
        ttr.init_cache(tcfg, q4, None, "cpu", batch=2, max_len=8)
    with pytest.raises(ValueError, match="max_len"):
        ttr.init_cache(tcfg, None, None, "cpu")

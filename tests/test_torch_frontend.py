"""Port parity, the encoder and VLM families: hubert-xlarge-smoke (a
bidirectional encoder on stub frame embeddings, RMSNorm blocks with a GELU
FFN) and qwen2-vl-2b-smoke (a GQA decoder with QKV bias, tied embeddings
and M-RoPE), on the JAX init converted by ``params_from_numpy``, against
the reference on the same numpy-seeded inputs (1e-4 in float32 unless a
test says otherwise) —

* ``layernorm``, ``apply_mrope`` (random ids, and three equal ids, which
  are ``apply_rope``) and the tanh-form ``gelu_mlp_apply`` (1e-6; the erf
  form misses by more);
* hubert-smoke's forward on embeds through both cache-free attention
  paths (``attend_full`` at S = 64, the non-causal ``attend_chunked`` at
  S = 128), its non-causality, and the encoder's ``make_prefill_step``;
* qwen2-vl-smoke's forward on tokens with and without M-RoPE ids and on
  embeds; ``prefill`` on embeds and ``make_embed_decode_step`` on dense
  float and int8 caches, in lockstep with the reference's caches (a KV
  write may sit one grid step off only at a float rounding tie,
  ``tie_flips``);
* weight and residual fake-quant block by block, ``quantize_param_tree``
  on both trees (the tied head passes through as the embedding), and the
  parameter counts of the full configs;
* ``configs/shapes.py`` against the reference's rules and batch shapes;
* qwen2-vl-smoke served by both packages' ``BatchedServer`` on paged int8
  pools through both routes and fused rounds: every host counter equal,
  tokens through the reference benches' accuracy gate; the CLI refuses
  the encoder in the reference's words and serves the VLM on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (perturbed_jax_params,  # noqa: E402
                           policy_quants, quantized_blocks_match,
                           quantized_tree_matches, t, tie_flips,
                           torch_model, unstack_layers, weight_policies)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.lm_precision import accuracy_gate  # noqa: E402
from repro.configs import counting as jcounting  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.fixedpoint import FixedPointFormat as JFormat  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro.quant.apply import build_model_quant as jbuild  # noqa: E402
from repro.quant.apply import quantize_param_tree as jquantize  # noqa
from repro_torch.configs import counting, shapes  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.fixedpoint import FixedPointFormat  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.models import attention, common, mlp  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.quant.apply import (build_model_quant,  # noqa: E402
                                     quantize_param_tree)

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
GATE = dict(min_agreement=0.9, request_floor=0.5, allowed_below_floor=0.15)
HUBERT, QWENVL = "hubert-xlarge", "qwen2-vl-2b"

_MODELS = {}
# the reference's entry points, compiled once per shape
_jforward = jax.jit(jtr.forward, static_argnames=("cfg",))
_jprefill = jax.jit(jtr.prefill, static_argnames=("cfg", "max_len"))


def _models(arch):
    if arch not in _MODELS:
        jcfg, tcfg, jparams, tree = perturbed_jax_params(arch, seed=3,
                                                         jit=True)
        _MODELS[arch] = jcfg, tcfg, jparams, torch_model(tree, tcfg)
    return _MODELS[arch]


def _ids(rng, B, S, hi=24):
    """(B, S, 3) M-RoPE ids: each row a random mix of spread ids."""
    return rng.integers(0, hi, (B, S, 3)).astype(np.int32)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------
def test_layernorm_matches_reference():
    """Unused by every forward (the encoder's blocks use RMSNorm, as the
    reference's), held all the same: float32 and bf16 inputs, a random
    scale and bias; the init is unit scale and zero bias."""
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (3, 5, 48)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 48).astype(np.float32),
         "bias": rng.normal(0, 1, 48).astype(np.float32)}
    want = jcommon.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    got = common.layernorm({k: t(v) for k, v in p.items()}, t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jcommon.layernorm({k: jnp.asarray(v) for k, v in p.items()}, xb)
    gb = common.layernorm({k: t(v) for k, v in p.items()},
                          t(x).to(torch.bfloat16))
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(),
                               np.asarray(wb.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    init = common.init_layernorm(48, torch.float32)
    jinit = jcommon.init_layernorm(48, jnp.float32)
    for k in ("scale", "bias"):
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(jinit[k]))


@pytest.mark.parametrize("head_dim", [16, 80, 128])
def test_apply_mrope_matches_reference(head_dim):
    """Random ids over the three bands (bounds at a quarter and five
    eighths of the half dim, truncated), at qwen2-vl's theta; with three
    equal ids M-RoPE is plain RoPE at that id, in both packages."""
    rng = np.random.default_rng(head_dim)
    x = rng.normal(size=(2, 7, 3, head_dim)).astype(np.float32)
    ids = _ids(rng, 2, 7, hi=4000)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(ids), 1e6)
    got = common.apply_mrope(t(x), t(ids), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    same = np.repeat(pos[..., None], 3, axis=-1)
    eq = common.apply_mrope(t(x), t(same), 1e6)
    np.testing.assert_array_equal(eq.numpy(),
                                  common.apply_rope(t(x), t(pos),
                                                    1e6).numpy())
    np.testing.assert_allclose(
        eq.numpy(), np.asarray(jcommon.apply_rope(jnp.asarray(x),
                                                  jnp.asarray(pos), 1e6)),
        **TOL)
    half = head_dim // 2
    bands = common._mrope_bands(half, CPU).tolist()
    b0, b1 = bands.index(1), bands.index(2)
    assert (b0, b1) == {16: (2, 5), 80: (10, 25), 128: (16, 40)}[head_dim]


def test_gelu_mlp_matches_reference_in_its_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; the port's GELU
    MLP holds the reference at 1e-6 in float32, and the erf form (torch's
    default) would miss it by more."""
    rng = np.random.default_rng(4)
    D, F = 32, 96
    p = {"w_in": rng.normal(0, 0.5, (D, F)), "b_in": rng.normal(0, 1, F),
         "w_out": rng.normal(0, 0.3, (F, D)), "b_out": rng.normal(0, 1, D)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(0, 1, (2, 9, D)).astype(np.float32)
    want = np.asarray(jmlp.gelu_mlp_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    m = mlp.GeluMLP(D, F, torch.float32)
    with torch.no_grad():
        for k, v in p.items():
            getattr(m, k).copy_(t(v))
    got = mlp.gelu_mlp_apply(m, t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    h = t(x) @ m.w_in + m.b_in
    erf = (torch.nn.functional.gelu(h) @ m.w_out + m.b_out).detach().numpy()
    assert np.abs(erf - want).max() > 100 * np.abs(got - want).max()
    assert np.abs(erf - want).max() > 1e-4
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        mlp.init_gelu_mlp(m, g)
    assert not m.b_in.any() and not m.b_out.any()
    std = float(m.w_out.std())
    assert abs(std - 0.88 / np.sqrt(F)) < 0.15 / np.sqrt(F)


# ---------------------------------------------------------------------------
# hubert-xlarge: the encoder
# ---------------------------------------------------------------------------
def test_encoder_converter_names_the_gelu_leaves():
    jcfg, tcfg, jparams, model = _models(HUBERT)
    seg = jparams["segments"][0][0]
    for li, blk in enumerate(model.layers):
        assert isinstance(blk.mlp, mlp.GeluMLP)
        for name in ("w_in", "b_in", "w_out", "b_out"):
            np.testing.assert_array_equal(
                getattr(blk.mlp, name).numpy(),
                np.asarray(seg["ffn"][name][li]), err_msg=name)
    assert not tcfg.causal and model.head is not None


@pytest.mark.parametrize("S", [64, 128], ids=["full", "chunked"])
def test_encoder_forward_on_embeds_matches_reference(S):
    """S = 64 attends through ``attend_full`` (S^2 <= attn_chunk^2), S =
    128 through the non-causal ``attend_chunked``: hidden and logits of
    every frame within 1e-4."""
    jcfg, tcfg, jparams, model = _models(HUBERT)
    assert (S * S > tcfg.attn_chunk ** 2) == (S == 128)
    emb = np.random.default_rng(S).normal(0, 1, (2, S, tcfg.d_model)
                                          ).astype(np.float32)
    jh, jlog, _, _ = _jforward(jparams, {"embeds": jnp.asarray(emb)},
                               cfg=jcfg)
    th, tlog, caches, _ = ttr.forward(model, None, tcfg, embeds=t(emb))
    assert caches is None and tlog.shape == (2, S, tcfg.vocab_size)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


@pytest.mark.parametrize("S", [64, 128], ids=["full", "chunked"])
def test_encoder_attends_both_ways(S):
    """Changing the last frame's embedding changes frame 0's logits (the
    encoder is bidirectional); a causal copy of the config leaves them
    exactly as they were."""
    _, tcfg, _, model = _models(HUBERT)
    emb = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, S, tcfg.d_model)).astype(np.float32))
    moved = emb.clone()
    moved[:, -1] += 1.0
    for cfg, changes in ((tcfg, True),
                         (dataclasses.replace(tcfg, causal=True), False)):
        a = ttr.forward(model, None, cfg, embeds=emb)[1][:, 0]
        b = ttr.forward(model, None, cfg, embeds=moved)[1][:, 0]
        assert bool((a != b).any()) == changes, cfg.causal


def test_encoder_prefill_step_returns_every_frame():
    """``make_prefill_step`` of an encoder returns the whole forward's
    logits (B, S, V) and no caches, as the reference's."""
    jcfg, tcfg, jparams, model = _models(HUBERT)
    emb = np.random.default_rng(5).normal(0, 1, (2, 48, tcfg.d_model)
                                          ).astype(np.float32)
    jstep = jax.jit(jsteps.make_prefill_step(jcfg, max_len=64))
    jlog, jc = jstep(jparams, {"embeds": jnp.asarray(emb)})
    tlog, tc = tsteps.make_prefill_step(tcfg, max_len=64)(
        model, embeds=t(emb))
    assert jc is None and tc is None
    assert tlog.shape == (2, 48, tcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


_FMTS = [((2, 6), (4, 12)), ((1, 5), (4, 12)), (None, (4, 12))]


@pytest.mark.parametrize("arch", [HUBERT, QWENVL])
def test_quantized_blocks_match_reference(arch):
    """Weights at Q2.6 / Q1.5 / sentinel over the three layers (the GELU
    MLP's and the attention's biases stay float), residual stream at
    Q4.12, block by block on the reference's inputs."""
    jcfg, tcfg, jparams, model = _models(arch)
    quantized_blocks_match(jcfg, tcfg, jparams, model,
                           *policy_quants(jcfg, tcfg, _FMTS))


@pytest.mark.parametrize("arch", [HUBERT, QWENVL])
def test_quantize_param_tree_matches_reference(arch):
    """One segment at its max format, Q2.6 (packed); the GELU MLP's
    biases and the attention's pass through; the tied VLM has no head
    entry in either tree."""
    jcfg, tcfg, jparams, model = _models(arch)
    fmts = [(2, 6), (1, 5), None]
    formats = quantized_tree_matches(jcfg, tcfg, jparams, model,
                                     *weight_policies(tcfg, fmts))
    assert formats == {(2, 6, True)}
    tp, jp = weight_policies(tcfg, fmts)
    got = quantize_param_tree(model, tp)
    want = jax.jit(jquantize, static_argnums=(1, 2))(jparams, jp, jcfg)
    assert ("head" in got) == ("head" in want) == (arch == HUBERT)
    ffn = got["layers"][0]["ffn"]
    if arch == HUBERT:
        assert isinstance(ffn["b_in"], torch.Tensor)
        assert not isinstance(ffn["w_in"], torch.Tensor)
    else:
        assert isinstance(got["layers"][0]["mixer"]["bq"], torch.Tensor)


def test_param_counts_of_the_full_configs():
    """``count_params`` and every layer's count of the two full configs
    equal the reference's: 0.945 G for hubert-xlarge, 1.544 G for
    qwen2-vl-2b."""
    for arch, n in ((HUBERT, 945_440_000), (QWENVL, 1_543_714_304)):
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert counting.count_params(cfg) == n
        assert jcounting.count_params(jcfg) == n
        for li in range(cfg.num_layers):
            assert counting.layer_param_count(cfg, li) == \
                jcounting.layer_param_count(jcfg, li)


# ---------------------------------------------------------------------------
# qwen2-vl-2b: the VLM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("inputs", ["tokens", "tokens+mrope", "embeds+mrope",
                                    "embeds+positions"])
def test_vlm_forward_matches_reference(inputs):
    """The forward from token ids with plain RoPE or with M-RoPE ids, from
    stub patch embeddings with M-RoPE ids, and from embeddings at explicit
    positions: hidden and logits within 1e-4."""
    jcfg, tcfg, jparams, model = _models(QWENVL)
    rng = np.random.default_rng(len(inputs))
    B, S = 2, 24
    batch = {}
    if inputs.startswith("tokens"):
        batch["tokens"] = rng.integers(0, tcfg.vocab_size, (B, S)
                                       ).astype(np.int32)
    else:
        batch["embeds"] = rng.normal(0, 1, (B, S, tcfg.d_model)
                                     ).astype(np.float32)
    if inputs.endswith("mrope"):
        batch["mrope_positions"] = _ids(rng, B, S)
    if inputs.endswith("positions"):
        batch["positions"] = rng.integers(0, 99, (B, S)).astype(np.int32)
    jh, jlog, _, _ = _jforward(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, cfg=jcfg)
    tok = batch.pop("tokens", None)
    th, tlog, _, _ = ttr.forward(model, None if tok is None else t(tok),
                                 tcfg, **{k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    if inputs == "tokens+mrope":
        plain = ttr.forward(model, t(tok), tcfg)[1]
        assert not torch.allclose(plain, tlog, **TOL)


class _KVTap:
    """Wraps ``attention.cache_update``: records each call's K and V on
    its grid's scale (the values a rounding tie is judged on)."""

    def __init__(self, fn):
        self.fn, self.seen = fn, []

    def __call__(self, cache, k_new, v_new, pos, quant=None):
        if quant is not None:
            s = 2.0 ** quant.frac_bits
            self.seen.append((int(pos), k_new.float() * s,
                              v_new.float() * s))
        return self.fn(cache, k_new, v_new, pos, quant)


def _caches_match(tcaches, jcaches, tcfg, tap, label):
    """Float caches within 1e-4; int8 grids equal but for one step at a
    rounding tie (``tie_flips``) in the slice this step wrote. Returns the
    flips."""
    flips = 0
    want = unstack_layers(jcaches, tcfg)
    for li, (g, w) in enumerate(zip(tcaches, want)):
        if tap is None:
            for k in ("k", "v"):
                np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                           err_msg=str((label, li, k)),
                                           **TOL)
            continue
        pos, ks, vs = tap.seen[li]
        for k, sc in (("k", ks), ("v", vs)):
            scaled = np.zeros(g[k].shape, np.float64)
            scaled[:, pos:pos + sc.shape[1]] = sc.numpy()
            flips += tie_flips(g[k].numpy(), w[k], scaled, (label, li, k))
    if tap is not None:
        tap.seen.clear()
    return flips


@pytest.mark.parametrize("container", ["fp", "int8"])
def test_vlm_embeds_prefill_and_decode_in_lockstep(container, monkeypatch):
    """``prefill`` on stub patch embeddings with M-RoPE ids (a 4x4 grid,
    then text), then four ``make_embed_decode_step`` steps (plain RoPE at
    the cache position, as the reference's), each step fed the reference's
    caches as they stand before it: logits within 1e-4, next tokens equal,
    the new caches equal (float within 1e-4; the int8 grid but for one
    step at a tie)."""
    jcfg, tcfg, jparams, model = _models(QWENVL)
    names = [f"layer_{i:03d}" for i in range(tcfg.num_layers)]
    tq = jq = tap = None
    if container == "int8":
        tq = build_model_quant(PrecisionPolicy.uniform(
            names, None, FixedPointFormat(2, 6)), tcfg,
            quantize_activations=False)
        jq = jbuild(JPolicy.uniform(names, None, JFormat(2, 6)), jcfg,
                    quantize_activations=False)
        tap = _KVTap(attention.cache_update)
        monkeypatch.setattr(attention, "cache_update", tap)
    rng = np.random.default_rng(11)
    B, max_len = 2, 40
    ids = shapes.mrope_ids((1, 4, 4), 8).numpy()
    S = ids.shape[0]
    emb = rng.normal(0, 1, (B, S, tcfg.d_model)).astype(np.float32)
    mro = np.broadcast_to(ids, (B, S, 3)).copy()
    jlast, jcaches, jS = _jprefill(
        jparams, {"embeds": jnp.asarray(emb),
                  "mrope_positions": jnp.asarray(mro)},
        cfg=jcfg, quant=jq, max_len=max_len)
    tlast, tcaches, tS = ttr.prefill(model, None, tcfg, quant=tq,
                                     max_len=max_len, embeds=t(emb),
                                     mrope_positions=t(mro))
    assert tS == jS == S
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    flips = _caches_match(tcaches, jcaches, tcfg, tap, "prefill")
    jdec = jax.jit(jsteps.make_embed_decode_step(jcfg, quant=jq))
    tdec = tsteps.make_embed_decode_step(tcfg, quant=tq)
    for step in range(4):
        e = rng.normal(0, 1, (B, 1, tcfg.d_model)).astype(np.float32)
        before = [{k: t(a) for k, a in c.items()}
                  for c in unstack_layers(jcaches, tcfg)]
        jn, jl, jcaches = jdec(jparams, jnp.asarray(e), S + step, jcaches)
        tn, tl, tcaches = tdec(model, t(e), S + step, before)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert tn.tolist() == np.asarray(jn).tolist()
        flips += _caches_match(tcaches, jcaches, tcfg, tap, step)
    assert flips <= 4, flips


def test_embed_decode_is_the_extended_forward():
    """Inside the port: each embed-decode step's logits equal those of a
    forward over the whole extended sequence at that position, its ids the
    prefill's M-RoPE ids then three equal ids at each cache position (the
    reference's own decode-consistency bound, rtol 0.12 and atol 0.08,
    holds with far to spare in float32)."""
    _, tcfg, _, model = _models(QWENVL)
    rng = np.random.default_rng(12)
    ids = shapes.mrope_ids((1, 4, 4), 4)
    S = ids.shape[0]
    emb = torch.from_numpy(rng.normal(0, 1, (2, S + 3, tcfg.d_model)
                                      ).astype(np.float32))
    ext = torch.cat([ids, torch.arange(S, S + 3)[:, None].expand(3, 3)
                     .to(torch.int32)])[None].expand(2, -1, -1)
    full = ttr.forward(model, None, tcfg, embeds=emb, mrope_positions=ext)[1]
    last, caches, _ = ttr.prefill(model, None, tcfg, max_len=S + 3,
                                  embeds=emb[:, :S],
                                  mrope_positions=ext[:, :S])
    np.testing.assert_allclose(last.numpy(), full[:, S - 1].numpy(), **TOL)
    dec = tsteps.make_embed_decode_step(tcfg)
    for i in range(3):
        _, lg, caches = dec(model, emb[:, S + i:S + i + 1], S + i, caches)
        np.testing.assert_allclose(lg.numpy(), full[:, S + i].numpy(),
                                   **TOL)


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------
def _dtype_name(dt) -> str:
    return str(dt).rsplit(".", 1)[-1]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_match_reference(arch):
    """``applicable`` and every ``batch_specs`` key, shape and dtype equal
    the reference's, for every arch and shape (with a batch override too);
    ``make_batch`` draws exactly those specs."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert [s.name for s in shapes.applicable_shapes(cfg)] == \
        [s.name for s in jshapes.applicable_shapes(jcfg)]
    for name, shp in shapes.SHAPES.items():
        jshp = jshapes.SHAPES[name]
        assert dataclasses.astuple(shp) == dataclasses.astuple(jshp)
        assert shapes.applicable(cfg, shp) == jshapes.applicable(jcfg, jshp)
        for over in (None, 3):
            got = shapes.batch_specs(cfg, shp, batch_override=over)
            want = jshapes.batch_specs(jcfg, jshp, batch_override=over)
            assert set(got) == set(want)
            for k, (s, dt) in got.items():
                assert tuple(s) == tuple(want[k].shape), k
                assert _dtype_name(dt) == _dtype_name(want[k].dtype), k
    small = shapes.ShapeConfig("small", 20, 2, "train")
    g = torch.Generator().manual_seed(0)
    batch = shapes.make_batch(cfg, small, generator=g, device="cpu")
    for k, (s, dt) in shapes.batch_specs(cfg, small).items():
        assert tuple(batch[k].shape) == s and batch[k].dtype == dt, k


def test_mrope_ids_lay_out_a_grid_then_text():
    """A (t, h, w) grid row-major, then text ids counting on from one past
    the grid's largest id, three equal; ``make_batch`` uses the largest
    square grid and is the same draw for the same seed."""
    ids = shapes.mrope_ids((2, 2, 3), 3, start=5)
    assert ids.tolist()[:4] == [[5, 5, 5], [5, 5, 6], [5, 5, 7],
                                [5, 6, 5]]
    assert ids.tolist()[12:] == [[8, 8, 8], [9, 9, 9], [10, 10, 10]]
    cfg = get_config(QWENVL)
    small = shapes.ShapeConfig("small", 20, 2, "prefill")
    a = shapes.make_batch(cfg, small, generator=torch.Generator()
                          .manual_seed(1), device="cpu")
    b = shapes.make_batch(cfg, small, generator=torch.Generator()
                          .manual_seed(1), device="cpu")
    assert torch.equal(a["embeds"], b["embeds"])
    assert a["mrope_positions"][0, 15].tolist() == [0, 3, 3]
    assert a["mrope_positions"][1, 16:].tolist() == [[i] * 3
                                                     for i in range(4, 8)]


# ---------------------------------------------------------------------------
# serving the VLM, and the CLI
# ---------------------------------------------------------------------------
LENS = [25, 9, 30, 1, 21, 40, 13]
SYS = 20                    # a shared system prompt (one full page of 16)


def _requests(cls, vocab, seed=7):
    """7 requests; those longer than the system prompt start with it."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, SYS)
    out = []
    for i, L in enumerate(LENS):
        p = rng.integers(0, vocab, L)
        if L > SYS:
            p[:SYS] = sys_p
        out.append(cls(i, p.astype(np.int32), 3 + i % 3))
    return out


def _counters(srv):
    c = {"prefill_forwards": srv.prefill_forwards,
         "program_launches": srv.program_launches,
         "decode_steps": srv.decode_steps, "cycles": srv.cycles,
         "prefill_tokens": srv.prefill_tokens,
         "prefill_forwards_saved": srv.prefill_forwards_saved,
         "prefill_mode": srv.prefill_mode,
         "allocs": srv.metrics.value("alloc.allocs"),
         "free": srv.allocator.num_free,
         "usable": srv.allocator.num_usable}
    if srv.prefix_cache is not None:
        st = srv.prefix_cache.stats()
        c.update({k: st[k] for k in ("lookups", "hits", "hit_tokens",
                                     "inserted_pages", "cow_copies")})
    return c


@pytest.mark.parametrize("mode", [dict(), dict(fused="on"),
                                  dict(prefix_cache="on")],
                         ids=["separate", "fused", "prefix"])
def test_vlm_serves_as_the_reference(mode):
    """qwen2-vl-smoke from token ids on paged int8 pools, bucketed
    prefill, separate programs, fused rounds or the prefix cache sharing
    a system prompt: every host counter equal to the reference server's,
    through both attention routes, and the tokens pass the gate."""
    jcfg, tcfg, jparams, model = _models(QWENVL)
    kw = dict(batch_size=3, max_len=64, page_size=16, prefill_bucket=8,
              kv_bits=8, **mode)
    jsrv = JServer(jcfg, jparams, **kw)
    jreqs = jsrv.run(_requests(JRequest, jcfg.vocab_size))
    for impl in ("gather", "kernel"):
        tsrv = BatchedServer(tcfg, model, attn_impl=impl, device=CPU, **kw)
        treqs = tsrv.run(_requests(Request, tcfg.vocab_size))
        assert all(r.done and r.error is None for r in treqs)
        assert _counters(tsrv) == _counters(jsrv), impl
        assert tsrv.prefill_mode == "bucketed"
        if "prefix_cache" in mode:
            assert tsrv.prefix_cache.stats()["hits"] >= 2
        gate = accuracy_gate([r.out for r in jreqs], [r.out for r in treqs],
                             **GATE)
        assert gate["passed"], (impl, gate)


def test_cli_refuses_the_encoder_in_the_reference_words():
    with pytest.raises(SystemExit) as ref:
        jserve.main(["--arch", HUBERT, "--smoke"])
    with pytest.raises(SystemExit) as port:
        tserve.main(["--arch", HUBERT, "--smoke", "--device", "cpu"])
    assert str(port.value) == str(ref.value)
    assert "encoder" in str(port.value)


def test_cli_serves_the_vlm_on_cpu(capsys):
    reqs = tserve.main(["--arch", QWENVL, "--smoke", "--device", "cpu",
                        "--requests", "3", "--batch-size", "2",
                        "--max-new", "3", "--max-len", "32",
                        "--prompt-len", "6", "--page-size", "8",
                        "--kv-bits", "8", "--attn-impl", "kernel"])
    assert all(r.done and len(r.out) == 3 for r in reqs)
    assert "[serve]" in capsys.readouterr().out

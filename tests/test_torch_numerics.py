"""Port parity, numerics core: fixed-point formats, bit packing, the KV
rounding rule, policies, configs and the KV quant plan — all exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: F401,E402  (sets JAX to CPU, torch to 1 thread)
import jax.numpy as jnp  # noqa: E402
from _compat import given, settings, strategies as st  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import fixedpoint as jfp  # noqa: E402
from repro.core import paged_kv as jpk  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.core import qtensor as jqt  # noqa: E402
from repro.quant import apply as japply  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import fixedpoint as tfp  # noqa: E402
from repro_torch.core import paged_kv as tpk  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core import qtensor as tqt  # noqa: E402
from repro_torch.quant import apply as tapply  # noqa: E402


@pytest.mark.parametrize("int_bits", [1, 2, 3, 5, 8])
def test_format_params_exact(int_bits):
    """(scale, qmin, qmax) equal the reference's bit for bit; the scale is
    an exact power of two at every F (the reference's ldexp contract)."""
    for frac in range(0, 22 - int_bits):
        got = tfp.format_params(int_bits, frac)
        want = [float(np.asarray(v)) for v in
                jfp.format_params(int_bits, frac)]
        assert list(got) == want, (int_bits, frac, got, want)
        assert got[0] == 2.0 ** frac


def test_fixed_point_format_validates_like_reference():
    for i, f in ((2, 6), (1, 7), (4, 0), (8, 8)):
        assert tfp.FixedPointFormat(i, f).total_bits == \
            jfp.FixedPointFormat(i, f).total_bits
    for bad in ((0, 3), (2, -1), (16, 15)):
        with pytest.raises(ValueError):
            tfp.FixedPointFormat(*bad)
        with pytest.raises(ValueError):
            jfp.FixedPointFormat(*bad)


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_pack_unpack_matches_reference(bits):
    """Packed words equal the reference's (two's-complement int32, top bit
    set included) and unpacking sign-extends back, with both sign extremes
    and a ragged last dim."""
    rng = np.random.default_rng(bits)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    for n in (32, 37):
        q = rng.integers(lo, hi + 1, (3, 5, n)).astype(np.int32)
        q[0, 0, :] = lo
        q[0, 1, :] = hi
        q[0, 2, ::2], q[0, 2, 1::2] = lo, hi
        tw, tn = tqt.pack_bits(torch.from_numpy(q), bits)
        jw, jn = jqt.pack_bits(jnp.asarray(q), bits)
        assert tw.dtype == torch.int32 and tn == jn == n
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        back = tqt.unpack_bits(tw, bits, n)
        np.testing.assert_array_equal(back.numpy(), q)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jqt.unpack_bits(jw, bits, n)))


@settings(max_examples=20, deadline=None)
@given(bits=st.sampled_from([2, 4, 8, 16]), words=st.integers(1, 6),
       seed=st.integers(0, 10_000))
def test_pack_roundtrip_property(bits, words, seed):
    rng = np.random.default_rng(seed)
    k = tqt.values_per_word(bits)
    q = rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1),
                     (2, words * k)).astype(np.int32)
    w, n = tqt.pack_bits(torch.from_numpy(q), bits)
    assert w.shape == (2, words)
    np.testing.assert_array_equal(tqt.unpack_bits(w, bits, n).numpy(), q)


@pytest.mark.parametrize("int_bits,frac_bits", [(2, 6), (2, 2), (1, 3)])
def test_quant_grid_ties_round_half_to_even(int_bits, frac_bits):
    """The KV write's rounding is jnp.round's half-to-even: ties at ±0.5,
    ±1.5, ±2.5 grid steps land on the even neighbour, exactly as the
    reference (round-half-away would give ±1, ±2, ±3)."""
    step = 2.0 ** -frac_bits
    ties = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 3.5, 0.25, -7.5, 100.0,
                     -100.0], np.float32) * step
    got, rs = tpk._quant_grid(torch.from_numpy(ties), int_bits, frac_bits)
    want, jrs = jpk._quant_grid(jnp.asarray(ties), int_bits, frac_bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rs == float(np.asarray(jrs))
    np.testing.assert_array_equal(got.numpy()[:6], [0, -0, 2, -2, 2, -2])


def test_policy_json_roundtrips_between_packages():
    names = [f"layer_{i:03d}" for i in range(4)]
    fmt = tfp.FixedPointFormat
    tp = tpol.PrecisionPolicy(tuple(names), (
        tpol.LayerPolicy(None, fmt(2, 6)), tpol.LayerPolicy(fmt(1, 7), None),
        tpol.LayerPolicy(fmt(3, 5), fmt(2, 2)), tpol.LayerPolicy(None, None)))
    jp = jpol.PrecisionPolicy.from_json(tp.to_json())
    assert jp.to_json() == tp.to_json()
    back = tpol.PrecisionPolicy.from_json(jp.to_json())
    assert back == tp
    uni = tpol.PrecisionPolicy.uniform(names, None, fmt(2, 6))
    assert uni.to_json() == jpol.PrecisionPolicy.uniform(
        names, None, jfp.FixedPointFormat(2, 6)).to_json()


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_configs_match_reference(arch):
    """Every ModelConfig field of the full and smoke configs equals the
    reference's."""
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    for get_t, get_j in ((treg.get_config, jreg.get_config),
                         (treg.get_smoke_config, jreg.get_smoke_config)):
        assert dataclasses.asdict(get_t(arch)) == \
            dataclasses.asdict(get_j(arch))
    cfg = treg.get_config(arch)
    assert cfg.torch_dtype == {"bfloat16": torch.bfloat16,
                               "float32": torch.float32}[cfg.dtype]


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_uniform_kv_quant_plan_matches_reference(kv_bits):
    """build_model_quant's uniform KV branch: the same per-layer Q(I,F) as
    the reference, for the serving policy and for a mixed-data policy."""
    jcfg = jreg.get_smoke_config("qwen2-72b")
    tcfg = treg.get_smoke_config("qwen2-72b")
    container = "int4" if kv_bits == 4 else "int8"
    names = tapply.transformer_layer_names(tcfg)
    assert names == japply.transformer_layer_names(jcfg)
    datas = [(2, kv_bits - 2), (3, 9), None, (1, 1)]
    tpol_ = tpol.PrecisionPolicy(tuple(names), tuple(
        tpol.LayerPolicy(None, None if d is None else tfp.FixedPointFormat(*d))
        for d in datas))
    jpol_ = jpol.PrecisionPolicy.from_json(tpol_.to_json())
    tq = tapply.build_model_quant(tpol_, tcfg, quantize_activations=False,
                                  kv_container=container)
    jq = japply.build_model_quant(jpol_, jcfg, quantize_activations=False,
                                  kv_container=container)
    assert list(tq.kv_int) == np.asarray(jq.kv_int).astype(int).tolist()
    assert list(tq.kv_frac) == np.asarray(jq.kv_frac).astype(int).tolist()
    assert tq.kv_container == jq.kv_container
    for kv_scale in ("static", "page"):
        assert tapply.kv_profile_key(tpol_, kv_scale_mode=kv_scale) == \
            japply.kv_profile_key(jpol_, kv_scale_mode=kv_scale)
        assert tapply.kv_profile_key(None, kv_bits=kv_bits,
                                     kv_scale_mode=kv_scale) == \
            japply.kv_profile_key(None, kv_bits=kv_bits,
                                  kv_scale_mode=kv_scale)

"""Port parity, the paper's accounting: parameter counts, KV bytes per
token, the transformer traffic model and the policy footprint report
equal the reference's exactly for every config of the registry (full
size and smoke), and the precision-policy methods the search and the
quant plan use (``decrement``, ``candidate_moves``, ``stacked_arrays``,
JSON) give the reference's results."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import counting as jcount  # noqa: E402
from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.configs.registry import get_smoke_config as jget_smoke  # noqa: E402,E501
from repro.core.fixedpoint import FixedPointFormat as JFormat  # noqa: E402
from repro.core.policy import LayerPolicy as JLayer  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.models.transformer import layer_signatures as jlayer_signatures  # noqa: E402,E501
from repro.quant import apply as japply  # noqa: E402
from repro_torch.configs import counting  # noqa: E402
from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402,E501
from repro_torch.core.fixedpoint import FixedPointFormat  # noqa: E402
from repro_torch.core.policy import FIELDS, LayerPolicy, PrecisionPolicy  # noqa: E402,E501
from repro_torch.core.traffic import LayerTraffic, TrafficModel  # noqa: E402
from repro_torch.quant import apply  # noqa: E402

CONFIGS = [(a, s) for a in ARCH_IDS for s in (False, True)]
_IDS = [f"{a}{'-smoke' if s else ''}" for a, s in CONFIGS]


def _cfgs(arch, smoke):
    return ((get_smoke_config(arch), jget_smoke(arch)) if smoke
            else (get_config(arch), jget(arch)))


def _pair(rows):
    """The same policy in both packages: ``rows`` holds one (weight, data)
    pair of (I, F) or None per layer."""
    def mk(fmt, layer, pol):
        names = tuple(f"layer_{i:03d}" for i in range(len(rows)))
        f = lambda v: None if v is None else fmt(*v)
        return pol(names, tuple(layer(f(w), f(d)) for w, d in rows))
    return (mk(FixedPointFormat, LayerPolicy, PrecisionPolicy),
            mk(JFormat, JLayer, JPolicy))


def _mixed_rows(n, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        w = (int(rng.integers(1, 4)), int(rng.integers(0, 8)))
        d = (int(rng.integers(1, 6)), int(rng.integers(0, 12)))
        pick = rng.integers(0, 4)
        rows.append((None if pick == 0 else w, None if pick == 1 else d))
    return rows


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=_IDS)
def test_counts_match_reference(arch, smoke):
    tcfg, jcfg = _cfgs(arch, smoke)
    assert counting.layer_signatures(tcfg) == jlayer_signatures(jcfg)
    for active in (False, True):
        assert (counting.count_params(tcfg, active)
                == jcount.count_params(jcfg, active))
        for i in range(tcfg.num_layers):
            assert (counting.layer_param_count(tcfg, i, active)
                    == jcount.layer_param_count(jcfg, i, active))
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    for b in (4.0, 2.0, 1.0, 0.5, 0.625):
        assert (counting.kv_bytes_per_token(tcfg, b)
                == jcount.kv_bytes_per_token(jcfg, b))


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=_IDS)
def test_traffic_and_footprint_match_reference(arch, smoke):
    tcfg, jcfg = _cfgs(arch, smoke)
    L = tcfg.num_layers
    for mode in ("train", "prefill", "decode"):
        tm = apply.transformer_traffic_model(tcfg, batch=3, seq_len=4096,
                                             mode=mode)
        jm = japply.transformer_traffic_model(jcfg, batch=3, seq_len=4096,
                                              mode=mode)
        assert [dataclass_tuple(lt) for lt in tm.layers] == \
            [dataclass_tuple(lt) for lt in jm.layers]
        assert tm.names == jm.names
        for bs, md in ((1, "batch"), (8, "batch"), (8, "single")):
            assert tm.accesses(bs, md) == jm.accesses(bs, md)
            assert tm.baseline_bits(bs, md) == jm.baseline_bits(bs, md)
    rows = [[((2, 6), (4, 12))] * L, [(None, None)] * L, _mixed_rows(L, L)]
    for r in rows:
        tp, jp = _pair(r)
        for bs, md in ((1, "batch"), (4, "single")):
            assert (tm.traffic_bits(tp, bs, md)
                    == jm.traffic_bits(jp, bs, md))
            assert (tm.traffic_ratio(tp, bs, md)
                    == jm.traffic_ratio(jp, bs, md))
        assert tm.footprint_bytes(tp) == jm.footprint_bytes(jp)
        got = apply.policy_footprint_report(tp, tcfg, batch=8, seq_len=2048)
        ref = japply.policy_footprint_report(jp, jcfg, batch=8, seq_len=2048)
        assert got == ref


def dataclass_tuple(lt):
    return (lt.name, lt.weight_elems, lt.data_in_elems, lt.data_out_elems,
            lt.data_elems)


def test_traffic_model_checks():
    tm = TrafficModel((LayerTraffic("a", 10, 2, 3),))
    with pytest.raises(ValueError):
        tm.accesses(1, "sometimes")
    tp, _ = _pair([((2, 6), None), ((2, 6), None)])
    with pytest.raises(ValueError, match="mismatch"):
        tm.traffic_bits(tp)
    with pytest.raises(ValueError):
        apply.transformer_traffic_model(get_smoke_config("qwen2-72b"),
                                        batch=1, seq_len=8, mode="serve")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_methods_match_reference(seed):
    """decrement / candidate_moves / with_field / stacked_arrays / the
    views and the JSON round trip, on a mixed policy with absent formats
    and fields at their floors."""
    rows = _mixed_rows(5, seed) + [((1, 0), (1, 0)), (None, None)]
    tp, jp = _pair(rows)
    as_rows = lambda p: [(lp.short()) for lp in p.layers]
    assert as_rows(tp) == as_rows(jp)
    assert tp.short() == jp.short() and tp.table() == jp.table()
    for i in range(len(tp)):
        for f in FIELDS:
            assert tp.layers[i].get_field(f) == jp.layers[i].get_field(f)
            got, ref = tp.decrement(i, f), jp.decrement(i, f)
            assert (got is None) == (ref is None), (i, f)
            if got is not None:
                assert got.to_json() == ref.to_json()
            assert (tp.with_field(i, f, 3).to_json()
                    == jp.with_field(i, f, 3).to_json())
    moves, jmoves = tp.candidate_moves(), jp.candidate_moves()
    assert [m for m, _ in moves] == [m for m, _ in jmoves]
    assert [p.to_json() for _, p in moves] == [p.to_json() for _, p in jmoves]
    sub = ("weight_frac", "data_int")
    assert ([m for m, _ in tp.candidate_moves(sub)]
            == [m for m, _ in jp.candidate_moves(sub)])
    for prefix in ("weight", "data"):
        for got, ref in zip(tp.stacked_arrays(prefix),
                            jp.stacked_arrays(prefix)):
            ref = np.asarray(ref)
            assert got.numpy().dtype == ref.dtype
            np.testing.assert_array_equal(got.numpy(), ref)
    assert tp["layer_002"].short() == jp["layer_002"].short()
    assert tp.replace_layer(0, tp.layers[6]).to_json() == \
        jp.replace_layer(0, jp.layers[6]).to_json()
    assert PrecisionPolicy.from_json(jp.to_json()) == tp
    assert JPolicy.from_json(tp.to_json()) == jp
    base = PrecisionPolicy.fp32_baseline(tp.names)
    assert base.to_json() == JPolicy.fp32_baseline(jp.names).to_json()
    assert base.candidate_moves() == []

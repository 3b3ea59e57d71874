"""Port parity, per-layer KV profiles (``--kv-profile``): the port's
``build_model_quant(per_layer_kv=True)`` equals the reference's field for
field; its caches hold one pool per layer in that layer's container with
the reference's bytes; served tokens under a mixed profile agree with
the reference's, with equal counters; inside the port both
``kv_profile_scan`` values give identical tokens and the kernel route
agrees with the gather route; and a profile's at-rest bytes lie between
uniform int4 and uniform int8."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import perturbed_jax_params, torch_model  # noqa: E402

from benchmarks.lm_precision import accuracy_gate  # noqa: E402
from repro.core import paged_kv as jpk  # noqa: E402
from repro.core.fixedpoint import FixedPointFormat as JFmt  # noqa: E402
from repro.core.policy import LayerPolicy as JLayer  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro.models.transformer import init_cache as jinit_cache  # noqa: E402
from repro.quant import apply as japply  # noqa: E402
from repro_torch.core import paged_kv as tpk  # noqa: E402
from repro_torch.core.fixedpoint import FixedPointFormat  # noqa: E402
from repro_torch.core.policy import LayerPolicy, PrecisionPolicy  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.quant import apply as tapply  # noqa: E402

CPU = torch.device("cpu")
GATE = dict(min_agreement=0.9, request_floor=0.5, allowed_below_floor=0.15)

# per-layer data formats of the 4-layer smoke config; None = a float layer
_PROFILES = {
    "alt": [(2, 6), (2, 2), (2, 6), (2, 2)],
    "contig": [(2, 6), (2, 6), (2, 2), (2, 2)],
    "fpmix": [None, (2, 6), (1, 3), None],
    "wide": [(4, 12), (3, 1), (2, 5), (1, 1)],
}


def _policies(fmts, weights=False):
    names = tuple(f"layer_{i:03d}" for i in range(len(fmts)))
    w = (2, 6) if weights else None
    tp = PrecisionPolicy(names, tuple(
        LayerPolicy(w and FixedPointFormat(*w),
                    f and FixedPointFormat(*f)) for f in fmts))
    jp = JPolicy(names, tuple(
        JLayer(w and JFmt(*w), f and JFmt(*f)) for f in fmts))
    return tp, jp


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg, jparams, tree = perturbed_jax_params("qwen2-72b", seed=2)
    return jcfg, tcfg, jparams, torch_model(tree, tcfg)


def _ints(a):
    return None if a is None else tuple(int(v) for v in np.asarray(a))


@pytest.mark.parametrize("unroll", [False, True])
@pytest.mark.parametrize("name", list(_PROFILES))
def test_build_model_quant_per_layer_matches_reference(models, name,
                                                       unroll):
    jcfg, tcfg, _, _ = models
    tp, jp = _policies(_PROFILES[name], weights=name == "wide")
    kw = dict(quantize_kv=True, quantize_activations=False,
              per_layer_kv=True, kv_scale_mode="page")
    tq = tapply.build_model_quant(tp, tcfg, **kw)
    jq = japply.build_model_quant(jp, jcfg, kv_unroll=unroll, **kw)
    for f in ("w_int", "w_frac", "a_int", "a_frac", "kv_int", "kv_frac"):
        assert getattr(tq, f) == _ints(getattr(jq, f)), f
    for f in ("kv_container", "kv_containers", "kv_scale_mode"):
        assert getattr(tq, f) == getattr(jq, f), f
    assert tapply.kv_profile_key(tp, kv_scale_mode="page") == \
        japply.kv_profile_key(jp, kv_scale_mode="page")
    for i, lp in enumerate(tp.layers):
        assert tapply.kv_layer_container(lp.data) == \
            japply.kv_layer_container(jp.layers[i].data)


@pytest.mark.parametrize("name", list(_PROFILES))
def test_per_layer_pools_match_reference(models, name):
    """One pool per layer in the layer's container, with the reference's
    shapes, dtypes and ``pool_bytes`` (the reference stacks same-container
    runs; its pools are read here one layer at a time)."""
    jcfg, tcfg, _, _ = models
    tp, jp = _policies(_PROFILES[name])
    kw = dict(quantize_kv=True, quantize_activations=False,
              per_layer_kv=True)
    tq = tapply.build_model_quant(tp, tcfg, **kw)
    jq = japply.build_model_quant(jp, jcfg, kv_unroll=True, **kw)
    spec = tpk.PagedCacheSpec(page_size=8, num_pages=9)
    tcaches = init_cache(tcfg, tq, spec, "cpu")
    jcaches = jinit_cache(jcfg, 2, 32, jq,
                          paged=jpk.PagedCacheSpec(page_size=8, num_pages=9))
    jpools = [p for p, _ in jpk.iter_kv_pools(jcaches)]
    tpools = list(tpk.iter_kv_pools(tcaches))
    assert len(tpools) == len(jpools) == tcfg.num_layers
    for li, (a, b) in enumerate(zip(tpools, jpools)):
        assert tpk.pool_container(a) == jpk.pool_container(b) == \
            tq.layer_container(li)
        assert tpk.pool_bytes(a) == jpk.pool_bytes(b), li
        for k in a:
            assert tuple(a[k].shape) == tuple(b[k].shape), (li, k)
    assert tpk.caches_kv_bytes(tcaches) == jpk.caches_kv_bytes(jcaches)
    with pytest.raises(ValueError, match="paged"):
        init_cache(tcfg, tq, None, "cpu", batch=2, max_len=32)


def _trace(cls, vocab):
    r = np.random.default_rng(5)
    return [cls(i, r.integers(0, vocab, 7 + i).astype(np.int32), 5)
            for i in range(3)]


def test_profile_serving_matches_reference(models):
    jcfg, tcfg, jparams, model = models
    tp, jp = _policies(_PROFILES["fpmix"], weights=True)
    kw = dict(batch_size=2, max_len=32, page_size=8, prefill_bucket=8,
              prefix_cache="on")
    jsrv = JServer(jcfg, jparams, kv_profile=jp, **kw)
    jreqs = jsrv.run(_trace(JRequest, jcfg.vocab_size))
    tsrv = BatchedServer(tcfg, model, kv_profile=tp, device=CPU, **kw)
    treqs = tsrv.run(_trace(Request, tcfg.vocab_size))
    assert tsrv.profile_key == jsrv.profile_key
    for f in ("prefill_forwards", "decode_steps", "program_launches"):
        assert getattr(tsrv, f) == getattr(jsrv, f), f
    assert tsrv.metrics.value("alloc.allocs") == \
        jsrv.metrics.value("alloc.allocs")
    gate = accuracy_gate([r.out for r in jreqs], [r.out for r in treqs],
                         **GATE)
    assert gate["passed"], gate


@pytest.mark.parametrize("name", ["contig", "alt", "fpmix"])
def test_profile_scan_group_equals_unroll(models, name):
    _, tcfg, _, model = models
    tp, _ = _policies(_PROFILES[name])
    outs = {}
    for scan in ("group", "unroll"):
        srv = BatchedServer(tcfg, model, batch_size=2, max_len=32,
                            page_size=8, kv_profile=tp, kv_profile_scan=scan,
                            device=CPU)
        outs[scan] = [r.out for r in srv.run(_trace(Request,
                                                    tcfg.vocab_size))]
        assert srv.allocator.num_free == srv.allocator.num_usable
    assert outs["group"] == outs["unroll"]


def test_kernel_route_with_mixed_profile(models):
    """Twin of the reference's mixed-profile kernel test: int8, int4 and
    float layers, bucketed prefill and decode through the kernel route (its
    plain version on the CPU), against the gather route."""
    _, tcfg, _, model = models
    tp, _ = _policies([None, (2, 6), (2, 2), (2, 6)])
    mk = lambda: [Request(i, np.random.default_rng(i).integers(  # noqa
        0, tcfg.vocab_size, 7 + i).astype(np.int32), 5) for i in range(3)]
    outs = {}
    for impl in ("gather", "kernel"):
        srv = BatchedServer(tcfg, model, batch_size=2, max_len=32,
                            page_size=8, kv_profile=tp, attn_impl=impl,
                            prefill="bucketed", prefill_bucket=8, device=CPU)
        outs[impl] = srv.run(mk())
        assert all(r.done for r in outs[impl])
        assert [tpk.pool_container(p) for p in srv.caches] == \
            ["fp", "int8", "int4", "int8"]
    gate = accuracy_gate([r.out for r in outs["gather"]],
                         [r.out for r in outs["kernel"]], **GATE)
    assert gate["passed"], gate


def test_per_layer_profile_shrinks_at_rest_bytes(models):
    _, tcfg, _, model = models
    tp, _ = _policies(_PROFILES["alt"])
    mk = lambda **kw: BatchedServer(tcfg, model, batch_size=2,  # noqa
                                    max_len=32, page_size=8, device=CPU,
                                    **kw)
    nbytes = {k: sum(tpk.caches_kv_bytes(mk(**kw).caches).values())
              for k, kw in (("prof", dict(kv_profile=tp)),
                            ("u8", dict(kv_bits=8)), ("u4", dict(kv_bits=4)))}
    assert nbytes["u4"] < nbytes["prof"] < nbytes["u8"], nbytes


def test_kv_profile_validation(models):
    _, tcfg, _, model = models
    profile = PrecisionPolicy.uniform(
        [f"layer_{i:03d}" for i in range(tcfg.num_layers)], None,
        FixedPointFormat(2, 6))
    with pytest.raises(ValueError, match="paged"):
        BatchedServer(tcfg, model, batch_size=2, max_len=32,
                      kv_profile=profile, device=CPU)
    with pytest.raises(ValueError, match="supersedes"):
        BatchedServer(tcfg, model, batch_size=2, max_len=32, page_size=8,
                      kv_bits=8, kv_profile=profile, device=CPU)
    with pytest.raises(ValueError, match="kv_profile_scan"):
        BatchedServer(tcfg, model, batch_size=2, max_len=32, page_size=8,
                      kv_profile=profile, kv_profile_scan="scan",
                      device=CPU)
    with pytest.raises(ValueError, match="kv-scale page"):
        BatchedServer(tcfg, model, batch_size=2, max_len=32, page_size=8,
                      kv_scale="page", device=CPU)

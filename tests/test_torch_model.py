"""Port parity, dense decoder: the JAX init converted with
``params_from_numpy`` gives the reference's hidden states and logits
(float32, 1e-4) on the qwen2-72b smoke config, through a padded chunk
prefill, a second chunk starting mid-page and decode steps, on paged fp,
int8 and int4 caches, through the gather route and the kernel route (its
plain version on the CPU; the reference's Pallas kernel in interpret
mode). Integer pool pages equal the reference's byte for byte; and, given
the same float K/V, every pool write the port's model makes stores exactly
what the reference's ``paged_update`` stores."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import perturbed_jax_params, t, torch_model  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.fixedpoint import FixedPointFormat as JFormat  # noqa: E402
from repro.core.paged_kv import PagedCacheSpec as JSpec  # noqa: E402
from repro.core.paged_kv import init_paged_pool as jinit_pool  # noqa: E402
from repro.core.paged_kv import iter_kv_pools  # noqa: E402
from repro.core.paged_kv import PagedKVLayout as JLayout  # noqa: E402
from repro.core.paged_kv import paged_update as jpaged_update  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.quant.apply import build_model_quant as jbuild  # noqa: E402
from repro_torch.core.fixedpoint import FixedPointFormat  # noqa: E402
from repro_torch.core.paged_kv import PagedCacheSpec  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.quant.apply import build_model_quant  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
PS, NP, B = 8, 4, 2
_BITS = {"fp": 0, "int8": 8, "int4": 4}


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg, jparams, tree = perturbed_jax_params("qwen2-72b")
    return jcfg, tcfg, jparams, torch_model(tree, tcfg)


def _quants(jcfg, tcfg, container):
    bits = _BITS[container]
    if not bits:
        return None, None
    names = [f"layer_{i:03d}" for i in range(tcfg.num_layers)]
    tq = build_model_quant(
        PrecisionPolicy.uniform(names, None, FixedPointFormat(2, bits - 2)),
        tcfg, quantize_activations=False, kv_container=container)
    jq = jbuild(JPolicy.uniform(names, None, JFormat(2, bits - 2)), jcfg,
                quantize_activations=False, kv_container=container)
    return tq, jq


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
@pytest.mark.parametrize("container", ["fp", "int8", "int4"])
def test_forward_matches_reference(models, container, attn_impl,
                                   monkeypatch):
    jcfg, tcfg, jparams, model = models
    tq, jq = _quants(jcfg, tcfg, container)
    num_pages = 1 + B * NP + 3
    rng = np.random.default_rng(_BITS[container] + len(attn_impl))
    ids = np.arange(1, num_pages)
    rng.shuffle(ids)
    table = ids[:B * NP].reshape(B, NP).astype(np.int32)
    jimpl = {"gather": "gather", "kernel": "pallas"}[attn_impl]

    writes = []                      # every pool write the port makes
    real_update = tattn.paged_update

    def recording_update(pool, k, v, page_table, pos, **kw):
        writes.append((k.clone(), v.clone(), page_table.clone(),
                       torch.as_tensor(pos).clone(), kw))
        return real_update(pool, k, v, page_table, pos, **kw)

    monkeypatch.setattr(tattn, "paged_update", recording_update)

    tcaches = ttr.init_cache(tcfg, tq, PagedCacheSpec(PS, num_pages),
                             torch.device("cpu"))
    jcaches = jtr.init_cache(jcfg, B, NP * PS, jq, paged=JSpec(PS, num_pages))
    pt_t, pt_j = t(table), jnp.asarray(table)

    # (tokens per row, start positions, valid lengths): a padded chunk
    # prefill, a second chunk that starts mid-page, then decode steps
    steps = [(11, [0, 3], [11, 7]), (6, [11, 10], [6, 6])]
    steps += [(1, [17 + i, 16 + i], None) for i in range(3)]
    for S, start, valid in steps:
        tok = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
        start = np.asarray(start, np.int32)
        kw = {} if valid is None else {
            "kv_valid_len": np.asarray(valid, np.int32)}
        th, tlog, tcaches, _ = ttr.forward(
            model, t(tok), tcfg, quant=tq, caches=tcaches,
            cache_pos=t(start), page_table=pt_t, attn_impl=attn_impl,
            **{k: t(v) for k, v in kw.items()})
        jh, jlog, jcaches, _ = jtr.forward(
            jparams, {"tokens": jnp.asarray(tok)}, jcfg, quant=jq,
            caches=jcaches, cache_pos=jnp.asarray(start), page_table=pt_j,
            attn_impl=jimpl, **{k: jnp.asarray(v) for k, v in kw.items()})
        n = S if valid is None else min(valid)
        np.testing.assert_allclose(th.numpy()[:, :n], np.asarray(jh)[:, :n],
                                   **TOL)
        np.testing.assert_allclose(tlog.numpy()[:, :n],
                                   np.asarray(jlog)[:, :n], **TOL)

    jpools = list(_reference_pools(jcaches))
    assert len(jpools) == len(tcaches) == tcfg.num_layers
    for tp, jp in zip(tcaches, jpools):
        if container == "fp":
            # float K/V differ by ULPs between XLA's and torch's GEMMs
            for name in ("k_pages", "v_pages"):
                np.testing.assert_allclose(tp[name][1:].numpy(),
                                           np.asarray(jp[name][1:]), **TOL)
        else:
            for name in ("k_pages", "v_pages"):
                np.testing.assert_array_equal(tp[name][1:].numpy(),
                                              np.asarray(jp[name][1:]))
        for name in ("k_scale", "v_scale"):
            np.testing.assert_array_equal(tp[name].numpy(),
                                          np.asarray(jp[name]))

    # replay the port's exact float K/V through the reference writer
    assert len(writes) == len(steps) * tcfg.num_layers
    layout = JLayout(num_pages, PS, tcfg.num_kv_heads, tcfg.head_dim,
                     container, jnp.float32)
    replay = [jinit_pool(layout) for _ in range(tcfg.num_layers)]
    for w, (k, v, page_table, pos, kw) in enumerate(writes):
        li = w % tcfg.num_layers
        vl = kw.pop("valid_len")
        assert kw.pop("amax_reduce") is None   # one device: every KV head
        replay[li] = jpaged_update(
            replay[li], jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
            jnp.asarray(page_table.numpy()), jnp.asarray(pos.numpy()),
            valid_len=None if vl is None else jnp.asarray(vl.numpy()), **kw)
    for tp, jp in zip(tcaches, replay):
        for name in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(tp[name][1:].numpy(),
                                          np.asarray(jp[name][1:]))
        for name in ("k_scale", "v_scale"):
            np.testing.assert_array_equal(tp[name].numpy(),
                                          np.asarray(jp[name]))


def _reference_pools(jcaches):
    """The reference's per-layer pools, unstacked from the scan layout."""
    for pool, axis in iter_kv_pools(jcaches):
        if axis == 0:
            yield pool
            continue
        for i in range(pool["k_pages"].shape[0]):
            yield {k: v[i] for k, v in pool.items()}


def test_params_from_numpy_unstacks_layers(models):
    """Layer i of the port holds period i of the reference's scan-stacked
    leaves, in the compute dtype; norm scales stay float32."""
    jcfg, tcfg, jparams, model = models
    seg = jparams["segments"][0][0]
    for li, blk in enumerate(model.layers):
        np.testing.assert_array_equal(blk.attn.wq.numpy(),
                                      np.asarray(seg["mixer"]["wq"][li]))
        np.testing.assert_array_equal(blk.attn.bk.numpy(),
                                      np.asarray(seg["mixer"]["bk"][li]))
        np.testing.assert_array_equal(blk.mlp.w_down.numpy(),
                                      np.asarray(seg["ffn"]["w_down"][li]))
        np.testing.assert_array_equal(blk.norm2.numpy(),
                                      np.asarray(seg["norm2"]["scale"][li]))
        assert blk.norm1.dtype == torch.float32
    assert model.head.dtype == tcfg.torch_dtype


def test_entry_points_default_to_cuda():
    """Without a card, asking for the default device raises instead of
    falling back to the CPU; every family builds on the CPU (the encoder
    with its GELU FFN, the VLM with tied embeddings)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.mlp import GeluMLP
    cfg = get_smoke_config("qwen2-72b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.init_model(cfg)
    enc = ttr.init_model(get_smoke_config("hubert-xlarge"), device="cpu")
    assert all(isinstance(b.mlp, GeluMLP) for b in enc.layers)
    vlm = ttr.init_model(get_smoke_config("qwen2-vl-2b"), device="cpu")
    assert vlm.head is None and vlm.layers[0].attn.has_bias
    m = ttr.init_model(cfg, seed=3, device="cpu")
    m2 = ttr.init_model(cfg, seed=3, device="cpu")
    assert torch.equal(m.layers[1].attn.wq, m2.layers[1].attn.wq)
    std = float(m.layers[0].mlp.w_gate.std())
    assert abs(std - 0.88 / np.sqrt(cfg.d_model)) < 0.1 / np.sqrt(
        cfg.d_model)   # truncated N(0,1) at +-2 has std 0.88

"""Port parity, per-page KV scales (``--kv-scale page``): given the same
float K/V, the port's page-scale write stores the reference's page bytes
and scales exactly (int8 and int4, chunks that start mid-page, recycled
pages holding garbage, padded chunk tails, tokens past the table span);
the page-scale sharing contract holds in the server; and page-scale
serving with the prefix cache counts what the reference counts, with
tokens that pass the accuracy gate."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import perturbed_jax_params, t, torch_model  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.lm_precision import accuracy_gate  # noqa: E402
from repro.core import paged_kv as jpk  # noqa: E402
from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro_torch.core import paged_kv as tpk  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402

CPU = torch.device("cpu")
KV, HD, PS, NP = 2, 16, 4, 10


def _garbage_pools(container, rng):
    """The same pool in both packages, every page holding a random grid and
    a random scale, as recycled pages do."""
    tl = tpk.PagedKVLayout(NP, PS, KV, HD, container)
    hdw = tl.store_head_dim
    pools = {}
    for name in ("k_pages", "v_pages"):
        if container == "int4":
            g = rng.integers(-2 ** 31, 2 ** 31, (NP, PS, KV, hdw),
                             dtype=np.int64).astype(np.int32)
        else:
            g = rng.integers(-127, 128, (NP, PS, KV, hdw)).astype(np.int8)
        pools[name] = g
    for name in ("k_scale", "v_scale"):
        pools[name] = rng.uniform(0.001, 0.05, NP).astype(np.float32)
    tp = {k: t(v) for k, v in pools.items()}
    jp = {k: jnp.asarray(v) for k, v in pools.items()}
    return tp, jp


def _assert_equal(tp, jp):
    """Pages 1.. and their scales byte for byte (page 0 is the scratch
    page, where colliding writes land in an unspecified order)."""
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tp[name][1:].numpy(),
                                      np.asarray(jp[name])[1:],
                                      err_msg=name)


# (pos per row, S, valid_len per row or None) over a 3-page table per row:
# a prompt chunk from offset 0, a chunk starting mid-page (the scale of its
# first page may rise and requantize earlier tokens), decode steps, a
# padded tail, and a chunk running past the 3-page span (out-of-span
# tokens go to the scratch page, not the last page)
_WRITES = [
    ([0, 0], 6, None),
    ([6, 6], 3, None),
    ([9, 9], 1, None),
    ([10, 10], 1, None),
    ([11, 11], 4, [1, 3]),
    ([11, 11], 5, None),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("container", ["int8", "int4"])
def test_page_scale_update_matches_reference(container, seed):
    rng = np.random.default_rng(seed)
    tp, jp = _garbage_pools(container, rng)
    table = np.array([[3, 7, 1], [2, 9, 5]], np.int32)
    for pos, S, vl in _WRITES:
        # a growing magnitude so later writes raise earlier pages' scales
        k = (rng.normal(size=(2, S, KV, HD)) * rng.uniform(0.2, 3.0)
             ).astype(np.float32)
        v = (rng.normal(size=(2, S, KV, HD)) * rng.uniform(0.2, 3.0)
             ).astype(np.float32)
        kw = dict(page_size=PS, container=container, scale_mode="page")
        tpk.paged_update(tp, t(k), t(v), t(table), t(np.array(pos)),
                         valid_len=None if vl is None else t(np.array(vl)),
                         **kw)
        jp = jpk.paged_update(jp, jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(table),
                              jnp.asarray(pos, jnp.int32),
                              valid_len=(None if vl is None else
                                         jnp.asarray(vl, jnp.int32)), **kw)
        _assert_equal(tp, jp)


@pytest.mark.parametrize("container", ["int8", "int4"])
def test_page_scale_round_trip_and_fresh_pages(container):
    """Pages written from offset 0 ignore their old scale; a scale raise
    keeps earlier tokens within half a step of their floats."""
    rng = np.random.default_rng(5)
    tp, _ = _garbage_pools(container, rng)
    table = torch.tensor([[4, 6]], dtype=torch.int32)
    small = torch.full((1, 3, KV, HD), 0.01)
    tpk.paged_update(tp, small, small, table, 0, page_size=PS,
                     container=container, scale_mode="page")
    qmax = 127 if container == "int8" else 7
    assert tp["k_scale"][4].item() == pytest.approx(0.01 / qmax)
    big = torch.randn(1, 3, KV, HD) * 4
    tpk.paged_update(tp, big, big, table, 3, page_size=PS,
                     container=container, scale_mode="page")
    k, _ = tpk.paged_gather(tp, table, container=container, head_dim=HD)
    want = torch.cat([small, big], 1)[0]
    step = torch.tensor([tp["k_scale"][4], tp["k_scale"][4],
                         tp["k_scale"][4], tp["k_scale"][4],
                         tp["k_scale"][6], tp["k_scale"][6]])
    err = (k[0, :6] - want).abs().amax(dim=(-2, -1))
    assert (err <= step / 2 + 1e-7).all(), (err, step)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jcfg, tcfg, jparams, tree = perturbed_jax_params("qwen2-72b", seed=2)
    return jcfg, tcfg, jparams, torch_model(tree, tcfg)


def test_page_scale_sharing_preserves_sharer_bytes(models):
    """The twin of the reference's sharing-contract test: page mode caches
    only full prompt pages, and a request that aliases a cached page and
    decodes past it leaves that page's bytes and scales untouched."""
    _, tcfg, _, model = models
    srv = BatchedServer(tcfg, model, batch_size=2, max_len=48, kv_bits=8,
                        page_size=8, kv_scale="page", prefix_cache="on",
                        prefill="bucketed", prefill_bucket=8,
                        prefill_batch=1, device=CPU)
    rng = np.random.default_rng(7)
    base = rng.integers(0, tcfg.vocab_size, 11).astype(np.int32)
    srv.run([Request(0, base, 4)])
    hit = srv.prefix_cache.lookup(base)
    assert len(hit.nodes) == 1 and hit.matched == 8
    assert hit.cow_node is None, "partial tail leaked into the cache"
    shared = int(hit.nodes[0].page)
    before = [{k: v[shared].clone() for k, v in pool.items()}
              for pool in srv.caches]
    ext = Request(1, np.concatenate(
        [base, rng.integers(0, tcfg.vocab_size, 6).astype(np.int32)]), 8)
    srv.run([ext])
    assert ext.done and ext.error is None
    assert srv.prefix_cache.stats()["hits"] >= 1
    for pool, old in zip(srv.caches, before):
        for k in pool:
            assert torch.equal(pool[k][shared], old[k]), k
    assert srv.release_prefix_cache() == 0
    assert srv.allocator.num_free == srv.allocator.num_usable


def test_ensure_page_asserts_the_sharing_contract(models):
    _, tcfg, _, model = models
    srv = BatchedServer(tcfg, model, batch_size=1, max_len=32, kv_bits=8,
                        page_size=8, kv_scale="page", device=CPU)
    srv._ensure_page(0, 3)
    srv.allocator.incref(srv.slot_pages[0][0])      # a second reader
    with pytest.raises(AssertionError, match="CoW-shared"):
        srv._ensure_page(0, 4)


def _counters(srv):
    st = srv.prefix_cache.stats()
    return {"prefill_forwards": srv.prefill_forwards,
            "prefill_forwards_saved": srv.prefill_forwards_saved,
            "decode_steps": srv.decode_steps,
            "allocs": srv.metrics.value("alloc.allocs"),
            "hits": st["hits"], "hit_tokens": st["hit_tokens"],
            "cow_copies": st["cow_copies"], "evictions": st["evictions"],
            "inserted_pages": st["inserted_pages"],
            "wave_dedup_pages": srv.wave_dedup_pages}


def _shared_prompts(cls, vocab):
    rng = np.random.default_rng(3)
    sys_p = rng.integers(0, vocab, 13).astype(np.int32)
    reqs = [cls(i, np.concatenate([sys_p, rng.integers(
        0, vocab, 3 + 2 * i).astype(np.int32)]), 4 + i % 3)
        for i in range(5)]
    reqs.append(cls(5, reqs[1].prompt.copy(), 5))
    return reqs


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_page_scale_serving_matches_reference(models, kv_bits):
    jcfg, tcfg, jparams, model = models
    kw = dict(batch_size=3, max_len=48, page_size=8, prefill_bucket=8,
              kv_bits=kv_bits, kv_scale="page", prefix_cache="on")
    jsrv = JServer(jcfg, jparams, **kw)
    jreqs = jsrv.run(_shared_prompts(JRequest, jcfg.vocab_size))
    for impl in ("gather", "kernel"):
        tsrv = BatchedServer(tcfg, model, attn_impl=impl, device=CPU, **kw)
        treqs = tsrv.run(_shared_prompts(Request, tcfg.vocab_size))
        assert _counters(tsrv) == _counters(jsrv), impl
        assert _counters(tsrv)["hits"] >= 3
        gate = accuracy_gate([r.out for r in jreqs], [r.out for r in treqs],
                             min_agreement=0.9, request_floor=0.5,
                             allowed_below_floor=0.15)
        assert gate["passed"], (impl, gate)
        assert tsrv.release_prefix_cache() == 0
        assert tsrv.allocator.num_free == tsrv.allocator.num_usable

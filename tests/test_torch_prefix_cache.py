"""Port parity, the shared-prefix page cache: the port's ``PrefixCache``
and the reference's, driven by the same random operations over their own
allocators, agree on every match, page, refcount and ``stats()``;
``copy_pool_pages`` copies the reference's bytes; inside the port,
serving with the prefix cache on gives exactly the tokens of serving
with it off (the twin of the reference's prefix identity script: an
11-token system prompt at page size 8, ``prefill_batch=1``, kv-bits 0, 8
and 4 and a per-layer profile, bucketed and stepwise); and hits, CoW
copies, evictions and wave-dedupe pages equal the reference server's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import perturbed_jax_params, t, torch_model  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.lm_precision import accuracy_gate  # noqa: E402
from repro.core import paged_kv as jpk  # noqa: E402
from repro.core.prefix_cache import PrefixCache as JCache  # noqa: E402
from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro_torch.core import paged_kv as tpk  # noqa: E402
from repro_torch.core.fixedpoint import FixedPointFormat  # noqa: E402
from repro_torch.core.policy import LayerPolicy, PrecisionPolicy  # noqa: E402
from repro_torch.core.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402

CPU = torch.device("cpu")
GATE = dict(min_agreement=0.9, request_floor=0.5, allowed_below_floor=0.15)


# ---------------------------------------------------------------------------
# the trie against the reference's, operation by operation
# ---------------------------------------------------------------------------
def _hit_view(hit):
    return (hit.matched, hit.full_pages, hit.cow_page, hit.cow_valid)


def _refcounts(al):
    return [al.refcount(p) for p in range(al.num_pages)]


@pytest.mark.parametrize("seed", range(6))
def test_cache_matches_reference_under_random_operations(seed):
    rng = np.random.default_rng(seed)
    ps = int(rng.choice([2, 3, 4]))
    caches = []
    for alloc_cls, cache_cls in ((tpk.PageAllocator, PrefixCache),
                                 (jpk.PageAllocator, JCache)):
        al = alloc_cls(48)
        c = cache_cls(al, ps)
        al.reclaim = c.evict
        caches.append((al, c))
    owned = [[], []]          # pages each "request" still references
    pinned = [[], []]
    common = list(rng.integers(0, 3, 7))
    for _ in range(60):
        op = rng.choice(["insert", "lookup", "pin", "unpin", "free",
                         "evict"], p=[0.3, 0.25, 0.1, 0.1, 0.15, 0.1])
        seq = (common[:rng.integers(0, 8)]
               + list(rng.integers(0, 3, rng.integers(0, 9))))
        key = str(rng.choice(["", "", "int4"]))
        n_evict = int(rng.integers(1, 4))
        record = bool(rng.integers(0, 2))
        outs = []
        for side, (al, c) in enumerate(caches):
            if op == "insert":
                n = -(-len(seq) // ps)
                if n > al.num_free:
                    outs.append(None)
                    continue
                pages = [al.alloc() for _ in range(n)]
                outs.append(c.insert(seq, pages, profile_key=key))
                owned[side].append(pages)
            elif op == "lookup":
                outs.append(_hit_view(c.lookup(seq, profile_key=key,
                                               record=record)))
            elif op == "pin":
                hit = c.lookup(seq, profile_key=key, record=False)
                c.pin(hit)
                pinned[side].append(hit)
                outs.append(_hit_view(hit))
            elif op == "unpin" and pinned[side]:
                c.unpin(pinned[side].pop(0))
            elif op == "free" and owned[side]:
                al.free(owned[side].pop(0))
            elif op == "evict":
                outs.append(c.evict(n_evict))
            outs.append([[n.page for n in c.peek_chain(seq, key)]])
        assert outs[:len(outs) // 2] == outs[len(outs) // 2:], op
        (ta, tc), (ja, jc) = caches
        assert _refcounts(ta) == _refcounts(ja)
        assert ta.num_free == ja.num_free
        assert tc.stats() == jc.stats()
        assert tc.evictable_pages() == jc.evictable_pages()
    for side, (al, c) in enumerate(caches):
        for hit in pinned[side]:
            c.unpin(hit)
        for pages in owned[side]:
            al.free(pages)
    assert caches[0][1].clear() == caches[1][1].clear() == 0
    assert caches[0][0].num_free == caches[0][0].num_usable
    assert caches[0][0].metrics.value("alloc.reclaims") == \
        caches[1][0].metrics.value("alloc.reclaims")


def _insert(cache, al, seq):
    pages = [al.alloc() for _ in range(-(-len(seq) // cache.page_size))]
    cache.insert(seq, pages)
    return pages


def test_heat_scores_and_lru_drop_match_reference():
    """The heat score (stamp + 16 per recorded hit) is the reference's; with
    no tier attached, eviction drops the least recently used leaf, as the
    reference's evict does without a tier or host store."""
    sides = []
    for alloc_cls, cache_cls in ((tpk.PageAllocator, PrefixCache),
                                 (jpk.PageAllocator, JCache)):
        al = alloc_cls(16)
        c = cache_cls(al, 2)
        hot = _insert(c, al, [0, 0])
        for _ in range(8):
            assert c.lookup([0, 0]).matched == 2
        cold = _insert(c, al, [1, 1])
        nodes = [c.lookup(s, record=False).nodes[0] for s in ([0, 0],
                                                            [1, 1])]
        heats = [c._heat(n) for n in nodes]
        al.free(hot)
        al.free(cold)
        c.lookup([1, 1], record=False)      # the cold node is now younger
        assert c.evict(1) == 1
        sides.append((heats, c.lookup([0, 0], record=False).matched,
                      c.lookup([1, 1], record=False).matched, c.stats()))
    assert sides[0] == sides[1]
    assert sides[0][0][0] > sides[0][0][1]       # hot outscores cold
    assert sides[0][1:3] == (0, 2)               # yet LRU drops the hot one


def test_profile_key_namespacing():
    al = tpk.PageAllocator(64)
    cache = PrefixCache(al, 2, profile_key="int8")
    pages = _insert(cache, al, [0, 1, 2, 3])
    assert cache.lookup([0, 1, 2, 3]).matched == 4
    assert cache.lookup([0, 1, 2, 3], profile_key="int4").matched == 0
    cache.insert([0, 1], [pages[0]], profile_key="int4")
    assert cache.lookup([0, 1], profile_key="int4").matched == 2
    assert {k for k, _, _ in cache.iter_chain_nodes()} == {"int8", "int4"}
    al.free(pages)
    # the page indexed under both keys holds two cache references, so
    # neither of its nodes is droppable (as in the reference)
    assert cache.clear() == 2 and al.refcount(pages[0]) == 2


def test_evict_keeps_ancestors_of_referenced_pages():
    al = tpk.PageAllocator(64)
    cache = PrefixCache(al, 2)
    pages = _insert(cache, al, [0, 1, 2, 3, 4, 5])
    al.free(pages[:2])
    assert cache.evictable_pages() == 0 and cache.evict(10) == 0
    al.free(pages[2:])
    assert cache.evictable_pages() == 3
    assert cache.clear() == 0


def test_tiers_are_not_ported():
    """The tiers were refused until they were ported; now a pager and a
    quant tier are accepted, and eviction tries them in the reference's
    order (requantize, demote, then drop), here with a tier that cannot
    narrow and a host tier without room, on both packages."""
    sides = []
    for alloc_cls, cache_cls in ((tpk.PageAllocator, PrefixCache),
                                 (jpk.PageAllocator, JCache)):
        calls = []

        class Tier:
            def room_pages(self):
                return 0

            def requantize(self, page, valid_len=None):
                calls.append(("requant", page, valid_len))
                return None

        class Host:
            def has_room(self, n=1):
                calls.append("host_room")
                return False

        class Pager:
            host = Host()

            def host_room(self):
                return 0

        al = alloc_cls(8)
        c = cache_cls(al, 2, pager=Pager(), tier=Tier())
        pages = _insert(c, al, [0, 1, 2])
        al.free(pages)
        assert c.evict(1) == 1
        sides.append((calls, c.stats()))
    assert sides[0] == sides[1]
    assert sides[0][0][0][0] == "requant" and sides[0][1]["evictions"] == 1


# ---------------------------------------------------------------------------
# copy-on-write bytes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("container,dtype", [
    ("int8", torch.float32), ("int4", torch.float32), ("fp", torch.float32),
    ("fp", torch.bfloat16)])
def test_copy_pool_pages_matches_reference(container, dtype):
    """Byte for byte against the reference's copy, a float pool's source
    scale folded into the copy (a non-unit source scale, as after a
    quant-tier restore, included); the source page stays as it was after
    the sharer extends its copy."""
    rng = np.random.default_rng(0)
    ps, kv, hd, n = 4, 2, 16, 6
    tl = tpk.PagedKVLayout(n, ps, kv, hd, container, dtype)
    shape = (n, ps, kv, tl.store_head_dim)
    if container == "fp":
        pages = rng.normal(size=shape).astype(np.float32)
    elif container == "int8":
        pages = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        pages = rng.integers(-2 ** 31, 2 ** 31, shape,
                             dtype=np.int64).astype(np.int32)
    scales = rng.uniform(0.01, 2.0, n).astype(np.float32)
    tp = {"k_pages": t(pages).to(tl.store_dtype),
          "v_pages": t(pages[::-1].copy()).to(tl.store_dtype),
          "k_scale": t(scales), "v_scale": t(scales[::-1].copy())}
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jp = {k: jnp.asarray(v.float().numpy() if v.dtype == torch.bfloat16
                         else v.numpy()) for k, v in tp.items()}
    if container == "fp":
        jp["k_pages"] = jp["k_pages"].astype(jdt)
        jp["v_pages"] = jp["v_pages"].astype(jdt)
    src = {k: v[2].clone() for k, v in tp.items()}
    tpk.copy_pool_pages(tp, 2, 3)
    jp = jpk.copy_pool_pages(jp, 2, 3)
    for k in tp:
        np.testing.assert_array_equal(tp[k].float().numpy(),
                                      np.asarray(jp[k], np.float32), k)
    if container == "fp":
        assert tp["k_scale"][3].item() == 1.0
    else:
        assert all(torch.equal(tp[k][3], src[k]) for k in tp)
    table = torch.tensor([[1, 3]], dtype=torch.int32)
    knew = torch.randn(1, 1, kv, hd)
    tpk.paged_update(tp, knew, knew, table, ps + 2, page_size=ps,
                     container=container, int_bits=2,
                     frac_bits=None if container == "fp" else
                     {"int8": 6, "int4": 2}[container])
    assert all(torch.equal(tp[k][2], src[k]) for k in tp)


# ---------------------------------------------------------------------------
# serving: prefix on == off inside the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jcfg, tcfg, jparams, tree = perturbed_jax_params("qwen2-72b", seed=2)
    return jcfg, tcfg, jparams, torch_model(tree, tcfg)


def _identity_trace(cls, vocab):
    """The reference identity script's trace: an 11-token system prompt
    (not page-aligned at page size 8: full-page aliasing and a CoW inside
    page 1), distinct suffixes, and a repeated prompt (a full-chain hit)."""
    sys_prompt = np.random.default_rng(11).integers(
        0, vocab, 11).astype(np.int32)
    r = np.random.default_rng(13)
    reqs = [cls(i, np.concatenate(
        [sys_prompt, r.integers(0, vocab, 2 + i).astype(np.int32)]),
        4 + i % 3) for i in range(4)]
    reqs.append(cls(4, reqs[0].prompt.copy(), 6))
    return reqs


def _profile(n_layers):
    return PrecisionPolicy(
        tuple(f"layer_{i:03d}" for i in range(n_layers)),
        tuple(LayerPolicy(None, FixedPointFormat(2, 6 if i % 2 == 0 else 2))
              for i in range(n_layers)))


@pytest.mark.parametrize("prefill", ["bucketed", "stepwise"])
@pytest.mark.parametrize("tag", ["kv0", "kv8", "kv4", "profile"])
def test_prefix_sharing_matches_unshared(models, tag, prefill):
    _, tcfg, _, model = models
    kw = ({"kv_profile": _profile(tcfg.num_layers)} if tag == "profile"
          else {"kv_bits": int(tag[2:])})
    base = dict(batch_size=2, max_len=32, page_size=8, prefill=prefill,
                prefill_bucket=8, prefill_batch=1, device=CPU, **kw)
    off = BatchedServer(tcfg, model, prefix_cache="off", **base)
    out_off = off.run(_identity_trace(Request, tcfg.vocab_size))
    on = BatchedServer(tcfg, model, prefix_cache="on", **base)
    out_on = on.run(_identity_trace(Request, tcfg.vocab_size))
    for a, b in zip(out_off, out_on):
        assert a.out == b.out, (tag, prefill, a.rid, a.out, b.out)
    assert all(r.done for r in out_on)
    st = on.prefix_cache.stats()
    assert st["hits"] >= 4 and st["cow_copies"] >= 1, st
    assert on.prefill_forwards < off.prefill_forwards
    assert on.release_prefix_cache() == 0
    assert on.allocator.num_free == on.allocator.num_usable


def _pool_pages(srv, pages):
    idx = torch.tensor(pages, dtype=torch.long)
    return [{k: v[idx].clone() for k, v in pool.items()}
            for pool in tpk.iter_kv_pools(srv.caches)]


@pytest.mark.parametrize("kv_scale", ["static", "page"])
def test_fused_follower_leaves_cached_prefix_intact(models, kv_scale):
    """A fused wave whose follower starts page-aligned past 0: a cached
    chain ends on a page boundary (in page-scale mode only whole pages are
    cached), and two same-wave prompts extend it by the same two pages.
    While the follower waits for its leader, its row in each fused round
    must not write the cached pages its table already aliases: their
    bytes and scales stay as they were, and the tokens equal serving with
    the prefix cache off."""
    _, tcfg, _, model = models
    rng = np.random.default_rng(21)
    sys_p = rng.integers(1, tcfg.vocab_size, 16).astype(np.int32)
    common = rng.integers(0, tcfg.vocab_size, 16).astype(np.int32)

    def waves():
        first = [Request(0, np.concatenate(
            [sys_p, rng2.integers(0, tcfg.vocab_size, 1)]).astype(np.int32),
            2)]
        second = [Request(1 + i, np.concatenate(
            [sys_p, common, rng2.integers(0, tcfg.vocab_size, 3 + 2 * i)])
            .astype(np.int32), 3) for i in range(2)]
        return first, second

    outs = {}
    for mode in ("off", "on"):
        rng2 = np.random.default_rng(22)
        srv = BatchedServer(tcfg, model, batch_size=3, max_len=64, kv_bits=8,
                            page_size=8, prefill_bucket=8, fused="on",
                            kv_scale=kv_scale, prefix_cache=mode, device=CPU)
        first, second = waves()
        srv.run(first)
        if mode == "on":
            cached = [n.page for n in
                      srv.prefix_cache.peek_chain(first[0].prompt[:-1])]
            assert len(cached) == 2
            before = _pool_pages(srv, cached)
        srv.run(second)
        outs[mode] = [r.out for r in first + second]
        if mode == "on":
            assert srv.wave_dedup_pages == 2          # the follower aliased
            assert srv.prefix_cache.stats()["hits"] >= 2
            for a, b in zip(before, _pool_pages(srv, cached)):
                for k in a:
                    assert torch.equal(a[k], b[k]), k
            assert srv.release_prefix_cache() == 0
            assert srv.allocator.num_free == srv.allocator.num_usable
    assert outs["on"] == outs["off"]


# ---------------------------------------------------------------------------
# serving: counters against the reference server
# ---------------------------------------------------------------------------
def _counters(srv):
    st = srv.prefix_cache.stats()
    return {"prefill_forwards": srv.prefill_forwards,
            "prefill_forwards_saved": srv.prefill_forwards_saved,
            "program_launches": srv.program_launches,
            "decode_steps": srv.decode_steps, "cycles": srv.cycles,
            "allocs": srv.metrics.value("alloc.allocs"),
            "reclaims": srv.metrics.value("alloc.reclaims"),
            "prefix_hit_tokens": srv.prefix_hit_tokens,
            "wave_dedup_pages": srv.wave_dedup_pages,
            "defers": srv.metrics.counter("sched.defers").value,
            "lookup_tokens": srv.prefix_cache.lookup_tokens,
            **{k: st[k] for k in ("lookups", "hits", "hit_tokens",
                                  "inserted_pages", "cow_copies",
                                  "evictions", "cached_pages")}}


_SERVE_CASES = {
    # batched waves (wave dedupe), fused rounds, and a pool small enough
    # that cached prefixes are evicted under pressure
    "wave": dict(batch_size=3, max_len=40, kv_bits=8),
    "fused": dict(batch_size=3, max_len=40, kv_bits=4, fused="on"),
    "evict": dict(batch_size=2, max_len=40, kv_bits=8, num_pages=9),
}


@pytest.mark.parametrize("case", list(_SERVE_CASES))
def test_prefix_counters_match_reference(models, case):
    jcfg, tcfg, jparams, model = models
    kw = dict(page_size=8, prefill_bucket=8, prefix_cache="on",
              **_SERVE_CASES[case])
    jsrv = JServer(jcfg, jparams, **kw)
    jreqs = jsrv.run(_identity_trace(JRequest, jcfg.vocab_size)
                     + _identity_trace(JRequest, jcfg.vocab_size)[1:3])
    tsrv = BatchedServer(tcfg, model, device=CPU, **kw)
    treqs = tsrv.run(_identity_trace(Request, tcfg.vocab_size)
                     + _identity_trace(Request, tcfg.vocab_size)[1:3])
    assert _counters(tsrv) == _counters(jsrv)
    if case == "evict":
        assert tsrv.prefix_cache.evictions > 0
    elif case == "wave":
        assert tsrv.wave_dedup_pages > 0
    gate = accuracy_gate([r.out for r in jreqs], [r.out for r in treqs],
                         **GATE)
    assert gate["passed"], gate
    assert tsrv.release_prefix_cache() == jsrv.release_prefix_cache() == 0
    assert tsrv.allocator.num_free == tsrv.allocator.num_usable


def test_serving_evicts_cached_prefixes_under_pressure(models):
    _, tcfg, _, model = models
    rng = np.random.default_rng(2)
    reqs = [Request(i, rng.integers(0, tcfg.vocab_size, 9).astype(np.int32),
                    6) for i in range(5)]
    srv = BatchedServer(tcfg, model, batch_size=1, max_len=32, kv_bits=8,
                        page_size=8, num_pages=5, prefix_cache="on",
                        device=CPU)
    srv.run(reqs)
    assert all(r.done and len(r.out) == 6 for r in reqs)
    assert srv.prefix_cache.evictions > 0
    assert srv.metrics.value("alloc.reclaims") > 0
    assert srv.release_prefix_cache() == 0
    assert srv.allocator.num_free == srv.allocator.num_usable


def test_prefix_validation_and_out_of_pages(models):
    _, tcfg, _, model = models
    with pytest.raises(ValueError, match="page-size"):
        BatchedServer(tcfg, model, batch_size=2, max_len=32,
                      prefix_cache="on", device=CPU)
    with pytest.raises(ValueError, match="prefix_cache"):
        BatchedServer(tcfg, model, batch_size=2, max_len=32, page_size=8,
                      prefix_cache="maybe", device=CPU)
    err = tpk.OutOfPagesError(needed=9, free=1, total=4, rid=3, reserved=2,
                              written=1, evictable=1)
    assert err.evictable == 1 and "evictable-cached" in str(err)
    srv = BatchedServer(tcfg, model, batch_size=2, max_len=64, kv_bits=8,
                        page_size=8, num_pages=4, prefix_cache="on",
                        device=CPU)
    rng = np.random.default_rng(0)
    with pytest.raises(tpk.OutOfPagesError) as ei:
        srv.run([Request(0, rng.integers(0, tcfg.vocab_size, 50)
                         .astype(np.int32), 40)])
    assert ei.value.needed > ei.value.total
    assert ei.value.written == 0 and ei.value.reserved == 0
    assert srv.allocator.num_free == srv.allocator.num_usable   # no pin leak

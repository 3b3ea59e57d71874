"""Port parity, the tiered page store: the reference's page-store tests
(``tests/test_page_store.py``) run on the port, each against the reference
on the same bytes. Blobs, requantized and widened blobs, snapshots and
geometry strings are byte-equal to the reference's for float, int8 and
int4 pools (static and per-page scales) and for a per-layer profile, whose
per-layer pools the port groups as the reference stacks them
(``paged_kv.kv_pool_groups``, ``group`` and ``unroll`` scan); snapshots
cross-load both ways, as pool records and between the two servers
(``snapshot_prefix_cache`` / ``restore_prefix_cache``); the pager, the
host tier, the quant tier and the allocator's pressure hooks keep the
reference's accounting."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_parity  # noqa: E402,F401  (JAX on the CPU, one torch thread)
import jax.numpy as jnp  # noqa: E402

from repro.core import page_store as jps  # noqa: E402
from repro.core import paged_kv as jpk  # noqa: E402
from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro_torch.core import page_store as tps  # noqa: E402
from repro_torch.core import paged_kv as tpk  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402

_PROFILE = ("fp", "int8", "int8", "int4", "int4", "fp")
_LAYOUTS = {
    # name: (per-layer containers, scale mode, scan)
    "fp": (("fp",) * 3, "static", "group"),
    "int8": (("int8",) * 3, "static", "group"),
    "int4": (("int4",) * 3, "static", "group"),
    "int8-page": (("int8",) * 3, "page", "group"),
    "int4-page": (("int4",) * 3, "page", "group"),
    "profile-group": (_PROFILE, "static", "group"),
    "profile-unroll": (_PROFILE, "static", "unroll"),
}


def _pools(containers, *, seed=0, num_pages=6, ps=4, KV=2, hd=16,
           scale_mode="static", pages=(1, 2), tokens=None,
           dtype=torch.float32):
    """One port pool per layer with ``pages`` written through the port's
    update path (int containers hold real grids and scales). ``tokens`` <
    len(pages) * ps leaves the last page partly written."""
    rng = np.random.default_rng(seed)
    caches = []
    pt = torch.tensor([list(pages)], dtype=torch.int32)
    for li, cont in enumerate(containers):
        layout = tpk.PagedKVLayout(num_pages, ps, KV, hd, cont, dtype)
        pool = tpk.init_paged_pool(layout, torch.device("cpu"))
        bits = {"int8": 8, "int4": 4}.get(cont, 0)
        for t in range(len(pages) * ps if tokens is None else tokens):
            k = torch.from_numpy((rng.normal(size=(1, 1, KV, hd))
                                  * (0.1 + 0.2 * t + 0.1 * li))
                                 .astype(np.float32))
            v = torch.from_numpy((rng.normal(size=(1, 1, KV, hd)) * 0.4)
                                 .astype(np.float32))
            tpk.paged_update(pool, k, v, pt, t, page_size=ps,
                             container=cont, int_bits=2 if bits else None,
                             frac_bits=(bits - 2) if bits else None,
                             scale_mode=scale_mode if bits else "static")
        caches.append(pool)
    return caches


def _layout(name, **kw):
    containers, scale_mode, scan = _LAYOUTS[name]
    return _pools(containers, scale_mode=scale_mode, **kw), scan


def _ref(caches, scan="group"):
    """The reference's cache structure holding the same bytes: one segment,
    a uniform cache one stacked pool, a profile a list of stacked runs
    (group) or of per-layer pools (unroll)."""
    recs = []
    for pools, axis in tpk.kv_pool_groups(caches, scan):
        if axis == 1:
            recs.append({k: jnp.asarray(np.stack([p[k].numpy()
                                                  for p in pools]))
                         for k in pools[0]})
        else:
            recs.append({k: jnp.asarray(v.numpy())
                         for k, v in pools[0].items()})
    uniform = len({(p["k_pages"].dtype, p["k_pages"].shape)
                   for p in tpk.iter_kv_pools(caches)}) == 1
    if uniform and scan == "group":
        return [(recs[0],)]
    return [(recs,)]


def _same_blob(a, b):
    """Byte-equal blobs: record count, field dtypes, shapes and bytes."""
    assert len(a.arrays) == len(b.arrays)
    for ra, rb in zip(a.arrays, b.arrays):
        for f in ("k", "v", "ks", "vs"):
            x, y = np.asarray(ra[f]), np.asarray(rb[f])
            assert x.dtype == y.dtype and x.shape == y.shape, (f, x.dtype,
                                                               y.dtype)
            assert x.tobytes() == y.tobytes(), f


def _page_state(caches, page):
    return [{k: v[page].clone() for k, v in p.items()}
            for p in tpk.iter_kv_pools(caches)]


def _assert_state_equal(a, b):
    for pa, pb in zip(a, b):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k


# ---------------------------------------------------------------------------
# extract / inject: byte-equal records, byte-identical round trip
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(_LAYOUTS))
def test_blob_and_geometry_match_reference(name):
    caches, scan = _layout(name, seed=1)
    ref = _ref(caches, scan)
    blob = tps.extract_page(caches, 2, scan=scan)
    want = jps.extract_page(ref, 2)
    _same_blob(blob, want)
    assert blob.nbytes == want.nbytes > 0
    assert blob.bytes_by_container() == want.bytes_by_container()
    assert tps.cache_geometry(caches, scan=scan) == jps.cache_geometry(ref)
    # inject into a different page: the source page's bytes arrive there,
    # and the source page stays as it was
    src = _page_state(caches, 2)
    assert tps.inject_page(caches, blob, 4, scan=scan) is caches
    _assert_state_equal(src, _page_state(caches, 4))
    _assert_state_equal(src, _page_state(caches, 2))
    ref = jps.inject_page(ref, want, 4)
    _same_blob(tps.extract_page(caches, 4, scan=scan),
               jps.extract_page(ref, 4))


def test_kv_pool_groups_follow_the_reference_stacking():
    caches = _pools(_PROFILE)
    group = tpk.kv_pool_groups(caches, "group")
    assert [(len(p), a) for p, a in group] == [(1, 1), (2, 1), (2, 1),
                                               (1, 1)]
    unroll = tpk.kv_pool_groups(caches, "unroll")
    assert [(len(p), a) for p, a in unroll] == [(1, 0)] * len(_PROFILE)
    assert [(len(p), a) for p, a in
            tpk.kv_pool_groups(_pools(("int8",) * 4))] == [(4, 1)]
    with pytest.raises(ValueError, match="scan"):
        tpk.kv_pool_groups(caches, "scan")


def test_extract_through_host_store_survives_page_reuse():
    """The blob is a host copy: rewriting the device page in place (the
    port's pools are written in place) leaves a parked blob intact."""
    caches = _pools(("int8",), seed=3)
    blob = tps.extract_page(caches, 1)
    snap = [{k: a.copy() for k, a in rec.items()} for rec in blob.arrays]
    host = tps.HostPageStore()
    h = host.put(blob)
    tps.inject_page(caches, tps.extract_page(caches, 2), 1)
    got = host.pop(h)
    for rec, ref in zip(got.arrays, snap):
        for k in rec:
            np.testing.assert_array_equal(rec[k], ref[k])
    assert host.num_pages == 0 and host.nbytes == 0


def test_host_store_accounting_and_capacity():
    caches = _pools(("int4",))
    blob = tps.extract_page(caches, 1)
    sides = []
    for store in (tps.HostPageStore(max_pages=2),
                  jps.HostPageStore(max_pages=2)):
        b = blob if isinstance(store, tps.HostPageStore) else \
            jps.extract_page(_ref(caches), 1)
        h1, h2 = store.put(b), store.put(b)
        assert store.num_pages == 2 and store.nbytes == 2 * b.nbytes
        assert not store.has_room(1)
        with pytest.raises(RuntimeError, match="host page tier full"):
            store.put(b)
        store.drop(h1)
        assert store.has_room(1) and store.drops == 1
        store.pop(h2)
        sides.append((store.num_pages, store.nbytes, store.peak_pages,
                      store.peak_bytes, store.puts, store.pops))
    assert sides[0] == sides[1] and sides[0][2] == 2
    assert set(blob.bytes_by_container()) == {"int4"}
    with pytest.raises(ValueError, match="max_pages"):
        tps.HostPageStore(max_pages=0)


def test_caches_kv_bytes_per_container_split():
    caches = _pools(("int8", "int8", "int4", "fp"))
    split = tpk.caches_kv_bytes(caches)
    assert split == jpk.caches_kv_bytes(_ref(caches))
    assert set(split) == {"int8", "int4", "fp"}
    # packed int4 stores 8 values a word: below one int8 layer's pool
    assert split["int4"] < split["int8"] // 2


# ---------------------------------------------------------------------------
# the pager against a live allocator, both modes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_pager_demote_promote_round_trip(mode):
    state = {"caches": _pools(("int8", "int8"), num_pages=8)}
    al = tpk.PageAllocator(8)
    host = tps.HostPageStore()
    pager = tps.TieredPager(al, host, lambda: state["caches"],
                            async_mode=mode == "async")
    page = al.alloc()
    tps.inject_page(state["caches"], tps.extract_page(state["caches"], 2),
                    page)
    ref = _page_state(state["caches"], page)
    h = pager.demote(page)
    assert al.refcount(page) == 0 and host.num_pages == 1
    # a later owner rewrites the freed page before the copy resolves
    tps.inject_page(state["caches"], tps.extract_page(state["caches"], 1),
                    page)
    assert pager.drain() == (1 if mode == "async" else 0)
    new_page = pager.promote(h)
    assert al.refcount(new_page) == 1 and host.num_pages == 0
    _assert_state_equal(ref, _page_state(state["caches"], new_page))
    assert pager.demotions == 1 and pager.promotions == 1
    assert pager.metrics.histogram("pager.demote_s").count == 1


def test_pager_prefetch_promote_equals_unstaged_promote(monkeypatch):
    """A prefetched handle promotes the same bytes as an unstaged one,
    counts a hit, and a handle dropped before its promote leaves the
    stage."""
    monkeypatch.setattr(tps, "_MAX_STAGED", 2)
    state = {"caches": _pools(("int4", "int4"), num_pages=10)}
    al = tpk.PageAllocator(10)
    pager = tps.TieredPager(al, tps.HostPageStore(),
                            lambda: state["caches"], async_mode=True)
    pages = [al.alloc() for _ in range(3)]
    for p, src in zip(pages, (1, 2, 1)):
        tps.inject_page(state["caches"],
                        tps.extract_page(state["caches"], src), p)
    want = [_page_state(state["caches"], p) for p in pages]
    hs = [pager.demote(p) for p in pages]
    assert pager.prefetch(hs[2]) == 0          # its copy is in flight
    pager.drain()
    assert pager.prefetch(hs[0]) == 1 and pager.prefetch(hs[0]) == 0
    assert pager.prefetch(hs[1]) == 1 and pager.prefetch(hs[2]) == 0
    pager.host.drop(hs[1])
    assert pager.stage_room() == 1
    got = [pager.promote(hs[0]), pager.promote(hs[2])]
    _assert_state_equal(want[0], _page_state(state["caches"], got[0]))
    _assert_state_equal(want[2], _page_state(state["caches"], got[1]))
    assert (pager.prefetches, pager.prefetch_hits) == (2, 1)
    sync = tps.TieredPager(al, tps.HostPageStore(), lambda: state["caches"])
    assert sync.prefetch(0) == 0


@pytest.mark.parametrize("staged", [False, True])
def test_pager_resume_uses_the_staged_upload(staged):
    """``resume`` (a preempted request's offloaded page) writes the parked
    bytes into a fresh page, from the staged upload when there is one; it
    counts no promotion and no prefetch hit (the reference's counters),
    only ``staged_resumes``."""
    state = {"caches": _pools(("int8", "int4"), num_pages=8)}
    al = tpk.PageAllocator(8)
    pager = tps.TieredPager(al, tps.HostPageStore(),
                            lambda: state["caches"], async_mode=True)
    page = al.alloc()
    want = _page_state(state["caches"], page)
    h = pager.offload(page)
    al.free([page])
    # the freed page's next owner rewrites it before the resume
    tps.inject_page(state["caches"], tps.extract_page(state["caches"], 2),
                    page)
    pager.drain()
    if staged:
        assert pager.prefetch(h) == 1
    new = pager.resume(h)
    _assert_state_equal(want, _page_state(state["caches"], new))
    assert al.refcount(new) == 1 and pager.host.num_pages == 0
    assert pager.stage_room() == tps._MAX_STAGED
    assert (pager.promotions, pager.prefetch_hits,
            pager.staged_resumes) == (0, 0, int(staged))


def test_extract_page_async_byte_identical_on_the_cpu():
    caches = _pools(("fp", "int8", "int4"), seed=4)
    want = tps.extract_page(caches, 2, scan="unroll")
    pending = tps.extract_page_async(caches, 2, scan="unroll")
    assert not pending.resolved and pending.nbytes == want.nbytes
    assert pending.bytes_by_container() == want.bytes_by_container()
    tps.inject_page(caches, tps.extract_page(caches, 1, scan="unroll"), 2,
                    scan="unroll")
    blob = pending.resolve()
    assert pending.resolve() is blob and pending.resolved
    _same_blob(blob, want)


# ---------------------------------------------------------------------------
# allocator pressure hooks and the host inventory
# ---------------------------------------------------------------------------
def test_allocator_pressure_callbacks_fire_in_order_after_reclaim():
    al = tpk.PageAllocator(3)                  # 2 usable
    calls, freed_pages = [], []

    def reclaim(n):
        calls.append("reclaim")
        return 0

    def cb(n):
        calls.append("pressure")
        if freed_pages:
            al.free([freed_pages.pop()])
        return 1

    al.reclaim = reclaim
    al.add_pressure(cb)
    p1, p2 = al.alloc(), al.alloc()
    freed_pages.append(p1)
    p3 = al.alloc()
    assert calls == ["reclaim", "pressure"] and p3 == p1
    with pytest.raises(tpk.OutOfPagesError):
        al.alloc()
    assert calls == ["reclaim", "pressure", "reclaim", "pressure"]
    al.free([p2, p3])
    assert al.metrics.value("alloc.reclaims") == 2


def test_out_of_pages_reports_host_inventory():
    msgs = []
    for cls in (tpk.PageAllocator, jpk.PageAllocator):
        al = cls(2)                            # 1 usable
        al.host_inventory = lambda: 7
        al.requant_inventory = lambda: 3
        al.alloc()
        with pytest.raises(Exception) as ei:
            al.alloc()
        assert ei.value.host_pages == 7 and ei.value.requantizable == 3
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "7 host-tier" in msgs[0]


# ---------------------------------------------------------------------------
# snapshots: the reference's format, cross-loaded both ways
# ---------------------------------------------------------------------------
def _entries(mod, caches):
    return [("int8|scale=static", [1, 2, 3, 4], mod.extract_page(caches, 1)),
            ("int8|scale=static", [1, 2, 3, 4, 9],
             mod.extract_page(caches, 2)),
            ("uniform4|scale=page", [5], mod.extract_page(caches, 2))]


def test_snapshot_save_load_round_trip(tmp_path):
    caches = _pools(("int4", "int8"))
    geo = tps.cache_geometry(caches)
    entries = _entries(tps, caches)
    path = str(tmp_path / "snap.npz")
    assert tps.save_prefix_snapshot(path, entries, page_size=4,
                                    geometry=geo) == 3
    meta, loaded = tps.load_prefix_snapshot(path)
    assert meta["page_size"] == 4 and meta["geometry"] == geo
    assert [(k, t) for k, t, _ in loaded] == [(k, t) for k, t, _ in entries]
    for (_, _, a), (_, _, b) in zip(entries, loaded):
        _same_blob(a, b)


@pytest.mark.parametrize("name", ["int8", "profile-group",
                                  "profile-unroll"])
def test_snapshot_files_match_and_cross_load(tmp_path, name):
    """The two packages write the same archive (header and arrays) for
    the same pages; either package's file loads through the other and
    injects the same bytes."""
    caches, scan = _layout(name, seed=5)
    ref = _ref(caches, scan)
    geo = tps.cache_geometry(caches, scan=scan)
    tp_, jp_ = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    tps.save_prefix_snapshot(tp_, [(k, t, tps.extract_page(caches, p,
                                                           scan=scan))
                                   for k, t, p in (("a", [1, 2], 1),
                                                   ("a", [1, 2, 3], 2))],
                             page_size=4, geometry=geo)
    jps.save_prefix_snapshot(jp_, [(k, t, jps.extract_page(ref, p))
                                   for k, t, p in (("a", [1, 2], 1),
                                                   ("a", [1, 2, 3], 2))],
                             page_size=4, geometry=jps.cache_geometry(ref))
    with np.load(tp_) as a, np.load(jp_) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype and a[f].tobytes() == \
                b[f].tobytes(), f
    # reference file -> port: the same bytes land in the port's pools
    meta, loaded = tps.load_prefix_snapshot(jp_)
    assert meta["geometry"] == geo
    tps.inject_page(caches, loaded[1][2], 5, scan=scan)
    _assert_state_equal(_page_state(caches, 2), _page_state(caches, 5))
    # port file -> reference
    jmeta, jloaded = jps.load_prefix_snapshot(tp_)
    assert jmeta["geometry"] == jps.cache_geometry(ref)
    ref = jps.inject_page(ref, jloaded[0][2], 5)
    _same_blob(jps.extract_page(ref, 5), tps.extract_page(caches, 1,
                                                          scan=scan))


def test_snapshot_path_without_npz_extension_round_trips(tmp_path):
    caches = _pools(("int8",))
    bare = str(tmp_path / "kvsnap")
    tps.save_prefix_snapshot(bare, [("k", [1, 2], tps.extract_page(caches,
                                                                   1))],
                             page_size=4, geometry=tps.cache_geometry(caches))
    assert tps.snapshot_path(bare) == jps.snapshot_path(bare)
    assert os.path.exists(tps.snapshot_path(bare))
    meta, loaded = tps.load_prefix_snapshot(bare)
    assert len(loaded) == 1 and meta["page_size"] == 4
    header = json.loads(str(np.load(tps.snapshot_path(bare))["__header__"]))
    assert header["version"] == jps.SNAPSHOT_VERSION


def test_bf16_pages_round_trip_through_host_and_snapshot(tmp_path):
    """numpy has no bfloat16: a bf16 page lives on the host as its 2-byte
    patterns (``V2``, as in an ``.npz`` the reference writes), counts as a
    float page, and comes back bit for bit."""
    caches = _pools(("fp", "fp"), dtype=torch.bfloat16, seed=6)
    blob = tps.extract_page(caches, 2)
    assert blob.arrays[0]["k"].dtype == np.dtype("V2")
    assert set(blob.bytes_by_container()) == {"fp"}
    assert json.loads(tps.cache_geometry(caches))[0][2] == "bfloat16"
    path = str(tmp_path / "bf16.npz")
    tps.save_prefix_snapshot(path, [("fp", [1], blob)], page_size=4,
                             geometry=tps.cache_geometry(caches))
    _, loaded = tps.load_prefix_snapshot(path)
    src = _page_state(caches, 2)
    tps.inject_page(caches, loaded[0][2], 5)
    _assert_state_equal(src, _page_state(caches, 5))
    # requantized on the host (exact bf16 -> float32 widening) and widened
    # back into the bf16 pool with the scale carried
    narrowed, n = tps.requantize_blob(blob, steps=1)
    assert n == 1 and tps._rec_container(narrowed.arrays[0]) == "int8"
    wide = tps.widen_blob(narrowed, caches)
    assert wide.arrays[0]["k"].dtype == np.dtype("V2")
    want = tps._dequant_plane(narrowed.arrays[0]["k"],
                              narrowed.arrays[0]["ks"], "int8", 16)
    got = tps._dequant_plane(wide.arrays[0]["k"], wide.arrays[0]["ks"],
                             "fp", 16)
    np.testing.assert_array_equal(want, got)


# ---------------------------------------------------------------------------
# online requantization and the quant tier
# ---------------------------------------------------------------------------
def test_narrower_container_ladder_and_floors():
    for cont in ("fp", "int8", "int4"):
        for hd in (8, 12, 16):
            for floor in (4, 8):
                assert tps.narrower_container(
                    cont, head_dim=hd, floor_bits=floor) == \
                    jps.narrower_container(cont, head_dim=hd,
                                           floor_bits=floor)
    assert tps.narrower_container("int8", head_dim=12) == "int8"
    assert tps.narrower_container("fp", head_dim=16) == "int8"


@pytest.mark.parametrize("name", ["fp", "int8", "int8-page",
                                  "profile-group"])
def test_requantize_matches_reference(name):
    """One step, all the way down, and a partial page's valid length: the
    port's narrowed blobs are the reference's byte for byte (float32 numpy,
    half to even), and one step loses at most half an LSB of the fresh
    grid."""
    caches, scan = _layout(name, seed=7, pages=(4, 2))   # fragmented
    ref = _ref(caches, scan)
    for kw in (dict(steps=1), dict(steps=None), dict(steps=1, valid_len=2),
               dict(steps=None, floor_bits=8)):
        got, n = tps.requantize_page(caches, 2, scan=scan, **kw)
        want, m = jps.requantize_page(ref, 2, **kw)
        assert n == m
        _same_blob(got, want)
    blob, narrowed = tps.requantize_page(caches, 2, steps=1, scan=scan)
    before = tps.extract_page(caches, 2, scan=scan)
    for b, a in zip(before.arrays, blob.arrays):
        cb, ca = tps._rec_container(b), tps._rec_container(a)
        if cb == ca:
            continue
        qmax = {"int8": 127.0, "int4": 7.0}[ca]
        for f, s in (("k", "ks"), ("v", "vs")):
            want = tps._dequant_plane(b[f], b[s], cb, 16)
            got = tps._dequant_plane(a[f], a[s], ca, 16)
            amax = np.max(np.abs(want))
            assert np.max(np.abs(want - got)) <= amax / (2 * qmax) * 1.001


def test_requantize_int4_already_at_floor_passes_through():
    caches = _pools(("int4",), seed=6)
    blob, narrowed = tps.requantize_page(caches, 1, steps=1)
    assert narrowed == 0
    _same_blob(blob, tps.extract_page(caches, 1))


def test_requantize_steps_none_reaches_floor_and_shrinks():
    caches = _pools(("fp",), seed=7)
    one, n1 = tps.requantize_page(caches, 1, steps=1)
    full, n2 = tps.requantize_page(caches, 1, steps=None)
    assert n1 == n2 == len(one.arrays)
    assert all(tps._rec_container(r) == "int8" for r in one.arrays)
    assert all(tps._rec_container(r) == "int4" for r in full.arrays)
    assert full.nbytes < one.nbytes < tps.extract_page(caches, 1).nbytes


def test_requantize_partial_page_masks_stale_slots():
    caches = _pools(("fp",), seed=8)
    blob, _ = tps.requantize_page(caches, 2, steps=1, valid_len=2)
    masked, _ = tps.requantize_page(_pools(("fp",), seed=8, tokens=6), 2,
                                    steps=1)
    for rec, ref in zip(blob.arrays, masked.arrays):
        k = tps._dequant_plane(rec["k"], rec["ks"], "int8", 16)
        assert np.all(k[..., 2:, :, :] == 0)
        np.testing.assert_allclose(rec["ks"], ref["ks"], rtol=1e-6)


@pytest.mark.parametrize("name", ["int8", "fp", "profile-unroll"])
def test_widen_blob_matches_reference(name):
    """Widening into each pool's container is the reference's byte for
    byte: int4 -> int8 as grid * 16 under scale / 16 (a bitwise equal
    dequant), any grid -> fp with the scale carried."""
    caches, scan = _layout(name, seed=9)
    ref = _ref(caches, scan)
    narrowed, _ = tps.requantize_page(caches, 1, steps=None, scan=scan)
    jnarrowed, _ = jps.requantize_page(ref, 1, steps=None)
    wide = tps.widen_blob(narrowed, caches, scan=scan)
    _same_blob(wide, jps.widen_blob(jnarrowed, ref))
    for nrec, wrec in zip(narrowed.arrays, wide.arrays):
        c_n, c_w = tps._rec_container(nrec), tps._rec_container(wrec)
        for f, s in (("k", "ks"), ("v", "vs")):
            np.testing.assert_array_equal(
                tps._dequant_plane(nrec[f], nrec[s], c_n, 16),
                tps._dequant_plane(wrec[f], wrec[s], c_w, 16))
    tps.inject_page(caches, wide, 4, scan=scan)
    _same_blob(tps.extract_page(caches, 4, scan=scan), wide)


def test_fp_restore_scale_roundtrip_recycle_and_cow():
    """A quant-tier restore into a float pool carries a non-unit scale: the
    gather reads it, a CoW copy folds it to a unit scale, and a fresh
    write at the page's offset 0 resets it."""
    ps, KV, hd = 4, 2, 16
    caches = _pools(("fp",), seed=13, num_pages=8)
    narrowed, _ = tps.requantize_page(caches, 1, steps=1)
    want = tps._dequant_plane(narrowed.arrays[0]["k"],
                              narrowed.arrays[0]["ks"], "int8", hd)
    tps.inject_page(caches, tps.widen_blob(narrowed, caches), 5)
    pool = caches[0]
    assert pool["k_scale"][5].item() != 1.0
    pt = torch.tensor([[5]], dtype=torch.int32)
    k, _ = tpk.paged_gather(pool, pt, container="fp")
    np.testing.assert_allclose(k[0].numpy(), want[0], atol=1e-6)
    tpk.copy_pool_pages(pool, 5, 6)
    assert pool["k_scale"][6].item() == 1.0
    k2, _ = tpk.paged_gather(pool, torch.tensor([[6]], dtype=torch.int32),
                             container="fp")
    np.testing.assert_allclose(k2.numpy(), k.numpy(), atol=1e-6)
    knew = torch.randn(1, 1, KV, hd)
    tpk.paged_update(pool, knew, knew, pt, 0, page_size=ps, container="fp")
    assert pool["k_scale"][5].item() == 1.0
    k3, _ = tpk.paged_gather(pool, pt, container="fp")
    assert torch.equal(k3[0, 0], knew[0, 0])


def _tiers(caches, scan="group", **kw):
    """The port's quant tier and the reference's over the same bytes."""
    state = {"t": caches, "j": _ref(caches, scan)}
    t = tps.QuantTierStore(lambda: state["t"], scan=scan, **kw)
    j = jps.QuantTierStore(lambda: state["j"],
                           lambda c: state.update(j=c), **kw)
    return state, t, j


def _tier_view(tier):
    return (tier.page_bytes_step, tier.page_bytes_floor, tier.max_bytes,
            tier.nbytes, tier.num_pages, tier.puts, tier.pops, tier.drops,
            tier.deepens, tier.peak_pages, tier.peak_bytes,
            tier.room_pages(), tier.bytes_by_container())


@pytest.mark.parametrize("name", ["fp", "profile-group"])
def test_quant_tier_park_deepen_restore_accounting(name):
    caches, scan = _layout(name, seed=10, num_pages=8)
    state, t, j = _tiers(caches, scan, pages=2)
    assert t.page_bytes_floor < t.page_bytes_step
    bt, bj = t.requantize(1), j.requantize(1)
    _same_blob(bt, bj)
    ht, hj = t.put(bt), j.put(bj)
    assert _tier_view(t) == _tier_view(j)
    freed = t.deepen(ht)
    assert freed > 0 and freed == j.deepen(hj)
    assert t.deepen(ht) == j.deepen(hj) == 0
    _same_blob(t.export(ht), j.export(hj))
    t.restore(ht, 5)
    j.restore(hj, 5)
    assert _tier_view(t) == _tier_view(j) and t.num_pages == 0
    _same_blob(tps.extract_page(state["t"], 5, scan=scan),
               jps.extract_page(state["j"], 5))


def test_quant_tier_deepen_at_the_floor_copies_nothing(monkeypatch):
    """Deepening a page already at its floor returns 0 before reading the
    parked records back (the reference copies them out first), and the
    call is timed all the same."""
    state, t, j = _tiers(_pools(("fp",), seed=12, num_pages=8), pages=2)
    ht, hj = t.put(t.requantize(1)), j.put(j.requantize(1))
    assert t.deepen(ht) == j.deepen(hj) > 0
    monkeypatch.setattr(t, "_host_blob", None)   # any read would raise
    assert t.deepen(ht) == j.deepen(hj) == 0
    assert _tier_view(t) == _tier_view(j)
    assert t.metrics.histogram("tier.deepen_s").count == 2


def test_quant_tier_byte_budget_enforced():
    state, t, _ = _tiers(_pools(("fp",), seed=11, num_pages=8), pages=2)
    h1 = t.put(t.requantize(1))
    b2 = t.requantize(2)
    assert not t.has_room(b2)
    with pytest.raises(RuntimeError, match="byte budget"):
        t.put(b2)
    t.deepen(h1)
    b2d, _ = tps.requantize_blob(b2, steps=None)
    assert t.has_room(b2d)
    h2 = t.put(b2d)
    t.drop(h1)
    t.drop(h2)
    assert t.num_pages == 0 and t.nbytes == 0 and t.drops == 2


def test_quant_tier_rejects_pools_with_nothing_to_narrow():
    with pytest.raises(ValueError, match="nothing to narrow"):
        tps.QuantTierStore(lambda: _pools(("int4",)), pages=2)
    with pytest.raises(ValueError, match="nothing to narrow"):
        tps.QuantTierStore(lambda: _pools(("int8",)), pages=2,
                           floor_bits=8)
    with pytest.raises(ValueError, match="floor_bits"):
        tps.QuantTierStore(lambda: _pools(("fp",)), pages=2,
                           floor_bits=6)


def test_cache_geometry_detects_mismatch():
    a = tps.cache_geometry(_pools(("int8",)))
    assert a == tps.cache_geometry(_pools(("int8",), num_pages=9))
    assert a != tps.cache_geometry(_pools(("int4",)))
    assert a != tps.cache_geometry(_pools(("int8",), hd=8))
    prof = _pools(_PROFILE)
    assert tps.cache_geometry(prof) != tps.cache_geometry(prof,
                                                          scan="unroll")


@pytest.fixture(scope="module")
def models():
    from _torch_parity import perturbed_jax_params, torch_model
    jcfg, tcfg, jparams, tree = perturbed_jax_params("qwen2-72b", seed=2)
    return jcfg, tcfg, jparams, torch_model(tree, tcfg)


# ---------------------------------------------------------------------------
# prefix snapshots exchanged between the two servers
# ---------------------------------------------------------------------------
def _snap_trace(cls, vocab):
    """Four prompts over one 19-token system prompt (two full pages and a
    partial one at page size 8)."""
    rng = np.random.default_rng(41)
    sys_p = rng.integers(0, vocab, 19).astype(np.int32)
    return [cls(i, np.concatenate([sys_p, rng.integers(0, vocab, 3 + i)
                                   .astype(np.int32)]), 3)
            for i in range(4)]


@pytest.mark.parametrize("scan", ["group", "unroll"])
def test_snapshots_cross_load_between_servers(models, tmp_path, scan):
    """A snapshot either server writes restores into the other (same
    geometry, same chains), and a restored server promotes the host pages
    on its first hits."""
    from repro.core.policy import LayerPolicy as JLayer
    from repro.core.policy import PrecisionPolicy as JPolicy
    from repro.core.fixedpoint import FixedPointFormat as JFmt
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.policy import LayerPolicy, PrecisionPolicy
    jcfg, tcfg, jparams, model = models
    n = tcfg.num_layers
    fmts = [None if i == 0 else (2, 2 if i % 2 else 6) for i in range(n)]
    tprof = PrecisionPolicy(tuple(f"layer_{i:03d}" for i in range(n)),
                            tuple(LayerPolicy(None, f and FixedPointFormat(*f))
                                  for f in fmts))
    jprof = JPolicy(tuple(f"layer_{i:03d}" for i in range(n)),
                    tuple(JLayer(None, f and JFmt(*f)) for f in fmts))
    kw = dict(batch_size=2, max_len=48, page_size=8, prefill_bucket=8,
              prefix_cache="on", kv_offload="host", kv_profile_scan=scan)
    tsrv = BatchedServer(tcfg, model, kv_profile=tprof,
                         device=torch.device("cpu"), **kw)
    tsrv.run(_snap_trace(Request, tcfg.vocab_size))
    jsrv = JServer(jcfg, jparams, kv_profile=jprof, **kw)
    jsrv.run(_snap_trace(JRequest, jcfg.vocab_size))
    tp_, jp_ = str(tmp_path / "port"), str(tmp_path / "ref")
    assert tsrv.snapshot_prefix_cache(tp_) == jsrv.snapshot_prefix_cache(jp_)
    fresh_j = JServer(jcfg, jparams, kv_profile=jprof, **kw)
    fresh_t = BatchedServer(tcfg, model, kv_profile=tprof,
                            device=torch.device("cpu"), **kw)
    n_j = fresh_j.restore_prefix_cache(tp_)
    n_t = fresh_t.restore_prefix_cache(jp_)
    assert n_j == n_t == tsrv.prefix_cache.stats()["inserted_pages"] > 0
    fresh_t.run(_snap_trace(Request, tcfg.vocab_size))
    st = fresh_t.prefix_cache.stats()
    assert st["promotions"] >= 1 and st["restored_pages"] == n_t
    assert fresh_t.release_prefix_cache() == 0
    assert fresh_t.host_store.num_pages == 0
    with pytest.raises(ValueError, match="geometry"):
        BatchedServer(tcfg, model, kv_bits=8, device=torch.device("cpu"),
                      **kw).restore_prefix_cache(jp_)

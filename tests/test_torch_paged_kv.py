"""Port parity, paged KV core: given the same float K/V, the port's pool
writes store the same page bytes and scales as the reference (exact), on
fragmented page tables with partial pages, padded chunks and out-of-span
clamps; the gather view and the allocator's counts match too."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import t  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import paged_kv as jpk  # noqa: E402
from repro_torch.core import paged_kv as tpk  # noqa: E402

KV, HD, PS = 2, 16, 8

_JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pools(container, num_pages, dtype=torch.float32):
    tl = tpk.PagedKVLayout(num_pages, PS, KV, HD, container, dtype)
    jl = jpk.PagedKVLayout(num_pages, PS, KV, HD, container,
                           _JAX_DTYPES[dtype])
    return tpk.init_paged_pool(tl, torch.device("cpu")), \
        jpk.init_paged_pool(jl)


def _assert_pools_equal(tp, jp, *, skip_scratch=True):
    """Pages 1.. byte for byte (page 0 is the scratch page: colliding
    padded writes land there in an unspecified order); all scales."""
    lo = 1 if skip_scratch else 0
    for name in ("k_pages", "v_pages"):
        a = tp[name][lo:]
        b = np.asarray(jp[name][lo:])
        if a.dtype == torch.bfloat16:
            a, b = a.float(), b.astype(np.float32)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]),
                                      err_msg=name)


# (pos per row, S, valid_len per row or None): chunks that start and end
# mid-page, a padded chunk, decode steps, and a write past the table span
_WRITES = [
    ([0, 3], 11, None),          # prompt chunks straddling page boundaries
    ([11, 14], 8, [5, 8]),       # padded tail on row 0 -> scratch page
    ([16, 22], 1, None),         # decode steps
    ([17, 23], 1, None),
    ([18, 21], 4, [4, 2]),
    ([20, 22], 6, None),         # row 1 runs past its 3-page span: clamps
]


@pytest.mark.parametrize("container,dtype", [
    ("int8", torch.float32), ("int4", torch.float32),
    ("fp", torch.float32), ("fp", torch.bfloat16)])
def test_paged_update_matches_reference(container, dtype):
    rng = np.random.default_rng(7)
    B, NP = 2, 3
    num_pages = 1 + B * NP + 2
    tp, jp = _pools(container, num_pages, dtype)
    ids = np.arange(1, num_pages)
    rng.shuffle(ids)
    table = ids[:B * NP].reshape(B, NP).astype(np.int32)  # fragmented
    kw = {} if container == "fp" else {"int_bits": 2,
                                       "frac_bits": 6 if container == "int8"
                                       else 2}
    for pos, S, valid in _WRITES:
        k = rng.normal(0, 1.5, (B, S, KV, HD)).astype(np.float32)
        v = rng.normal(0, 1.5, (B, S, KV, HD)).astype(np.float32)
        k[0, 0, 0, :4] = np.array([0.5, -0.5, 1.5, -1.5]) * 2.0 ** -6
        pos_a = np.asarray(pos, np.int32)
        valid_a = None if valid is None else np.asarray(valid, np.int32)
        kt, vt = t(k, dtype), t(v, dtype)
        tpk.paged_update(tp, kt, vt, t(table), t(pos_a), page_size=PS,
                         container=container,
                         valid_len=None if valid is None else t(valid_a),
                         **kw)
        jp = jpk.paged_update(
            jp, jnp.asarray(k, _JAX_DTYPES[dtype]),
            jnp.asarray(v, _JAX_DTYPES[dtype]), jnp.asarray(table),
            jnp.asarray(pos_a), page_size=PS, container=container,
            valid_len=None if valid is None else jnp.asarray(valid_a), **kw)
        _assert_pools_equal(tp, jp)
    # the gather view (dequantized with the page scales) agrees too
    tk, tv = tpk.paged_gather(tp, t(table), container=container, head_dim=HD)
    jk, jv = jpk.paged_gather(jp, jnp.asarray(table), container=container,
                              head_dim=HD)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_paged_update_scalar_pos_and_unit_scale_reset():
    """A scalar position broadcasts over rows, and an fp page whose scale
    was left non-unit is reset to 1.0 by its first write at offset 0 (and
    only then)."""
    tp, jp = _pools("fp", 6)
    tp["k_scale"][:] = 0.25
    jp = dict(jp, k_scale=jnp.full((6,), 0.25, jnp.float32))
    table = np.array([[3, 1], [2, 4]], np.int32)
    rng = np.random.default_rng(0)
    for pos, S in ((5, 2), (8, 3)):
        k = rng.normal(size=(2, S, KV, HD)).astype(np.float32)
        tpk.paged_update(tp, t(k), t(k), t(table), pos, page_size=PS,
                         container="fp")
        jp = jpk.paged_update(jp, jnp.asarray(k), jnp.asarray(k),
                              jnp.asarray(table), pos, page_size=PS,
                              container="fp")
        _assert_pools_equal(tp, jp)
    # pages 1 and 4 (second block) were first written at offset 0
    assert tp["k_scale"].tolist() == [1.0, 1.0, 0.25, 0.25, 1.0, 0.25]


def test_static_scale_marks_every_touched_page():
    tp, _ = _pools("int8", 8)
    table = torch.tensor([[5, 2, 7]], dtype=torch.int32)
    k = torch.randn(1, 10, KV, HD)
    tpk.paged_update(tp, k, k, table, torch.tensor([4]), page_size=PS,
                     container="int8", int_bits=2, frac_bits=6)
    assert tp["k_scale"].tolist() == [1.0, 1.0, 2 ** -6, 1.0, 1.0, 2 ** -6,
                                      1.0, 1.0]


def test_unknown_scale_mode_raises():
    tp, _ = _pools("int8", 4)
    k = torch.zeros(1, 1, KV, HD)
    with pytest.raises(ValueError, match="scale_mode"):
        tpk.paged_update(tp, k, k, torch.tensor([[1]], dtype=torch.int32), 0,
                         page_size=PS, container="int8", int_bits=2,
                         frac_bits=6, scale_mode="dynamic")


def test_layout_matches_reference():
    for cont in ("int8", "int4", "fp"):
        a = tpk.PagedKVLayout(9, 16, 8, 128, cont)
        b = jpk.PagedKVLayout(9, 16, 8, 128, cont)
        assert a.store_head_dim == b.store_head_dim
        assert tpk.init_paged_pool(a, torch.device("cpu"))["k_pages"].shape \
            == jpk.init_paged_pool(b)["k_pages"].shape
    with pytest.raises(ValueError, match="head_dim % 8"):
        tpk.PagedKVLayout(9, 16, 8, 12, "int4")
    with pytest.raises(ValueError):
        tpk.PagedKVLayout(1, 16, 8, 128, "int8")
    assert tpk.max_pages_per_seq(33, 16) == jpk.max_pages_per_seq(33, 16)


def test_allocator_matches_reference():
    """The same alloc/incref/free sequence hands out the same pages, keeps
    the same counts, and fails the same way."""
    ta, ja = tpk.PageAllocator(6), jpk.PageAllocator(6)
    for a in (ta, ja):
        got = [a.alloc() for _ in range(3)]
        a.incref(got[1])
        a.free([got[1], got[0]])
    assert [ta.alloc() for _ in range(3)] == [ja.alloc() for _ in range(3)]
    assert (ta.num_free, ta.num_usable, ta.refcount(2)) == \
        (ja.num_free, ja.num_usable, ja.refcount(2))
    assert ta.metrics.value("alloc.allocs") == \
        ja.metrics.value("alloc.allocs")
    assert ta.metrics.value("alloc.free_pages") == ta.num_free
    for a in (ta, ja):
        with pytest.raises(ValueError, match="double free"):
            a.free([4, 4])
        with pytest.raises(ValueError):
            a.free([0])
        with pytest.raises(ValueError, match="unallocated"):
            a.incref(4)
    for a in (ta, ja):
        while a.num_free:
            a.alloc()
    te = pytest.raises(tpk.OutOfPagesError, ta.alloc).value
    je = pytest.raises(jpk.OutOfPagesError, ja.alloc).value
    assert (te.needed, te.free, te.total, te.rid) == \
        (je.needed, je.free, je.total, je.rid)
    assert str(te) == str(je)
    kw = dict(needed=3, free=1, total=8, rid=5, reserved=2, written=4)
    assert str(tpk.OutOfPagesError(**kw)).split(" [")[0] == \
        str(jpk.OutOfPagesError(**kw)).split(" [")[0]


def test_caches_kv_bytes_counts_every_layer():
    pools = [_pools(c, 5)[0] for c in ("int8", "int4", "int8")]
    out = tpk.caches_kv_bytes(pools)
    per = {c: tpk.pool_bytes(_pools(c, 5)[0]) for c in ("int8", "int4")}
    assert out == {"int8": 2 * per["int8"], "int4": per["int4"]}
    assert per["int8"] == 2 * 5 * PS * KV * HD + 2 * 5 * 4

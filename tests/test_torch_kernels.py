"""Port parity, paged-attention kernel: the port's plain version (what the
wrapper runs for CPU tensors) against the reference's Pallas kernel in
interpret mode and its dense oracle, on the shared fragmented-pool fixture;
and decode == chunk at S = 1 inside the port. The CUDA kernel itself is
checked against the plain version in tests/test_torch_cuda.py.

Tolerance: 1e-4 abs + rel on float32 outputs (the tests/test_kernels.py
standard): the three implementations sum in different orders."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import t  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import paged_kv_attention as pka  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _case(seed, *, b, kv, g, hd, ps, s, bits, start):
    """Fragmented pool + per-row starts that straddle page boundaries."""
    rng = np.random.default_rng(seed)
    starts = np.maximum(0, start - rng.integers(0, 4, b)).astype(np.int32)
    np_pages = max(1, -(-int(starts.max() + s) // ps))
    pool = tref.make_fragmented_pool(rng, b, np_pages, ps, kv, hd, bits)
    q = rng.normal(size=(b, s, kv * g, hd)).astype(np.float32)
    return q, pool, starts, (starts + s).astype(np.int32)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_fixture_matches_reference(bits):
    """One numpy seed gives both packages the same pool and page table."""
    a = tref.make_fragmented_pool(np.random.default_rng(3), 2, 3, 8, 2, 16,
                                  bits)
    b = jref.make_fragmented_pool(np.random.default_rng(3), 2, 3, 8, 2, 16,
                                  bits)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("s", [1, 5, 16])
def test_plain_chunk_matches_reference(bits, s):
    """Plain chunk attention == the reference Pallas chunk kernel
    (interpret mode) == both packages' dense oracles, GQA with G = 2,
    starts mid-page, partial last pages."""
    kw = dict(b=2, kv=2, g=2, hd=16, ps=8, s=s, bits=bits, start=11)
    q, (kq, vq, ks, vs, pt), starts, lens = _case(bits * 10 + s, **kw)
    got = pka.paged_kv_attention_chunk(
        t(q), t(kq), t(vq), t(ks), t(vs), t(pt), t(starts), t(lens),
        bits=bits)
    assert got.dtype == torch.float32 and got.shape == q.shape
    jargs = (jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
             jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(pt),
             jnp.asarray(starts), jnp.asarray(lens))
    want = jops.paged_kv_attention_chunk(*jargs, bits=bits, block_q=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = jref.paged_kv_attention_chunk_ref(*jargs, bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    mine = tref.paged_kv_attention_chunk_ref(
        t(q), t(kq), t(vq), t(ks), t(vs), t(pt), t(starts), t(lens),
        bits=bits)
    np.testing.assert_allclose(mine.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_plain_decode_matches_reference(bits):
    """Decode (S = 1 at kv_len - 1) == the reference decode kernel and
    oracle, with per-row lengths that leave last pages partial."""
    rng = np.random.default_rng(40 + bits)
    b, kv, g, hd, ps, np_pages = 3, 2, 4, 32, 8, 4
    kq, vq, ks, vs, pt = tref.make_fragmented_pool(rng, b, np_pages, ps, kv,
                                                   hd, bits)
    q = rng.normal(size=(b, kv * g, hd)).astype(np.float32)
    lens = np.array([1, 17, 32], np.int32)
    got = pka.paged_kv_attention_decode(t(q), t(kq), t(vq), t(ks), t(vs),
                                        t(pt), t(lens), bits=bits)
    jargs = (jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
             jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(pt),
             jnp.asarray(lens))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.paged_kv_attention(*jargs, bits=bits)),
        **TOL)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jref.paged_kv_attention_ref(*jargs, bits=bits)), **TOL)
    np.testing.assert_allclose(
        tref.paged_kv_attention_ref(t(q), t(kq), t(vq), t(ks), t(vs), t(pt),
                                    t(lens), bits=bits).numpy(),
        np.asarray(jref.paged_kv_attention_ref(*jargs, bits=bits)), **TOL)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_decode_is_chunk_special_case(bits):
    """Inside the port, decode == chunk at S = 1 with q_start = kv_len - 1,
    exactly."""
    q, (kq, vq, ks, vs, pt), _, _ = _case(5, b=2, kv=2, g=2, hd=16, ps=8,
                                          s=1, bits=bits, start=20)
    lens = torch.tensor([13, 20], dtype=torch.int32)
    args = (t(kq), t(vq), t(ks), t(vs), t(pt))
    d = pka.paged_kv_attention_decode(t(q)[:, 0], *args, lens, bits=bits)
    c = pka.paged_kv_attention_chunk(t(q), *args, lens - 1, lens, bits=bits,
                                     block_q=1)
    assert torch.equal(d, c[:, 0])


def test_wrapper_rejects_bad_inputs():
    q, (kq, vq, ks, vs, pt), starts, lens = _case(
        1, b=1, kv=2, g=2, hd=16, ps=8, s=3, bits=8, start=2)
    args = [t(q), t(kq), t(vq), t(ks), t(vs), t(pt), t(starts), t(lens)]
    with pytest.raises(ValueError, match="bits=4"):
        pka.paged_kv_attention_chunk(*args, bits=4)
    bad = list(args)
    bad[1] = bad[1].to(torch.int32)
    with pytest.raises(ValueError):
        pka.paged_kv_attention_chunk(*bad, bits=8)
    bad = list(args)
    bad[3] = bad[3][:-1]
    with pytest.raises(ValueError, match="scales"):
        pka.paged_kv_attention_chunk(*bad, bits=8)

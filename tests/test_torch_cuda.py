"""On a CUDA card only: the port's CUDA kernels against their plain
PyTorch versions. Imports no JAX, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Everywhere else every test skips (a CUDA kernel has no CPU mode).
Tolerance: 1e-4 abs + rel on float32 outputs; TF32 is off."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import paged_kv_attention as pka  # noqa: E402
from repro_torch.kernels.ref import make_fragmented_pool  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, *, b, kv, g, hd, ps, s, bits, start, qdt):
    rng = np.random.default_rng(seed)
    starts = np.maximum(0, start - rng.integers(0, 4, b)).astype(np.int32)
    np_pages = max(1, -(-int(starts.max() + s) // ps))
    kq, vq, ks, vs, pt = make_fragmented_pool(rng, b, np_pages, ps, kv, hd,
                                              bits)
    q = rng.normal(size=(b, s, kv * g, hd)).astype(np.float32)
    kp, vp = torch.from_numpy(kq), torch.from_numpy(vq)
    if bits == 0:
        kp, vp = kp.to(qdt), vp.to(qdt)
    return [torch.from_numpy(q).to(qdt), kp, vp, torch.from_numpy(ks),
            torch.from_numpy(vs), torch.from_numpy(pt),
            torch.from_numpy(starts), torch.from_numpy(starts + s)]


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("s", [1, 5, 16, 33])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention_matches_plain(cuda, bits, s, qdt):
    """Fragmented tables, starts mid-page, S past one query block."""
    args = _case(bits * 100 + s, b=3, kv=2, g=4, hd=32, ps=8, s=s,
                 bits=bits, start=19, qdt=qdt)
    plain = pka.paged_kv_attention_chunk(*args, bits=bits)
    before = pka.paged_kv_attention_chunk.launches
    got = pka.paged_kv_attention_chunk(*[a.to(cuda) for a in args],
                                       bits=bits)
    torch.cuda.synchronize()
    assert pka.paged_kv_attention_chunk.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_decode_at_served_width(cuda, bits):
    """qwen2-72b attention widths (64 heads over 8 KV heads, head_dim 128,
    page size 16), decode against the plain version."""
    args = _case(7, b=4, kv=8, g=8, hd=128, ps=16, s=1, bits=bits,
                 start=300, qdt=torch.bfloat16)
    lens = args[7]
    plain = pka.paged_kv_attention_decode(args[0][:, 0], *args[1:6], lens,
                                          bits=bits)
    got = pka.paged_kv_attention_decode(
        *[a.to(cuda) for a in [args[0][:, 0]] + args[1:6] + [lens]],
        bits=bits)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


def test_cuda_launch_errors_raise(cuda):
    """A CUDA tensor never falls back to the plain version: inputs the
    kernel does not take raise."""
    args = [a.to(cuda) for a in _case(1, b=1, kv=2, g=2, hd=16, ps=8, s=2,
                                      bits=8, start=3, qdt=torch.float32)]
    args[1] = args[1].to(torch.int32)
    with pytest.raises(ValueError):
        pka.paged_kv_attention_chunk(*args, bits=8)
    args = [a.to(cuda) for a in _case(1, b=1, kv=2, g=2, hd=16, ps=8, s=2,
                                      bits=8, start=3, qdt=torch.float16)]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pka.paged_kv_attention_chunk(*args, bits=8)


# ---------------------------------------------------------------------------
# The kernel entry point's kernels: B2 (block_kv), B3, B4, B5/B6
# ---------------------------------------------------------------------------
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pack as pk  # noqa: E402
from repro_torch.kernels import quant_cast as qc  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("s", [1, 5, 33])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_cuda_block_kv_matches_plain_and_default(cuda, bits, s, qdt):
    """The KV-head-blocked kernel: 1e-4 against the plain version, 1e-5
    against the default kernel, fragmented tables, S past a query block."""
    args = _case(bits * 10 + s, b=3, kv=2, g=4, hd=32, ps=8, s=s, bits=bits,
                 start=19, qdt=qdt)
    plain = pka.paged_kv_attention_chunk(*args, bits=bits)
    dargs = [a.to(cuda) for a in args]
    before = pka.paged_kv_attention_chunk.kvblock_launches
    got = ops.paged_kv_attention_chunk(*dargs, bits=bits, block_kv=True)
    torch.cuda.synchronize()
    assert pka.paged_kv_attention_chunk.kvblock_launches == before + 1
    default = ops.paged_kv_attention_chunk(*dargs, bits=bits)
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(got.cpu().numpy(), default.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4, 0])
@pytest.mark.parametrize("s", [1, 32])
def test_cuda_block_kv_at_served_width(cuda, bits, s):
    """qwen2-72b attention widths: 8 KV heads of 128 at page size 16 fill
    most of a block's shared memory, so S = 32 runs one query per block."""
    args = _case(9 + s, b=2, kv=8, g=8, hd=128, ps=16, s=s, bits=bits,
                 start=300, qdt=torch.bfloat16)
    plain = pka.paged_kv_attention_chunk(*args, bits=bits)
    got = ops.paged_kv_attention_chunk(*[a.to(cuda) for a in args],
                                       bits=bits, block_kv=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


def test_cuda_kv_attention_matches_plain(cuda):
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 8, 32)).astype(np.float32))
    kq = torch.from_numpy(rng.integers(-128, 128, (2, 77, 2, 32)).astype(
        np.int8))
    vq = torch.from_numpy(rng.integers(-128, 128, (2, 77, 2, 32)).astype(
        np.int8))
    kw = dict(int_bits=2, frac_bits=6, block_t=32)
    plain = ops.kv_attention(q, kq, vq, 70, **kw)
    got = ops.kv_attention(q.to(cuda), kq.to(cuda), vq.to(cuda), 70, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


def _quant_cast_input(shape, f, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 5).astype(np.float32).reshape(-1)
    below = np.nextafter(np.float32(0.5), np.float32(0))
    special = np.array([0.5, -0.5, 1.5, -2.5, below, -below, 0.0, -0.0,
                        1e9, -1e9, np.inf, -np.inf, 3e-39, -3e-39],
                       np.float32) * np.float32(2.0 ** -f)
    x[:min(x.size, special.size)] = special[:x.size]
    return torch.from_numpy(x.reshape(shape))


@pytest.mark.parametrize("shape", [(1, 1), (37, 129), (4, 37, 129),
                                   (3, 1001)])
@pytest.mark.parametrize("i,f", [(2, 6), (4, 4), (2, 14), (8, 8), (1, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quant_cast_exact(cuda, shape, i, f, dtype):
    """Bit for bit against the plain version (and so fake_quant): ties,
    0.49999997 of a step, infinities, subnormals, ragged sizes."""
    x = _quant_cast_input(shape, f, sum(shape) + f).to(dtype)
    plain = qc.quant_cast_plain(x, i, f)
    before = qc.quant_cast.launches
    got = ops.quant_cast(x.to(cuda), i, f)
    torch.cuda.synchronize()
    assert qc.quant_cast.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got.cpu(), plain)


def test_cuda_quant_cast_unaligned_view(cuda):
    """A view that starts off a 16-byte boundary takes the scalar path."""
    x = _quant_cast_input((4, 1001), 6, 1).to(cuda)
    view = x.reshape(-1)[3:]
    got = qc.quant_cast(view, 2, 6)
    assert torch.equal(got.cpu(), qc.quant_cast_plain(view.cpu(), 2, 6))


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
@pytest.mark.parametrize("rows,words", [(1, 1), (37, 5), (300, 129)])
def test_cuda_pack_unpack_exact(cuda, bits, rows, words):
    vpw = 32 // bits
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    rng = np.random.default_rng(bits + rows)
    q = torch.from_numpy(rng.integers(lo, hi + 1, (rows, words * vpw))
                         .astype(np.int32))
    q[0, 0], q[-1, -1] = lo, hi
    before = (pk.pack_2d.launches, pk.unpack_2d.launches)
    w = ops.pack(q.to(cuda), bits)
    back = ops.unpack(w, bits)
    torch.cuda.synchronize()
    assert (pk.pack_2d.launches, pk.unpack_2d.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(w.cpu(), pk.pack_plain(q, bits))
    assert torch.equal(back.cpu(), q)
    assert torch.equal(back.cpu(), pk.unpack_plain(w.cpu(), bits))


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (8, 300, 130), (33, 77, 257),
                                   (130, 520, 65)])
@pytest.mark.parametrize("adt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdt", [torch.int8, torch.int16])
def test_cuda_qmatmul_matches_plain(cuda, m, k, n, adt, wdt):
    """Ragged M, N and K on both tile shapes (M <= 32 and above); error
    relative to max|ref| <= 1e-4 (f32) / 2e-2 (bf16)."""
    rng = np.random.default_rng(m * 7 + n)
    lim = 128 if wdt == torch.int8 else 4096
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(adt)
    wq = torch.from_numpy(rng.integers(-lim, lim, (k, n))).to(wdt)
    s = torch.from_numpy((rng.uniform(0.001, 0.05, n) * 128 / lim).astype(
        np.float32))
    plain = qmm.quant_matmul_plain(a, wq, s)
    before = qmm.quant_matmul.launches
    got = ops.qmatmul(a.to(cuda), wq.to(cuda), s.to(cuda))
    torch.cuda.synchronize()
    assert qmm.quant_matmul.launches == before + 1
    tol = 1e-4 if adt == torch.float32 else 2e-2
    err = float((got.cpu() - plain).abs().max())
    assert err <= tol * float(plain.abs().max()), err


def test_cuda_entry_point_bad_inputs_raise(cuda):
    """A CUDA tensor the kernels do not take raises; nothing falls back."""
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.quant_cast(torch.zeros(4, 4, dtype=torch.float16, device=cuda),
                       2, 6)
    with pytest.raises(ValueError, match="contiguous"):
        ops.quant_cast(torch.zeros(4, 4, device=cuda).T, 2, 6)
    with pytest.raises(ValueError, match="int32"):
        ops.pack(torch.zeros(2, 8, dtype=torch.int64, device=cuda), 4)
    with pytest.raises(ValueError, match="multiple"):
        ops.pack(torch.zeros(2, 12, dtype=torch.int32, device=cuda), 4)
    with pytest.raises(ValueError, match="aligned"):
        pk.unpack_2d(torch.zeros(17, dtype=torch.int32,
                                 device=cuda)[1:].reshape(2, 8), bits=4)
    a = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError, match="int8 or int16"):
        ops.qmatmul(a, torch.zeros(8, 3, device=cuda), torch.ones(3,
                                                                  device=cuda))
    with pytest.raises(ValueError, match="scales must be float32"):
        ops.qmatmul(a, torch.zeros(8, 3, dtype=torch.int8, device=cuda),
                    torch.ones(3, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        args = [x.to(cuda) for x in _case(1, b=1, kv=64, g=1, hd=128, ps=16,
                                          s=1, bits=0,
                                          start=3, qdt=torch.float32)]
        ops.paged_kv_attention_chunk(*args, bits=0, block_kv=True)


def test_cuda_failed_launches_raise(cuda, monkeypatch):
    """A launch the C side refuses returns its cudaError_t and the wrapper
    raises, without counting a launch."""
    x = torch.zeros(4, 8, device=cuda)
    monkeypatch.setitem(qc._DTYPES, torch.float32, 7)
    before = qc.quant_cast.launches
    with pytest.raises(RuntimeError, match="quant_cast kernel launch"):
        qc.quant_cast(x, 2, 6)
    assert qc.quant_cast.launches == before
    q = torch.zeros(2, 8, dtype=torch.int32, device=cuda)
    out = torch.empty(2, 1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="pack kernel launch"):
        pk._launch("pack_launch", q, out, 2, bits=3)
    monkeypatch.setitem(qmm._W_DTYPES, torch.int8, 5)
    before = qmm.quant_matmul.launches
    with pytest.raises(RuntimeError, match="quant_matmul kernel launch"):
        qmm.quant_matmul(x, torch.zeros(8, 3, dtype=torch.int8, device=cuda),
                         torch.ones(3, device=cuda))
    assert qmm.quant_matmul.launches == before
    args = [a.to(cuda) for a in _case(1, b=1, kv=2, g=2, hd=16, ps=8, s=2,
                                      bits=8, start=3, qdt=torch.float32)]
    monkeypatch.setitem(pka._PAGE_DTYPES, torch.int8, 9)
    before = pka.paged_kv_attention_chunk.kvblock_launches
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.paged_kv_attention_chunk(*args, bits=8, block_kv=True)
    assert pka.paged_kv_attention_chunk.kvblock_launches == before

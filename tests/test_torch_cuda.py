"""On a CUDA card only: the port's CUDA kernels against their plain
PyTorch versions, and the split-KV tensor-core attention's determinism and
dispatch. Imports no JAX, so it runs on a machine without it:

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
    # ragged N or K, or an int16 grid: the FMA kernel by the route rule
    assert qmm.quant_matmul.last_plan["route"] == "fma"
    tol = 1e-4 if adt == torch.float32 else 2e-2
    err = float((got.cpu() - plain).abs().max())
    assert err <= tol * float(plain.abs().max()), err


@pytest.mark.parametrize("m,k,n,split", [
    (1, 8192, 1024, True), (8, 8192, 4096, True), (17, 4096, 2048, True),
    (33, 1024, 512, True), (256, 1024, 512, True), (129, 520, 528, True),
    (5, 256, 4096, False), (200, 256, 1024, False)])
@pytest.mark.parametrize("adt", [torch.float32, torch.bfloat16])
def test_cuda_qmatmul_tensor_core_route(cuda, m, k, n, split, adt):
    """Int8 grids with aligned rows take the tensor-core kernel, at decode
    (M <= 32) and prefill, with and without split-K, M at the tiles'
    edges: error relative to max|ref| <= 1e-4 (f32) / 2e-2 (bf16), two
    calls bitwise equal (the split-K merge is in fixed order), one launch
    counted a call whatever its splits; the plan is the planner's for the
    tile shape and a parts the library reports, and covers K."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(adt)
    wq = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.001, 0.05, n).astype(np.float32))
    plain = qmm.quant_matmul_plain(a, wq, s)
    args = (a.to(cuda), wq.to(cuda), s.to(cuda))
    before = qmm.quant_matmul.launches
    got = ops.qmatmul(*args)
    plan = dict(qmm.quant_matmul.last_plan)
    again = ops.qmatmul(*args)
    torch.cuda.synchronize()
    assert qmm.quant_matmul.launches == before + 2
    assert plan["route"] == "mma"
    assert plan["tile"] == ("decode" if m <= 32 else "prefill")
    assert (plan["splits"] > 1) == split, plan
    assert plan["blocks_per_sm"] >= 1 and plan["smem_bytes"] > 0
    assert plan["a_parts"] == qmm.A_PARTS[adt]
    want = qmm.plan_qmm(m, n, k, plan["tile_shape"],
                        sms=torch.cuda.get_device_properties(cuda)
                        .multi_processor_count,
                        blocks_per_sm=plan["blocks_per_sm"])
    assert (want.splits, want.steps_per_split) == (plan["splits"],
                                                  plan["steps_per_split"])
    assert want.k_ranges(k)[-1][1] == k
    assert torch.equal(got, again)
    tol = 1e-4 if adt == torch.float32 else 2e-2
    err = float((got.cpu() - plain).abs().max())
    assert err <= tol * float(plain.abs().max()), err


def test_cuda_qmatmul_unaligned_rows_take_fma(cuda):
    """The same int8 grid through a view whose data pointer is not 16-byte
    aligned takes the FMA kernel, and both routes agree with the plain
    version."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(8, 513)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-128, 128, (512, 64)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.001, 0.05, 64).astype(np.float32))
    da = a.to(cuda)
    for view, route in ((da[:, 1:].contiguous(), "mma"),
                        (da.flatten()[1:4097].view(8, 512), "fma")):
        got = ops.qmatmul(view, wq.to(cuda), s.to(cuda))
        torch.cuda.synchronize()
        assert qmm.quant_matmul.last_plan["route"] == route
        plain = qmm.quant_matmul_plain(view.cpu(), wq, s)
        err = float((got.cpu() - plain).abs().max())
        assert err <= 1e-4 * float(plain.abs().max()), err


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


# ---------------------------------------------------------------------------
# B1 and B2 on tensor cores: page sizes, split-KV, determinism, dispatch
# ---------------------------------------------------------------------------
def _long_case(seed, *, b, bits, s, lo, hi, kv=8, g=8, hd=128, ps=16,
               qdt=torch.bfloat16):
    """Per-row lengths in [lo, hi]; the chunk's s queries end at each row's
    last key."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, b).astype(np.int32)
    kq, vq, ks, vs, pt = make_fragmented_pool(rng, b, -(-int(lens.max()) //
                                                        ps), ps, kv, hd, bits)
    q = rng.normal(size=(b, s, kv * g, hd)).astype(np.float32)
    kp, vp = torch.from_numpy(kq), torch.from_numpy(vq)
    if bits == 0:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    return [torch.from_numpy(q).to(qdt), kp, vp, torch.from_numpy(ks),
            torch.from_numpy(vs), torch.from_numpy(pt),
            torch.from_numpy(lens - s), torch.from_numpy(lens)]


@pytest.mark.parametrize("bits", [8, 4, 0])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("s", [1, 7, 40])
@pytest.mark.parametrize("block_kv", [False, True])
def test_cuda_mma_matches_plain_at_page_sizes(cuda, bits, ps, s, block_kv):
    """The tensor-core kernels at page size 8 (one MMA k-chunk spans two
    pages) and 16, several splits, S past a query block: 1e-4 against the
    plain version."""
    args = _long_case(bits * 100 + ps + s, b=3, bits=bits, s=s, lo=150,
                      hi=400, kv=2, g=4, hd=64, ps=ps)
    plain = pka.paged_kv_attention_chunk(*args, bits=bits)
    got = pka.paged_kv_attention_chunk(*[a.to(cuda) for a in args],
                                       bits=bits, block_kv=block_kv)
    torch.cuda.synchronize()
    assert pka.paged_kv_attention_chunk.last_plan["route"] == "mma"
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("block_kv", [False, True])
def test_cuda_split_kv_at_served_width(cuda, bits, block_kv):
    """qwen2-72b widths (8 KV heads, G 8, head_dim 128, page size 16) at
    1-2k keys: decode runs on at least 4 KV splits and holds 1e-4."""
    args = _long_case(11 + bits, b=4, bits=bits, s=1, lo=1024, hi=2048)
    plain = pka.paged_kv_attention_chunk(*args, bits=bits)
    got = pka.paged_kv_attention_chunk(*[a.to(cuda) for a in args],
                                       bits=bits, block_kv=block_kv)
    torch.cuda.synchronize()
    assert pka.paged_kv_attention_chunk.last_plan["splits"] >= 4
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("bits", [8, 4, 0])
def test_cuda_decode_is_bitwise_the_s1_chunk(cuda, bits):
    """Decode is the S = 1 chunk with block_q = 1, bit for bit, on the
    split path (the reference's test_paged_decode_is_chunk_special_case)."""
    args = [a.to(cuda) for a in _long_case(21 + bits, b=4, bits=bits, s=1,
                                           lo=600, hi=1500)]
    lens = args[7]
    d = pka.paged_kv_attention_decode(args[0][:, 0], *args[1:6], lens,
                                      bits=bits)
    c = pka.paged_kv_attention_chunk(*args[:6], lens - 1, lens, bits=bits,
                                     block_q=1)
    torch.cuda.synchronize()
    assert pka.paged_kv_attention_chunk.last_plan["splits"] > 1
    assert torch.equal(d, c[:, 0])


@pytest.mark.parametrize("s", [1, 32])
@pytest.mark.parametrize("block_kv", [False, True])
def test_cuda_identical_calls_are_bitwise_equal(cuda, s, block_kv):
    """No atomics: the splits and their merge run in a fixed order."""
    args = [a.to(cuda) for a in _long_case(31 + s, b=4, bits=8, s=s,
                                           lo=500, hi=1200)]
    a = pka.paged_kv_attention_chunk(*args, bits=8, block_kv=block_kv)
    b = pka.paged_kv_attention_chunk(*args, bits=8, block_kv=block_kv)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("block_kv", [False, True])
def test_cuda_float32_pages_take_the_fma_kernel(cuda, block_kv):
    """Float32 pages reach the float32-FMA kernel by dtype dispatch; bf16
    pages of the same values the tensor-core one. Both hold 1e-4."""
    f32 = _case(41, b=2, kv=2, g=4, hd=32, ps=16, s=3, bits=0, start=70,
                qdt=torch.float32)
    bf16 = list(f32)
    bf16[1], bf16[2] = f32[1].to(torch.bfloat16), f32[2].to(torch.bfloat16)
    for args, route in ((f32, "fma"), (bf16, "mma")):
        plain = pka.paged_kv_attention_chunk(*args, bits=0)
        got = pka.paged_kv_attention_chunk(*[a.to(cuda) for a in args],
                                           bits=0, block_kv=block_kv)
        torch.cuda.synchronize()
        assert pka.paged_kv_attention_chunk.last_plan["route"] == route
        np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


def test_cuda_mma_refused_launch_raises(cuda, monkeypatch):
    """On the tensor-core route a launch the C side refuses raises without
    counting a launch, and pages off a 16-byte boundary are refused."""
    args = [a.to(cuda) for a in _case(2, b=2, kv=2, g=4, hd=32, ps=8, s=2,
                                      bits=8, start=30, qdt=torch.bfloat16)]
    pka.paged_kv_attention_chunk(*args, bits=8)
    assert pka.paged_kv_attention_chunk.last_plan["route"] == "mma"
    with monkeypatch.context() as mp:
        mp.setitem(pka._PAGE_DTYPES, torch.int8, 9)
        pka._occupancy.cache_clear()
        before = pka.paged_kv_attention_chunk.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            pka.paged_kv_attention_chunk(*args, bits=8)
        assert pka.paged_kv_attention_chunk.launches == before
    pka._occupancy.cache_clear()
    flat = torch.zeros(args[1].numel() + 1, dtype=torch.int8, device=cuda)
    off = flat[1:].view(args[1].shape)
    with pytest.raises(ValueError, match="16-byte"):
        pka.paged_kv_attention_chunk(args[0], off, args[2], *args[3:],
                                     bits=8)


def _fused_rows(seed, *, bits, qdt, hd=128, kv=8, g=8, ps=16, s=32):
    """A fused round's attention inputs: rows with mixed ``valid_len``
    (prefill chunks, decode rows of one real query, a row padded from 1
    to the shared bucket ``s``) at per-row starts over a fragmented
    pool."""
    import dataclasses
    from repro_torch.configs.registry import get_smoke_config
    rng = np.random.default_rng(seed)
    starts = np.array([0, 37, 300, 5, 129, 16], np.int32)
    valid = np.array([s, 1, 1, 7, s - 3, 1], np.int32)
    b = len(starts)
    np_pages = -(-int(starts.max() + s) // ps)
    kq, vq, ks, vs, pt = make_fragmented_pool(rng, b, np_pages, ps, kv, hd,
                                              bits)
    cache = {"k_pages": torch.from_numpy(kq), "v_pages": torch.from_numpy(vq),
             "k_scale": torch.from_numpy(ks), "v_scale": torch.from_numpy(vs)}
    if bits == 0:
        cache = {k: v.to(qdt) if k.endswith("pages") else v
                 for k, v in cache.items()}
    q = torch.from_numpy(rng.normal(size=(b, s, kv * g, hd)).astype(
        np.float32)).to(qdt)
    cfg = dataclasses.replace(get_smoke_config("qwen2-72b"),
                              num_heads=kv * g, num_kv_heads=kv, head_dim=hd,
                              d_model=kv * g * hd)
    return cfg, q, cache, torch.from_numpy(pt), torch.from_numpy(starts), \
        valid


@pytest.mark.parametrize("bits", [8, 4, 0])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_cuda_fused_rows_with_mixed_valid_len(cuda, bits, qdt):
    """The fused step's attention: one [rows, bucket] chunk whose rows are
    prefill chunks and decode rows of one real query (``valid_len``
    mixed), per-row ``q_start``/``kv_len`` through
    ``route_paged_attention``. B1 on the card equals the plain route on
    every real query, in one launch."""
    from repro_torch.models.attention import route_paged_attention
    cfg, q, cache, pt, starts, valid = _fused_rows(3 + bits, bits=bits,
                                                   qdt=qdt)
    S = q.shape[1]
    pos = starts[:, None].to(torch.int64) + torch.arange(S)[None, :]
    plain = route_paged_attention(q, cache, pt, pos, starts, cfg=cfg,
                                  attn_impl="kernel")
    before = pka.paged_kv_attention_chunk.launches
    got = route_paged_attention(q.to(cuda), {k: v.to(cuda)
                                             for k, v in cache.items()},
                                pt.to(cuda), pos.to(cuda), starts.to(cuda),
                                cfg=cfg, attn_impl="kernel")
    torch.cuda.synchronize()
    assert pka.paged_kv_attention_chunk.launches == before + 1
    for r, n in enumerate(valid):
        np.testing.assert_allclose(got[r, :n].float().cpu().numpy(),
                                   plain[r, :n].float().numpy(),
                                   **(TOL if qdt == torch.float32
                                      else dict(rtol=2e-2, atol=2e-2)))


def test_cuda_fused_step_launches_b1_once_per_layer(cuda):
    """The fused step on the card, kernel route: a mixed admission round
    and an S = 1 steady-state step each launch B1 once per layer, and the
    emitted rows' logits equal the plain route's on the CPU (float32)."""
    import dataclasses
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.paged_kv import PagedCacheSpec
    from repro_torch.launch.steps import make_fused_step
    from repro_torch.models.transformer import init_cache, init_model
    cfg = dataclasses.replace(get_smoke_config("qwen2-72b"), d_model=256,
                              num_heads=4, num_kv_heads=2, d_ff=384)
    step = make_fused_step(cfg, attn_impl="kernel")
    spec = PagedCacheSpec(page_size=8, num_pages=1 + 4 * 4)
    pt = torch.arange(1, 17, dtype=torch.int32).reshape(4, 4)
    rng = np.random.default_rng(0)
    rounds = [  # (tokens (4, S), starts, valid, emit)
        (rng.integers(0, 256, (4, 8)), [0, 0, 0, 0], [8, 5, 1, 3],
         [0, 1, 2, 3]),
        (rng.integers(0, 256, (4, 8)), [8, 5, 1, 3], [1, 8, 1, 2],
         [0, 2, 0, 0]),
        (rng.integers(0, 256, (4, 1)), [9, 13, 2, 5], [1, 1, 1, 1],
         [0, 1, 2, 3])]
    outs = {}
    for dev in ("cpu", cuda):
        model = init_model(cfg, seed=1, device="cpu").to(dev)
        caches = init_cache(cfg, None, spec, dev)
        outs[str(dev)] = []
        for tok, st, vl, em in rounds:
            before = pka.paged_kv_attention_chunk.launches
            nxt, logits, caches = step(
                model, torch.tensor(tok, dtype=torch.int32, device=dev),
                torch.tensor(st, dtype=torch.int32, device=dev),
                torch.tensor(vl, dtype=torch.int32, device=dev), caches,
                pt.to(dev), torch.tensor(em, dtype=torch.int32, device=dev))
            if dev != "cpu":
                torch.cuda.synchronize()
                assert (pka.paged_kv_attention_chunk.launches
                        == before + cfg.num_layers)
            outs[str(dev)].append(logits.float().cpu())
    for (_, _, _, em), a, b in zip(rounds, outs["cpu"], outs[str(cuda)]):
        n = len(set(em))
        np.testing.assert_allclose(b[:n].numpy(), a[:n].numpy(), **TOL)


# ---------------------------------------------------------------------------
# B1 on the pools of the prefix cache, per-page scales and per-layer
# profiles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("container", ["int8", "int4"])
def test_cuda_b1_on_page_scale_pools(cuda, container):
    """``paged_update(scale_mode="page")`` on the card writes the CPU's
    bytes and scales (pages 1..); after a write that raises a page's
    scale (requantizing its earlier tokens in place), B1 equals its plain
    version on the pool."""
    from repro_torch.core import paged_kv as tpk
    rng = np.random.default_rng(11)
    kv, hd, ps, b = 8, 128, 16, 4
    layout = tpk.PagedKVLayout(40, ps, kv, hd, container)
    pools = {d: tpk.init_paged_pool(layout, torch.device(d))
             for d in ("cpu", cuda)}
    pt = torch.from_numpy(rng.permutation(np.arange(1, 37)).astype(
        np.int32).reshape(b, 9))
    raised = False
    for pos, s, mag in ((0, 20, 0.05), (20, 9, 3.0), (29, 1, 5.0),
                        (30, 1, 0.1)):
        k = torch.from_numpy((rng.normal(size=(b, s, kv, hd)) * mag)
                             .astype(np.float32))
        v = torch.from_numpy((rng.normal(size=(b, s, kv, hd)) * mag)
                             .astype(np.float32))
        before = pools["cpu"]["k_scale"].clone()
        for d, pool in pools.items():
            tpk.paged_update(pool, k.to(d), v.to(d), pt.to(d), pos,
                             page_size=ps, container=container,
                             scale_mode="page")
        raised |= bool((pools["cpu"]["k_scale"] > before)[1:].any()
                       & (before[1:] != 1.0).any())
        for name, t in pools[cuda].items():
            assert torch.equal(t[1:].cpu(), pools["cpu"][name][1:]), name
    assert raised
    pool = pools[cuda]
    used = pt.flatten().long()
    assert torch.unique(pool["k_scale"][used.to(cuda)]).numel() >= 2
    bits = {"int8": 8, "int4": 4}[container]
    q = torch.from_numpy(rng.normal(size=(b, 1, kv * 8, hd)).astype(
        np.float32))
    lens = torch.full((b,), 31, dtype=torch.int32)
    args = (pool["k_pages"], pool["v_pages"], pool["k_scale"],
            pool["v_scale"], pt.to(cuda))
    got = pka.paged_kv_attention_decode(q[:, 0].to(cuda), *args,
                                        lens.to(cuda), bits=bits)
    plain = pka.paged_kv_attention_chunk_plain(
        q, *[a.cpu() for a in args], lens - 1, lens, bits=bits)[:, 0]
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


def test_cuda_b1_on_aliased_page_table(cuda):
    """Rows whose page tables alias the same pages (a shared prefix, each
    row then on its own pages) read them as the plain version does."""
    rng = np.random.default_rng(5)
    b, s, kv, g, hd, ps = 4, 5, 8, 8, 128, 16
    args = _case(9, b=b, kv=kv, g=g, hd=hd, ps=ps, s=s, bits=8, start=90,
                 qdt=torch.bfloat16)
    pt = args[5].clone()
    shared = rng.integers(1, int(pt.max()) + 1, 4)
    pt[:, :4] = torch.from_numpy(shared.astype(np.int32))   # aliased prefix
    args[5] = pt
    plain = pka.paged_kv_attention_chunk_plain(*args, bits=8)
    got = pka.paged_kv_attention_chunk(*[a.to(cuda) for a in args], bits=8)
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)
    again = pka.paged_kv_attention_chunk(*[a.to(cuda) for a in args],
                                         bits=8)
    assert torch.equal(got, again)


def _small_cfg():
    import dataclasses
    from repro_torch.configs.registry import get_smoke_config
    return dataclasses.replace(get_smoke_config("qwen2-72b"), d_model=256,
                               num_heads=4, num_kv_heads=2, d_ff=384)


def _profile(cfg, fmts):
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.policy import LayerPolicy, PrecisionPolicy
    return PrecisionPolicy(
        tuple(f"layer_{i:03d}" for i in range(cfg.num_layers)),
        tuple(LayerPolicy(None, f and FixedPointFormat(*f)) for f in fmts))


def test_cuda_b1_in_a_mixed_container_forward(cuda, monkeypatch):
    """One forward whose layers store float, int8 and int4 pages side by
    side (a per-layer profile): B1 launches once per layer per forward at
    each layer's own width, and each launch equals the plain version on
    its own inputs (captured at the call)."""
    from repro_torch.core.paged_kv import PagedCacheSpec
    from repro_torch.models import attention
    from repro_torch.models.transformer import forward, init_cache, \
        init_model
    from repro_torch.quant.apply import build_model_quant
    cfg = _small_cfg()
    quant = build_model_quant(_profile(cfg, [None, (2, 6), (2, 2), (2, 6)]),
                              cfg, quantize_kv=True,
                              quantize_activations=False, per_layer_kv=True,
                              kv_scale_mode="page")
    seen = []
    real = attention.paged_kv_attention_chunk

    def capture(q, *a, bits):
        seen.append(([x.clone() for x in (q,) + a], bits))
        return real(q, *a, bits=bits)
    monkeypatch.setattr(attention, "paged_kv_attention_chunk", capture)
    model = init_model(cfg, seed=1, device=cuda)
    caches = init_cache(cfg, quant, PagedCacheSpec(page_size=8,
                                                   num_pages=12), cuda)
    pt = torch.tensor([[3, 7, 1], [9, 2, 5]], dtype=torch.int32,
                      device=cuda)
    rng = np.random.default_rng(2)
    tok = torch.tensor(rng.integers(0, 256, (2, 11)), dtype=torch.int32,
                       device=cuda)
    for toks, pos in ((tok, 0), (tok[:, :4], 11)):
        before = pka.paged_kv_attention_chunk.launches
        forward(model, toks, cfg, quant=quant, caches=caches,
                cache_pos=pos, page_table=pt, attn_impl="kernel")
        torch.cuda.synchronize()
        assert pka.paged_kv_attention_chunk.launches == \
            before + cfg.num_layers
    assert [b for _, b in seen] == [0, 8, 4, 8] * 2
    for inputs, bits in seen:
        got = real(*inputs, bits=bits)
        plain = pka.paged_kv_attention_chunk_plain(
            *[x.cpu() for x in inputs], bits=bits)
        np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


def test_cuda_served_prefix_cache_counts_as_on_the_cpu(cuda):
    """A small served trace with a shared prompt, prefix cache off and on,
    kernel route: the card's host counters equal the CPU's on the same
    trace, sharing saves prefill forwards, B1 runs once per layer per
    program, and every page comes back."""
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.transformer import init_model
    cfg = _small_cfg()
    rng = np.random.default_rng(4)
    sys_p = rng.integers(0, 256, 21).astype(np.int32)
    suffixes = [rng.integers(0, 256, 3 + 4 * i).astype(np.int32)
                for i in range(6)]

    def trace():
        reqs = [Request(i, np.concatenate([sys_p, s]), 6)
                for i, s in enumerate(suffixes)]
        return reqs + [Request(6, reqs[2].prompt.copy(), 4)]

    counts = {}
    for dev in ("cpu", cuda):
        model = init_model(cfg, seed=3, device=dev)
        for mode in ("off", "on"):
            srv = BatchedServer(cfg, model, batch_size=3, max_len=64,
                                kv_bits=8, page_size=8, prefill_bucket=8,
                                attn_impl="kernel", prefix_cache=mode,
                                kv_scale="page", device=dev)
            before = pka.paged_kv_attention_chunk.launches
            reqs = srv.run(trace())
            if dev != "cpu":
                torch.cuda.synchronize()
                assert (pka.paged_kv_attention_chunk.launches - before
                        == cfg.num_layers * srv.program_launches)
            assert all(r.done and len(r.out) == r.max_new for r in reqs)
            c = {"prefill_forwards": srv.prefill_forwards,
                 "decode_steps": srv.decode_steps,
                 "allocs": srv.metrics.value("alloc.allocs")}
            if mode == "on":
                st = srv.prefix_cache.stats()
                c.update({k: st[k] for k in ("hits", "hit_tokens",
                                             "cow_copies", "evictions")},
                         wave=srv.wave_dedup_pages)
                assert srv.release_prefix_cache() == 0
            assert srv.allocator.num_free == srv.allocator.num_usable
            counts[(str(dev), mode)] = c
    for mode in ("off", "on"):
        assert counts[(str(cuda), mode)] == counts[("cpu", mode)]
    on, off = counts[(str(cuda), "on")], counts[(str(cuda), "off")]
    assert on["hits"] >= 3 and on["prefill_forwards"] < \
        off["prefill_forwards"]


# ---------------------------------------------------------------------------
# the tiered page store on the card: side-stream copies through pinned
# memory, bf16 pages on the host, and B1 on pools restored from each tier
# ---------------------------------------------------------------------------
def _card_pool(cuda, container, *, b=4, blocks=3, seed=0, num_pages=40,
               dtype=torch.bfloat16):
    """One qwen2-72b-width pool on the card (8 KV heads, head_dim 128,
    page size 16) whose pages an allocator handed out, written through
    ``paged_update``: (caches, allocator, page table, tokens, bits)."""
    from repro_torch.core import paged_kv as tpk
    kv, hd, ps = 8, 128, 16
    rng = np.random.default_rng(seed)
    pool = tpk.init_paged_pool(
        tpk.PagedKVLayout(num_pages, ps, kv, hd, container, dtype), cuda)
    al = tpk.PageAllocator(num_pages)
    pages = [al.alloc() for _ in range(b * blocks)]
    pt = torch.tensor(np.array(pages, np.int32).reshape(b, blocks),
                      device=cuda)
    n = blocks * ps - 3
    bits = {"int8": 8, "int4": 4, "fp": 0}[container]
    k, v = (torch.from_numpy((rng.normal(size=(b, n, kv, hd)) * m)
                             .astype(np.float32)).to(cuda)
            for m in (0.7, 0.4))
    tpk.paged_update(pool, k, v, pt, 0, page_size=ps, container=container,
                     int_bits=2 if bits else None,
                     frac_bits=bits - 2 if bits else None)
    return [pool], al, pt, n, bits


def _state(caches, page):
    return {k: t[page].clone() for k, t in caches[0].items()}


@pytest.mark.parametrize("container", ["int8", "int4", "fp"])
def test_cuda_async_demote_survives_a_rewritten_page(cuda, container):
    """An async demote clones the page on the compute stream and copies the
    clone to a pinned landing buffer on a side stream; the freed page's
    next owner rewrites it before the copy resolves, and the host blob
    (ordinary memory, copied out of the buffer) still holds the page as it
    was, which promotes back byte for byte."""
    from repro_torch.core import page_store as tps
    caches, al, pt, _, _ = _card_pool(cuda, container, seed=1)
    pager = tps.TieredPager(al, tps.HostPageStore(), lambda: caches,
                            async_mode=True)
    page, other = int(pt[0, 0]), int(pt[1, 1])
    want = _state(caches, page)
    h = pager.demote(page)
    again = al.alloc()
    assert again == page                       # the next owner's page
    tps.inject_page(caches, tps.extract_page(caches, other), again)
    assert not torch.equal(caches[0]["k_pages"][page], want["k_pages"])
    blob = pager.host.get(h)
    assert pager.pinned_bytes == blob.nbytes     # one landing buffer
    for f, key in (("k", "k_pages"), ("v", "v_pages"), ("ks", "k_scale"),
                   ("vs", "v_scale")):
        assert blob.arrays[0][f][0].tobytes() == \
            tps.to_host(want[key]).tobytes(), f
    new = pager.promote(h)
    for k, t in _state(caches, new).items():
        assert torch.equal(t, want[k]), k


@pytest.mark.parametrize("container", ["int8", "int4", "fp"])
def test_cuda_async_demotes_share_a_bounded_pinned_ring(cuda, container):
    """Twelve async demotes land in the pager's ring of three pinned
    buffers, each reused only after its last copy resolved: every parked
    page promotes back byte for byte, and the pinned memory stays at three
    pages while the host tier holds twelve."""
    from repro_torch.core import page_store as tps
    caches, al, pt, _, _ = _card_pool(cuda, container, seed=6)
    pager = tps.TieredPager(al, tps.HostPageStore(), lambda: caches,
                            async_mode=True)
    pages = [int(p) for p in pt.flatten()]
    want = [_state(caches, p) for p in pages]
    handles = [pager.demote(p) for p in pages]
    for p in pages:          # the next owners overwrite every freed page
        q = al.alloc()
        tps.inject_page(caches, tps.extract_page(caches, pages[0]), q)
    pager.drain()
    page_bytes = pager.host.get(handles[0]).nbytes
    assert pager.host.num_pages == len(pages) == 12
    assert pager.pinned_bytes == 3 * page_bytes
    for h, w in zip(handles, want):
        new = pager.promote(h)
        for k, t in _state(caches, new).items():
            assert torch.equal(t, w[k]), k


@pytest.mark.parametrize("container", ["int8", "int4", "fp"])
def test_cuda_prefetch_promote_equals_unstaged_promote(cuda, container):
    """A page staged through pinned memory on the side stream and promoted
    after the compute stream waits on its copy holds the bytes an unstaged
    promote writes."""
    from repro_torch.core import page_store as tps
    caches, al, pt, _, _ = _card_pool(cuda, container, seed=2)
    pager = tps.TieredPager(al, tps.HostPageStore(), lambda: caches,
                            async_mode=True)
    src = int(pt[2, 0])
    want = _state(caches, src)
    twin = al.alloc()
    tps.inject_page(caches, tps.extract_page(caches, src), twin)
    ha, hb = pager.demote(src), pager.demote(twin)
    pager.drain()
    assert pager.prefetch(ha) == 1
    staged, unstaged = pager.promote(ha), pager.promote(hb)
    torch.cuda.synchronize()
    assert (pager.prefetches, pager.prefetch_hits) == (1, 1)
    for k in want:
        assert torch.equal(caches[0][k][staged], want[k]), k
        assert torch.equal(caches[0][k][unstaged], want[k]), k


def test_cuda_bf16_page_round_trip_through_host_and_snapshot(cuda,
                                                             tmp_path):
    """A bf16 page goes to the host as its 2-byte patterns, through an
    ``.npz`` snapshot and back, bit for bit, in both pager modes."""
    from repro_torch.core import page_store as tps
    caches, al, pt, _, _ = _card_pool(cuda, "fp", seed=3)
    src = int(pt[0, 1])
    want = _state(caches, src)
    blob = tps.extract_page(caches, src)
    assert blob.arrays[0]["k"].dtype == np.dtype("V2")
    path = str(tmp_path / "bf16")
    tps.save_prefix_snapshot(path, [("fp", [1], blob)], page_size=16,
                             geometry=tps.cache_geometry(caches))
    meta, loaded = tps.load_prefix_snapshot(path)
    assert meta["geometry"] == tps.cache_geometry(caches)
    dst = al.alloc()
    tps.inject_page(caches, loaded[0][2], dst)
    for k in want:
        assert torch.equal(caches[0][k][dst], want[k]), k
    for mode in (False, True):
        pager = tps.TieredPager(al, tps.HostPageStore(), lambda: caches,
                                async_mode=mode)
        page = pager.promote(pager.demote(dst))
        for k in want:
            assert torch.equal(caches[0][k][page], want[k]), (mode, k)
        dst = page


@pytest.mark.parametrize("tier", ["host-int8", "host-int4", "quant-bf16",
                                  "quant-int8"])
def test_cuda_b1_on_pools_restored_from_each_tier(cuda, tier):
    """B1 against its plain version on pages that came back from a tier:
    promoted from the host tier (int8, int4), or restored from the quant
    tier, a bf16 pool holding widened int8 grids under non-unit scales and
    an int8 pool holding int4 grids x 16 under scale / 16."""
    from repro_torch.core import page_store as tps
    kind, cont = tier.split("-")
    container = "fp" if cont == "bf16" else cont
    caches, al, pt, n, bits = _card_pool(cuda, container, seed=4)
    new_pt = pt.clone()
    if kind == "host":
        pager = tps.TieredPager(al, tps.HostPageStore(), lambda: caches,
                                async_mode=True)
        handles = [[pager.demote(int(p)) for p in row] for row in pt]
        for i, row in enumerate(handles):
            for j, h in enumerate(row):
                new_pt[i, j] = pager.promote(h)
    else:
        qt = tps.QuantTierStore(lambda: caches, pages=64)
        parked = []
        for row in pt:
            hs = []
            for p in row:
                hs.append(qt.put(qt.requantize(int(p))))
                al.free([int(p)])
            parked.append(hs)
        for i, row in enumerate(parked):
            for j, h in enumerate(row):
                page = al.alloc()
                qt.restore(h, page)
                new_pt[i, j] = page
        used = new_pt.flatten().long()
        scales = caches[0]["k_scale"][used]
        assert bool((scales != 1.0).all())
        if cont == "bf16":       # int8 grids saturate: one amax per page
            assert torch.unique(scales).numel() >= 2
    pool = caches[0]
    q = torch.randn(pt.shape[0], 64, 128, generator=torch.Generator()
                    .manual_seed(5)).to(cuda, torch.bfloat16)
    lens = torch.full((pt.shape[0],), n, dtype=torch.int32, device=cuda)
    args = (pool["k_pages"], pool["v_pages"], pool["k_scale"],
            pool["v_scale"], new_pt)
    got = pka.paged_kv_attention_decode(q, *args, lens, bits=bits)
    plain = pka.paged_kv_attention_chunk_plain(
        q[:, None].cpu(), *[a.cpu() for a in args], lens.cpu() - 1,
        lens.cpu(), bits=bits)[:, 0]
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


# ---------------------------------------------------------------------------
# the paper's CNNs (torch ops, no kernel): TF32 and cuDNN determinism
# ---------------------------------------------------------------------------
def _cnn_case(net, n):
    from repro_torch.data.synthetic import digits_dataset, shapes32_dataset
    from repro_torch.models import cnn
    spec = cnn.SPECS[net]
    params = cnn.init_cnn(torch.Generator().manual_seed(0), spec,
                          device="cpu")
    make = digits_dataset if net == "lenet" else shapes32_dataset
    x, y = make(n, seed=11)
    return spec, params, cnn.images_nchw(x, "cpu"), torch.from_numpy(y).long()


@pytest.mark.parametrize("net", ["lenet", "convnet", "alexnet_small"])
def test_cuda_cnn_logits_match_cpu_with_tf32_on(cuda, net):
    """TF32 and cuDNN autotuning switched on around the call: the CNN's
    forward turns them off for itself (card logits within 1e-4 of the
    CPU's) and leaves them on for the rest of the program."""
    from repro_torch.models import cnn
    spec, params, x, _ = _cnn_case(net, 64)
    want = cnn.cnn_forward(params, x, spec)
    gparams = {k: {kk: v.to(cuda) for kk, v in d.items()}
               for k, d in params.items()}
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    try:
        torch.backends.cudnn.benchmark = True
        for f in flags:
            f.allow_tf32 = True
        got = cnn.cnn_forward(gparams, x.to(cuda), spec)
        assert torch.backends.cudnn.benchmark
        assert all(f.allow_tf32 for f in flags)
    finally:
        torch.backends.cudnn.benchmark = False
        for f in flags:
            f.allow_tf32 = False
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("net", ["lenet", "convnet", "alexnet_small"])
def test_cuda_cnn_eval_is_a_function(cuda, net):
    """Trained on the card with the reference's recipe, one policy
    evaluated twice gives the same count (the greedy search compares tied
    accuracies with a strict >), within one sample of the port's on the
    CPU. (At random init the ten logits are near ties, so argmax there
    tells nothing of the two devices.)"""
    from repro_torch.benchmarks.common import train_cnn
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import cnn
    spec, _, x, y = _cnn_case(net, 512)
    gparams, _ = train_cnn(net, device=cuda, verbose=False)
    params = {k: {kk: v.cpu() for kk, v in d.items()}
              for k, d in gparams.items()}
    pol = PrecisionPolicy.uniform(spec.layer_names, FixedPointFormat(1, 6),
                                  FixedPointFormat(4, 3))
    a = cnn.cnn_accuracy(gparams, x.to(cuda), y.to(cuda), spec, pol)
    b = cnn.cnn_accuracy(gparams, x.to(cuda), y.to(cuda), spec, pol)
    assert a == b
    assert abs(a - cnn.cnn_accuracy(params, x, y, spec, pol)) * 512 <= 1


# ---------------------------------------------------------------------------
# The MoE and MLA families: B1 at llama4-maverick's query-group size, the
# router's stable top-k and the MoE dispatch on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4, 0])
@pytest.mark.parametrize("s", [1, 32])
def test_cuda_b1_at_group_five(cuda, bits, s):
    """40 query heads over 8 KV heads (G = 5), head_dim 128, page size 16:
    a block packs 25 queries x 5 heads = 125 rows at S = 32 and 5 live
    rows of 16 at decode, so a warp's rows straddle queries (G = 8 never
    did). The tensor-core kernel against the plain version."""
    args = _case(500 + bits + s, b=4, kv=8, g=5, hd=128, ps=16, s=s,
                 bits=bits, start=300, qdt=torch.bfloat16)
    assert pka.query_block(s, 5, 8, False) == min(s, 25)
    assert pka.kernel_route(args[1], head_dim=128, G=5,
                            block_kv=False) == "mma"
    plain = pka.paged_kv_attention_chunk(*args, bits=bits)
    before = pka.paged_kv_attention_chunk.launches
    got = pka.paged_kv_attention_chunk(*[a.to(cuda) for a in args],
                                       bits=bits)
    torch.cuda.synchronize()
    assert pka.paged_kv_attention_chunk.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


def test_cuda_stable_topk_breaks_ties_to_the_lower_index(cuda):
    """Scores with 3 distinct values over 256 experts (bf16 logits cast
    to float32, as the router's): on the card the same indices as on the
    CPU, each run of equal scores in ascending expert order."""
    from repro_torch.models.moe import stable_topk
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 3, (64, 256)).astype(np.float32))
    x = x.to(torch.bfloat16).to(torch.float32)
    for k in (1, 8):
        vals, idx = stable_topk(x.to(cuda), k)
        cv, ci = stable_topk(x, k)
        assert torch.equal(idx.cpu(), ci) and torch.equal(vals.cpu(), cv)
        same = vals[:, 1:] == vals[:, :-1]
        assert bool((idx[:, 1:] > idx[:, :-1])[same].all())


@pytest.mark.parametrize("mode", ["eval_all", "scatter"])
@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "deepseek-v3-671b"])
def test_cuda_moe_apply_matches_cpu(cuda, arch, mode):
    """``moe_apply`` at the smoke widths (float32, capacity factor 0.5 so
    scatter drops assignments): the card's routing equals the CPU's and
    its output and load-balance loss lie within 1e-4."""
    import copy
    import dataclasses
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_smoke_config(arch),
                              moe_capacity_factor=0.5)
    g = torch.Generator().manual_seed(3)
    m = moe.MoE(cfg, torch.float32, "cpu")
    with torch.no_grad():
        moe.init_moe(m, g)
        m.router.normal_(0.0, 2.0 / np.sqrt(cfg.d_model), generator=g)
    x = torch.randn((2, 16, cfg.d_model), generator=g)
    want, aux = moe.moe_apply(m, x, cfg=cfg, mode=mode)
    gm = copy.deepcopy(m).to(cuda)
    got, gaux = moe.moe_apply(gm, x.to(cuda), cfg=cfg, mode=mode)
    assert torch.equal(moe._route(gm, x.to(cuda), cfg)[1].cpu(),
                       moe._route(m, x, cfg)[1])
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
    assert float(gaux["moe_lb_loss"]) == pytest.approx(
        float(aux["moe_lb_loss"]), rel=1e-5)


# ---------------------------------------------------------------------------
# The recurrent families: B1 at jamba's query-group size and the recurrent
# mixers on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4, 0])
@pytest.mark.parametrize("s", [1, 32])
def test_cuda_b1_at_group_four(cuda, bits, s):
    """32 query heads over 8 KV heads (G = 4, jamba-v0.1's attention),
    head_dim 128, page size 16: a block packs 32 queries x 4 heads = 128
    rows at S = 32 and 4 live rows of 16 at decode. The tensor-core kernel
    against the plain version."""
    args = _case(400 + bits + s, b=4, kv=8, g=4, hd=128, ps=16, s=s,
                 bits=bits, start=300, qdt=torch.bfloat16)
    assert pka.query_block(s, 4, 8, False) == s
    assert pka.kernel_route(args[1], head_dim=128, G=4,
                            block_kv=False) == "mma"
    plain = pka.paged_kv_attention_chunk(*args, bits=bits)
    before = pka.paged_kv_attention_chunk.launches
    got = pka.paged_kv_attention_chunk(*[a.to(cuda) for a in args],
                                       bits=bits)
    torch.cuda.synchronize()
    assert pka.paged_kv_attention_chunk.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("kind,arch", [("mamba", "jamba-v0.1-52b"),
                                       ("mlstm", "xlstm-350m"),
                                       ("slstm", "xlstm-350m")])
def test_cuda_ssm_mixer_matches_cpu(cuda, kind, arch):
    """A recurrent mixer at its published widths in float32 (jamba's
    Mamba: di 8192, 128 heads, state 16; xlstm's mLSTM: 4 heads of 512;
    its sLSTM: 4 heads of 256): 64 tokens (one chunk) from the initial
    state, then one token from the returned state, on the card against
    the CPU within 1e-4, states included (TF32 off)."""
    import copy
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import ssm
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    mod_cls, init, apply, _ = ssm.MIXERS[kind]
    g = torch.Generator().manual_seed(5)
    m = mod_cls(cfg, torch.float32, "cpu")
    with torch.no_grad():
        init(m, g)
    gm = copy.deepcopy(m).to(cuda)
    x = torch.randn((2, 65, cfg.d_model), generator=g)
    y, st = apply(m, x[:, :64], cfg=cfg)
    y1, st1 = apply(m, x[:, 64:], cfg=cfg, state=st)
    gy, gst = apply(gm, x[:, :64].to(cuda), cfg=cfg)
    gy1, gst1 = apply(gm, x[:, 64:].to(cuda), cfg=cfg, state=gst)
    for a, b in ((gy, y), (gy1, y1)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), **TOL)
    for k in st1:
        np.testing.assert_allclose(gst1[k].cpu().numpy(), st1[k].numpy(),
                                   err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# The encoder and VLM families: B1 at qwen2-vl's query-group size, an
# encoder block, M-RoPE and the tanh GELU on the card, and a preempted
# recurrent request's parked states
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4, 0])
@pytest.mark.parametrize("s", [1, 32])
def test_cuda_b1_at_group_six(cuda, bits, s):
    """12 query heads over 2 KV heads (G = 6, qwen2-vl-2b), head_dim 128,
    page size 16: a block packs 21 queries x 6 heads = 126 of 128 rows at
    S = 32 and 6 live rows of 16 at decode. The tensor-core kernel against
    the plain version."""
    args = _case(600 + bits + s, b=4, kv=2, g=6, hd=128, ps=16, s=s,
                 bits=bits, start=300, qdt=torch.bfloat16)
    assert pka.query_block(s, 6, 2, False) == min(s, 21)
    assert pka.kernel_route(args[1], head_dim=128, G=6,
                            block_kv=False) == "mma"
    plain = pka.paged_kv_attention_chunk(*args, bits=bits)
    before = pka.paged_kv_attention_chunk.launches
    got = pka.paged_kv_attention_chunk(*[a.to(cuda) for a in args],
                                       bits=bits)
    torch.cuda.synchronize()
    assert pka.paged_kv_attention_chunk.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("chunk", [1024, 128], ids=["full", "chunked"])
def test_cuda_frontend_hubert_block_matches_cpu(cuda, chunk):
    """One hubert-xlarge block at its published widths (d_model 1280, 16
    heads of 80, GELU FFN of 5120) in float32, 256 frames, bidirectional:
    through ``attend_full`` and (attn_chunk 128) the non-causal
    ``attend_chunked``, on the card against the CPU within 1e-4 (TF32
    off)."""
    import copy
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as ttr
    cfg = dataclasses.replace(get_config("hubert-xlarge"), dtype="float32",
                              attn_chunk=chunk)
    assert not cfg.causal and cfg.head_dim == 80
    g = torch.Generator().manual_seed(7)
    blk = ttr.DecoderBlock(cfg, torch.float32, "cpu")
    with torch.no_grad():
        ttr._init_block(blk, g)
        blk.mlp.b_in.normal_(0.0, 1.0, generator=g)
    gblk = copy.deepcopy(blk).to(cuda)
    x = torch.randn((2, 256, cfg.d_model), generator=g)
    pos = torch.arange(256)[None].expand(2, 256)
    want, _, _ = ttr.block_apply(blk, x, pos, cfg=cfg, cache=None,
                                 cache_pos=None)
    got, _, _ = ttr.block_apply(gblk, x.to(cuda), pos.to(cuda), cfg=cfg,
                                cache=None, cache_pos=None)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)


def test_cuda_frontend_mrope_and_tanh_gelu_match_cpu(cuda):
    """qwen2-vl's M-RoPE at head_dim 128 (bands at 16 and 40) over
    4096-range ids, and the tanh-form GELU MLP at qwen2-vl's d_model, on
    the card against the CPU within 1e-4."""
    from repro_torch.models import common, mlp
    g = torch.Generator().manual_seed(8)
    x = torch.randn((2, 64, 12, 128), generator=g)
    ids = torch.randint(0, 4096, (2, 64, 3), generator=g)
    np.testing.assert_allclose(
        common.apply_mrope(x.to(cuda), ids.to(cuda), 1e6).cpu().numpy(),
        common.apply_mrope(x, ids, 1e6).numpy(), **TOL)
    m = mlp.GeluMLP(1536, 1024, torch.float32, "cpu")
    with torch.no_grad():
        mlp.init_gelu_mlp(m, g)
        m.b_in.normal_(0.0, 1.0, generator=g)
    h = torch.randn((2, 16, 1536), generator=g)
    gm = mlp.GeluMLP(1536, 1024, torch.float32, cuda)
    gm.load_state_dict(m.state_dict())
    np.testing.assert_allclose(mlp.gelu_mlp_apply(gm, h.to(cuda)).cpu()
                               .numpy(), mlp.gelu_mlp_apply(m, h).numpy(),
                               **TOL)


def test_cuda_frontend_preempted_states_resume_on_the_card(cuda):
    """jamba-smoke (eval_all, Mamba states beside a paged int8 attention
    layer through B1) with SLO scheduling and the host tier at batch
    size 1: two requests are preempted, their state rows parked on the
    card and written back on resume, and every request gets exactly the
    tokens of an uninterrupted batch-size-1 run on the card."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.transformer import init_model
    cfg = get_smoke_config("jamba-v0.1-52b")
    assert cfg.moe_mode == "eval_all"
    model = init_model(cfg, seed=0, device=cuda)

    def trace():
        rng = np.random.default_rng(11)
        return [Request(i, rng.integers(0, cfg.vocab_size, L).astype(
            np.int32), n, priority=p, arrive_step=a)
            for i, (L, n, p, a) in enumerate(((9, 14, 0, 0), (9, 5, 5, 4),
                                              (5, 6, 1, 8), (4, 4, 9, 12)))]
    kw = dict(batch_size=1, max_len=48, page_size=8, kv_bits=8,
              attn_impl="kernel", device=cuda)
    srv = BatchedServer(cfg, model, num_pages=4, sched="slo",
                        kv_offload="host", **kw)
    parked = []
    resume = srv._resume_slot

    def tap(i, req, total):
        parked.append({li: {k: v.clone() for k, v in rows.items()}
                       for li, rows in req._paused.states.items()})
        resume(i, req, total)
        for li, rows in parked[-1].items():
            for k, v in rows.items():
                assert v.is_cuda and torch.equal(srv.caches[li][k][i], v)
    srv._resume_slot = tap
    reqs = srv.run(trace())
    assert srv.preempt_count == srv.resume_count == len(parked) == 2
    assert all(parked)
    want = BatchedServer(cfg, model, **kw).run(trace())
    assert [r.out for r in reqs] == [r.out for r in want]


# ---------------------------------------------------------------------------
# the serving benches on the card (``-k bench``)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bench_models():
    """qwen2-72b's smoke config, one model on the card and the same
    weights on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.transformer import init_model
    cfg = get_smoke_config("qwen2-72b")
    gpu = init_model(cfg, seed=0, device=torch.device("cuda"))
    return cfg, gpu, init_model(cfg, seed=0, device="cpu")


def _bench(workload, cfg, model):
    from repro_torch.benchmarks import paged_serve, traffic
    if workload == "traffic":
        return traffic.run_serve(cfg, model, fast=True, teacher_force=True,
                                 verbose=False)
    return paged_serve.run(cfg, model, workload=workload, fast=True,
                           teacher_force=True, verbose=False)


@pytest.mark.parametrize("workload", ["mixed", "prefix", "overcommit",
                                      "adapt", "ragged", "traffic"])
def test_cuda_bench_workload_matches_cpu(cuda, bench_models, workload,
                                         tmp_path, monkeypatch):
    """Each serving bench at ``--fast`` on the card, every token gate
    teacher-forced: it passes its gates and its host counters equal the
    same bench's on the CPU (the predictor-on arm of the traffic harness,
    which reads the wall clock, left out). The mixed workload's kernel
    row launches B1 once per layer per program, and each of those calls
    (decode and bucketed prefill, captured as the row made them) equals
    the plain version on its own inputs."""
    from repro_torch.benchmarks import common
    from repro_torch.benchmarks.paged_serve import host_counters
    from repro_torch.models import attention
    monkeypatch.setattr(common, "RESULTS", tmp_path)
    cfg, gpu, cpu = bench_models
    seen = []

    def capturing(real, entry):
        def call(q, *a, bits):
            seen.append((entry, [x.clone() for x in (q,) + a], bits))
            return real(q, *a, bits=bits)
        return call
    for entry in ("paged_kv_attention_decode", "paged_kv_attention_chunk"):
        monkeypatch.setattr(attention, entry,
                            capturing(getattr(attention, entry), entry))
    before = pka.paged_kv_attention_chunk.launches
    got = _bench(workload, cfg, gpu)
    launched = pka.paged_kv_attention_chunk.launches - before
    monkeypatch.undo()
    monkeypatch.setattr(common, "RESULTS", tmp_path)
    want = _bench(workload, cfg, cpu)
    assert (host_counters(workload, got, wall_clock=False)
            == host_counters(workload, want, wall_clock=False))
    if workload != "mixed":
        assert launched == 0 and not seen
        return
    assert got["rows"][-1]["attn_impl"] == "kernel"
    assert launched == len(seen) > 0 and launched % cfg.num_layers == 0
    assert {e for e, _, _ in seen} == {"paged_kv_attention_decode",
                                       "paged_kv_attention_chunk"}
    for entry, inputs, bits in seen:
        out = getattr(pka, entry)(*inputs, bits=bits)
        x = [t.cpu() for t in inputs]
        if entry == "paged_kv_attention_decode":
            plain = pka.paged_kv_attention_chunk_plain(
                x[0][:, None], *x[1:6], x[6] - 1, x[6], bits=bits)[:, 0]
        else:
            plain = pka.paged_kv_attention_chunk_plain(*x, bits=bits)
        np.testing.assert_allclose(out.cpu().numpy(), plain.numpy(), **TOL)


# ---------------------------------------------------------------------------
# the training slice: B1 at G = 1 (deepseek-7b's attention), the train step,
# the int8 optimizer state and the wire, a bf16 checkpoint, on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("s", [1, 32])
def test_cuda_train_b1_at_group_one(cuda, bits, s):
    """32 query heads over 32 KV heads (G = 1, deepseek-7b's attention,
    served after training), head_dim 128, page size 16: a block packs 32
    queries of one head at S = 32 and one live row of 16 at decode. The
    tensor-core kernel against the plain version."""
    args = _case(500 + bits + s, b=4, kv=32, g=1, hd=128, ps=16, s=s,
                 bits=bits, start=300, qdt=torch.bfloat16)
    assert pka.query_block(s, 1, 32, False) == s
    assert pka.kernel_route(args[1], head_dim=128, G=1,
                            block_kv=False) == "mma"
    plain = pka.paged_kv_attention_chunk(*args, bits=bits)
    before = pka.paged_kv_attention_chunk.launches
    got = pka.paged_kv_attention_chunk(*[a.to(cuda) for a in args],
                                       bits=bits)
    torch.cuda.synchronize()
    assert pka.paged_kv_attention_chunk.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


def _train_smoke(device, steps, seed=0):
    """``steps`` train steps of deepseek-7b-smoke on ``device`` from the
    seed's weights made on the CPU; each step's loss and grad norm."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.lm import LMDataConfig, lm_batch
    from repro_torch.launch.steps import (TrainHParams, init_train_state,
                                          make_train_step)
    from repro_torch.models.transformer import init_model
    cfg = get_smoke_config("deepseek-7b")
    model = init_model(cfg, seed=seed, device="cpu", trainable=True)
    hp = TrainHParams(lr=1e-3)
    state = init_train_state(cfg, hp, model=model.to(device))
    step = make_train_step(cfg, hp)
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=4)
    out = []
    for i in range(steps):
        b = {k: v.to(device) for k, v in lm_batch(dcfg, i).items()}
        state, m = step(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def test_cuda_train_step_matches_cpu(cuda):
    """Three steps of deepseek-7b-smoke (float32, TF32 off) on the card
    against the same steps on the CPU: loss and grad norm within rtol
    1e-5 each step."""
    got, want = _train_smoke(cuda, 3), _train_smoke("cpu", 3)
    for (lg, gg), (lw, gw) in zip(got, want):
        assert lg == pytest.approx(lw, rel=1e-5)
        assert gg == pytest.approx(gw, rel=1e-5)


def _shared(rng, shapes):
    return {n: torch.from_numpy(rng.normal(0, s, shape).astype(np.float32))
            for n, (shape, s) in shapes.items()}


TRAIN_SHAPES = {"embed": ((300, 64), 0.5), "norm": ((64,), 1.0),
                "w": ((64, 96), 0.1), "experts": ((4, 64, 32), 0.1)}


def test_cuda_train_int8_moments_match_cpu(cuda):
    """AdamW with int8 moments, three updates on shared gradients (numpy),
    on the card and on the CPU: parameters within 1e-6, moment scales
    within 1e-6, int8 grids equal but for at most 0.1% one-step flips."""
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         adamw_update)
    cfg = AdamWConfig(quantize_moments=True)
    rng = np.random.default_rng(11)
    p0 = _shared(rng, TRAIN_SHAPES)
    grads = [_shared(rng, {n: (s, 0.05) for n, (s, _) in
                           TRAIN_SHAPES.items()}) for _ in range(3)]
    out = []
    for dev in (cuda, torch.device("cpu")):
        params = {n: p.clone().to(dev) for n, p in p0.items()}
        st = adamw_init(params, cfg)
        for g in grads:
            adamw_update(params, {n: x.to(dev) for n, x in g.items()}, st,
                         1e-2, cfg)
        out.append((params, st))
    (pc, sc), (ph, sh) = out
    flips = total = 0
    for n in TRAIN_SHAPES:
        np.testing.assert_allclose(pc[n].cpu().numpy(), ph[n].numpy(),
                                   rtol=1e-6, atol=1e-6)
        for k in ("m", "v"):
            np.testing.assert_allclose(sc[k][n]["scale"].cpu().numpy(),
                                       sh[k][n]["scale"].numpy(), rtol=1e-6)
            d = (sc[k][n]["q"].cpu().to(torch.int32)
                 - sh[k][n]["q"].to(torch.int32)).abs()
            assert int(d.max()) <= 1
            flips += int((d != 0).sum())
            total += d.numel()
    assert flips <= 1e-3 * total, (flips, total)


@pytest.mark.parametrize("bits", [8, 16])
def test_cuda_train_compression_matches_cpu(cuda, bits):
    """The int8 (int16) gradient wire with error feedback, three steps on
    shared gradients: compressed gradients and residuals equal the CPU's
    exactly (every division is by a tensor)."""
    from repro_torch.optim.compress import (CompressionConfig,
                                            compress_gradients,
                                            error_feedback_init)
    cfg = CompressionConfig(bits=bits)
    rng = np.random.default_rng(bits)
    grads = [_shared(rng, TRAIN_SHAPES) for _ in range(3)]
    res_c = error_feedback_init({n: g.to(cuda) for n, g in grads[0].items()})
    res_h = error_feedback_init(grads[0])
    for g in grads:
        cc, res_c = compress_gradients({n: x.to(cuda) for n, x in g.items()},
                                       res_c, cfg)
        ch, res_h = compress_gradients(g, res_h, cfg)
        for n in g:
            assert torch.equal(cc[n].cpu(), ch[n])
            assert torch.equal(res_c[n].cpu(), res_h[n])


def test_cuda_train_bf16_checkpoint_round_trip(cuda, tmp_path):
    """C6 on the card: a train-state tree of deepseek-7b-smoke made on the
    card, every float leaf cast to bf16, saved and restored onto the card
    bit for bit (the int32 step exactly)."""
    from repro_torch.checkpoint.ckpt import (restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.steps import (TrainHParams, init_train_state,
                                          train_state_tree)

    def bf16(t):
        if isinstance(t, dict):
            return {k: bf16(v) for k, v in t.items()}
        if isinstance(t, list):
            return [bf16(v) for v in t]
        return t.to(torch.bfloat16) if t.is_floating_point() else t

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        return b.device.type == "cuda" and torch.equal(a, b)

    cfg = get_smoke_config("deepseek-7b")
    state = init_train_state(cfg, TrainHParams(), device=cuda)
    tree = bf16(train_state_tree(state, cfg, device=cuda))
    tree["params"]["embed"]["table"][0, :3] = torch.tensor(
        [float("nan"), -0.0, 1e-40])
    save_checkpoint(str(tmp_path), 1, tree)
    _, back, _ = restore_checkpoint(str(tmp_path), tree, device=cuda)
    assert same(tree, back)


# ---------------------------------------------------------------------------
# Training of the recurrent and encoder families and from embeddings: the
# mixers' backward, the int8 wire's grouping (C7) and a VLM trained from
# patch embeddings, each on the card against the CPU
# ---------------------------------------------------------------------------
def _mixer_grads(mod, apply, cfg, x, quant, weights, device):
    """The gradients of every parameter and of the input of a weighted
    sum of the mixer's output and returned state, on ``device``."""
    import copy
    m = copy.deepcopy(mod).to(device)
    for p in m.parameters():
        p.requires_grad_(True)
    u = x.clone().to(device).requires_grad_(True)
    y, st = apply(m, u, cfg=cfg, state_quant=quant)
    loss = (y * weights["y"].to(device)).sum()
    for k, v in st.items():
        loss = loss + (v * weights[k].to(device)).sum()
    loss.backward()
    out = {n: p.grad for n, p in m.named_parameters()}
    out["input"] = u.grad
    return float(loss.detach()), {n: g.cpu() for n, g in out.items()}


@pytest.mark.parametrize("kind,arch", [("mamba", "jamba-v0.1-52b"),
                                       ("mlstm", "xlstm-350m"),
                                       ("slstm", "xlstm-350m")])
def test_cuda_train2_mixer_backward_matches_cpu(cuda, kind, arch):
    """A recurrent mixer at its published widths in float32, its chunk
    cut to 32 so that 64 tokens cross one boundary, float states: the
    loss within rtol 1e-5 and every parameter's and the input's gradient
    within 1e-4 of its largest magnitude, on the card against the CPU
    (TF32 off). (On a state grid, the card and the CPU put a state value
    at a rounding tie one grid step apart now and then, as any two
    float programs do; the grid itself is held exactly below.)"""
    quant = None
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import ssm
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              ssm_chunk=32)
    mod_cls, init, apply, _ = ssm.MIXERS[kind]
    g = torch.Generator().manual_seed(7)
    m = mod_cls(cfg, torch.float32, "cpu")
    with torch.no_grad():
        init(m, g)
    x = torch.randn((2, 64, cfg.d_model), generator=g)
    y, st = apply(m, x, cfg=cfg)
    weights = {"y": torch.randn(y.shape, generator=g)}
    weights.update({k: torch.randn(v.shape, generator=g)
                    for k, v in st.items()})
    lc, gc = _mixer_grads(m, apply, cfg, x, quant, weights, cuda)
    lh, gh = _mixer_grads(m, apply, cfg, x, quant, weights, "cpu")
    assert lc == pytest.approx(lh, rel=1e-5)
    for n, want in gh.items():
        scale = max(float(want.abs().max()), 1e-30)
        err = float((gc[n] - want).abs().max())
        assert err <= 1e-4 * scale, (n, err, scale)


@pytest.mark.parametrize("fmt", [(2, 6), (4, 4)])
def test_cuda_train2_state_grid_is_straight_through_as_on_cpu(cuda, fmt):
    """C8 on the card: the recurrent state grid under autograd (Q2.6 of
    KV8 alone, Q4.4 of KV8 under D12) returns the CPU's values bit for bit
    (ties half to even, clipping) and passes the gradient where the CPU
    does: 1 inside the range, 0 where it clips."""
    from repro_torch.models import ssm
    scale = 2.0 ** fmt[1]
    ties = (torch.arange(-600, 600, dtype=torch.float32) + 0.5) / scale
    x = torch.cat([ties, 4 * torch.randn(
        (4, 4, 64, 65), generator=torch.Generator().manual_seed(2)
    ).reshape(-1)])
    out = []
    for dev in (cuda, torch.device("cpu")):
        xg = x.clone().to(dev).requires_grad_(True)
        y = ssm._maybe_fake_quant(xg, fmt)
        y.backward(torch.ones_like(y))
        out.append((y.detach().cpu(), xg.grad.cpu()))
    (yc, gc), (yh, gh) = out
    assert torch.equal(yc, yh)
    assert torch.equal(gc, gh)
    assert 0 < float(gh.sum()) < gh.numel()


def test_cuda_train2_wire_groups_match_cpu(cuda):
    """C7 on the card: the int8 wire with the train step's grouping (one
    scale per leaf of the reference's tree, ``reference_groups``) on
    xlstm-350m-smoke's parameter shapes, three steps of shared gradients:
    compressed gradients and residuals equal the CPU's exactly."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.steps import reference_groups
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.compress import (CompressionConfig,
                                            compress_gradients,
                                            error_feedback_init)
    cfg = get_smoke_config("xlstm-350m")
    model = init_model(cfg, device="cpu", trainable=True)
    groups = reference_groups(model, cfg)
    assert groups
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    rng = np.random.default_rng(3)
    grads = [{n: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
              for n, s in shapes.items()} for _ in range(3)]
    ccfg = CompressionConfig()
    res_c = error_feedback_init({n: x.to(cuda) for n, x in grads[0].items()})
    res_h = error_feedback_init(grads[0])
    for gr in grads:
        cc, res_c = compress_gradients({n: x.to(cuda) for n, x in gr.items()},
                                       res_c, ccfg, groups=groups)
        ch, res_h = compress_gradients(gr, res_h, ccfg, groups=groups)
        for n in gr:
            assert torch.equal(cc[n].cpu(), ch[n]), n
            assert torch.equal(res_c[n].cpu(), res_h[n]), n


def _train_embeds(device, arch, steps, seed=0):
    """``steps`` train steps of an arch's smoke config on ``device`` from
    ``make_batch``'s stub-frontend batches (4 x 80: qwen2-vl's 8 x 8 patch
    grid, then 16 text positions), weights made on the CPU."""
    import dataclasses
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.configs.shapes import SHAPES, make_batch
    from repro_torch.launch.steps import (TrainHParams, init_train_state,
                                          make_train_step)
    from repro_torch.models.transformer import init_model
    cfg = get_smoke_config(arch)
    model = init_model(cfg, seed=seed, device="cpu", trainable=True)
    hp = TrainHParams(lr=1e-3)
    state = init_train_state(cfg, hp, model=model.to(device))
    step = make_train_step(cfg, hp)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=80)
    out = []
    for i in range(steps):
        b = make_batch(cfg, shape, generator=torch.Generator().manual_seed(i),
                       device="cpu", batch_override=4)
        state, m = step(state, {k: v.to(device) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def test_cuda_train2_vlm_from_embeddings_matches_cpu(cuda):
    """Three steps of qwen2-vl-2b-smoke from patch embeddings with M-RoPE
    ids (float32, TF32 off) on the card against the same steps on the
    CPU: loss and grad norm within rtol 1e-5 each step."""
    got = _train_embeds(cuda, "qwen2-vl-2b", 3)
    want = _train_embeds("cpu", "qwen2-vl-2b", 3)
    for (lg, gg), (lw, gw) in zip(got, want):
        assert lg == pytest.approx(lw, rel=1e-5)
        assert gg == pytest.approx(gw, rel=1e-5)


# ---------------------------------------------------------------------------
# the serving half of the distributed layer: the replica frontend, the
# world-size-1 mesh path on NCCL, and B1 on a tensor-parallel rank's heads
# ---------------------------------------------------------------------------
_REPLICA_KW = dict(batch_size=2, max_len=48, page_size=8, num_pages=12,
                   kv_bits=8, attn_impl="kernel", prefix_cache="on",
                   kv_offload="host", sched="slo", metrics="on",
                   pager_async="on")


def _replica_trace(vocab):
    from repro_torch.core.traffic import (TenantSpec, TraceConfig,
                                          generate_trace)
    return generate_trace(TraceConfig(
        seed=11, horizon=24, rate=0.3, process="bursty", burst_rate=1.2,
        p_enter_burst=0.2, p_exit_burst=0.3, vocab_size=vocab,
        tenants=(TenantSpec("chat", weight=0.7, priority=5,
                            deadline_slack=6, prompt_mean=8.0,
                            prompt_sigma=0.4, prompt_cap=12,
                            max_new_mean=2.5, max_new_sigma=0.4,
                            max_new_cap=4, shared_prefix_len=6,
                            prefix_pool=2),
                 TenantSpec("bulk", weight=0.3, priority=0,
                            deadline_slack=None, prompt_mean=9.0,
                            prompt_sigma=0.4, prompt_cap=14,
                            max_new_mean=6.0, max_new_sigma=0.3,
                            max_new_cap=8))))


def _counters(srv):
    return {k: v for k, v in srv.metrics.snapshot()["counters"].items()
            if not k.endswith("_s")}


def test_cuda_replicas_one_replica_is_the_plain_server(cuda):
    """A 1-replica ``ReplicaFrontend`` on the card, through B1 with the
    prefix cache, the host tier, the async pager and SLO scheduling: its
    tokens, done flags and finish steps equal the plain server's bit for
    bit, and so do its host counters."""
    from repro_torch.launch.frontend import (ReplicaFrontend,
                                             requests_from_trace)
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models.transformer import init_model
    cfg = _small_cfg()
    model = init_model(cfg, seed=5, device=cuda)
    trace = _replica_trace(cfg.vocab_size)
    plain = BatchedServer(cfg, model, device=cuda, **_REPLICA_KW)
    want = plain.run(requests_from_trace(trace)[0])
    fe = ReplicaFrontend([BatchedServer(cfg, model, device=cuda,
                                        **_REPLICA_KW)])
    before = pka.paged_kv_attention_chunk.launches
    got, keys = requests_from_trace(trace)
    fe.run(got, keys)
    assert pka.paged_kv_attention_chunk.launches - before \
        == cfg.num_layers * fe.servers[0].program_launches > 0
    for g, w in zip(got, want):
        assert (g.rid, list(g.out), g.done, g.finish_step) == \
            (w.rid, list(w.out), w.done, w.finish_step)
    assert _counters(fe.servers[0]) == _counters(plain)


def test_cuda_replicas_mesh_world_one_is_the_plain_server(cuda):
    """``BatchedServer(mesh=make_serving_mesh(1))`` on a one-rank NCCL
    group (its collectives run, over one rank) against the plain server:
    the same tokens bit for bit and the same host counters, page scales
    included."""
    import torch.distributed as dist
    from repro_torch.launch.frontend import requests_from_trace
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models.transformer import init_model
    cfg = _small_cfg()
    model = init_model(cfg, seed=6, device=cuda)
    trace = _replica_trace(cfg.vocab_size)
    kw = dict(_REPLICA_KW, kv_scale="page")
    plain = BatchedServer(cfg, model, device=cuda, **kw)
    want = plain.run(requests_from_trace(trace)[0])
    mesh = make_serving_mesh(1, device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        srv = BatchedServer(cfg, model, mesh=mesh, device=cuda, **kw)
        assert srv.model is not model
        got = srv.run(requests_from_trace(trace)[0])
    finally:
        dist.destroy_process_group()
    assert [list(r.out) for r in got] == [list(r.out) for r in want]
    assert _counters(srv) == _counters(plain)


def test_cuda_replicas_mesh_predictor_reads_the_first_rank(cuda):
    """The deadline-miss predictor under a one-rank NCCL mesh: its
    wall-clock feature goes through the model group's broadcast
    (``parallel.hints.first_rank_value``, a float64 on the card), and
    with both clocks reading one TPOT slowdown the mesh server consults
    the same features and serves the plain server's tokens and
    counters."""
    import torch.distributed as dist
    from repro_torch.launch.frontend import requests_from_trace
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.hints import first_rank_value
    cfg = _small_cfg()
    model = init_model(cfg, seed=7, device=cuda)
    trace = _replica_trace(cfg.vocab_size)
    kw = dict(_REPLICA_KW, predictor="on")

    def serve(srv):
        srv.slo_monitor.tpot_slowdown = lambda: 0.125
        seen, consult = [], srv.predictor.consult
        srv.predictor.consult = lambda x: (seen.append(list(x)),
                                           consult(x))[1]
        return srv.run(requests_from_trace(trace)[0]), seen

    plain = BatchedServer(cfg, model, device=cuda, **kw)
    want, want_seen = serve(plain)
    mesh = make_serving_mesh(1, device="cuda")
    try:
        srv = BatchedServer(cfg, model, mesh=mesh, device=cuda, **kw)
        assert first_rank_value(-0.0625, srv.mesh_plan, cuda) == -0.0625
        got, seen = serve(srv)
    finally:
        dist.destroy_process_group()
    assert len(seen) >= 3 and seen == want_seen
    assert {f[-1] for f in seen} == {0.125}
    assert [list(r.out) for r in got] == [list(r.out) for r in want]
    assert _counters(srv) == _counters(plain)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("s", [1, 32])
def test_cuda_replicas_b1_on_local_heads(cuda, bits, s):
    """B1 on a tensor-parallel rank's heads at qwen2-72b's widths over 2
    ranks: 32 query heads over 4 KV heads (G = 8), head_dim 128, page size
    16, against its plain version."""
    args = _case(700 + bits + s, b=4, kv=4, g=8, hd=128, ps=16, s=s,
                 bits=bits, start=200, qdt=torch.bfloat16)
    plain = pka.paged_kv_attention_chunk(*args, bits=bits)
    before = pka.paged_kv_attention_chunk.launches
    got = pka.paged_kv_attention_chunk(*[a.to(cuda) for a in args],
                                       bits=bits)
    torch.cuda.synchronize()
    assert pka.paged_kv_attention_chunk.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), **TOL)


# ---------------------------------------------------------------------------
# distributed training on a one-rank NCCL group (``[dist]``)
# ---------------------------------------------------------------------------
def _dist_leaves(state):
    out = {f"params/{n}": p.detach()
           for n, p in state["params"].named_parameters()}
    for k in ("m", "v"):
        for n, v in state["opt"][k].items():
            for j, x in (v.items() if isinstance(v, dict) else [("", v)]):
                out[f"opt/{k}/{n}/{j}"] = x
    for n, r in state.get("ef_residual", {}).items():
        out[f"ef_residual/{n}"] = r
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_cuda_dist_mesh_step_is_the_plain_step(cuda, quantized):
    """``make_train_step(plan=)`` over ``make_host_mesh("cuda")`` (one
    NCCL rank) on deepseek-7b-smoke, 3 steps against the plain step from
    the same state: losses, grad norms and every state leaf bit for bit;
    quantized: W10 / D12 / KV8, int8 moments and the int8 wire."""
    import torch.distributed as dist
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.lm import LMDataConfig, lm_batch
    from repro_torch.launch.mesh import close_process_group, make_host_mesh
    from repro_torch.launch.steps import (TrainHParams, init_train_state,
                                          make_train_step, shard_train_state)
    from repro_torch.launch.train import build_quant
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compress import CompressionConfig
    from repro_torch.parallel.sharding import plan_for_mesh
    cfg = get_smoke_config("deepseek-7b")
    hp = TrainHParams(lr=1e-3, adamw=AdamWConfig(quantize_moments=quantized),
                      grad_compress=CompressionConfig() if quantized
                      else None)
    quant = (build_quant(cfg, weight_bits=10, data_bits=12, kv_bits=8,
                         policy_json="") if quantized else None)
    d = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=4,
                     seed=2)
    mesh = make_host_mesh("cuda")
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        plan = plan_for_mesh(mesh)
        plain = init_train_state(cfg, hp, seed=4, device=cuda)
        sharded = shard_train_state(init_train_state(cfg, hp, seed=4,
                                                     device=cuda), cfg, plan)
        s_plain = make_train_step(cfg, hp, quant=quant)
        s_mesh = make_train_step(cfg, hp, quant=quant, plan=plan)
        for i in range(3):
            b = {k: v.to(cuda) for k, v in lm_batch(d, i).items()}
            _, mp = s_plain(plain, b)
            _, mm = s_mesh(sharded, b)
            assert all(torch.equal(mp[k], mm[k]) for k in mp), (i, mp, mm)
        a, b = _dist_leaves(plain), _dist_leaves(sharded)
        assert [k for k in a if not torch.equal(a[k], b[k])] == []
    finally:
        close_process_group()


def test_cuda_dist_elastic_round_trip(cuda, tmp_path):
    """A deepseek-7b-smoke state trained 2 mesh steps on the card, its
    checkpoint written under the plan and ``elastic_restore``d onto a
    plain state from another seed: every leaf bit for bit."""
    from repro_torch.checkpoint.ckpt import save_checkpoint
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.lm import LMDataConfig, lm_batch
    from repro_torch.launch.mesh import close_process_group, make_host_mesh
    from repro_torch.launch.steps import (TrainHParams, init_train_state,
                                          make_train_step, shard_train_state,
                                          train_state_tree)
    from repro_torch.parallel.sharding import plan_for_mesh
    from repro_torch.runtime import elastic_restore
    cfg = get_smoke_config("deepseek-7b")
    hp = TrainHParams(lr=1e-3)
    d = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=4,
                     seed=2)
    mesh = make_host_mesh("cuda")
    try:
        plan = plan_for_mesh(mesh)
        state = shard_train_state(init_train_state(cfg, hp, seed=4,
                                                   device=cuda), cfg, plan)
        step = make_train_step(cfg, hp, plan=plan)
        for i in range(2):
            step(state, {k: v.to(cuda) for k, v in lm_batch(d, i).items()})
        save_checkpoint(str(tmp_path), 2, train_state_tree(state, cfg,
                                                           plan=plan),
                        plan=plan)
        got, restored, _ = elastic_restore(
            str(tmp_path), init_train_state(cfg, hp, seed=5, device=cuda),
            mesh)
    finally:
        close_process_group()
    assert got == 2
    a, b = _dist_leaves(state), _dist_leaves(restored)
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


def test_cuda_dist_allreduce_and_gpipe_at_world_one(cuda):
    """World size 1 on CUDA tensors: ``quantized_allreduce`` over the
    one-rank "data" axis returns its input; ``gpipe_apply`` on a
    one-stage mesh equals the sequential chain, forward and gradient."""
    from repro_torch.launch.mesh import (close_process_group,
                                         make_host_mesh, make_test_mesh)
    from repro_torch.optim.compress import quantized_allreduce
    from repro_torch.parallel.hints import activation_hints
    from repro_torch.parallel.pipeline import gpipe_apply
    from repro_torch.parallel.sharding import plan_for_mesh
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1000, generator=g).to(cuda)
    W = (torch.randn(1, 32, 32, generator=g) * 0.3).to(cuda)
    xs = torch.randn(3, 2, 32, generator=g).to(cuda)
    mesh = make_host_mesh("cuda")
    try:
        with activation_hints(plan_for_mesh(mesh)):
            assert quantized_allreduce(x, "data") is x
        stage = make_test_mesh((1,), ("stage",), device="cuda")
        got_w = W.clone().requires_grad_(True)
        got = gpipe_apply(lambda w, h: torch.tanh(h @ w), got_w, xs,
                          mesh=stage)
        got.sum().backward()
    finally:
        close_process_group()
    want_w = W.clone().requires_grad_(True)
    want = torch.tanh(xs @ want_w[0])
    want.sum().backward()
    np.testing.assert_allclose(got.detach().cpu().numpy(),
                               want.detach().cpu().numpy(), **TOL)
    np.testing.assert_allclose(got_w.grad.cpu().numpy(),
                               want_w.grad.cpu().numpy(), **TOL)

"""Port parity, the kernel entry point: every op of
``repro_torch.kernels.ops`` (on CPU tensors: the kernels' plain versions)
against ``repro.kernels.ops`` in interpret mode and the oracles of both
packages, on the same numpy inputs, at a few fixed shapes that are ragged
against the reference's blocks. The CUDA kernels themselves are checked
against the plain versions in tests/test_torch_cuda.py.

Tolerances: quant_cast, pack and unpack exact; qmatmul rtol 1e-4 / atol
1e-3 (f32) and 2e-2 / 0.2 (bf16), as tests/test_kernels.py; attention
1e-4, and the KV-head-blocked route 1e-5 against the port's default."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import t  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _special(frac_bits: int) -> np.ndarray:
    """Exact ties and the largest float32 below a half step, both signs."""
    below = np.nextafter(np.float32(0.5), np.float32(0))
    return np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, below, -below,
                     3 + below, -(3 + below)], np.float32) * np.float32(
                         2.0 ** -frac_bits)


@pytest.mark.parametrize("shape,i,f", [((1, 1), 2, 6), ((37, 129), 2, 6),
                                       ((4, 37, 129), 3, 5),
                                       ((300, 700), 8, 8),
                                       ((6, 10), 2, 14)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_cast_exact(shape, i, f, dtype):
    rng = np.random.default_rng(sum(shape) + i + f)
    x = (rng.normal(size=shape) * 5).astype(np.float32)
    flat = x.reshape(-1)
    sp = _special(f)
    flat[:min(len(sp), flat.size)] = sp[:flat.size]
    tdt = getattr(torch, dtype)
    y = ops.quant_cast(t(x).to(tdt), i, f)
    jy = jops.quant_cast(jnp.asarray(x).astype(dtype), i, f)
    assert y.dtype == tdt and tuple(y.shape) == shape
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(jy, np.float32))
    np.testing.assert_array_equal(
        y.float().numpy(),
        tref.quant_cast_ref(t(x).to(tdt), i, f).float().numpy())


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
@pytest.mark.parametrize("rows,words", [(3, 4), (37, 5)])
def test_pack_unpack_exact(bits, rows, words):
    """Words equal the reference kernels' and oracles' (top bit set
    included); unpacking sign-extends back; leading dims reshape as the
    reference's ops do."""
    vpw = 32 // bits
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    rng = np.random.default_rng(bits * 100 + rows)
    q = rng.integers(lo, hi + 1, (rows, words * vpw)).astype(np.int32)
    q[0, :vpw] = lo
    q[-1, -vpw:] = hi
    w = ops.pack(t(q), bits)
    jw = jops.pack(jnp.asarray(q), bits)
    assert w.dtype == torch.int32 and tuple(w.shape) == (rows, words)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tref.pack_ref(t(q), bits).numpy(),
                                  np.asarray(jref.pack_ref(jnp.asarray(q),
                                                           bits)))
    back = ops.unpack(w, bits)
    np.testing.assert_array_equal(back.numpy(), q)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jops.unpack(jw,
                                                                       bits)))
    np.testing.assert_array_equal(tref.unpack_ref(w, bits).numpy(), q)
    w3 = ops.pack(t(q).reshape(1, rows, -1), bits)
    assert torch.equal(w3[0], w)
    assert torch.equal(ops.unpack(w3, bits)[0], back)


def test_pack_rejects_what_the_reference_asserts():
    q = torch.zeros((2, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        ops.pack(q, 8)
    with pytest.raises(ValueError, match="bits"):
        ops.pack(q, 3)
    with pytest.raises(ValueError, match="multiple"):
        tref.pack_ref(q, 4)


@pytest.mark.parametrize("m,k,n,adt,wdt", [
    (1, 1, 1, "float32", "int8"), (5, 300, 130, "float32", "int8"),
    (130, 77, 257, "bfloat16", "int8"), (33, 520, 65, "float32", "int16")])
def test_qmatmul_matches_reference(m, k, n, adt, wdt):
    """The int16 grid is 32x finer (values to +-4096, scales / 32), so the
    weights it holds span the same range as the int8 cases'."""
    rng = np.random.default_rng(m + k + n)
    a = rng.normal(size=(m, k)).astype(np.float32)
    lim = 128 if wdt == "int8" else 4096
    wq = rng.integers(-lim, lim, (k, n)).astype(wdt)
    s = (rng.uniform(0.001, 0.05, n) * 128 / lim).astype(np.float32)
    tdt = getattr(torch, adt)
    got = ops.qmatmul(t(a).to(tdt), t(wq), t(s))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    ja = jnp.asarray(a).astype(adt)
    want = jops.qmatmul(ja, jnp.asarray(wq), jnp.asarray(s))
    tol = 2e-2 if adt == "bfloat16" else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol * 10)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.quant_matmul_ref(ja, jnp.asarray(wq),
                                                      jnp.asarray(s))),
        rtol=tol, atol=tol * 10)
    np.testing.assert_allclose(
        tref.quant_matmul_ref(t(a).to(tdt), t(wq), t(s)).numpy(),
        np.asarray(jref.quant_matmul_ref(ja, jnp.asarray(wq),
                                         jnp.asarray(s))),
        rtol=tol, atol=tol * 10)


def test_qmatmul_rejects_mismatched_shapes():
    a, wq = torch.zeros((2, 3)), torch.zeros((4, 5), dtype=torch.int8)
    with pytest.raises(ValueError, match="do not match"):
        ops.qmatmul(a, wq, torch.ones(5))
    with pytest.raises(ValueError, match="scales"):
        ops.qmatmul(a, wq[:3], torch.ones(4))


@pytest.mark.parametrize("b,kv,g,hd,T,kv_len,block_t", [
    (2, 2, 2, 32, 77, 70, 32), (1, 1, 4, 16, 40, 40, 64)])
def test_kv_attention_matches_reference(b, kv, g, hd, T, kv_len, block_t):
    """The identity-page-table wrapper: T padded up to whole pages,
    uniform 2^-F scales; equals the reference op and both oracles."""
    rng = np.random.default_rng(T)
    q = rng.normal(size=(b, kv * g, hd)).astype(np.float32)
    k_q = rng.integers(-128, 128, (b, T, kv, hd)).astype(np.int8)
    v_q = rng.integers(-128, 128, (b, T, kv, hd)).astype(np.int8)
    got = ops.kv_attention(t(q), t(k_q), t(v_q), kv_len, int_bits=2,
                           frac_bits=6, block_t=block_t)
    jargs = (jnp.asarray(q), jnp.asarray(k_q), jnp.asarray(v_q))
    want = jops.kv_attention(*jargs, kv_len, int_bits=2, frac_bits=6,
                             block_t=block_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = jref.kv_attention_ref(*jargs, 2, 6, kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    np.testing.assert_allclose(
        tref.kv_attention_ref(t(q), t(k_q), t(v_q), 2, 6, kv_len).numpy(),
        np.asarray(oracle), **TOL)


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("s", [1, 5])
def test_paged_chunk_block_kv_matches_reference(bits, s):
    """``block_kv=True`` through ops: 1e-4 against the reference's blocked
    kernel (interpret mode), 1e-5 against the port's default route, on
    fragmented tables with starts mid-page."""
    rng = np.random.default_rng(bits * 7 + s)
    b, kv, g, hd, ps = 2, 2, 2, 32, 16
    starts = np.maximum(0, 19 - rng.integers(0, 4, b)).astype(np.int32)
    np_pages = -(-int(starts.max() + s) // ps)
    pool = tref.make_fragmented_pool(rng, b, np_pages, ps, kv, hd, bits)
    q = rng.normal(size=(b, s, kv * g, hd)).astype(np.float32)
    lens = (starts + s).astype(np.int32)
    targs = [t(x) for x in (q, *pool, starts, lens)]
    got = ops.paged_kv_attention_chunk(*targs, bits=bits, block_q=4,
                                       block_kv=True)
    default = ops.paged_kv_attention_chunk(*targs, bits=bits, block_q=4)
    np.testing.assert_allclose(got.numpy(), default.numpy(), rtol=1e-5,
                               atol=1e-5)
    jargs = [jnp.asarray(x) for x in (q, *pool, starts, lens)]
    want = jops.paged_kv_attention_chunk(*jargs, bits=bits, block_q=4,
                                         block_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_decode_op_matches_reference():
    rng = np.random.default_rng(11)
    b, kv, g, hd, ps, np_pages = 2, 2, 2, 16, 8, 3
    pool = tref.make_fragmented_pool(rng, b, np_pages, ps, kv, hd, 8)
    q = rng.normal(size=(b, kv * g, hd)).astype(np.float32)
    lens = np.array([5, 24], np.int32)
    got = ops.paged_kv_attention(*[t(x) for x in (q, *pool, lens)], bits=8)
    want = jops.paged_kv_attention(*[jnp.asarray(x) for x in
                                     (q, *pool, lens)], bits=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel_bench_stages_on_cpu(tmp_path, monkeypatch):
    """The port's kernel bench: the reference bench's stages and row keys,
    every row within its oracle's tolerance, host times named *_cpu_s on
    the CPU, the record saved under results/."""
    from benchmarks import kernel_bench as jbench
    from repro_torch.benchmarks import kernel_bench as tbench
    monkeypatch.setattr(tbench, "RESULTS", tmp_path)
    res = tbench.run(device="cpu", verbose=False)
    assert list(res) == list(jbench._STAGES)
    assert set(res["pack"]) == {"2b", "4b", "8b", "16b"}
    assert set(res["paged_decode_gap"]) == {
        f"ctx{c}-{k}" for c in (64, 256) for k in ("fp", "int8", "int4")}
    for rows in res.values():
        for r in rows.values():
            assert not any(k.endswith("_ms") for k in r)
            assert any(k.endswith("_cpu_s") for k in r)
            for k in ("max_err_vs_ref", "rel_err_vs_ref",
                      "max_err_vs_gather"):
                assert r.get(k, 0.0) <= 1e-4
            assert r.get("roundtrip_exact", True)
            assert r.get("blocked_vs_default_err", 0.0) <= 1e-5
    assert (tmp_path / "torch_kernel_bench.json").exists()


def test_kernel_bench_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    from repro_torch.benchmarks import kernel_bench
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_bench.main(["--only", "pack"])

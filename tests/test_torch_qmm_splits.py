"""Port, quantized-weight matmul on tensor cores with split-K (CPU side of
the CUDA kernel in ``src/repro_torch/kernels/csrc/quant_matmul.cu``):

- the planner ``plan_qmm`` is a pure function of the shapes, the tile's
  (BM, BN, BK) and the card's occupancy; its splits cover K exactly in
  runs of whole K steps, none empty; at qwen2-72b's widths the grid fills
  a wave; M > 32 takes the prefill tile (``qmm_tile``). The tile shapes
  are those of the kernel's two instantiations (on the card the library
  reports them, and tests/test_torch_cuda.py checks the plans it makes);
- the plain partials over the planner's runs, merged by
  ``merge_splits_plain`` (the merge kernel's plain version: summed in split
  order, then scaled), equal ``kernels/ref.py::quant_matmul_ref`` and the
  JAX package's ``ops.qmatmul`` (its Pallas kernel in interpret mode);
- an emulation of the kernel's numerics (a float32 ``a`` as bf16 parts,
  the int8 grid exact, a float32 sum per 16-deep MMA step and part in
  split order, the merge, the scales last) holds 1e-4 of max|ref| with a
  10x margin at K = 8192 against the JAX reference with ``A_PARTS`` parts,
  and one part fewer does not, so the kernel takes the fewest that hold;
- the route rule: an int8 grid with aligned rows takes the tensor-core
  kernel; an int16 grid, N % 16 != 0, a row of ``a`` that is not a whole
  number of 16-byte chunks or an unaligned data pointer the FMA kernel.

Tolerances: 1e-4 (float32 ``a``) and 2e-2 (bf16 ``a``) of max|ref| (the
tests/test_kernels.py standard); 1e-5 of max|ref| for the emulation."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import t  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

QWEN2_72B = [  # M, K, N: decode up- and down-projection, a prefill chunk
    (8, 8192, 29568), (8, 29568, 8192), (256, 8192, 29568)]
# (BM, BN, BK) of DecodeTile and PrefillTile in csrc/quant_matmul.cu
TILES = {"decode": (32, 128, 64), "prefill": (128, 128, 32)}
SHAPES = QWEN2_72B + [(1, 8192, 1024), (17, 4096, 2048), (33, 1024, 512),
                      (129, 520, 528), (5, 256, 4096), (200, 256, 1024),
                      (1, 16, 16), (32, 100000, 16)]


def _inputs(seed, m, k, n, adt):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, k)).astype(np.float32)
    wq = rng.integers(-128, 128, (k, n)).astype(np.int8)
    s = rng.uniform(0.001, 0.05, n).astype(np.float32)
    return t(a).to(getattr(torch, adt)), t(wq), t(s)


def _plan(M, N, K, **kw):
    return qmm.plan_qmm(M, N, K, TILES[qmm.qmm_tile(M)], **kw)


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("bps", [1, 2, 3, 4])
def test_plan_qmm_covers_k_in_aligned_runs(M, K, N, bps):
    plan = _plan(M, N, K, blocks_per_sm=bps)
    assert plan == qmm.plan_qmm.__wrapped__(M, N, K, TILES[plan.tile],
                                            blocks_per_sm=bps)
    assert plan.tile == ("prefill" if M > qmm.DECODE_MAX_ROWS else "decode")
    bk = TILES[plan.tile][2]
    assert plan.k_step == bk
    ranges = plan.k_ranges(K)
    assert len(ranges) == plan.splits <= qmm.MAX_SPLITS
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (_, e0), (b1, _) in zip(ranges, ranges[1:]):
        assert e0 == b1                                 # contiguous
    assert all(e > b for b, e in ranges)                # none empty
    assert all(b % bk == 0 for b, _ in ranges)          # whole K steps
    per = plan.steps_per_split * bk
    assert all(e - b == per for b, e in ranges[:-1])
    # what the launch checks: every split has a step, the last ends at K
    ksteps = -(-K // bk)
    assert plan.steps_per_split * (plan.splits - 1) < ksteps
    assert plan.steps_per_split * plan.splits >= ksteps
    if plan.splits > 1:
        assert plan.steps_per_split >= qmm.MIN_SPLIT_STEPS


@pytest.mark.parametrize("M,K,N", QWEN2_72B)
@pytest.mark.parametrize("bps", [2, 3, 4])
def test_plan_qmm_fills_a_wave_at_qwen2_72b(M, K, N, bps):
    """Enough blocks for every resident slot of the card; a grid of
    output tiles that fills the slots alone is not split."""
    plan = _plan(M, N, K, blocks_per_sm=bps)
    bm, bn, _ = TILES[plan.tile]
    tiles = -(-M // bm) * -(-N // bn)
    assert tiles * plan.splits >= qmm.H100_SMS * bps
    if tiles >= qmm.H100_SMS * bps:
        assert plan.splits == 1
    # fewer SMs, fewer splits
    assert _plan(M, N, K, sms=16, blocks_per_sm=bps).splits <= plan.splits


@pytest.mark.parametrize("m,k,n,adt", [
    (8, 1024, 256, "float32"), (8, 1024, 256, "bfloat16"),
    (40, 520, 144, "float32"), (3, 2048, 64, "bfloat16")])
def test_merged_plain_splits_match_references(m, k, n, adt):
    a, wq, s = _inputs(m + k + n, m, k, n, adt)
    plan = _plan(m, n, k, blocks_per_sm=4)
    assert plan.splits > 1
    parts = torch.stack([qmm.quant_matmul_partial_plain(a, wq, r)
                         for r in plan.k_ranges(k)])
    merged = qmm.merge_splits_plain(parts, s)
    ref = tref.quant_matmul_ref(a, wq, s)
    want = np.asarray(jops.qmatmul(jnp.asarray(a.float().numpy()).astype(adt),
                                   jnp.asarray(wq.numpy()),
                                   jnp.asarray(s.numpy())))
    tol = (1e-4 if adt == "float32" else 2e-2) * float(ref.abs().max())
    assert float((merged - ref).abs().max()) <= tol
    assert float(np.abs(merged.numpy() - want).max()) <= tol


def _bf16_parts(x: torch.Tensor, n: int):
    """x as n bf16 values summed: hi = bf16(x), then bf16 of what is left."""
    parts = []
    for _ in range(n):
        h = x.to(torch.bfloat16).to(torch.float32)
        parts.append(h)
        x = x - h
    return parts


def emulate_mma_kernel(a, wq, scales, plan, parts):
    """The tensor-core kernel's arithmetic on the CPU: ``a`` as ``parts``
    bf16 parts, products with the int8 grid exact (float64), each 16-deep
    MMA step of each part rounded to float32 and added to the split's
    float32 accumulator in order, the splits merged in order, the scales
    last."""
    M, K = a.shape
    pa = _bf16_parts(a.to(torch.float32), parts)
    wf = wq.to(torch.float64)
    partials = []
    for k0, k1 in plan.k_ranges(K):
        acc = torch.zeros((M, wq.shape[1]), dtype=torch.float32)
        for kk in range(k0, k1, 16):
            for p in pa:
                acc = acc + (p[:, kk:kk + 16].double() @ wf[kk:kk + 16]).float()
        partials.append(acc)
    return qmm.merge_splits_plain(torch.stack(partials), scales)


@pytest.mark.parametrize("m,adt", [(8, "float32"), (8, "bfloat16"),
                                   (64, "float32")])
def test_kernel_numerics_hold_at_k_8192(m, adt):
    """qwen2-72b's up-projection depth (K = 8192) on 320 columns: the
    emulated kernel within 1e-5 of max|ref| (1e-4 with a 10x margin) of
    the JAX reference on the same values."""
    a, wq, s = _inputs(m, m, 8192, 320, adt)
    plan = _plan(m, 320, 8192, blocks_per_sm=4)
    got = emulate_mma_kernel(a, wq, s, plan, qmm.A_PARTS[a.dtype])
    want = np.asarray(jref.quant_matmul_ref(
        jnp.asarray(a.float().numpy()), jnp.asarray(wq.numpy()),
        jnp.asarray(s.numpy())))
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err


def test_one_part_fewer_misses_the_float32_tolerance():
    """A float32 ``a`` as one bf16 part (2^-9 relative) misses 1e-4 of
    max|ref| at K = 8192: the kernel's two parts are the fewest that
    hold."""
    a, wq, s = _inputs(8, 8, 8192, 320, "float32")
    plan = _plan(8, 320, 8192, blocks_per_sm=4)
    got = emulate_mma_kernel(a, wq, s, plan, qmm.A_PARTS[torch.float32] - 1)
    want = np.asarray(jref.quant_matmul_ref(
        jnp.asarray(a.numpy()), jnp.asarray(wq.numpy()),
        jnp.asarray(s.numpy())))
    err = float(np.abs(got.numpy() - want).max())
    assert err > 1e-4 * float(np.abs(want).max()), err


def _at(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``x`` starting ``offset`` elements into a
    fresh buffer (its data pointer off a 16-byte boundary for an odd
    offset)."""
    buf = torch.zeros(x.numel() + offset, dtype=x.dtype)
    buf[offset:] = x.flatten()
    return buf[offset:].view(x.shape)


@pytest.mark.parametrize("adt,wdt,k,n,off_a,off_w,route", [
    ("bfloat16", "int8", 520, 528, 0, 0, "mma"),
    ("float32", "int8", 516, 64, 0, 0, "mma"),
    ("bfloat16", "int8", 516, 64, 0, 0, "fma"),    # 1032-byte rows of a
    ("float32", "int8", 514, 64, 0, 0, "fma"),
    ("bfloat16", "int8", 512, 72, 0, 0, "fma"),    # N % 16 != 0
    ("bfloat16", "int16", 512, 64, 0, 0, "fma"),   # int16 grid
    ("float32", "int8", 512, 64, 1, 0, "fma"),     # a off 16 bytes
    ("bfloat16", "int8", 512, 64, 0, 16, "mma"),   # wq 16 bytes in
    ("bfloat16", "int8", 512, 64, 0, 8, "fma")])   # wq off 16 bytes
def test_kernel_route(adt, wdt, k, n, off_a, off_w, route):
    a = _at(torch.zeros((8, k), dtype=getattr(torch, adt)), off_a)
    wq = _at(torch.zeros((k, n), dtype=getattr(torch, wdt)), off_w)
    s = torch.ones(n)
    assert qmm.kernel_route(a, wq, s) == route

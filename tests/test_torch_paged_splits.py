"""Port, paged attention on tensor cores with split-KV (CPU side of the
CUDA kernels in ``src/repro_torch/kernels/csrc/paged_kv_attention.cu``):

- the split planner is a pure function of the shapes that covers every
  page-table column exactly once with no empty split;
- the plain partials over the planner's ranges, merged by
  ``merge_partials_plain`` (the merge kernel's plain version), equal the
  unsplit plain version (1e-6) and the JAX Pallas chunk kernel in
  interpret mode (1e-4);
- an emulation of the kernel's numerics (integer grid as the bf16 MMA
  operand, scales after QK^T, ``v_scale`` folded into P split as bf16
  hi + lo, a float32 q split into three bf16 parts, float32 accumulation
  over 16-key tiles, the planner's splits and the merge) holds against the
  JAX dense oracle at 1e-4 on served-like widths (head_dim 128, G 8, 1-2k
  keys), so the design's error budget fits before any card runs it.

Tolerances: 1e-6 where only the order of float32 sums differs; 1e-4 abs +
rel against the reference (the tests/test_kernels.py standard)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import t  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.qtensor import unpack_bits  # noqa: E402
from repro_torch.kernels import paged_kv_attention as pka  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)

SHAPES = [  # B, KV, S, NP, ps, G, blocks_per_sm (B1, B2)
    (8, 8, 1, 36, 16, 8, (3, 1)),      # served decode, max_len 576
    (8, 8, 32, 36, 16, 8, (2, 1)),     # served prefill bucket
    (8, 8, 1, 128, 16, 8, (3, 1)),     # decode, 2k keys
    (8, 8, 32, 128, 16, 8, (2, None)),  # B2 on the FMA route
    (2, 8, 1, 256, 8, 8, (4, 1)),      # page size 8, 2k keys
    (1, 1, 1, 5000, 16, 1, (8, 2)),    # more pages than one split holds
    (3, 2, 5, 4, 8, 4, (2, 1)),
    (1, 2, 1, 1, 16, 2, (None, None)),  # one page, FMA route
]


@pytest.mark.parametrize("B,KV,S,NP,ps,G,bps", SHAPES)
def test_plan_splits_covers_every_page_once(B, KV, S, NP, ps, G, bps):
    kw = dict(B=B, KV=KV, S=S, NP=NP, ps=ps, G=G, blocks_per_sm=bps)
    splits = pka.plan_splits(**kw)
    assert splits == pka.plan_splits.__wrapped__(**kw)  # shapes alone
    assert splits[0][0] == 0 and splits[-1][1] == NP
    for (b0, e0), (b1, _) in zip(splits, splits[1:]):
        assert e0 == b1                                 # contiguous
    assert all(e > b for b, e in splits)                # none empty
    assert max(e - b for b, e in splits) <= pka._MAX_SPLIT_PAGES
    covered = np.zeros(NP, int)
    for b, e in splits:
        covered[b:e] += 1
    assert (covered == 1).all()
    # equal ranges but the last: the kernel takes (pages per split, count)
    per = splits[0][1] - splits[0][0]
    assert all(e - b == per for b, e in splits[:-1])


@pytest.mark.parametrize("bps", [2, 3, 4])
def test_plan_splits_fill_one_wave_at_served_decode(bps):
    """Served decode (8 rows x 8 KV heads = 64 B1 blocks unsplit) gets as
    many splits as fill one wave of resident blocks, each at least 64 keys
    long; B2's 8 blocks a split ask for more, and both take the larger
    count; a chunk whose blocks already fill the card is not split."""
    kw = dict(B=8, KV=8, NP=128, ps=16, G=8)
    splits = pka.plan_splits(S=1, blocks_per_sm=(bps, None), **kw)
    blocks = 8 * 8 * len(splits)
    assert bps * pka.H100_SMS - 64 < blocks <= bps * pka.H100_SMS
    assert min(e - b for b, e in splits) * 16 >= pka._MIN_SPLIT_KEYS
    both = pka.plan_splits(S=1, blocks_per_sm=(bps, 1), **kw)
    assert len(both) == max(len(splits), pka.H100_SMS // 8)
    assert len(pka.plan_splits(S=1, num_sms=16, blocks_per_sm=(bps, None),
                               **kw)) < len(splits)
    assert len(pka.plan_splits(S=128, blocks_per_sm=(bps, 1), **kw)) == 1


@pytest.mark.parametrize("S,G,KV,block_kv,want", [
    (1, 8, 8, False, 1), (32, 8, 8, False, 16), (5, 4, 2, False, 5),
    (1, 8, 8, True, 1), (32, 8, 8, True, 4), (33, 4, 2, True, 32),
    (3, 200, 1, False, 1)])
def test_query_block(S, G, KV, block_kv, want):
    assert pka.query_block(S, G, KV, block_kv) == want
    # a float32 q holds B2 to 8 warps (three bf16 parts of its fragments)
    f32 = pka.query_block(S, G, KV, block_kv, torch.float32)
    assert f32 == (want if not block_kv else max(1, min(S, 128 // KV // G)))


@pytest.mark.parametrize("dtype,hd,G,KV,block_kv,route", [
    (torch.int8, 128, 8, 8, False, "mma"),
    (torch.int32, 128, 8, 8, True, "mma"),
    (torch.bfloat16, 32, 4, 2, False, "mma"),
    (torch.float32, 128, 8, 8, False, "fma"),     # float32 pages
    (torch.int8, 16, 2, 2, False, "fma"),         # head_dim 16
    (torch.int8, 128, 8, 16, True, "fma"),        # B2 past 8 warps
    (torch.int8, 128, 8, 16, False, "mma"),
    (torch.int8, 128, 256, 1, False, "fma")])     # G past 128 rows
def test_kernel_route(dtype, hd, G, KV, block_kv, route):
    pages = torch.zeros((2, 16, KV, hd // 8 if dtype == torch.int32 else hd),
                        dtype=dtype)
    assert pka.kernel_route(pages, head_dim=hd, G=G,
                            block_kv=block_kv) == route


def _case(seed, *, b, kv, g, hd, ps, s, bits, lo, hi):
    """Fragmented pool, per-row lengths in [lo, hi], the chunk's S queries
    ending at each row's last key."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, b).astype(np.int32)
    np_pages = -(-int(lens.max()) // ps)
    kq, vq, ks, vs, pt = tref.make_fragmented_pool(rng, b, np_pages, ps, kv,
                                                   hd, bits)
    q = rng.normal(size=(b, s, kv * g, hd)).astype(np.float32)
    return q, (kq, vq, ks, vs, pt), (lens - s).astype(np.int32), lens


def _jax_args(q, pool, starts, lens):
    return tuple(jnp.asarray(x) for x in (q, *pool, starts, lens))


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("s,ps", [(1, 8), (1, 16), (6, 8), (6, 16)])
def test_merged_plain_partials_match_unsplit_and_reference(bits, s, ps):
    q, pool, starts, lens = _case(bits + 10 * s + ps, b=3, kv=2, g=4, hd=32,
                                  ps=ps, s=s, bits=bits, lo=300, hi=600)
    args = (t(q), *(t(x) for x in pool), t(starts), t(lens))
    B, S, H, hd = q.shape
    splits = pka.plan_splits(B=B, KV=2, S=S, NP=pool[4].shape[1], ps=ps,
                             G=4)
    assert len(splits) > 1
    parts = [pka.paged_kv_attention_partial_plain(*args, bits=bits,
                                                  pages=range(b, e))
             for b, e in splits]
    merged = pka.merge_partials_plain(*(torch.stack(x) for x in zip(*parts)))
    whole = pka.paged_kv_attention_chunk(*args, bits=bits)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)
    want = jops.paged_kv_attention_chunk(*_jax_args(q, pool, starts, lens),
                                         bits=bits, block_q=4)
    np.testing.assert_allclose(merged.numpy(), np.asarray(want), **TOL)


def _bf16_parts(x: torch.Tensor, n: int):
    """x as n bf16 values summed: hi = bf16(x), then bf16 of what is left."""
    parts = []
    for _ in range(n):
        h = x.to(torch.bfloat16).to(torch.float32)
        parts.append(h)
        x = x - h
    return parts


def emulate_mma_kernel(q, k_pages, v_pages, k_scale, v_scale, page_table,
                       q_start, kv_len, *, bits):
    """The tensor-core kernel's arithmetic in float32 on the CPU: per split
    of the planner, 16-key tiles up to the last visible key, scores as
    (q . grid) * k_scale * sm_scale, masked online softmax, P * v_scale as
    bf16 hi + lo against the grid, then the merge."""
    B, S, H, hd = q.shape
    _, ps, KV, _ = k_pages.shape
    NP = page_table.shape[1]
    G = H // KV
    sm = float(1.0 / np.sqrt(hd))
    ids = page_table.long()

    def grid(x):
        x = x[ids].reshape(B, NP * ps, KV, -1)
        return (unpack_bits(x, 4, hd) if bits == 4 else x).to(torch.float32)

    kg, vg = grid(k_pages), grid(v_pages)
    ksk = (k_scale[ids] * sm).repeat_interleave(ps, dim=1)        # (B, T)
    vsk = v_scale[ids].repeat_interleave(ps, dim=1)
    qf = q.to(torch.float32).reshape(B, S, KV, G, hd)
    qparts = _bf16_parts(qf, 3 if q.dtype == torch.float32 else 1)
    qpos = q_start[:, None] + torch.arange(S)[None]                 # (B, S)
    stop = torch.minimum(qpos[:, -1], kv_len - 1) + 1               # (B,)
    parts = []
    for p0, p1 in pka.plan_splits(B=B, KV=KV, S=S, NP=NP, ps=ps, G=G):
        m = torch.full((B, S, KV, G), pka.NEG_INF)
        l = torch.zeros((B, S, KV, G))
        acc = torch.zeros((B, S, KV, G, hd))
        for k0 in range(p0 * ps, p1 * ps, 16):
            sl = slice(k0, min(k0 + 16, p1 * ps))
            pos = torch.arange(sl.start, sl.stop)
            s = sum(torch.einsum("bskgd,btkd->bskgt", x, kg[:, sl])
                    for x in qparts) * ksk[:, None, None, None, sl]
            ok = ((pos[None, None] <= qpos[:, :, None])
                  & (pos[None, None] < stop[:, None, None]))
            s = torch.where(ok[:, :, None, None], s,
                            torch.tensor(pka.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = p * vsk[:, None, None, None, sl]
            acc = acc * corr[..., None] + sum(
                torch.einsum("bskgt,btkd->bskgd", x, vg[:, sl])
                for x in _bf16_parts(pv, 2))
            m = m_new
        parts.append((m.reshape(B, S, H), l.reshape(B, S, H),
                      acc.reshape(B, S, H, hd)))
    return pka.merge_partials_plain(*(torch.stack(x) for x in zip(*parts)))


@pytest.mark.parametrize("bits", [8, 4, 0])
@pytest.mark.parametrize("s", [1, 8])
@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float32])
def test_kernel_numerics_hold_at_served_widths(bits, s, qdt):
    """qwen2-72b attention widths (8 KV heads, G 8, head_dim 128, page
    size 16) at 1-2k keys: the emulated kernel within 1e-4 of the JAX
    dense oracle. (A bf16 P alone carries 2^-9 of relative error, times
    |V| up to ~10 on int8 pages: the hi/lo split is what fits 1e-4.)"""
    q, pool, starts, lens = _case(bits + s, b=2, kv=8, g=8, hd=128, ps=16,
                                  s=s, bits=bits, lo=1024, hi=2048)
    kq, vq, ks, vs, pt = (t(x) for x in pool)
    if bits == 0:
        kq, vq = kq.to(torch.bfloat16), vq.to(torch.bfloat16)
    qt = t(q).to(qdt)
    got = emulate_mma_kernel(qt, kq, vq, ks, vs, pt, t(starts), t(lens),
                             bits=bits)
    exact = [x.to(torch.float32) if x.is_floating_point() else x
             for x in (qt, kq, vq)]                 # the bf16 values
    want = jref.paged_kv_attention_chunk_ref(
        *_jax_args(*(x.numpy() for x in exact[:1]),
                   (exact[1].numpy(), exact[2].numpy(), *pool[2:]), starts,
                   lens), bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

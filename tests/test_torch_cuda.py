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

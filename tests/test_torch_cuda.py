"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the test). Run them on a machine with an H100 — which has no JAX, so the
repository's conftest.py (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pytest

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxtpu_torch.ops import attention as att
    return torch, att


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,t,s,d", [
    (1, 1, 1, 1, 64), (1, 3, 33, 33, 32), (2, 2, 127, 129, 64),
    (1, 2, 200, 70, 128), (1, 1, 300, 1000, 64), (3, 1, 64, 2048, 32)])
def test_flash_kernel_matches_plain_version(cuda, dtype, tol, causal, b, h,
                                            t, s, d):
    torch, att = cuda
    g = torch.Generator(device="cuda").manual_seed(t * s + d)
    dt = getattr(torch, dtype)
    q = torch.randn(b, h, t, d, device="cuda", generator=g).to(dt)
    k = torch.randn(b, h, s, d, device="cuda", generator=g).to(dt)
    v = torch.randn(b, h, s, d, device="cuda", generator=g).to(dt)
    before = att.flash_attention.launches
    got = att.flash_attention(q, k, v, causal=causal, sm_scale=0.3)
    want = att.flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=0.3)
    torch.cuda.synchronize()
    assert att.flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_nan_past_the_kv_tail_never_leaks(cuda):
    """Rows past S in the same allocation are never read."""
    torch, att = cuda
    buf = torch.full((1, 1, 80, 64), float("nan"), device="cuda")
    buf[:, :, :70] = torch.randn(1, 1, 70, 64, device="cuda")
    k = buf[:, :, :70]  # contiguous prefix of a NaN-tailed buffer
    q = torch.randn(1, 1, 16, 64, device="cuda")
    out = att.flash_attention(q, k, k)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("case", ["float16", "non_contiguous", "d48"])
def test_kernel_refuses_what_it_does_not_take(cuda, case):
    torch, att = cuda
    from mxtpu_torch import MXNetError
    q = torch.zeros(1, 2, 8, 64, device="cuda")
    if case == "float16":
        q = q.half()
    elif case == "non_contiguous":
        q = torch.zeros(1, 8, 2, 64, device="cuda").transpose(1, 2)
    else:
        q = torch.zeros(1, 2, 8, 48, device="cuda")
    k = torch.zeros_like(q).contiguous()
    before = att.flash_attention.launches
    with pytest.raises(MXNetError):
        att.flash_attention(q, k, k)
    assert att.flash_attention.launches == before

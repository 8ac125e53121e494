"""The port's flash-attention gradient against mxtpu's: the plain backward
(what a CPU tensor runs, ``flash_attention_backward_reference`` under
``FlashAttentionFunction``) against mxtpu's gradient, which is
``jax.vjp`` of ``_streaming`` (``_flash3_bwd`` recomputes through it):
taken directly at most shapes, and once through the public
``mxtpu.ops.attention.flash_attention``, whose forward runs its Pallas
kernel in interpret mode here (B*H*T*S <= 2**22).

Tolerances: float32 within atol 2e-5 (both sum in f32, in other orders).
bfloat16 within 3e-2 of the largest gradient: ``_streaming`` rounds the
scores of q.k to bf16 inside its einsum and differentiates through bf16
arithmetic, where the port's plain backward computes in f32 from bf16
inputs and rounds only the results, so the two differ by a few bf16 ulps
(2^-8 each) of the largest values. Head dims 160 and 256 (the card's
wide pair, D > 128) are held the same way. Also: gradcheck in float64, the row
log-sum-exp, NaN beyond the tensors' ends never read, S = 0, meta shape
inference, and CPU dispatch launching no kernel."""
import numpy as np
import pytest

from mxtpu.ops import attention as jatt


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    from mxtpu_torch.ops import attention as att
    return torch, att


def _inputs(b, h, t, s, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, t, d).astype(np.float32) * 0.5,
            rng.randn(b, h, s, d).astype(np.float32) * 0.5,
            rng.randn(b, h, s, d).astype(np.float32) * 0.5,
            rng.randn(b, h, t, d).astype(np.float32))


def _jax_grads(q, k, v, g, dtype, causal, block_k=64, public=False):
    """mxtpu's gradient: jax.vjp of ``_streaming`` in its (B*H, T, D)
    layout, or (``public``) of the public op."""
    import jax
    import jax.numpy as jnp
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    b, h, t, d = q.shape
    if public:
        def f(a, b_, c):
            return jatt.flash_attention(a, b_, c, causal=causal, block_q=32,
                                        block_k=block_k)
        shape = lambda x: x  # noqa: E731
    else:
        def f(a, b_, c):
            return jatt._streaming(a, b_, c, d ** -0.5, causal,
                                   block=block_k)
        shape = lambda x: x.reshape((b * h,) + x.shape[2:])  # noqa: E731
    args = [jnp.asarray(shape(x), jdt) for x in (q, k, v)]
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(x.astype(jnp.float32)).reshape(y.shape)
            for x, y in zip(vjp(jnp.asarray(shape(g), jdt)), (q, k, v))]


def _port_grads(tt, q, k, v, g, dtype, **kw):
    torch, att = tt
    tdt = getattr(torch, dtype)
    args = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    out = att.flash_attention(*args, **kw)
    grads = torch.autograd.grad(out, args, torch.from_numpy(g).to(tdt))
    assert all(x.dtype == tdt for x in grads)
    return [x.float().numpy() for x in grads]


@pytest.mark.parametrize("b,h,t,s,d,causal,dtype", [
    (1, 2, 64, 64, 64, True, "float32"),      # one tile
    (1, 2, 64, 64, 64, False, "float32"),
    (2, 1, 96, 96, 32, True, "float32"),      # ragged tail, T == S
    (1, 2, 48, 160, 32, True, "float32"),     # T < S, ragged kv tail
    (1, 2, 48, 160, 32, False, "float32"),
    (1, 2, 160, 40, 64, True, "float32"),     # T > S
    (1, 1, 64, 64, 128, True, "float32"),     # D = 128
    (1, 2, 96, 96, 64, True, "bfloat16"),
    (1, 2, 48, 160, 32, False, "bfloat16"),
    (1, 2, 48, 80, 160, True, "float32"),     # D > 128: the wide pair's
    (1, 2, 80, 48, 160, False, "float32"),    # plain version
    (1, 1, 64, 96, 256, True, "float32"),
    (1, 1, 96, 64, 256, False, "float32"),
    (1, 1, 64, 96, 256, True, "bfloat16"),
])
def test_plain_backward_matches_mxtpu_vjp(tt, b, h, t, s, d, causal, dtype):
    q, k, v, g = _inputs(b, h, t, s, d, seed=t + 3 * s + d)
    want = _jax_grads(q, k, v, g, dtype, causal)
    got = _port_grads(tt, q, k, v, g, dtype, causal=causal, block_q=32,
                      block_k=64)
    _check(got, want, dtype)


def _check(got, want, dtype):
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        if dtype == "float32":
            np.testing.assert_allclose(a, w, rtol=0, atol=2e-5,
                                       err_msg=name)
        else:
            err = np.abs(a - w).max() / max(1.0, np.abs(w).max())
            assert err <= 3e-2, (name, err)


def test_plain_backward_matches_the_public_mxtpu_op(tt):
    """Through ``mxtpu.ops.attention.flash_attention`` itself (its Pallas
    forward in interpret mode, its custom VJP), causal, T != S."""
    b, h, t, s, d = 1, 2, 80, 112, 32
    assert b * h * t * s <= 1 << 22
    q, k, v, g = _inputs(b, h, t, s, d, seed=11)
    want = _jax_grads(q, k, v, g, "float32", True, public=True)
    got = _port_grads(tt, q, k, v, g, "float32", causal=True)
    _check(got, want, "float32")


@pytest.mark.parametrize("d", [160, 256, 640])
def test_plain_backward_at_wide_head_dims_matches_the_public_mxtpu_op(tt, d):
    """D > 128 (the card's wide pair) through mxtpu's public op, whose
    Pallas forward carries D whole (interpret mode here), causal, T != S,
    float32 within 2e-5."""
    b, h, t, s = 1, 2, 48, 72
    q, k, v, g = _inputs(b, h, t, s, d, seed=d)
    want = _jax_grads(q, k, v, g, "float32", True, public=True)
    got = _port_grads(tt, q, k, v, g, "float32", causal=True)
    _check(got, want, "float32")


def test_gradcheck_float64(tt):
    """The plain path in float64 (it then computes in float64): causal,
    T != S, a custom scale."""
    torch, att = tt
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, n, 32)).requires_grad_()
               for n in (9, 13, 13))
    assert torch.autograd.gradcheck(
        lambda a, b, c: att.flash_attention(a, b, c, causal=True,
                                            sm_scale=0.3), (q, k, v))


@pytest.mark.parametrize("causal", [False, True])
def test_lse_is_the_rows_logsumexp(tt, causal):
    torch, att = tt
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 2, 70, 50, 32, 1))
    _, lse = att.flash_attention_reference(q, k, v, causal=causal,
                                           return_lse=True)
    s = q @ k.transpose(-1, -2) / np.sqrt(32)
    if causal:
        s = s.masked_fill(torch.arange(50)[None, :] >
                          torch.arange(70)[:, None], float("-inf"))
    want = torch.logsumexp(s, dim=-1)
    assert lse.shape == (1, 2, 70) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)


def test_nan_beyond_the_ends_is_never_read(tt):
    """k and v as views into buffers whose rows past S are NaN: the
    gradients are finite and equal those of contiguous copies."""
    torch, att = tt
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, 40, 72, 32, 2))
    kbuf = torch.full((1, 2, 100, 32), float("nan"))
    vbuf = torch.full((1, 2, 100, 32), float("nan"))
    kbuf[:, :, :72] = k
    vbuf[:, :, :72] = v
    kv_views = (kbuf[:, :, :72], vbuf[:, :, :72])
    for causal in (False, True):
        out, lse = att.flash_attention_reference(q, *kv_views, causal=causal,
                                                 return_lse=True)
        got = att.flash_attention_backward_reference(
            q, *kv_views, out, g, lse, causal=causal)
        want = att.flash_attention_backward_reference(
            q, k, v, out, g, lse, causal=causal)
        for a, w in zip(got, want):
            assert bool(torch.isfinite(a).all())
            torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_no_keys_gives_zero_gradients(tt):
    torch, att = tt
    q = torch.randn(1, 2, 5, 32, requires_grad=True)
    k = torch.randn(1, 2, 0, 32, requires_grad=True)
    v = torch.randn(1, 2, 0, 32, requires_grad=True)
    out = att.flash_attention(q, k, v)
    _, lse = att.flash_attention_reference(q, k, v, return_lse=True)
    assert bool(torch.isinf(lse).all()) and bool((lse > 0).all())
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert float(dq.abs().max()) == 0.0 and dk.shape == k.shape


def test_autograd_on_cpu_launches_no_kernel_and_meta_infers(tt):
    torch, att = tt
    before = (att.flash_attention.launches,
              att.flash_attention_backward.launches)
    q = torch.randn(1, 1, 8, 32, requires_grad=True)
    out = att.flash_attention(q, q, q, causal=True)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__.startswith("FlashAttentionFunction")
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    assert (att.flash_attention.launches,
            att.flash_attention_backward.launches) == before
    with torch.no_grad():  # inference records nothing
        assert att.flash_attention(q, q, q).grad_fn is None
    m = torch.empty(2, 3, 10, 64, device="meta", requires_grad=True)
    mo = att.flash_attention(m, m, m, causal=True)
    assert mo.shape == m.shape and mo.device.type == "meta"
    dq, dk, dv = att.flash_attention_backward(m, m, m, mo, mo,
                                              torch.empty(2, 3, 10,
                                                          device="meta"))
    assert dq.shape == m.shape and dq.device.type == "meta"


def test_backward_kernel_input_checks_raise(tt):
    """The CUDA backward's checks run before any launch: a CPU tensor
    handed straight to it raises MXNetError."""
    torch, att = tt
    from mxtpu_torch.base import MXNetError
    q = torch.randn(1, 1, 4, 32)
    with pytest.raises(MXNetError):
        att._flash_bwd_cuda(q, q, q, q, q, torch.zeros(1, 1, 4), True, 1.0)
    x = torch.randn(1, 1, 4, 513)  # past 512: the wide pair, unpadded
    assert att._kernel_width(x, x, x) == 513 and att._wide(x)
    with pytest.raises(MXNetError, match="CUDA"):  # the device check
        att._flash_bwd_cuda(x, x, x, x, x, torch.zeros(1, 1, 4), True, 1.0)

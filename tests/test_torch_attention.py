"""mxtpu_torch flash attention vs mxtpu's: the port's plain version
(what a CPU tensor runs) against ``mxtpu.ops.attention.flash_attention``,
which at B*H*T*S <= 2**22 runs its Pallas kernel in interpret mode on the
CPU, as the JAX package's own tests run it. float32 within atol 1e-4,
bfloat16 within 2e-2 (p is rounded to bf16 at different points of the
two online softmaxes). Also the wrapper's dispatch: a CPU tensor takes the
plain version and launches nothing, the kernel's input checks raise, and
the module has no try/fallback."""
import ast
import inspect

import numpy as np
import pytest

from mxtpu.ops import attention as jatt


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    from mxtpu_torch.ops import attention as att
    return torch, mxtpu_torch, att


def _qkv(b, h, t, s, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, t, d).astype(np.float32) * 0.5,
            rng.randn(b, h, s, d).astype(np.float32) * 0.5,
            rng.randn(b, h, s, d).astype(np.float32) * 0.5)


def _jax_flash(q, k, v, dtype, **kw):
    import jax.numpy as jnp
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out = jatt.flash_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                               jnp.asarray(v, jdt), **kw)
    return np.asarray(out.astype(jnp.float32))


def _port_flash(tt, q, k, v, dtype, **kw):
    torch, _, att = tt
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    out = att.flash_attention(*(torch.from_numpy(x).to(tdt)
                                for x in (q, k, v)), **kw)
    assert out.dtype == tdt
    return out.to(torch.float32).numpy()


TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,t,s,d,block_q,block_k", [
    (1, 2, 128, 128, 64, 512, 1024),   # one block each way
    (2, 2, 128, 128, 32, 64, 64),      # multi-block online softmax
    (1, 2, 64, 160, 32, 64, 64),       # T != S, ragged kv tail
    (1, 1, 96, 96, 64, 32, 64),        # ragged tail, T == S
    (1, 2, 160, 64, 32, 32, 64),       # T > S
    (1, 1, 128, 128, 128, 512, 1024),  # D = 128
])
def test_plain_version_matches_mxtpu_flash(tt, dtype, causal, b, h, t, s,
                                           d, block_q, block_k):
    assert b * h * t * s <= 1 << 22  # the JAX side runs its Pallas kernel
    q, k, v = _qkv(b, h, t, s, d, seed=t + s + d)
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    want = _jax_flash(q, k, v, dtype, **kw)
    got = _port_flash(tt, q, k, v, dtype, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_mxtpu_reference_oracle(tt, causal):
    """Against mxtpu's materialized-softmax oracle ``_reference`` at a
    size past the interpret-mode limit, with a custom sm_scale."""
    torch, _, att = tt
    b, h, t, d = 2, 4, 384, 64
    q, k, v = _qkv(b, h, t, t, d, seed=5)
    import jax.numpy as jnp
    want = np.asarray(jatt._reference(
        jnp.asarray(q.reshape(b * h, t, d)), jnp.asarray(k.reshape(b * h, t, d)),
        jnp.asarray(v.reshape(b * h, t, d)), 0.2, causal)).reshape(q.shape)
    got = att.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, sm_scale=0.2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_op_matches_mxtpu_op(tt):
    """The _contrib_FlashAttention op (attrs as the graph stores them)."""
    torch, mt, _ = tt
    import jax.numpy as jnp
    from mxtpu.ops import registry as jreg
    q, k, v = _qkv(1, 2, 64, 64, 32, seed=9)
    attrs = {"causal": "True", "sm_scale": "0.0", "block_q": "32",
             "block_k": "32"}
    _, _, (want,) = jreg.invoke("_contrib_FlashAttention",
                                [jnp.asarray(x) for x in (q, k, v)], attrs)
    _, parsed, (got,) = mt.ops.registry.invoke(
        "_contrib_FlashAttention", [torch.from_numpy(x) for x in (q, k, v)],
        attrs)
    assert (parsed.block_q, parsed.block_k) == (32, 32)  # recorded
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_tpu_tiling_attrs_do_not_change_the_result(tt):
    torch, _, att = tt
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 96, 96, 32, seed=2))
    a = att.flash_attention(q, k, v, causal=True, block_q=512, block_k=1024)
    b = att.flash_attention(q, k, v, causal=True, block_q=16, block_k=48)
    assert torch.equal(a, b)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing(tt):
    torch, _, att = tt
    before = att.flash_attention.launches
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 32, 32, 32))
    out = att.flash_attention(q, k, v, causal=True)
    ref = att.flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(out, ref)
    assert att.flash_attention.launches == before == 0


def test_meta_tensor_gives_the_output_shape(tt):
    torch, _, att = tt
    q = torch.empty(2, 3, 5, 32, device="meta")
    k = torch.empty(2, 3, 7, 32, device="meta")
    out = att.flash_attention(q, k, k)
    assert out.device.type == "meta" and out.shape == q.shape


@pytest.mark.parametrize("case", ["cpu", "float16", "mixed_dtype",
                                  "non_contiguous", "head_dim_48",
                                  "kv_mismatch", "rank3"])
def test_kernel_input_checks_raise(tt, case):
    """What the CUDA kernel does not take raises before any launch."""
    torch, mt, att = tt
    q = torch.zeros(1, 2, 8, 64)
    k = torch.zeros(1, 2, 8, 64)
    v = torch.zeros(1, 2, 8, 64)
    if case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif case == "non_contiguous":
        q = torch.zeros(1, 8, 2, 64).transpose(1, 2)
    elif case == "head_dim_48":
        q, k, v = (torch.zeros(1, 2, 8, 48) for _ in range(3))
    elif case == "kv_mismatch":
        v = torch.zeros(1, 2, 9, 64)
    elif case == "rank3":
        q = torch.zeros(2, 8, 64)
    with pytest.raises(mt.MXNetError, match="flash_attention kernel"):
        att.check_kernel_inputs(q, k, v)


def test_attention_module_has_no_fallback(tt):
    """No try/except anywhere in the module: on a CUDA tensor the kernel
    runs or the call raises."""
    _, _, att = tt
    tree = ast.parse(inspect.getsource(att))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]

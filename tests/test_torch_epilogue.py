"""mxtpu_torch's BN-apply+ReLU epilogue vs mxtpu's: the port's plain
version (what a CPU tensor runs) against ``mxtpu.ops.epilogue``'s Pallas
kernel in interpret mode on the CPU (as ``tests/test_attention.py`` runs
it) and against its XLA reference, on the same numpy inputs.

Tolerances: against the reference, float32 is exact (atol 0): both
multiply, then add, then ReLU, each rounding once. The interpret-mode
kernel's body is compiled as one XLA loop that contracts ``x*s+b`` into
an FMA, so it differs from both by an ulp; it is held at atol 1e-5.
bfloat16 within 1e-2 (one bf16 ulp at the values used). Both layouts:
channel-minor (M, C) as the TPU kernel takes it, and NCHW (``axis=1``),
which the JAX side runs through a transpose. Also ``fold_bn`` (rtol
1e-6) and the wrapper's dispatch: a CPU tensor launches nothing, a meta
tensor gives an empty result, bad inputs raise, and there is no
fallback."""
import ast
import inspect

import numpy as np
import pytest

from mxtpu.ops import epilogue as jepi


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    from mxtpu_torch.ops import epilogue as epi
    return torch, mxtpu_torch, epi


def _inputs(shape, axis, seed):
    rng = np.random.RandomState(seed)
    c = shape[axis]
    x = (rng.randn(*shape) * 2.0).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    shift = (rng.randn(c) * 0.5).astype(np.float32)
    return x, r, scale, shift


def _jax(fn, x, r, scale, shift, axis, dtype, **kw):
    """mxtpu's (M, C) function on x with channels at ``axis``."""
    import jax.numpy as jnp
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    perm = [d for d in range(x.ndim) if d != axis] + [axis]
    back = np.argsort(perm)
    flat = lambda a: jnp.asarray(a.transpose(perm).reshape(-1, a.shape[axis]),
                                 jdt)
    out = fn(flat(x), jnp.asarray(scale), jnp.asarray(shift),
             flat(r) if r is not None else None, **kw)
    out = np.asarray(out.astype(jnp.float32))
    return out.reshape([x.shape[d] for d in perm]).transpose(back)


def _port(tt, x, r, scale, shift, axis, dtype):
    torch, _, epi = tt
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    out = epi.bn_apply_relu_add(
        torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
        torch.from_numpy(shift),
        torch.from_numpy(r).to(tdt) if r is not None else None, axis=axis)
    assert out.dtype == tdt and tuple(out.shape) == x.shape
    return out.to(torch.float32).numpy()


SHAPES = [((96, 128), 1), ((1000, 72), 1), ((50, 37), 1),
          ((2, 8, 6, 5), 1), ((3, 4, 7, 7), 1)]
SHAPE_IDS = ["mc96x128", "mc1000x72", "mc50x37", "nchw2x8x6x5",
             "nchw3x4x7x7"]
TOL_KERNEL = {"float32": 1e-5, "bfloat16": 1e-2}
TOL_REF = {"float32": 0.0, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape,axis", SHAPES, ids=SHAPE_IDS)
def test_plain_version_matches_mxtpu_kernel_and_reference(tt, dtype, residual,
                                                          shape, axis):
    x, r, scale, shift = _inputs(shape, axis, seed=sum(shape))
    r = r if residual else None
    got = _port(tt, x, r, scale, shift, axis, dtype)
    kern = _jax(jepi.bn_apply_relu_add, x, r, scale, shift, axis, dtype,
                block_m=32, interpret=True)
    ref = _jax(jepi.bn_apply_relu_add_reference, x, r, scale, shift, axis,
               dtype)
    np.testing.assert_allclose(got, kern, rtol=0, atol=TOL_KERNEL[dtype])
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL_REF[dtype])


def test_residual_is_added_after_the_relu(tt):
    torch, _, epi = tt
    x = torch.tensor([[-3.0, 2.0]])
    one = torch.ones(2)
    out = epi.bn_apply_relu_add(x, one, torch.zeros(2), torch.full((1, 2),
                                                                   -1.0))
    assert out.tolist() == [[-1.0, 1.0]]


def test_nan_and_inf_pass_as_through_relu(tt):
    torch, _, epi = tt
    x = torch.tensor([[float("nan"), float("inf"), float("-inf"), 1.0]])
    out = epi.bn_apply_relu_add(x, torch.ones(4), torch.zeros(4))
    assert torch.isnan(out[0, 0]) and out[0, 1] == float("inf")
    assert out[0, 2] == 0.0 and out[0, 3] == 1.0


def test_fold_bn_matches_mxtpu(tt):
    import jax.numpy as jnp
    torch, _, epi = tt
    rng = np.random.RandomState(7)
    g, b, m = (rng.randn(64).astype(np.float32) for _ in range(3))
    v = (rng.rand(64) + 0.1).astype(np.float32)
    want = jepi.fold_bn(*(jnp.asarray(a) for a in (g, b, m, v)), eps=2e-5)
    got = epi.fold_bn(*(torch.from_numpy(a) for a in (g, b, m, v)),
                      eps=2e-5)
    for w, o in zip(want, got):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_block_m_does_not_change_the_result(tt):
    torch, _, epi = tt
    x, _, s, b = _inputs((100, 24), 1, seed=5)
    args = [torch.from_numpy(a) for a in (x, s, b)]
    assert torch.equal(epi.bn_apply_relu_add(*args, block_m=8),
                       epi.bn_apply_relu_add(*args, block_m=4096))


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing(tt):
    torch, _, epi = tt
    before = epi.bn_apply_relu_add.launches
    x, r, s, b = (torch.from_numpy(a) for a in _inputs((8, 16), 1, seed=1))
    out = epi.bn_apply_relu_add(x, s, b, r)
    assert torch.equal(out, epi.bn_apply_relu_add_reference(x, s, b, r))
    assert epi.bn_apply_relu_add.launches == before


def test_meta_tensor_gives_the_output_shape(tt):
    torch, _, epi = tt
    x = torch.empty(4, 8, 3, 3, device="meta", dtype=torch.bfloat16)
    s = torch.empty(8, device="meta")
    out = epi.bn_apply_relu_add(x, s, s, axis=1)
    assert out.device.type == "meta" and out.shape == x.shape
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["float16", "non_contiguous", "scale_f64",
                                  "scale_shape", "residual_dtype",
                                  "residual_shape", "axis", "cpu_tensor"])
def test_kernel_input_checks_raise(tt, case):
    torch, mt, epi = tt
    x = torch.zeros(4, 6)
    s = torch.zeros(6)
    b = torch.zeros(6)
    r = None
    axis = -1
    if case == "float16":
        x = x.half()
    elif case == "non_contiguous":
        x = torch.zeros(6, 4).t()
    elif case == "scale_f64":
        s = s.double()
    elif case == "scale_shape":
        s = torch.zeros(4)
    elif case == "residual_dtype":
        r = torch.zeros(4, 6, dtype=torch.bfloat16)
    elif case == "residual_shape":
        r = torch.zeros(4, 5)
    elif case == "axis":
        axis = 2
    with pytest.raises(mt.MXNetError, match="bn_apply_relu_add kernel"):
        epi.check_kernel_inputs(x, s, b, r, axis)


def test_layout_splits_around_the_channel_axis(tt):
    _, _, epi = tt
    assert epi._layout((401408, 64), -1) == (401408, 64, 1)
    assert epi._layout((32, 64, 112, 112), 1) == (32, 64, 12544)
    assert epi._layout((32, 7, 7, 2048), 3) == (1568, 2048, 1)


def test_epilogue_module_has_no_fallback(tt):
    """No try/except anywhere in the module: on a CUDA tensor the kernel
    runs or the call raises."""
    _, _, epi = tt
    tree = ast.parse(inspect.getsource(epi))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]

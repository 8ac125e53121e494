"""The rest of ``mxtpu/ops/contrib.py`` outside CTC in the port against
mxtpu's: ``_contrib_quantize`` (round half to even, uint8, the range as
two (1,) outputs; at ties and at mn == mx), ``_contrib_dequantize`` (its
gradient into the range through ``max(mx - mn, 1e-8)``),
``_contrib_fft``/``_contrib_ifft`` (re/im interleaved; the inverse not
normalized) and ``_contrib_count_sketch`` (h truncated to int32, -1
counted from the end, 5 and -5 dropped with out_dim 4, duplicates
adding). Forward within 1e-5 and gradients within 1e-4 of the largest
magnitude (at least 1), ``torch.autograd.grad`` against ``jax.vjp``
(``final_op_cases.CONTRIB_CASES``); fft/ifft round trips.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import numpy as np
import pytest

from final_op_cases import CONTRIB_CASES
from final_op_parity import check_forward, check_gradient

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
IDS = ["%s-%d" % (c[0], i) for i, c in enumerate(CONTRIB_CASES)]


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return torch, mxtpu_torch


@pytest.mark.parametrize("name,arrays,attrs,diff,outs", CONTRIB_CASES,
                         ids=IDS)
def test_contrib_op_matches_mxtpu(tt, name, arrays, attrs, diff, outs):
    torch, mt = tt
    check_forward(torch, mt, name, arrays, attrs, FWD_TOL)
    if diff:
        check_gradient(torch, mt, name, arrays, attrs, diff, outs, GRAD_TOL)


def test_quantize_and_count_sketch_pinned(tt):
    torch, mt = tt
    reg = mt.ops.registry
    mn, mx = torch.tensor([0.0]), torch.tensor([255.0])
    _, _, (q, lo, hi) = reg.invoke(
        "_contrib_quantize", [torch.tensor([0.5, 1.5, 2.5, -3.0, 300.0]),
                              mn, mx], {})
    assert q.dtype == torch.uint8 and q.tolist() == [0, 2, 2, 0, 255]
    assert lo.shape == (1,) and hi.shape == (1,)
    _, _, (o,) = reg.invoke(
        "_contrib_count_sketch", [torch.tensor([[1.0, 2.0, 3.0, 4.0]]),
                                  torch.tensor([[-1.0, 5.0, 2.7, -5.0]]),
                                  torch.ones(1, 4)], {"out_dim": 4})
    assert o.tolist() == [[0.0, 0.0, 3.0, 1.0]]


@pytest.mark.parametrize("shape", [(4, 8), (2, 3, 6)])
def test_fft_round_trip(tt, shape):
    """ifft(fft(x)) is n * x (mxtpu's unnormalized inverse), in both
    packages."""
    torch, mt = tt
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    n = shape[-1]
    with mt.cpu():
        got = mt.nd.contrib.ifft(mt.nd.contrib.fft(mt.nd.array(x)))
    want = mxtpu.nd.contrib.ifft(mxtpu.nd.contrib.fft(mxtpu.nd.array(x)))
    np.testing.assert_allclose(got.asnumpy(), n * x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5,
                               atol=1e-5)


import mxtpu  # noqa: E402  (mxtpu's nd namespace for the round trip)


@pytest.mark.parametrize("name,arrays,attrs,diff,outs", CONTRIB_CASES, ids=IDS)
def test_shape_inference_matches_the_op(tt, name, arrays, attrs, diff, outs):
    """Shape inference (the op on meta tensors, as a Symbol's
    infer_shape runs it) gives each output's shape and type."""
    torch, mt = tt
    op = mt.ops.registry.get_op(name)
    a = op.parse_attrs(dict(attrs))
    inferred = op.infer(a, [(x.shape, x.dtype.name) for x in arrays])
    real = op.apply(a, [torch.from_numpy(x.copy()) for x in arrays])
    assert inferred == [(tuple(r.shape), r.dtype) for r in real]

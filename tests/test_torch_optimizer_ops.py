"""The eight update ops of ``mxtpu/ops/optimizer_ops.py`` in the port,
against mxtpu's: each case of ``update_op_cases.py`` through both
packages' op, every output (the new weight, then the new states) within
1e-5 relative (float16 weights within one float16 ulp); and through
``nd.<op>`` with ``out=`` aliasing the weight, which writes the new weight
into it and leaves the states as they were, as mxtpu does.

torch is imported lazily and pinned to one thread."""
import numpy as np
import pytest

import mxtpu
from test_torch_ops_tranche import _jax_run
from update_op_cases import UPDATE_CASES


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return torch, mxtpu_torch


def _tol(ref):
    return 1e-3 if ref.dtype == np.float16 else 1e-5


@pytest.mark.parametrize("name,arrays,attrs", UPDATE_CASES,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(UPDATE_CASES)])
def test_update_op_matches_mxtpu(tt, name, arrays, attrs):
    torch, mt = tt
    ins = [torch.from_numpy(a.copy()) for a in arrays]
    _, _, outs = mt.ops.registry.invoke(name, ins, dict(attrs))
    want = _jax_run(name, arrays, attrs)
    assert len(outs) == len(want)
    for got, ref in zip(outs, want):
        g = got.numpy()
        assert g.dtype == ref.dtype and g.shape == ref.shape
        np.testing.assert_allclose(g.astype(np.float64),
                                   ref.astype(np.float64), rtol=_tol(ref),
                                   atol=_tol(ref))
    for a, x in zip(arrays, ins):  # the inputs are not changed
        np.testing.assert_array_equal(x.numpy(), a)


@pytest.mark.parametrize("name,arrays,attrs", UPDATE_CASES[::2],
                         ids=[c[0] for c in UPDATE_CASES[::2]])
def test_out_aliasing_the_weight(tt, name, arrays, attrs):
    torch, mt = tt

    def run(pkg, ctx):
        xs = [pkg.nd.array(a, ctx=ctx, dtype=a.dtype) for a in arrays]
        res = getattr(pkg.nd, name)(*xs, out=xs[0], **attrs)
        res = res if isinstance(res, (list, tuple)) else [res]
        return [x.asnumpy() for x in xs], [r.asnumpy() for r in res]

    got, got_res = run(mt, mt.cpu())
    want, want_res = run(mxtpu, mxtpu.cpu())
    assert len(got_res) == len(want_res) == 1
    for g, w in zip(got + got_res, want + want_res):
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=_tol(w),
                                   atol=_tol(w))
    for a, g in zip(arrays[1:], got[1:]):  # the states as they were
        np.testing.assert_array_equal(g, a)
    assert not np.array_equal(got[0], arrays[0])


def test_the_update_ops_are_mxtpus_names(tt):
    """The eight names, with mxtpu's arg names and output counts."""
    torch, mt = tt
    from mxtpu.ops import registry as jreg
    names = sorted({c[0] for c in UPDATE_CASES})
    assert len(names) == 8
    for n in names:
        p, j = mt.ops.registry.get_op(n), jreg.get_op(n)
        assert p.arg_names == j.arg_names
        a = p.parse_attrs({"lr": 0.1})
        assert p.n_out(a) == j.n_out(j.parse_attrs({"lr": 0.1}))

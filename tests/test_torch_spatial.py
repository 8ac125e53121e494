"""The 18 op names of ``mxtpu/ops/spatial.py`` in the port, against
mxtpu's: the same numpy inputs (``spatial_cases.py``) through mxtpu's op
(JAX on the CPU, on an empty jit cache) and the port's (PyTorch on the
CPU, the plain versions). Forward: the same dtype, shape and NaN
positions, values within 1e-5 relative; Proposal's image column
exactly and its corners within 1e-6 of the largest (XLA's exp on the CPU
and torch's differ in the last bit of one value in ten, and XLA fuses
the decode's products and sums, so a corner may differ by an ulp of the
box's centre). mxtpu's op runs jitted, as
it always runs: XLA rewrites a division by a constant into a product
with its reciprocal and contracts products and sums into fused
multiply-adds, and the port follows that arithmetic where it moves a
bin's bound.
Gradient: under one random head gradient for each output,
``torch.autograd.grad`` against ``jax.vjp`` of mxtpu's op, within 1e-4
of the largest finite gradient, with infinities and NaNs at the same
places. Then ROIPooling's and Proposal's deciding cases as plain
numbers, and the census.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import numpy as np
import pytest

import mxtpu  # noqa: F401  (registers the JAX ops)
from mxtpu.ops import registry as jreg
from spatial_cases import (CASES, ROI_MANY_TERMS, ROIS, _a, order_bound,
                           ordered_roi_gradient)
from test_torch_ops_tranche import _close, _jax_run

FWD_RTOL = 1e-5
GRAD_TOL = 1e-4
PROPOSAL = ("_contrib_Proposal", "Proposal", "_contrib_MultiProposal",
            "MultiProposal")


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return torch, mxtpu_torch


IDS = ["%s-%d" % (c[0], i) for i, c in enumerate(CASES)]


@pytest.mark.parametrize("name,arrays,attrs,diff", CASES, ids=IDS)
def test_forward_matches_mxtpu(tt, name, arrays, attrs, diff):
    torch, mt = tt
    _, _, outs = mt.ops.registry.invoke(
        name, [torch.from_numpy(a.copy()) for a in arrays], dict(attrs))
    want = _jax_run(name, arrays, attrs)
    assert len(outs) == len(want)
    for k, (got, ref) in enumerate(zip(outs, want)):
        g = got.numpy()
        assert g.dtype == ref.dtype and g.shape == ref.shape
        if name in PROPOSAL and k == 0:
            np.testing.assert_array_equal(g[:, 0], ref[:, 0])
            np.testing.assert_allclose(g, ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max())
        else:
            np.testing.assert_allclose(g.astype(np.float64),
                                       ref.astype(np.float64),
                                       rtol=FWD_RTOL, atol=FWD_RTOL,
                                       equal_nan=True)


@pytest.mark.parametrize("name,arrays,attrs,diff", CASES, ids=IDS)
def test_gradient_matches_mxtpu(tt, name, arrays, attrs, diff):
    import jax
    import jax.numpy as jnp
    torch, mt = tt
    jop = jreg.get_op(name)
    ja = jop.parse_attrs(dict(attrs))

    def jf(*xs):
        full = [jnp.asarray(x) for x in arrays]
        for i, x in zip(diff, xs):
            full[i] = x
        out = jop.fn(ja, *full)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    outs, vjp = jax.vjp(jax.jit(jf),
                        *[jnp.asarray(arrays[i]) for i in diff])
    rng = np.random.RandomState(len(name))
    heads = [np.asarray(rng.randn(*o.shape), np.float32) for o in outs]
    want = [np.asarray(g, np.float32)
            for g in vjp(tuple(jnp.asarray(h) for h in heads))]

    op = mt.ops.registry.get_op(name)
    xs = [torch.from_numpy(a.copy()) for a in arrays]
    for i in diff:
        xs[i].requires_grad_()
    pouts = op.apply(op.parse_attrs(dict(attrs)), xs)
    pairs = [(o, torch.from_numpy(h)) for o, h in zip(pouts, heads)
             if o.requires_grad]
    wrt = [xs[i] for i in diff]
    got = [None] * len(wrt)
    if pairs:
        got = torch.autograd.grad([o for o, _ in pairs],
                                  wrt, [h for _, h in pairs],
                                  allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g for g, x in zip(got, wrt)]
    for k, (g, w) in enumerate(zip(got, want)):
        _close(g.detach().numpy(), w, GRAD_TOL, "input %d" % diff[k])


def _pool(torch, mt, data, rois, pooled, scale, head=None):
    x = torch.tensor(data, requires_grad=True)
    _, _, (y,) = mt.ops.registry.invoke(
        "ROIPooling", [x, torch.tensor(rois)],
        {"pooled_size": pooled, "spatial_scale": scale})
    (g,) = torch.autograd.grad(
        y, [x], torch.ones_like(y) if head is None else torch.tensor(head))
    return y.detach().numpy(), g.numpy()


def test_roi_pooling_ties_split_equally(tt):
    """A 3x3 bin of zeros gives each pixel 1/9 of its head gradient, as
    ``jnp.max``'s gradient does; one maximum takes it whole."""
    torch, mt = tt
    data = np.zeros((1, 1, 3, 3), np.float32)
    y, g = _pool(torch, mt, data, _a([[0, 0, 0, 2, 2]]), (1, 1), 1.0)
    assert y.tolist() == [[[[0.0]]]]
    np.testing.assert_array_equal(g, np.full((1, 1, 3, 3), 1 / 9,
                                             np.float32))
    data[0, 0, 1, 2] = 2.0
    data[0, 0, 2, 0] = 2.0
    y, g = _pool(torch, mt, data, _a([[0, 0, 0, 2, 2]]), (1, 1), 1.0)
    assert y.item() == 2.0
    assert g[0, 0, 1, 2] == g[0, 0, 2, 0] == 0.5 and g.sum() == 1.0


def test_roi_pooling_rounds_half_to_even(tt):
    """Corner 8 at scale 1/16 is 0.5, which rounds to 0 (not 1), and 24
    is 1.5, which rounds to 2; so the ROI [8, 8, 24, 24] covers columns
    and rows 0-2."""
    torch, mt = tt
    data = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    y, g = _pool(torch, mt, data, _a([[0, 8, 8, 24, 24]]), (3, 3), 1 / 16)
    np.testing.assert_array_equal(y[0, 0], data[0, 0, :3, :3])
    assert g[0, 0, :3, :3].sum() == 9 and g[0, 0, 3].sum() == 0


def test_roi_pooling_non_finite_bins(tt):
    """A bin holding +inf gives 0 and no gradient; a bin holding NaN
    gives 0 and NaN gradient over its pixels (0 / 0 in ``jnp.max``'s
    gradient), as mxtpu does; the ROIs get no gradient. A ROI wholly past
    the map's end pools its last row and column (mxtpu clips a bin's
    start to H - 1 and its end to H): both its bins take the pixel (1, 3)
    whole."""
    torch, mt = tt
    data = np.zeros((1, 1, 2, 4), np.float32)
    data[0, 0, 0, 0] = np.nan
    data[0, 0, 0, 2] = np.inf
    rois = torch.tensor(_a([[0, 0, 0, 3, 1], [0, 9, 9, 12, 12]]),
                        requires_grad=True)
    x = torch.tensor(data, requires_grad=True)
    _, _, (y,) = mt.ops.registry.invoke(
        "ROIPooling", [x, rois], {"pooled_size": (1, 2),
                                  "spatial_scale": 1.0})
    gx, gr = torch.autograd.grad(y.sum(), [x, rois], allow_unused=True)
    assert y.detach().numpy().tolist() == [[[[0.0, 0.0]]], [[[0.0, 0.0]]]]
    g = gx.numpy()[0, 0]
    assert np.isnan(g[:, :2]).all() and g[0, 2:].tolist() == [0, 0]
    assert g[1, 2:].tolist() == [0, 2]
    assert gr is None or not gr.any()


def test_roi_pooling_indices_as_xla_converts(tt):
    """The image of a ROI: NaN -> 0, 1.7 -> 1, -3 and 5 clamped, 1e10
    saturated then clamped, as mxtpu's convert and gather take it."""
    torch, mt = tt
    data = np.stack([np.full((1, 2, 2), v, np.float32) for v in (1, 2)])
    rois = _a([[v, 0, 0, 1, 1] for v in (np.nan, 1.7, -3, 5, 1e10, -0.5)])
    y, _ = _pool(torch, mt, data, rois, (1, 1), 1.0)
    assert y.ravel().tolist() == [1.0, 2.0, 1.0, 2.0, 2.0, 1.0]


@pytest.mark.parametrize("k", range(len(ROI_MANY_TERMS)))
def test_roi_pooling_gradient_over_many_terms(tt, k):
    """A pixel in thousands of bins: the port's gradient and mxtpu's
    (``jax.vjp`` of the jitted op) add the same terms as the sum in (ROI,
    ph, pw) order does, each in its own order, so each is within the
    bound on two orders' difference (``order_bound``: float32 epsilon
    times the number and the magnitudes of the terms) of that sum."""
    import jax
    import jax.numpy as jnp
    from mxtpu_torch.ops import spatial
    torch, mt = tt
    (data, rois), attrs = ROI_MANY_TERMS[k]
    pooled, scale = attrs["pooled_size"], attrs["spatial_scale"]
    t_rois = torch.from_numpy(rois)
    N, _, H, W = data.shape
    bins = [b.long().numpy() for b in spatial._roi_bins(
        t_rois, pooled[0], pooled[1], scale, H, W)]
    image = spatial._batch_index(t_rois[:, 0], N).numpy()
    dy = np.random.RandomState(7).randn(
        rois.shape[0], data.shape[1], *pooled).astype(np.float32)
    want, terms, mag = ordered_roi_gradient(data, image, bins, dy)
    assert terms.max() > 1000
    _, got = _pool(torch, mt, data, rois, pooled, scale, head=dy)
    jop = jreg.get_op("ROIPooling")
    ja = jop.parse_attrs(dict(attrs))
    _, vjp = jax.vjp(jax.jit(lambda x: jop.fn(ja, x, jnp.asarray(rois))),
                     jnp.asarray(data))
    (ref,) = vjp(jnp.asarray(dy))
    bound = order_bound(terms, mag)
    for g in (got, np.asarray(ref, np.float32)):
        assert np.all(np.abs(g.astype(np.float64) - want) <= bound)


def test_proposal_pads_by_cycling_the_kept(tt):
    """Fewer boxes kept than ``rpn_post_nms_top_n``: the output repeats
    the kept ones in order, never a suppressed box; with
    ``output_score`` the scores follow them."""
    torch, mt = tt
    from spatial_cases import _PROP_ATTRS, _PROP_BBOX, _PROP_INFO, \
        _PROP_SCORE
    attrs = dict(_PROP_ATTRS, threshold=0.01, rpn_post_nms_top_n=40,
                 output_score=True)
    _, _, (rois, scores) = mt.ops.registry.invoke(
        "_contrib_MultiProposal", [torch.from_numpy(_PROP_SCORE),
                                   torch.from_numpy(_PROP_BBOX),
                                   torch.from_numpy(_PROP_INFO)], attrs)
    rois = rois.numpy().reshape(2, 40, 5)
    scores = scores.numpy().reshape(2, 40)
    for b in range(2):
        assert (rois[b, :, 0] == b).all()
        kept = len(np.unique(rois[b, :, 1:], axis=0))
        assert 1 <= kept < 40
        np.testing.assert_array_equal(rois[b, kept:], np.resize(
            rois[b, :kept], (40 - kept, 5)))
        assert (np.diff(scores[b, :kept]) <= 0).all()


def test_region_ops_chunk_over_rois(tt, monkeypatch):
    """The region ops' plain forms run over chunks of ROIs; one ROI a
    chunk gives the same numbers and gradients."""
    torch, mt = tt
    from spatial_cases import _MAP
    sp = mt.ops.spatial

    def run():
        x = torch.tensor(_MAP, requires_grad=True)
        outs = [mt.ops.registry.invoke(
            name, [x, torch.tensor(ROIS[:6])], attrs)[2][0]
            for name, attrs in (
                ("ROIPooling", {"pooled_size": (3, 3),
                                "spatial_scale": 0.5}),
                ("PSROIPooling", {"pooled_size": 1, "output_dim": 3,
                                  "spatial_scale": 0.5}))]
        g = torch.autograd.grad(sum(o.sum() for o in outs), [x])[0]
        return [o.detach() for o in outs] + [g]

    whole = run()
    monkeypatch.setattr(sp, "_CHUNK_ELEMENTS", 1)
    for a, b in zip(whole, run()):
        assert torch.equal(a, b)


def test_census_of_the_spatial_names(tt):
    """Every name of spatial.py is in the port, with a case above."""
    import inspect
    torch, mt = tt
    names = {n for n in jreg.list_ops()
             if inspect.getmodule(jreg.get_op(n).fn).__name__.endswith(
                 ".spatial")}
    assert len(names) == 18
    assert names <= set(mt.ops.registry.list_ops())
    assert names == {c[0] for c in CASES}

"""The Faster R-CNN (``models/rcnn.py``) against mxtpu's
``examples/rcnn/train_end2end.py``, on the CPU.

- The ``"example"`` configuration: the same data draws as the example's
  ``make_batch``; its training symbol through ``Module`` from mxtpu's
  Xavier weights, 3 Adam steps at B=2, the four outputs (the losses
  among them) and every weight after each step within 1e-4 of mxtpu's
  Module; then the test symbol's rois (within 1e-6 of the largest
  corner: XLA's exp and torch's differ in a last bit), cls_prob and
  bbox_pred from the trained weights.
- The ``"vgg16"`` configuration cut to a narrow width (a few channels, a
  64x96 image, fewer proposals and ROIs, no dropout: the two packages
  draw different masks): built by the port, sent through ``tojson`` into
  mxtpu's ``load_json``, and one training forward and backward of both
  from the same weights, outputs and every gradient within 1e-4.

torch is imported lazily and pinned to one thread."""
import os
import sys

import numpy as np
import pytest

import mxtpu as mx

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "rcnn"))
import train_end2end as ex  # noqa: E402  (registers mxtpu's op)

TOL = 1e-4
N = 2


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    from mxtpu_torch.models import rcnn
    return torch, mxtpu_torch, rcnn


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _mx_batch(arrays):
    x, info, lab, btgt, bwt, gt = arrays
    return mx.io.DataBatch(data=[mx.nd.array(x), mx.nd.array(info)],
                           label=[mx.nd.array(v) for v in
                                  (lab, btgt, bwt, gt)], pad=0, index=None)


def test_example_steps_match_mxtpus_module(tt):
    torch, mt, rcnn = tt
    cfg = rcnn.CONFIGS["example"]
    jm = mx.mod.Module(ex.build_train_symbol(), context=mx.cpu(0),
                       data_names=rcnn.DATA_NAMES,
                       label_names=rcnn.LABEL_NAMES)
    jm.bind(data_shapes=rcnn.data_shapes(cfg, N),
            label_shapes=rcnn.label_shapes(cfg, N))
    mx.random.seed(5)
    np.random.seed(5)
    jm.init_params(mx.initializer.Xavier())
    jm.init_optimizer(optimizer="adam",
                      optimizer_params={"learning_rate": 0.003})
    args, auxs = jm.get_params()

    sym = rcnn.build_train_symbol(cfg)
    assert sorted(sym.list_arguments()) == \
        sorted(ex.build_train_symbol().list_arguments())
    pm = mt.mod.Module(sym, context=mt.cpu(), data_names=rcnn.DATA_NAMES,
                       label_names=rcnn.LABEL_NAMES)
    pm.bind(data_shapes=rcnn.data_shapes(cfg, N),
            label_shapes=rcnn.label_shapes(cfg, N))
    pm.init_params(arg_params=mt.convert.params_from_mxtpu(args, "cpu"),
                   aux_params={})
    pm.init_optimizer(optimizer="adam",
                      optimizer_params={"learning_rate": 0.003})

    rng_j, rng_p = np.random.RandomState(5), np.random.RandomState(5)
    for step in range(3):
        want_in = ex.make_batch(rng_j, N)
        got_in = rcnn.make_batch(rng_p, N, cfg)
        for g, w in zip(got_in, want_in):
            np.testing.assert_array_equal(g, w)
        jm.forward_backward(_mx_batch(want_in))
        jm.update()
        pm.forward_backward(rcnn.batch_of(got_in, mt.cpu()))
        pm.update()
        for k, (g, w) in enumerate(zip(pm.get_outputs(), jm.get_outputs())):
            _close(g.asnumpy(), w.asnumpy(), TOL, "step %d output %d"
                   % (step, k))
        pa, ja = pm.get_params()[0], jm.get_params()[0]
        for name in ja:
            _close(pa[name].asnumpy(), ja[name].asnumpy(), TOL,
                   "step %d %s" % (step, name))

    # the test symbol from the trained weights
    x, info = rcnn.make_batch(np.random.RandomState(77), N, cfg)[:2]
    outs = []
    for pkg, sym_t in ((mt, rcnn.build_test_symbol(cfg)),
                       (mx, ex.build_test_symbol())):
        mod = pkg.mod.Module(sym_t, context=pkg.cpu(),
                             data_names=rcnn.DATA_NAMES, label_names=None)
        mod.bind(data_shapes=rcnn.data_shapes(cfg, N), for_training=False)
        mod.set_params(*(pm if pkg is mt else jm).get_params())
        mod.forward(pkg.io.DataBatch(
            data=[pkg.nd.array(x, ctx=pkg.cpu()),
                  pkg.nd.array(info, ctx=pkg.cpu())], label=[], pad=0,
            index=None), is_train=False)
        outs.append([o.asnumpy() for o in mod.get_outputs()])
    (rois, prob, deltas), (jrois, jprob, jdeltas) = outs
    assert rois.shape == (N * cfg["post_nms_test"], 5)
    np.testing.assert_array_equal(rois[:, 0], jrois[:, 0])
    np.testing.assert_allclose(rois, jrois, rtol=0,
                               atol=1e-6 * np.abs(jrois).max())
    _close(prob, jprob, TOL, "cls_prob")
    _close(deltas, jdeltas, TOL, "bbox_pred")


def _narrow_vgg16(rcnn):
    return dict(rcnn.CONFIGS["vgg16"], widths=(4, 4, 8, 8, 8),
                rpn_conv=8, fc=(16, 16), image=(64, 96), dropout=0.0,
                post_nms_train=64, rois_per_img=16, post_nms_test=32)


def _mxtpu_proposal_target(rcnn):
    """mxtpu's twin of the port's ``proposal_target`` prop (the same
    body), for the JSON graph: the example registers its own, which takes
    no kwargs."""

    class Op(mx.operator.CustomOp):
        __init__ = rcnn.ProposalTarget.__init__
        forward = rcnn.ProposalTarget.forward
        backward = rcnn.ProposalTarget.backward

    class Prop(mx.operator.CustomOpProp):
        def __init__(self, num_classes="3", rois_per_img="8",
                     fg_fraction="0.5"):
            mx.operator.CustomOpProp.__init__(self, need_top_grad=False)
            self.num_classes = int(num_classes)
            self.rois_per_img = int(rois_per_img)
            self.fg_fraction = float(fg_fraction)

        list_arguments = rcnn.ProposalTargetProp.list_arguments
        list_outputs = rcnn.ProposalTargetProp.list_outputs
        infer_shape = rcnn.ProposalTargetProp.infer_shape

        def create_operator(self, ctx, shapes, dtypes):
            return Op(self.num_classes, self.rois_per_img, self.fg_fraction)

    return Prop


def test_narrow_vgg16_graph_crosses_into_mxtpu(tt, monkeypatch):
    torch, mt, rcnn = tt
    cfg = _narrow_vgg16(rcnn)
    assert rcnn.feature_shape(cfg) == (4, 6)
    monkeypatch.setitem(mx.operator._REGISTRY, "proposal_target",
                        _mxtpu_proposal_target(rcnn))
    sym = rcnn.build_train_symbol(cfg)
    jsym = mx.sym.load_json(sym.tojson())
    assert jsym.list_arguments() == sym.list_arguments()
    assert jsym.list_outputs() == sym.list_outputs()
    arrays = rcnn.make_batch(np.random.RandomState(11), N, cfg)
    inputs = dict(zip(rcnn.DATA_NAMES + rcnn.LABEL_NAMES, arrays))
    shapes = dict(rcnn.data_shapes(cfg, N) + rcnn.label_shapes(cfg, N))
    arg_shapes = dict(zip(sym.list_arguments(),
                          sym.infer_shape(**shapes)[0]))
    rng = np.random.RandomState(12)
    weights = {n: (rng.randn(*s) * (0.3 if n.endswith("weight") else 0.05))
               .astype(np.float32)
               for n, s in arg_shapes.items() if n not in inputs}
    grads = {}
    outs = {}
    for pkg, s in ((mt, sym), (mx, jsym)):
        ex_ = s.simple_bind(pkg.cpu(), grad_req={n: "write"
                                                 for n in weights},
                            **shapes)
        for n, v in dict(weights, **inputs).items():
            ex_.arg_dict[n][:] = pkg.nd.array(v, ctx=pkg.cpu())
        outs[pkg] = [o.asnumpy() for o in ex_.forward(is_train=True)]
        ex_.backward()
        grads[pkg] = {n: ex_.grad_dict[n].asnumpy() for n in weights}
    for k, (g, w) in enumerate(zip(outs[mt], outs[mx])):
        _close(g, w, TOL, "output %d" % k)
    for n in weights:
        _close(grads[mt][n], grads[mx][n], TOL, n)
    assert np.abs(grads[mt]["conv1_1_weight"]).max() > 0
    assert rcnn.fixed_params(cfg, sym) == [
        "conv1_1_weight", "conv1_1_bias", "conv1_2_weight", "conv1_2_bias",
        "conv2_1_weight", "conv2_1_bias", "conv2_2_weight", "conv2_2_bias"]


def test_the_vgg16_configuration(tt):
    """The reference's widths, as symbol_vgg.py and config.py give them:
    20,646 anchors an image at 600x1000, ROIPooling 7x7 at 1/16 from
    conv5_3 (37x62), 21 classes, fc6/fc7 of 4096."""
    torch, mt, rcnn = tt
    cfg = rcnn.CONFIGS["vgg16"]
    assert rcnn.feature_shape(cfg) == (37, 62)
    assert rcnn.all_anchors(cfg).shape == (20646, 4)
    sym = rcnn.build_train_symbol(cfg)
    shapes = dict(rcnn.data_shapes(cfg, 2) + rcnn.label_shapes(cfg, 2))
    args, outs, _ = sym.infer_shape(**shapes)
    by = dict(zip(sym.list_arguments(), args))
    assert by["conv5_3_weight"] == (512, 512, 3, 3)
    assert by["rpn_conv_3x3_weight"] == (512, 512, 3, 3)
    assert by["fc6_weight"] == (4096, 512 * 49)
    assert by["cls_score_weight"] == (21, 4096)
    assert by["bbox_pred_weight"] == (84, 4096)
    assert outs == [(2, 2, 20646), (), (256, 21), ()]
    test = rcnn.build_test_symbol(cfg)
    _, touts, _ = test.infer_shape(**dict(rcnn.data_shapes(cfg, 2)))
    assert touts == [(600, 5), (600, 21), (600, 84)]

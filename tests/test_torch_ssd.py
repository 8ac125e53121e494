"""The SSD detector (BASELINE config 5) in the port against mxtpu's, on
the CPU, from the same numpy inputs (mxtpu on ``JAX_PLATFORMS=cpu``).

- ``MultiBoxPrior`` bit for bit over sizes, ratios, steps, offsets and
  clip.
- ``MultiBoxTarget``: ``cls_target`` and ``loc_target_mask`` exactly,
  ``loc_target`` within 1e-6 relative (of max(1, |x|)), with several
  boxes, padding rows, two boxes on one best anchor, negative mining
  with ``minimum_negative_samples``, and no mining (ratio -1).
- ``MultiBoxDetection``: the class column (and so the keep decisions)
  exactly, boxes and scores within 1e-6, with ``nms_topk`` -1 and 400,
  ``force_suppress``, ``clip``, every candidate under the threshold.
- The plain suppression sweep against mxtpu's ``_nms_scan``, on random
  and adversarial candidate sets and at K = 2,500, past the 1,756 the
  first kernel took; ``MultiBoxDetection`` at its default ``nms_topk``
  -1 on 2,500 anchors. The kernel's launch plan (grids, scratch) at K =
  1 to 24,564 against hand-worked sizes, and its algorithm, emulated in
  numpy with the words it never writes as random bits, against the plain
  sweep.
- ``MakeLoss`` (null, batch, valid) and ``smooth_l1`` gradients against
  ``jax.vjp`` of mxtpu's ops.
- The ``tiny`` train symbol's forward outputs and gradients against
  mxtpu's executor from the same weights (1e-5), after ``cls_target``
  is held equal and the hard-negative margin (the last kept negative's
  score over the first dropped one's) is shown to exceed the tolerance,
  so a near-tie swap cannot pass or fail silently. The detection output
  is held through the heads (the detection op of each package on the
  port's own ``cls_prob``, ``loc_preds`` and anchors): an untrained net
  scores every anchor within ulps of its neighbours, so the top-400 cut
  of two packages differs at the ulp level by nature.
- 3 steps of ``Module.fit`` (SGD, momentum 0.9, wd 5e-4, as
  examples/ssd/train.py) against mxtpu's: ``cls_target`` at each step
  exactly, the weights within 1e-5, the MultiBox metric within 1e-5.
- A port checkpoint of the tiny SSD loading into mxtpu's Module: its
  heads within 1e-5 and its detections equal through the same ops.
- ``models.ssd_data`` against examples/ssd's ``_synth``, ``train`` and
  ``evaluate`` helpers; meta shape inference of the three ops; an
  inference Module bound with the training labels, as evaluate.py binds
  it.
- A ``slow`` twin of ``tests/test_examples_gate.py::test_ssd_gate``.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import logging
import os
import sys

import numpy as np
import pytest

import mxtpu as mx
from mxtpu.models import ssd as jssd
from mxtpu.ops import contrib as jcontrib
from mxtpu.ops import registry as jreg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOC_RTOL = 1e-6
STEP_TOL = 1e-5
# the hard-negative margin must exceed this: far above the ulps by which
# the two packages' logits differ (~1e-7 here)
MARGIN_TOL = 1e-4
TINY = dict(num_classes=3, num_scales=3, network="tiny")
SHAPE = (3, 64, 64)


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _quiet():
    log = logging.getLogger("quiet")
    log.setLevel(logging.ERROR)
    return log


def _both(mt, name, arrays, attrs):
    """(mxtpu's outputs, the port's) of op ``name`` on the same arrays;
    mxtpu's op on an empty jit cache (ROADMAP C)."""
    import jax.numpy as jnp
    import torch
    op = jreg.get_op(name)
    saved, op._jit_cache = op._jit_cache, {}
    try:
        _, _, jo = jreg.invoke(name, [jnp.asarray(a) for a in arrays],
                               dict(attrs))
    finally:
        op._jit_cache = saved
    _, _, to = mt.ops.registry.invoke(
        name, [torch.from_numpy(np.array(a)) for a in arrays], dict(attrs))
    return [np.asarray(o) for o in jo], [o.numpy() for o in to]


def _boxes(rng, n, lo=0.02, hi=0.45):
    """n corner boxes (n, 4) inside the unit square."""
    c = rng.uniform(0.1, 0.9, (n, 2))
    half = rng.uniform(lo, hi, (n, 2)) / 2
    return np.concatenate([c - half, c + half], 1).astype(np.float32)


# ------------------------------------------------------------ MultiBoxPrior
PRIOR_CASES = [
    ((1, 2, 5, 7), dict(sizes=(0.2, 0.272), ratios=(1, 2, 0.5))),
    ((2, 3, 19, 19), dict(sizes=(0.1, 0.141), ratios=(1, 2, 0.5, 3,
                                                       1.0 / 3))),
    ((1, 1, 3, 3), dict(sizes=(0.88, 0.961), ratios=(1, 2, 0.5),
                        clip=True)),
    ((1, 1, 4, 6), dict(sizes=(0.3, 0.5), ratios=(1,), steps=(0.1, 0.2),
                        offsets=(0.3, 0.7))),
    ((1, 1, 38, 38), dict(sizes=(0.1,), ratios=(1, 2), steps=(-1, 0.05),
                          offsets=(0.0, 1.0), clip=True)),
]


@pytest.mark.parametrize("shape,attrs", PRIOR_CASES)
def test_multibox_prior_is_mxtpus_bit_for_bit(mt, shape, attrs):
    data = np.zeros(shape, np.float32)
    (want,), (got,) = _both(mt, "_contrib_MultiBoxPrior", [data], attrs)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


# ------------------------------------------------------------ MultiBoxTarget
def _target_case(kind, seed=0, A=120, B=3, G=4, C=4):
    rng = np.random.RandomState(seed)
    anchors = _boxes(rng, A)[None]
    label = np.full((B, G, 5), -1.0, np.float32)
    for b in range(B):
        for g in range(b + 1):  # 1..B boxes, the rest padding rows
            i = rng.randint(A)
            label[b, g, 1:] = anchors[0, i] + rng.randn(4) * 0.02
            label[b, g, 0] = rng.randint(C)
    if kind == "same_best_anchor":  # two boxes claim one anchor
        label[:, 1] = label[:, 0]
        label[:, 1, 0] = (label[:, 0, 0] + 1) % C
        label[:, 1, 1:] += 0.001
    cls_pred = rng.randn(B, C + 1, A).astype(np.float32)
    attrs = {"none": {}, "same_best_anchor": {},
             "mining": dict(negative_mining_ratio=3.0),
             "mining_min": dict(negative_mining_ratio=3.0,
                                minimum_negative_samples=20,
                                negative_mining_thresh=0.4,
                                overlap_threshold=0.4),
             "ratio_neg1": dict(negative_mining_ratio=-1.0,
                                ignore_label=-2.0)}[kind]
    return [anchors, label.astype(np.float32), cls_pred], attrs


@pytest.mark.parametrize("kind", ["none", "same_best_anchor", "mining",
                                  "mining_min", "ratio_neg1"])
def test_multibox_target_matches_mxtpu(mt, kind):
    arrays, attrs = _target_case(kind)
    want, got = _both(mt, "_contrib_MultiBoxTarget", arrays, attrs)
    loc_t, loc_m, cls_t = got
    assert np.array_equal(cls_t, want[2])
    assert np.array_equal(loc_m, want[1])
    np.testing.assert_allclose(loc_t, want[0], rtol=0,
                               atol=LOC_RTOL * max(1.0, np.abs(want[0]).max()))
    assert (cls_t > 0).any()  # positives matched
    if "mining" in kind:
        assert (cls_t == -1).any() and (cls_t == 0).any()


# --------------------------------------------------------- MultiBoxDetection
def _detection_case(seed=1, A=600, B=2, C=4, scale=3.0):
    rng = np.random.RandomState(seed)
    anchors = _boxes(rng, A)[None]
    logits = rng.randn(B, C + 1, A) * scale
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rng.randn(B, A * 4) * 0.5).astype(np.float32)
    return [prob.astype(np.float32), loc, anchors]


DET_CASES = [
    {}, dict(nms_topk=400), dict(nms_topk=400, force_suppress=True),
    dict(clip=False, nms_threshold=0.3), dict(threshold=0.995),
    dict(threshold=1.5, nms_topk=50),  # every candidate under threshold
]


@pytest.mark.parametrize("attrs", DET_CASES)
def test_multibox_detection_matches_mxtpu(mt, attrs):
    arrays = _detection_case()
    (want,), (got,) = _both(mt, "_contrib_MultiBoxDetection", arrays, attrs)
    assert got.shape == want.shape
    assert np.array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0,
                               atol=1e-6)
    if attrs.get("threshold", 0) > 1:
        assert (got[..., 0] == -1).all()
    else:
        assert (got[..., 0] >= 0).sum() > 0


def _nms_sets():
    """(boxes, scores, class ids, thresh, force) candidate sets: random;
    one class with every box overlapping; IoUs exactly at the threshold;
    -inf tails; force_suppress across classes."""
    rng = np.random.RandomState(3)
    K = 64
    out = []
    b = _boxes(rng, K)
    s = np.sort(rng.rand(K).astype(np.float32))[::-1].copy()
    c = rng.randint(0, 3, K).astype(np.float32)
    out.append((b, s, c, 0.5, False))
    stack = np.tile([[0.2, 0.2, 0.6, 0.6]], (K, 1)).astype(np.float32)
    stack += rng.rand(K, 4).astype(np.float32) * 0.05
    out.append((stack, s, np.zeros(K, np.float32), 0.5, False))
    # [0, 0, 1, 1] against [0, 0, 1, h]: IoU exactly h (h dyadic)
    at = np.tile([[0.0, 0.0, 1.0, 1.0]], (K, 1)).astype(np.float32)
    at[1::2, 3] = 0.5
    out.append((at, s, np.zeros(K, np.float32), 0.5, False))
    tail = s.copy()
    tail[40:] = -np.inf
    out.append((b, tail, c, 0.3, False))
    out.append((b, s, c, 0.2, True))
    return out


@pytest.mark.parametrize("case", range(5))
def test_plain_sweep_matches_mxtpus_nms_scan(mt, case):
    import jax.numpy as jnp
    import torch
    from mxtpu_torch.ops import contrib
    boxes, scores, cls, thresh, force = _nms_sets()[case]
    want = np.asarray(jcontrib._nms_scan(jnp.asarray(boxes),
                                         jnp.asarray(scores),
                                         jnp.asarray(cls), thresh, force))
    got = contrib.nms_keep(torch.from_numpy(boxes)[None],
                           torch.from_numpy(scores)[None],
                           torch.from_numpy(cls)[None], thresh, force)[0]
    assert np.array_equal(got.numpy(), want)
    assert contrib.nms_keep.launches == 0  # CPU: the plain version


# (K, batch) -> (tiles, pairs, scratch bytes): ceil(K / 64) tiles; the
# upper triangle's tiles(tiles + 1) / 2 matrix blocks an image; the
# matrix of 8-byte words, batch x tiles x K
NMS_PLANS = [
    ((1, 32), (1, 1, 8 * 32 * 1 * 1)),
    ((37, 32), (1, 1, 8 * 32 * 1 * 37)),
    ((400, 32), (7, 28, 716800)),            # 896 blocks, 0.7 MB
    ((1376, 8), (22, 253, 8 * 8 * 22 * 1376)),
    ((7486, 32), (117, 6903, 224220672)),    # SSD300 at nms_topk=-1
    ((24564, 1), (384, 73920, 75460608)),    # SSD512's anchors
]


@pytest.mark.parametrize("kb,want", NMS_PLANS,
                         ids=["K%d" % kb[0] for kb, _ in NMS_PLANS])
def test_nms_plan_sizes_grids_and_scratch(mt, kb, want):
    from mxtpu_torch.ops import contrib
    k, batch = kb
    plan = contrib.nms_plan(batch, k)
    tiles, pairs, scratch = want
    assert (plan["tiles"], plan["pairs"], plan["scratch_bytes"]) == want
    assert plan["scratch_shape"] == (batch, tiles, k)
    assert plan["matrix_blocks"] == pairs * batch
    assert plan["matrix_threads"] == 64
    assert plan["image_blocks"] == batch
    assert (plan["sweep_blocks"], plan["sweep_threads"]) == (batch, 1024)
    assert plan["sweep_smem"] == 8 * tiles  # 936 bytes at K = 7,486
    assert plan["sweep_smem"] <= 48 * 1024


def test_nms_plan_loops_images_past_the_grids_y_extent(mt):
    from mxtpu_torch.ops import contrib
    plan = contrib.nms_plan(70000, 400)
    assert plan["image_blocks"] == 65535
    assert plan["sweep_blocks"] == 70000


def _big_nms_set(k=2500, seed=5):
    """K = 2,500 candidates past the old kernel's 1,756: random boxes of
    3 classes, scores sorted, -inf from 2,200 on and for one whole tile
    (64-127)."""
    rng = np.random.RandomState(seed)
    s = np.sort(rng.rand(k).astype(np.float32))[::-1].copy()
    s[64:128] = -np.inf
    s[2200:] = -np.inf
    return (_boxes(rng, k), s, rng.randint(0, 3, k).astype(np.float32), 0.5,
            False)


def test_plain_sweep_matches_mxtpus_nms_scan_past_the_old_limit(mt):
    import jax.numpy as jnp
    import torch
    from mxtpu_torch.ops import contrib
    boxes, scores, cls, thresh, force = _big_nms_set()
    want = np.asarray(jcontrib._nms_scan(jnp.asarray(boxes),
                                         jnp.asarray(scores),
                                         jnp.asarray(cls), thresh, force))
    got = contrib.nms_keep(torch.from_numpy(boxes)[None],
                           torch.from_numpy(scores)[None],
                           torch.from_numpy(cls)[None], thresh, force)[0]
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.sum() < 2200


def test_multibox_detection_at_its_default_topk_past_the_old_limit(mt):
    """nms_topk=-1 (the op's default) on 2,500 anchors at B=2: every
    candidate goes to the sweep."""
    arrays = _detection_case(seed=4, A=2500, B=2)
    (want,), (got,) = _both(mt, "_contrib_MultiBoxDetection", arrays, {})
    assert got.shape == want.shape == (2, 2500, 6)
    assert np.array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0,
                               atol=1e-6)
    assert (got[..., 0] >= 0).sum() > 0


def _kernel_algorithm(boxes, scores, cls, thresh, force, rng):
    """``csrc/multibox_nms.cu``'s algorithm on one image, in numpy: the
    64 x 64 tiles of the upper triangle write their rows' words except
    where the tile's rows or columns are all dead, every other word is
    random (the scratch is never cleared); the sweep starts from the dead
    candidates removed, resolves each chunk up to the last live one as
    the fixed point of kept = alive & ~(OR of the kept rows' diagonal
    words), and ORs the kept rows' words into the later chunks' removed
    words that are not all removed yet."""
    import torch
    from mxtpu_torch.ops import contrib
    k = len(scores)
    tiles = contrib.nms_plan(1, k)["tiles"]
    b = torch.from_numpy(boxes)
    iou = contrib._box_iou_corner(b, b).numpy()
    same = (cls[:, None] == cls[None, :]) | force
    bits = np.zeros((k, tiles * 64), bool)
    bits[:, :k] = (iou > thresh) & same & np.triu(np.ones((k, k), bool), 1)
    words = np.packbits(bits.reshape(k, tiles, 64), axis=-1,
                        bitorder="little").view("<u8")[..., 0]  # (k, tiles)
    live = np.zeros(tiles * 64, bool)
    with np.errstate(invalid="ignore"):
        live[:k] = scores > -np.inf
    live_tile = live.reshape(tiles, 64).any(axis=1)
    mask = rng.randint(0, 2 ** 63, (tiles, k), dtype=np.int64).view("u8")
    for r in range(tiles):
        for c in range(r, tiles):
            if live_tile[r] and live_tile[c]:
                rows = slice(64 * r, min(64 * r + 64, k))
                mask[c, rows] = words[rows, c]
    full = (1 << 64) - 1
    removed = [full ^ int(w) for w in np.packbits(
        live.reshape(tiles, 64), axis=-1, bitorder="little").view("<u8")[:, 0]]
    chunks = int(np.flatnonzero(live_tile)[-1]) + 1 if live_tile.any() else 0
    for c in range(chunks):
        alive = full ^ removed[c]
        kept, prev = alive, None
        while kept != prev:  # the fixed point of the chunk's keep set
            prev = kept
            clear = 0
            for t in range(min(64, k - 64 * c)):
                if kept >> t & 1:
                    clear |= int(mask[c, 64 * c + t])
            kept = alive & (full ^ clear)
        removed[c] = full ^ kept
        for w in range(c + 1, chunks):
            if removed[w] != full:
                for t in range(64):
                    if kept >> t & 1:
                        removed[w] |= int(mask[w, 64 * c + t])
    return np.array([not (removed[i >> 6] >> (i & 63)) & 1 for i in range(k)])


def _algorithm_sets():
    from mxtpu_torch.models import ssd_data
    sets = [(n, b[0], s[0], c[0], t, f)
            for n, b, s, c, t, f in ssd_data.nms_sets(batch=1, seed=4)]
    return sets + [("k2500", *_big_nms_set())]


@pytest.mark.parametrize("case", range(11))
def test_kernel_algorithm_equals_the_plain_version(mt, case):
    """The kernel's design, emulated, keeps what the plain sweep keeps on
    every set of ``ssd_data.nms_sets`` and at K = 2,500, with the words
    it never writes as random bits."""
    import torch
    from mxtpu_torch.ops import contrib
    name, boxes, scores, cls, thresh, force = _algorithm_sets()[case]
    want = contrib.nms_keep_reference(
        *(torch.from_numpy(np.ascontiguousarray(x))[None]
          for x in (boxes, scores, cls)), thresh, force)[0].numpy()
    got = _kernel_algorithm(boxes, scores, cls, thresh, force,
                            np.random.RandomState(case))
    assert np.array_equal(got, want), name


# ------------------------------------------------------- MakeLoss, smooth_l1
def _vjp_pair(mt, name, x, attrs, head):
    import jax
    import jax.numpy as jnp
    import torch
    jop = jreg.get_op(name)
    ja = jop.parse_attrs(dict(attrs))
    _, vjp = jax.vjp(lambda v: jop.fn(ja, v), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(head))[0])
    op = mt.ops.registry.get_op(name)
    t = torch.from_numpy(x.copy()).requires_grad_()
    out = op.apply(op.parse_attrs(dict(attrs)), [t])[0]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        jop.fn(ja, jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    got = torch.autograd.grad(out, t, torch.from_numpy(head))[0].numpy()
    return got, want


@pytest.mark.parametrize("attrs", [
    {}, dict(grad_scale=2.5), dict(normalization="batch"),
    dict(normalization="valid", grad_scale=1.0),
    dict(normalization="valid", grad_scale=0.0)])
def test_make_loss_gradient_matches_jax_vjp(mt, attrs):
    rng = np.random.RandomState(4)
    x = rng.randn(6, 7).astype(np.float32)
    head = rng.randn(6, 7).astype(np.float32)  # ignored by the loss head
    got, want = _vjp_pair(mt, "MakeLoss", x, attrs, head)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name,attrs", [
    ("smooth_l1", {}), ("smooth_l1", dict(scalar=3.0)),
    ("smooth_l1", dict(scalar=0.5)), ("make_loss", {})])
def test_smooth_l1_and_make_loss_gradients_match_jax_vjp(mt, name, attrs):
    rng = np.random.RandomState(5)
    x = (rng.randn(5, 8) * 2).astype(np.float32)
    head = rng.randn(5, 8).astype(np.float32)
    got, want = _vjp_pair(mt, name, x, attrs, head)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,arrays,attrs", [
    ("_contrib_MultiBoxPrior", [np.zeros((2, 3, 5, 7), np.float32)],
     dict(sizes=(0.2, 0.3), ratios=(1, 2, 0.5))),
    ("_contrib_MultiBoxTarget", _target_case("mining")[0],
     dict(negative_mining_ratio=3.0)),
    ("_contrib_MultiBoxDetection", _detection_case(), dict(nms_topk=400)),
    ("MakeLoss", [np.zeros((3, 4), np.float32)], {}),
    ("smooth_l1", [np.zeros((3, 4), np.float32)], {}),
])
def test_meta_shape_inference_matches_mxtpu(mt, name, arrays, attrs):
    import torch
    op = mt.ops.registry.get_op(name)
    got = op.infer(op.parse_attrs(dict(attrs)),
                   [(a.shape, torch.float32) for a in arrays])
    jop = jreg.get_op(name)
    want = jop.infer(jop.parse_attrs(dict(attrs)),
                     [(a.shape, np.float32) for a in arrays])
    assert [s for s, _ in got] == [tuple(s) for s, _ in want]


# -------------------------------------------------------------- the model
def _heads(pkg, ssd):
    """A group of the train symbol's heads (loc_preds, cls_preds,
    anchors), built from the model module's own pieces, so the same
    parameter names bind to it."""
    data = pkg.sym.Variable("data")
    layers = ssd._build_features(data, TINY["num_scales"], TINY["network"])
    sizes, ratios = ssd.default_spec(TINY["num_scales"])
    return pkg.sym.Group(list(ssd._multibox_layer(
        layers, TINY["num_classes"], sizes, ratios)))


def _bound(pkg, sym, ctx, batch, w, for_training=True):
    mod = pkg.mod.Module(sym, label_names=("label",) if for_training
                         else None, context=ctx, logger=_quiet())
    mod.bind(data_shapes=[("data", (batch,) + SHAPE)],
             label_shapes=[("label", (batch, 8, 5))] if for_training
             else None, for_training=for_training)
    mod.init_params(arg_params=w, allow_missing=not for_training)
    return mod


def _mx_weights(seed=2, batch=2):
    sym = jssd.get_symbol_train(**TINY)
    mod = mx.mod.Module(sym, label_names=("label",), context=mx.cpu(),
                        logger=_quiet())
    mod.bind(data_shapes=[("data", (batch,) + SHAPE)],
             label_shapes=[("label", (batch, 8, 5))])
    mx.random.seed(seed)
    np.random.seed(seed)
    mod.init_params(mx.initializer.Xavier())
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _port_heads(mt, w, x):
    mod = _bound(mt, _heads(mt, mt.models.ssd), mt.cpu(), x.shape[0],
                 mt.convert.params_from_mxtpu(w, "cpu"), for_training=False)
    mod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())], None),
                is_train=False)
    return [o.asnumpy() for o in mod.get_outputs()]


def test_tiny_train_step_matches_mxtpu(mt):
    import torch
    from mxtpu_torch.models import ssd_data
    B = 2
    w = _mx_weights(batch=B)
    x, lab = ssd_data.make_batch(np.random.RandomState(0), B, SHAPE, 3)
    jmod = _bound(mx, jssd.get_symbol_train(**TINY), mx.cpu(), B,
                  {k: mx.nd.array(v) for k, v in w.items()})
    jmod.forward(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(lab)]),
                 is_train=True)
    jmod.backward()
    tmod = _bound(mt, mt.models.ssd.get_symbol_train(**TINY), mt.cpu(), B,
                  mt.convert.params_from_mxtpu(w, "cpu"))
    tmod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                 [mt.nd.array(lab, ctx=mt.cpu())]),
                 is_train=True)
    tmod.backward()
    jout = [o.asnumpy() for o in jmod.get_outputs()]
    tout = [o.asnumpy() for o in tmod.get_outputs()]

    # the targets first: equal, and no hard negative within reach of a
    # swap: a near-tie would part the two packages for no fault of either
    loc_preds, cls_preds, anchors = _port_heads(mt, w, x)
    assert np.array_equal(tout[2], jout[2]), \
        "%d anchors differ" % (tout[2] != jout[2]).sum()
    margin = ssd_data.mining_margin(
        torch.from_numpy(anchors), torch.from_numpy(lab),
        torch.from_numpy(cls_preds), torch.from_numpy(tout[2]))
    assert margin > MARGIN_TOL, margin
    for i in (0, 1):
        np.testing.assert_allclose(tout[i], jout[i], rtol=0, atol=STEP_TOL)
    # the detections through the same ops on the port's heads: the port's
    # graph, the port's op, mxtpu's op
    det_attrs = dict(nms_threshold=0.5, force_suppress=False,
                     variances=(0.1, 0.1, 0.2, 0.2), nms_topk=400)
    (jdet,), (tdet,) = _both(mt, "_contrib_MultiBoxDetection",
                             [tout[0], loc_preds, anchors], det_attrs)
    assert np.array_equal(tout[3], tdet)
    assert np.array_equal(tdet[..., 0], jdet[..., 0])
    np.testing.assert_allclose(tdet, jdet, rtol=0, atol=1e-6)

    jg = {k: v.asnumpy() for k, v in
          jmod._exec_group.execs[0].grad_dict.items()}
    tg = {k: v.asnumpy() for k, v in
          tmod._exec_group.execs[0].grad_dict.items()}
    assert sorted(jg) == sorted(tg) == sorted(w)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=0, atol=STEP_TOL,
                                   err_msg=k)
    assert any(np.abs(g).max() > 1e-3 for g in tg.values())


def _cls_targets():
    seen = []

    def cb(param):
        mod = param.locals["self"]
        seen.append(mod.get_outputs()[2].asnumpy().copy())
    return seen, cb


def test_fit_three_steps_matches_mxtpu(mt):
    from mxtpu_torch.models import ssd_data
    sys.path.insert(0, os.path.join(ROOT, "examples", "ssd"))
    import _synth
    import train as ssd_train
    B = 4
    w = _mx_weights(seed=5, batch=B)
    kw = dict(num_epoch=1, optimizer="sgd",
              optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                                "wd": 5e-4})
    jseen, jcb = _cls_targets()
    jmod = mx.mod.Module(jssd.get_symbol_train(**TINY), label_names=(
        "label",), context=mx.cpu(), logger=_quiet())
    jmetric = ssd_train.MultiBoxMetric()
    jmod.fit(_synth.SynthDetIter(B, SHAPE, 3, num_batches=3, seed=0),
             arg_params={k: mx.nd.array(v) for k, v in w.items()},
             eval_metric=jmetric, batch_end_callback=jcb, **kw)
    tseen, tcb = _cls_targets()
    tmod = mt.mod.Module(mt.models.ssd.get_symbol_train(**TINY),
                         label_names=("label",), context=mt.cpu(),
                         logger=_quiet())
    tmetric = ssd_data.MultiBoxMetric()
    tmod.fit(ssd_data.SynthDetIter(B, SHAPE, 3, num_batches=3, seed=0),
             arg_params=mt.convert.params_from_mxtpu(w, "cpu"),
             eval_metric=tmetric, batch_end_callback=tcb, **kw)
    assert tmod._fused is not None  # fit ran the fused step
    assert len(tseen) == len(jseen) == 3
    for step, (a, b) in enumerate(zip(tseen, jseen)):
        assert np.array_equal(a, b), "step %d: %d anchors differ" % (
            step, (a != b).sum())
    jw = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    tw = {k: v.asnumpy() for k, v in tmod.get_params()[0].items()}
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=STEP_TOL,
                                   err_msg=k)
    assert any(not np.array_equal(tw[k], w[k]) for k in w)  # it trained
    for (n1, v1), (n2, v2) in zip(tmetric.get_name_value(),
                                  jmetric.get_name_value()):
        assert n1 == n2 and abs(v1 - v2) <= STEP_TOL * max(1.0, abs(v2))


def test_port_checkpoint_loads_into_mxtpu(mt, tmp_path):
    """A port checkpoint (after a step of the port's fit) into mxtpu's
    Module: the same heads within 1e-5, and the same detections through
    each package's detection op on the port's heads."""
    from mxtpu_torch.models import ssd_data
    B = 2
    w = _mx_weights(seed=6, batch=B)
    prefix = str(tmp_path / "ssd")
    tmod = mt.mod.Module(mt.models.ssd.get_symbol_train(**TINY),
                         label_names=("label",), context=mt.cpu(),
                         logger=_quiet())
    tmod.fit(ssd_data.SynthDetIter(B, SHAPE, 3, num_batches=1, seed=1),
             arg_params=mt.convert.params_from_mxtpu(w, "cpu"),
             num_epoch=1, eval_metric=ssd_data.MultiBoxMetric(),
             optimizer="sgd",
             optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
             epoch_end_callback=mt.callback.do_checkpoint(prefix))
    _, args, aux = mx.model.load_checkpoint(prefix, 1)
    x, _ = ssd_data.make_batch(np.random.RandomState(9), B, SHAPE, 3)
    jheads = _bound(mx, _heads(mx, jssd), mx.cpu(), B, args,
                    for_training=False)
    jheads.forward(mx.io.DataBatch([mx.nd.array(x)], None), is_train=False)
    trained = {k: v.asnumpy() for k, v in tmod.get_params()[0].items()}
    theads = _port_heads(mt, trained, x)
    for a, b in zip(theads, [o.asnumpy() for o in jheads.get_outputs()]):
        np.testing.assert_allclose(a, b, rtol=0, atol=STEP_TOL)
    loc_preds, cls_preds, anchors = theads
    e = np.exp(cls_preds - cls_preds.max(1, keepdims=True))
    prob = (e / e.sum(1, keepdims=True)).astype(np.float32)
    (jdet,), (tdet,) = _both(mt, "_contrib_MultiBoxDetection",
                             [prob, loc_preds, anchors], dict(nms_topk=400))
    assert np.array_equal(tdet[..., 0], jdet[..., 0])
    np.testing.assert_allclose(tdet, jdet, rtol=0, atol=1e-6)
    # and the port's inference symbol from the same file
    _, targs, _ = mt.model.load_checkpoint(prefix, 1)
    tinf = _bound(mt, mt.models.ssd.get_symbol(**TINY), mt.cpu(), B,
                  targs, for_training=False)
    tinf.forward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())], None),
                 is_train=False)
    det = tinf.get_outputs()[0].asnumpy()
    assert det.shape == (B, anchors.shape[1], 6) and np.isfinite(det).all()


def test_inference_module_takes_the_training_labels(mt):
    """examples/ssd/evaluate.py binds ``get_symbol``, which takes no
    label, with ``label_names=("label",)`` and the iterator's label
    shapes: mxtpu's Module drops the label it does not take, and so does
    the port's."""
    from mxtpu_torch.models import ssd_data
    B = 2
    w = _mx_weights(seed=7, batch=B)
    x, lab = ssd_data.make_batch(np.random.RandomState(3), B, SHAPE, 3)
    dets = []
    for pkg, sym, ctx, arr in (
            (mx, jssd.get_symbol(**TINY), mx.cpu(), mx.nd.array),
            (mt, mt.models.ssd.get_symbol(**TINY), mt.cpu(),
             lambda a: mt.nd.array(a, ctx=mt.cpu()))):
        mod = pkg.mod.Module(sym, label_names=("label",), context=ctx,
                             logger=_quiet())
        mod.bind(data_shapes=[("data", (B,) + SHAPE)],
                 label_shapes=[("label", lab.shape)], for_training=False)
        mod.set_params({k: arr(v) for k, v in w.items()}, {},
                       allow_missing=True)
        mod.forward(pkg.io.DataBatch([arr(x)], [arr(lab)]), is_train=False)
        dets.append(mod.get_outputs()[0].asnumpy())
    assert mod.label_names == []
    assert dets[0].shape == dets[1].shape == (B, 1376, 6)
    assert np.isfinite(dets[1]).all()
    with pytest.raises(mt.MXNetError, match="label shapes name"):
        mt.mod.Module(sym, label_names=("label",), context=mt.cpu()).bind(
            data_shapes=[("data", (B,) + SHAPE)],
            label_shapes=[("other", lab.shape)], for_training=False)


# ------------------------------------------------------ data and metrics
def test_ssd_data_is_the_examples(mt):
    from mxtpu_torch.models import ssd_data
    sys.path.insert(0, os.path.join(ROOT, "examples", "ssd"))
    import _synth
    import evaluate as ssd_eval
    import train as ssd_train
    jit = _synth.SynthDetIter(4, SHAPE, 3, num_batches=2, seed=7)
    tit = ssd_data.SynthDetIter(4, SHAPE, 3, num_batches=2, seed=7)
    jm, tm = ssd_train.MultiBoxMetric(), ssd_data.MultiBoxMetric()
    ja, ta = ssd_eval.MApMetric(), ssd_data.MApMetric()
    rng = np.random.RandomState(8)
    for jb, tb in zip(jit, tit):
        assert np.array_equal(jb.data[0].asnumpy(), tb.data[0].asnumpy())
        lab = tb.label[0].asnumpy()
        assert np.array_equal(jb.label[0].asnumpy(), lab)
        prob = rng.dirichlet(np.ones(4), (4, 50)).transpose(0, 2, 1)
        loss = rng.randn(4, 200)
        cls_t = rng.randint(-1, 4, (4, 50)).astype(np.float32)
        det = np.concatenate([rng.randint(-1, 3, (4, 50, 1)),
                              rng.rand(4, 50, 1),
                              np.repeat(lab[:, :1, 1:], 50, 1)
                              + rng.randn(4, 50, 4) * 0.05], -1)
        jm.update(None, [mx.nd.array(a) for a in (prob, loss, cls_t)])
        tm.update(None, [mt.nd.array(a, ctx=mt.cpu())
                         for a in (prob, loss, cls_t)])
        ja.update([mx.nd.array(lab)], [mx.nd.array(det)])
        ta.update([mt.nd.array(lab, ctx=mt.cpu())],
                  [mt.nd.array(det, ctx=mt.cpu())])
    for (n1, v1), (n2, v2) in zip(tm.get_name_value(), jm.get_name_value()):
        assert n1 == n2 and abs(v1 - v2) <= 1e-6 * max(1.0, abs(v2))
    assert ta.get()[0] == ja.get()[0]
    assert abs(ta.get()[1] - ja.get()[1]) <= 1e-6 and ta.get()[1] > 0


def test_default_context_is_the_ports(mt):
    with mt.cpu():
        assert mt.test_utils.default_context() == mt.cpu()
    mt.test_utils.assert_almost_equal(np.ones(3), np.ones(3) + 1e-7)
    with pytest.raises(AssertionError):
        mt.test_utils.assert_almost_equal(np.ones(3), np.zeros(3))
    assert mt.test_utils.same(np.arange(3), np.arange(3))
    assert mt.test_utils.default_dtype() is np.float32


# --------------------------------------------------------- the gate's twin
@pytest.mark.slow  # mxtpu's own test_ssd_gate runs in the slow tier
def test_ssd_gate_twin(mt, tmp_path):
    """tests/test_examples_gate.py::test_ssd_gate through the port on
    cpu(), from mxtpu's own initial draw there (Xavier after
    ``mx.random.seed(2)``, carried over by name): tiny, 64x64, 3
    classes, 3 scales, 12 epochs of 8 batches at lr 0.05; trained
    CrossEntropy < 1.2 and mAP above max(untrained, 0.05) on 2 held-out
    batches; the checkpoint reloads bit for bit. The port's own Xavier
    draws from numpy's stream (ROADMAP C, deliberate deltas), so its
    seed 2 is another initial net: chip_smoke.py's twin runs the port's
    draws at several seeds."""
    from mxtpu_torch.models import ssd_data
    sym = jssd.get_symbol_train(**TINY)
    jmod = mx.mod.Module(sym, label_names=("label",), context=mx.cpu(),
                         logger=_quiet())
    jmod.bind(data_shapes=[("data", (8,) + SHAPE)],
              label_shapes=[("label", (8, 8, 5))])
    mx.random.seed(2)
    np.random.seed(2)
    jmod.init_params(mx.initializer.Xavier())
    w = {k: v.asnumpy() for k, v in jmod.get_params()[0].items()}
    out = ssd_data.gate_twin(mt, mt.cpu(), str(tmp_path / "ssd"),
                             arg_params=mt.convert.params_from_mxtpu(
                                 w, "cpu"))
    assert out["cross_entropy"] < 1.2, out
    assert out["map_trained"] > max(out["map_untrained"], 0.05), out
    assert out["reload_bit_exact"], out

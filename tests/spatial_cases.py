"""The inputs of the spatial tranche's cases: the 18 op names of
``mxtpu/ops/spatial.py``, each case ``(op, inputs, attrs, indices of the
inputs to differentiate)`` in numpy alone, so that
``test_torch_spatial.py`` holds them against mxtpu on the CPU and
``test_torch_cuda.py`` and ``chip_smoke.py`` run them on the card against
the CPU (where neither JAX nor mxtpu is).

The ROIPooling cases plant what decides its answer: corners that land
on .5 after scaling (half to even), ROIs partly and wholly off the map,
1x1 ROIs, bins of zeros (tied maxima), NaN and +-inf inside bins, image
indices out of range and NaN, adjacent bins that share a row, and the
1/16 scale of the Faster R-CNN; then the kernels' edges: windows larger
and wider than the forward's staged tile, ROIs under one pixel, C = 3
and C = 513 against the channel tiles, R = 1, every ROI on image 1,
every ROI off the map, a bin of NaN and a bin of -inf, 300 ROIs crowding
one pixel, and pooled sizes past the kernels' spans in shared memory.
``ROI_MANY_TERMS`` puts a pixel in thousands of bins, where the kernel's
sum and the plain version's add the same terms in different orders:
``ordered_roi_gradient`` gives the kernel's order and ``order_bound``
what bounds the difference between any two orders. The Proposal cases
plant boxes under ``rpn_min_size``, tied scores, a threshold that keeps
fewer boxes than ``rpn_post_nms_top_n`` (the cycling pad),
``output_score`` and two images."""
import numpy as np

NAN, INF = np.nan, np.inf


def _r(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def _a(values, dtype=np.float32):
    return np.array(values, dtype)


def _softmax_pairs(x, A):
    """cls_prob (N, 2A, H, W) from scores: softmax over (bg, fg) pairs."""
    s = x.reshape(x.shape[0], 2, A, *x.shape[2:])
    e = np.exp(s - s.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).reshape(x.shape) \
        .astype(np.float32)


def _relu(x):
    return np.maximum(x, 0).astype(np.float32)


# ROIs in image pixels over an 8x10 map at scale 0.5: [image, x1, y1, x2, y2]
ROIS = _a([[0, 0, 0, 19, 15],      # the whole map
           [1, 3, 5, 11, 9],       # 1.5 -> 2, 2.5 -> 2, 5.5 -> 6, 4.5 -> 4
           [0, 7, 1, 7, 1],        # a 1x1 ROI (3.5 -> 4, 0.5 -> 0)
           [1, -9, -7, 4, 3],      # partly off the map
           [0, 30, 22, 41, 29],    # wholly off the map (bottom right)
           [0, -40, -30, -21, -19],  # wholly off the map (top left)
           [5, 2, 2, 13, 11],      # image 5 of 2: clamped to 1
           [-3, 2, 2, 13, 11],     # image -3: clamped to 0
           [NAN, 4, 0, 9, 6],      # NaN image: 0
           [1.7, 0, 4, 12, 9]])    # image 1.7: 1
# a 6-row ROI over 4 bins: floor/ceil bounds overlap on shared rows
ROIS_SHARED = _a([[0, 0, 0, 5, 5], [0, 1, 0, 6, 5], [1, 0, 1, 9, 6]])

_MAP = _r((2, 3, 8, 10), 1)
_ZEROS = _relu(_r((2, 3, 8, 10), 2, shift=-0.8))  # most pixels 0
_NONFIN = _r((2, 2, 8, 10), 3)
_NONFIN[0, 0, 1, 2] = NAN
_NONFIN[0, 1, 5, 7] = INF
_NONFIN[1, 0, 3, 3] = -INF
_NONFIN[1, 1, 6, 1] = NAN
_NONFIN[1, 1, 0, 0] = INF

# Faster R-CNN's scale: corner 8 at 1/16 is 0.5, which rounds to 0
_RCNN_MAP = _relu(_r((2, 4, 6, 9), 4, shift=-0.3))
_RCNN_ROIS = _a([[0, 8, 8, 72, 56], [1, 24, 40, 136, 88], [0, 0, 0, 143, 95],
                 [1, 56, 8, 56, 8]])

# the kernels' edges. One ROI over a whole 1x8x160x240 map at 1/1 (bins
# of ~23x34): a window larger than the forward's staged tile, walked in
# row bands; one over a 5x2100 map: a window row wider than the tile,
# walked in column tiles too.
_BIG = _relu(_r((1, 8, 160, 240), 40, shift=-0.5))
_WIDE = _r((1, 3, 5, 2100), 41)
# ROIs under one map pixel at 0.5 (every one of the 49 bins is that
# pixel), and one two pixels wide (7 bins over 2 columns)
_TINY_ROIS = _a([[0, 3, 3, 3.4, 3.2], [1, 7, 9, 7, 9], [0, 0, 0, 2, 1]])
# C = 513: one past a multiple of the forward's and the gather's channel
# tiles, at a small H and W
_C513 = _relu(_r((2, 513, 5, 6), 42, shift=-0.3))
_C513_ROIS = _a([[0, 0, 0, 5, 4], [1, 1, 2, 4, 4], [0, 2, 0, 3, 1]])
# a bin holding NaN (image 0, channel 0, bin (1, 1) of the second ROI)
# and one of only -inf (channel 1, bin (0, 0) of the first: rows 4-5,
# columns 4-7)
_HOLES = _r((2, 2, 8, 12), 43)
_HOLES[0, 0, 2, 3] = NAN
_HOLES[0, 1, 4:6, 4:8] = -INF
_HOLE_ROIS = _a([[0, 4, 4, 11, 7], [0, 0, 0, 5, 3], [1, 4, 4, 11, 7]])
# every ROI on image 1; every ROI off the map (past the bottom right
# corner, whose bins clip to the corner pixel, and above the top left,
# whose bins are empty)
_ROIS_IMG1 = np.concatenate([np.ones((4, 1), np.float32), ROIS[:4, 1:]], 1)
_ROIS_OFF = _a([[0, 30, 22, 41, 29], [1, -40, -30, -21, -19],
                [1, 25, 1, 60, 9], [0, -30, 2, -4, 12]])

# 300 ROIs over a ramp (the max of a rectangle is its bottom-right
# corner, so each bin's gradient goes to its own pixel), 70 of them from
# pixel (2, 2): more than a chunk of ROIs, more listed ROIs for one tile
# than a warp has lanes, and a pixel in more bins than a warp's list
# holds at once, while no pixel sums more than a few terms
_RAMP = (np.arange(576, dtype=np.float32).reshape(1, 1, 24, 24) / 7
         * _a([1, 2])[None, :, None, None])
_rng = np.random.RandomState(49)
_ys, _xs = np.meshgrid(np.arange(3, 24), np.arange(3, 24), indexing="ij")
_CORNERS = np.stack([_ys.ravel(), _xs.ravel()], 1)[
    _rng.permutation(441)[:300]]
_TOPLEFT = np.concatenate([np.full((70, 2), 2),
                           np.minimum(_rng.randint(0, 3, (230, 2)),
                                      _CORNERS[70:])])
_RAMP_ROIS = np.concatenate([np.zeros((300, 1)), _TOPLEFT[:, ::-1],
                             _CORNERS[:, ::-1]], 1).astype(np.float32)
# pooled sizes past the kernels' spans in shared memory: one bin a row
_TALL = _r((1, 1, 520, 4), 50)
_LONG = _r((1, 1, 1100, 2), 51)

# 120 ROIs under pixel (3, 3) of a 1x4x6x7 map (each of their 49 bins is
# that pixel: 5,880 terms there), and one ROI over image 1 of a ReLU'd
# 2x3x6x7 map pooled 200x200 (each pixel in about a thousand bins, tied
# zeros splitting their share)
_rng = np.random.RandomState(52)
_UNDER_ONE = np.concatenate([np.zeros((120, 1)), 3 + _rng.uniform(
    -0.4, 0.4, (120, 4))], 1).astype(np.float32)
ROI_MANY_TERMS = [
    ([_r((1, 4, 6, 7), 53), _UNDER_ONE],
     {"pooled_size": (7, 7), "spatial_scale": 1.0}),
    ([_relu(_r((2, 3, 6, 7), 54, shift=-0.3)), _a([[1, 0, 0, 6, 5]])],
     {"pooled_size": (200, 200), "spatial_scale": 1.0}),
]


def ordered_roi_gradient(data, image, bins, dy):
    """ROIPooling's gradient as the card's kernel sums it: for each map
    element, in float32, from 0, the terms of the bins that hold it in
    (ROI, ph, pw) order. A bin's term is dy / (its tied maxima) on each
    tied maximum, NaN on every pixel of a bin holding NaN, and none where
    its max is not finite. ``image`` (R,) and ``bins`` (hs, he, ws, we),
    (R, ph) and (R, pw), are each ROI's image and bin bounds as ints.
    Returns dx, the number of terms of each element and the sum of their
    magnitudes (float64)."""
    hs, he, ws, we = bins
    dx = np.zeros(data.shape, np.float32)
    terms = np.zeros(data.shape, np.int64)
    mag = np.zeros(data.shape, np.float64)
    for r, b in enumerate(image):
        for ph in range(hs.shape[1]):
            for pw in range(ws.shape[1]):
                at = (b, slice(None), slice(hs[r, ph], he[r, ph]),
                      slice(ws[r, pw], we[r, pw]))
                region = data[at]
                if region.size == 0:
                    continue
                nan = np.isnan(region).any(axis=(1, 2))
                m = np.where(np.isnan(region), -INF, region).max(axis=(1, 2))
                tied = (region == m[:, None, None]) \
                    & (np.isfinite(m) & ~nan)[:, None, None]
                count = np.maximum(tied.sum(axis=(1, 2)), 1)
                share = np.where(nan, np.float32(NAN),
                                 dy[r, :, ph, pw] / count.astype(np.float32))
                hit = tied | nan[:, None, None]
                term = np.broadcast_to(share.astype(np.float32)[:, None, None],
                                       region.shape)
                np.add(dx[at], term, out=dx[at], where=hit)
                terms[at] += hit
                mag[at] += np.where(hit, np.abs(term.astype(np.float64)), 0)
    return dx, terms, mag


def order_bound(terms, mag):
    """The most two float32 sums of the same n terms, in any orders, can
    differ by: each is within gamma(n - 1) * sum |t| of the exact sum,
    gamma(k) = k u / (1 - k u), u = 2^-24."""
    u = 2.0 ** -24
    k = np.maximum(terms - 1, 0) * u
    return 2 * k / (1 - k) * mag


_A_PROP = 6  # scales (2, 4) x ratios (0.5, 1, 2)
_PROP_ATTRS = {"feature_stride": 8, "scales": (2.0, 4.0),
               "ratios": (0.5, 1.0, 2.0), "rpn_pre_nms_top_n": 200,
               "rpn_post_nms_top_n": 60, "threshold": 0.5, "rpn_min_size": 6}
_PROP_SCORE = _softmax_pairs(_r((2, 2 * _A_PROP, 6, 8), 5, 2.0), _A_PROP)
_PROP_BBOX = _r((2, 4 * _A_PROP, 6, 8), 6, 0.3)
_PROP_INFO = _a([[48, 64, 1.0], [40, 56, 1.5]])

# (op, inputs, attrs, indices of the inputs to differentiate)
CASES = [
    ("BilinearSampler", [_r((2, 3, 5, 6), 10),
                         _r((2, 2, 4, 5), 11, 0.7)], {}, [0, 1]),
    # grid points on pixel centres and the border exactly
    ("BilinearSampler", [_r((1, 2, 4, 5), 12),
                         np.stack([np.tile(_a([-1, -0.5, 0, 0.5, 1]),
                                           (3, 1)),
                                   np.tile(_a([[-1], [1 / 3], [1]]),
                                           (1, 5))])[None]], {}, [0]),
    ("GridGenerator", [_r((2, 6), 13)],
     {"transform_type": "affine", "target_shape": (4, 5)}, [0]),
    ("GridGenerator", [_r((2, 2, 4, 5), 14)],
     {"transform_type": "warp", "target_shape": (4, 5)}, [0]),
    ("SpatialTransformer", [_r((2, 3, 6, 7), 15),
                            _a([[0.9, 0.1, 0.05, -0.1, 1.1, 0.0],
                                [0.5, 0.0, 0.3, 0.0, 0.6, -0.2]])],
     {"target_shape": (4, 5), "transform_type": "affine",
      "sampler_type": "bilinear"}, [0, 1]),
    ("ROIPooling", [_MAP, ROIS],
     {"pooled_size": (3, 3), "spatial_scale": 0.5}, [0]),
    ("ROIPooling", [_ZEROS, ROIS],
     {"pooled_size": (2, 3), "spatial_scale": 0.5}, [0]),
    ("ROIPooling", [_NONFIN, ROIS],
     {"pooled_size": (3, 3), "spatial_scale": 0.5}, [0]),
    ("ROIPooling", [_MAP, ROIS_SHARED],
     {"pooled_size": (4, 4), "spatial_scale": 1.0}, [0]),
    ("ROIPooling", [_RCNN_MAP, _RCNN_ROIS],
     {"pooled_size": (7, 7), "spatial_scale": 0.0625}, [0]),
    ("ROIPooling", [_BIG, _a([[0, 0, 0, 239, 159]])],
     {"pooled_size": (7, 7), "spatial_scale": 1.0}, [0]),
    ("ROIPooling", [_WIDE, _a([[0, 0, 0, 2099, 4], [0, 300, 1, 1900, 3]])],
     {"pooled_size": (2, 7), "spatial_scale": 1.0}, [0]),
    ("ROIPooling", [_ZEROS, _TINY_ROIS],
     {"pooled_size": (7, 7), "spatial_scale": 0.5}, [0]),
    ("ROIPooling", [_MAP, ROIS_SHARED],
     {"pooled_size": (7, 7), "spatial_scale": 1.0}, [0]),
    ("ROIPooling", [_C513, _C513_ROIS],
     {"pooled_size": (7, 7), "spatial_scale": 1.0}, [0]),
    ("ROIPooling", [_MAP, ROIS[1:2]],
     {"pooled_size": (3, 3), "spatial_scale": 0.5}, [0]),
    ("ROIPooling", [_MAP, _ROIS_IMG1],
     {"pooled_size": (2, 2), "spatial_scale": 0.5}, [0]),
    ("ROIPooling", [_MAP, _ROIS_OFF],
     {"pooled_size": (3, 3), "spatial_scale": 0.5}, [0]),
    ("ROIPooling", [_HOLES, _HOLE_ROIS],
     {"pooled_size": (2, 2), "spatial_scale": 1.0}, [0]),
    ("ROIPooling", [_RAMP, _RAMP_ROIS],
     {"pooled_size": (1, 1), "spatial_scale": 1.0}, [0]),
    ("ROIPooling", [_TALL, _a([[0, 0, 0, 3, 519], [0, 1, 10, 3, 400]])],
     {"pooled_size": (520, 1), "spatial_scale": 1.0}, [0]),
    ("ROIPooling", [_LONG, _a([[0, 0, 0, 1, 1099], [0, 0, 5, 1, 800]])],
     {"pooled_size": (1100, 1), "spatial_scale": 1.0}, [0]),
    ("_contrib_PSROIPooling", [_r((2, 18, 7, 8), 16), ROIS[:6]],
     {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 3}, [0]),
    ("PSROIPooling", [_r((2, 8, 7, 8), 17), ROIS[:4]],
     {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 3,
      "group_size": 2}, [0]),
    ("Correlation", [_r((2, 3, 7, 8), 18), _r((2, 3, 7, 8), 19)],
     {"kernel_size": 1, "max_displacement": 2, "pad_size": 2}, [0, 1]),
    ("Correlation", [_r((1, 2, 9, 9), 20), _r((1, 2, 9, 9), 21)],
     {"kernel_size": 3, "max_displacement": 2, "stride1": 2, "stride2": 2,
      "pad_size": 3, "is_multiply": False}, [0, 1]),
    ("_contrib_DeformableConvolution",
     [_r((2, 4, 6, 6), 22), _r((2, 36, 6, 6), 23, 0.7),
      _r((4, 2, 3, 3), 24)],
     {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4, "num_group": 2,
      "num_deformable_group": 2}, [0, 1, 2]),
    ("DeformableConvolution",
     [_r((1, 2, 7, 7), 25), _r((1, 18, 3, 3), 26, 0.5),
      _r((3, 2, 3, 3), 27), _r((3,), 28)],
     {"kernel": (3, 3), "stride": (2, 2), "dilate": (1, 1), "pad": (0, 0),
      "num_filter": 3, "no_bias": False}, [0, 1, 2, 3]),
    ("_contrib_DeformablePSROIPooling",
     [_r((2, 18, 8, 9), 29), ROIS[:5], _r((5, 2, 3, 3), 30)],
     {"spatial_scale": 0.5, "output_dim": 2, "group_size": 3,
      "pooled_size": 3, "sample_per_part": 2, "trans_std": 0.1}, [0, 2]),
    ("DeformablePSROIPooling", [_r((2, 8, 8, 9), 31), ROIS[:4]],
     {"spatial_scale": 0.5, "output_dim": 2, "group_size": 2,
      "pooled_size": 2, "part_size": 2, "no_trans": True}, [0]),
    ("_contrib_Proposal", [_PROP_SCORE, _PROP_BBOX, _PROP_INFO],
     dict(_PROP_ATTRS, output_score=True), [0, 1]),
    # tied scores: every foreground score equal
    ("Proposal", [np.full((1, 2 * _A_PROP, 6, 8), 0.5, np.float32),
                  _PROP_BBOX[:1], _PROP_INFO[:1]], dict(_PROP_ATTRS), [1]),
    # few kept, cycled: a threshold of 0.01 and post > kept
    ("_contrib_MultiProposal", [_PROP_SCORE, _PROP_BBOX, _PROP_INFO],
     dict(_PROP_ATTRS, threshold=0.01, rpn_post_nms_top_n=40,
          output_score=True), [0, 1]),
    # most boxes under rpn_min_size (-inf scores), pre cut off (all)
    ("MultiProposal", [_PROP_SCORE, _PROP_BBOX * 3, _PROP_INFO],
     dict(_PROP_ATTRS, rpn_min_size=20, rpn_pre_nms_top_n=-1,
          rpn_post_nms_top_n=30), [1]),
    ("khatri_rao", [_r((3, 4), 32), _r((3, 2), 33)], {"num_args": 2},
     [0, 1]),
    ("_contrib_krprod", [_r((2, 3), 34), _r((2, 2), 35), _r((2, 2), 36)],
     {"num_args": 3}, [0, 1, 2]),
    ("_khatri_rao", [_r((4, 1), 37), _r((4, 3), 38)], {"num_args": 2},
     [0, 1]),
]

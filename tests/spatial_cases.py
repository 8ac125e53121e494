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
1/16 scale of the Faster R-CNN. The Proposal cases plant boxes under
``rpn_min_size``, tied scores, a threshold that keeps fewer boxes than
``rpn_post_nms_top_n`` (the cycling pad), ``output_score`` and two
images."""
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

"""The inputs of the op tranche's cases: the 97 op names the port took
over from ``mxtpu/ops/tensor.py`` and ``mxtpu/ops/nn.py``, each case
``(op, inputs, attrs, indices of the inputs to differentiate)`` in numpy
alone, so that ``test_torch_ops_tranche.py`` holds them against mxtpu on
the CPU and ``test_torch_cuda.py`` and ``chip_smoke.py`` run them on the
card against the CPU (where neither JAX nor mxtpu is). The inputs plant
exact zeros, ties, the clip bounds, NaN and -0.0 for the sorts, indices
out of range, an int32 zero divisor, and integer and float16 arrays."""
import numpy as np

NAN = np.nan


def _r(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def _a(values, dtype=np.float32):
    return np.array(values, dtype)


# zeros of both signs, halves (the rounding ties), integers
_U = _a([[-1.5, -0.5, 0.0, -0.0, 0.5, 1.5], [2.5, -2.5, 0.3, -0.7, 1.0, 3.0]])
_UNIT = _a([[-0.9, -0.5, 0.0, 0.3, 0.5, 0.99]])
_POS = _a([[0.25, 0.5, 1.0, 2.0, 3.5, 10.0]])
_GAMMA = _a([[-2.5, -1.5, -0.5, 0.5, 3.0, 4.5]])
_INT = _a([[-3, -1, 0, 2, 5, 7]], np.int32)
_SORT = _a([[1.0, NAN, 3.0, -0.0, 0.0, 2.0, 3.0, -1.0]])
_TIES = _a([[1.0, 3.0, 3.0, 2.0], [0.0, -0.0, 5.0, 5.0]])

UNARY_ANY = ["sin", "cos", "tan", "arctan", "sinh", "cosh", "tanh",
             "arcsinh", "erf", "expm1", "degrees", "radians", "cbrt",
             "softsign", "sign", "round", "rint", "ceil", "floor", "trunc",
             "fix", "identity", "BlockGrad", "stop_gradient", "cast_storage"]

# (op, inputs, attrs, indices of the inputs to differentiate)
CASES = (
    [(n, [_U], {"stype": "default"} if n == "cast_storage" else {}, [0])
     for n in UNARY_ANY] +
    [(n, [_UNIT], {}, [0]) for n in ("arcsin", "arccos", "arctanh")] +
    [(n, [_POS], {}, [0]) for n in ("log1p", "log2", "log10", "reciprocal",
                                    "rsqrt", "rcbrt", "gammaln", "gamma")] +
    [("arccosh", [_a([[1.25, 1.5, 3.0, 10.0]])], {}, [0]),
     ("gamma", [_GAMMA], {}, [0]),       # |Gamma|: gamma(-0.5) = +3.54
     ("gammaln", [_GAMMA], {}, [0]),
     # the gradient at 0: -inf for rsqrt, +-inf for cbrt and rcbrt
     ("rsqrt", [_a([[0.0, 4.0]])], {}, [0]),
     ("cbrt", [_a([[0.0, -8.0, 27.0]])], {}, [0]),
     ("reciprocal", [_a([[0.0, -0.0, 2.0]])], {}, []),
     ("log1p", [_a([[-1.0, 0.0]])], {}, [])] +
    [(n, [_INT], {"stype": "csr"} if n == "cast_storage" else {}, [])
     for n in ("sin", "sign", "round", "floor", "fix", "identity",
               "cast_storage", "tanh", "erf", "sqrt")] +
    [(n, [_U.astype(np.float16)], {}, [])
     for n in ("round", "tanh", "sign", "cbrt")] +
    # mod: float with zero and negative divisors (NaN at /0), int32 with
    # a zero divisor (5 % 0 == 0), and the gradient off the zeros
    [("_mod", [_a([5, -5, 5, 0, 7.5, -7.5, 1]),
               _a([0, 3, -3, 2, 2, -2, -0.0])], {}, []),
     ("_mod", [_a([5, -5, 5, 0, 7, -7], np.int32),
               _a([0, 3, -3, 2, 0, -2], np.int32)], {}, []),
     ("_mod", [_a([5.0, -5.0, 7.0, 2.5, -0.5]),
               _a([3.0, 3.0, -2.0, 0.5, 2.0])], {}, [0, 1]),
     ("broadcast_mod", [_r((2, 3, 4), 1, 3.0), _a([[[1.5]], [[-2.0]]])],
      {}, [0, 1]),
     ("broadcast_mod", [_a([[5, -5, 7]], np.int32), _a([[0], [3]], np.int32)],
      {}, []),
     ("_mod_scalar", [_a([5, -5, 7, 0], np.int32)], {"scalar": 0}, []),
     ("_mod_scalar", [_a([5.5, -5.5, 7.0, 0.0])], {"scalar": 2.0}, [0]),
     ("_mod_scalar", [_a([5.5, -5.5, 7.0])], {"scalar": 0.0}, []),
     ("_rmod_scalar", [_a([2.0, -3.0, 1.5, 0.0])], {"scalar": 5.0}, []),
     ("_rmod_scalar", [_a([2.0, -3.0, 1.5, 4.0])], {"scalar": 5.0}, [0]),
     ("_rmod_scalar", [_a([2, -3, 0, 4], np.int32)], {"scalar": 5}, []),
     # hypot: (0, 0) gives each side 1/2; an int array comes out float32
     ("_hypot", [_a([0.0, 3.0, -3.0, 0.0, 5.0]),
                 _a([0.0, 4.0, 4.0, -2.0, 5.0])], {}, [0, 1]),
     ("_hypot", [_a([3, 0], np.int32), _a([4, 0], np.int32)], {}, []),
     ("broadcast_hypot", [_r((2, 3), 2), _a([[0.0], [1.0]])], {}, [0, 1]),
     ("_hypot_scalar", [_a([0.0, 3.0, -4.0])], {"scalar": 4.0}, [0]),
     ("_hypot_scalar", [_a([0.0, 3.0])], {"scalar": 0.0}, [0]),
     ("_grad_add", [_r((2, 3), 3), _r((2, 3), 4)], {}, [0, 1])] +
    [(n, [_r((2, 3), 5), _r((2, 3), 6), _r((2, 3), 7)], {"num_args": 3},
      [0, 1, 2]) for n in ("add_n", "ElementWiseSum", "_sum")] +
    [("add_n", [_a([1, 2], np.int32), _a([3, 4], np.int32)],
      {"num_args": 2}, []),
     ("broadcast_axis", [_r((1, 3, 1), 8)], {"axis": (0, 2), "size": (2, 4)},
      [0]),
     ("broadcast_axes", [_r((2, 1), 9)], {"axis": 1, "size": 3}, [0]),
     # prod: a zero's gradient is the product of the rest, two zeros 0
     ("prod", [_a([[0.0, 2.0, 3.0], [1.0, 0.0, 0.0], [2.0, -1.5, 4.0]])], {},
      [0]),
     ("prod", [_a([[0.0, 2.0, 3.0], [1.0, 0.0, 0.0], [2.0, -1.5, 4.0]])],
      {"axis": 1}, [0]),
     ("prod", [_r((2, 3, 4), 10)], {"axis": (0, 2), "keepdims": True}, [0]),
     ("prod", [_r((2, 3, 4), 11)], {"axis": 1, "exclude": True}, [0]),
     ("prod", [_a([[65536, 65536, 3], [7, -2, 5]], np.int32)], {"axis": 1},
      []),  # int32, wrapping: 2^32 -> 0
     ("prod", [_a([[3, 200], [7, 70]], np.uint8)], {"axis": 1}, []),
     ("nansum", [_a([[1.0, NAN, 2.0], [NAN, NAN, 0.5]])], {}, [0]),
     ("nansum", [_a([[1.0, NAN, 2.0], [NAN, NAN, 0.5]])], {"axis": 1}, [0]),
     ("nansum", [_a([[1, 2], [3, 4]], np.int32)], {"axis": 0}, []),
     ("nanprod", [_a([[1.5, NAN, 2.0], [NAN, NAN, 0.5]])], {"axis": 1}, [0]),
     ("nanprod", [_a([[0.0, NAN, 2.0]])], {}, [0]),
     ("sum_axis", [_r((2, 3, 4), 12)], {"axis": 1, "keepdims": True}, [0]),
     ("sum_axis", [_r((2, 3, 4), 13)], {}, [0]),
     ("_square_sum", [_r((2, 3, 4), 14)], {"axis": (0, 2)}, [0]),
     ("_square_sum", [_r((2, 3), 15)], {"keepdims": True}, [0]),
     ("argmin", [_a([[1.0, 0.0, 0.0], [2.0, 2.0, 1.0]])], {"axis": 1}, []),
     ("argmin", [_a([[1.0, 0.0, 0.0], [2.0, 2.0, 0.0]])], {}, []),
     ("argmin", [_a([[1, 0, 0], [2, 2, 1]], np.int32)],
      {"axis": 0, "keepdims": True}, []),
     ("argmax_channel", [_a([[[1.0, 3.0], [3.0, 0.0]],
                             [[2.0, 2.0], [2.0, 5.0]]])], {}, []),
     ("argmax_channel", [_a([[3, 200], [7, 70]], np.int32)], {}, []),
     # slice and its assignments: None bounds, negative bounds, a bound
     # far past the start (clipped)
     ("slice", [_r((3, 4), 16)], {"begin": (-10, None), "end": (2, -1)}, [0]),
     ("slice", [_r((2, 3, 4), 17)], {"begin": (1, 0), "end": (2, 2)}, [0]),
     ("crop", [_r((3, 4), 18)], {"begin": (1, 1), "end": (3, 3)}, [0]),
     ("_slice_assign", [_r((3, 4), 19), _r((2, 2), 20)],
      {"begin": (1, 1), "end": (3, 3)}, [0, 1]),
     ("_slice_assign", [_r((3, 4), 21), _r((1, 2), 22)],
      {"begin": (0, -2), "end": (3, None)}, [0, 1]),
     ("_crop_assign", [_r((3, 4), 23), _r((1, 4), 24)],
      {"begin": (1, 0), "end": (2, 4)}, [0, 1]),
     ("_slice_assign_scalar", [_r((3, 4), 25)],
      {"begin": (1, 1), "end": (3, 3), "scalar": 2.5}, [0]),
     ("_crop_assign_scalar", [_a([[1, 2, 3], [4, 5, 6]], np.int32)],
      {"begin": (0, 1), "end": (2, 2), "scalar": 2.7}, []),
     # clip: the gradient is 1/2 at each bound, 0 at NaN; an int32 array
     # comes out float32, float16 stays float16
     ("clip", [_a([-1.0, 0.0, 0.25, 0.5, 1.0, 2.0, NAN])],
      {"a_min": 0.0, "a_max": 1.0}, [0]),
     ("clip", [_a([0.5, 0.5, 1.0])], {"a_min": 0.5, "a_max": 0.5}, [0]),
     ("clip", [_a([0, 1, 2, 3], np.int32)], {"a_min": 0.5, "a_max": 2.5}, []),
     ("clip", [_a([0.1, 1.0, 2.0, 3.0], np.float16)],
      {"a_min": 0.5, "a_max": 2.5}, []),
     ("repeat", [_r((2, 3), 26)], {"repeats": 2}, [0]),
     ("repeat", [_r((2, 3), 27)], {"repeats": 3, "axis": 1}, [0]),
     ("repeat", [_r((2, 3), 28)], {"repeats": 2, "axis": -2}, [0]),
     ("tile", [_r((2,), 29)], {"reps": (2, 2)}, [0]),
     ("tile", [_r((2, 3), 30)], {"reps": (2, 1, 3)}, [0]),
     ("tile", [_r((2, 3, 2), 31)], {"reps": (2,)}, [0]),
     ("space_to_depth", [_r((1, 2, 4, 6), 32)], {"block_size": 2}, [0]),
     ("dot", [_r((3, 4), 33), _r((4, 5), 34)], {}, [0, 1]),
     ("dot", [_r((4, 3), 35), _r((5, 4), 36)],
      {"transpose_a": True, "transpose_b": True}, [0, 1]),
     ("dot", [_r((2, 3, 4), 37), _r((4, 5), 38)], {}, [0, 1]),
     ("dot", [_r((2, 3, 4), 39), _r((3, 4, 5), 40)], {}, [0, 1]),
     ("dot", [_r((4, 2, 3), 41), _r((5, 4), 42)],
      {"transpose_a": True, "transpose_b": True}, [0, 1]),
     ("dot", [_r((4,), 43), _r((4,), 44)], {}, [0, 1]),
     ("dot", [_r((3, 4), 45), _r((4,), 46)], {}, [0, 1]),
     ("batch_dot", [_r((2, 3, 4), 47), _r((2, 4, 5), 48)], {}, [0, 1]),
     ("batch_dot", [_r((2, 4, 3), 49), _r((2, 5, 4), 50)],
      {"transpose_a": True, "transpose_b": True}, [0, 1]),
     # the gathers: an index out of range is clamped (gather_nd), NaN
     # (batch_take), a zero row (one_hot) or dropped (scatter_nd)
     ("one_hot", [_a([-1.0, 0.0, 2.0, 3.0, 1.7, -0.5, NAN, 1e10, -1e10])],
      {"depth": 3}, []),
     ("one_hot", [_a([[1, 2], [0, 5]], np.int32)],
      {"depth": 3, "dtype": "int32", "on_value": 2.0, "off_value": -1.0}, []),
     ("one_hot", [_a([1.0, 2.0])], {"depth": 3, "dtype": "float16",
                                    "on_value": 2.5, "off_value": -1.0}, []),
     ("gather_nd", [_a([[1.0, 2.0], [3.0, 4.0]]), _a([[5, -1], [0, 9]])], {},
      [0]),
     ("gather_nd", [_r((3, 4, 2), 51), _a([[0, 2, -1, 1], [3, 0, 1, 1]])],
      {}, [0]),
     ("gather_nd", [_r((3, 4), 52), _a([[2, 0, -3, 7]], np.int32)], {}, [0]),
     ("scatter_nd", [_a([1.0, 2.0, 3.0]), _a([[5, -1, 1], [0, 1, -3]])],
      {"shape": (2, 2)}, [0]),
     ("scatter_nd", [_r((4, 3), 53), _a([[0, 1, 1, -1], [2, 0, 0, 1]])],
      {"shape": (2, 3, 3)}, [0]),
     ("batch_take", [_r((3, 4), 54), _a([-1.0, 5.0, 2.0])], {}, [0]),
     ("batch_take", [_r((2, 3), 55), _a([0, -4], np.int32)], {}, [0]),
     ("_ones", [], {"shape": (2, 3)}, []),
     ("_ones", [], {"shape": (2,), "dtype": "int32"}, []),
     ("_full", [], {"shape": (3, 2), "value": 2.5}, []),
     ("_full", [], {"shape": (2,), "value": 7.9, "dtype": "int32"}, []),
     ("_arange", [], {"start": 0.1, "stop": 1.7, "step": 0.3}, []),
     ("_arange", [], {"start": 3.0, "dtype": "int32", "repeat": 2}, []),
     ("_arange", [], {"start": 5.0, "stop": -1.0, "step": -1.5}, []),
     ("_arange", [], {"start": 2.0, "stop": 2.0}, []),
     # the orderings: ties keep the lower index first, NaN sorts last
     # (descending sort: first), -0.0 equals 0.0
     ("topk", [_a([1.0, 3.0, 3.0, 2.0])], {"k": 2}, []),
     ("topk", [_SORT], {"k": 0, "ret_typ": "both"}, [0]),
     ("topk", [_SORT], {"k": 3, "ret_typ": "value", "is_ascend": True}, [0]),
     ("topk", [_TIES], {"k": 2, "ret_typ": "mask"}, []),
     ("topk", [_TIES], {"k": 1, "axis": 0, "ret_typ": "both"}, [0]),
     ("topk", [_a([[3, 1, 3], [0, 2, 2]], np.int32)], {"k": 2}, []),
     ("sort", [_SORT], {}, [0]),
     ("sort", [_SORT], {"is_ascend": False}, [0]),
     ("sort", [_TIES], {"axis": 0, "is_ascend": False}, [0]),
     ("sort", [_a([[3, 1, 3], [0, 2, 2]], np.int32)], {"axis": None}, []),
     ("argsort", [_SORT], {}, []),
     ("argsort", [_SORT], {"is_ascend": False}, []),
     ("argsort", [_TIES], {"axis": 0}, []),
     ("quantize_int8", [_a([0.5, 1.5, 2.5, -0.5, 300.0, -300.0])],
      {"scale": (1.0,)}, []),
     ("quantize_int8", [_r((2, 3, 2), 56, 4.0)], {"scale": (0.5, 0.1, 0.25),
                                                   "axis": 1}, []),
     ("dequantize_int8", [_a([[-127, 0, 5], [127, 3, -2]], np.int8)],
      {"scale": (0.5, 2.0), "axis": 0}, []),
     ("dequantize_int8", [_a([-127, 0, 5], np.int8)],
      {"scale": (0.25,), "out_dtype": "float16"}, []),
     ("_identity_with_attr_like_rhs", [_r((2, 3), 57), _r((4,), 58)], {},
      [0, 1])] +
    # nn.py: Deconvolution (mxtpu's default no_bias=True), with adj, a
    # target_shape, groups, a dilation, adj above pad, 1-D and 3-D
    [("Deconvolution", [_r((2, 2, 4, 5), 60), _r((2, 3, 3, 3), 61)],
      {"kernel": (3, 3), "num_filter": 3, "stride": (2, 2), "pad": (1, 1),
       "adj": (1, 1)}, [0, 1]),
     ("Deconvolution", [_r((1, 4, 3, 3), 62), _r((4, 1, 3, 2), 63),
                        _r((2,), 64)],
      {"kernel": (3, 2), "num_filter": 2, "num_group": 2, "stride": (1, 2),
       "dilate": (2, 1), "no_bias": False}, [0, 1, 2]),
     ("Deconvolution", [_r((1, 2, 3, 3), 65), _r((2, 2, 3, 3), 66)],
      {"kernel": (3, 3), "num_filter": 2, "stride": (2, 2), "pad": (1, 1),
       "target_shape": (8, 7)}, [0, 1]),
     ("Deconvolution", [_r((1, 1, 2, 2), 67), _r((1, 1, 3, 3), 68)],
      {"kernel": (3, 3), "num_filter": 1, "stride": (2, 2), "pad": (1, 1),
       "adj": (3, 0)}, [0, 1]),
     ("Deconvolution", [_r((2, 3, 6), 69), _r((3, 2, 4), 70)],
      {"kernel": (4,), "num_filter": 2, "stride": (3,), "pad": (2,)},
      [0, 1]),
     ("Deconvolution", [_r((1, 2, 2, 3, 2), 71), _r((2, 1, 2, 2, 2), 72)],
      {"kernel": (2, 2, 2), "num_filter": 1, "stride": (2, 2, 2)}, [0, 1]),
     ("UpSampling", [_r((2, 3, 2, 3), 73)], {"scale": 2}, [0]),
     ("UpSampling", [_r((1, 2, 2, 2), 74), _r((1, 1, 2, 2), 75)],
      {"scale": 3, "num_args": 2, "multi_input_mode": "sum"}, [0, 1]),
     ("UpSampling", [_r((1, 2, 3, 4), 76), _r((2, 1, 4, 4), 77)],
      {"scale": 2, "sample_type": "bilinear", "num_args": 2,
       "num_filter": 2}, [0]),
     ("Crop", [_r((1, 2, 5, 6), 78)], {"h_w": (3, 2), "offset": (1, 2)}, [0]),
     ("Crop", [_r((1, 2, 5, 6), 79), _r((1, 1, 2, 3), 80)],
      {"num_args": 2, "center_crop": True}, [0]),
     ("Pad", [_r((1, 2, 3, 4), 81)],
      {"mode": "constant", "pad_width": (0, 0, 1, 2, 2, 1, 0, 3),
       "constant_value": 1.5}, [0]),
     ("Pad", [_r((1, 2, 3, 4), 82)],
      {"mode": "edge", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)}, [0]),
     ("pad", [_r((1, 2, 3, 4), 83)],
      {"mode": "reflect", "pad_width": (0, 0, 0, 0, 2, 2, 3, 1)}, [0]),
     ("pad", [_r((1, 1, 3), 84)],
      {"mode": "reflect", "pad_width": (0, 0, 1, 0, 4, 5)}, [0]),
     ("Pad", [_r((2, 3, 2), 85)],
      {"mode": "edge", "pad_width": (1, 0, 0, 2, 0, 0)}, [0]),
     ("LRN", [_r((2, 5, 3, 3), 86)], {"nsize": 3}, [0]),
     ("LRN", [_r((1, 4, 2, 2), 87)],
      {"nsize": 5, "alpha": 0.1, "beta": 0.5, "knorm": 1.0}, [0]),
     ("InstanceNorm", [_r((2, 3, 4, 4), 88), _r((3,), 89, shift=1.0),
                       _r((3,), 90)], {}, [0, 1, 2]),
     ("InstanceNorm", [_r((2, 3, 5), 91), _r((3,), 92), _r((3,), 93)],
      {"eps": 0.1}, [0, 1, 2])] +
    [("L2Normalization", [_r((2, 3, 2, 2), 94 + i)], {"mode": m}, [0])
     for i, m in enumerate(("instance", "channel", "spatial"))] +
    [("SoftmaxActivation", [_r((2, 3, 2, 2), 97)], {}, [0]),
     ("SoftmaxActivation", [_r((2, 3, 2, 2), 98)], {"mode": "channel"}, [0]),
     ("softmax_cross_entropy", [_r((3, 4), 99), _a([1.0, 3.0, 0.0])], {},
      [0]),
     ("softmax_cross_entropy", [_r((3, 4), 100), _a([1.0, 5.0, -1.0])], {},
      []),
     # the loss heads: the gradient ignores the head gradient
     ("LinearRegressionOutput", [_r((4, 1), 101), _r((4,), 102)], {}, [0]),
     ("LinearRegressionOutput", [_r((4, 3), 103), _r((4, 3), 104)],
      {"grad_scale": 0.5}, [0]),
     ("LogisticRegressionOutput", [_r((4, 3), 105), _r((4, 3), 106)], {},
      [0]),
     ("MAERegressionOutput", [_a([[1.0, 2.0], [0.5, -1.0]]),
                              _a([[1.0, 3.0], [0.0, -1.5]])], {}, [0]),
     ("SVMOutput", [_r((4, 5), 107), _a([0.0, 4.0, 2.0, 7.0])], {}, [0]),
     ("SVMOutput", [_r((4, 5), 108), _a([1.0, 3.0, -1.0, 2.0])],
      {"use_linear": True, "margin": 0.5,
       "regularization_coefficient": 2.0}, [0]),
     ("IdentityAttachKLSparseReg", [_r((3, 4), 109)], {}, [0])])

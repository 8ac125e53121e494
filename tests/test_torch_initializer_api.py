"""The initializers this slice adds to the port (Orthogonal, MSRAPrelu,
Bilinear, Mixed, Load, and the upsampling/moving-statistics names of the
suffix dispatch) against mxtpu's on the CPU. Orthogonal draws from
numpy's global generator in both packages and Bilinear draws nothing, so
they agree bit for bit under one ``np.random.seed``. mxtpu's Xavier (and
so MSRAPrelu) draws from its threefry key (a deliberate delta, ROADMAP
C: the port's initializers draw from numpy), so MSRAPrelu is held bit
for bit to the numpy normal draw of mxtpu's scale, and by its
statistics to mxtpu's draw.

torch is imported lazily and pinned to one thread: several test workers
share the host."""
import numpy as np
import pytest

import mxtpu as mx


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def _init(pkg, init, name, shape, seed=7):
    np.random.seed(seed)
    with pkg.cpu():
        arr = pkg.nd.zeros(shape)
        init(pkg.init.InitDesc(name), arr)
    return arr.asnumpy()


CASES = [
    ("Orthogonal", {}, "fc_weight", (6, 4)),
    ("Orthogonal", {}, "fc_weight", (4, 6)),
    ("Orthogonal", {"scale": 0.5, "rand_type": "normal"}, "conv_weight",
     (8, 2, 3, 3)),
    ("Bilinear", {}, "up_weight", (2, 1, 4, 4)),
    ("Bilinear", {}, "up_weight", (1, 1, 5, 3)),
    ("Xavier", {}, "deconv_upsampling", (2, 2, 4, 4)),
    ("Xavier", {}, "bn_moving_inv_var", (5,)),
    ("Xavier", {}, "x_moving_avg", (5,)),
]


@pytest.mark.parametrize("name,kw,param,shape", CASES,
                         ids=["%s-%s-%d" % (c[0], c[2], i)
                              for i, c in enumerate(CASES)])
def test_initializer_matches_mxtpu_bit_for_bit(mt, name, kw, param, shape):
    got = _init(mt, getattr(mt.init, name)(**kw), param, shape)
    want = _init(mx, getattr(mx.init, name)(**kw), param, shape)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_orthogonal_rows_are_orthonormal(mt):
    w = _init(mt, mt.init.Orthogonal(scale=1.0), "fc_weight", (5, 12))
    np.testing.assert_allclose(w @ w.T, np.eye(5), atol=1e-5)


@pytest.mark.parametrize("factor_type,slope,shape", [
    ("avg", 0.25, (64, 32, 3, 3)), ("in", 0.0, (128, 256)),
    ("out", 0.5, (64, 16, 5, 5))])
def test_msraprelu_draws_mxtpus_normal_from_numpy(mt, factor_type, slope,
                                                  shape):
    got_init = mt.init.MSRAPrelu(factor_type=factor_type, slope=slope)
    want_init = mx.init.MSRAPrelu(factor_type=factor_type, slope=slope)
    assert got_init.dumps() == want_init.dumps()
    assert got_init.magnitude == want_init.magnitude
    assert got_init.rnd_type == want_init.rnd_type == "gaussian"
    got = _init(mt, got_init, "conv_weight", shape, seed=11)
    hw = np.prod(shape[2:]) if len(shape) > 2 else 1.0
    fan = {"avg": (shape[0] + shape[1]) * hw / 2.0, "in": shape[1] * hw,
           "out": shape[0] * hw}[factor_type]
    scale = np.sqrt(2.0 / (1 + slope ** 2) / fan)
    np.random.seed(11)
    np.testing.assert_array_equal(
        got, np.random.normal(0.0, scale, shape).astype(np.float32))
    want = _init(mx, want_init, "conv_weight", shape)
    n = want.size
    for x in (got, want):
        assert abs(x.mean()) < 5 * scale / np.sqrt(n)
        assert abs(x.std() - scale) < 5 * scale / np.sqrt(2 * n)


def _module(pkg):
    net = pkg.sym.Convolution(pkg.sym.Variable("data"), num_filter=4,
                              kernel=(3, 3), name="conv0")
    net = pkg.sym.BatchNorm(net, name="bn0")
    net = pkg.sym.FullyConnected(pkg.sym.Flatten(net), num_hidden=3,
                                 name="fc")
    net = pkg.sym.SoftmaxOutput(net, name="softmax")
    mod = pkg.mod.Module(net, context=pkg.cpu())
    mod.bind(data_shapes=[("data", (2, 1, 6, 6))],
             label_shapes=[("softmax_label", (2,))])
    return mod


def _mixed(pkg):
    init = pkg.init
    return init.Mixed([".*fc_weight", ".*conv.*_weight", ".*gamma",
                       ".*(beta|bias)", ".*moving_mean", ".*moving_var"],
                      [init.Orthogonal(), init.Bilinear(), init.One(),
                       init.Zero(), init.Zero(), init.One()])


def test_mixed_dispatches_by_pattern_as_mxtpu(mt):
    """Module.init_params through Mixed: every parameter agrees with
    mxtpu's bit for bit."""
    out = {}
    for pkg in (mt, mx):
        mod = _module(pkg)
        np.random.seed(5)
        mod.init_params(_mixed(pkg))
        args, aux = mod.get_params()
        out[pkg.__name__] = {k: v.asnumpy() for k, v in
                             list(args.items()) + list(aux.items())}
    got, want = out["mxtpu_torch"], out["mxtpu"]
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mixed_raises_for_an_unmatched_name(mt):
    init = mt.init.Mixed(["fc.*"], [mt.init.Zero()])
    with mt.cpu():
        with pytest.raises(mt.MXNetError, match="did not match"):
            init(mt.init.InitDesc("conv_weight"), mt.nd.zeros((2,)))


def test_load_reads_a_checkpoints_names_then_the_default(mt):
    rng = np.random.RandomState(2)
    saved = {"arg:fc_weight": rng.randn(3, 4).astype(np.float32),
             "aux:bn_moving_var": rng.rand(4).astype(np.float32),
             "fc_bias": rng.randn(3).astype(np.float32)}
    out = {}
    for pkg in (mt, mx):
        with pkg.cpu():
            init = pkg.init.Load({k: pkg.nd.array(v) for k, v in
                                  saved.items()},
                                 default_init=pkg.init.Constant(0.5))
            got = {}
            for name, shape in [("fc_weight", (3, 4)), ("fc_bias", (3,)),
                                ("bn_moving_var", (4,)),
                                ("other_weight", (2,))]:
                arr = pkg.nd.zeros(shape)
                init(pkg.init.InitDesc(name), arr)
                got[name] = arr.asnumpy()
            with pytest.raises(pkg.MXNetError):
                pkg.init.Load({})(pkg.init.InitDesc("x"), pkg.nd.zeros((1,)))
        out[pkg.__name__] = got
    for k, v in out["mxtpu"].items():
        np.testing.assert_array_equal(out["mxtpu_torch"][k], v, err_msg=k)
    np.testing.assert_array_equal(out["mxtpu_torch"]["fc_weight"],
                                  saved["arg:fc_weight"])
    assert (out["mxtpu_torch"]["other_weight"] == 0.5).all()


@pytest.mark.parametrize("name", ["orthogonal", "msraprelu", "bilinear"])
def test_create_and_dumps_as_mxtpu(mt, name):
    got = mt.initializer.create(name)
    want = mx.initializer.create(name)
    assert got.dumps() == want.dumps()

"""KVStore in mxtpu_torch vs mxtpu, on the CPU.

- Every case of mxtpu's ``tests/test_kvstore.py`` run by one body
  through both packages (values exact: they are small integers), every
  kind created in both, ``dist_async`` with no cluster one worker as in
  mxtpu. ``row_sparse_pull`` into a dense and a row_sparse out, and a
  row_sparse gradient pushed through the store's SGD, give mxtpu's rows.
- ``model._create_kvstore``'s decision table against mxtpu's: no store
  for one device unless ``dist``; ``local`` with a parameter over 16 M
  elements updates on the devices.
- The optimizer states through the kvstore: a 2-context Module on the
  kvstore path (the optimizer on the store) saves its states through
  the store, and a fresh Module that loads them continues bit for bit
  as the run that never stopped; both runs within 1e-5 of mxtpu's.
"""
import logging

import numpy as np
import pytest

import mxtpu as mx

SHAPE = (4, 4)
KEYS = [5, 7, 11]
PKGS = ["mxtpu", "mxtpu_torch"]


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


@pytest.fixture(params=PKGS)
def pkg(request, mt):
    """The package under test, inside a ``cpu()`` scope (the port's
    default context is the card)."""
    p = mx if request.param == "mxtpu" else mt
    with p.cpu():
        yield p


def _is_port(p):
    return p.__name__ == "mxtpu_torch"


def test_single_kv_pair(pkg):
    nd = pkg.nd
    store = pkg.kv.create("local")
    store.init(3, nd.ones(SHAPE))
    out = nd.zeros(SHAPE)
    store.pull(3, out=out)
    assert np.array_equal(out.asnumpy(), np.ones(SHAPE))
    store.push(3, nd.ones(SHAPE) * 4)
    store.pull(3, out=out)
    assert np.array_equal(out.asnumpy(), np.full(SHAPE, 4))


def test_aggregation(pkg):
    """Push a list (one per context) -> the values are summed."""
    nd = pkg.nd
    store = pkg.kv.create("local")
    store.init(3, nd.ones(SHAPE))
    devs = [pkg.cpu(i % 2) for i in range(4)]
    store.push(3, [nd.ones(SHAPE, ctx=d) for d in devs])
    out = nd.zeros(SHAPE)
    store.pull(3, out=out)
    assert np.array_equal(out.asnumpy(), np.full(SHAPE, 4))


def test_list_kv_pairs(pkg):
    nd = pkg.nd
    store = pkg.kv.create("local")
    store.init(KEYS, [nd.ones(SHAPE)] * len(KEYS))
    store.push(KEYS, [nd.ones(SHAPE) * 2] * len(KEYS))
    outs = [nd.zeros(SHAPE) for _ in KEYS]
    store.pull(KEYS, out=outs)
    for o in outs:
        assert np.array_equal(o.asnumpy(), np.full(SHAPE, 2))


def test_updater(pkg):
    nd = pkg.nd
    store = pkg.kv.create("local")
    store.init(3, nd.ones(SHAPE))

    def updater(key, recv, stored):
        stored += recv * 2

    store.set_updater(updater)
    store.push(3, nd.ones(SHAPE))
    out = nd.zeros(SHAPE)
    store.pull(3, out=out)
    assert np.array_equal(out.asnumpy(), np.full(SHAPE, 3))  # 1 + 2*1
    store.push(3, [nd.ones(SHAPE)] * 4)
    store.pull(3, out=out)
    assert np.array_equal(out.asnumpy(), np.full(SHAPE, 11))  # 3 + 2*4


def test_optimizer_on_kvstore(pkg):
    """update_on_kvstore: push a gradient, pull the updated weight."""
    nd = pkg.nd
    store = pkg.kv.create("local")
    store.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1,
                                          rescale_grad=1.0))
    store.init(0, nd.ones(SHAPE))
    store.push(0, nd.ones(SHAPE))
    out = nd.zeros(SHAPE)
    store.pull(0, out=out)
    np.testing.assert_allclose(out.asnumpy(), 1 - 0.1, rtol=0, atol=1e-7)


def test_kvstore_types_and_rank(pkg):
    for name in ("local", "device", "dist_sync", "dist_async"):
        store = pkg.kv.create(name)
        assert store.type == name
        assert (store.rank, store.num_workers) == (0, 1)
    store = pkg.kv.create("local")
    assert store.rank == 0
    assert store.num_workers == 1
    with pytest.raises(pkg.MXNetError):
        pkg.kv.create("unknown_type")


def _row_sparse_pulls(pkg, kind):
    """A dense and a row_sparse pull of rows [2, 0, 2], then a row_sparse
    gradient pushed through SGD and the rows pulled again."""
    nd = pkg.nd
    store = pkg.kv.create(kind)
    store.init("emb", nd.array(np.arange(12).reshape(4, 3).astype("f4")))
    out = nd.zeros((4, 3))
    rows = nd.array(np.array([2., 0., 2.]))
    store.row_sparse_pull("emb", out=out, row_ids=rows)
    sp = nd.sparse.zeros("row_sparse", (4, 3))
    store.row_sparse_pull("emb", out=sp, row_ids=rows)
    got = [out.asnumpy(), sp.indices.asnumpy(), sp.data.asnumpy(),
           sp.asnumpy()]
    store.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5,
                                          rescale_grad=1.0))
    grad = nd.array(np.array([[0, 0, 0], [1, 2, 3], [0, 0, 0], [4, 5, 6]],
                             "f4")).tostype("row_sparse")
    store.push("emb", grad)
    after = nd.sparse.zeros("row_sparse", (4, 3))
    store.row_sparse_pull("emb", out=after, row_ids=nd.array(
        np.array([3., 1.])))
    return got + [grad.indices.asnumpy(), after.indices.asnumpy(),
                  after.data.asnumpy(), after.stype]


@pytest.mark.parametrize("kind", ["local", "device", "dist_sync",
                                  "dist_device_sync"])
def test_row_sparse_pull(mt, kind):
    with mx.cpu():
        want = _row_sparse_pulls(mx, kind)
    with mt.cpu():
        got = _row_sparse_pulls(mt, kind)
    assert want[1].tolist() == [0, 2] and want[-1] == "row_sparse"
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, str):
            assert g == w
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_push_keeps_the_callers_array_and_pull_writes_in_place(mt):
    """The port's in-place contract: a pushed array of one is not the
    store's, and pull writes into each out's own tensor."""
    with mt.cpu():
        store = mt.kv.create("device")
        store.init("w", mt.nd.ones(SHAPE))
        g = mt.nd.ones(SHAPE) * 3
        store.push("w", g)
        g[:] = 7
        outs = [mt.nd.zeros(SHAPE, ctx=mt.cpu(i)) for i in range(2)]
        held = [o._data for o in outs]
        store.pull("w", out=outs)
    for o, t in zip(outs, held):
        assert o._data is t
        assert np.array_equal(o.asnumpy(), np.full(SHAPE, 3))


class _Sized:
    def __init__(self, size):
        self.size = size


# (kvstore, devices, largest parameter's elements)
DECISIONS = [(None, 1, 10), (None, 2, 10), ("local", 1, 10),
             ("device", 1, 10), ("local", 2, 10), ("device", 2, 10),
             ("local", 2, 16 * 1024 * 1024 + 1),
             ("device", 2, 16 * 1024 * 1024 + 1),
             ("local", 2, 16 * 1024 * 1024), ("dist_sync", 1, 10),
             ("dist_device_sync", 1, 16 * 1024 * 1024 + 1),
             ("dist_sync", 2, 10)]


@pytest.mark.parametrize("kvstore,devices,size", DECISIONS,
                         ids=["%s-%d-%d" % d for d in DECISIONS])
def test_create_kvstore_decides_as_mxtpu(mt, kvstore, devices, size):
    from mxtpu import model as jmodel
    params = {"a": _Sized(3), "b": _Sized(size)}
    jkv, jup = jmodel._create_kvstore(kvstore, devices, params)
    tkv, tup = mt.model._create_kvstore(kvstore, devices, params)
    assert (tkv is None) == (jkv is None)
    assert tup == jup
    if tkv is not None:
        assert tkv.type == jkv.type == kvstore
    given = mt.kv.create("local")
    assert mt.model._create_kvstore(given, 1, params) == (given, True)


def _quiet():
    log = logging.getLogger("quiet")
    log.setLevel(logging.ERROR)
    return log


def _data():
    rng = np.random.RandomState(2)
    x = rng.randn(64, 6).astype(np.float32)
    y = rng.randint(0, 3, 64).astype(np.float32)
    return x, y


W0 = {"fc1_weight": np.random.RandomState(5).randn(8, 6)
      .astype(np.float32) * 0.3,
      "fc1_bias": np.zeros(8, np.float32),
      "fc2_weight": np.random.RandomState(6).randn(3, 8)
      .astype(np.float32) * 0.3,
      "fc2_bias": np.zeros(3, np.float32)}


def _net(pkg):
    s = pkg.sym
    h = s.FullyConnected(s.Variable("data"), num_hidden=8, name="fc1")
    h = s.Activation(h, act_type="tanh")
    h = s.FullyConnected(h, num_hidden=3, name="fc2")
    return s.SoftmaxOutput(h, name="softmax")


def _kv_module(pkg, load=None, start=None):
    """A 2-context Module on the kvstore path: Adam has a fused rule, so
    an uneven work_load_list declines the fused step, and "device" puts
    the optimizer on the store, which holds the weights from
    ``init_optimizer`` on (so a resumed run's weights go in first)."""
    mod = pkg.mod.Module(_net(pkg), context=[pkg.cpu(0), pkg.cpu(1)],
                         work_load_list=[1, 1.0000001], logger=_quiet())
    mod.bind(data_shapes=[("data", (16, 6))],
             label_shapes=[("softmax_label", (16,))])
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in (start or W0).items()})
    mod.init_optimizer(kvstore="device", optimizer="adam",
                       optimizer_params={"learning_rate": 0.01})
    if load is not None:
        mod.load_optimizer_states(load)
    return mod


def _steps(pkg, mod, batches):
    for xb, yb in batches:
        mod.forward_backward(pkg.io.DataBatch(
            [pkg.nd.array(xb, ctx=pkg.cpu())],
            [pkg.nd.array(yb, ctx=pkg.cpu())]))
        mod.update()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_optimizer_states_through_the_kvstore(mt, tmp_path):
    x, y = _data()
    batches = [(x[i:i + 16], y[i:i + 16]) for i in range(0, 64, 16)]
    ref = _kv_module(mx)
    jw = _steps(mx, ref, batches)
    whole = _kv_module(mt)
    assert whole._fused is None and whole._update_on_kvstore
    tw = _steps(mt, whole, batches)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    first = _kv_module(mt)
    _steps(mt, first, batches[:2])
    fname = str(tmp_path / "kv.states")
    first.save_optimizer_states(fname)
    second = _kv_module(mt, load=fname, start={
        k: v.asnumpy() for k, v in first.get_params()[0].items()})
    # Adam's bias correction counts the steps the optimizer has taken
    second._optimizer._index_update_count = dict(
        first._optimizer._index_update_count)
    second._optimizer.num_update = first._optimizer.num_update
    got = _steps(mt, second, batches[2:])
    for k in tw:
        np.testing.assert_array_equal(got[k], tw[k], err_msg=k)

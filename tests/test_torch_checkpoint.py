"""Checkpoints in mxtpu_torch against mxtpu's, on the CPU.

- ``nd.save`` / ``nd.load`` in both directions between the packages, bit
  for bit: float32, float16, bfloat16 and int32, as a list and as a dict.
- ``Symbol.save`` / ``symbol.load`` in both directions.
- A resnet-8 ``Module.save_checkpoint`` from each package loaded by the
  other's ``Module.load``: params and moving statistics bit for bit, and
  the manifests' keys equal.
- Kill-and-resume within the port, on mlp and on resnet-8, through the
  fused update and through the Updater: train one epoch, checkpoint with
  the optimizer states, ``Module.load(prefix, 1,
  load_optimizer_states=True)`` and train the second; the weights and
  statistics are bit for bit those of a run that was never stopped.
- ``async_write=True`` raises (the asynchronous writer is not ported).
"""
import json
import logging
import os

import numpy as np
import pytest

import mxtpu as mx


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(2)
    import mxtpu_torch
    return mxtpu_torch


def _quiet():
    log = logging.getLogger("quiet")
    log.setLevel(logging.ERROR)
    return log


DTYPES = ["float32", "float16", "bfloat16", "int32"]


def _arrays():
    rng = np.random.RandomState(0)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = [(3, 4), (5,), (2, 3, 2), (7, 1)][i]
        v = rng.randn(*shape) * 100
        out[dt] = v.astype(np.int32) if dt == "int32" else \
            v.astype(np.float32)
    return out


def _bits(a):
    """The raw bits of a numpy array (bfloat16 as 16-bit words)."""
    return np.ascontiguousarray(a).view(
        {2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _mx_array(v, dt):
    return mx.nd.array(v, dtype=dt)


def _mt_array(mt, v, dt):
    return mt.nd.array(v, ctx=mt.cpu(), dtype=dt)


def _mt_bits(arr):
    import torch
    t = arr._data
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


@pytest.mark.parametrize("as_dict", [False, True], ids=["list", "dict"])
def test_nd_files_cross_between_the_packages_bit_for_bit(mt, tmp_path,
                                                         as_dict):
    arrays = _arrays()
    mx_in = {dt: _mx_array(v, dt) for dt, v in arrays.items()}
    mt_in = {dt: _mt_array(mt, v, dt) for dt, v in arrays.items()}
    for writer, reader in (("mt", "mx"), ("mx", "mt")):
        fname = str(tmp_path / ("%s-%d.nd" % (writer, as_dict)))
        src = mt_in if writer == "mt" else mx_in
        data = dict(src) if as_dict else [src[dt] for dt in DTYPES]
        (mt.nd.save if writer == "mt" else mx.nd.save)(fname, data)
        got = (mt.nd.load if reader == "mt" else mx.nd.load)(fname)
        if not as_dict:
            assert isinstance(got, list) and len(got) == len(DTYPES)
            got = dict(zip(DTYPES, got))
        assert sorted(got) == sorted(DTYPES)
        for dt in DTYPES:
            want = _mt_bits(mt_in[dt])
            have = _mt_bits(got[dt]) if reader == "mt" else \
                _bits(np.asarray(got[dt]._data))
            assert have.shape == want.shape, (writer, dt)
            np.testing.assert_array_equal(have, want, err_msg=dt)
            if reader == "mt":
                assert got[dt].context == mt.cpu()
                assert str(got[dt]._data.dtype).endswith(dt)
    with open(fname, "rb") as f:  # a binary file object
        assert len(mt.nd.load(f)) == len(DTYPES)


def test_nd_load_refuses_another_format(mt, tmp_path):
    bad = tmp_path / "bad.nd"
    bad.write_bytes(b"NOTMXTPU" + b"\0" * 8)
    with pytest.raises(mt.MXNetError, match="invalid"):
        mt.nd.load(str(bad))


def test_symbol_files_cross_between_the_packages(mt, tmp_path):
    tsym = mt.models.get_resnet(10, 8, (3, 28, 28))
    jsym = mx.models.resnet.get_symbol(10, 8, (3, 28, 28))
    tsym.save(str(tmp_path / "t-symbol.json"))
    jsym.save(str(tmp_path / "j-symbol.json"))
    from_t = mt.sym.load(str(tmp_path / "t-symbol.json"))
    from_j = mt.sym.load(str(tmp_path / "j-symbol.json"))
    back = mx.sym.load(str(tmp_path / "t-symbol.json"))
    assert from_t.tojson() == tsym.tojson()
    assert json.loads(from_j.tojson())["nodes"] == \
        json.loads(jsym.tojson())["nodes"]
    assert json.loads(back.tojson())["nodes"] == \
        json.loads(tsym.tojson())["nodes"]
    assert from_j.list_outputs() == jsym.list_outputs()


def _resnet8_module(pkg, ctx, seed=4):
    mod = pkg.mod.Module(pkg.models.get_resnet(10, 8, (3, 28, 28))
                         if pkg is not mx else
                         mx.models.resnet.get_symbol(10, 8, (3, 28, 28)),
                         context=ctx, logger=_quiet())
    mod.bind(data_shapes=[("data", (8, 3, 28, 28))],
             label_shapes=[("softmax_label", (8,))])
    return mod


def _numpy_params(mod):
    return [{k: _bits(v.asnumpy()) for k, v in d.items()}
            for d in mod.get_params()]


def test_module_checkpoints_cross_between_the_packages(mt, tmp_path):
    # mxtpu's weights with statistics that are not its init's
    jmod = _resnet8_module(mx, mx.cpu())
    mx.random.seed(4)
    jmod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
    w0, a0 = [{k: v.asnumpy() for k, v in d.items()}
              for d in jmod.get_params()]
    rng = np.random.RandomState(5)
    a0 = {k: (rng.randn(*v.shape) * 0.1).astype(np.float32)
          for k, v in a0.items()}
    jmod.set_params({k: mx.nd.array(v) for k, v in w0.items()},
                    {k: mx.nd.array(v) for k, v in a0.items()})
    tmod = _resnet8_module(mt, mt.cpu())
    tmod.init_params(arg_params=mt.convert.params_from_mxtpu(w0, "cpu"),
                     aux_params=mt.convert.params_from_mxtpu(a0, "cpu"))
    jpre, tpre = str(tmp_path / "jx"), str(tmp_path / "pt")
    jmod.save_checkpoint(jpre, 3)
    tmod.save_checkpoint(tpre, 3)
    for name in ("-symbol.json", "-0003.params",
                 "-0003.params.manifest.json"):
        assert os.path.exists(tpre + name), name
    jman = json.load(open(jpre + "-0003.params.manifest.json"))
    tman = json.load(open(tpre + "-0003.params.manifest.json"))
    assert sorted(jman) == sorted(tman)
    for k in ("format", "version", "epoch", "params", "aux", "arrays"):
        assert jman[k] == tman[k], k

    want = _numpy_params(tmod)
    t_from_j = mt.mod.Module.load(jpre, 3, context=mt.cpu(),
                                  logger=_quiet())
    t_from_j.bind(data_shapes=[("data", (8, 3, 28, 28))],
                  label_shapes=[("softmax_label", (8,))])
    j_from_t = mx.mod.Module.load(tpre, 3, context=mx.cpu(),
                                  logger=_quiet())
    j_from_t.bind(data_shapes=[("data", (8, 3, 28, 28))],
                  label_shapes=[("softmax_label", (8,))])
    for got in (_numpy_params(t_from_j), _numpy_params(j_from_t)):
        for have, ref in zip(got, want):
            assert sorted(have) == sorted(ref)
            for k in ref:
                np.testing.assert_array_equal(have[k], ref[k], err_msg=k)
    # and what it serves is what the live module serves
    x = np.random.RandomState(6).rand(8, 3, 28, 28).astype(np.float32)
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())])
    for mod in (tmod, t_from_j):
        mod.forward(batch, is_train=False)
    np.testing.assert_array_equal(t_from_j.get_outputs()[0].asnumpy(),
                                  tmod.get_outputs()[0].asnumpy())


def _data(model, n=128):
    rng = np.random.RandomState(0)
    shape = (n, 3, 28, 28) if model == "resnet8" else (n, 20)
    return (rng.rand(*shape).astype(np.float32),
            rng.randint(0, 10, n).astype(np.float32))


def _sym(mt, model):
    return mt.models.get_resnet(10, 8, (3, 28, 28)) if model == "resnet8" \
        else mt.models.get_mlp(10)


@pytest.mark.parametrize("path", ["fused", "updater"])
@pytest.mark.parametrize("model", ["mlp", "resnet8"])
def test_kill_and_resume_is_bit_exact(mt, tmp_path, model, path):
    import torch

    class SGDByUpdater(mt.optimizer.SGD):
        pass

    x, y = _data(model)

    def opt():
        kw = dict(learning_rate=0.1, momentum=0.9, rescale_grad=1.0 / 32)
        return mt.optimizer.SGD(**kw) if path == "fused" else \
            SGDByUpdater(**kw)

    def fit(mod, **kw):
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=32), optimizer=opt(),
                initializer=mt.init.Xavier(), **kw)
        assert (mod._fused is not None) == (path == "fused")

    np.random.seed(7)
    whole = mt.mod.Module(_sym(mt, model), context=mt.cpu(),
                          logger=_quiet())
    fit(whole, num_epoch=2)

    np.random.seed(7)
    first = mt.mod.Module(_sym(mt, model), context=mt.cpu(),
                          logger=_quiet())
    prefix = str(tmp_path / model)
    fit(first, num_epoch=1)
    first.save_checkpoint(prefix, 1, save_optimizer_states=True)
    del first  # the kill
    resumed = mt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                 context=mt.cpu(), logger=_quiet())
    fit(resumed, begin_epoch=1, num_epoch=2)

    for want, got in zip(whole.get_params(), resumed.get_params()):
        assert sorted(want) == sorted(got)
        for k in want:
            assert torch.equal(want[k]._data, got[k]._data), k


def test_async_write_raises(mt, tmp_path):
    """``async_write`` no longer raises: the Module's and
    ``model.save_checkpoint``'s async writes land through the snapshot
    writer, with the manifest and the optimizer states, and load in
    both packages bit for bit."""
    mod = mt.mod.Module(mt.models.get_mlp(4), context=mt.cpu(),
                        logger=_quiet())
    mod.bind(data_shapes=[("data", (2, 5))],
             label_shapes=[("softmax_label", (2,))])
    mod.init_params()
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    assert mod._fused is not None
    prefix = str(tmp_path / "a")
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True,
                        async_write=True)
    mt.model.save_checkpoint(str(tmp_path / "b"), 1, mod.symbol,
                             *mod.get_params(), async_write=True)
    mt.model.wait_checkpoints()
    live = mod.get_params()[0]
    for p in (prefix, str(tmp_path / "b")):
        for load in (mt.model.load_checkpoint, mx.model.load_checkpoint):
            _, args, _ = load(p, 1)
            assert sorted(args) == sorted(live)
            for k, v in args.items():
                np.testing.assert_array_equal(v.asnumpy(),
                                              live[k].asnumpy(), err_msg=k)
        man = json.load(open(p + "-0001.params.manifest.json"))
        assert man["format"] == "mxtpu-checkpoint-1"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    mod.load_optimizer_states(prefix + "-0001.states")
    theirs = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                context=mx.cpu())
    theirs.bind(data_shapes=[("data", (2, 5))],
                label_shapes=[("softmax_label", (2,))])
    theirs.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    got = theirs._fused.export_opt_state()
    want = mod._fused.export_opt_state()
    assert sorted(got) == sorted(want)
    for idx in want:
        np.testing.assert_array_equal(got[idx], want[idx])


def test_do_checkpoint_and_params_files(mt, tmp_path):
    """``do_checkpoint`` writes what ``fit`` hands it every ``period``
    epochs; ``save_params`` / ``load_params`` carry a module's values."""
    x, y = _data("mlp", 64)
    prefix = str(tmp_path / "m")
    np.random.seed(1)
    mod = mt.mod.Module(mt.models.get_mlp(10), context=mt.cpu(),
                        logger=_quiet())
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=32), num_epoch=4,
            initializer=mt.init.Xavier(),
            epoch_end_callback=mt.callback.do_checkpoint(prefix, period=2))
    assert sorted(os.listdir(tmp_path)) == [
        "m-0002.params", "m-0002.params.manifest.json", "m-0004.params",
        "m-0004.params.manifest.json", "m-symbol.json"]
    sym, args, auxs = mt.model.load_checkpoint(prefix, 4)
    assert sym.tojson() == mod.symbol.tojson()
    live = mod.get_params()[0]
    for k in live:
        np.testing.assert_array_equal(args[k].asnumpy(), live[k].asnumpy())
    mod.save_params(str(tmp_path / "p.params"))
    other = mt.mod.Module(mt.models.get_mlp(10), context=mt.cpu(),
                          logger=_quiet())
    other.bind(data_shapes=[("data", (32, 20))],
               label_shapes=[("softmax_label", (32,))])
    other.init_params()
    other.load_params(str(tmp_path / "p.params"))
    for k, v in other.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(), live[k].asnumpy())

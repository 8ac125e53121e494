"""KVStore ``dist_sync`` over several processes in mxtpu_torch, on the CPU.

Two worker processes join a gloo group from torch's ``env://`` variables
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and each
fits an mlp on its half of every batch through ``Module.fit(kvstore=
<a dist_sync KVStore>)``: the summed gradient is all-reduced over the
processes, the optimizer runs on every worker, ``rescale_grad`` is
1/(global batch). The result must equal one process on the whole batch
within 1e-6 (the same sums in another order), in the port and in
mxtpu's one-process run (within 1e-5), and the two workers' weights must
be bit-identical. Without the variables a ``dist_sync`` store is one
worker, as mxtpu's is; ``dist_async`` raises.
"""
import json
import logging
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
BATCH = 16  # global: each of the 2 workers takes 8 rows of each batch
EPOCHS = 2
OPT = {"learning_rate": 0.1, "momentum": 0.9}

WORKER = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, %(repo)r)
import torch
torch.set_num_threads(1)
import mxtpu_torch as mt
sys.path.insert(0, %(tests)r)
from test_torch_dist_kvstore import data, net, w0, worker_rows
rank = int(os.environ["RANK"])
x, y = data()
xr, yr = worker_rows(x, y, rank, 2)
kv = mt.kv.create("dist_sync")
mod = mt.mod.Module(net(mt), context=mt.cpu())
mod.fit(mt.io.NDArrayIter(xr, yr, batch_size=%(half)d), num_epoch=%(epochs)d,
        kvstore=kv, optimizer="sgd", optimizer_params=%(opt)r,
        arg_params={k: mt.nd.array(v, ctx=mt.cpu()) for k, v in w0().items()})
w = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
np.savez(os.path.join(%(out)r, "rank%%d.npz" %% rank), **w)
print(json.dumps({"rank": kv.rank, "num_workers": kv.num_workers,
                  "fused": mod._fused is not None,
                  "rescale": mod._optimizer.rescale_grad}))
kv.barrier()
torch.distributed.destroy_process_group()
"""


def data():
    rng = np.random.RandomState(4)
    x = rng.randn(64, 6).astype(np.float32)
    y = rng.randint(0, 3, 64).astype(np.float32)
    return x, y


def w0():
    rng = np.random.RandomState(5)
    return {"fc1_weight": (rng.randn(8, 6) * 0.3).astype(np.float32),
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": (rng.randn(3, 8) * 0.3).astype(np.float32),
            "fc2_bias": np.zeros(3, np.float32)}


def net(pkg):
    s = pkg.sym
    h = s.FullyConnected(s.Variable("data"), num_hidden=8, name="fc1")
    h = s.Activation(h, act_type="relu")
    h = s.FullyConnected(h, num_hidden=3, name="fc2")
    return s.SoftmaxOutput(h, name="softmax")


def worker_rows(x, y, rank, world):
    """Worker ``rank``'s rows: its 1/world of each global batch."""
    half = BATCH // world
    idx = np.concatenate([np.arange(i + rank * half, i + (rank + 1) * half)
                          for i in range(0, len(x), BATCH)])
    return x[idx], y[idx]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _quiet():
    log = logging.getLogger("quiet")
    log.setLevel(logging.ERROR)
    return log


def _whole(pkg):
    x, y = data()
    mod = pkg.mod.Module(net(pkg), context=pkg.cpu(), logger=_quiet())
    mod.fit(pkg.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=EPOCHS,
            optimizer="sgd", optimizer_params=OPT,
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in w0().items()})
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


def test_dist_sync_over_two_gloo_workers_is_the_whole_batch(mt, tmp_path):
    code = WORKER % {"repo": str(REPO), "tests": str(REPO / "tests"),
                     "half": BATCH // 2, "epochs": EPOCHS, "opt": OPT,
                     "out": str(tmp_path)}
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH="")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, o in enumerate(outs):
        assert o == {"rank": rank, "num_workers": 2, "fused": False,
                     "rescale": 1.0 / BATCH}
    got = [dict(np.load(tmp_path / ("rank%d.npz" % r))) for r in range(2)]
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
    import mxtpu as mx  # here: the workers import this module, not jax
    whole = _whole(mt)
    ref = _whole(mx)
    for k in whole:
        np.testing.assert_allclose(got[0][k], whole[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(got[0][k], ref[k], rtol=0, atol=1e-5,
                                   err_msg=k)
        assert np.abs(got[0][k] - w0()[k]).max() > 1e-3  # it trained


def test_dist_store_without_a_cluster_is_one_worker(mt, monkeypatch):
    import mxtpu as mx
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for name in ("dist_sync", "dist_device_sync"):
        kv = mt.kv.create(name)
        assert (kv.type, kv.rank, kv.num_workers) == (name, 0, 1)
        kv.barrier()
        jkv = mx.kv.create(name)
        assert (jkv.rank, jkv.num_workers) == (0, 1)
    with pytest.raises(mt.MXNetError, match="dist_async"):
        mt.kv.create("dist_async")

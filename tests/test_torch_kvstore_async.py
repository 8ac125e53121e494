"""The port's TCP parameter server and ``dist_async``, against mxtpu's.

mxtpu's tests/test_dist_kvstore.py cases, run on the port's
``mxtpu_torch.kvstore_server`` with worker processes on this host (the
launch layout: ``MXTPU_ROLE=worker``): push and pull that do not wait,
then a barrier (:99-118); the server-side optimizer (:94); ``num_dead_node``
after a SIGKILL (:206), with a 0.2 s heartbeat and a 5 s timeout, so a
live worker would have to miss 25 pings to be counted dead; the TCP
``row_sparse_pull`` (:280). Then ``dist_async`` in a torch.distributed
job from ``env://`` (rank 0 hosts the server; a worker's push is
visible to its own next pull while the other worker waits), a store with
no cluster (one worker), and the wire format across the packages: mxtpu's
``KVServer`` serving the port's ``KVClient`` and the reverse. Every
subprocess has a timeout of its own.
"""
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _env(**kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    for v in ("MXTPU_ROLE", "DMLC_ROLE", "WORLD_SIZE", "RANK",
              "MASTER_ADDR", "MASTER_PORT", "MXTPU_ASYNC_PS_URI",
              "MXTPU_ASYNC_PS_PORT"):
        env.pop(v, None)
    env.update(kw)
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _communicate(procs, timeout=TIMEOUT):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode())
            assert p.returncode == 0, out.decode()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _cluster(src, n=2, **env):
    """The port's server in a thread and ``n`` worker processes running
    ``src`` under the launch environment."""
    from mxtpu_torch.kvstore_server import KVServer
    server = KVServer(0, n)
    server.run_in_thread()
    base = _env(MXTPU_ROOT_URI="127.0.0.1", MXTPU_ROOT_PORT=str(server.port),
                MXTPU_NUM_WORKERS=str(n), MXTPU_ROLE="worker", **env)
    procs = [subprocess.Popen([sys.executable, "-c", src],
                              env=dict(base, MXTPU_WORKER_ID=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(n)]
    return _communicate(procs), server


HEAD = "import numpy as np\nimport mxtpu_torch as mt\nctx = mt.cpu()\n"


def test_dist_async_push_pull_do_not_wait_then_a_barrier():
    """mxtpu's :99-118: a worker's pull after its own push returns at
    once with its push applied, whatever the other worker has done."""
    src = HEAD + textwrap.dedent("""
        kv = mt.kv.create("dist_async")
        kv.init(1, mt.nd.zeros((2,), ctx=ctx))
        kv.push(1, mt.nd.ones((2,), ctx=ctx))
        out = mt.nd.zeros((2,), ctx=ctx)
        kv.pull(1, out=out)
        assert out.asnumpy().sum() >= 2.0, out.asnumpy()
        kv.barrier()
        kv.close()
        print("WORKER_OK")
    """)
    outs, server = _cluster(src)
    assert all("WORKER_OK" in o for o in outs)
    # async with no updater: each push is stored as it comes
    assert server.sync_mode is False and server.versions[1] == 2
    np.testing.assert_array_equal(server.store[1], [1.0, 1.0])


def test_dist_sync_server_side_optimizer():
    """mxtpu's :94: the optimizer pickled to the server runs there once a
    round: w -= 0.5 * sum of the workers' gradients."""
    src = HEAD + textwrap.dedent("""
        kv = mt.kv.create("dist_sync")
        nw = kv.num_workers
        kv.init(7, mt.nd.zeros((2, 2), ctx=ctx))
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.5,
                                          rescale_grad=1.0))
        kv.barrier()
        kv.push(7, mt.nd.ones((2, 2), ctx=ctx))
        out = mt.nd.zeros((2, 2), ctx=ctx)
        kv.pull(7, out=out)
        assert np.allclose(out.asnumpy(), -0.5 * nw), out.asnumpy()
        kv.barrier()
        kv.close()
        print("WORKER_OK", kv.rank)
    """)
    outs, server = _cluster(src)
    assert sorted(o.split()[-1] for o in outs) == ["0", "1"]
    assert server.updater is not None and server.versions[7] == 1


def test_num_dead_node_after_a_sigkill():
    """mxtpu's :206: SIGKILL one worker; the survivor's num_dead_node
    rises to 1 once it has been silent for the timeout, and was 0 while
    both were alive; a clean close is never dead."""
    from mxtpu_torch.kvstore_server import KVServer
    server = KVServer(0, 2)
    server.run_in_thread()
    env = _env(MXTPU_ROOT_URI="127.0.0.1", MXTPU_ROOT_PORT=str(server.port),
               MXTPU_NUM_WORKERS="2", MXTPU_ROLE="worker",
               MXTPU_HEARTBEAT_INTERVAL="0.2")
    victim = HEAD + textwrap.dedent("""
        import time
        kv = mt.kv.create("dist_sync")
        print("VICTIM_UP", flush=True)
        time.sleep(600)
    """)
    watcher = HEAD + textwrap.dedent("""
        import sys, time
        kv = mt.kv.create("dist_sync")  # both heartbeat before its barrier
        assert kv.num_dead_node(timeout=5.0) == 0, "false positive"
        print("BOTH_ALIVE", flush=True)
        sys.stdin.readline()  # the victim is killed
        deadline = time.time() + 60
        while time.time() < deadline:
            if kv.num_dead_node(timeout=5.0) == 1:
                print("DEAD_DETECTED", flush=True)
                kv.close()
                sys.exit(0)
            time.sleep(0.3)
        print("NEVER_DETECTED", flush=True)
        sys.exit(1)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", src],
                              env=dict(env, MXTPU_WORKER_ID=str(r)),
                              stdin=subprocess.PIPE,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r, src in enumerate((victim, watcher))]
    v, w = procs
    try:
        assert b"VICTIM_UP" in v.stdout.readline()
        line = w.stdout.readline()
        assert b"BOTH_ALIVE" in line, line + w.stdout.read()
        v.send_signal(signal.SIGKILL)
        v.wait(timeout=30)
        t0 = time.time()
        out, _ = w.communicate(b"killed\n", timeout=TIMEOUT)
        assert w.returncode == 0, out.decode()
        assert "DEAD_DETECTED" in out.decode(), out.decode()
        assert time.time() - t0 < 60
        assert server.stopped_ranks == {1}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_dist_row_sparse_pull_ships_the_rows():
    """mxtpu's :280: a row_sparse out pulls only its rows of the
    server's value after a push round."""
    src = HEAD + textwrap.dedent("""
        kv = mt.kv.create("dist_sync")
        nw = kv.num_workers
        shape = (8, 3)
        kv.init(5, mt.nd.array(np.arange(24, dtype="float32")
                               .reshape(shape), ctx=ctx))
        kv.push(5, mt.nd.ones(shape, ctx=ctx))
        out = mt.nd.sparse.zeros("row_sparse", shape, ctx=ctx)
        rows = mt.nd.array(np.array([6.0, 1.0, 4.0, 1.0], "float32"),
                           ctx=ctx)
        kv.row_sparse_pull(5, out=out, row_ids=rows)
        expect = np.zeros(shape, "float32")
        expect[[1, 4, 6]] = nw
        assert np.allclose(out.asnumpy(), expect), out.asnumpy()
        assert out.indices.asnumpy().tolist() == [1, 4, 6]
        dense = mt.nd.zeros(shape, ctx=ctx)
        kv.row_sparse_pull(5, out=dense, row_ids=rows)
        assert np.allclose(dense.asnumpy(), nw)
        kv.barrier()
        kv.close()
        print("WORKER_OK")
    """)
    outs, _ = _cluster(src)
    assert all("WORKER_OK" in o for o in outs)


def test_dist_async_over_env_rank0_hosts_the_server():
    """Two torch.distributed ranks from env:// (gloo): rank 0 hosts the
    async server (at MXTPU_ASYNC_PS_PORT); rank 1 pushes and sees its push
    while rank 0 waits at a barrier it reaches after; both then train the
    mlp through fit(kvstore="dist_async") to finite weights, every push
    counted by the server's versions."""
    src = HEAD + textwrap.dedent("""
        import os
        kv = mt.kv.create("dist_async")
        r, n = kv.rank, kv.num_workers
        assert n == 2 and (kv._server is not None) == (r == 0)
        kv.init(0, mt.nd.zeros((3,), ctx=ctx))
        if r == 1:  # with no updater each push is stored as it comes
            for i in range(3):
                kv.push(0, mt.nd.ones((3,), ctx=ctx) * (i + 1))
                out = mt.nd.zeros((3,), ctx=ctx)
                kv.pull(0, out=out)
                assert out.asnumpy()[0] == i + 1, out.asnumpy()
        kv.barrier()
        out = mt.nd.zeros((3,), ctx=ctx)
        kv.pull(0, out=out)
        assert out.asnumpy()[0] == 3.0, out.asnumpy()
        rng = np.random.RandomState(r)
        x = rng.rand(64, 20).astype("float32")
        y = rng.randint(0, 4, 64).astype("float32")
        mod = mt.mod.Module(mt.models.get_mlp(4), context=ctx)
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
                kvstore=kv, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                initializer=mt.init.Xavier())
        w = mod.get_params()[0]
        assert all(np.isfinite(v.asnumpy()).all() for v in w.values())
        kv.barrier()
        if r == 0:
            keys = [k for k in kv._server.versions if k != 0]
            print("VERSIONS", sorted(kv._server.versions[k] for k in keys))
        kv.close()
        print("WORKER_OK", r)
    """)
    port, ps_port = _free_port(), _free_port()
    # the server's port named (MXTPU_ASYNC_PS_*) rather than derived as
    # MASTER_PORT + 1000, which another process on the host may hold
    env = _env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", MXTPU_ASYNC_PS_URI="127.0.0.1",
               MXTPU_ASYNC_PS_PORT=str(ps_port))
    procs = [subprocess.Popen([sys.executable, "-c", src],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    outs = _communicate(procs)
    assert all("WORKER_OK" in o for o in outs)
    versions = [line for line in outs[0].splitlines()
                if line.startswith("VERSIONS")][0]
    # 2 workers x 2 epochs x 4 batches, each push applied on its own
    assert set(eval(versions.split(" ", 1)[1])) == {16}


def test_dist_async_without_a_cluster_is_one_worker(monkeypatch):
    import mxtpu_torch as mt
    for v in ("WORLD_SIZE", "MXTPU_ROLE", "DMLC_ROLE"):
        monkeypatch.delenv(v, raising=False)
    kv = mt.kv.create("dist_async")
    assert (kv.type, kv.rank, kv.num_workers) == ("dist_async", 0, 1)
    assert kv._client is None and kv.num_dead_node() == 0
    kv.init(3, mt.nd.ones((2,), ctx=mt.cpu()))
    kv.push(3, mt.nd.ones((2,), ctx=mt.cpu()) * 4)
    out = mt.nd.zeros((2,), ctx=mt.cpu())
    kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), [4.0, 4.0])
    kv.barrier()
    kv.close()


def _wire_case(server_cls, client_cls):
    server = server_cls(0, 1)
    server.run_in_thread()
    client = client_cls("127.0.0.1", server.port)
    client.start_heartbeat(0, interval=0.2)
    value = np.arange(12, dtype="float32").reshape(4, 3)
    client.init("w", value, rank=0)
    client.barrier()
    client.push("w", np.ones((4, 3), "float32"))
    np.testing.assert_array_equal(client.pull("w"), np.ones((4, 3)))
    np.testing.assert_array_equal(client.pull_rows("w", [3, 0]),
                                  np.ones((2, 3)))
    client.send_command("sync_mode", False)
    client.push("w", value)
    client.push("w", value * 2)
    np.testing.assert_array_equal(client.pull("w"), value * 2)
    assert client.num_dead_node(timeout=30) == 0
    assert server.versions["w"] == 3
    client.stop()
    assert server.stopped_ranks == {0}


def test_the_wire_format_is_mxtpu_s():
    """The frames are the same bytes: mxtpu's KVServer serves the port's
    KVClient, the port's serves mxtpu's, and a message framed by either
    package reads back in the other."""
    import mxtpu.kvstore_server as jkvs
    import mxtpu_torch.kvstore_server as tkvs
    _wire_case(jkvs.KVServer, tkvs.KVClient)
    _wire_case(tkvs.KVServer, jkvs.KVClient)
    msg = ("PUSH", "w", np.arange(6, dtype="float32").reshape(2, 3))
    for send, recv in ((jkvs._send_msg, tkvs._recv_msg),
                       (tkvs._send_msg, jkvs._recv_msg)):
        a, b = socket.socketpair()
        with a, b:
            send(a, msg)
            got = recv(b)
        assert got[:2] == msg[:2]
        np.testing.assert_array_equal(got[2], msg[2])


def test_launch_form_dist_sync_matches_one_process(tmp_path):
    """``python -m mxtpu_torch.kvstore_server`` as the server and two
    workers under MXTPU_ROLE=worker on dist_sync: their weights within
    1e-6 of one process on the whole batch, and the same bits on both."""
    port = _free_port()
    base = _env(MXTPU_ROOT_URI="127.0.0.1", MXTPU_ROOT_PORT=str(port),
                MXTPU_NUM_WORKERS="2")
    src = HEAD + textwrap.dedent("""
        import os, sys
        w0 = {k: mt.nd.array(v, ctx=ctx)
              for k, v in np.load(sys.argv[1]).items()}
        kv = "local"
        if os.environ.get("MXTPU_ROLE") == "worker":
            kv = mt.kv.create("dist_sync")
        rng = np.random.RandomState(0)
        X = rng.rand(64, 20).astype("float32")
        Y = rng.randint(0, 4, 64).astype("float32")
        if kv == "local":
            x, y, b = X, Y, 32
        else:
            # each worker takes its half of every global batch of 32
            idx = np.concatenate([np.arange(s + 16 * kv.rank,
                                            s + 16 * kv.rank + 16)
                                  for s in (0, 32)])
            x, y, b = X[idx], Y[idx], 16
        mod = mt.mod.Module(mt.models.get_mlp(4), context=ctx)
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=b), num_epoch=2,
                kvstore=kv, optimizer="sgd", arg_params=w0,
                optimizer_params={"learning_rate": 0.1,
                                  "rescale_grad": 1.0 / 32})
        got = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        np.savez(sys.argv[2], **got)
        if kv != "local":
            kv.close()
    """)
    import mxtpu_torch as mt
    sym = mt.models.get_mlp(4)
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=(32, 20))[0]))
    rng = np.random.RandomState(1)
    w0 = {k: rng.uniform(-0.3, 0.3, s).astype("float32")
          for k, s in shapes.items() if k not in ("data", "softmax_label")}
    np.savez(tmp_path / "w0.npz", **w0)
    server = subprocess.Popen(
        [sys.executable, "-m", "mxtpu_torch.kvstore_server"],
        env=dict(base, MXTPU_ROLE="server"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", src, str(tmp_path / "w0.npz"),
         str(tmp_path / ("w%d.npz" % r))],
        env=dict(base, MXTPU_ROLE="worker", MXTPU_WORKER_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", src, str(tmp_path / "w0.npz"),
         str(tmp_path / "one.npz")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT))
    _communicate(procs + [server])
    w = [np.load(tmp_path / ("w%d.npz" % r)) for r in range(2)]
    one = np.load(tmp_path / "one.npz")
    for k in one.files:
        np.testing.assert_array_equal(w[0][k], w[1][k], err_msg=k)
        np.testing.assert_allclose(w[0][k], one[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        assert np.abs(one[k] - w0[k]).max() > 1e-3, k

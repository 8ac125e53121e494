"""The distributed KVStore's transport: a TCP parameter server and its
worker client.

The port's own copy of ``mxtpu/kvstore_server.py`` (frames :54-93,
``KVServer`` :95-331, ``KVClient`` :333-437, ``cluster_env`` and
``_init_kvstore_server_module``), the ps-lite + KVStoreDistServer design
over a plain TCP socket:

- a frame is ``[payload length][buffer count]`` (``<QI``), one ``<Q``
  length a buffer, the pickle-5 payload, then each raw buffer: array
  bytes travel out of band (``buffer_callback``) and land in
  preallocated buffers. The bytes are mxtpu's, so either package's
  client talks to either package's server.
- sync mode: the pushes of a key are summed until every worker has
  pushed, then the server applies its updater once (or stores the sum);
  a pull waits for the round its worker pushed to. Async mode: every push
  applies at once, a pull never waits.
- ``init`` keeps the lowest rank's value (rank 0 wins, whatever order the
  workers' INITs arrive in), never after a push round.
- ``set_optimizer`` pickles the optimizer to the server
  (``COMMAND set_optimizer``); barriers; heartbeats and ``num_dead``
  (a rank silent longer than the timeout, excluding clean STOPs);
  ``pull_rows`` ships only the requested rows of a row_sparse weight.

Values travel as numpy arrays on the host; the server's updater runs on
the port's NDArray on the CPU. The cluster environment is mxtpu's
(``MXTPU_ROLE`` worker | server, ``MXTPU_ROOT_URI``/``MXTPU_ROOT_PORT``,
``MXTPU_NUM_WORKERS``, ``MXTPU_WORKER_ID``; the ``DMLC_*`` names are
honoured). A server process runs as

    MXTPU_ROLE=server MXTPU_ROOT_PORT=9091 MXTPU_NUM_WORKERS=2 \\
        python -m mxtpu_torch.kvstore_server

and serves until every worker has stopped it; workers then create a
``dist_*`` store with ``MXTPU_ROLE=worker``.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import sys
import threading
import time

import numpy as _np

from .analysis import concurrency as _conc
from .base import MXNetError

__all__ = ["KVServer", "KVClient", "cluster_env"]

_HDR = struct.Struct("<Q")
_FRAME = struct.Struct("<QI")


def _send_msg(sock, obj):
    bufs = []
    payload = pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]
    head = [_FRAME.pack(len(payload), len(raws))]
    head += [_HDR.pack(r.nbytes) for r in raws]
    head.append(payload)
    sock.sendall(b"".join(head))
    for r in raws:
        sock.sendall(r)


def _recv_into(sock, view):
    n = len(view)
    off = 0
    while off < n:
        got = sock.recv_into(view[off:], n - off)
        if got == 0:
            raise ConnectionError("kvstore peer closed")
        off += got


def _recv_exact(sock, n):
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf))
    return bytes(buf)


def _recv_msg(sock):
    payload_len, nbuf = _FRAME.unpack(_recv_exact(sock, _FRAME.size))
    sizes = [_HDR.unpack(_recv_exact(sock, _HDR.size))[0]
             for _ in range(nbuf)]
    payload = _recv_exact(sock, payload_len)
    bufs = []
    for sz in sizes:
        b = bytearray(sz)
        _recv_into(sock, memoryview(b))
        bufs.append(b)
    return pickle.loads(payload, buffers=bufs)


def _key_int(k):
    """An integer key as an int, any other as itself (the local store's
    rule for the updater's index)."""
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


class KVServer:
    """The server role: ``num_workers`` workers push and pull keys;
    ``versions`` counts each key's applied updates."""

    def __init__(self, port, num_workers, host="127.0.0.1"):
        self.num_workers = int(num_workers)
        self.sync_mode = True
        self.store = {}          # key -> numpy value
        self.versions = {}       # key -> applied updates
        self.merge = {}          # key -> [running sum, contributions]
        self.updater = None      # None: the merged value is stored
        self.cv = _conc.condition(owner="KVServer", attr="cv")
        self.barrier_counts = {}
        self.init_ranks = {}     # key -> the lowest rank that set it
        self.heartbeats = {}     # rank -> monotonic time of its last ping
        self._started = time.monotonic()
        self.stopped_ranks = set()
        self.stops_seen = 0
        self._stop = False
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, int(port)))
        self.port = self.sock.getsockname()[1]
        self.sock.listen(self.num_workers + 4)

    # ---------------------------------------------------------- lifecycle
    def run(self):
        """Serve until every worker has sent STOP (blocking)."""
        def acceptor():
            while not self._stop:
                try:
                    conn, _ = self.sock.accept()
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                    1)
                except OSError:
                    break
                threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True).start()

        threading.Thread(target=acceptor, daemon=True).start()
        with self.cv:
            while self.stops_seen < self.num_workers:
                self.cv.wait(timeout=0.5)
        self._stop = True
        try:
            self.sock.close()
        except OSError:
            pass

    def run_in_thread(self):
        t = threading.Thread(target=self.run, daemon=True)
        t.start()
        return t

    # ---------------------------------------------------------- handlers
    _OPS = {"PUSH": "_handle_push", "PULL": "_handle_pull",
            "PULL_ROWS": "_handle_pull_rows", "INIT": "_handle_init",
            "BARRIER": "_handle_barrier", "COMMAND": "_handle_command",
            "HEARTBEAT": "_handle_heartbeat", "NUM_DEAD": "_handle_num_dead"}

    def _serve_conn(self, conn):
        try:
            while True:
                msg = _recv_msg(conn)
                op = msg[0]
                if op == "STOP":
                    with self.cv:
                        self.stops_seen += 1
                        if len(msg) > 1 and msg[1] is not None:
                            self.stopped_ranks.add(int(msg[1]))
                        self.cv.notify_all()
                    _send_msg(conn, ("OK",))
                    return
                handler = self._OPS.get(op)
                _send_msg(conn, getattr(self, handler)(*msg[1:])
                          if handler else ("ERR", "unknown op %s" % op))
        except (ConnectionError, EOFError):
            return

    def _apply(self, key, merged):
        """Run the updater on the stored value, or store ``merged``."""
        if key not in self.store:
            self.store[key] = merged.copy()
        elif self.updater is not None:
            from .context import cpu
            from .ndarray import array
            weight = array(self.store[key], ctx=cpu())
            self.updater(_key_int(key), array(merged, ctx=cpu()), weight)
            self.store[key] = weight.asnumpy()
        else:
            self.store[key] = merged.copy()
        self.versions[key] = self.versions.get(key, 0) + 1

    def _handle_init(self, key, value, rank=0):
        with self.cv:
            prev_rank = self.init_ranks.get(key)
            if (self.versions.get(key, 0) == 0
                    and (prev_rank is None or rank < prev_rank)):
                self.store[key] = _np.asarray(value).copy()
                self.versions.setdefault(key, 0)
                self.init_ranks[key] = rank
            self.cv.notify_all()
        return ("OK",)

    def _handle_push(self, key, value):
        value = _np.asarray(value)
        with self.cv:
            if not self.sync_mode:
                self._apply(key, value)
                self.cv.notify_all()
                return ("OK", self.versions[key])
            acc = self.merge.get(key)
            if acc is None:
                self.merge[key] = [value.astype(_np.float64, copy=True)
                                   if value.dtype.kind == "f" else
                                   value.copy(), 1]
            else:
                acc[0] = acc[0] + value
                acc[1] += 1
            if self.merge[key][1] >= self.num_workers:
                merged, _ = self.merge.pop(key)
                self._apply(key, merged.astype(value.dtype, copy=False))
                self.cv.notify_all()
            return ("OK", self.versions.get(key, 0))

    def _wait_version(self, key, min_version, what):
        """Under the lock: wait until ``key`` exists and, in sync mode,
        has seen ``min_version`` rounds; an error tuple on a timeout."""
        while (key not in self.store
               or (self.sync_mode
                   and self.versions.get(key, 0) < min_version)):
            if not self.cv.wait(timeout=60):
                return ("ERR", "%s timeout on key %r" % (what, key))
        return None

    def _handle_pull(self, key, min_version):
        with self.cv:
            err = self._wait_version(key, min_version, "pull")
            return err or ("OK", self.store[key], self.versions.get(key, 0))

    def _handle_pull_rows(self, key, rows, min_version):
        """Only the requested rows of the stored value."""
        with self.cv:
            err = self._wait_version(key, min_version, "pull_rows")
            if err:
                return err
            idx = _np.asarray(rows, dtype=_np.int64).reshape(-1)
            return ("OK", self.store[key][idx], self.versions.get(key, 0))

    def _handle_barrier(self, bid):
        with self.cv:
            self.barrier_counts[bid] = self.barrier_counts.get(bid, 0) + 1
            self.cv.notify_all()
            while self.barrier_counts[bid] % self.num_workers != 0:
                if not self.cv.wait(timeout=60):
                    return ("ERR", "barrier timeout")
            return ("OK",)

    def _handle_heartbeat(self, rank):
        with self.cv:
            self.heartbeats[int(rank)] = time.monotonic()
            self.cv.notify_all()
        return ("OK",)

    def _handle_num_dead(self, timeout_sec):
        """Workers silent for longer than ``timeout_sec``: a rank that
        pinged and stopped, or one that never pinged, timed from the
        server's start; a rank that sent a clean STOP is not dead."""
        now = time.monotonic()
        with self.cv:
            if not self.heartbeats:
                return ("OK", 0)
            dead = 0
            for r in range(self.num_workers):
                if r in self.stopped_ranks:
                    continue
                if now - self.heartbeats.get(r, self._started) > \
                        float(timeout_sec):
                    dead += 1
            return ("OK", dead)

    def _handle_command(self, head, body):
        with self.cv:
            if head == "sync_mode":
                self.sync_mode = bool(body)
            elif head == "set_optimizer":
                from . import optimizer as opt
                self.updater = opt.get_updater(pickle.loads(body))
            else:
                return ("ERR", "unknown command %s" % head)
            self.cv.notify_all()
        return ("OK",)


class KVClient:
    """A worker's connection to the server (one request at a time).

    A transport failure leaves the stream at an unknown point, so the
    client drops its socket and the next request connects anew. What it
    raises says whether the request may be sent again:

    - the send failed: the server cannot have seen a whole request (it
      drops a partial frame with its connection), so the error is a
      ``ConnectionError``, which a ``faults.RetryPolicy`` retries;
    - the reply was lost after the request went out: a read-only request
      (``_REPEATABLE``) raises ``ConnectionError`` too; any other (a
      push, an init, a barrier, a command) may have been applied, and a
      second copy would be counted twice (a sync round would sum this
      worker's gradient twice), so it raises ``MXNetError``, which no
      policy retries.
    """

    #: requests that only read the server's state
    _REPEATABLE = frozenset(("PULL", "PULL_ROWS", "HEARTBEAT", "NUM_DEAD"))

    def __init__(self, uri, port, connect_timeout=90):
        self._addr = (uri, int(port))
        self._connect_timeout = connect_timeout
        self._sock = self._connect()
        self._lock = _conc.lock("KVClient", "_lock")
        self._barrier_id = 0
        self._push_counts = {}
        self._hb_stop = None
        self._rank = None

    def _connect(self):
        deadline = time.monotonic() + self._connect_timeout
        while True:
            try:
                sock = socket.create_connection(self._addr, timeout=120)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return sock
            except OSError:
                if time.monotonic() >= deadline:
                    raise MXNetError("cannot reach kvstore server at %s:%s"
                                     % self._addr)
                time.sleep(0.3)

    def _drop(self):
        sock, self._sock = self._sock, None
        try:
            sock.close()
        except OSError:
            pass

    def _rpc(self, *msg):
        with self._lock:
            # declared blocking seam: holding the client lock across the
            # round trip is that lock's declared job (ALLOWED_BLOCKING)
            _conc.blocking("http", "kvstore-rpc")
            if self._sock is None:
                self._sock = self._connect()
            try:
                _send_msg(self._sock, msg)
            except OSError as exc:
                self._drop()
                raise ConnectionError("kvstore %s not sent: %s"
                                      % (msg[0], exc)) from exc
            try:
                resp = _recv_msg(self._sock)
            except (OSError, EOFError) as exc:
                self._drop()
                if msg[0] in self._REPEATABLE:
                    raise ConnectionError("kvstore %s: reply lost: %s"
                                          % (msg[0], exc)) from exc
                raise MXNetError(
                    "kvstore %s: the connection failed after the request "
                    "was sent (%s); the server may have applied it, so it "
                    "is not sent again" % (msg[0], exc)) from exc
        if resp[0] != "OK":
            raise MXNetError("kvstore rpc failed: %r" % (resp,))
        return resp

    def init(self, key, value, rank=0):
        self._rpc("INIT", key, _np.asarray(value), rank)

    def push(self, key, value):
        version = self._rpc("PUSH", key, _np.asarray(value))[1]
        self._push_counts[key] = self._push_counts.get(key, 0) + 1
        return version

    def pull(self, key):
        """The stored value; in sync mode, once every round this worker
        pushed to has been applied."""
        return self._rpc("PULL", key, self._push_counts.get(key, 0))[1]

    def pull_rows(self, key, rows):
        """Only ``rows`` of the stored value."""
        return self._rpc("PULL_ROWS", key, _np.asarray(rows),
                         self._push_counts.get(key, 0))[1]

    def barrier(self):
        self._barrier_id += 1
        self._rpc("BARRIER", self._barrier_id)

    def send_command(self, head, body):
        self._rpc("COMMAND", head, body)

    def start_heartbeat(self, rank, interval=None):
        """Ping the server every ``interval`` seconds from a daemon thread
        (``MXTPU_HEARTBEAT_INTERVAL``, default 1)."""
        if self._hb_stop is not None:
            return
        if interval is None:
            interval = float(os.environ.get("MXTPU_HEARTBEAT_INTERVAL", 1.0))
        self._rank = int(rank)
        self._hb_stop = threading.Event()
        self._rpc("HEARTBEAT", self._rank)

        def loop():
            while not self._hb_stop.wait(interval):
                try:
                    self._rpc("HEARTBEAT", self._rank)
                except (MXNetError, OSError):
                    return

        threading.Thread(target=loop, daemon=True).start()

    def num_dead_node(self, timeout=60):
        """How many workers the server counts dead (silent longer than
        ``timeout`` seconds)."""
        return int(self._rpc("NUM_DEAD", float(timeout))[1])

    def stop(self):
        if self._hb_stop is not None:
            self._hb_stop.set()
        try:
            self._rpc("STOP", self._rank)
        except (MXNetError, OSError):
            pass
        if self._sock is not None:
            self._drop()


def cluster_env():
    """The ``MXTPU_*`` cluster environment (``DMLC_*`` honoured), or None
    without a role."""
    env = os.environ
    role = env.get("MXTPU_ROLE", env.get("DMLC_ROLE"))
    if role is None:
        return None
    return {
        "role": role,
        "uri": env.get("MXTPU_ROOT_URI", env.get("DMLC_PS_ROOT_URI",
                                                 "127.0.0.1")),
        "port": int(env.get("MXTPU_ROOT_PORT",
                            env.get("DMLC_PS_ROOT_PORT", "9091"))),
        "num_workers": int(env.get("MXTPU_NUM_WORKERS",
                                   env.get("DMLC_NUM_WORKER", "1"))),
        "worker_id": int(env.get("MXTPU_WORKER_ID", "0")),
    }


def _init_kvstore_server_module():
    """Serve, in a process whose role is ``server`` (or ``scheduler``),
    until the workers stop it; False for any other role."""
    env = cluster_env()
    if env is None or env["role"] not in ("server", "scheduler"):
        return False
    KVServer(env["port"], env["num_workers"]).run()
    return True


if __name__ == "__main__":
    if not _init_kvstore_server_module():
        sys.exit("python -m mxtpu_torch.kvstore_server: set MXTPU_ROLE="
                 "server (and MXTPU_ROOT_PORT, MXTPU_NUM_WORKERS)")

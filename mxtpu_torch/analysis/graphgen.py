"""Seeded random-graph generation + transform fuzzing.

Counterpart of ``mxtpu/analysis/graphgen.py``: the same seeded draws
(numpy's ``RandomState`` and crc32 sub-seeds), so ``random_graph(seed)``
is mxtpu's graph node for node and ``fuzz_round`` walks the same graphs
and configs; the numeric differential runs on the port's executor on
``cpu()``.

The transform catalog's correctness evidence used to be a handful of
fixture parity gates; this module turns it into a property: generate
random DAGs over the op vocabulary (FC / conv / pool / BatchNorm /
activations / reshape / concat / elemwise adds / softmax-loss heads),
push every catalog pass and sampled compositions × knob vectors through
:func:`mxtpu_torch.compile.pipeline.transform_graph`, certify each rewrite
with :mod:`mxtpu_torch.analysis.equiv`, and differential-test the
semantics-preserving configs numerically on seeded inputs.

Determinism is the schedule fuzzer's convention: every per-graph
seed derives from one master seed by crc32, so the same master seed
reproduces the same graphs, the same sampled configs, and the same
verdict sequence — a refutation is reproducible from ``(seed, config)``
alone.  Bounded rounds run in tier-1; ``tools/fuzz_transforms.py``
drives deeper sweeps and persists refutations as regression fixtures.
"""
from __future__ import annotations

import os as _os
import zlib as _zlib

import numpy as _np

__all__ = ["sub_seed", "random_graph", "fuzz_round", "CONFIGS",
           "SEMANTIC_PRESERVING"]

#: catalog configs the fuzzer samples per graph (quant rides the
#: inference kind and is certify-only: it changes numerics by design)
CONFIGS = (
    ("fuse_opt",),
    ("remat_reuse",),
    ("layout",),
    ("bf16",),
    ("quant",),
    ("layout", "bf16"),
    ("bf16", "fuse_opt", "remat_reuse"),
    ("layout", "bf16", "fuse_opt", "remat_reuse"),
)

#: configs whose rewrites must reproduce the original forward numerics
#: (annotation-only passes bit-exact; layout transposes cancel modulo
#: accumulation-order epsilon)
SEMANTIC_PRESERVING = frozenset({"layout", "fuse_opt", "remat_reuse"})

#: knob vectors the fuzzer samples (set via the knobs' declared env
#: names around the transform run, restored after)
_KNOB_VECTORS = (
    {},
    {"MXTPU_REMAT_THRESHOLD": "1.0", "MXTPU_FUSE_OPT_MAX_KB": "8.0"},
    {"MXTPU_REMAT_THRESHOLD": "16.0",
     "MXTPU_FUSE_OPT_MAX_KB": "1024.0"},
)

_NUM_CLASSES = 5


def sub_seed(master, i, tag=""):
    """Stable per-item seed derived from one master seed (crc32 — the
    fuzzer's convention: same master ⇒ same sub-seeds on every platform)."""
    return _zlib.crc32(("%s:%d:%d" % (tag, i, master)).encode()) \
        & 0x7FFFFFFF


def random_graph(seed):
    """One seeded random DAG; returns ``(symbol, shapes)`` where
    ``shapes`` covers the data/label inputs (parameters infer).  Graphs
    are deliberately small (batch 4, dims ≤ 32) — the fuzzer's value is
    breadth over the op/topology space, not model scale."""
    import mxtpu_torch as mx
    rng = _np.random.RandomState(seed)
    batch = 4
    counter = [0]

    def nm(op):
        counter[0] += 1
        return "fz_%s%d" % (op, counter[0])

    cur = mx.sym.Variable("data")
    conv_net = rng.rand() < 0.5
    if conv_net:
        c = int(rng.choice([1, 3, 4]))
        hw = int(rng.choice([8, 12, 16]))
        data_shape = (batch, c, hw, hw)
    else:
        f = int(rng.randint(6, 25))
        data_shape = (batch, f)

    depth = int(rng.randint(2, 6))
    for _ in range(depth):
        if conv_net:
            choice = rng.choice(
                ["conv", "pool", "bn", "act", "branch_add"])
            if choice == "conv":
                nf = int(rng.choice([4, 8, 16]))
                cur = mx.sym.Convolution(
                    cur, name=nm("conv"), num_filter=nf,
                    kernel=(3, 3), pad=(1, 1))
            elif choice == "pool" and hw >= 4:
                cur = mx.sym.Pooling(
                    cur, name=nm("pool"),
                    pool_type=str(rng.choice(["max", "avg"])),
                    kernel=(2, 2), stride=(2, 2))
                hw //= 2
            elif choice == "bn":
                cur = mx.sym.BatchNorm(cur, name=nm("bn"))
            elif choice == "branch_add":
                a = mx.sym.Activation(cur, name=nm("brelu"),
                                      act_type="relu")
                cur = mx.sym.elemwise_add(cur, a, name=nm("badd"))
            else:
                cur = mx.sym.Activation(
                    cur, name=nm("act"),
                    act_type=str(rng.choice(["relu", "tanh"])))
        else:
            choice = rng.choice(
                ["fc", "act", "branch_add", "concat", "reshape"])
            if choice == "fc":
                cur = mx.sym.FullyConnected(
                    cur, name=nm("fc"),
                    num_hidden=int(rng.choice([8, 12, 16])))
            elif choice == "act":
                cur = mx.sym.Activation(
                    cur, name=nm("act"),
                    act_type=str(rng.choice(["relu", "sigmoid",
                                             "tanh"])))
            elif choice == "branch_add":
                a = mx.sym.Activation(cur, name=nm("brelu"),
                                      act_type="relu")
                cur = mx.sym.elemwise_add(cur, a, name=nm("badd"))
            elif choice == "concat":
                k = int(rng.choice([4, 8]))
                b1 = mx.sym.FullyConnected(cur, name=nm("cfc"),
                                           num_hidden=k)
                b2 = mx.sym.FullyConnected(cur, name=nm("cfc"),
                                           num_hidden=k)
                cur = mx.sym.Concat(b1, b2, dim=1, name=nm("concat"))
            else:
                cur = mx.sym.Reshape(cur, shape=(batch, -1),
                                     name=nm("reshape"))
    if conv_net:
        cur = mx.sym.Flatten(cur, name=nm("flat"))
    cur = mx.sym.FullyConnected(cur, name=nm("head"),
                                num_hidden=_NUM_CLASSES)
    out = mx.sym.SoftmaxOutput(cur, name="softmax")
    return out, {"data": data_shape, "softmax_label": (batch,)}


def _seeded_args(sym, shapes, seed):
    """Deterministic f32 bindings for every argument and aux state of
    ``sym``; returns ``(args, aux)``."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = _np.random.RandomState(seed)
    args = {}
    for name, shp in zip(sym.list_arguments(), arg_shapes):
        if name == "softmax_label":
            args[name] = rng.randint(
                0, _NUM_CLASSES, shp).astype(_np.float32)
        else:
            args[name] = (rng.rand(*shp).astype(_np.float32) - 0.5)
    aux = {}
    for name, shp in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[name] = _np.ones(shp, _np.float32) \
            if name.endswith("_moving_var") \
            else _np.zeros(shp, _np.float32)
    return args, aux


def _forward(sym, args, aux):
    import mxtpu_torch as mx
    from ..compile import pipeline as _pipe
    nd = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in args.items()}
    nda = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in aux.items()}
    with _pipe.pipeline_scope([]):   # bind raw: no re-transforming
        ex = sym.bind(mx.cpu(), nd, args_grad=None, grad_req="null",
                      aux_states=nda)
        return ex.forward(is_train=False)[0].asnumpy()


def fuzz_round(master_seed, n_graphs=64, numeric=True, configs=CONFIGS,
               eps=1e-5):
    """One bounded fuzz round; returns a dict with the deterministic
    ``verdicts`` list (one line per graph — the sequence tier-1 pins),
    and ``refutations``: ``(graph_seed, config, verdict)`` for every
    graph whose rewrite was refused certification or failed the
    numeric differential — each reproducible from the tuple alone."""
    from .. import telemetry as _tel
    from ..compile import pipeline as _pipe
    verdicts = []
    refutations = []
    for i in range(n_graphs):
        gseed = sub_seed(master_seed, i, "graph")
        sym, shapes = random_graph(gseed)
        rng = _np.random.RandomState(sub_seed(master_seed, i, "cfg"))
        cfg = configs[int(rng.randint(len(configs)))]
        knobs = dict(_KNOB_VECTORS[int(rng.randint(
            len(_KNOB_VECTORS)))])
        args, aux = _seeded_args(sym, shapes,
                                 sub_seed(master_seed, i, "args"))
        kind = "executor_infer" if "quant" in cfg else "fused_step"
        values = args if "quant" in cfg else None
        saved = {k: _os.environ.get(k) for k in knobs}
        _os.environ.update(knobs)
        try:
            sym2, rep = _pipe.transform_graph(
                sym, kind=kind, shapes=shapes, passes=cfg,
                values=values)
        finally:
            for k, v in saved.items():
                if v is None:
                    _os.environ.pop(k, None)
                else:
                    _os.environ[k] = v
        refused = [e["name"] for e in rep.entries if e["cert_refused"]]
        errored = [e["name"] for e in rep.entries
                   if e["error"] is not None]
        diff = "skip"
        if numeric and rep.symbol_changed \
                and set(rep.applied) <= SEMANTIC_PRESERVING:
            o1 = _forward(sym, args, aux)
            o2 = _forward(sym2, args, aux)
            delta = float(_np.max(_np.abs(
                o1.astype(_np.float64) - o2.astype(_np.float64))))
            diff = "exact" if delta == 0.0 \
                else ("max%.1e" % delta if delta <= eps
                      else "MISMATCH%.1e" % delta)
        bad = bool(refused or errored or diff.startswith("MISMATCH"))
        verdict = ("g%02d seed=%d cfg=%s kind=%s applied=%s cert=%s "
                   "diff=%s%s"
                   % (i, gseed, "+".join(cfg), kind,
                      ",".join(rep.applied) or "-", rep.cert or "-",
                      diff, " REFUTED" if bad else ""))
        verdicts.append(verdict)
        if bad:
            refutations.append((gseed, cfg, verdict))
        _tel.counter(
            "fuzz_graphs_run",
            help="random graphs pushed through the transform fuzzer "
                 "(mxtpu.analysis.graphgen)").inc()
    return {"master_seed": master_seed, "n_graphs": n_graphs,
            "verdicts": verdicts, "refutations": refutations}

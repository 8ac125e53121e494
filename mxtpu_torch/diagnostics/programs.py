"""Per-program cost introspection: what every built program costs.

Counterpart of ``mxtpu/diagnostics/programs.py``: ``ProgramRecord``,
``record_program``, ``programs``, ``latest_record`` and
``program_table``. mxtpu reads XLA's ``cost_analysis`` and
``memory_analysis`` off the executable it compiles at a program's first
call. The port compiles nothing: a program is an executor plan walked
eagerly. Its first call runs under :class:`CostCounter` instead, which
counts the flops of every aten op the call dispatches
(``torch.utils.flop_counter``) and the bytes each one reads and writes,
plus ``torch.cuda.max_memory_allocated`` around the call. The port's
hand-written kernels are ctypes launches, which no dispatch mode sees:
each wrapper reports its own flops and bytes from its shapes
(:func:`kernel_cost`, the formulas ``chip_smoke.py`` bounds each kernel
with). ``MXTPU_DIAG_COST=0`` turns the capture off.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

from .. import telemetry as _tel
from ..analysis import concurrency as _conc

__all__ = ["ProgramRecord", "record_program", "programs", "program_table",
           "latest_record", "cost_enabled", "set_cost_enabled", "clear",
           "owner_name", "summarize_precision", "CostCounter",
           "kernel_cost"]

_ENABLED = os.environ.get("MXTPU_DIAG_COST", "1") != "0"

#: retain at most this many program records
MAX_RECORDS = int(os.environ.get("MXTPU_DIAG_COST_CAP", "1024"))

_ids = itertools.count(1)
_RECORDS = deque(maxlen=MAX_RECORDS)
_LOCK = _conc.lock("programs", "_LOCK")
_TLS = threading.local()


def cost_enabled():
    return _ENABLED


def set_cost_enabled(flag):
    """Runtime toggle; affects programs built after the flip (capture
    happens once, at a program's first call)."""
    global _ENABLED
    _ENABLED = bool(flag)


def owner_name(owner):
    """Normalize an owner to its display name, so a long-lived wrapper
    never pins the owner object itself."""
    if isinstance(owner, str):
        return owner
    return type(owner).__name__ if owner is not None else ""


def kernel_cost(flops, nbytes):
    """Add one hand-written kernel launch's ``flops`` and ``nbytes`` to
    the counter of the first call being captured on this thread (no-op
    otherwise: one attribute read)."""
    counter = getattr(_TLS, "counter", None)
    if counter is not None:
        counter.flops += float(flops)
        counter.bytes += float(nbytes)
        counter.kernels += 1


class CostCounter:
    """Counts a call's operations and bytes: aten ops through a dispatch
    mode (flops from ``torch.utils.flop_counter``'s formulas, bytes as
    each op's tensor inputs read and outputs written once), the port's
    kernels through :func:`kernel_cost`. A context manager; the numbers
    are ``flops``, ``bytes`` and ``kernels`` after it exits."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels = 0
        self._modes = []

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import FlopCounterMode
        counter = self

        class _Bytes(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                counter.bytes += _tensor_bytes(args) + _tensor_bytes(out)
                return out

        self._flop = FlopCounterMode(display=False)
        self._modes = [self._flop, _Bytes()]
        for m in self._modes:
            m.__enter__()
        self._prev = getattr(_TLS, "counter", None)
        _TLS.counter = self
        return self

    def __exit__(self, *exc):
        _TLS.counter = self._prev
        for m in reversed(self._modes):
            m.__exit__(*exc)
        self.flops += float(self._flop.get_total_flops())
        return False


def _tensor_bytes(tree):
    import torch
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type != "meta":
                total += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


class ProgramRecord:
    """One built program's captured cost/memory metadata (mxtpu's
    fields; ``argument_bytes``/``output_bytes`` are the first call's
    tensors, ``temp_bytes`` the rise of the card's peak allocation
    above what was allocated before the call, 0 on the CPU)."""

    __slots__ = ("id", "kind", "owner", "created", "compile_ms", "flops",
                 "bytes_accessed", "argument_bytes", "output_bytes",
                 "temp_bytes", "generated_code_bytes", "calls",
                 "n_devices", "sharded_args", "replicated_args",
                 "precision", "transforms", "cert", "kernels")

    def __init__(self, kind, owner, compile_ms):
        self.id = next(_ids)
        self.kind = kind
        self.owner = owner_name(owner)
        self.created = time.time()
        self.compile_ms = compile_ms
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.argument_bytes = 0
        self.output_bytes = 0
        self.temp_bytes = 0
        self.generated_code_bytes = 0
        self.calls = 0
        self.n_devices = 1
        self.sharded_args = 0
        self.replicated_args = 0
        self.precision = "f32"
        self.transforms = ()
        self.cert = "-"
        self.kernels = 0   # hand-written kernel launches the call made

    def to_dict(self):
        return {
            "id": self.id, "kind": self.kind, "owner": self.owner,
            "created": round(self.created, 3),
            "compile_ms": round(self.compile_ms, 3),
            "flops": self.flops, "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "calls": self.calls,
            "n_devices": self.n_devices,
            "sharded_args": self.sharded_args,
            "replicated_args": self.replicated_args,
            "precision": self.precision,
            "transforms": list(self.transforms),
            "cert": self.cert,
            "kernels": self.kernels,
        }


def summarize_precision(rec, args, tag=None):
    """Stamp ``rec.precision``: the compile pipeline's ``tag`` wins
    ("mixed_bf16", "int8_ptq"); otherwise the label derives from the
    call's floating tensors ("bf16" when all are half precision, "mixed"
    when both families appear, else "f32"). Never raises."""
    if tag:
        rec.precision = str(tag)
        return
    try:
        import torch
        lo = hi = 0
        stack = [args]
        while stack:
            x = stack.pop()
            if isinstance(x, torch.Tensor):
                if x.is_floating_point():
                    if x.dtype in (torch.bfloat16, torch.float16):
                        lo += 1
                    else:
                        hi += 1
            elif isinstance(x, (list, tuple)):
                stack.extend(x)
            elif isinstance(x, dict):
                stack.extend(x.values())
        if lo and hi:
            rec.precision = "mixed"
        elif lo:
            rec.precision = "bf16"
        elif hi:
            rec.precision = "f32"
    except Exception:
        pass


def record_program(kind, owner, counter, compile_ms, args=(), out=(),
                   temp_bytes=0, transforms=None, cert=None):
    """Capture a program's first call (``counter``: its
    :class:`CostCounter`) into the registry and the telemetry counters.
    Never raises past its own bookkeeping."""
    rec = ProgramRecord(kind, owner, compile_ms)
    if transforms:
        rec.transforms = tuple(transforms)
        rec.cert = cert or "off"
    if counter is not None:
        rec.flops = counter.flops
        rec.bytes_accessed = counter.bytes
        rec.kernels = counter.kernels
    rec.argument_bytes = _tensor_bytes(args)
    rec.output_bytes = _tensor_bytes(out)
    rec.temp_bytes = int(temp_bytes)
    with _LOCK:
        _RECORDS.append(rec)
    reg = _tel.registry()
    labels = {"kind": kind}
    reg.counter("program_captured",
                help="programs whose cost/memory analysis was captured",
                labels=labels).inc()
    reg.counter("program_flops", labels=labels,
                help="total flops of captured programs (per execution, "
                     "summed over builds)").inc(rec.flops)
    reg.counter("program_bytes_accessed", labels=labels,
                help="total bytes-accessed of captured programs").inc(
        rec.bytes_accessed)
    g = reg.gauge("program_temp_bytes_peak", labels=labels,
                  help="largest temp (scratch) allocation among captured "
                       "programs of this kind")
    if rec.temp_bytes > g.value:
        g.set(rec.temp_bytes)
    return rec


def programs(kind=None):
    """Snapshot of captured records (list of dicts, oldest first)."""
    with _LOCK:
        recs = list(_RECORDS)
    return [r.to_dict() for r in recs if kind is None or r.kind == kind]


def latest_record(kind=None):
    """The most recent live ProgramRecord (optionally of one kind)."""
    with _LOCK:
        for r in reversed(_RECORDS):
            if kind is None or r.kind == kind:
                return r
    return None


def program_table(kind=None):
    """Human-readable cost report, one row per captured program
    (mxtpu's columns)."""
    rows = programs(kind)
    header = ("id", "kind", "owner", "calls", "compile_ms", "mflops",
              "mb_accessed", "arg_kb", "out_kb", "temp_kb", "devs",
              "prec", "cert", "xforms")
    lines = ["%4s %-12s %-16s %6s %10s %10s %11s %8s %8s %8s %9s %-10s "
             "%-4s %s" % header]
    for r in rows:
        devs = "%d" % r.get("n_devices", 1)
        if r.get("sharded_args"):
            devs += " (%ds)" % r["sharded_args"]
        lines.append("%4d %-12s %-16s %6d %10.1f %10.2f %11.2f %8d %8d "
                     "%8d %9s %-10s %-4s %s"
                     % (r["id"], r["kind"][:12], r["owner"][:16], r["calls"],
                        r["compile_ms"], r["flops"] / 1e6,
                        r["bytes_accessed"] / 1e6,
                        r["argument_bytes"] // 1024,
                        r["output_bytes"] // 1024,
                        r["temp_bytes"] // 1024, devs,
                        r.get("precision", "f32")[:10],
                        r.get("cert", "-"),
                        ",".join(r.get("transforms", ())) or "-"))
    return "\n".join(lines)


def clear():
    """Drop captured records (tests)."""
    with _LOCK:
        _RECORDS.clear()

"""MeshContext and ShardingPlan: the mesh and the decisions taken on it.

Counterpart of ``mxtpu/sharding/plan.py``, plain Python in both packages:

- ``MeshContext`` (:61) owns a mesh of port contexts (``parallel.Mesh``)
  and the axis vocabulary (``SpecLayout``); ``create`` (:96) takes every
  form mxtpu's takes. ``devices=`` defaults to every CUDA device and
  raises on a host without one: pass ``cpu()`` contexts to build a mesh
  of the host, as the tests do.
- The active mesh lives in a ``contextvars.ContextVar`` (:150-210), so
  each thread sees its own: ``activate``, ``deactivate``, ``active``,
  ``use``, ``current``; ``from_env`` reads ``MXTPU_MESH`` (:212) and
  ``resolve`` normalizes ``fit(mesh=...)`` (:228).
- ``ShardingPlan`` (:267) fits the name heuristics to the live mesh and
  the real shapes (``_fit`` :330) and adds cross-replica weight-update
  sharding to the optimizer state (``_weight_update_spec`` :371): the
  state of a trainable parameter of at least ``min_shard_elems``
  elements whose first dim the data axis divides shards its rows over
  ``data``. ``shard_update`` and ``min_shard_elems`` are constructor
  arguments with mxtpu's defaults (on, 4096); mxtpu's environment reads
  ``MXTPU_SHARD_UPDATE`` / ``MXTPU_SHARD_MIN_ELEMS`` are not ported.

The plan decides; ``replica_layout()`` says what each device then holds
(``parallel.mesh.ReplicaLayout``: its coordinates, its rows of the batch,
its block of each split parameter, its tp/fsdp/data groups). What runs it
is the executor group (``module/executor_group.py``: one replica a mesh
device, each holding its blocks), the replica walk (``executor.py``: a
parameter split over ``fsdp`` gathered right before its op, one split
over ``tp`` computed on its block by the op's ``tp_fn``) and the fused
step (``module/fused.py``): it reduce-scatters the gradients of the
parameters whose ``opt_spec`` shards over ``data``, updates each
replica's rows and all-gathers them; the KVStore veneer
(``kvstore.py``) consults ``current()``.
"""
from __future__ import annotations

import contextlib
import contextvars
import os

import numpy as _np

from ..analysis import concurrency as _conc
from ..base import MXNetError
from ..context import gpu, num_gpus
from ..parallel.mesh import Mesh, ReplicaLayout
from .spec import PartitionSpec as PS
from .spec import SpecLayout, parameter_spec_from_name

__all__ = ["MeshContext", "ShardingPlan", "activate", "deactivate",
           "active", "active_mesh", "current", "use", "resolve",
           "from_env", "plan_for_module", "naive_spec", "DISABLED",
           "spec_to_json", "spec_from_json"]


def spec_to_json(spec):
    """A spec as a JSON-able list: ``None`` | axis name | list of axis
    names."""
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def spec_from_json(entries):
    """Inverse of :func:`spec_to_json` (lists become axis tuples)."""
    return PS(*[tuple(e) if isinstance(e, list) else e
                for e in (entries or [])])


def _cuda_contexts():
    n = num_gpus()
    if n == 0:
        raise MXNetError("a mesh over the default devices needs CUDA, and "
                         "there is no CUDA device: pass devices=[cpu(0), "
                         "cpu(1), ...] to build a mesh of host contexts")
    return [gpu(i) for i in range(n)]


class MeshContext:
    """A device mesh plus the axis vocabulary used to shard over it."""

    def __init__(self, mesh, layout=None):
        if not isinstance(mesh, Mesh):
            raise MXNetError("MeshContext needs a mxtpu_torch Mesh, got %r"
                             % (type(mesh).__name__,))
        self.mesh = mesh
        self.layout = layout or SpecLayout()

    @property
    def devices(self):
        """Flat context list in mesh order."""
        return list(self.mesh.devices.flat)

    @property
    def axis_sizes(self):
        """{axis_name: size} for every mesh axis."""
        return dict(zip(self.mesh.axis_names, self.mesh.devices.shape))

    @property
    def n_data(self):
        """Size of the data (replica) axis; 1 when the mesh has none."""
        return self.axis_sizes.get(self.layout.data_axis, 1)

    def __repr__(self):
        return "MeshContext(%s)" % ", ".join(
            "%s:%d" % kv for kv in self.axis_sizes.items())

    @classmethod
    def create(cls, spec=None, devices=None, layout=None):
        """A MeshContext from a loose description:

        * ``None`` / ``"all"`` / ``"auto"`` / ``True`` — 1-D ``('data',)``
          over every device;
        * an int / ``"8"`` — 1-D ``('data',)`` over the first n devices;
        * ``"4x2"`` — 2-D ``('data', 'tp')``;
        * ``"data:4,tp:2"`` — named axes, any order;
        * a port ``Mesh`` or an existing MeshContext — wrapped/returned.

        ``devices`` (contexts) defaults to every CUDA device."""
        layout = layout or SpecLayout()
        if isinstance(spec, MeshContext):
            return spec
        if isinstance(spec, Mesh):
            return cls(spec, layout)
        devices = list(devices) if devices is not None \
            else _cuda_contexts()
        if spec is None or spec is True or (
                isinstance(spec, str) and spec.lower() in ("all", "auto")):
            shape, names = (len(devices),), (layout.data_axis,)
        elif isinstance(spec, int) or (isinstance(spec, str)
                                       and spec.isdigit()):
            shape, names = (int(spec),), (layout.data_axis,)
        elif isinstance(spec, str) and ":" in spec:
            names, shape = [], []
            for part in spec.split(","):
                axis, _, size = part.partition(":")
                names.append(axis.strip())
                shape.append(int(size))
            shape, names = tuple(shape), tuple(names)
        elif isinstance(spec, str) and "x" in spec:
            shape = tuple(int(s) for s in spec.split("x"))
            default_names = (layout.data_axis, layout.tp_axis,
                             layout.fsdp_axis)
            if len(shape) > len(default_names):
                raise MXNetError("mesh spec %r: use the named 'axis:n,...' "
                                 "form for >%d axes" % (spec,
                                                        len(default_names)))
            names = default_names[:len(shape)]
        else:
            raise MXNetError("cannot parse mesh spec %r (use an int, "
                             "'all', '4x2', 'data:4,tp:2', or a Mesh)"
                             % (spec,))
        n = int(_np.prod(shape))
        if n > len(devices):
            raise MXNetError("mesh spec %r needs %d devices, only %d "
                             "available" % (spec, n, len(devices)))
        return cls(Mesh(devices[:n], names, shape), layout)


# ----------------------------------------------------------- active mesh
_active_lock = _conc.lock("plan", "_active_lock")
# a contextvar: concurrent fits on different threads must not see each
# other's mesh, and interleaved use() exits restore their own prior value
_active = contextvars.ContextVar("mxtpu_torch_active_mesh", default=None)


def activate(mesh_ctx):
    """Install ``mesh_ctx`` as the active mesh of this thread/context;
    returns the previous value."""
    prev = _active.get()
    _active.set(mesh_ctx)
    return prev


def deactivate():
    """Clear the active mesh."""
    return activate(None)


def active():
    """The activated MeshContext, or None (``DISABLED`` reads as None —
    :func:`current` applies the environment fallback)."""
    cur = _active.get()
    return None if cur is DISABLED else cur


def active_mesh():
    """The active port ``Mesh``, or None."""
    ctx = active()
    return ctx.mesh if ctx is not None else None


@contextlib.contextmanager
def use(mesh_ctx):
    """Scoped :func:`activate`; ``None`` is a no-op."""
    if mesh_ctx is None:
        yield None
        return
    prev = activate(mesh_ctx)
    try:
        yield mesh_ctx
    finally:
        activate(prev)


#: what ``mesh=False`` activates: no mesh, and no ``MXTPU_MESH`` fallback
DISABLED = object()

#: MXTPU_MESH parse cache: one MeshContext per spec string
_ENV_CACHE = {}


def from_env():
    """The MeshContext ``MXTPU_MESH`` describes (``8``, ``all``,
    ``data:4,tp:2``), or None when unset or off; one object per value."""
    spec = os.environ.get("MXTPU_MESH", "").strip()
    if not spec or spec.lower() in ("0", "none", "off", "false"):
        return None
    ctx = _ENV_CACHE.get(spec)
    if ctx is None:
        with _active_lock:
            ctx = _ENV_CACHE.get(spec)
            if ctx is None:
                ctx = _ENV_CACHE[spec] = MeshContext.create(spec)
    return ctx


def resolve(mesh=None):
    """Normalize ``fit(mesh=...)``: ``None`` defers to ``MXTPU_MESH``;
    ``False``/``0``/``"none"``/``"off"``/``"false"`` disable it (even with
    the environment set: :data:`DISABLED`); anything else goes through
    :meth:`MeshContext.create`."""
    if mesh is None:
        return from_env()
    if mesh is False or (isinstance(mesh, (str, int))
                         and str(mesh).lower() in ("0", "none", "off",
                                                   "false")):
        return DISABLED
    return MeshContext.create(mesh)


def current():
    """The mesh of the current scope: the active MeshContext, else
    ``MXTPU_MESH``; None under ``DISABLED``."""
    ctx = _active.get()
    if ctx is DISABLED:
        return None
    if ctx is not None:
        return ctx
    return from_env()


# ----------------------------------------------------------------- plan
def naive_spec(shape, mesh_ctx, axis=None):
    """Dim 0 over the data axis when it divides, else replicated."""
    axis = axis or mesh_ctx.layout.data_axis
    n = mesh_ctx.axis_sizes.get(axis, 1)
    if n > 1 and shape and shape[0] % n == 0:
        return PS(axis)
    return PS()


class ShardingPlan:
    """Mesh-legal PartitionSpecs for one module's parameters, optimizer
    state and batches.

    ``param_shapes`` maps every parameter to its shape; ``trainable``
    restricts weight-update sharding to what the optimizer updates;
    ``overrides`` forces a spec per name (kept raw, so ``validate``
    reports axis typos and rank mismatches). ``shard_update`` gates
    weight-update sharding; ``min_shard_elems`` keeps smaller states
    replicated."""

    def __init__(self, mesh_ctx, param_shapes, data_names=(),
                 label_names=(), trainable=None, aux_names=(),
                 batch_shapes=None, overrides=None, shard_update=True,
                 min_shard_elems=4096):
        self.mesh_ctx = mesh_ctx
        self.layout = mesh_ctx.layout
        self.param_shapes = {n: tuple(s) for n, s in param_shapes.items()}
        self.data_names = list(data_names)
        self.label_names = list(label_names)
        self.trainable = set(trainable if trainable is not None
                             else self.param_shapes)
        self.aux_names = list(aux_names)
        self.batch_shapes = {n: tuple(s)
                             for n, s in (batch_shapes or {}).items()}
        self.overrides = dict(overrides or {})
        self.shard_update = bool(shard_update)
        self.min_shard_elems = int(min_shard_elems)
        #: name -> (raw_spec, final_spec, [(kind, message)])
        self.decisions = {}
        self._param_specs = {}
        self._opt_specs = {}
        for name, shape in self.param_shapes.items():
            raw = self.overrides.get(name)
            if raw is None:
                raw = parameter_spec_from_name(name, self.layout)
            final, reasons = self._fit(raw, shape)
            self.decisions[name] = (raw, final, reasons)
            self._param_specs[name] = final
            self._opt_specs[name] = self._weight_update_spec(name, shape,
                                                             final)

    @property
    def mesh(self):
        return self.mesh_ctx.mesh

    def replica_layout(self):
        """The ``ReplicaLayout`` of this plan over its mesh (one object
        per plan): the split parameters' specs, the rows of the batch
        over every axis but the layout's tp axis."""
        if getattr(self, "_replica_layout", None) is None:
            self._replica_layout = ReplicaLayout(
                self.mesh, self._param_specs, tp_axis=self.layout.tp_axis)
        return self._replica_layout

    @property
    def n_data(self):
        return self.mesh_ctx.n_data

    def _fit(self, spec, shape):
        """Prune ``spec`` against the mesh and the shape: absent axes and
        dims the axes do not divide become None. Returns (final_spec,
        [(kind, message)])."""
        sizes = self.mesh_ctx.axis_sizes
        reasons = []
        entries = tuple(spec)
        if len(entries) > len(shape):
            reasons.append(("rank", "spec rank %d > param rank %d — extra "
                            "dims dropped" % (len(entries), len(shape))))
            entries = entries[:len(shape)]
        fitted = []
        for dim, entry in enumerate(entries):
            if entry is None:
                fitted.append(None)
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            missing = [a for a in axes if a not in sizes]
            if missing:
                reasons.append(("axis", "axis %s not on the mesh (has: %s)"
                                % ("/".join(missing),
                                   ", ".join(sizes) or "none")))
                axes = tuple(a for a in axes if a in sizes)
            factor = int(_np.prod([sizes[a] for a in axes])) if axes else 1
            if factor <= 1:
                fitted.append(None)
                continue
            if shape[dim] % factor != 0:
                reasons.append(("divisibility", "dim %d (size %d) not "
                                "divisible by %s=%d — replicated"
                                % (dim, shape[dim], "×".join(axes),
                                   factor)))
                fitted.append(None)
                continue
            fitted.append(axes if len(axes) > 1 else axes[0])
        while fitted and fitted[-1] is None:
            fitted.pop()
        return PS(*fitted), reasons

    def _weight_update_spec(self, name, shape, param_spec):
        """The optimizer state's spec: the parameter's plus data-axis row
        sharding where legal."""
        if name not in self.trainable or not self.shard_update:
            return param_spec
        data = self.layout.data_axis
        n = self.mesh_ctx.axis_sizes.get(data, 1)
        if n <= 1 or not shape:
            return param_spec
        if int(_np.prod(shape)) < self.min_shard_elems:
            return param_spec
        dim0 = tuple(param_spec)[0] if tuple(param_spec) else None
        used = dim0 if isinstance(dim0, tuple) else \
            ((dim0,) if dim0 else ())
        if data in used:
            return param_spec
        factor = n * int(_np.prod(
            [self.mesh_ctx.axis_sizes[a] for a in used])) if used else n
        if shape[0] % factor != 0:
            return param_spec
        merged = (data,) + used
        rest = tuple(param_spec)[1:]
        return PS(merged if len(merged) > 1 else data, *rest)

    def param_spec(self, name):
        """The parameter's spec (replicated when unknown)."""
        return self._param_specs.get(name, PS())

    def opt_spec(self, name):
        """The spec of the parameter's optimizer state."""
        return self._opt_specs.get(name, self.param_spec(name))

    def batch_spec(self, name):
        """A batch array's spec: rows over data, replicated where the
        known shape does not divide."""
        shape = self.batch_shapes.get(name)
        if shape is not None:
            return naive_spec(shape, self.mesh_ctx)
        return self.layout.activations()

    def sharded_opt_names(self):
        """Names whose optimizer state shards over data."""
        data = self.layout.data_axis
        out = []
        for name, spec in self._opt_specs.items():
            entry = tuple(spec)[0] if tuple(spec) else None
            axes = entry if isinstance(entry, tuple) else (entry,)
            if data in axes:
                out.append(name)
        return out

    def validate(self):
        """[{"kind", "name", "raw", "final", "message"}]: ``axis_typo``
        and ``rank_mismatch`` for overrides, ``axis_absent`` and
        ``rank_pruned`` for heuristics, ``replicated_fallback`` for dims
        that could not shard."""
        issues = []
        for name, (raw, final, reasons) in sorted(self.decisions.items()):
            overridden = name in self.overrides
            for rkind, msg in reasons:
                if rkind == "axis":
                    kind = "axis_typo" if overridden else "axis_absent"
                elif rkind == "rank":
                    kind = "rank_mismatch" if overridden else "rank_pruned"
                else:
                    kind = "replicated_fallback"
                issues.append({"kind": kind, "name": name,
                               "raw": str(raw), "final": str(final),
                               "message": msg})
        return issues

    def describe(self):
        """A JSON-ready summary."""
        return {
            "mesh": dict(self.mesh_ctx.axis_sizes),
            "shard_update": self.shard_update,
            "min_shard_elems": self.min_shard_elems,
            "params": {n: {"shape": list(self.param_shapes[n]),
                           "spec": str(self._param_specs[n]),
                           "opt_spec": str(self._opt_specs[n])}
                       for n in sorted(self.param_shapes)},
            "sharded_opt": sorted(self.sharded_opt_names()),
        }


def plan_for_module(module, mesh_ctx, overrides=None, shard_update=True):
    """The ShardingPlan of a bound, initialized Module: shapes from its
    bound arrays, trainable = parameters minus ``fixed_param_names``,
    batch shapes from the bound data and label shapes."""
    shapes = module._exec_group.param_shapes
    fixed = set(module._fixed_param_names or ())
    batch_shapes = dict((module._data_shapes or [])
                        + (module._label_shapes or []))
    return ShardingPlan(
        mesh_ctx,
        {n: tuple(shapes[n]) for n in module._param_names},
        data_names=list(module._data_names),
        label_names=list(module._label_names),
        trainable=[n for n in module._param_names if n not in fixed],
        aux_names=list(module._aux_names),
        batch_shapes=batch_shapes,
        overrides=overrides, shard_update=shard_update)

"""Shape/dtype inference provenance: who broke which node, through what path.

Counterpart of ``mxtpu/analysis/provenance.py``. ``infer_walk`` is the
events mode of mxtpu's ``_infer_graph`` (mxtpu/symbol/symbol.py:496-619):
one forward walk that never raises, recording each node it cannot
resolve. Shapes come from each op run on meta tensors (``OpDef.apply``
on ``device="meta"``, every output including the updated aux values, as
``jax.eval_shape`` gives mxtpu), so the walk does no arithmetic. dtypes
are numpy dtypes, bfloat16 as the port's ``BFLOAT16`` stand-in;
:func:`dtype_name` names any of them as mxtpu's dtypes name themselves.
The verifier passes, the dataflow analyses and the rewrites all read
this one walk.
"""
from __future__ import annotations

import numpy as _np

__all__ = ["infer_walk", "unknown_root_paths", "describe_insufficient",
           "describe_unresolved_arg", "known_shape_summary",
           "dtype_name", "np_dtype"]


def np_dtype(dt):
    """The numpy dtype of ``dt`` (a name, numpy or torch dtype), with
    bfloat16 as ``ops.registry.BFLOAT16``."""
    from ..ops.registry import BFLOAT16, numpy_dtype, torch_dtype
    if isinstance(dt, _np.dtype) and dt == BFLOAT16:
        return dt
    if isinstance(dt, str) and dt == "bfloat16":
        return BFLOAT16
    try:
        return _np.dtype(dt)
    except TypeError:
        return numpy_dtype(torch_dtype(dt))


def dtype_name(dt):
    """mxtpu's name of a dtype: "float32", "bfloat16", "int8", ..."""
    from ..ops.registry import BFLOAT16
    d = np_dtype(dt)
    return "bfloat16" if d == BFLOAT16 else d.name


def _walk(sym, shape_hints, type_hints, events):
    """mxtpu's ``_infer_graph(events=...)`` over the port's ops."""
    import torch

    from ..ops.registry import numpy_dtype, torch_dtype
    from ..symbol.symbol import _shape_attr
    f32 = _np.dtype("float32")
    shapes, dtypes = {}, {}
    for node in sym._topo():
        if node.is_variable:
            shp = shape_hints.get(node.name)
            if shp is None and node._extra_attrs.get("__shape__") is not None:
                shp = _shape_attr(node._extra_attrs["__shape__"])
            dt = type_hints.get(node.name)
            if dt is None:
                vdt = node._extra_attrs.get("__dtype__")
                dt = np_dtype(str(vdt)) if vdt is not None else f32
            shapes[node.name] = tuple(shp) if shp is not None else None
            shapes[(id(node), 0)] = shapes[node.name]
            dtypes[node.name] = dtypes[(id(node), 0)] = dt
            continue
        try:
            attrs = node.parsed_attrs()
        except Exception as exc:
            events.append({"node": node.name, "op": node.op.name,
                           "missing_inputs": [], "exception": str(exc)})
            continue
        if "__is_train__" in node.op.attrs_spec:
            attrs = type(attrs)(attrs)
            attrs["__is_train__"] = False
        in_shapes = [shapes.get((id(n), i)) for n, i in node.inputs]
        if any(s is None for s in in_shapes) and \
                node.op.infer_args is not None:
            try:
                full = node.op.infer_args(attrs, in_shapes)
            except Exception:
                full = in_shapes
            for (inode, _i), old, new in zip(node.inputs, in_shapes, full):
                if old is None and new is not None and inode.is_variable:
                    shapes[inode.name] = tuple(new)
                    shapes[(id(inode), 0)] = tuple(new)
                    dtypes.setdefault(inode.name, f32)
                    dtypes.setdefault((id(inode), 0), f32)
        in_avals, missing = [], []
        for inode, idx in node.inputs:
            key = (id(inode), idx)
            if shapes.get(key) is None:
                missing.append(inode.name if inode.is_variable
                               else "%s[%d]" % (inode.name, idx))
            else:
                in_avals.append((shapes[key], dtypes.get(key, f32)))
        if missing:
            events.append({"node": node.name, "op": node.op.name,
                           "missing_inputs": missing, "exception": None})
            continue
        try:
            metas = [torch.empty(tuple(s), dtype=torch_dtype(d),
                                 device="meta") for s, d in in_avals]
            outs = node.op.apply(attrs, metas, "meta")
        except Exception as exc:
            events.append({"node": node.name, "op": node.op.name,
                           "missing_inputs": [],
                           "exception": " ".join(str(exc).split())[:300]})
            continue
        for i, o in enumerate(outs):
            shapes[(id(node), i)] = tuple(o.shape)
            dtypes[(id(node), i)] = numpy_dtype(o.dtype)
    return shapes, dtypes


def infer_walk(symbol, shape_hints=None, type_hints=None):
    """Forward-propagate shapes/dtypes node by node, NEVER raising.

    Returns ``(shapes, dtypes, events)`` where ``shapes``/``dtypes`` map
    variable names and ``(id(node), out_idx)`` entries to their inferred
    values (None/absent where unknown), and ``events`` is a list of
    per-node failure records::

        {"node": name, "op": op_name,
         "missing_inputs": [input names with unknown shape],
         "exception": str or None}

    The walk is memoized on the symbol, keyed by the hints (mxtpu
    :22-67): the build seam runs it many times over one graph (each
    dataflow analysis, the verifier suite, hint enrichment and the
    certification gate), and a symbol does not change after it is made.
    Callers get fresh top-level dicts.
    """
    type_hints = {k: np_dtype(v) for k, v in (type_hints or {}).items()}
    key = (tuple(sorted((k, tuple(v) if v is not None else None)
                        for k, v in (shape_hints or {}).items())),
           tuple(sorted((k, dtype_name(v)) for k, v in type_hints.items())))
    memo = symbol.__dict__.setdefault("_infer_walk_memo", {})
    hit = memo.get(key)
    if hit is None:
        events = []
        shapes, dtypes = _walk(symbol, dict(shape_hints or {}), type_hints,
                               events)
        if len(memo) >= 8:   # a symbol sees a handful of hint sets, ever
            memo.clear()
        memo[key] = hit = (shapes, dtypes, events)
    shapes, dtypes, events = hit
    return dict(shapes), dict(dtypes), list(events)


def unknown_root_paths(symbol, shapes, node):
    """For each input of ``node`` whose shape is unknown, walk upstream to
    the root variables that lack a shape hint. Returns a list of paths,
    each a tuple of node names root→node (the provenance the error
    message prints as ``data -> fc1 -> relu1 -> fc2``)."""
    paths = []
    seen = set()

    def walk(n, idx, trail):
        key = (id(n), idx)
        if key in seen:
            return
        seen.add(key)
        if shapes.get(key) is not None:
            return
        if n.is_variable:
            paths.append(tuple(reversed(trail + [n.name])))
            return
        hit = False
        for inode, iidx in n.inputs:
            if shapes.get((id(inode), iidx)) is None:
                hit = True
                walk(inode, iidx, trail + [n.name])
        if not hit:
            # unknown output with fully-known inputs: the node itself
            # failed inference — it IS the root
            paths.append(tuple(reversed(trail + [n.name])))

    for inode, idx in node.inputs:
        if shapes.get((id(inode), idx)) is None:
            walk(inode, idx, [node.name])
    return paths


def known_shape_summary(symbol, shapes, limit=12):
    """The partially-inferred shape dict, rendered compactly: every
    ARGUMENT whose shape resolved (the part of the puzzle that worked),
    so the error shows what was inferred, not just what failed."""
    known = []
    unknown = []
    for name in symbol.list_arguments():
        s = shapes.get(name)
        (known if s is not None else unknown).append((name, s))
    parts = ["%s=%s" % (n, tuple(s)) for n, s in known[:limit]]
    if len(known) > limit:
        parts.append("... %d more" % (len(known) - limit))
    return {"inferred": ", ".join(parts) if parts else "(none)",
            "unknown_args": [n for n, _ in unknown]}


def describe_insufficient(symbol, node, shapes, hints=None):
    """The sharpened form of the old bare error
    ``infer_shape: insufficient information at node '%s'``: names the
    unknown inputs, the arg→node provenance path, and the partially-
    inferred shape dict. With ``hints`` (the caller's original shape
    hints), a FULL partial walk recomputes the shape dict — the caller's
    in-progress ``shapes`` stops at the failing node, hiding hints for
    arguments the walk never reached."""
    if hints is not None:
        shapes, _, _ = infer_walk(symbol, hints)
    paths = unknown_root_paths(symbol, shapes, node)
    roots = sorted({p[0] for p in paths})
    summary = known_shape_summary(symbol, shapes)
    lines = ["infer_shape: insufficient information at node '%s' (op %s)"
             % (node.name, node.op.name if node.op else "null")]
    if roots:
        lines.append("  unresolved argument(s): %s — pass their shapes to "
                     "infer_shape/bind" % ", ".join(roots))
    for p in paths[:6]:
        lines.append("  provenance: %s" % " -> ".join(p))
    if len(paths) > 6:
        lines.append("  ... %d more paths" % (len(paths) - 6))
    lines.append("  inferred so far: %s" % summary["inferred"])
    return "\n".join(lines)


def describe_unresolved_arg(symbol, arg_name, shapes, hints=None):
    """Sharpened form of ``cannot determine shape of argument '%s'``:
    names the consumers that needed the argument and what WAS inferred."""
    if hints is not None:
        shapes, _, _ = infer_walk(symbol, hints)
    consumers = []
    for node in symbol._topo():
        if node.is_variable:
            continue
        for inode, _ in node.inputs:
            if inode.is_variable and inode.name == arg_name:
                consumers.append(node.name)
                break
    summary = known_shape_summary(symbol, shapes)
    lines = ["infer_shape: cannot determine shape of argument '%s'"
             % arg_name]
    if consumers:
        lines.append("  consumed by: %s — none of them could back-infer it"
                     % ", ".join(consumers[:8]))
    else:
        lines.append("  the argument is never consumed by an op (unused "
                     "input?)")
    lines.append("  inferred so far: %s" % summary["inferred"])
    lines.append("  hint: pass %s=<shape> to infer_shape/simple_bind, or "
                 "set shape= on the Variable" % arg_name)
    return "\n".join(lines)

"""Network visualization (parity: python/mxnet/visualization.py —
print_summary, plot_network via graphviz if present).

The port's own copy of ``mxtpu/visualization.py``, which uses no JAX:
it reads only the Symbol's JSON and its shape inference, so the two
packages print the same summary of the same graph.
"""
from __future__ import annotations

import json

__all__ = ["print_summary", "plot_network"]

_PARAM_SUFFIXES = ("weight", "bias", "gamma", "beta")
_AUX_SUFFIXES = ("moving_mean", "moving_var")


def _prod(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def print_summary(symbol, shape=None, line_length=120,
                  positions=(.38, .54, .63, .72, 1.), dtype_bytes=4):
    """Print layer-by-layer summary (parity visualization.py
    print_summary), extended with a per-layer memory column.

    With ``shape`` given, each row shows the layer's output shape
    (batch dim stripped), its parameter count (from the inferred
    argument shapes — weight/bias/gamma/beta inputs), and its memory
    footprint in KB: parameter bytes (incl. aux moving stats) plus the
    activation bytes of its outputs at the given batch size, assuming
    ``dtype_bytes`` per element (4 = float32).

    Output shapes are resolved per (node, output-index) from the
    internals graph — NOT by name lookup — so multi-output layers and
    grouped symbols (``sym.Group``) report the right shapes instead of
    blanks or a colliding duplicate's."""
    show_shape = shape is not None
    node_out_shapes = {}   # node name -> {out idx -> full shape}
    arg_shape_dict = {}
    aux_shape_dict = {}
    if show_shape:
        internals = symbol.get_internals()
        # one whole-graph inference pass feeds all three dicts (internals
        # spans the same graph, so its arg/aux lists match symbol's)
        arg_shapes, out_shapes, aux_shapes = \
            internals.infer_shape_partial(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        for (node, idx), shp in zip(internals._outputs, out_shapes):
            if shp is None:   # partial inference: un-inferable node
                continue
            node_out_shapes.setdefault(node.name, {})[idx] = tuple(shp)
        arg_shape_dict = dict(zip(internals.list_arguments(),
                                  arg_shapes or []))
        aux_shape_dict = dict(zip(internals.list_auxiliary_states(),
                                  aux_shapes or []))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    if positions[-1] <= 1:
        positions = [int(line_length * p) for p in positions]
    if len(positions) == 4:
        # legacy 4-column tuple (pre-Mem-column callers): keep the
        # caller's widths, splice in a Mem column the width of Param #,
        # and rescale so the last column still ends at line_length
        mem_w = max(positions[2] - positions[1], 8)
        positions = [positions[0], positions[1], positions[2],
                     positions[2] + mem_w, positions[3] + mem_w]
        positions = [int(p * line_length / positions[-1])
                     for p in positions]
    elif len(positions) < 4:   # unusably short: fall back to defaults
        positions = [int(line_length * p) for p in (.38, .54, .63, .72, 1.)]
    to_display = ["Layer (type)", "Output Shape", "Param #", "Mem (KB)",
                  "Previous Layer"]

    def print_row(fields, positions):
        line = ""
        for i, field in enumerate(fields):
            line += str(field)
            line = line[:positions[i]]
            line += " " * (positions[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(to_display, positions)
    print("=" * line_length)

    total_params = [0]
    total_bytes = [0]

    def _layer_params_bytes(node):
        """(param count, param+aux bytes) from the node's null inputs."""
        n_params = 0
        n_bytes = 0
        for item in node["inputs"]:
            input_node = nodes[item[0]]
            if input_node["op"] != "null":
                continue
            pname = input_node["name"]
            if pname.endswith(_PARAM_SUFFIXES):
                pshape = arg_shape_dict.get(pname)
                if pshape:
                    n_params += _prod(pshape)
                    n_bytes += _prod(pshape) * dtype_bytes
            elif pname.endswith(_AUX_SUFFIXES):
                ashape = aux_shape_dict.get(pname)
                if ashape:   # aux stats occupy memory but aren't "params"
                    n_bytes += _prod(ashape) * dtype_bytes
        return n_params, n_bytes

    def print_layer_summary(node, out_shapes_of_node):
        op = node["op"]
        pre_node = []
        for item in node["inputs"]:
            input_node = nodes[item[0]]
            if input_node["op"] != "null" or item[0] in heads:
                pre_node.append(input_node["name"])
        cur_param, cur_bytes = (0, 0)
        if show_shape:
            cur_param, cur_bytes = _layer_params_bytes(node)
            for shp in out_shapes_of_node.values():
                cur_bytes += _prod(shp) * dtype_bytes
        # display convention (reference parity): batch dim stripped, one
        # shape per visible output
        disp = [s[1:] for _, s in sorted(out_shapes_of_node.items())]
        out_disp = str(disp[0] if len(disp) == 1 else disp) if disp else "[]"
        first_connection = pre_node[0] if pre_node else ""
        print_row([node["name"] + " (" + op + ")", out_disp, cur_param,
                   "%.1f" % (cur_bytes / 1024.0) if show_shape else 0,
                   first_connection], positions)
        for i in range(1, len(pre_node)):
            print_row(["", "", "", "", pre_node[i]], positions)
        total_params[0] += cur_param
        total_bytes[0] += cur_bytes

    heads = set(conf["arg_nodes"])
    for node in nodes:
        if node["op"] == "null":
            continue
        print_layer_summary(node, node_out_shapes.get(node["name"], {}))
        print("_" * line_length)
    print("Total params: %s" % total_params[0])
    if show_shape:
        print("Total memory (params + activations): %.1f KB"
              % (total_bytes[0] / 1024.0))
    print("_" * line_length)


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Graphviz plot (parity visualization.py plot_network). Requires graphviz."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("Draw network requires graphviz library")
    node_attrs = node_attrs or {}
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs)
    dot = Digraph(name=title, format=save_format)
    hidden_nodes = set()
    for node in nodes:
        op = node["op"]
        name = node["name"]
        attrs = node.get("attrs", {})
        if op == "null":
            if name.endswith("weight") or name.endswith("bias") or \
                    name.endswith("gamma") or name.endswith("beta") or \
                    name.endswith("moving_mean") or name.endswith("moving_var"):
                if hide_weights:
                    hidden_nodes.add(name)
                continue
            dot.node(name=name, label=name,
                     **dict(node_attr, fillcolor="#8dd3c7"))
        else:
            label = op
            if op == "Convolution":
                label = "Convolution\n%s/%s, %s" % (
                    attrs.get("kernel", "?"), attrs.get("stride", "(1,)"),
                    attrs.get("num_filter", "?"))
            elif op == "FullyConnected":
                label = "FullyConnected\n%s" % attrs.get("num_hidden", "?")
            elif op == "Activation" or op == "LeakyReLU":
                label = "%s\n%s" % (op, attrs.get("act_type", ""))
            elif op == "Pooling":
                label = "Pooling\n%s, %s/%s" % (
                    attrs.get("pool_type", "?"), attrs.get("kernel", "?"),
                    attrs.get("stride", "(1,)"))
            dot.node(name=name, label=label,
                     **dict(node_attr, fillcolor="#fb8072"))
        for item in node.get("inputs", []):
            input_name = nodes[item[0]]["name"]
            if input_name not in hidden_nodes:
                dot.edge(tail_name=input_name, head_name=name)
    return dot

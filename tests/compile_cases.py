"""Graphs and helpers shared by the compile-pipeline tests of the port
(``tests/test_torch_{compile,analysis,dataflow,transforms,equiv,quant,
sanitizer}.py``): the same symbol built by either package (``pkg`` is
``mxtpu`` or ``mxtpu_torch``), its input shapes, seeded weights, and the
findings of a report as comparable tuples."""
import numpy as np

#: name -> (make(pkg) -> symbol, input shapes); ResNet-50 v2 is built
#: for its graph only (no test runs it)
GRAPHS = {
    "mlp": (lambda pkg: pkg.models.mlp.get_symbol(10),
            {"data": (8, 784)}),
    "lenet": (lambda pkg: pkg.models.lenet.get_symbol(10),
              {"data": (4, 1, 28, 28)}),
    "resnet8": (lambda pkg: pkg.models.resnet.get_symbol(10, 8,
                                                         (3, 28, 28)),
                {"data": (4, 3, 28, 28)}),
    "resnet50": (lambda pkg: pkg.models.resnet.get_symbol(1000, 50,
                                                          (3, 224, 224)),
                 {"data": (2, 3, 224, 224)}),
    "lm2": (lambda pkg: pkg.models.transformer.get_symbol(
        61, 16, num_layers=2, num_heads=2, d_model=32),
            {"data": (2, 16)}),
}


def build(pkg, name):
    """(symbol, shapes) of graph ``name`` in ``pkg``, auto-named from a
    fresh counter (the same node names in both packages)."""
    fn, shapes = GRAPHS[name]
    with pkg.name.NameManager():
        return fn(pkg), dict(shapes)


def seeded_params(sym, shapes, seed=0, scale=0.1):
    """({arg: array}, {aux: array}) numpy f32 for every parameter and aux
    state (inputs and labels left out): uniform weights, moving variances
    near one."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {n: rng.uniform(-scale, scale, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes and n != "softmax_label"}
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("_var")
               else rng.uniform(-0.1, 0.1, s)).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def values_for(pkg, args):
    """The bound-parameter values a build context hands the quant pass,
    as ``pkg``'s arrays (jax for mxtpu, torch for the port)."""
    if pkg.__name__ == "mxtpu":
        import jax.numpy as jnp
        return {k: jnp.asarray(v) for k, v in args.items()}
    import torch
    return {k: torch.from_numpy(np.array(v)) for k, v in args.items()}


def findings(report):
    """A report's findings as (pass, severity, node, message) tuples."""
    return [(f.pass_name, f.severity, f.node, f.message)
            for f in report.findings]


def entries(report):
    """A PipelineReport's per-pass outcome, comparable across packages."""
    return [(e["name"], e["applied"], e["rejected"], e["cert_refused"],
             e["error"] is not None) for e in report.entries]

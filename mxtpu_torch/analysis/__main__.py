"""CLI: ``python -m mxtpu_torch.analysis [model.json] [--shape name=d,d,...]``.

Counterpart of ``mxtpu/analysis/__main__.py``: the same options, report
and exit status.

With no graph file, prints the registered pass catalog (what the
verifier can check). With a serialized graph, runs every pass —
including dead-node detection over the raw JSON node table — and prints
the findings; exit status 1 when anything at error severity fired,
so the command gates in CI.
"""
from __future__ import annotations

import argparse
import json
import sys


def _parse_shape(spec):
    name, _, dims = spec.partition("=")
    if not dims:
        raise argparse.ArgumentTypeError(
            "--shape wants name=d,d,... (e.g. data=1,3,32,32)")
    dims = dims.strip("()[] ")
    try:
        return name.strip(), tuple(int(d) for d in dims.split(",") if d)
    except ValueError:
        raise argparse.ArgumentTypeError("bad shape spec %r" % spec)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxtpu_torch.analysis",
        description="mxtpu_torch graph verifier: run the analysis pass suite "
                    "over a serialized Symbol (prefix-symbol.json).")
    ap.add_argument("graph", nargs="?",
                    help="graph JSON file (Symbol.save output); omitted, "
                         "the registered pass catalog is printed")
    ap.add_argument("--shape", action="append", type=_parse_shape,
                    default=[], metavar="NAME=D,D,...",
                    help="input shape hint (repeatable)")
    ap.add_argument("--passes", default=None,
                    help="comma-separated subset of passes to run")
    ap.add_argument("--pipeline", default=None, metavar="NAMES",
                    help="dry-run compile-pipeline transform passes "
                         "(comma-separated registry names, e.g. bf16) "
                         "and report what each did and why — per-node "
                         "provenance, verifier re-run, rejections")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    args = ap.parse_args(argv)

    from . import analyze_json, list_passes, list_transforms, sanitizer_mode

    if args.graph is None:
        passes = list_passes()
        print("mxtpu_torch.analysis: %d registered passes" % len(passes))
        for name, doc in passes:
            print("  %-16s %s" % (name, doc))
        transforms = list_transforms()
        print("compile-pipeline transforms (--pipeline): %d registered"
              % len(transforms))
        from . import get_transform
        for name, doc in transforms:
            algebra = getattr(get_transform(name), "algebra", None)
            print("  %-16s [%s] %s"
                  % (name, algebra or "no algebra", doc))
        print("sanitizer: MXTPU_SANITIZE=%s"
              % (sanitizer_mode() or "(unset; nan|inf|all)"))
        print("usage: python -m mxtpu_torch.analysis model.json "
              "[--shape data=1,3,32,32] [--pipeline bf16]")
        return 0

    with open(args.graph) as f:
        graph_json = f.read()
    report = analyze_json(
        graph_json, shapes=dict(args.shape),
        passes=[p.strip() for p in args.passes.split(",")]
        if args.passes else None)
    if args.pipeline:
        from ..symbol import load_json
        from ..symbol.symbol import _merge_pipeline_report
        report = _merge_pipeline_report(report, load_json(graph_json),
                                        dict(args.shape), args.pipeline)
    if args.json:
        print(json.dumps(report.to_dict(), indent=2))
    else:
        print(report.render())
    return 1 if report.errors else 0


if __name__ == "__main__":
    sys.exit(main())

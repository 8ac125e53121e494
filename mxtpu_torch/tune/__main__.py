"""``python -m mxtpu_torch.tune`` — the autotuner CLI (mxtpu's
``python -m mxtpu.tune``). The search's probes run on ``--ctx``
(``gpu``, the default: card 0; or ``cpu``).

Subcommands::

    search   run the offline search and emit a TunedConfig artifact
    show     print an artifact (values + provenance summary)
    catalog  print the knob catalog (markdown table; docs/tune.md embeds it)
    version  print the live knob-registry fingerprint
"""
from __future__ import annotations

import argparse
import json
import logging
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mxtpu_torch.tune",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd")
    s = sub.add_parser("search", help="offline search -> TunedConfig")
    s.add_argument("--fixture", default="mlp",
                   help="serving fixture the probes run on")
    s.add_argument("--ctx", default="gpu", choices=("gpu", "cpu"),
                   help="device the probes run on (gpu: card 0)")
    s.add_argument("--buckets", default="1,8",
                   help="serving bucket sizes for the probes")
    s.add_argument("--top-k", type=int, default=3,
                   help="predicted candidates to actually measure")
    s.add_argument("--no-probe", action="store_true",
                   help="rank only (skip the probe runs)")
    s.add_argument("--out", default="tuned.json",
                   help="artifact path to write")
    p = sub.add_parser("show", help="print an artifact")
    p.add_argument("artifact")
    sub.add_parser("catalog", help="print the knob catalog table")
    sub.add_parser("version", help="print the knob-registry fingerprint")
    args = ap.parse_args(argv)

    if args.cmd == "catalog":
        from . import registry
        print(registry.catalog_table())
        return 0
    if args.cmd == "version":
        from . import registry
        print(registry.registry_version())
        return 0
    if args.cmd == "show":
        from . import config
        cfg = config.TunedConfig.load(args.artifact, strict=True)
        print(json.dumps({"registry_version": cfg.registry_version,
                          "created": cfg.created,
                          "values": cfg.values,
                          "provenance_events":
                          [e.get("event") for e in cfg.provenance]},
                         indent=1, sort_keys=True))
        return 0
    if args.cmd == "search":
        logging.basicConfig(level=logging.INFO)
        from ..context import cpu, gpu
        from . import searcher
        buckets = tuple(int(b) for b in args.buckets.split(","))
        searcher.search(fixture=args.fixture, buckets=buckets,
                        top_k=args.top_k, probe=not args.no_probe,
                        out=args.out,
                        ctx=gpu(0) if args.ctx == "gpu" else cpu())
        return 0
    ap.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())

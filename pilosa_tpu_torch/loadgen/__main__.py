"""CLI: ``python -m pilosa_tpu_torch.loadgen <scenario> [options]``.

The port's copy of pilosa_tpu/loadgen/__main__.py. Runs one scenario --
against a managed in-process cluster of the port's nodes, on the card
unless ``--device cpu``, by default, or a live deployment via
``--target`` -- and writes its SLO report.

    python -m pilosa_tpu_torch.loadgen smoke --out slo.json
    python -m pilosa_tpu_torch.loadgen mixed --target http://h1:10101,http://h2:10101
    python -m pilosa_tpu_torch.loadgen --list
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    from pilosa_tpu_torch.loadgen.engine import run_scenario
    from pilosa_tpu_torch.loadgen.scenario import Scenario
    from pilosa_tpu_torch.loadgen.scenarios import SCENARIOS, get_scenario
    from pilosa_tpu_torch.loadgen.target import AttachedTarget

    ap = argparse.ArgumentParser(
        prog="python -m pilosa_tpu_torch.loadgen",
        description="open-loop scenario harness: drive a live "
                    "node/cluster, emit an SLO report")
    ap.add_argument("scenario", nargs="?",
                    help="built-in scenario name, or a path to a "
                         "scenario JSON file")
    ap.add_argument("--list", action="store_true",
                    help="list built-in scenarios and exit")
    ap.add_argument("--target", default="",
                    help="comma-separated base URLs of a live cluster "
                         "(default: boot a managed in-process cluster)")
    ap.add_argument("--out", default="",
                    help="write the SLO report JSON here")
    ap.add_argument("--seed", type=int, default=None,
                    help="override the scenario seed")
    ap.add_argument("--duration", type=float, default=None,
                    help="override duration_s")
    ap.add_argument("--rate", type=float, default=None,
                    help="override offered rate (arrivals/s)")
    ap.add_argument("--quiet", action="store_true",
                    help="don't print the report to stdout")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where a managed cluster's nodes keep their data "
                         "and run their kernels (default: the card)")
    args = ap.parse_args(argv)

    if args.list:
        for name in sorted(SCENARIOS):
            print(f"{name:20s} {SCENARIOS[name].__doc__.splitlines()[0]}")
        return 0
    if not args.scenario:
        ap.error("scenario name required (or --list)")

    if args.scenario.endswith(".json"):
        with open(args.scenario) as f:
            sc = Scenario.from_dict(json.load(f))
    else:
        sc = get_scenario(args.scenario)
    if args.seed is not None:
        sc.seed = args.seed
    if args.duration is not None:
        sc.duration_s = args.duration
    if args.rate is not None:
        sc.rate = args.rate

    target = None
    if args.target:
        target = AttachedTarget(args.target.split(","))
    report = run_scenario(sc, target=target, out=args.out or None,
                          device=args.device)
    if not args.quiet:
        print(json.dumps(report, indent=2, sort_keys=True))
    if args.out:
        print(f"# SLO report written to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

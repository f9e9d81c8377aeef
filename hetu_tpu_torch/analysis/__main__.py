"""``python -m hetu_tpu_torch.analysis`` — preflight the model zoo from
the command line.

Counterpart of ``python -m hetu_tpu.analysis``. Builds each registered
zoo graph (:mod:`.zoo`) with its canonical feed shapes, runs the static
passes (:func:`~hetu_tpu_torch.analysis.analyze`), and prints each
model's findings. Exit status 1 when any model has errors.

The JAX package's ``--all`` (the zoo with every self-lint, numerics
and efficiency in one report) and ``--jit-purity`` need passes that
are ROADMAP item 17d; both are refused, naming it, with exit status 2.
The numerics and efficiency passes run inside :func:`analyze`, and
alone as ``python -m hetu_tpu_torch.analysis.numerics`` and ``python -m
hetu_tpu_torch.analysis.efficiency``.
"""
from __future__ import annotations

import argparse
import sys

# the reference's options whose passes are still to port -> their item
REFUSED = {"all": ("--all", "item 17d (the PS wire check and the "
                            "self-lints)"),
           "jit_purity": ("--jit-purity", "item 17d (the self-lints)")}


def _run_zoo(names, json_out, hbm_budget):
    from . import analyze, zoo
    failed = []
    for name in names:
        eval_nodes, feed_shapes = zoo.build(name)
        report = analyze(eval_nodes, feed_shapes=feed_shapes,
                         hbm_budget=hbm_budget)
        status = "FAIL" if report.errors else "ok"
        print(f"== {name}: {status} ({len(report.errors)} errors, "
              f"{len(report.warnings)} warnings)")
        if json_out:
            print(report.to_json())
        else:
            for f in report.errors + report.warnings:
                print("   " + str(f))
        if report.errors:
            failed.append(name)
    return failed


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m hetu_tpu_torch.analysis",
        description="static preflight over the model zoo")
    parser.add_argument("models", nargs="*",
                        help="zoo model names (default: all)")
    parser.add_argument("--list", action="store_true",
                        help="list registered zoo models and exit")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable findings")
    parser.add_argument("--hbm-budget", default=None, metavar="BYTES",
                        help="device-memory budget for the memory pass "
                             "(e.g. 8G, 512MiB; default: "
                             "$HETU_HBM_BUDGET or the card's memory)")
    parser.add_argument("--jit-purity", action="store_true",
                        help="refused: the self-lints are ROADMAP "
                             "item 17d")
    parser.add_argument("--all", action="store_true",
                        help="refused: the aggregate report needs "
                             "ROADMAP item 17d")
    args = parser.parse_args(argv)
    for dest, (flag, item) in REFUSED.items():
        if getattr(args, dest):
            print(f"analysis: {flag} is not ported yet: it waits for "
                  f"ROADMAP {item}", file=sys.stderr)
            return 2

    from . import zoo
    if args.list:
        print("\n".join(sorted(zoo.ZOO)))
        return 0

    names = args.models or sorted(zoo.ZOO)
    unknown = [n for n in names if n not in zoo.ZOO]
    if unknown:
        parser.error(f"unknown zoo model(s) {unknown}; "
                     f"--list shows the registry")

    failed = _run_zoo(names, args.json, args.hbm_budget)
    if failed:
        print(f"preflight: {len(failed)}/{len(names)} zoo model(s) "
              f"failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

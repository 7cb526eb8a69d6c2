"""CLI: ``python -m repro_torch.analysis [--pass name,...] [--all]
[--list] [-q] [--device DEV]``.

Exit status 0 = every selected pass clean; 1 = findings (printed one per
line, prefixed with their invariant code); 2 = a bad argument.  The
default selection is the static set (contracts, ladder, obs), which
executes nothing.  ``--pass recompile`` (or ``--all``) also runs a tiny
ladder fill and bounds the loads of its kernel library, on the card
unless ``--device`` names another device (``--device cpu``: the plain
path, which builds nothing).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import analysis


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's invariant analyzer: stage contracts, "
                    "ladder equivalence, obs contract, recompile guard")
    ap.add_argument("--pass", dest="passes", default=None,
                    help="comma-separated pass subset "
                         f"(know: {', '.join(analysis.PASSES)}; "
                         f"default: {', '.join(analysis.STATIC_PASSES)})")
    ap.add_argument("--all", action="store_true",
                    help="run every pass incl. the executing recompile "
                         "guard")
    ap.add_argument("--list", action="store_true",
                    help="list passes and exit")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress progress; print findings only")
    ap.add_argument("--device", default=None,
                    help="device of the recompile guard's fill (default: "
                         "the card)")
    args = ap.parse_args(argv)

    if args.list:
        for p in analysis.PASSES:
            tag = "" if p in analysis.STATIC_PASSES else "  (executes)"
            print(f"{p}{tag}")
        return 0

    if args.passes:
        selected = [p.strip() for p in args.passes.split(",") if p.strip()]
        unknown = [p for p in selected if p not in analysis.PASSES]
        if unknown:
            ap.error(f"unknown pass(es) {unknown}; know {analysis.PASSES}")
    elif args.all:
        selected = list(analysis.PASSES)
    else:
        selected = list(analysis.STATIC_PASSES)

    progress = (lambda msg: None) if args.quiet else \
        (lambda msg: print(msg, file=sys.stderr))

    findings = []
    for p in selected:
        progress(f"[analysis] pass: {p}")
        got = analysis.run_pass(p, progress=progress, device=args.device)
        progress(f"[analysis]   {len(got)} finding(s)")
        findings += got

    for f in findings:
        print(f)
    if findings:
        print(f"[analysis] FAILED: {len(findings)} finding(s) across "
              f"{len(selected)} pass(es)", file=sys.stderr)
        return 1
    progress(f"[analysis] OK: {len(selected)} pass(es) clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI: rollup / verify / diff obs traces and BENCH_sweep artifacts.

    PYTHONPATH=src python -m repro_torch.obs report TRACE.jsonl
    PYTHONPATH=src python -m repro_torch.obs report TRACE.jsonl --check BENCH.json
    PYTHONPATH=src python -m repro_torch.obs diff OLD.json NEW.json [--warn-pct 20]

``report`` prints the trace rollup (derived fill records, span totals,
counters, and each fill's counters: a job's, where a job is one fill);
``--check`` re-derives every ladder-fill record from the raw
JSONL and compares it field-by-field against the artifact's
``ladder_fills`` (exit 1 on any mismatch — the artifact is then NOT a
faithful readout of the run).  ``diff`` compares two artifacts'
wall-time fields and reports regressions over the threshold; it exits 0
(warn-only) unless ``--fail`` is given — CI uses warn-only so noisy
container timings cannot block a merge.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import report


def _load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_rep = sub.add_parser("report", help="rollup a JSONL trace")
    p_rep.add_argument("trace", help="path to a trace .jsonl")
    p_rep.add_argument("--check", metavar="BENCH_JSON", default=None,
                       help="verify this BENCH_sweep artifact against "
                            "the trace (exit 1 on mismatch)")
    p_rep.add_argument("--json", action="store_true",
                       help="print the rollup as JSON")

    p_diff = sub.add_parser("diff", help="compare two BENCH artifacts")
    p_diff.add_argument("old")
    p_diff.add_argument("new")
    p_diff.add_argument("--warn-pct", type=float, default=20.0,
                        help="wall-time regression threshold (default 20)")
    p_diff.add_argument("--fail", action="store_true",
                        help="exit 1 when regressions exceed the threshold")

    args = ap.parse_args(argv)

    if args.cmd == "report":
        events = report.read_trace(args.trace)
        roll = report.rollup(events, trace_file=args.trace)
        roll["fill_counters"] = report.fill_counters(events)
        if args.json:
            print(json.dumps(roll, indent=2, sort_keys=True))
        else:
            print(f"trace: {args.trace}  ({roll['n_events']} events)")
            for i, rec in enumerate(roll["fills"]):
                print(f"fill[{i}]: " + json.dumps(rec, sort_keys=True))
            for name, t in sorted(roll["spans"].items()):
                print(f"span {name:<18} n={t['count']:<5} "
                      f"dur_s={t['dur_s']}")
            for name, c in sorted(roll["events"].items()):
                print(f"event {name:<17} n={c}")
            for name, c in sorted(roll["counters"].items()):
                print(f"counter {name:<15} n={c}")
            for i, f in enumerate(roll["fill_counters"]):
                print(f"fill_counters[{i}] {f['fill']}: "
                      + json.dumps(f["counters"], sort_keys=True))
        if args.check:
            problems = report.check(events, _load_json(args.check),
                                    trace_file=args.trace)
            if problems:
                for p in problems:
                    print(f"CHECK FAIL: {p}", file=sys.stderr)
                return 1
            print(f"check OK: {args.check} matches the trace "
                  f"({len(roll['fills'])} fills, bit-exact)")
        return 0

    if args.cmd == "diff":
        res = report.diff(_load_json(args.old), _load_json(args.new),
                          warn_pct=args.warn_pct)
        print(json.dumps({k: res[k] for k in ("fills", "old_only")},
                         indent=2))
        for r in res["regressions"]:
            print(f"WARNING: wall-time regression: {r}", file=sys.stderr)
        if res["regressions"] and args.fail:
            return 1
        return 0

    return 2  # pragma: no cover - argparse enforces a subcommand


if __name__ == "__main__":
    sys.exit(main())

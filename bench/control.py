"""The control of a cell's correctness check: the plain reference put in
the program's place, with its float32 sums accumulated in bfloat16 (the
nearest precision below the configuration's float32), and compared by
the cell's own check with the float32 reference, lane by lane, at the
cell's own trace length.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line a seed: the lanes compared and ``leaf_mismatches``,
the number the check holds to its limit of 0 (the control must exceed
it).  The benchmark's runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control(cell, seed: int) -> dict:
    """The control's readings on one job's sampled lanes of `seed`."""
    from bench.lib import check as chk
    from bench.lib.jobs import job_seed, system_config

    n = int(cell.config["trace_length"])
    cfgs = {s: system_config(cell.config, s) for s in cell.traffic["systems"]}
    lanes = chk.sample_lanes(cell.traffic, 1, seed)
    out = {}
    for dtype in ("float32", "bfloat16"):
        out[dtype] = chk.run_reference(
            [(cfgs[s], w, n, job_seed(seed, j), dtype) for j, s, w in lanes],
            chk.default_workers())
    bad = [chk.compare(low, ref)
           for low, ref in zip(out["bfloat16"], out["float32"])]
    return {"cell": cell.name, "seed": seed, "lanes": len(lanes),
            "leaf_mismatches": sum(len(b) for b in bad),
            "lanes_differing": sum(1 for b in bad if b),
            "leaves": sorted({x for b in bad for x in b})}


def main(argv=None) -> int:
    from bench.lib import manifest

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = manifest.cell(args.workload)
    for s in args.seeds:
        t0 = time.perf_counter()
        got = control(cell, s)
        got["seconds"] = time.perf_counter() - t0
        print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once, on the card, and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; both are files under ``bench/``, and the
traffic's ``kind`` names the module under ``bench/kinds/`` that runs its
jobs and checks them.  A run sets up (imports, the CUDA context, the
kernel library, one warm-up job of the cell's own shape), then runs jobs
back to back, each on traces of its own seed, until the first job that
ends at or after ``--seconds``: that is the measured window.  Then it
checks a sample of the window's results against the plain reference,
and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted`` and ``failed`` (jobs), ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics,
read under ``torch.profiler`` over the window), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number the
check compared, with its limit.

Exit codes: 2 when no card (or too few) is visible, 3 when a module of
JAX or of the JAX package is loaded once the window has closed; a run
that cannot set up raises (1).  Nothing is printed to standard output in
those cases.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# top-level module names no process that prints a result may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# where a run's own files go, inside the checkout (listed in .gitignore)
RUN_DIR = os.path.join(ROOT, "build", "bench")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def measure(cell, seed: int, seconds: float, trace: bool, device="cuda",
            n: int | None = None, workers: int | None = None) -> dict:
    """Set up, run the window and check it; returns the result object
    (without the device's name, which ``main`` adds).  ``n`` overrides
    the configuration's trace length and ``workers`` the reference's
    processes (tests on the CPU use both)."""
    import torch

    import repro_torch.obs as obs
    from bench.lib import check as chk
    from bench.lib import devtrace, manifest
    from bench.lib.jobs import WARMUP, job_seed

    kind = manifest.kind(cell.traffic)
    n = n or kind.trace_length(cell)
    on_card = torch.device(device).type == "cuda"
    log: list[str] = []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    checks, pre_log = kind.pre_check(cell)
    log += pre_log
    # checks the kind makes after the warm-up and after every job: the
    # largest reading of each is compared with its limit
    after: dict = {}

    def after_job():
        for k, (v, lim) in kind.after_job(cell).items():
            after[k] = (max(v, after.get(k, (v, lim))[0]), lim)

    kind.run_job(cell, n, job_seed(seed, WARMUP), device)  # warm-up
    sync()
    after_job()
    setup_s = time.perf_counter() - T_START

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    jobs, failed, peak = [], 0, 0
    tracer = obs.tracer()
    with prof if prof is not None else contextlib.nullcontext():
        w0 = time.perf_counter()
        while True:
            i = len(jobs)
            s = job_seed(seed, i)
            e0 = len(tracer.events)
            cpu0 = time.process_time()
            t0 = time.perf_counter()
            wall0 = time.time()
            try:
                with (torch.profiler.record_function(devtrace.JOB_SPAN)
                      if prof is not None else contextlib.nullcontext()):
                    results = kind.run_job(cell, n, s, device)
                    sync()
            except Exception as e:  # a job that fails ends the window
                failed += 1
                log.append(f"job {i} failed: {type(e).__name__}: {e}")
                t1 = time.perf_counter()
                break
            t1 = time.perf_counter()
            cpu_s = time.process_time() - cpu0
            after_job()
            if on_card:
                peak = max(peak, torch.cuda.max_memory_allocated())
            jobs.append({"index": i, "seed": s, "t0_host": t0, "t1_host": t1,
                         "wall0": wall0, "results": results, "cpu_s": cpu_s,
                         "events": tracer.events[e0:]})
            if t1 - w0 >= seconds:
                break
    window_s = t1 - w0
    for j in jobs:
        events = j.pop("events")
        j["span_events"] = [e for e in events if e.get("kind") == "span"]
        j.update(kind.job_record(cell, n, j["results"], events))
    checks.update(after)

    ctx = SimpleNamespace(setup_s=setup_s, window_s=window_s, jobs=jobs,
                          device=[], window=(0.0, 0.0))
    out = {"attempted": len(jobs) + failed, "failed": failed}
    dev = {"busy_s": None, "window_s": None}
    if prof is not None:
        dev, out["breakdown"] = read_trace(prof, cell.name, jobs, ctx)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = manifest.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    floors = [j["floor"] for j in jobs if "floor" in j]
    if floors:
        log.append("floor: " + ", ".join(
            f"job {j['index']} {f['floor_s'] * 1e3:.3f} ms bound by "
            f"{f['bound']} (rounds {f['rounds_s'] * 1e3:.3f} ms, bytes "
            f"{f['bytes_s'] * 1e3:.3f} ms)"
            for j, f in list(zip(jobs, floors))[:3]))
    log.append(f"window: {len(jobs)} jobs in {window_s:.3f} s; set-up "
               f"{setup_s:.3f} s; device memory peak {peak} bytes")
    log.append("job seconds: " + " ".join(
        f"{j['t1_host'] - j['t0_host']:.3f}" for j in jobs))
    # the process's own processor time (all its threads) beside each
    # job's wall time: host noise shows as both growing together
    log.append("job process seconds: " + " ".join(
        f"{j['cpu_s']:.2f}" for j in jobs))

    # the program's device state is freed before the reference runs
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    got, ref_log = kind.check(
        cell, n, jobs, seed,
        chk.default_workers() if workers is None else workers)
    checks.update(got)
    log += ref_log
    log.append(f"reference: {time.perf_counter() - t_ref:.3f} s")
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    out.update(correct=correct, metrics=metrics,
               device=dict(count=cell.chips, memory_peak_bytes=peak, **dev),
               checks={k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()},
               log=log)
    return out


def read_trace(prof, name: str, jobs: list, ctx):
    """Put the profiler's clock into ``jobs`` (``t0``, ``t1``) and ``ctx``
    (the window and its device operations); returns the device's busy and
    window seconds and the breakdown."""
    from bench.lib import devtrace

    os.makedirs(RUN_DIR, exist_ok=True)
    path = os.path.join(RUN_DIR, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    tr = devtrace.load(path)
    os.remove(path)
    spans = tr["jobs"]
    if len(spans) != len(jobs) or not jobs:
        raise RuntimeError(f"the profiler's trace holds {len(spans)} job "
                           f"spans for {len(jobs)} jobs")
    for j, (a, b) in zip(jobs, spans):
        j["t0"], j["t1"] = a, b
    lo, hi = spans[0][0], spans[-1][1]
    ctx.device = [d for d in tr["device"] if d[2] > lo and d[1] < hi]
    ctx.window = (lo, hi)
    busy = devtrace.union((a, b) for _n, a, b in ctx.device)
    dev = {"busy_s": devtrace.length(devtrace.clip(busy, lo, hi)) * 1e-6,
           "window_s": (hi - lo) * 1e-6}
    return dev, breakdown(tr, jobs, busy, lo, hi)


def breakdown(tr: dict, jobs: list, busy, lo: float, hi: float) -> dict:
    """The window's device operations that took most time, and its
    longest idle gaps labelled by what the host was doing."""
    from bench.lib import devtrace

    # the program's own spans (host wall clock) moved onto the trace's
    # clock by each job's start
    spans = []
    for j in jobs:
        off = j["t0"] - j["wall0"] * 1e6
        for e in j["span_events"]:
            spans.append((e["name"], e["t0"] * 1e6 + off,
                          (e["t0"] + e["dur_s"]) * 1e6 + off))
    gaps = sorted(devtrace.gaps(busy, lo, hi), key=lambda g: g[0] - g[1])
    return {"device_ops": devtrace.top_ops(tr["device"], lo, hi),
            "idle_gaps": [[devtrace.label_gap(a, b, tr["host"], spans),
                           (b - a) * 1e-6] for a, b in gaps[:10]]}


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from bench.lib import manifest

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"no result: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    # the program's result cache goes to a directory of the run's own,
    # emptied here: no job may find an entry there or leave one behind
    cache_dir = os.path.join(RUN_DIR, "sim_cache")
    shutil.rmtree(cache_dir, ignore_errors=True)
    os.environ["REPRO_TORCH_SIM_CACHE"] = cache_dir
    os.environ["REPRO_OBS_DIR"] = os.path.join(RUN_DIR, "obs")
    out = measure(cell, args.seed, args.seconds, bool(args.trace))
    import repro_torch.obs as obs
    trace_file = obs.tracer().path
    obs.tracer().close()
    if os.path.exists(trace_file):
        os.remove(trace_file)
    bad = forbidden_modules()
    if bad:
        print(f"no result: modules of JAX or of the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    log = out.pop("log")
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "power_limit_w": power_limit(), **out["device"]}
    if not args.trace:
        out["device"].pop("busy_s")
        out["device"].pop("window_s")
    result = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                                  "device")}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    for line in log:
        print(line, file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def power_limit():
    """The card's power limit in W as ``nvidia-smi`` reads it, or None."""
    import subprocess
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(got.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    sys.exit(main())

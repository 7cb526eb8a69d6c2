"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version on the card, drives the port's main
path (``repro_torch.sim.runner.run_batch`` over all 11 workloads, radix
and Victima at the Table-3 defaults) against the JAX package's snapshot
``tests/golden/torch_fullsize_stats.json``, and times it.  Any failed
check raises, so the exit code is non-zero; no phase's failure is
caught.  With no CUDA device, or without the repository around it, it
exits non-zero and prints no result.

The last line of standard output is ``{"ok": true, "device": ...}``; the
line before it is the ``{"kernels": [...]}`` record.  Imports neither
jax nor the JAX package.
"""
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)

# tests/golden_trace.py, copied so this script needs no JAX
GOLDEN_CFG = dict(l2tlb_sets=4, l2tlb_ways=4, l1d4_sets=2, l1d4_ways=2,
                  l1d2_sets=2, l1d2_ways=2, l2_sets=64, l2_ways=8,
                  l3_sets=64, l3_ways=8, n_pages4=1 << 12, n_pages2=1 << 8,
                  n_pagesh=1 << 8, n_feat=1)
GOLDEN_SYSTEMS = {"radix": {}, "victima": {"victima": True}}


def golden_trace(n: int = 6000, seed: int = 1234) -> dict:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4096, size=n)
    cyc = np.tile(np.arange(512), n // 512 + 1)[:n]
    pages = np.where(rng.random(n) < 0.5, cyc, base).astype(np.int32)
    return {
        "vpn": pages,
        "is2m": rng.random(n) < 0.25,
        "line": (pages * 64 + rng.integers(0, 64, size=n)).astype(np.int32),
        "ipa": np.full((n,), 3.0, np.float32),
    }


SYSTEMS = ("radix", "victima")
CHECK_N = 2000      # accesses of the kernel-vs-plain check at Table 3
UNIT_N = 512        # accesses of the timed kernel-vs-plain unit
SOURCES = ("mmu_step", "load_latency")  # csrc/*.cu, built side by side
FULL_N = 20_000     # main path against the JAX snapshot
TIMED_N = 150_000   # main path at the runner's default length


def phase(name):
    print(f"\n== {name}", flush=True)
    return time.perf_counter()


def cuda_time(fn, reps=1):
    """Median milliseconds of `fn()` between CUDA events."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def load_latency_ns(lib, footprint: int, dev) -> float:
    """Nanoseconds of one dependent load over a chain of 128-byte lines
    spread at random over `footprint` bytes (csrc/load_latency.cu)."""
    lines = footprint // 128
    perm = np.random.default_rng(0).permutation(lines).astype(np.int64) * 32
    nxt = np.zeros(lines * 32, np.int32)
    nxt[perm] = np.roll(perm, -1)
    nxt_d = torch.from_numpy(nxt).to(dev)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    lib.chase_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_void_p]
    steps = 200_000

    def chase(n):
        err = lib.chase_launch(nxt_d.data_ptr(), int(perm[0]), n,
                               out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"chase launch failed: CUDA error {err}")

    chase(2 * lines)  # brings the chain into the cache level under test
    ms = cuda_time(lambda: chase(steps), reps=3)
    if int(out.item()) != int(perm[steps % lines]):
        raise AssertionError("pointer chase ended at the wrong line")
    return ms * 1e6 / steps


def latency_floor(cfg, st, l1_ns: float, l2_ns: float):
    """Least time of the scan that left `st` under the dependent-load
    model, from its Stats: (ms, rounds per access).

    Each access of csrc/mmu_step.cu is a chain of load rounds, each
    issued after a __syncwarp or branch on the last one's result.  Rounds
    on the lane's small structures (TLBs, PWCs, L1D tags) are charged
    the L1-hit latency, rounds on the L2 and L3 rows and the PTW-CP
    counters (too large for an SM's L1) the L2-hit latency.  Rounds
    whose count the Stats do not hold (a Victima refill of a demand
    walk's block, an L2 insert after a background line or a prefetch,
    walk levels beyond one per walk or per L3 probe) are left out, so
    this is a floor.  Lanes run side by side: the floor is the slowest
    lane's.
    """
    s, h = st.stats, st.hier
    acc = s.n_access.double()
    walks = (s.n_demand_ptw + s.n_bg_ptw).double()
    levels = torch.maximum(walks, h.n_l3_trans.double())  # walk L2 rows
    l2a, l2m = h.n_l2_access.double(), h.n_l2_miss.double()
    # small: the stats read, L1-TLB probe, L2-TLB probe and fill, the two
    # L1-TLB fills, L1D probe and fill; per walk the PWC probe and fills
    small = 8 * acc + 4 * walks
    # large: per access the data line's L2 and L3 rows, the prefetch's L2
    # row, two background L3 rows; on an L1D miss the L2 touch or (L2
    # miss) the L3 aging and the L2 insert; per walk level its L2 and L3
    # rows and the touch or aging, and the insert on an L2 miss
    big = (5 * acc + (l2a - l2m) + 2 * l2m + 3 * levels
           + h.n_l3_trans.double())
    if cfg.victima:
        small = small + acc                   # L2-TLB victim tag
        big = big + 2 * acc + s.n_bg_ptw.double()  # probe, counters, retag
    else:
        big = big + s.n_demand_ptw.double()   # PTW-CP counter update
    ns = small * l1_ns + big * l2_ns
    return (float(ns.max()) / 1e6,
            float(((small + big) / acc).mean()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import metrics, mmu, timing
    from repro_torch.core.stages import (SimConfig, default_stages,
                                         make_state, state_leaves)
    from repro_torch.kernels import build, mmu_step
    from repro_torch.sim import runner, systems, trace_gen

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    # ------------------------------------------------------------ 1
    t = phase("1. device and build")
    kind = torch.cuda.get_device_name(0)
    print(f"device {kind}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")
    print(smi)
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = dict(zip(SOURCES, pool.map(build.compile_kernel, SOURCES)))
    for src, built in builds.items():
        print(f"built {src} in {built['seconds']:.2f} s")
        for ln in built["log"].splitlines():
            if any(w in ln for w in ("registers", "spill", "smem", "stack")):
                print("  " + ln.strip())
    chase = build.load("load_latency")
    l1_ns = load_latency_ns(chase, 16 << 10, dev)
    l2_ns = load_latency_ns(chase, 16 << 20, dev)
    print(f"dependent load: {l1_ns:.1f} ns at a 16 KiB footprint (L1 hit), "
          f"{l2_ns:.1f} ns at 16 MiB (L2 hit)")
    print(f"phase 1: {time.perf_counter() - t:.1f} s")

    def leaves(st):
        return [x.cpu().numpy() for x in state_leaves(st)]

    def max_err(a, b):
        """Largest |kernel - plain| over every leaf (exact: must be 0)."""
        assert len(a) == len(b)
        err = 0.0
        for i, (x, y) in enumerate(zip(a, b)):
            assert x.dtype == y.dtype and x.shape == y.shape, i
            err = max(err, float(np.max(np.abs(
                x.astype(np.float64) - y.astype(np.float64)), initial=0.0)))
        return err

    def on_card(tr):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in tr.items()}

    def run_both(cfg, tr):
        """State leaves after the kernel and after the plain version."""
        names = default_stages(cfg)
        W = tr["vpn"].shape[1]
        stk, stp = make_state(cfg, W, dev), make_state(cfg, W, dev)
        ctr = on_card(tr)
        mmu_step.launch(stk, ctr, cfg, names)
        mmu_step.plain_scan(mmu.make_step(cfg, names), stp, ctr)
        torch.cuda.synchronize()
        return leaves(stk), leaves(stp)

    # ------------------------------------------------------------ 2
    t = phase("2. kernel against its plain version, on the card")
    workloads = trace_gen.all_workloads()
    t0 = time.perf_counter()
    gens = trace_gen.generate_many(workloads, n=TIMED_N, seed=0)
    gen_s = time.perf_counter() - t0
    main_tr = {k: np.stack([g["trace"][k] for g in gens], axis=1)
               for k in gens[0]["trace"]}
    main_tr["ipa"] = np.broadcast_to(np.asarray(
        [g["spec"].ipa for g in gens], np.float32),
        (TIMED_N, len(gens))).copy()
    pair = [workloads.index("rnd"), workloads.index("bc")]
    check_tr = {k: v[:CHECK_N, pair] for k, v in main_tr.items()}
    worst, kernel_leaves = 0.0, {}
    for name in SYSTEMS:
        t0 = time.perf_counter()
        k, p = run_both(systems.config(name), check_tr)
        kernel_leaves[name] = k
        err = max_err(k, p)
        worst = max(worst, err)
        if err != 0.0:
            raise AssertionError(f"{name}: kernel differs from the plain "
                                 f"version (max abs err {err})")
        print(f"{name} Table-3, rnd+bc, {CHECK_N} accesses: kernel == "
              f"plain on all {len(k)} leaves ({time.perf_counter() - t0:.1f}"
              f" s)")
    with open(os.path.join(ROOT, "tests", "golden", "mmu_stats.json")) as f:
        golden = json.load(f)
    for name, over in GOLDEN_SYSTEMS.items():
        cfg = SimConfig(**GOLDEN_CFG, **over)
        stats, _ = mmu.simulate(cfg, golden_trace(), device=dev)
        for field, want in golden[name].items():
            got = np.asarray(getattr(stats, field)).tolist()
            if got != want:
                raise AssertionError(f"golden {name}.{field}: {got} != "
                                     f"{want}")
        print(f"golden {name}: kernel == tests/golden/mmu_stats.json")
    cfg = systems.config("victima")
    st = make_state(cfg, 2, dev)
    mmu_step.launch(st, on_card(check_tr), cfg, default_stages(cfg),
                    block=97)
    torch.cuda.synchronize()
    if max_err(kernel_leaves["victima"], leaves(st)) != 0.0:
        raise AssertionError("the result depends on the trace-block size")
    print("victima with 97-access blocks == one block")
    print(f"phase 2: {time.perf_counter() - t:.1f} s")

    # ------------------------------------------------------------ 3
    t = phase(f"3. main path at full width against the JAX snapshot "
              f"(n={FULL_N})")
    with open(os.path.join(ROOT, "tests", "golden",
                           "torch_fullsize_stats.json")) as f:
        snap = json.load(f)
    assert (snap["n"], snap["seed"], snap["workloads"]) == \
        (FULL_N, 0, workloads), "snapshot settings"
    for w, g in zip(workloads, trace_gen.generate_many(workloads, n=FULL_N,
                                                       seed=0)):
        h = hashlib.sha256()
        for k in ("vpn", "is2m", "line"):
            h.update(g["trace"][k].tobytes())
        if h.hexdigest() != snap["trace_sha256"][w]:
            raise AssertionError(f"{w}: the port's trace differs from the "
                                 f"one the snapshot was made from")
    print("traces: all 11 equal the snapshot's (sha256)")
    for name in SYSTEMS:
        mmu_step.LAUNCHES = 0
        out = runner.run_batch(name, n=FULL_N, seed=0, cache=False)
        launches = mmu_step.LAUNCHES
        if launches == 0:
            raise AssertionError(f"{name}: the main path launched no kernel")
        for w in workloads:
            stats, extras, _ = out[w]
            want = snap["systems"][name][w]
            for field, v in want["stats"].items():
                if np.asarray(getattr(stats, field)).tolist() != v:
                    raise AssertionError(f"{name}/{w}: Stats.{field} "
                                         f"differs from the snapshot")
            for key, v in want["extras"].items():
                if np.asarray(extras[key]).tolist() != v:
                    raise AssertionError(f"{name}/{w}: extras[{key!r}] "
                                         f"differs from the snapshot")
        print(f"{name}: 11 workloads equal the JAX snapshot on every Stats "
              f"leaf and extra ({launches} launches)")
    print(f"phase 3: {time.perf_counter() - t:.1f} s")

    # ------------------------------------------------------------ 4
    t = phase(f"4. timing: the main path at n={TIMED_N}")
    W = len(workloads)
    print(f"trace generation alone (11 workloads, generate_many): "
          f"{gen_s:.2f} s")
    results, main_launches = {}, {}
    for name in SYSTEMS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mmu_step.LAUNCHES = 0
        t0 = time.perf_counter()
        results[name] = runner.run_batch(name, n=TIMED_N, seed=0,
                                         cache=False)
        wall = time.perf_counter() - t0
        main_launches[name] = mmu_step.LAUNCHES
        if main_launches[name] == 0:
            raise AssertionError(f"{name}: the main path launched no kernel")
        peak = torch.cuda.max_memory_allocated() / 2**20
        # the kernel alone on the same inputs, between CUDA events
        cfg = systems.config(name)
        st = make_state(cfg, W, dev)
        ctr = on_card(main_tr)
        kms = cuda_time(lambda: mmu_step.launch(st, ctr, cfg,
                                                default_stages(cfg)))
        print(f"{name}: run_batch wall {wall:.2f} s, kernel {kms:.1f} ms "
              f"({main_launches[name]} launches), "
              f"{TIMED_N / kms * 1e3:,.0f} accesses/s per lane, "
              f"{TIMED_N * W / kms * 1e3:,.0f} accesses/s over {W} lanes, "
              f"peak device memory {peak:.0f} MiB")
    print(f"{'workload':9s} {'PTW red.':>9s} {'Victima hits':>13s} "
          f"{'reach MB':>9s} {'speedup':>8s}")
    for w in workloads:
        base, _, spec = results["radix"][w]
        vic = results["victima"][w][0]
        print(f"{w:9s} {metrics.ptw_reduction(base, vic) * 100:8.1f}% "
              f"{int(vic.n_victima_hit):13d} "
              f"{metrics.translation_reach_mb(vic):9.1f} "
              f"{(timing.speedup(base, vic, spec.ipa) - 1) * 100:7.1f}%")
    print(f"phase 4: {time.perf_counter() - t:.1f} s")

    # ------------------------------------------------------------ 5
    t = phase(f"5. kernel vs plain version: Victima, {UNIT_N} accesses x "
              f"{W} lanes")
    cfg = systems.config("victima")
    names = default_stages(cfg)
    unit = on_card({k: v[:UNIT_N] for k, v in main_tr.items()})
    warm = make_state(cfg, W, dev)
    mmu_step.launch(warm, unit, cfg, names)  # module load, caches
    states = [make_state(cfg, W, dev) for _ in range(3)]
    it = iter(states)
    ms = cuda_time(lambda: mmu_step.launch(next(it), unit, cfg, names),
                   reps=3)
    stp = make_state(cfg, W, dev)
    plain_ms = cuda_time(lambda: mmu_step.plain_scan(
        mmu.make_step(cfg, names), stp, unit))
    unit_err = max_err(leaves(states[0]), leaves(stp))
    if unit_err != 0.0:
        raise AssertionError(f"timed unit: kernel differs from plain "
                             f"({unit_err})")
    # roofline: the trace read once, and each state byte the unit changed
    # (against the state it started from) written once; the step has no
    # arithmetic to speak of, so bytes bound it
    nbytes = sum(x.numel() * x.element_size() for x in unit.values())
    for a, b in zip(leaves(states[0]), leaves(make_state(cfg, W, dev))):
        nbytes += int((a != b).sum()) * a.itemsize
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_ms, rounds = latency_floor(cfg, states[0], l1_ns, l2_ns)
    print(f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, max abs err "
          f"{unit_err}; bytes bound {bound_ms:.5f} ms ({nbytes:,} bytes); "
          f"latency floor {chain_ms:.3f} ms ({rounds:.1f} dependent load "
          f"rounds per access, L1 {l1_ns:.1f} ns, L2 {l2_ns:.1f} ns)")
    print(f"phase 5: {time.perf_counter() - t:.1f} s")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "mmu_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mmu_step.cu",
        "replaces": "src/repro/kernels/mmu_step.py:105",
        "launches": main_launches["victima"],
        "launches_by_system": main_launches,
        "max_abs_err": max(worst, unit_err),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None,
        "latency_floor_ms": chain_ms, "load_rounds_per_access": rounds,
        "l1_hit_ns": l1_ns, "l2_hit_ns": l2_ns,
        "unit": f"victima, Table-3 defaults, first {UNIT_N} accesses x "
                f"{W} lanes",
        "matches_plain": True, "matches_reference": True}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

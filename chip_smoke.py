"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, in
parallel, and drives its paths on the card:

- the simulator (phases 2-5): the ``mmu_step`` kernel against its plain
  PyTorch version in each placement of the lane's state (all in shared
  memory at Table 3; the L2 cache, or the L2 TLB, in device memory) and
  for each system of the L3-TLB, POM-TLB and nested-paging compositions
  (``STAGED``) and of the Table-2, Utopia and Revelator ones (``PAPER``),
  ``repro_torch.sim.runner.run_batch`` over all 11
  workloads (radix and Victima, then each of ``STAGED`` and ``PAPER``,
  at the Table-3 defaults, every launch in shared memory and of the
  system's composition) against the JAX package's snapshots
  ``tests/golden/torch_fullsize_stats.json``,
  ``torch_fullsize_stages_stats.json`` and
  ``torch_fullsize_paper_stats.json``, timed, with each composition's
  latency floor and, from the kernel's profiled build, its cycles per
  access by stage;
- the last systems (phases 2-4): Utopia and Revelator under nested
  paging (``VIRT2``) and the twelve multicore systems (``MULTICORE``,
  each on ``sim.paper.MC_MIX`` over its cores, the mix's first
  component at one core) against the plain version (at Table 3, and the
  DRAM-cache systems also on small structures where the DRAM cache
  hits), against ``tests/golden/torch_fullsize_multicore_stats.json``
  at n = 20,000 core by core, and timed at n = 150,000 with floors that
  count the DRAM-cache probes;
- the ladders (phases 2-4 and 4b): the three ladder instantiations of
  the kernel (``ladder_native``, ``ladder_np``, ``ladder_mc``) against
  the plain dyn step on the native, nested and ``radix_2c`` ladders'
  base configs, small and at Table 3, one lane a member (a multicore
  member's lanes one a core); ``run_ladder`` of all five ladders at
  n = 20,000 against the four JAX snapshots, every member and workload
  (the multicore ones on their mix); the native ladder's fill at
  n = 150,000 timed beside its 28 members' static kernel runs, each
  lane equal to its member's;
- the paper's tables (phase 12): every figure function of
  ``repro_torch.sim.paper`` (ladder members through ``run_ladder``) at
  n = 20,000 against the reference's rows in
  ``torch_fullsize_paper_stats.json`` and, for ``multicore_scaling``,
  ``torch_fullsize_multicore_stats.json`` (Table 2's MLPs trained from the
  reference's initial weights, within ``MLP_TOL``), then the whole table
  at n = 150,000 from a fresh result cache, timed per figure;
- serving granite-3-2b (phases 6-8): the ``flash_attention`` (prefill;
  bf16 on the tensor cores, float32 on the CUDA cores, each call
  checked to have taken its dtype's kernel) and ``paged_attention``
  (decode; each case in the form its plan picks and in the other) kernels
  against their plain versions at the JAX tests' shapes, granite's, and
  bf16 at hd 128, with windows, ragged S != Sk and the model's strided
  views, the paged kernel also at hd 128 and 256, ragged clusters and
  qwen3-32b's 4096-token geometry; the model at full width, 2 layers,
  against the JAX snapshot ``tests/golden/torch_granite_fullwidth.json``;
  then at full width and depth, 8 requests x 512 prompt tokens and 64
  greedy decode steps, counted (one flash launch per layer per prefill,
  all on the bf16 tensor-core kernel; one paged launch per layer per
  step, all in its plan's form), checked against the plain path and
  timed, with the flash kernel's registers, shared memory and TFLOP/s,
  and the paged kernel's warm, rotated over the 40 layers' caches, in
  its other form, and at qwen3-32b's and recurrentgemma-2b's decode
  geometries beside SDPA;
- serving mamba2-2.7b (phases 9-11): the ``ssd_intra`` kernels (bf16 in
  ``model`` rounding on the tensor cores, every other call on the CUDA
  cores; each call checked to have taken its route) against their plain
  version in both roundings at the JAX test's shapes, the smoke config's,
  the tensor-core kernel's edges and the full prefill's (B and C per
  group, x strided as the model holds it); the model at full width, 2
  layers, against the JAX
  snapshot ``tests/golden/torch_mamba2_fullwidth.json``, and in float32
  its chunked forward against the token-by-token recurrence; then at
  full width and depth, 8 requests x 512 prompt tokens (one ssd_intra
  launch per layer, all on the tensor-core kernel) and 64 greedy decode
  steps from ``init_cache``, counted, checked against the plain path and
  timed, with the kernel's registers, shared memory and TFLOP/s;
- the serving engine (phase 13; plain PyTorch, no kernel of its own):
  ``benchmarks/serve_bench.py``'s matrix, ``benchmarks/serving.py``'s
  decode storm with 64 clusters and with 1, and 64 slots over 4096 pages
  at 6 requests a tick, through ``repro_torch.serve.load.run_load`` and
  ``engine.decode_step``, each against the JAX snapshot
  ``tests/golden/torch_serve.json`` (records but their timing fields,
  arrival digests first, the storms' state digests) and the records
  against the offline ``serve_record`` of the phase's trace, with the
  decode tick's p50 and p99, requests/s, launches a tick (three ticks
  in the middle of each run, each replayed on a copy of its state under
  ``torch.profiler``) and the VTC hit rate; then Victima time-sharded
  over the ``mmu_step`` kernel (one launch a round) against its serial
  run;
- serving the other families (phases 14-16) through the same two
  attention kernels: granite-moe-1b-a400m (the experts of
  ``repro_torch.models.moe``) and seamless-m4t-medium (the
  encoder-decoder) at full width, 2 layers, against the JAX snapshots
  ``tests/golden/torch_granite_moe_fullwidth.json`` (the card's routes
  first: a request whose gate gap is under ROUTE_GAP or whose experts
  flipped is left out and counted) and ``torch_seamless_fullwidth.json``
  (decode over a cross cache holding the encoder's projection), then at
  full depth, 8 requests x 512 tokens and 64 greedy decode steps,
  counted, timed and profiled; qwen3-32b (qk_norm), mixtral-8x7b (window,
  top-2 experts) and qwen2-vl-7b (M-RoPE over a vision grid) at full
  width, 2 layers, kernel path against plain path, and mixtral's smoke
  ring (window 32, pages of 16) in float32 past its wrap;
- serving recurrentgemma-2b (phase 17), the hybrid of RG-LRU blocks and
  local attention: the bf16 flash kernel at hd 256 (10 query heads on
  one kv head) against its plain version at the prefill's shape, where
  the window binds, ragged and in the model's strided views, timed
  beside SDPA with its registers and spills; the model at full width, 3
  layers (one superblock), against the JAX snapshot
  ``tests/golden/torch_recurrentgemma_fullwidth.json``; then at full
  depth, 26 layers, 8 requests x 512 tokens and 64 greedy decode steps
  from ``init_cache`` over a ring of 640 slots, counted (8 flash launches
  a prefill, 8 paged a step), timed, profiled, and checked against the
  plain path.

Any failed check raises, so the exit code is non-zero; no phase's
failure is caught.  With no CUDA device, or without the repository around it, it
exits non-zero and prints no result.

The last line of standard output is ``{"ok": true, "device": ...}``; the
line before it is the ``{"kernels": [...]}`` record.  Imports neither
jax nor the JAX package.
"""
import ctypes
import dataclasses
import hashlib
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

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
# the systems of the L3-TLB, POM-TLB and nested-paging compositions ->
# the composition (mmu_step.COMPOSITIONS) each must launch
STAGED = {"pom": "pom", "l3tlb_64k_15": "l3tlb", "l3tlb_64k_24": "l3tlb",
          "l3tlb_64k_39": "l3tlb", "np": "np", "victima_virt": "victima_np",
          "pom_virt": "pom_np", "isp": "radix"}
# the systems of the Table-2, Utopia and Revelator compositions -> the
# composition each must launch; phase 2 checks all but utopia_rs8 (the
# instantiation of utopia and utopia_rs32, at 16 ways) against the plain
# version
PAPER = {"radix_collect": "radix_collect", "utopia": "utopia",
         "utopia_rs8": "utopia", "utopia_rs32": "utopia",
         "utopia_victima": "utopia_victima", "revelator": "revelator",
         "revelator_victima": "revelator_victima"}
PAPER_PLAIN = [n for n in PAPER if n != "utopia_rs8"]
# Utopia and Revelator under nested paging -> their composition; phase 2
# checks both against the plain version
VIRT2 = {"utopia_virt": "utopia_np", "revelator_virt": "revelator_np"}
# the multicore systems -> their composition (the one-core members but
# victima_dramc_1c run the single-core instantiations); each runs on
# MC_MIX (its first component alone at one core), as multicore_scaling
# gives it them
_MC_COMP = {"radix": "radix_mc", "victima": "victima_mc", "pom": "pom_mc",
            "victima_dramc": "victima_dramc"}
MULTICORE = {f"{k}_{c}c": _MC_COMP[k] if c > 1 or k == "victima_dramc" else k
             for c in (1, 2, 4) for k in _MC_COMP}
# phase 2's multicore checks against the plain version at Table 3: one
# 2-core and one 4-core system of each kind
MULTICORE_PLAIN = [f"{k}_{c}c" for k in ("radix", "victima", "pom",
                                         "victima_dramc") for c in (2, 4)]
# and on small structures (SMALL, a 64 x 8 DRAM cache), where the DRAM
# cache hits
MC_SMALL = {"victima_dramc_2c": dict(dram_cache_sets=64, dram_cache_ways=8),
            "victima_dramc_4c": dict(dram_cache_sets=64, dram_cache_ways=8)}
# Table 2's MLPs trained on the card from the reference's initial weights
# against the reference's results: accuracy, precision, recall and F1
# within this (the two trainers' float32 sums differ in order)
MLP_TOL = 0.005
CHECK_N = 2000      # accesses of the kernel-vs-plain check at Table 3
# processes that run STAGED's plain versions on the CPU during phase 2
# (on the card the plain step waits on the host, one small kernel at a
# time); the card's machine has 8 cores
PLAIN_WORKERS = 6
# a system of each other placement (mmu_step.placement), checked at
# PLACED_N accesses: the L2 cache, then the L2 TLB, in device memory
PLACED = {"victima_l2_8m": "l2_device", "radix_l2_8m": "l2_device",
          "l2tlb_128k": "l2tlb_device"}
PLACED_N = 1000
UNIT_N = 512        # accesses of the timed kernel-vs-plain unit
# the libraries, built side by side: csrc/<name>.cu, and mmu_step_prof,
# mmu_step.cu with its per-stage clock64() stamps (build.VARIANTS)
LIBRARIES = ("mmu_step", "mmu_step_prof", "load_latency", "flash_attention",
             "paged_attention", "ssd_scan")
FULL_N = 20_000     # main path against the JAX snapshot
TIMED_N = 150_000   # main path at the runner's default length
# each ladder on small structures (tests/test_torch_ladder_gpu.py's): one
# lane a member flavour whose union is the ladder's base composition
SMALL = dict(l2tlb_sets=4, l2tlb_ways=4, l1d4_sets=2, l1d4_ways=2,
             l1d2_sets=2, l1d2_ways=2, l2_sets=64, l2_ways=8, l3_sets=64,
             l3_ways=8, n_pages4=1 << 12, n_pages2=1 << 8, n_pagesh=1 << 8,
             l3tlb_ways=4, pom_sets=16, pom_ways=4, restseg4_sets=16,
             restseg2_sets=8, restseg_ways=4, rev_sets=16, rev_ways=4,
             rev_sig_bits=10)
SMALL_LADDERS = {
    "radix": [dict(), dict(utopia=True, victima=True, restseg_ways=8),
              dict(revelator=True), dict(revelator=True, victima=True),
              dict(pom=True), dict(l3tlb_sets=16, l3tlb_lat=24),
              dict(victima=True, l2_sets=16, l2_ways=4),
              dict(l2tlb_sets=2, l2tlb_ways=2, l2tlb_lat=17)],
    "np": [dict(virt=True), dict(virt=True, victima=True, l2_sets=16,
                                 l2_ways=4), dict(virt=True, pom=True),
           dict(virt=True, utopia=True), dict(virt=True, revelator=True)],
    "radix_2c": [dict(n_cores=2, shared_tier_stats=True, **v) for v in (
        dict(), dict(victima=True), dict(pom=True),
        dict(victima=True, dram_cache_sets=64, dram_cache_ways=8))],
}
# the ladder instantiation each ladder's launches must run
LADDER_COMP = {"radix": "ladder_native", "np": "ladder_np",
               "radix_2c": "ladder_mc"}
# the multicore ladders (all of ladder_mc); phase 3 fills each on its mix
MC_LADDERS = ("radix_1c", "radix_2c", "radix_4c")
SMALL_N = 3000      # accesses of the small ladders' kernel-vs-plain check


def plain_leaves(name: str, tr: dict, over=None) -> list:
    """The plain version (the port's stage pipeline, access by access) of
    system `name` at its registered sizes (changed by `over`) over the
    numpy trace `tr` (leaves [T, W]), on the CPU of a worker process: its
    state leaves."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.set_num_threads(1)
    from repro_torch.core import mmu
    from repro_torch.core.stages import (default_stages, make_state,
                                         state_leaves)
    from repro_torch.kernels import mmu_step
    from repro_torch.sim import systems
    cfg = dataclasses.replace(systems.config(name), **(over or {}))
    st = make_state(cfg, tr["vpn"].shape[1])
    mmu_step.plain_scan(mmu.make_step(cfg, default_stages(cfg)), st,
                        {k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in tr.items()})
    return [x.numpy() for x in state_leaves(st)]


def ladder_setup(ladder: str, small: bool):
    """(base config, per-lane Dyn on the CPU) of `ladder`: on small
    structures (SMALL_LADDERS) or its registered members at Table 3, one
    lane a member, a multicore member's lanes one a core."""
    from repro_torch.core.stages import Dyn, SimConfig, dyn_of, stack_dyns
    from repro_torch.sim import systems
    if small:
        cfgs = [SimConfig(**{**SMALL, **v}) for v in SMALL_LADDERS[ladder]]
        base = systems.dyn_base_config(cfgs)
        dyn = stack_dyns([dyn_of(c) for c in cfgs])
    else:
        base = systems.ladder_base_config(ladder)
        dyn = systems.ladder_dyn(systems.LADDERS[ladder])
    return base, Dyn(*[x.repeat_interleave(base.n_cores) for x in dyn])


def plain_dyn_leaves(ladder: str, small: bool, tr: dict) -> list:
    """The plain dyn step of `ladder` (``ladder_setup``) over the numpy
    trace `tr` (leaves [T, lanes]), on the CPU of a worker process: its
    state leaves."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.set_num_threads(1)
    from repro_torch.core import mmu
    from repro_torch.core.stages import (default_stages, make_state,
                                         state_leaves)
    from repro_torch.kernels import mmu_step
    base, dyn = ladder_setup(ladder, small)
    st = make_state(base, tr["vpn"].shape[1])
    mmu_step.plain_scan(mmu.make_step(base, default_stages(base), dyn), st,
                        {k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in tr.items()})
    return [x.numpy() for x in state_leaves(st)]


def sha256_of(*arrays) -> str:
    """sha256 over the arrays' bytes, in order (the paper snapshot's
    digests of the feats and pc4 extras and of Table 2's dataset)."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


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


def device_ms(fn, reps=20):
    """Milliseconds of device time per `fn()`: `reps` calls between CUDA
    events, queued behind a spin of the card (torch.cuda._sleep) so that
    the host's time to issue them does not leave the card waiting inside
    the timed window."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms at the H100's clocks
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def load_latency_ns(lib, footprint: int, dev, shared: bool = False) -> float:
    """Nanoseconds of one dependent load over a chain of 128-byte lines
    spread at random over `footprint` bytes of device memory, or (shared)
    of 4-byte words over `footprint` bytes of shared memory
    (csrc/load_latency.cu)."""
    stride = 1 if shared else 32
    lines = footprint // (4 * stride)
    perm = np.random.default_rng(0).permutation(lines).astype(np.int64) * stride
    nxt = np.zeros(lines * stride, np.int32)
    nxt[perm] = np.roll(perm, -1)
    nxt_d = torch.from_numpy(nxt).to(dev)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    lib.chase_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.chase_shared_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_longlong,
                                        ctypes.c_void_p, ctypes.c_void_p]
    steps = 200_000

    def chase(n):
        if shared:
            err = lib.chase_shared_launch(nxt_d.data_ptr(), len(nxt),
                                          int(perm[0]), n, out.data_ptr(),
                                          stream)
        else:
            err = lib.chase_launch(nxt_d.data_ptr(), int(perm[0]), n,
                                   out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"chase launch failed: CUDA error {err}")

    chase(2 * lines)  # brings the chain into the cache level under test
    ms = cuda_time(lambda: chase(steps), reps=3)
    if int(out.item()) != int(perm[steps % lines]):
        raise AssertionError("pointer chase ended at the wrong line")
    return ms * 1e6 / steps


def latency_floor(cfg, st, sm_ns: float, l1_ns: float, l2_ns: float):
    """Least time of the scan that left `st`, under the dependent-round
    model of csrc/mmu_step.cu, from its Stats: (ms, rounds per access).

    Each access is a chain of rounds, each a row read whose tag compare
    decides the next.  A round is charged the latency of the place that
    holds its row under the launch's placement (mmu_step.placement):
    shared memory, or in device memory the L1-hit latency where the
    structure fits in the L1 left beside the shared memory, else the
    L2-hit latency.  Rounds: the first of every access (the L1 TLBs, L2
    TLB, L1D, PWCs, Victima probe, L3-TLB or POM-shadow rows, RestSeg
    and signature-table rows, read together); per walk level, POM-TLB
    line, RestSeg tag line and host-walk level an L2-cache row, and an L3
    row where it misses the L2 (a verification walk of Revelator counts
    one level at least); per nested translation its nested-TLB row (shared memory), and under Victima its
    nested-TLB-block probe's L2 row where the nested TLB missed; per
    background walk its PWC rows and the retag's L2 row; the two
    background lines' L3 rows (read together); on an L1D miss the data
    line's L2 row (the prefetch's is read with it), and on an L2 miss its
    L3 row; with a DRAM cache, each of its probes (an L3 miss of the data
    line or of a PTE line) one row more.  The instructions between the
    rounds, the rounds whose count the Stats do not hold (walk levels
    beyond one a walk or one an L3 probe, L2 inserts after a background
    line, a Victima retag of a demand walk or a translation, the
    nested-TLB evictions' background host walks) and the counter reads
    (issued ahead of their use) are left out, so this is a floor.  Lanes
    run side by side: the floor is the slowest lane's.
    """
    from repro_torch.kernels import mmu_step
    pl = mmu_step.placement(cfg)
    l1_room = 256 * 1024 - pl.smem_bytes  # the SM's L1 beside the shared

    def dev_ns(nbytes):
        return l1_ns if nbytes <= l1_room else l2_ns

    l2_place = sm_ns if pl.l2_shared else dev_ns(
        6 * cfg.l2_sets * cfg.l2_ways)
    tlb_place = sm_ns if pl.l2tlb_shared else dev_ns(
        9 * cfg.l2tlb_sets * cfg.l2tlb_ways)
    l3_place = dev_ns(9 * cfg.l3_sets * cfg.l3_ways)
    first = max(tlb_place, l2_place if cfg.victima else sm_ns)
    if cfg.l3tlb_sets:
        first = max(first, dev_ns(9 * cfg.l3tlb_sets * cfg.l3tlb_ways))
    if cfg.pom:
        first = max(first, dev_ns(9 * cfg.pom_sets * cfg.pom_ways))
    if cfg.utopia:
        first = max(first, dev_ns(9 * cfg.restseg4_sets * cfg.restseg_ways))
    if cfg.revelator:  # the signature row and its enrolled pages
        first = max(first, dev_ns(13 * cfg.rev_sets * cfg.rev_ways))
    s, h = st.stats, st.hier
    acc = s.n_access.double()
    bgw = s.n_bg_ptw.double()
    host = s.n_host_ptw.double()
    # nested translations: each hits the nested TLB, a Victima nested-TLB
    # block, or walks the host table
    nested = s.n_ntlb_hit.double() + s.n_nvictima_hit.double() + host
    pte = s.n_demand_ptw.double() + bgw + 4 * host
    if cfg.pom:  # every access past the L2 TLB reads its POM line
        pte = pte + s.n_l2tlb_miss.double() - s.n_victima_hit.double()
    if cfg.utopia:  # every RestSeg probe reads its tag line
        pte = pte + s.n_restseg_hit.double() + s.n_restseg_miss.double()
    if cfg.revelator:  # a verification walk (one level at least) a hit
        pte = pte + s.n_rev_hit.double() + s.n_rev_mispred.double()
    levels = torch.maximum(pte, h.n_l3_trans.double())
    l2m = h.n_l2_miss.double()
    l2_rounds = levels + h.n_l2_access.double()
    if cfg.victima:
        l2_rounds = l2_rounds + bgw + host + s.n_nvictima_hit.double()
    l3_rounds = h.n_l3_trans.double() + acc + l2m
    sm_rounds = bgw + nested
    dc_rounds = h.n_dramc_access.double()
    dc_place = dev_ns(9 * max(cfg.dram_cache_sets, 1) * cfg.dram_cache_ways)
    ns = (acc * first + sm_rounds * sm_ns + l2_rounds * l2_place
          + l3_rounds * l3_place + dc_rounds * dc_place)
    return (float(ns.max()) / 1e6,
            float(((acc + sm_rounds + l2_rounds + l3_rounds + dc_rounds)
                   / acc).mean()))


def latency_floor_device(cfg, st, l1_ns: float, l2_ns: float):
    """The same floor for a kernel that keeps the whole state in device
    memory and reads a row again for every probe, touch and insert (the
    first CUDA version of the scan; kept for comparison with earlier
    records): (ms, rounds per access).

    Rounds on the lane's small structures (TLBs, PWCs, L1D tags) are
    charged the L1-hit latency, rounds on the L2 and L3 rows and the
    PTW-CP counters the L2-hit latency.  Rounds whose count the Stats do
    not hold are left out, as above.
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


# ---------------------------------------------------------------- attention

BF16_TFLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate (data sheet)
F32_TFLOPS = 67e12     # H100 SXM float32 rate outside the tensor cores
TOL = {torch.float32: 1e-5}   # the JAX kernel tests' tolerances
FLASH_BF16_TOL, PAGED_BF16_TOL = 2e-2, 3e-2
# tests/test_kernels_flash.py's shapes, then granite-3-2b's prefill
FLASH_SHAPES = [(1, 128, 2, 2, 32), (2, 256, 4, 2, 64), (1, 256, 8, 1, 64),
                (2, 128, 6, 3, 16), (8, 512, 32, 8, 64)]
# bf16 only, where float32 has no kernel or no need: (B, S, Sk, H, K, hd,
# causal, model layout) -- ragged S and Sk (no multiple of a tile, Sk !=
# S), hd 128 (the width of the dense configs queued next), and the
# model's [B,S,H,hd] views at hd 128
FLASH_BF16_CASES = [(2, 77, 200, 4, 2, 64, True, False),
                    (2, 77, 200, 4, 2, 64, False, False),
                    (2, 200, 77, 4, 2, 64, True, False),
                    (2, 320, 320, 8, 2, 128, True, False),
                    (2, 320, 320, 8, 2, 128, False, False),
                    (2, 512, 512, 32, 8, 128, True, True)]
# the prefills of phases 14-16 (bf16, the model's [B,S,H,hd] views): (B,
# S, Sk, H, K, hd, causal, window) -- granite-moe-1b-a400m (G 2);
# seamless-m4t-medium's encoder (non-causal), decoder self-attention and
# cross-attention (G 1, S != Sk as in the snapshot's shapes); qwen3-32b
# (G 8), mixtral-8x7b with its window (G 4), qwen2-vl-7b (G 7)
FLASH_MODEL_CASES = [(8, 512, 512, 16, 8, 64, True, None),
                     (8, 512, 512, 16, 16, 64, False, None),
                     (8, 512, 512, 16, 16, 64, True, None),
                     (2, 256, 384, 16, 16, 64, False, None),
                     (2, 256, 256, 64, 8, 128, True, None),
                     (2, 256, 256, 32, 8, 128, True, 4096),
                     (2, 300, 300, 32, 8, 128, True, 128),
                     (2, 256, 256, 28, 4, 128, True, None)]
FLASH_KERNEL = {torch.float32: "fma_f32", torch.bfloat16: "mma_bf16"}
# quoted, not measured by this script: the bf16 flash kernel's time at
# granite's prefill when it ran on the CUDA cores, before the
# tensor-core kernel (earlier runs of this script, NVIDIA H100 80GB HBM3,
# 700 W; PERF.md's kernel table); printed on a line of its own, never in
# the kernels line, whose numbers are all this run's
QUOTED_CUDA_CORE_FLASH_MS = 1.0821
# (B, H, K, hd, page, nb, P, lens): tests/test_kernels_paged.py's
# shapes, granite-3-2b's decode (a cache of 1024 positions in pages of
# 128), hd 128 at G 7 (qwen2-vl-7b) and G 8, hd 256 at G 10 on one kv head
# (recurrentgemma-2b), a ragged batch whose lens leave whole CTAs of a
# 16-CTA cluster empty, lens == nb * page, and qwen3-32b's decode
# geometry at 4096 tokens; lens None draws them in [1, nb * page)
PAGED_SHAPES = [(2, 4, 2, 64, 64, 4, 16, None), (1, 8, 1, 32, 32, 8, 16, None),
                (4, 4, 4, 16, 16, 2, 32, None),
                (8, 32, 8, 64, 128, 8, 64, None),
                (2, 14, 2, 128, 64, 4, 16, None),
                (2, 16, 2, 128, 64, 4, 16, None),
                (4, 10, 1, 256, 64, 8, 32, None),
                (4, 8, 2, 64, 64, 16, 64, (1, 65, 130, 1000)),
                (2, 8, 2, 64, 64, 4, 8, (256, 256)),
                (8, 64, 8, 128, 128, 32, 256, (4096,) * 8),
                # the decodes of phases 14-16: granite-moe (G 2, a cache
                # of 640), seamless's cross-attention (G 1, lens the whole
                # cross cache), qwen3-32b (G 8) and mixtral-8x7b (G 4)
                (8, 16, 8, 64, 128, 5, 40, (576,) * 8),
                (8, 16, 16, 64, 128, 4, 32, (512,) * 8),
                (2, 64, 8, 128, 128, 3, 6, None),
                (2, 32, 8, 128, 128, 3, 6, None)]
# decode geometries of the dense configs the paged kernel now takes,
# timed in phase 8 beside SDPA: (name, B, H, K, hd, page, nb, lens)
PAGED_LONG = [("qwen3-32b", 8, 64, 8, 128, 128, 32, 4096),
              ("recurrentgemma-2b", 8, 10, 1, 256, 128, 16, 2048)]
FORM = {True: "cluster", False: "two_pass"}   # plan().clustered -> name
SNAP_TOL = 2e-2        # full-width logits against the JAX snapshot
# kernel path against plain path, bf16 logits at full depth: the flash
# kernel rounds p to bf16 where the plain version does not, and 40 layers
# carry that to the logits (a CPU emulation of that rounding at 40
# layers, d_model 512, moved logits of size ~1.3 by 3.0e-2)
SERVE_TOL = 5e-2
SERVE_B, SERVE_PROMPT, SERVE_CACHE, SERVE_STEPS = 8, 512, 1024, 64


def close(got, want, tol, what):
    """Max |got - want|; raises unless |got - want| <= tol + tol*|want|
    everywhere (numpy's assert_allclose with atol = rtol = tol)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite output")
    if bool((diff > tol + tol * w.abs()).any()):
        raise AssertionError(f"{what}: max abs err {float(diff.max())} "
                             f"beyond the tolerance {tol}")
    return float(diff.max())


def close_scaled(got, want, tol, what):
    """Max |got - want|; raises unless it is at most tol * max |want|
    (a bound at the scale of the whole tensor, for logits)."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite output")
    err, scale = float((g - w).abs().max()), float(w.abs().max())
    if err > tol * scale:
        raise AssertionError(f"{what}: max abs err {err} beyond {tol} of the "
                             f"largest value {scale}")
    return err


def flash_ops(q, k, causal, window=None):
    """Operations flash attention needs on these inputs: 4*hd per
    (query, key) pair the masks keep (q.k and p.v, a multiply and an add
    each)."""
    B, H, S, hd = q.shape
    Sk = k.shape[2]
    qpos = torch.arange(S)[:, None]
    kpos = torch.arange(Sk)[None, :]
    keep = torch.ones(S, Sk, dtype=torch.bool)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= qpos - kpos < window
    return 4 * hd * B * H * int(keep.sum())


def flash_bound_ms(q, k, causal, window=None):
    """Least time of flash attention on these inputs: q, k, v read once
    and o written once over the memory rate, or the operations the masks
    keep (flash_ops) over the peak rate of the dtype."""
    ops_ = flash_ops(q, k, causal, window)
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    peak = BF16_TFLOPS if q.dtype == torch.bfloat16 else F32_TFLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def paged_bound_ms(q, k_pages, tables, lens):
    """Least time of paged decode attention: the K and V rows up to
    lens read once, q, tables and lens read and o written once, over the
    memory rate; or 4*hd operations per (query head, token) over the
    peak rate of the dtype."""
    B, H, hd = q.shape
    K = k_pages.shape[2]
    n = int(lens.long().clamp(max=tables.shape[1] * k_pages.shape[1]).sum())
    nbytes = (2 * n * K * hd * k_pages.element_size()
              + 2 * q.numel() * q.element_size()
              + 4 * (tables.numel() + lens.numel()))
    ops_ = 4 * hd * H * n
    peak = BF16_TFLOPS if q.dtype == torch.bfloat16 else F32_TFLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def attention_vs_plain(dev):
    """Phase 6: both attention kernels against their plain versions on
    the card, at the JAX tests' shapes, granite-3-2b's and the prefill
    and decode shapes of phases 14-16.  Returns the max abs error of each
    kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    rng = np.random.default_rng(0)

    def draw(shape, dtype):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev).to(dtype)

    errs = {"flash_attention": 0.0, "paged_attention": 0.0}
    # (B, S, Sk, H, K, hd, dtype, causal, window, model layout)
    cases = [(B, S, S, H, K, hd, dt, c, None, False)
             for B, S, H, K, hd in FLASH_SHAPES
             for dt in (torch.float32, torch.bfloat16) for c in (True, False)]
    cases += [(1, 256, 256, 4, 2, 32, dt, True, w, False)
              for dt in (torch.float32, torch.bfloat16) for w in (32, 128)]
    cases += [(B, S, Sk, H, K, hd, torch.bfloat16, c, None, lay)
              for B, S, Sk, H, K, hd, c, lay in FLASH_BF16_CASES]
    cases += [(B, S, Sk, H, K, hd, torch.bfloat16, c, w, True)
              for B, S, Sk, H, K, hd, c, w in FLASH_MODEL_CASES]
    for B, S, Sk, H, K, hd, dt, causal, window, layout in cases:
        if layout:   # [B,S,H,hd] tensors seen as [B,H,S,hd], as ops does
            q = draw((B, S, H, hd), dt).transpose(1, 2)
            k, v = (draw((B, Sk, K, hd), dt).transpose(1, 2)
                    for _ in range(2))
        else:
            q, k, v = draw((B, H, S, hd), dt), draw((B, K, Sk, hd), dt), \
                draw((B, K, Sk, hd), dt)
        kern = FLASH_KERNEL[dt]
        before = fa.LAUNCHES_BY_KERNEL[kern]
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        if fa.LAUNCHES_BY_KERNEL[kern] != before + 1:
            raise AssertionError(f"flash {B, S, Sk, H, K, hd} {dt} did not "
                                 f"launch {kern}")
        want = ref.mha_reference(q, k, v, causal=causal, window=window)
        tol = TOL.get(dt, FLASH_BF16_TOL)
        err = close(got, want, tol, f"flash {B, S, Sk, H, K, hd}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        print(f"flash {kern} B={B} S={S} Sk={Sk} H={H} K={K} hd={hd} "
              f"{str(dt)[6:]} causal={causal} window={window}"
              f"{' [B,S,H,hd] views' if layout else ''}: max abs err "
              f"{err:.3g} (tolerance {tol})")
    # the cluster slots the planner assumes, against the card's own count
    for hd in (64, 128):
        card = pa.clusters_on_card(hd)
        if any(card[s] < n for s, n in pa.CLUSTER_SLOTS.items()):
            raise AssertionError(f"the card holds {card} clusters of each "
                                 f"size at hd {hd}, the plan assumes "
                                 f"{pa.CLUSTER_SLOTS}")
        print(f"paged clusters held at once (cudaOccupancyMaxActiveClusters, "
              f"bf16, hd {hd}), by CTAs a cluster: {card}; the plan assumes "
              f"{pa.CLUSTER_SLOTS}")
    for B, H, K, hd, page, nb, P, given in PAGED_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            q = draw((B, H, hd), dt)
            kp, vp = draw((P, page, K, hd), dt), draw((P, page, K, hd), dt)
            tables = torch.from_numpy(rng.permutation(P)[:B * nb].reshape(
                B, nb).astype(np.int32)).to(dev)
            lens = rng.integers(1, nb * page, size=B) if given is None \
                else np.asarray(given)
            lens = torch.from_numpy(lens.astype(np.int32)).to(dev)
            pl = pa.plan(B, K, nb, page, hd, H // K, dt)
            form = FORM[pl.clustered]
            before, by = pa.LAUNCHES, pa.LAUNCHES_BY_FORM[form]
            got = pa.paged_attention(q, kp, vp, tables, lens)
            if pa.LAUNCHES != before + 1 \
                    or pa.LAUNCHES_BY_FORM[form] != by + 1:
                raise AssertionError(f"paged {B, H, K, hd} did not launch "
                                     f"the {form} form")
            want = ref.paged_attention_reference(q, kp, vp, tables, lens)
            tol = TOL.get(dt, PAGED_BF16_TOL)
            err = close(got, want, tol, f"paged {B, H, K, hd, page, nb, P}")
            # the other form, forced (the comparison phase 8 times)
            other = close(pa.launch(q, kp, vp, tables, lens,
                                    clustered=not pl.clustered), want, tol,
                          f"paged {B, H, K, hd, page, nb, P} "
                          f"{FORM[not pl.clustered]}")
            errs["paged_attention"] = max(errs["paged_attention"], err,
                                          other)
            print(f"paged B={B} H={H} K={K} hd={hd} page={page} nb={nb} "
                  f"P={P} {str(dt)[6:]}, permuted pool, lens "
                  f"{lens.tolist()}; plan {form} form, {pl.splits} CTAs a "
                  f"(request, kv head), {B * K * pl.splits} CTAs of "
                  f"{pl.smem_bytes} bytes of shared memory: max abs err "
                  f"{err:.3g}, the {FORM[not pl.clustered]} form's "
                  f"{other:.3g} (tolerance {tol})")
    return errs


def full_width_vs_snapshot(dev):
    """Phase 7: granite-3-2b at full width, 2 layers, against the JAX
    package's snapshot tests/golden/torch_granite_fullwidth.json."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    with open(os.path.join(ROOT, "tests", "golden",
                           "torch_granite_fullwidth.json")) as f:
        snap = json.load(f)
    cfg = dataclasses.replace(get_config("granite-3-2b"),
                              n_layers=snap["n_layers"])
    t0 = time.perf_counter()
    tree = M.numpy_params(cfg, snap["seed"])
    if M.tree_sha256(tree) != snap["weights_sha256"]:
        raise AssertionError("the weights differ from the ones the snapshot "
                             "was made from (numpy draws other normals?)")
    B, S = snap["batch"], snap["prompt_len"]
    prompt = np.random.default_rng(snap["seed"] + 1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    if M.tree_sha256({}, prompt) != snap["prompt_sha256"]:
        raise AssertionError("the prompt differs from the snapshot's")
    print(f"weights and prompt equal the snapshot's (sha256; "
          f"{time.perf_counter() - t0:.1f} s to draw and digest)")
    m = M.build(cfg, dev)
    params = M.params_from_jax(tree, cfg, dev)
    del tree
    logits, cache = m.prefill(params, {"tokens": torch.from_numpy(prompt)},
                              m.init_cache(B, snap["cache_len"]))
    worst, compared = 0.0, 0
    for i, st in enumerate(snap["steps"]):
        if i:
            tok = torch.tensor(snap["steps"][i - 1]["token"],
                               dtype=torch.int32)[:, None]
            logits, cache = m.decode_step(
                params, cache, tok, torch.full((B,), S + i - 1,
                                               dtype=torch.int32))
        lg = logits[:, -1].float()
        top = torch.gather(lg, 1, torch.tensor(st["top_ids"], device=dev))
        err = close(top, torch.tensor(st["top_logits"], device=dev),
                    SNAP_TOL, f"step {i} top-{snap['top']} logits")
        lse = torch.logsumexp(lg, -1)
        err = max(err, close(lse, torch.tensor(st["logsumexp"], device=dev),
                             SNAP_TOL, f"step {i} logsumexp"))
        worst = max(worst, err)
        greedy = lg.argmax(-1).tolist()
        for b in range(B):
            if st["margin"][b] > SNAP_TOL:
                compared += 1
                if greedy[b] != st["token"][b]:
                    raise AssertionError(f"step {i}, request {b}: greedy "
                                         f"token {greedy[b]} != "
                                         f"{st['token'][b]}")
    print(f"prefill + {snap['decode_steps']} decode steps, B={B}: max abs "
          f"err {worst:.4g} on the top-{snap['top']} logits and logsumexp "
          f"(tolerance {SNAP_TOL}); {compared} greedy tokens with a top-2 "
          f"margin above it all equal the snapshot's")
    return worst


def plain_attention():
    """The model's attention through the plain versions on the card (the
    comparison path): patches the two functions ``layers`` calls and
    returns a function that restores them."""
    from repro_torch.kernels import ops, ref

    saved = ops.flash_attention, ops.paged_attention

    def flash(q, k, v, *, causal=True, window=None):
        return ref.mha_reference(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window).transpose(1, 2)

    ops.flash_attention, ops.paged_attention = \
        flash, ref.paged_attention_reference

    def restore():
        ops.flash_attention, ops.paged_attention = saved
    return restore


def ptxas_usage(log: str, entry: str) -> str:
    """What ``nvcc -Xptxas -v`` reported for the kernel entry whose
    mangled name contains `entry`: registers, stack and spills."""
    cur, out = None, []
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
        elif cur and entry in cur and ("spill" in ln or "Used" in ln):
            out.append(ln.split(":", 1)[-1].strip() if "Used" in ln
                       else ln.strip())
    if not out:
        raise AssertionError(f"no ptxas report for {entry} in the build log")
    return "; ".join(out)


def mmu_entry(code: int, placement: str, dyn: bool = False) -> str:
    """The mangled-name part of the mmu_step kernel's instantiation for a
    composition code, a placement and the ladder flag (``ptxas_usage``'s
    entry)."""
    from repro_torch.kernels import mmu_step
    l2s, ts = mmu_step.PLACEMENTS[placement]
    return (f"mmu_step_kernelILb{int(l2s)}ELb{int(ts)}ELi{code}"
            f"ELb{int(dyn)}EE")


def paged_entry(hd: int, clustered: bool) -> str:
    """The mangled-name part of the bf16 paged kernel at width hd in the
    form ``clustered`` picks (``ptxas_usage``'s entry)."""
    return f"paged_kernelI13__nv_bfloat16S1_Li{hd}ELb{int(not clustered)}E"


def serving_path(dev, flash_log, paged_log):
    """Phase 8: granite-3-2b at full width and depth serves SERVE_B
    requests: prefill of SERVE_PROMPT tokens, SERVE_STEPS greedy decode
    steps over a cache of SERVE_CACHE positions.  `flash_log` and
    `paged_log` are the two attention builds' nvcc output."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.models import model as M

    cfg = get_config("granite-3-2b")
    m = M.build(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = m.init(gen)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_params() / 1e9:.2f} B parameters in {cfg.dtype}, drawn "
          f"on the card in {time.perf_counter() - t0:.1f} s")
    prompt = M.dummy_batch(cfg, SERVE_B, SERVE_PROMPT, gen)

    def run(steps, tokens=None):
        """Prefill and `steps` decode steps; the logits of each, and the
        tokens fed (greedy unless given)."""
        cache = m.init_cache(SERVE_B, SERVE_CACHE)
        lg, cache = m.prefill(params, prompt, cache)
        out, fed = [lg], []
        for i in range(steps):
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None] \
                if tokens is None else tokens[i]
            fed.append(tok)
            pos = torch.full((SERVE_B,), SERVE_PROMPT + i, dtype=torch.int32,
                             device=dev)
            lg, cache = m.decode_step(params, cache, tok, pos)
            out.append(lg)
        return out, fed, cache

    # the kernel path against the plain path on the same weights
    kern, fed, _ = run(4)
    restore = plain_attention()
    plain, _, _ = run(4, fed)
    restore()
    serve_err = 0.0
    for i, (a, b) in enumerate(zip(kern, plain)):
        serve_err = max(serve_err, close(a, b, SERVE_TOL, f"serving step {i}"))
    print(f"kernel path == plain path (attention's plain versions on the "
          f"card) over the prefill and 4 decode steps: max abs err "
          f"{serve_err:.4g} on the bf16 model's logits (tolerance "
          f"{SERVE_TOL})")

    # the main path, counted and timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = m.init_cache(SERVE_B, SERVE_CACHE)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    fa.LAUNCHES = pa.LAUNCHES = 0
    fa.LAUNCHES_BY_KERNEL.update(mma_bf16=0, fma_f32=0)
    pa.LAUNCHES_BY_FORM.update(cluster=0, two_pass=0)
    t0 = time.perf_counter()
    lg, cache = m.prefill(params, prompt, cache)
    prefill_enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if (fa.LAUNCHES, pa.LAUNCHES) != (cfg.n_layers, 0):
        raise AssertionError(f"prefill launched flash {fa.LAUNCHES} and "
                             f"paged {pa.LAUNCHES} times")
    if fa.LAUNCHES_BY_KERNEL != {"mma_bf16": cfg.n_layers, "fma_f32": 0}:
        raise AssertionError(f"the bf16 prefill's flash launches went to "
                             f"{fa.LAUNCHES_BY_KERNEL}, not all to mma_bf16")
    print(f"prefill: flash launches by kernel {fa.LAUNCHES_BY_KERNEL}")
    finite &= torch.isfinite(lg).all()
    t0 = time.perf_counter()
    for i in range(SERVE_STEPS):
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((SERVE_B,), SERVE_PROMPT + i, dtype=torch.int32,
                         device=dev)
        lg, cache = m.decode_step(params, cache, tok, pos)
        finite &= torch.isfinite(lg).all()
        if pa.LAUNCHES != cfg.n_layers * (i + 1) \
                or fa.LAUNCHES != cfg.n_layers:
            raise AssertionError(f"decode step {i}: paged launched "
                                 f"{pa.LAUNCHES} times in all")
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / SERVE_STEPS
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / SERVE_STEPS
    launches = {"flash_attention": fa.LAUNCHES,
                "paged_attention": pa.LAUNCHES}
    plan = pa.plan(SERVE_B, cfg.n_kv_heads, SERVE_CACHE // m.page, m.page,
                   cfg.hd, cfg.n_heads // cfg.n_kv_heads)
    want = {"cluster": 0, "two_pass": 0}
    want[FORM[plan.clustered]] = pa.LAUNCHES
    if pa.LAUNCHES_BY_FORM != want:
        raise AssertionError(f"decode's paged launches went to "
                             f"{pa.LAUNCHES_BY_FORM}, not all to the "
                             f"plan's {FORM[plan.clustered]} form")
    print(f"decode: paged launches by form {pa.LAUNCHES_BY_FORM}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(finite):
        raise AssertionError("non-finite logits on the serving path")
    print(f"main path: prefill {prefill_ms:.2f} ms ({SERVE_B} x "
          f"{SERVE_PROMPT} tokens), decode {decode_ms:.3f} ms per step, "
          f"{SERVE_B * 1e3 / decode_ms:,.0f} tokens/s over {SERVE_STEPS} "
          f"steps; launches {launches}; logits finite; peak device memory "
          f"{peak:.2f} GiB")
    print(f"prefill: the host enqueued it in {prefill_enqueue_ms:.2f} ms "
          f"(the card then needed {prefill_ms - prefill_enqueue_ms:.2f} ms "
          f"more)")
    print(f"decode: the host enqueued a step every {enqueue_ms:.3f} ms "
          f"(the card then needed {SERVE_STEPS * (decode_ms - enqueue_ms):.2f}"
          f" ms more to finish all {SERVE_STEPS})")

    def device_rows(prof):
        """(kernel, device ms, calls) of the profiled window; an
        operator's row repeats its kernels' time, so kernels only."""
        return [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    # where the prefill's device time goes (torch.profiler, one prefill)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m.prefill(params, prompt, m.init_cache(SERVE_B, SERVE_CACHE))
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy_ms = sum(r[1] for r in rows)
    print(f"profiled prefill: wall {prof_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({busy_ms / prof_ms:.1%}), "
          f"{sum(r[2] for r in rows)} kernel launches")
    for key, ms_, n in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"  {ms_:8.3f} ms {n:5d} calls  {key[:90]}")

    # where a decode step's device time goes (torch.profiler, 4 steps)
    prof_steps = 4
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(prof_steps):
            pos = torch.full((SERVE_B,), SERVE_PROMPT + SERVE_STEPS + i,
                             dtype=torch.int32, device=dev)
            lg, cache = m.decode_step(params, cache, tok, pos)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy_ms = sum(r[1] for r in rows)
    print(f"profiled {prof_steps} decode steps: wall {prof_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms ({busy_ms / prof_ms:.1%}; idle "
          f"{1 - busy_ms / prof_ms:.1%} under the profiler)")
    for key, ms_, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {ms_ / prof_steps:8.3f} ms/step {n // prof_steps:5d} "
              f"calls/step  {key[:90]}")

    # each kernel alone at the main path's shapes
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(1)

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev).to(torch.bfloat16)

    # the model's layout [B,S,H,hd], seen as [B,H,S,hd] as ops passes it
    q = draw((SERVE_B, SERVE_PROMPT, H, hd)).transpose(1, 2)
    k, v = (draw((SERVE_B, SERVE_PROMPT, K, hd)).transpose(1, 2)
            for _ in range(2))
    kx, vx = (x.repeat_interleave(H // K, dim=1) for x in (k, v))
    flash = {
        "ms": device_ms(lambda: fa.flash_attention(q, k, v, causal=True)),
        "plain_ms": device_ms(lambda: ref.mha_reference(q, k, v,
                                                        causal=True)),
        "library_ms": device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kx, vx, is_causal=True))}
    flash["bound_ms"], flash["bound_by"] = flash_bound_ms(q, k, True)
    flash["tflops"] = flash_ops(q, k, True) / (flash["ms"] * 1e-3) / 1e12
    print(f"flash_attention (mma_bf16, hd {hd}): "
          f"{ptxas_usage(flash_log, f'flash_mmaILi{hd}E')}; "
          f"{fa.smem_bytes(torch.bfloat16, hd)} bytes of dynamic shared "
          f"memory a block; {flash['tflops']:.1f} TFLOP/s on the "
          f"{flash_ops(q, k, True) / 1e9:.2f} GFLOP the causal mask keeps, "
          f"{flash['bound_ms'] / flash['ms']:.1%} of the bound "
          f"({flash['bound_ms']:.5f} ms, {flash['bound_by']}); "
          f"{flash['ms'] / flash['library_ms']:.2f}x SDPA")
    print(f"flash_attention before the tensor-core kernel: "
          f"{QUOTED_CUDA_CORE_FLASH_MS} ms on the CUDA cores, quoted from "
          f"PERF.md (not measured here); this run is "
          f"{QUOTED_CUDA_CORE_FLASH_MS / flash['ms']:.1f}x faster")
    # the same prefill at hd 128, the width of the dense configs queued
    # next (its own draws, so the inputs above and below stay as they are)
    rng128 = np.random.default_rng(2)
    q2, k2, v2 = (torch.from_numpy(rng128.standard_normal(
        (SERVE_B, SERVE_PROMPT, n, 128), dtype=np.float32)).to(dev).to(
        torch.bfloat16).transpose(1, 2) for n in (H, K, K))
    kx2, vx2 = (x.repeat_interleave(H // K, dim=1) for x in (k2, v2))
    ms128 = device_ms(lambda: fa.flash_attention(q2, k2, v2, causal=True))
    sdpa128 = device_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q2, kx2, vx2, is_causal=True))
    print(f"flash_attention (mma_bf16, hd 128, same B, S, H, K): "
          f"{ptxas_usage(flash_log, 'flash_mmaILi128E')}; {ms128:.4f} ms, "
          f"SDPA {sdpa128:.4f} ms ({ms128 / sdpa128:.2f}x), "
          f"{flash_ops(q2, k2, True) / (ms128 * 1e-3) / 1e12:.1f} TFLOP/s")
    del q2, k2, v2, kx2, vx2
    nb = SERVE_CACHE // m.page
    kp = cache["k"][0].view(SERVE_B * nb, m.page, K, hd)
    vp = cache["v"][0].view(SERVE_B * nb, m.page, K, hd)
    qd = draw((SERVE_B, H, hd))
    tables = torch.arange(SERVE_B * nb, dtype=torch.int32,
                          device=dev).reshape(SERVE_B, nb)
    lens = torch.full((SERVE_B,), SERVE_PROMPT + SERVE_STEPS,
                      dtype=torch.int32, device=dev)
    kg = kp[tables.long()].reshape(SERVE_B, SERVE_CACHE, K, hd).transpose(
        1, 2).repeat_interleave(H // K, dim=1)
    vg = vp[tables.long()].reshape(SERVE_B, SERVE_CACHE, K, hd).transpose(
        1, 2).repeat_interleave(H // K, dim=1)
    mask = (torch.arange(SERVE_CACHE, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    paged = {
        "ms": device_ms(lambda: pa.paged_attention(qd, kp, vp, tables,
                                                   lens)),
        "plain_ms": device_ms(lambda: ref.paged_attention_reference(
            qd, kp, vp, tables, lens)),
        "library_ms": device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qd[:, :, None], kg, vg, attn_mask=mask))}
    paged["bound_ms"], paged["bound_by"] = paged_bound_ms(qd, kp, tables,
                                                          lens)
    pl = pa.plan(SERVE_B, K, nb, m.page, hd, H // K)
    paged["plan"] = {"form": FORM[pl.clustered], "splits": pl.splits,
                     "ctas": SERVE_B * K * pl.splits,
                     "smem_bytes": pl.smem_bytes}
    # the same launch over each layer's cache in turn, as a decode step
    # makes it: 40 x 9.4 MB of K/V rows, past the 50 MB L2
    layer_pages = [(cache["k"][i].view(SERVE_B * nb, m.page, K, hd),
                    cache["v"][i].view(SERVE_B * nb, m.page, K, hd))
                   for i in range(cfg.n_layers)]
    turn = [0]

    def rotated():
        kp_, vp_ = layer_pages[turn[0] % cfg.n_layers]
        turn[0] += 1
        return pa.paged_attention(qd, kp_, vp_, tables, lens)
    paged["rotated_ms"] = device_ms(rotated, reps=4 * cfg.n_layers)
    # the other form of the merge on the same inputs: the design
    # comparison (cluster: one launch, merged in distributed shared
    # memory; two-pass: partials through device memory, a second kernel)
    other = FORM[not pl.clustered]
    paged[f"{other}_ms"] = device_ms(lambda: pa.launch(
        qd, kp, vp, tables, lens, clustered=not pl.clustered))

    def rotated_other():
        kp_, vp_ = layer_pages[turn[0] % cfg.n_layers]
        turn[0] += 1
        return pa.launch(qd, kp_, vp_, tables, lens,
                         clustered=not pl.clustered)
    paged[f"{other}_rotated_ms"] = device_ms(rotated_other,
                                             reps=4 * cfg.n_layers)
    del kg, vg, layer_pages
    print(f"paged_attention (hd {hd}, bf16): plan {FORM[pl.clustered]} "
          f"form, {pl.splits} CTAs a (request, kv head), "
          f"{paged['plan']['ctas']} CTAs of {pl.smem_bytes} bytes of shared "
          f"memory; ptxas: "
          f"{ptxas_usage(paged_log, paged_entry(hd, pl.clustered))}"
          f"; warm (one layer's cache) {paged['ms']:.4f} ms, rotated over "
          f"the {cfg.n_layers} layers' caches {paged['rotated_ms']:.4f} ms "
          f"a launch; {paged['bound_ms'] / paged['ms']:.1%} of the bound "
          f"warm; the {other} form {paged[f'{other}_ms']:.4f} ms warm, "
          f"{paged[f'{other}_rotated_ms']:.4f} ms rotated")
    # the decode geometries of the dense configs the kernel now takes, on
    # pools drawn here (permuted tables, every request at `n` tokens)
    paged["long_context"] = {}
    for name, B, Hx, Kx, hdx, page, nbx, n in PAGED_LONG:
        g = np.random.default_rng(3)
        P = B * nbx

        def draw_x(shape):
            return torch.from_numpy(g.standard_normal(
                shape, dtype=np.float32)).to(dev).to(torch.bfloat16)
        qx = draw_x((B, Hx, hdx))
        kx, vx = draw_x((P, page, Kx, hdx)), draw_x((P, page, Kx, hdx))
        tab = torch.from_numpy(g.permutation(P).reshape(B, nbx).astype(
            np.int32)).to(dev)
        lx = torch.full((B,), n, dtype=torch.int32, device=dev)
        kgx, vgx = (x[tab.long()].reshape(B, nbx * page, Kx, hdx).transpose(
            1, 2).repeat_interleave(Hx // Kx, dim=1) for x in (kx, vx))
        mx = (torch.arange(nbx * page, device=dev)[None, :]
              < lx[:, None])[:, None, None, :]
        plx = pa.plan(B, Kx, nbx, page, hdx, Hx // Kx)
        otherx = FORM[not plx.clustered]
        r = {"ms": device_ms(lambda: pa.paged_attention(qx, kx, vx, tab,
                                                        lx)),
             "library_ms": device_ms(
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     qx[:, :, None], kgx, vgx, attn_mask=mx)),
             f"{otherx}_ms": device_ms(lambda: pa.launch(
                 qx, kx, vx, tab, lx, clustered=not plx.clustered)),
             "form": FORM[plx.clustered], "splits": plx.splits,
             "ctas": B * Kx * plx.splits,
             "unit": f"B={B}, H={Hx}, K={Kx}, hd={hdx}, bf16, page {page}, "
                     f"nb {nbx}, lens {n}"}
        r["bound_ms"], r["bound_by"] = paged_bound_ms(qx, kx, tab, lx)
        err = close(pa.paged_attention(qx, kx, vx, tab, lx),
                    ref.paged_attention_reference(qx, kx, vx, tab, lx),
                    PAGED_BF16_TOL, f"paged {name}")
        print(f"paged_attention at {name}'s decode ({r['unit']}, "
              f"{2 * kx.numel() * 2 / 1e6:.1f} MB of K/V): plan "
              f"{r['form']} form, {plx.splits} CTAs a (request, kv head), "
              f"{r['ctas']} CTAs; ptxas: "
              f"{ptxas_usage(paged_log, paged_entry(hdx, plx.clustered))}"
              f"; {r['ms']:.4f} ms, SDPA over the gathered cache "
              f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x), "
              f"the {otherx} form {r[f'{otherx}_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.1%} of it); max abs err against "
              f"the plain version {err:.3g}")
        paged["long_context"][name] = r
        del qx, kx, vx, kgx, vgx
    for name, r in (("flash_attention", flash), ("paged_attention", paged)):
        print(f"{name}: {r['ms']:.4f} ms per launch, plain {r['plain_ms']:.4f}"
              f" ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    print(f"share: flash {cfg.n_layers * flash['ms'] / prefill_ms:.1%} of "
          f"the prefill, paged {cfg.n_layers * paged['ms'] / decode_ms:.1%} "
          f"of a decode step")
    return {"launches": launches, "flash": flash, "paged": paged}


# ---------------------------------------------------------------- mamba2

SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}  # test_kernels_ssd.py
# (T, q, G, r, p, n): tests/test_kernels_ssd.py's shapes (B and C per
# head), mamba2-2.7b's smoke prefill (2 x 32 tokens), a shape off the
# tensor-core kernel's 8-element chunks (bf16 `model` on the CUDA cores),
# one at that kernel's edges (13 heads, 2 groups), the full prefill
SSD_SHAPES = [(2, 32, 4, 1, 16, 16), (1, 64, 2, 1, 32, 32),
              (3, 16, 8, 1, 8, 16), (8, 8, 1, 8, 16, 16),
              (2, 40, 2, 5, 20, 36), (3, 128, 2, 13, 64, 128),
              (32, 128, 1, 80, 64, 128)]
# full-width logits against the JAX snapshot: bf16 logits of size ~4,
# where a bf16 ulp is 3.1e-2 (the port's plain path on a CPU: 2.1e-2)
SSM_SNAP_TOL = 5e-2
SSM_RECURRENT_TOL = 1e-3  # float32 chunked vs recurrent (test_kernels_ssd.py:59)
# kernel path against plain path, prefill logits at 64 layers.  float32:
# the two roundings are one computation and the cumsum rounds alike, so
# only the order of float32 sums differs.  bf16: the two round W to bf16
# at the same places but sum CB in other orders, so a weight near a
# rounding tie lands one ulp apart, and 64 random layers amplify that (a
# CPU emulation, CB, y and S summed in float64 instead, at d_model 1024
# and 64 layers moved logits of size ~4.3 by 0.17, 0.13 of this bound)
SSM_SERVE_TOL = {torch.float32: 1e-3, torch.bfloat16: 2.5e-1}
SSM_B, SSM_PROMPT, SSM_STEPS = 8, 512, 64


def ssd_inputs(T, q, G, r, p, n, dtype, dev, rng):
    """The model's layout: x, B and C slices of one [T*q, conv_dim]
    buffer (x's token stride is conv_dim); dt and dA float32 in Mamba-2's
    ranges, so that decays pass the clip at -60."""
    R = G * r
    xbc = torch.from_numpy(rng.standard_normal(
        (T * q, R * p + 2 * G * n), dtype=np.float32)).to(dev).to(dtype)
    x = xbc[:, :R * p].view(T, q, R, p)
    B = xbc[:, R * p:R * p + G * n].view(T, q, G, n)
    C = xbc[:, R * p + G * n:].view(T, q, G, n)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (T, q, R))) \
        * rng.uniform(0.5, 20.0, (1, 1, R))
    A = -rng.uniform(1.0, 16.0, R)
    return (x, torch.from_numpy(dt.astype(np.float32)).to(dev),
            torch.from_numpy((dt * A).astype(np.float32)).to(dev), B, C)


def ssd_route(dtype, mode, n, p):
    """The kernel a call should run (the rule ssd_scan.kernel_for
    documents): bf16 `model` with n and p in whole 8-element chunks on the
    tensor cores, everything else on the CUDA cores."""
    if dtype == torch.bfloat16 and mode == "model" and n % 8 == 0 \
            and p % 8 == 0:
        return "mma_bf16"
    return "fma_f32"


def ssd_ops(x, B):
    """Operations the causal block needs: CB's lower triangle per group,
    the lower-triangular W @ x and B^T @ x per head."""
    T, q, R, p = x.shape
    G, n = B.shape[2], B.shape[3]
    tri = q * (q + 1) // 2
    return 2 * T * (G * tri * n + R * tri * p + R * q * n * p)


def ssd_bound_ms(x, B, out_dtype):
    """Least time of the intra-chunk block on these inputs: x, B, C, dt
    and dA read once and y, S written once over the memory rate; or
    ssd_ops over the peak rate of the dtype."""
    T, q, R, p = x.shape
    G, n = B.shape[2], B.shape[3]
    ops_ = ssd_ops(x, B)
    out = torch.empty((), dtype=out_dtype).element_size()
    nbytes = (x.numel() * x.element_size() + 2 * T * q * G * n
              * B.element_size() + 2 * 4 * T * q * R
              + out * (T * q * R * p + T * R * n * p))
    peak = BF16_TFLOPS if x.dtype == torch.bfloat16 else F32_TFLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def ssd_vs_plain(dev):
    """Phase 9: the ssd_intra kernels against their plain version on the
    card, both roundings, float32 and bf16, each call checked to have run
    the kernel of its route.  Returns the max abs error."""
    from repro_torch.kernels import ref, ssd_scan

    rng = np.random.default_rng(2)
    worst = 0.0
    routes = {k: 0 for k in ssd_scan.LAUNCHES_BY_KERNEL}
    for T, q, G, r, p, n in SSD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            x, dtv, dA, B, C = ssd_inputs(T, q, G, r, p, n, dt, dev, rng)
            for mode in ("pallas", "model"):
                before = dict(ssd_scan.LAUNCHES_BY_KERNEL)
                y, S = ssd_scan.ssd_intra(x, dtv, dA, B, C, mode=mode)
                ran = [k for k, v in ssd_scan.LAUNCHES_BY_KERNEL.items()
                       if v != before[k]]
                want = ssd_route(dt, mode, n, p)
                what = f"ssd_intra {T, q, G, r, p, n} {str(dt)[6:]} {mode}"
                if ran != [want]:
                    raise AssertionError(f"{what} ran {ran}, not {want}")
                routes[want] += 1
                wy, wS = ref.ssd_intra_plain(x, dtv, dA, B, C, mode=mode)
                err = max(close(y, wy, SSD_TOL[dt], what + " y"),
                          close(S, wS, SSD_TOL[dt], what + " S"))
                worst = max(worst, err)
                print(f"{what} [{want}]: max abs err {err:.3g} (tolerance "
                      f"{SSD_TOL[dt]}; y {str(y.dtype)[6:]})")
    print(f"calls by kernel: {routes}")
    return worst


def mamba2_vs_snapshot(dev):
    """Phase 10: mamba2-2.7b at full width, 2 layers, against the JAX
    snapshot tests/golden/torch_mamba2_fullwidth.json (bf16), then in
    float32 the chunked forward against the token-by-token recurrence."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    with open(os.path.join(ROOT, "tests", "golden",
                           "torch_mamba2_fullwidth.json")) as f:
        snap = json.load(f)
    cfg = dataclasses.replace(get_config("mamba2-2.7b"),
                              n_layers=snap["n_layers"])
    t0 = time.perf_counter()
    tree = M.numpy_params(cfg, snap["seed"])
    if M.tree_sha256(tree) != snap["weights_sha256"]:
        raise AssertionError("the weights differ from the ones the snapshot "
                             "was made from (numpy draws other numbers?)")
    B, S = snap["batch"], snap["prompt_len"]
    prompt = torch.from_numpy(np.random.default_rng(snap["seed"] + 1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    if M.tree_sha256({}, prompt.numpy()) != snap["prompt_sha256"]:
        raise AssertionError("the prompt differs from the snapshot's")
    print(f"weights and prompt equal the snapshot's (sha256; "
          f"{time.perf_counter() - t0:.1f} s to draw and digest)")
    m = M.build(cfg, dev)
    params = M.params_from_jax(tree, cfg, dev)
    logits, _ = m.prefill(params, {"tokens": prompt})
    cache = m.init_cache(B, S)
    worst, compared = 0.0, 0
    for i, st in enumerate(snap["steps"]):
        if i:
            tok = torch.tensor(snap["steps"][i - 1]["token"],
                               dtype=torch.int32)[:, None]
            logits, cache = m.decode_step(params, cache, tok, None)
        lg = logits[:, -1].float()
        top = torch.gather(lg, 1, torch.tensor(st["top_ids"], device=dev))
        err = close(top, torch.tensor(st["top_logits"], device=dev),
                    SSM_SNAP_TOL, f"step {i} top-{snap['top']} logits")
        err = max(err, close(torch.logsumexp(lg, -1),
                             torch.tensor(st["logsumexp"], device=dev),
                             SSM_SNAP_TOL, f"step {i} logsumexp"))
        worst = max(worst, err)
        greedy = lg.argmax(-1).tolist()
        for b in range(B):
            if st["margin"][b] > SSM_SNAP_TOL:
                compared += 1
                if greedy[b] != st["token"][b]:
                    raise AssertionError(f"step {i}, request {b}: greedy "
                                         f"token {greedy[b]} != "
                                         f"{st['token'][b]}")
    print(f"prefill + {snap['decode_steps']} decode steps from init_cache, "
          f"B={B}: max abs err {worst:.4g} on the top-{snap['top']} logits "
          f"and logsumexp (tolerance {SSM_SNAP_TOL}); {compared} greedy "
          f"tokens with a top-2 margin above it all equal the snapshot's")

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = M.build(cfg32, dev)
    params = M.params_from_jax(tree, cfg32, dev)
    del tree
    want = m32.forward(params, {"tokens": prompt})
    cache = m32.init_cache(B, S, torch.float32)
    err = 0.0
    for i in range(S):
        lg, cache = m32.decode_step(params, cache, prompt[:, i:i + 1], None)
        err = max(err, close(lg[:, 0], want[:, i], SSM_RECURRENT_TOL,
                             f"float32 position {i}"))
    print(f"float32: forward (chunked, through the kernel) == decode_step "
          f"token by token from init_cache at all {S} positions of {B} "
          f"requests: max abs err {err:.3g} on the logits (tolerance "
          f"{SSM_RECURRENT_TOL})")
    return worst


def mamba2_dt_a_init(params, gen):
    """Mamba-2's published init of A and dt in place of the reference's
    zeros (A_log = log U[1, 16]; softplus(dt_bias) log-uniform in [1e-3,
    1e-1]), drawn from `gen`: a chunk's decay then passes the clip."""
    for lp in params.layers:
        mx = lp.mixer
        u = torch.rand(mx.A_log.shape, generator=gen, device=gen.device)
        mx.A_log.copy_(torch.log(1.0 + 15.0 * u))
        u = torch.rand(mx.dt_bias.shape, generator=gen, device=gen.device)
        dt = torch.exp(np.log(1e-3) + u * (np.log(1e-1) - np.log(1e-3)))
        mx.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))


def mamba2_serving(dev, ssd_log):
    """Phase 11: mamba2-2.7b at full width and depth serves SSM_B
    requests: prefill of SSM_PROMPT tokens, then SSM_STEPS greedy decode
    steps from init_cache (the reference's ssm prefill returns no
    cache).  `ssd_log` is the ssd_scan build's nvcc output."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref, ssd_scan
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    cfg = get_config("mamba2-2.7b")
    m = M.build(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = m.init(gen)
    mamba2_dt_a_init(params, gen)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.ssm_heads} heads of {cfg.ssm_headdim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, {cfg.n_params() / 1e9:.2f}"
          f" B parameters in {cfg.dtype}, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    prompt = M.dummy_batch(cfg, SSM_B, SSM_PROMPT, gen)

    # the kernel path against the plain path on the same weights (only
    # the prefill runs the kernel): the bf16 model, and the model in
    # float32 on two of the requests
    def kernel_vs_plain(model, weights, batch):
        kern, _ = model.prefill(weights, batch)
        saved = ssd_scan.ssd_intra
        ssd_scan.ssd_intra = ref.ssd_intra_plain
        try:
            plain, _ = model.prefill(weights, batch)
        finally:
            ssd_scan.ssd_intra = saved
        dt = L.dtype_of(model.cfg)
        err = close(kern, plain, SSM_SERVE_TOL[dt], f"mamba2 {dt} prefill")
        same = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
        print(f"kernel path == plain path (ssd_intra's plain version on the "
              f"card), {str(dt)[6:]} prefill of {batch['tokens'].shape[0]} "
              f"requests: max abs err {err:.4g} on the logits (tolerance "
              f"{SSM_SERVE_TOL[dt]}), greedy tokens equal for {same:.0%}")

    kernel_vs_plain(m, params, prompt)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = M.build(cfg32, dev)
    gen32 = torch.Generator(device=dev).manual_seed(1)
    p32 = m32.init(gen32)
    mamba2_dt_a_init(p32, gen32)
    kernel_vs_plain(m32, p32, {"tokens": prompt["tokens"][:2]})
    del p32

    # the main path, counted and timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    ssd_scan.LAUNCHES = 0
    for k in ssd_scan.LAUNCHES_BY_KERNEL:
        ssd_scan.LAUNCHES_BY_KERNEL[k] = 0
    t0 = time.perf_counter()
    lg, cache = m.prefill(params, prompt)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = dict(ssd_scan.LAUNCHES_BY_KERNEL)
    if ssd_scan.LAUNCHES != cfg.n_layers or cache is not None:
        raise AssertionError(f"prefill launched ssd_intra "
                             f"{ssd_scan.LAUNCHES} times")
    if by_kernel != {"mma_bf16": cfg.n_layers, "fma_f32": 0}:
        raise AssertionError(f"prefill launches by kernel: {by_kernel}, "
                             f"not all {cfg.n_layers} on mma_bf16")
    finite &= torch.isfinite(lg).all()
    cache = m.init_cache(SSM_B, SSM_PROMPT + SSM_STEPS)
    t0 = time.perf_counter()
    for i in range(SSM_STEPS):
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        lg, cache = m.decode_step(params, cache, tok, None)
        finite &= torch.isfinite(lg).all()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / SSM_STEPS
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / SSM_STEPS
    launches = ssd_scan.LAUNCHES
    if launches != cfg.n_layers:
        raise AssertionError(f"decode launched ssd_intra: {launches} in all")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(finite):
        raise AssertionError("non-finite logits on the mamba2 serving path")
    print(f"main path: prefill {prefill_ms:.2f} ms ({SSM_B} x {SSM_PROMPT} "
          f"tokens, {SSM_B * SSM_PROMPT * 1e3 / prefill_ms:,.0f} tokens/s), "
          f"decode {decode_ms:.3f} ms per step, "
          f"{SSM_B * 1e3 / decode_ms:,.0f} tokens/s over {SSM_STEPS} steps; "
          f"ssd_intra launches {launches} {by_kernel}; logits finite; peak "
          f"device memory "
          f"{peak:.2f} GiB")
    print(f"decode: the host enqueued a step every {enqueue_ms:.3f} ms "
          f"(the card then needed {SSM_STEPS * (decode_ms - enqueue_ms):.2f}"
          f" ms more to finish all {SSM_STEPS})")

    # device time by kernel under torch.profiler: one prefill, 4 steps
    for what, steps in (("prefill", 0), ("decode", 4)):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if steps == 0:
                m.prefill(params, prompt)
            for _ in range(steps):
                lg, cache = m.decode_step(params, cache, tok, None)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(r[1] for r in rows)
        per = max(steps, 1)
        print(f"profiled {what} ({per} call{'s' if per > 1 else ''}): wall "
              f"{prof_ms:.2f} ms, device busy {busy_ms:.2f} ms "
              f"({busy_ms / prof_ms:.1%}; idle {1 - busy_ms / prof_ms:.1%} "
              f"under the profiler)")
        for key, ms_, n in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"  {ms_ / per:8.3f} ms/call {n // per:5d} launches/call  "
                  f"{key[:90]}")

    # the kernel alone at the main path's shapes and layout (model
    # rounding, as ssd_chunked calls it)
    T, q = SSM_B * SSM_PROMPT // cfg.ssm_chunk, cfg.ssm_chunk
    x, dtv, dA, B, C = ssd_inputs(T, q, cfg.ssm_groups,
                                  cfg.ssm_heads // cfg.ssm_groups,
                                  cfg.ssm_headdim, cfg.ssm_state,
                                  torch.bfloat16, dev,
                                  np.random.default_rng(3))
    ssd = {
        "ms": device_ms(lambda: ssd_scan.ssd_intra(x, dtv, dA, B, C,
                                                   mode="model")),
        "plain_ms": device_ms(lambda: ref.ssd_intra_plain(
            x, dtv, dA, B, C, mode="model"), reps=5),
        "library_ms": None}
    ssd["bound_ms"], ssd["bound_by"] = ssd_bound_ms(x, B, torch.float32)
    ssd["tflops"] = ssd_ops(x, B) / (ssd["ms"] * 1e-3) / 1e12
    print(f"ssd_intra: {ssd['ms']:.4f} ms per launch, plain "
          f"{ssd['plain_ms']:.4f} ms, bound {ssd['bound_ms']:.5f} ms "
          f"({ssd['bound_by']}); no single PyTorch call computes it")
    print(f"ssd_intra (mma_bf16): {ptxas_usage(ssd_log, 'ssd_mma')}; "
          f"{ssd_scan.smem_bytes('mma_bf16', q, cfg.ssm_state, cfg.ssm_headdim)}"
          f" bytes of dynamic shared memory a block, "
          f"{ssd_scan.HEADS_PER_BLOCK['mma_bf16']} heads a block; "
          f"{ssd['tflops']:.1f} TFLOP/s on the {ssd_ops(x, B) / 1e9:.2f} "
          f"GFLOP of causal work, {ssd['bound_ms'] / ssd['ms']:.1%} of the "
          f"bound")
    print(f"share: ssd_intra {cfg.n_layers * ssd['ms'] / prefill_ms:.1%} of "
          f"the prefill")
    return {"launches": launches, "launches_by_kernel": by_kernel,
            "ssd": ssd,
            "unit": f"mamba2-2.7b prefill: T={T} chunks of {q}, R="
                    f"{cfg.ssm_heads} heads of {cfg.ssm_headdim}, G="
                    f"{cfg.ssm_groups}, n={cfg.ssm_state}, bf16, model "
                    f"rounding (y, S in float32), x strided as in the model"}


# ------------------------------------------ moe, encdec and dense options

# a router's k-th minus (k+1)-th gate under which XLA's and the card's
# bf16 activations may pick another expert.  The router reads rms-normed
# activations (elements of size ~1) through N(0, 1/D) weights, so half a
# bf16 ulp (2^-9) of each input element moves a logit by ~2e-3 and a
# k-th gate (~0.04 at granite-moe's 32 experts) by ~1e-4: this is ~10x
# that.  A flip moves the token's FFN output by a whole expert's share,
# which SNAP_TOL cannot hold, so such a request (a decode step: all of
# it, capacity couples its tokens) is left out of the comparison and
# counted, as greedy tokens under the top-2 margin are.
ROUTE_GAP = 1e-3
# measured on the CPU (the port's plain path against the JAX package at
# this snapshot's inputs): the two packages' first-layer gates differ by
# up to 2.3e-3 (median 6e-4 a token), more than the estimate above, so a
# request whose routes differ from the snapshot's at a larger gap is left
# out too (``route_verdict``: "flip"); only a first-layer flip at a gap
# of FLIP_GAP (4x that measurement) or more fails as a routing fault
FLIP_GAP = 1e-2
# phases 14-15 at full depth: requests x prompt tokens (8 routing groups
# of 512 for granite-moe), decode steps, and the decode cache
FD_B, FD_PROMPT, FD_STEPS, FD_CACHE = 8, 512, 64, 640
# phase 16: 2 layers at full width, B x prompt tokens, decode steps over
# a cache of OPT_CACHE.  Kernel path against plain path at the logits,
# at the logits' scale: max |kernel - plain| <= OPT_TOL * max |plain|
# (``close_scaled``).  Phase 6 holds each kernel to FLASH_BF16_TOL /
# PAGED_BF16_TOL, up to two bf16 ulps of an output (the flash kernel
# rounds its weights to bf16 where the plain version keeps float32);
# that difference reaches every logit of these untied heads (normal, of
# size ~4.5) alike, whatever the logit's own size, so a bound relative
# to each element fails on the logits near 0: on an H100, qwen3-32b's
# moved by up to 4.8e-2 (the CPU tests measured 5.0-5.1e-2 between the
# two packages' bf16 logits of its smoke config).  PAGED_BF16_TOL of the
# largest logit (~0.14) holds that and still fails a wrong mask, norm
# or rotation, which moves the logits by their own size.
OPT_B, OPT_PROMPT, OPT_STEPS, OPT_CACHE = 2, 256, 4, 384
OPT_TOL = PAGED_BF16_TOL
# mixtral's ring at smoke width (window 32) in float32, where the kernels
# and the plain versions agree to 1e-5 a layer (the JAX kernel tests'
# tolerance) and no route can flip: the CPU tests' float32 model bound
OPT_RING = dict(B=2, prompt=40, steps=30, page=16, tol=1e-4)


def record_routes():
    """Every ``moe.route`` call's result, in call order (one per moe
    layer per prefill or decode step): patches the function ``moe_apply``
    calls and returns (the list, a function that restores it)."""
    from repro_torch.models import moe

    calls, saved = [], moe.route

    def route(p, x, cfg):
        r = saved(p, x, cfg)
        calls.append(r)
        return r
    moe.route = route

    def restore():
        moe.route = saved
    return calls, restore


def routes_at(calls, rows, k: int):
    """The routes of tokens ``rows`` (flat indices over a call's B*S
    tokens) in each of ``calls`` (one a layer): experts [n, L, k], kept
    [n, L, k], and the k-th minus (k+1)-th gate [n, L], as numpy."""
    topi, keep, gap = [], [], []
    for r in calls:
        E = r.gates.shape[-1]
        idx = torch.as_tensor(rows, device=r.topi.device)
        topi.append(r.topi.reshape(-1, k)[idx].cpu().numpy())
        keep.append(r.keep.reshape(-1, k)[idx].cpu().numpy())
        g = torch.sort(r.gates.reshape(-1, E)[idx], dim=-1,
                       descending=True).values
        gap.append((g[:, k - 1] - g[:, k]).cpu().numpy())
    return (np.stack(topi, 1), np.stack(keep, 1), np.stack(gap, 1))


def route_verdict(got, want, what: str) -> list:
    """Per request: "same" (the routes equal in every layer: the same
    experts, the same ones kept, in any order), "gap" (its smallest gate
    gap is under ROUTE_GAP), "flip" (other experts) or "capacity" (the
    same experts, another one kept: a flip elsewhere in the group moved
    a capacity slot).  ``got`` and ``want`` are (experts, kept, gap) as
    ``routes_at`` gives them; ``want``'s gaps decide.  Raises where the
    first layer's experts differ at a gap of FLIP_GAP or more: that
    layer's router input differs between the two only by attention's
    roundings, which move a gate by less (``FLIP_GAP``), so the routing
    would be wrong."""
    def chosen(r, b, layer):   # expert -> kept (the choices' order
        return dict(zip(r[0][b][layer].tolist(),    # within a token
                        r[1][b][layer].tolist()))   # changes nothing)

    out = []
    for b in range(len(want[0])):
        layers = range(len(want[0][b]))
        got_b = [chosen(got, b, i) for i in layers]
        want_b = [chosen(want, b, i) for i in layers]
        if got_b[0].keys() != want_b[0].keys() \
                and float(want[2][b][0]) >= FLIP_GAP:
            raise AssertionError(
                f"{what}, request {b}: experts {sorted(got_b[0])} in the "
                f"first layer where the reference chose {sorted(want_b[0])}"
                f" at a gate gap of {float(want[2][b][0]):.3g} (at least "
                f"{FLIP_GAP})")
        if float(np.min(want[2][b])) < ROUTE_GAP:
            out.append("gap")
        elif any(g.keys() != w.keys() for g, w in zip(got_b, want_b)):
            out.append("flip")
        else:
            out.append("capacity" if got_b != want_b else "same")
    return out


def snapshot_rows(lg, st, rows, tol: float, what: str):
    """The snapshot step ``st``'s top logits and logsumexp against logits
    [B, V] at requests ``rows``, and the greedy token where the top-2
    margin passes ``tol``.  Returns (max abs err, greedy tokens
    compared)."""
    if not rows:
        return 0.0, 0
    dev = lg.device
    r = torch.tensor(rows, device=dev)
    lg = lg.float()[r]
    top = torch.gather(lg, 1, torch.tensor(st["top_ids"], device=dev)[r])
    err = close(top, torch.tensor(st["top_logits"], device=dev)[r], tol,
                f"{what} top-{len(st['top_ids'][0])} logits")
    err = max(err, close(torch.logsumexp(lg, -1),
                         torch.tensor(st["logsumexp"], device=dev)[r], tol,
                         f"{what} logsumexp"))
    compared = 0
    for b, g in zip(rows, lg.argmax(-1).tolist()):
        if st["margin"][b] > tol:
            compared += 1
            if g != st["token"][b]:
                raise AssertionError(f"{what}, request {b}: greedy token {g}"
                                     f" != {st['token'][b]}")
    return err, compared


def load_snapshot(name: str) -> dict:
    with open(os.path.join(ROOT, "tests", "golden", name)) as f:
        return json.load(f)


def granite_moe_vs_snapshot(dev) -> dict:
    """Phase 14 (a): granite-moe-1b-a400m at full width, 2 layers, against
    tests/golden/torch_granite_moe_fullwidth.json, the card's routes at
    each compared token held to the snapshot's first (``route_verdict``):
    requests (a decode step's: the step) under ROUTE_GAP, or whose
    capacity slots moved, are left out and counted."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    snap = load_snapshot("torch_granite_moe_fullwidth.json")
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              n_layers=snap["n_layers"])
    t0 = time.perf_counter()
    tree = M.numpy_params(cfg, snap["seed"])
    if M.tree_sha256(tree) != snap["weights_sha256"]:
        raise AssertionError("the weights differ from the ones the snapshot "
                             "was made from (numpy draws other normals?)")
    B, S, k = snap["batch"], snap["prompt_len"], cfg.top_k
    prompt = np.random.default_rng(snap["seed"] + 1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    if M.tree_sha256({}, prompt) != snap["prompt_sha256"]:
        raise AssertionError("the prompt differs from the snapshot's")
    print(f"weights and prompt equal the snapshot's (sha256; "
          f"{time.perf_counter() - t0:.1f} s to draw and digest)")
    m = M.build(cfg, dev)
    params = M.params_from_jax(tree, cfg, dev)
    del tree
    calls, restore = record_routes()
    try:
        logits, cache = m.prefill(params, {"tokens": torch.from_numpy(prompt)},
                                  m.init_cache(B, snap["cache_len"]))
        steps = [(logits, calls[:])]
        for i in range(1, len(snap["steps"])):
            del calls[:]
            tok = torch.tensor(snap["steps"][i - 1]["token"],
                               dtype=torch.int32)[:, None]
            logits, cache = m.decode_step(
                params, cache, tok, torch.full((B,), S + i - 1,
                                               dtype=torch.int32))
            steps.append((logits, calls[:]))
    finally:
        restore()
    worst, compared, greedy = 0.0, 0, 0
    left = {"gap": 0, "flip": 0, "capacity": 0}
    for i, ((lg, step_calls), st) in enumerate(zip(steps, snap["steps"])):
        if len(step_calls) != cfg.n_layers:
            raise AssertionError(f"step {i} routed {len(step_calls)} times, "
                                 f"want one a layer")
        rows = [b * S + S - 1 for b in range(B)] if i == 0 else list(range(B))
        want = tuple(np.asarray(st[f"route_{x}"])
                     for x in ("topi", "keep", "gap"))
        verdict = route_verdict(routes_at(step_calls, rows, k), want,
                                f"step {i}")
        if i and any(v != "same" for v in verdict):   # the whole step
            verdict = [next(v for v in verdict if v != "same")] * B
        keep_rows = [b for b, v in enumerate(verdict) if v == "same"]
        for v in verdict:
            if v != "same":
                left[v] += 1
        err, n = snapshot_rows(lg[:, -1], st, keep_rows, SNAP_TOL,
                               f"step {i}")
        worst, compared, greedy = max(worst, err), compared + len(keep_rows), \
            greedy + n
        print(f"step {i}: routes {verdict}, smallest gate gap "
              f"{float(np.min(want[2])):.3g}; compared requests {keep_rows}")
    if compared == 0:
        raise AssertionError("every request was left out: nothing compared")
    print(f"prefill + {snap['decode_steps']} decode steps, B={B}: "
          f"{compared} of {B * len(steps)} (request, step) logits compared, "
          f"max abs err {worst:.4g} on the top-{snap['top']} logits and "
          f"logsumexp (tolerance {SNAP_TOL}); left out: {left['gap']} under "
          f"the gate gap {ROUTE_GAP}, {left['flip']} whose experts differ "
          f"from the snapshot's, {left['capacity']} whose capacity slots "
          f"moved; {greedy} greedy tokens with a top-2 margin above the "
          f"tolerance all equal the snapshot's")
    return {"max_abs_err": worst, "compared": compared, "left_out": left}


def seamless_vs_snapshot(dev) -> dict:
    """Phase 15 (a): seamless-m4t-medium at full width, 2 + 2 layers,
    against tests/golden/torch_seamless_fullwidth.json: ``Model.prefill``'s
    last logits, then 4 greedy decode steps from position 0 whose cross
    cache holds the port's own encoder projection."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import encdec
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    snap = load_snapshot("torch_seamless_fullwidth.json")
    cfg = dataclasses.replace(get_config("seamless-m4t-medium"),
                              n_layers=snap["n_layers"],
                              n_enc_layers=snap["n_enc_layers"])
    t0 = time.perf_counter()
    tree = M.numpy_params(cfg, snap["seed"])
    if M.tree_sha256(tree) != snap["weights_sha256"]:
        raise AssertionError("the weights differ from the ones the snapshot "
                             "was made from (numpy draws other normals?)")
    B, S, Ss = snap["batch"], snap["prompt_len"], snap["source_len"]
    tokens = np.random.default_rng(snap["seed"] + 1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    src = torch.from_numpy(np.random.default_rng(snap["seed"] + 2)
                           .standard_normal((B, Ss, cfg.d_model),
                                            dtype=np.float32)).bfloat16()
    if M.tree_sha256({}, tokens, src.float().numpy()) != snap["inputs_sha256"]:
        raise AssertionError("the inputs differ from the snapshot's")
    print(f"weights and inputs equal the snapshot's (sha256; "
          f"{time.perf_counter() - t0:.1f} s to draw and digest)")
    m = M.build(cfg, dev)
    params = M.params_from_jax(tree, cfg, dev)
    del tree
    batch = {"tokens": torch.from_numpy(tokens), "src_embeds": src}
    logits, none = m.prefill(params, batch)
    if none is not None:
        raise AssertionError("the encdec prefill returned a cache")
    steps = [logits]
    cache = m.init_cache(B, snap["cache_len"])
    fill_cross_cache(params, cfg, cache, encdec.encode(
        params, cfg, src.to(dev)), L)
    tok = torch.from_numpy(tokens[:, :1])
    for i in range(snap["decode_steps"]):
        logits, cache = m.decode_step(params, cache, tok,
                                      torch.full((B,), i, dtype=torch.int32))
        steps.append(logits)
        tok = torch.tensor(snap["steps"][i + 1]["token"],
                           dtype=torch.int32)[:, None]
    worst, greedy = 0.0, 0
    for i, (lg, st) in enumerate(zip(steps, snap["steps"])):
        err, n = snapshot_rows(lg[:, -1], st, list(range(B)), SNAP_TOL,
                               f"step {i}")
        worst, greedy = max(worst, err), greedy + n
    print(f"prefill ({B} x {S} tokens over {Ss} frames) + "
          f"{snap['decode_steps']} decode steps from position 0 over the "
          f"encoder's cross cache: max abs err {worst:.4g} on the top-"
          f"{snap['top']} logits and logsumexp (tolerance {SNAP_TOL}); "
          f"{greedy} greedy tokens with a top-2 margin above it all equal "
          f"the snapshot's")
    return {"max_abs_err": worst}


def fill_cross_cache(params, cfg, cache, enc, L):
    """Each decoder layer's ``cross.wk``/``wv`` projection of the encoder
    output ``enc`` [B,Ss,D] into slots [0, Ss) of the cross cache (the
    port, as the reference, leaves that to its caller)."""
    B, Ss, _ = enc.shape
    for i, lp in enumerate(params.dec):
        for name, w in (("xk", lp.cross.wk), ("xv", lp.cross.wv)):
            cache[name][i, :, :Ss] = L.matmul(enc, w).reshape(
                B, Ss, cfg.n_kv_heads, cfg.hd)


def profiled(fn):
    """(wall ms, [(kernel, device ms, calls)]) of ``fn()`` under
    torch.profiler; an operator's row repeats its kernels' time, so
    kernels only."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, [(e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]


def report_rows(what: str, wall: float, rows, per: int) -> dict:
    """Prints and returns a profiled window's busy share and its eight
    largest kernels, per ``per`` steps."""
    busy = sum(r[1] for r in rows)
    print(f"{what}: wall {wall / per:.2f} ms, device busy {busy / per:.2f} "
          f"ms ({busy / wall:.1%}), {sum(r[2] for r in rows) // per} kernel "
          f"launches, per {'step' if per > 1 else 'call'}")
    top = sorted(rows, key=lambda r: -r[1])[:8]
    for key, ms_, n in top:
        print(f"  {ms_ / per:8.3f} ms {n // per:5d} calls  {key[:90]}")
    return {"wall_ms": wall / per, "busy_ms": busy / per,
            "launches": sum(r[2] for r in rows) // per,
            "top": [[k[:90], ms_ / per, n // per] for k, ms_, n in top]}


def zero_attention_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    fa.LAUNCHES = pa.LAUNCHES = 0
    fa.LAUNCHES_BY_KERNEL.update(mma_bf16=0, fma_f32=0)
    pa.LAUNCHES_BY_FORM.update(cluster=0, two_pass=0)


def full_depth_serving(dev, name: str, smi: str, check=None) -> dict:
    """Phases 14 (b), 15 (b) and 17 (c): ``name`` at full width and
    depth, random weights drawn on the card, serves FD_B requests:
    prefill of FD_PROMPT tokens (seamless: over FD_PROMPT source frames),
    then FD_STEPS greedy decode steps (granite-moe over a cache of
    FD_CACHE positions after the prompt; recurrentgemma, whose prefill
    fills no cache, from ``init_cache`` at the same positions over a ring
    of FD_CACHE slots; seamless from position 0 over a cache of
    FD_PROMPT, its cross cache the encoder's projection), each counted:
    flash launches a prefill (one an attention layer; seamless: encoder,
    self and cross), paged launches a step (the same; seamless: self and
    cross), all bf16 on the tensor-core kernel and in the plan's form.
    ``check(m, params, batch)``, where given, runs before the weights go,
    and its result is returned under ``"check"``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import encdec, rglru
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    cfg = get_config(name)
    ed = cfg.family == "encdec"
    hybrid = cfg.family == "hybrid"
    attn_layers = rglru.layout(cfg)[0] if hybrid else cfg.n_layers
    m = M.build(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = m.init(gen)
    torch.cuda.synchronize()
    layers = f"{cfg.n_enc_layers} + {cfg.n_layers}" if ed else cfg.n_layers
    print(f"{cfg.name}: {layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_params() / 1e9:.2f} B parameters in {cfg.dtype}, drawn on "
          f"the card in {time.perf_counter() - t0:.1f} s")
    batch = M.dummy_batch(cfg, FD_B, FD_PROMPT, gen)
    want_flash = cfg.n_enc_layers + 2 * cfg.n_layers if ed else attn_layers
    want_paged = 2 * cfg.n_layers if ed else attn_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stateless = cfg.family in M.STATELESS_PREFILL   # fills no cache
    cache = None if stateless else m.init_cache(FD_B, FD_CACHE)
    zero_attention_counts()
    t0 = time.perf_counter()
    lg, cache = m.prefill(params, batch, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = {"flash_attention": fa.LAUNCHES,
                        "paged_attention": pa.LAUNCHES}
    flash_by_kernel = dict(fa.LAUNCHES_BY_KERNEL)
    if (fa.LAUNCHES, pa.LAUNCHES) != (want_flash, 0) \
            or fa.LAUNCHES_BY_KERNEL["mma_bf16"] != want_flash:
        raise AssertionError(f"{name} prefill: flash launches "
                             f"{fa.LAUNCHES_BY_KERNEL}, paged {pa.LAUNCHES};"
                             f" want {want_flash} mma_bf16 and 0")
    finite = torch.isfinite(lg).all()
    start = FD_PROMPT
    if ed:
        cache = m.init_cache(FD_B, FD_PROMPT)
        fill_cross_cache(params, cfg, cache,
                         encdec.encode(params, cfg, batch["src_embeds"]), L)
        start = 0
    if hybrid:
        cache = m.init_cache(FD_B, FD_CACHE)
    zero_attention_counts()
    t0 = time.perf_counter()
    for i in range(FD_STEPS):
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((FD_B,), start + i, dtype=torch.int32, device=dev)
        lg, cache = m.decode_step(params, cache, tok, pos)
        finite &= torch.isfinite(lg).all()
        if (pa.LAUNCHES, fa.LAUNCHES) != (want_paged * (i + 1), 0):
            raise AssertionError(f"{name} decode step {i}: paged launched "
                                 f"{pa.LAUNCHES} times, flash {fa.LAUNCHES}")
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / FD_STEPS
    decode_launches = {"flash_attention": fa.LAUNCHES,
                       "paged_attention": pa.LAUNCHES}
    by_form = dict(pa.LAUNCHES_BY_FORM)
    if not bool(finite):
        raise AssertionError(f"{name}: non-finite logits")
    peak = torch.cuda.max_memory_allocated() / 2**30
    r = {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
         "tokens_per_s": FD_B * 1e3 / decode_ms, "peak_gib": peak,
         "prefill_launches": prefill_launches,
         "decode_launches": decode_launches, "paged_by_form": by_form,
         "card": smi}
    # where the device time goes (torch.profiler): one prefill, then 4
    # decode steps on from where the timed ones stopped
    wall, rows = profiled(lambda: m.prefill(
        params, batch, None if stateless else m.init_cache(FD_B, FD_CACHE)))
    r["profiled_prefill"] = report_rows(f"{name} profiled prefill", wall,
                                        rows, 1)

    def steps4():
        for i in range(4):
            pos = torch.full((FD_B,), start + FD_STEPS + i, dtype=torch.int32,
                             device=dev)
            m.decode_step(params, cache, tok, pos)
    wall, rows = profiled(steps4)
    r["profiled_decode"] = report_rows(f"{name} profiled decode", wall, rows,
                                       4)
    print(f"{name} main path ({smi}): prefill {prefill_ms:.2f} ms ({FD_B} x "
          f"{FD_PROMPT} tokens), decode {decode_ms:.3f} ms a step, "
          f"{r['tokens_per_s']:,.0f} tokens/s over {FD_STEPS} steps; "
          f"launches: prefill {prefill_launches} (flash by kernel "
          f"{flash_by_kernel}), decode {decode_launches} "
          f"(paged by form {by_form}, {want_paged} a step); logits finite; "
          f"peak device memory {peak:.2f} GiB")
    if check is not None:
        del cache
        torch.cuda.empty_cache()
        r["check"] = check(m, params, batch)
        cache = None
    del params, cache
    torch.cuda.empty_cache()
    return r


def grid_positions3(B: int, S: int, P: int, width: int):
    """M-RoPE streams [3,B,S] int32: P vision patches on a raster ``width``
    wide at t = 0, then text at t = h = w counting on past the grid."""
    pos = torch.zeros((3, B, S), dtype=torch.int32)
    i = torch.arange(P)
    pos[1, :, :P], pos[2, :, :P] = i // width, i % width
    pos[:, :, P:] = torch.arange(S - P, dtype=torch.int32) + \
        max(int(pos[1:, :, :P].max()), 0) + 1
    return pos


def kernel_vs_plain(m, params, batch, steps: int, cache_len: int, tol: float,
                    what: str, extras=lambda i, pos: None,
                    compare=close) -> dict:
    """``m``'s prefill and ``steps`` greedy decode steps through the
    kernels, then through their plain versions on the card fed the same
    tokens; logits compared by ``compare`` at ``tol`` where the two runs'
    routes (moe only) agree (``route_verdict``, the kernel run's gates
    deciding).
    Returns the max abs err, what was left out, and the kernel run's
    prefill ms and decode ms a step (host clock after a sync)."""
    from repro_torch.models import model as M

    cfg = m.cfg
    B, S = batch["tokens"].shape
    moe_ = cfg.family == "moe"
    stateless = cfg.family in M.STATELESS_PREFILL

    def run(tokens=None):
        calls, restore = record_routes()
        out, fed, routes = [], [], []
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = m.prefill(params, batch, None if stateless
                                  else m.init_cache(B, cache_len))
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            if stateless:   # decode starts from init_cache
                cache = m.init_cache(B, cache_len)
            out.append(lg)
            routes.append(calls[:])
            t0 = time.perf_counter()
            for i in range(steps):
                del calls[:]
                tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None] \
                    if tokens is None else tokens[i]
                fed.append(tok)
                pos = torch.full((B,), S + i, dtype=torch.int32,
                                 device=m.device)
                lg, cache = m.decode_step(params, cache, tok, pos,
                                          extras(i, pos))
                out.append(lg)
                routes.append(calls[:])
            torch.cuda.synchronize()
            decode_ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
        finally:
            restore()
        return out, fed, routes, prefill_ms, decode_ms

    kern, fed, kroutes, prefill_ms, decode_ms = run()
    restore = plain_attention()
    try:
        plain, _, proutes, _, _ = run(fed)
    finally:
        restore()
    err, compared, left = 0.0, 0, {"gap": 0, "flip": 0, "capacity": 0}
    for i, (a, b) in enumerate(zip(kern, plain)):
        keep = list(range(B))
        if moe_:
            rows = [x * S + S - 1 for x in range(B)] if i == 0 else keep
            verdict = route_verdict(
                routes_at(proutes[i], rows, cfg.top_k),
                routes_at(kroutes[i], rows, cfg.top_k), f"{what} step {i}")
            if i and any(v != "same" for v in verdict):
                verdict = [next(v for v in verdict if v != "same")] * B
            keep = [x for x, v in enumerate(verdict) if v == "same"]
            for v in verdict:
                if v != "same":
                    left[v] += 1
        if keep:
            r = torch.tensor(keep, device=a.device)
            err = max(err, compare(a[r], b[r], tol, f"{what} step {i}"))
            compared += len(keep)
    if compared == 0:
        raise AssertionError(f"{what}: every request was left out")
    scaled = " of the largest logit" if compare is close_scaled else ""
    moe_left = (f", left out: {left['gap']} under the gate gap {ROUTE_GAP}, "
                f"{left['flip']} whose experts differ, {left['capacity']} "
                f"whose capacity slots moved" if moe_ else "")
    print(f"{what}: kernel path == plain path over the prefill ({B} x {S}) "
          f"and {steps} decode steps: max abs err {err:.4g} on the logits "
          f"(tolerance {tol}{scaled}); {compared} of {B * (steps + 1)} "
          f"(request, step) compared{moe_left}; kernel path: prefill "
          f"{prefill_ms:.2f} ms, decode {decode_ms:.3f} ms a step")
    return {"max_abs_err": err, "compared": compared, "left_out": left,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def dense_options(dev, smi: str) -> dict:
    """Phase 16: qwen3-32b (qk_norm, G 8), mixtral-8x7b (window 4096, top-2
    of 8 experts, G 4) and qwen2-vl-7b (M-RoPE over a vision grid with
    vision embeddings, G 7) at full width, 2 layers, random weights on
    the card, kernel path against plain path (``kernel_vs_plain``); then
    mixtral's smoke width (window 32, a ring of 32 slots in pages of 16)
    in float32, prefilled past the window and decoded past two wraps."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import model as M

    out = {}
    for name in ("qwen3-32b", "mixtral-8x7b", "qwen2-vl-7b"):
        cfg = dataclasses.replace(get_config(name), n_layers=2)
        m = M.build(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = m.init(gen)
        batch = M.dummy_batch(cfg, OPT_B, OPT_PROMPT, gen)
        extras = lambda i, pos: None   # noqa: E731
        if cfg.family == "vlm":
            P = batch["vision_embeds"].shape[1]
            batch["positions3"] = grid_positions3(OPT_B, OPT_PROMPT, P, 16)

            def extras(i, pos):   # the text's own streams from step 2 on
                return None if i < 2 else {"positions3": torch.stack(
                    [pos[:, None], pos[:, None] - 100, pos[:, None] - 99])}
        zero_attention_counts()
        r = kernel_vs_plain(m, params, batch, OPT_STEPS, OPT_CACHE, OPT_TOL,
                            f"{name} (2 layers, full width, bf16, G "
                            f"{cfg.n_heads // cfg.n_kv_heads}, hd {cfg.hd})",
                            extras, close_scaled)
        r["card"] = smi
        out[name] = r
        del params
        torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"),
                              dtype="float32")
    m = M.build(cfg, dev, page=OPT_RING["page"])
    gen = torch.Generator(device=dev).manual_seed(0)
    params = m.init(gen)
    batch = M.dummy_batch(cfg, OPT_RING["B"], OPT_RING["prompt"], gen)
    zero_attention_counts()
    r = kernel_vs_plain(m, params, batch, OPT_RING["steps"], 64,
                        OPT_RING["tol"], f"mixtral smoke ring (window "
                        f"{cfg.window}, page {OPT_RING['page']}, float32, "
                        f"prompt {OPT_RING['prompt']}, decode to position "
                        f"{OPT_RING['prompt'] + OPT_RING['steps'] - 1})")
    if r["left_out"]["flip"] or r["left_out"]["capacity"]:
        raise AssertionError("float32 routes differ between the kernel and "
                             "plain paths")
    if fa.LAUNCHES_BY_KERNEL["fma_f32"] == 0 or pa.LAUNCHES == 0:
        raise AssertionError("the float32 ring did not run the kernels")
    out["mixtral-8x7b-smoke-ring"] = r
    print(f"phase 16's times: host clock after a sync, on {smi}")
    return out


# ---------------------------------------------------------- hybrid

# phase 17 (a): the bf16 flash kernel at recurrentgemma-2b's head width,
# (B, S, Sk, H, K, causal, window, model layout) -- the hybrid's prefill
# (8 x 512, window 2048, which never binds at 512), a 4096-token
# sequence where it binds, ragged S != Sk (no multiple of a 64-row or
# 32-key tile), causal and not, and windows that bind on ragged shapes:
# non-causal, where rows 126 .. 199 see no key (0, in both versions), and
# causal over 300 tokens
HYBRID_HD = 256
HYBRID_FLASH_CASES = [(8, 512, 512, 10, 1, True, 2048, True),
                      (1, 4096, 4096, 10, 1, True, 2048, True),
                      (2, 77, 200, 10, 1, True, None, False),
                      (2, 200, 77, 10, 1, False, None, False),
                      (2, 200, 77, 10, 1, False, 50, False),
                      (2, 300, 300, 10, 1, True, 128, True)]


def flash_hd256(dev, flash_log: str, smi: str) -> dict:
    """Phase 17 (a): ``flash_mma<256>`` against its plain version at
    HYBRID_FLASH_CASES (FLASH_BF16_TOL, each call checked to have taken
    the mma_bf16 kernel), then timed at the hybrid's prefill shape beside
    the plain version and SDPA (k and v repeated to the 10 query heads),
    with its bound, registers, spills and shared memory.  A float32 call
    at hd 256 must raise (no kernel takes it)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rng = np.random.default_rng(17)

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev).to(torch.bfloat16)

    hd, err = HYBRID_HD, 0.0
    for B, S, Sk, H, K, causal, window, layout in HYBRID_FLASH_CASES:
        if layout:   # [B,S,H,hd] tensors seen as [B,H,S,hd], as ops does
            q = draw((B, S, H, hd)).transpose(1, 2)
            k, v = (draw((B, Sk, K, hd)).transpose(1, 2) for _ in range(2))
        else:
            q, k, v = draw((B, H, S, hd)), draw((B, K, Sk, hd)), \
                draw((B, K, Sk, hd))
        before = fa.LAUNCHES_BY_KERNEL["mma_bf16"]
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        if fa.LAUNCHES_BY_KERNEL["mma_bf16"] != before + 1:
            raise AssertionError(f"flash {B, S, Sk, H, K, hd} did not launch "
                                 f"mma_bf16")
        want = ref.mha_reference(q, k, v, causal=causal, window=window)
        e = close(got, want, FLASH_BF16_TOL, f"flash {B, S, Sk, H, K, hd}")
        err = max(err, e)
        blind = Sk - 1 + window if window else S   # rows that see no key
        if blind < S and got[:, :, blind:].any():
            raise AssertionError(f"flash {B, S, Sk, H, K, hd} wrote other "
                                 f"than 0 in rows {blind}.. that see no key")
        print(f"flash mma_bf16 B={B} S={S} Sk={Sk} H={H} K={K} hd={hd} "
              f"causal={causal} window={window}"
              f"{' [B,S,H,hd] views' if layout else ''}: max abs err "
              f"{e:.3g} (tolerance {FLASH_BF16_TOL})")
    try:
        fa.flash_attention(q.float(), k.float(), v.float())
    except ValueError as e:
        print(f"float32 at hd {hd} raises, as it must: {e}")
    else:
        raise AssertionError(f"a float32 flash call at hd {hd} ran")
    B, S, _, H, K, causal, window, _ = HYBRID_FLASH_CASES[0]
    q = draw((B, S, H, hd)).transpose(1, 2)
    k, v = (draw((B, S, K, hd)).transpose(1, 2) for _ in range(2))
    kx, vx = (x.repeat_interleave(H // K, dim=1) for x in (k, v))
    r = {"ms": device_ms(lambda: fa.flash_attention(
            q, k, v, causal=causal, window=window)),
         "plain_ms": device_ms(lambda: ref.mha_reference(
             q, k, v, causal=causal, window=window)),
         "library_ms": device_ms(
             lambda: torch.nn.functional.scaled_dot_product_attention(
                 q, kx, vx, is_causal=True))}
    r["bound_ms"], r["bound_by"] = flash_bound_ms(q, k, causal, window)
    ops_ = flash_ops(q, k, causal, window)
    r["tflops"] = ops_ / (r["ms"] * 1e-3) / 1e12
    r["ptxas"] = ptxas_usage(flash_log, f"flash_mmaILi{hd}E")
    r["smem_bytes"] = fa.smem_bytes(torch.bfloat16, hd)
    r["max_abs_err"] = err
    r["unit"] = (f"recurrentgemma-2b prefill: B={B}, S={S}, H={H}, K={K}, "
                 f"hd={hd}, bf16, causal, window {window}")
    r["card"] = smi
    print(f"flash_attention (mma_bf16, hd {hd}): {r['ptxas']}; "
          f"{r['smem_bytes']} bytes of dynamic shared memory a block; "
          f"{r['ms']:.4f} ms at {r['unit']}, plain {r['plain_ms']:.4f} ms, "
          f"SDPA {r['library_ms']:.4f} ms; {r['tflops']:.1f} TFLOP/s on the "
          f"{ops_ / 1e9:.2f} GFLOP the mask keeps, "
          f"{r['bound_ms'] / r['ms']:.1%} of the bound ({r['bound_ms']:.5f} "
          f"ms, {r['bound_by']}); {smi}")
    return r


def draw_hybrid_snapshot() -> dict:
    """Phase 17 (b)'s inputs, drawn on the host while phase 1 builds the
    kernels (numpy draws and digests outside the GIL): the snapshot, the
    3-layer config, its weights from ``numpy_params`` and the prompt,
    each checked against the snapshot's sha256."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    snap = load_snapshot("torch_recurrentgemma_fullwidth.json")
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"),
                              n_layers=snap["n_layers"])
    t0 = time.perf_counter()
    tree = M.numpy_params(cfg, snap["seed"])
    if M.tree_sha256(tree) != snap["weights_sha256"]:
        raise AssertionError("the weights differ from the ones the snapshot "
                             "was made from (numpy draws other normals?)")
    prompt = np.random.default_rng(snap["seed"] + 1).integers(
        0, cfg.vocab_size, (snap["batch"], snap["prompt_len"])).astype(
            np.int32)
    if M.tree_sha256({}, prompt) != snap["prompt_sha256"]:
        raise AssertionError("the prompt differs from the snapshot's")
    return {"snap": snap, "cfg": cfg, "tree": tree, "prompt": prompt,
            "seconds": time.perf_counter() - t0}


def hybrid_vs_snapshot(dev, drawn: dict) -> dict:
    """Phase 17 (b): recurrentgemma-2b at full width, 3 layers (one
    superblock: the 2-layer cut would be the tail alone, with no
    attention), against tests/golden/torch_recurrentgemma_fullwidth.json:
    ``Model.prefill``'s last logits (no cache), then 4 greedy decode
    steps from ``init_cache`` at positions 0..3, the snapshot's tokens fed
    back.  The prefill must launch flash once, each step paged once.
    ``drawn``: ``draw_hybrid_snapshot()``'s result, whose weights this
    consumes."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import model as M

    snap, cfg, prompt = drawn["snap"], drawn["cfg"], drawn["prompt"]
    B, S = snap["batch"], snap["prompt_len"]
    print(f"weights and prompt equal the snapshot's (sha256; drawn and "
          f"digested in {drawn['seconds']:.1f} s during phase 1)")
    m = M.build(cfg, dev)
    params = M.params_from_jax(drawn.pop("tree"), cfg, dev)
    zero_attention_counts()
    logits, none = m.prefill(params, {"tokens": torch.from_numpy(prompt)})
    if none is not None or (fa.LAUNCHES, pa.LAUNCHES) != (1, 0):
        raise AssertionError(f"the prefill returned a cache or launched "
                             f"flash {fa.LAUNCHES}, paged {pa.LAUNCHES} times")
    steps = [logits]
    cache = m.init_cache(B, snap["cache_len"])
    for i in range(snap["decode_steps"]):
        tok = torch.tensor(snap["steps"][i]["token"], dtype=torch.int32)
        logits, cache = m.decode_step(params, cache, tok[:, None],
                                      torch.full((B,), i, dtype=torch.int32))
        steps.append(logits)
    if (fa.LAUNCHES, pa.LAUNCHES) != (1, snap["decode_steps"]):
        raise AssertionError(f"decode launched paged {pa.LAUNCHES} times")
    worst, greedy = 0.0, 0
    for i, (lg, st) in enumerate(zip(steps, snap["steps"])):
        err, n = snapshot_rows(lg[:, -1], st, list(range(B)), SNAP_TOL,
                               f"step {i}")
        worst, greedy = max(worst, err), greedy + n
    print(f"prefill ({B} x {S} tokens) + {snap['decode_steps']} decode steps "
          f"from position 0 over a cache of {snap['cache_len']}: max abs err "
          f"{worst:.4g} on the top-{snap['top']} logits and logsumexp "
          f"(tolerance {SNAP_TOL}); {greedy} greedy tokens with a top-2 "
          f"margin above it all equal the snapshot's")
    del params, cache
    return {"max_abs_err": worst, "greedy_compared": greedy}


def hybrid_kernel_vs_plain(m, params, batch) -> dict:
    """Phase 17 (c)'s check: the 26-layer model's prefill and FD_STEPS
    greedy decode steps through the kernels against the same through
    their plain versions, logits within OPT_TOL of the largest
    (``close_scaled``, phase 16's rule)."""
    return kernel_vs_plain(m, params, batch, FD_STEPS, FD_CACHE, OPT_TOL,
                           f"recurrentgemma-2b (26 layers, full width, bf16, "
                           f"G {m.cfg.n_heads // m.cfg.n_kv_heads}, hd "
                           f"{m.cfg.hd})", compare=close_scaled)


# ------------------------------------------------------- serving engine

# phase 13's runs, and what the JAX package gave for them on the CPU
SERVE_SNAPSHOT = os.path.join(ROOT, "tests", "golden", "torch_serve.json")
# launches a tick: counted over this many ticks in the middle of a run
# (its steady state), each replayed on a copy of the run's state
SERVE_PROFILED_TICKS = 3
TIME_SHARD_N = 20_000      # phase 13 (d): Victima on bc, serial and
TIME_SHARDS = 4            # in 4 time shards, equal Stats


def digest_of_leaves(leaves) -> str:
    """tests/torch_serve_regen.py's digest of a state's leaves (dtype,
    shape and bytes of each, in order)."""
    h = hashlib.sha256()
    for x in leaves:
        x = np.ascontiguousarray(x)
        h.update(str(x.dtype).encode() + str(x.shape).encode())
        h.update(x.tobytes())
    return h.hexdigest()


def digest_of_arrivals(reqs) -> str:
    """tests/torch_serve_regen.py's digest of an arrival list."""
    rows = [[r.arrive_tick, r.prompt_blocks, r.decode_tokens, r.kind]
            for r in reqs]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def cuda_launches(fn) -> tuple[int, object]:
    """``fn()``'s kernel launches (the ``cudaLaunchKernel`` calls that
    ``torch.profiler`` records) and its result."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                            "cudaLaunchKernelExC")), out


def profiled_ticks(engine, window: range, seen: list):
    """A ``run_load`` tick hook: each tick of `window` replayed on a copy
    of the run's state under the profiler (outside the run's timing);
    appends (launches less the copy's, busy slots after the tick)."""
    def hook(t, replay):
        if t in window:
            n, after = cuda_launches(replay)
            n_copy, _ = cuda_launches(lambda: engine.clone(after))
            seen.append((n - n_copy, int(after.slot_live.sum())))
    return hook


def serving_engine(dev, smi: str) -> dict:
    """Phase 13: the serving engine (``repro_torch.serve``) on the card.

    (a) benchmarks/serve_bench.py's matrix, (b) the decode storm of
    benchmarks/serving.py and its no-cluster ablation, (c) 64 slots and
    4096 pages at a deployment's load, each against the JAX snapshot
    ``tests/golden/torch_serve.json`` (every record field but the timing
    ones; each arrival list's digest first), the records also against
    the offline ``serve_record`` of the phase's trace; (d) the
    time-sharded simulator against its serial kernel run.  Returns the
    phase's numbers.
    """
    import repro_torch.obs as obs
    from repro_torch.core import mmu
    from repro_torch.kernels import mmu_step
    from repro_torch.obs import report
    from repro_torch.serve import engine, load
    from repro_torch.sim import parallel, systems, trace_gen

    with open(SERVE_SNAPSHOT, encoding="utf-8") as f:
        snap = json.load(f)
    timing = set(snap["timing_fields"])
    out = {"runs": {}, "storms": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        tr = obs.configure(os.path.join(tmp, "serve.jsonl"))
        live = []
        for want in snap["runs"]:
            cfg = engine.EngineConfig(**want["cfg"])
            gen = (load.poisson_trace if want["arrival"] == "poisson"
                   else load.diurnal_trace)
            reqs = gen(want["rate"], want["ticks"], cfg, seed=want["seed"])
            if digest_of_arrivals(reqs) != want["arrivals_sha256"]:
                raise AssertionError(
                    f"{want['name']}: this numpy draws another arrival "
                    f"list than the snapshot's")
            mid = want["record"]["n_ticks"] // 2
            window = range(mid - 1, mid - 1 + SERVE_PROFILED_TICKS)
            seen = []
            rec = load.run_load(reqs, cfg, lanes=want["lanes"],
                                run=want["name"], arrival=want["arrival"],
                                rate=want["rate"], device=dev,
                                tick_hook=profiled_ticks(engine, window,
                                                         seen))
            if len(seen) != SERVE_PROFILED_TICKS or min(seen)[0] <= 0:
                raise AssertionError(f"{want['name']}: ticks {window} "
                                     f"profiled as {seen}")
            got = {k: v for k, v in rec.items() if k not in timing}
            if got != want["record"]:
                diff = {k: (got.get(k), v) for k, v in want["record"].items()
                        if got.get(k) != v}
                raise AssertionError(f"{want['name']}: record differs from "
                                     f"the JAX snapshot: {diff}")
            live.append(rec)
            out["runs"][want["name"]] = {
                "cfg": want["cfg"], "lanes": want["lanes"],
                "ticks": rec["n_ticks"], "arrivals": rec["n_arrivals"],
                "p50_ms": rec["decode_p50_s"] * 1e3,
                "p99_ms": rec["decode_p99_s"] * 1e3,
                "mean_ms": rec["decode_mean_s"] * 1e3,
                "wall_s": rec["wall_s"], "rps": rec["throughput_rps"],
                "vtc_hit_rate": rec["vtc_hit_rate"],
                "profiled_ticks": [window.start, window.stop - 1],
                "launches_per_tick": sum(n for n, _ in seen) / len(seen),
                "busy_slots": sum(b for _, b in seen) / len(seen)}
            r = out["runs"][want["name"]]
            print(f"{want['name']}: {r['ticks']} ticks, {r['arrivals']} "
                  f"arrivals, decode tick p50 {r['p50_ms']:.3f} ms, p99 "
                  f"{r['p99_ms']:.3f} ms, {r['rps']} requests/s, "
                  f"{r['launches_per_tick']:.0f} launches a tick (ticks "
                  f"{window.start}-{window.stop - 1}, {r['busy_slots']:.1f} "
                  f"busy slots, each replayed on a copy), VTC hit rate "
                  f"{r['vtc_hit_rate']:.6f} [{smi}]")
        tr.flush()
        offline = report.serve_records(report.read_trace(tr.path), tr.path)
        if offline != live:
            raise AssertionError("the offline serve records of the phase's "
                                 "trace differ from the live ones")
        print(f"{len(live)} runs equal the JAX snapshot on every record "
              f"field but the timing ones, arrival digests first; the "
              f"offline records of the trace equal the live ones [{smi}]")

        # (b) the decode storm and its no-cluster ablation
        obs.configure(os.path.join(tmp, "storm.jsonl"))
        for want in snap["storms"]:
            scope = f"storm{want['n_clusters']}"
            cfg = engine.EngineConfig(**snap["storm_cfg"],
                                      n_clusters=want["n_clusters"])
            st = engine.init(cfg, device=dev)
            for slot in range(cfg.n_slots):
                st, _ok = engine.admit(st, slot, 2 + slot % 3)
            t0 = time.perf_counter()
            for _ in range(want["ticks"]):
                st, _phys, _src = engine.decode_step(st, cfg, scope=scope)
            wall = time.perf_counter() - t0
            got = {"n_clusters": want["n_clusters"], "ticks": want["ticks"],
                   "n_hit_tc": int(st.vtc.n_hit_tc[0]),
                   "n_hit_cluster": int(st.vtc.n_hit_cluster[0]),
                   "n_walk": int(st.vtc.n_walk[0]),
                   "pages_free": int(st.page_free.sum()),
                   "pool_stall": int(st.n_pool_stall[0]),
                   "pressure": bool(st.pressure[0]),
                   "state_sha256": digest_of_leaves(
                       [x[0].cpu().numpy()
                        for x in parallel.tree_leaves(st)])}
            if got != want:
                raise AssertionError(f"storm n_clusters="
                                     f"{want['n_clusters']}: {got} != the "
                                     f"JAX snapshot's {want}")
            lat = obs.REGISTRY.hist_stats(
                engine.scoped(obs.names.HIST_DECODE_STEP_S, scope))
            # launches a tick: decode_step itself, on a copy, after the run
            spare = engine.clone(st)

            def ticks(spare=spare, cfg=cfg, scope=scope):
                for _ in range(SERVE_PROFILED_TICKS):
                    engine.decode_step(spare, cfg, scope=scope + "_profiled")

            n_launch, _ = cuda_launches(ticks)
            hits = got["n_hit_tc"] + got["n_hit_cluster"]
            s = {"p50_ms": lat["p50"] * 1e3, "p99_ms": lat["p99"] * 1e3,
                 "wall_s": wall,
                 "launches_per_tick": n_launch / SERVE_PROFILED_TICKS,
                 "vtc_hit_rate": hits / (hits + got["n_walk"]),
                 "walk_rate": got["n_walk"] / (hits + got["n_walk"])}
            out["storms"][want["n_clusters"]] = s
            print(f"storm, {want['n_clusters']} clusters: state equals the "
                  f"JAX snapshot after {want['ticks']} ticks; decode tick "
                  f"p50 {s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms, "
                  f"{s['launches_per_tick']:.0f} launches a tick, VTC hit "
                  f"rate {s['vtc_hit_rate']:.6f} (walks "
                  f"{s['walk_rate']:.4f}), {wall:.2f} s [{smi}]")

        # (d) the time-sharded simulator: one kernel launch a hand-off round
        gen = trace_gen.generate("bc", n=TIME_SHARD_N, seed=0)
        trace = dict(gen["trace"])
        trace["ipa"] = np.full((TIME_SHARD_N,), gen["spec"].ipa, np.float32)
        cfg = systems.config("victima")
        timed = {}
        for t_sh in (1, TIME_SHARDS):
            before = mmu_step.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats, extras = mmu.simulate(cfg, trace, device=dev,
                                         time_shards=t_sh)
            torch.cuda.synchronize()
            timed[t_sh] = (stats, extras, (time.perf_counter() - t0) * 1e3,
                           mmu_step.LAUNCHES - before)
        (s1, e1, ms1, n1), (s4, e4, ms4, n4) = timed[1], timed[TIME_SHARDS]
        rounds = max(e["attrs"]["round"] for e in obs.tracer().events
                     if e.get("name") == obs.names.EV_TIME_SHARD_ROUND)
        if not 1 <= n4 == rounds <= TIME_SHARDS or n1 < 1:
            raise AssertionError(f"time-sharded Victima: {n4} launches for "
                                 f"{rounds} rounds, {n1} serial launches")
        for field, a, b in zip(s1._fields, s1, s4):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise AssertionError(f"time-sharded Victima: Stats.{field} "
                                     f"differs from the serial run")
        if sorted(e1) != sorted(e4) or any(
                not np.array_equal(np.asarray(e1[k]), np.asarray(e4[k]))
                for k in e1):
            raise AssertionError("time-sharded Victima: extras differ")
        out["time_shard"] = {"system": "victima", "workload": "bc",
                             "n": TIME_SHARD_N, "t_shards": TIME_SHARDS,
                             "rounds": n4, "ms": ms4, "serial_ms": ms1,
                             "serial_launches": n1}
        print(f"time-sharded Victima, bc, n={TIME_SHARD_N}: {TIME_SHARDS} "
              f"shards, {n4} rounds (one launch each), {ms4:.2f} ms against "
              f"{ms1:.2f} ms serial ({n1} launches), Stats equal [{smi}]")
    finally:
        obs.tracer().close()
        shutil.rmtree(tmp, ignore_errors=True)

    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import metrics, mmu, timing
    from repro_torch.core.stages import (Dyn, SimConfig, default_stages,
                                         make_state, state_leaves)
    from repro_torch.kernels import build, mmu_step
    from repro_torch.sim import paper, runner, systems, trace_gen

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
    with ThreadPoolExecutor(1) as host:
        hybrid_draw = host.submit(draw_hybrid_snapshot)   # for phase 17
        with ThreadPoolExecutor(len(LIBRARIES)) as pool:
            builds = dict(zip(LIBRARIES, pool.map(build.compile_kernel,
                                                  LIBRARIES)))
        hybrid_inputs = hybrid_draw.result()
    for src, built in builds.items():
        print(f"built {src} in {built['seconds']:.2f} s")
        for ln in built["log"].splitlines():
            if any(w in ln for w in ("registers", "spill", "smem", "stack")):
                print("  " + ln.strip())
    chase = build.load("load_latency")
    l1_ns = load_latency_ns(chase, 16 << 10, dev)
    l2_ns = load_latency_ns(chase, 16 << 20, dev)
    sm_ns = load_latency_ns(chase, 16 << 10, dev, shared=True)
    codes = dict((*mmu_step.COMPOSITIONS.values(),
                  *mmu_step.COLLECTED.values(),
                  *mmu_step.LADDER_COMPOSITIONS.values()))
    built = mmu_step.instantiations()
    if len(built) != 27:
        raise AssertionError(f"{len(built)} instantiations, want 27")
    ladder_ptxas, inst_ptxas = {}, {}
    for comp, place in built:
        dyn = comp in LADDER_COMP.values()
        usage = ptxas_usage(builds["mmu_step"]["log"],
                            mmu_entry(codes[comp], place, dyn))
        inst_ptxas[f"{comp}/{place}"] = usage
        if dyn:
            ladder_ptxas[comp] = usage
        print(f"mmu_step {comp} ({place}{', ladder' if dyn else ''}): "
              + usage)
    print(f"dependent load: {l1_ns:.1f} ns at a 16 KiB footprint (L1 hit), "
          f"{l2_ns:.1f} ns at 16 MiB (L2 hit), {sm_ns:.1f} ns in shared "
          f"memory")
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

    def leaf_index(cfg, pick):
        """The position of the leaf `pick(state)` in ``state_leaves``."""
        st = make_state(cfg, 1, "meta")
        want = pick(st)
        return next(i for i, x in enumerate(state_leaves(st)) if x is want)

    def on_card(tr):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in tr.items()}

    def run_kernel(cfg, tr):
        """State leaves after the kernel, its launch checked to have taken
        the configuration's placement and composition."""
        names = default_stages(cfg)
        stk = make_state(cfg, tr["vpn"].shape[1], dev)
        ctr = on_card(tr)
        want = mmu_step.placement(cfg).name
        comp = mmu_step.composition(cfg, names)[0]
        before = mmu_step.LAUNCHES_BY_PLACEMENT[want]
        before_c = mmu_step.LAUNCHES_BY_COMPOSITION[comp]
        mmu_step.launch(stk, ctr, cfg, names)
        if mmu_step.LAUNCHES_BY_PLACEMENT[want] != before + 1:
            raise AssertionError(f"the launch did not take placement {want}")
        if mmu_step.LAUNCHES_BY_COMPOSITION[comp] != before_c + 1:
            raise AssertionError(f"the launch did not run composition {comp}")
        return leaves(stk)

    def run_both(cfg, tr):
        """State leaves after the kernel and after the plain version, both
        on the card."""
        k = run_kernel(cfg, tr)
        stp = make_state(cfg, tr["vpn"].shape[1], dev)
        mmu_step.plain_scan(mmu.make_step(cfg, default_stages(cfg)), stp,
                            on_card(tr))
        torch.cuda.synchronize()
        return k, leaves(stp)

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
    # the multicore systems' traces: MC_MIX over their cores (its first
    # component alone at one core), as multicore_scaling runs them
    mix_wl = {c: paper.MC_MIX if c > 1 else
              trace_gen.parse_mix(paper.MC_MIX)[0] for c in (1, 2, 4)}

    def mix_trace(c, n):
        g = trace_gen.generate_mix(mix_wl[c], n=n, seed=0, n_cores=c)
        return {k: np.ascontiguousarray(v) for k, v in g["trace"].items()}

    def small_mix_trace(c, n, seeds):
        """Per-lane golden traces, lane l being core l % c."""
        trs = [golden_trace(n, seed) for seed in seeds]
        tr = {k: np.stack([x[k] for x in trs], axis=1) for k in trs[0]}
        tr["core"] = (np.arange(len(trs), dtype=np.int32) % c)[None, :] \
            .repeat(n, 0)
        return tr

    def ladder_trace(ladder, small):
        """The ladder check's trace, one column a lane: per-lane mixed
        traces on small structures; at Table 3 the member's workload, the
        11 in turn, or a multicore member's mix, one lane a core."""
        members = SMALL_LADDERS[ladder] if small else systems.LADDERS[ladder]
        cores = systems.mix_cores(systems.LADDERS[ladder])
        lanes = len(members) * cores
        if small:
            return small_mix_trace(cores, SMALL_N, range(lanes))
        if cores > 1:
            return {k: np.tile(v, (1, len(members)))
                    for k, v in mix_trace(cores, CHECK_N).items()}
        cols = [c % len(workloads) for c in range(lanes)]
        return {k: np.ascontiguousarray(v[:CHECK_N, cols])
                for k, v in main_tr.items()}

    LADDER_CHECKS = [(lad, small) for lad in ("radix", "np", "radix_2c")
                     for small in (False, True)]
    # the new systems' checks against the plain version (on the CPU
    # workers): name -> (trace, config overrides)
    new_checks = {n: (check_tr, {}) for n in VIRT2}
    new_checks.update({n: (mix_trace(systems.config(n).n_cores, CHECK_N),
                           {}) for n in MULTICORE_PLAIN})
    new_checks.update({f"{n} (small)": (small_mix_trace(
        systems.config(n).n_cores, SMALL_N, range(systems.config(n).n_cores)),
        {**SMALL, **over}) for n, over in MC_SMALL.items()})
    # STAGED's plain versions run on the CPU, in worker processes, while
    # the card checks the others
    pool = ProcessPoolExecutor(PLAIN_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        ladder_plain = {key: pool.submit(plain_dyn_leaves, *key,
                                         ladder_trace(*key))
                        for key in LADDER_CHECKS}
        staged_plain = {name: pool.submit(plain_leaves, name, check_tr)
                        for name in sorted(STAGED, key=lambda n: (
                            "virt" not in n and n != "np", n))
                        + PAPER_PLAIN}
        new_plain = {key: pool.submit(plain_leaves, key.split()[0], tr, over)
                     for key, (tr, over) in new_checks.items()}
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
                  f"plain on all {len(k)} leaves "
                  f"({time.perf_counter() - t0:.1f} s)")
        for name, want in PLACED.items():
            t0 = time.perf_counter()
            cfg = systems.config(name)
            got = mmu_step.placement(cfg)
            if got.name != want:
                raise AssertionError(f"{name}: placement {got.name}, "
                                     f"want {want}")
            k, p = run_both(cfg, {k: v[:PLACED_N]
                                  for k, v in check_tr.items()})
            err = max_err(k, p)
            worst = max(worst, err)
            if err != 0.0:
                raise AssertionError(f"{name}: kernel differs from the plain "
                                     f"version (max abs err {err})")
            print(f"{name} ({want}, {got.smem_bytes:,} bytes of shared "
                  f"memory), rnd+bc, {PLACED_N} accesses: kernel == plain on "
                  f"all {len(k)} leaves ({time.perf_counter() - t0:.1f} s)")
        for name, comp in [*STAGED.items(),
                           *((n, PAPER[n]) for n in PAPER_PLAIN)]:
            t0 = time.perf_counter()
            cfg = systems.config(name)
            got = mmu_step.placement(cfg)
            if got.name != "shared":
                raise AssertionError(f"{name}: placement {got.name}, want "
                                     f"shared")
            k = run_kernel(cfg, check_tr)  # checks the composition too
            err = max_err(k, staged_plain[name].result())
            worst = max(worst, err)
            if err != 0.0:
                raise AssertionError(f"{name}: kernel differs from the plain "
                                     f"version (max abs err {err})")
            print(f"{name} ({comp}, shared, {got.smem_bytes:,} bytes) "
                  f"Table-3, rnd+bc, {CHECK_N} accesses: kernel == plain (on "
                  f"the CPU) on all {len(k)} leaves (waited "
                  f"{time.perf_counter() - t0:.1f} s)")
        # Utopia and Revelator under nested paging at Table 3 (rnd+bc);
        # the multicore systems at Table 3 on their mix and, with the DRAM
        # cache, on small structures where it hits
        for key, (tr, over) in new_checks.items():
            t0 = time.perf_counter()
            name = key.split()[0]
            cfg = dataclasses.replace(systems.config(name), **over)
            comp = {**VIRT2, **MULTICORE}[name]
            if mmu_step.placement(cfg).name != "shared" or \
                    mmu_step.composition(cfg, default_stages(cfg))[0] != comp:
                raise AssertionError(f"{key}: want composition {comp} in "
                                     f"shared memory")
            k = run_kernel(cfg, tr)
            err = max_err(k, new_plain[key].result())
            worst = max(worst, err)
            if err != 0.0:
                raise AssertionError(f"{key}: kernel differs from the plain "
                                     f"version (max abs err {err})")
            hit = ""
            if cfg.dram_cache_sets:
                hits = k[leaf_index(cfg, lambda st: st.hier.n_dramc_hit)]
                if "small" in key and int(hits.min()) <= 0:
                    raise AssertionError(f"{key}: the DRAM cache never hit")
                hit = f", DRAM-cache hits {hits.tolist()}"
            what = "rnd+bc" if tr is check_tr else "its mix"
            print(f"{key} ({comp}), {what}, {tr['vpn'].shape[0]} accesses "
                  f"x {tr['vpn'].shape[1]} "
                  f"lanes: kernel == plain (on the CPU) on all {len(k)} "
                  f"leaves{hit} (waited {time.perf_counter() - t0:.1f} s)")
        with open(os.path.join(ROOT, "tests", "golden",
                               "mmu_stats.json")) as f:
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
            raise AssertionError("the result depends on the trace-block "
                                 "size")
        print("victima with 97-access blocks == one block")
        # the ladder instantiations against the plain dyn step
        for ladder, small in LADDER_CHECKS:
            t0 = time.perf_counter()
            base, dyn = ladder_setup(ladder, small)
            names = default_stages(base)
            tr = ladder_trace(ladder, small)
            lanes = tr["vpn"].shape[1]
            comp = LADDER_COMP[ladder]
            pl = mmu_step.ladder_placement(base, names)
            before = dict(mmu_step.LAUNCHES_BY_COMPOSITION)
            before_p = mmu_step.LAUNCHES_BY_PLACEMENT[pl.name]
            stk = make_state(base, lanes, dev)
            mmu_step.launch(stk, on_card(tr), base, names,
                            dyn=dyn.to(dev))
            got = {k: v - before[k] for k, v in
                   mmu_step.LAUNCHES_BY_COMPOSITION.items() if v != before[k]}
            if got != {comp: 1} or \
                    mmu_step.LAUNCHES_BY_PLACEMENT[pl.name] != before_p + 1:
                raise AssertionError(f"ladder {ladder}: launched {got}, want "
                                     f"one {comp} in {pl.name}")
            k = leaves(stk)
            del stk
            err = max_err(k, ladder_plain[ladder, small].result())
            worst = max(worst, err)
            if err != 0.0:
                raise AssertionError(f"ladder {ladder} ({comp}, "
                                     f"{'small' if small else 'Table 3'}): "
                                     f"kernel differs from the plain dyn "
                                     f"step (max abs err {err})")
            n = tr["vpn"].shape[0]
            where = ("small structures" if small
                     else "Table 3, the registered members")
            print(f"ladder {ladder} ({comp}, {pl.name}, {where}, "
                  f"{lanes} lanes x {n} accesses): kernel == plain dyn step "
                  f"(on the CPU) on all {len(k)} leaves (waited "
                  f"{time.perf_counter() - t0:.1f} s)")
    finally:
        pool.shutdown(cancel_futures=True)
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
    composition = {**{n: n for n in SYSTEMS}, **STAGED, **PAPER, **VIRT2,
                   **MULTICORE}

    def main_path_launches(name):
        """Launches since the counts were set to 0; every one must have
        kept the whole lane in shared memory (Table 3) and run the
        system's composition."""
        by = {k: v for k, v in mmu_step.LAUNCHES_BY_PLACEMENT.items() if v}
        by_c = {k: v for k, v in mmu_step.LAUNCHES_BY_COMPOSITION.items()
                if v}
        if mmu_step.LAUNCHES == 0:
            raise AssertionError(f"{name}: the main path launched no kernel")
        if by != {"shared": mmu_step.LAUNCHES}:
            raise AssertionError(f"{name}: main-path launches by placement "
                                 f"{by}, want all in shared memory")
        if by_c != {composition[name]: mmu_step.LAUNCHES}:
            raise AssertionError(f"{name}: main-path launches by composition "
                                 f"{by_c}, want all {composition[name]}")
        return mmu_step.LAUNCHES, by

    def zero_counts():
        mmu_step.LAUNCHES = 0
        for counts in (mmu_step.LAUNCHES_BY_PLACEMENT,
                       mmu_step.LAUNCHES_BY_COMPOSITION):
            for k in counts:
                counts[k] = 0

    def snapshot_equal(name, out, want, n):
        """Every Stats leaf and extra of `out` equals the snapshot's; an
        extra the snapshot holds as ``<key>_sha256`` (feats, pc4) by its
        digest."""
        for w in workloads:
            stats, extras, _ = out[w]
            for field, v in want[w]["stats"].items():
                if np.asarray(getattr(stats, field)).tolist() != v:
                    raise AssertionError(f"{name}/{w}: Stats.{field} "
                                         f"differs from the snapshot (n={n})")
            keys = {k.removesuffix("_sha256") for k in want[w]["extras"]}
            if set(extras) != keys:
                raise AssertionError(f"{name}/{w}: extras {sorted(extras)}, "
                                     f"the snapshot's {sorted(keys)}")
            for key, v in want[w]["extras"].items():
                got = (sha256_of(*extras[key.removesuffix("_sha256")])
                       if key.endswith("_sha256")
                       else np.asarray(extras[key]).tolist())
                if got != v:
                    raise AssertionError(f"{name}/{w}: extras[{key!r}] "
                                         f"differs from the snapshot (n={n})")

    for name in SYSTEMS:
        zero_counts()
        out = runner.run_batch(name, n=FULL_N, seed=0, cache=False)
        launches, _ = main_path_launches(name)
        snapshot_equal(name, out, snap["systems"][name], FULL_N)
        print(f"{name}: 11 workloads equal the JAX snapshot on every Stats "
              f"leaf and extra ({launches} launches)")
    with open(os.path.join(ROOT, "tests", "golden",
                           "torch_fullsize_stages_stats.json")) as f:
        snap2 = json.load(f)
    assert (snap2["seed"], snap2["workloads"]) == (0, workloads), \
        "stages snapshot settings"
    for n, digests in snap2["trace_sha256"].items():
        for w, g in zip(workloads, trace_gen.generate_many(
                workloads, n=int(n), seed=0)):
            h = hashlib.sha256()
            for k in ("vpn", "is2m", "line"):
                h.update(g["trace"][k].tobytes())
            if h.hexdigest() != digests[w]:
                raise AssertionError(f"{w}: the port's trace at n={n} differs "
                                     f"from the stages snapshot's")
    print(f"stages snapshot traces: all 11 equal at n = "
          f"{', '.join(sorted(snap2['trace_sha256']))} (sha256)")
    for name in STAGED:
        want = snap2["systems"][name]
        zero_counts()
        out = runner.run_batch(name, n=want["n"], seed=0, cache=False)
        launches, _ = main_path_launches(name)
        snapshot_equal(name, out, want["workloads"], want["n"])
        print(f"{name}: 11 workloads at n={want['n']} equal the JAX stages "
              f"snapshot on every Stats leaf and extra ({launches} launches, "
              f"all {composition[name]} in shared memory)")
    with open(os.path.join(ROOT, "tests", "golden",
                           "torch_fullsize_paper_stats.json")) as f:
        snap3 = json.load(f)
    assert (snap3["n"], snap3["seed"], snap3["workloads"]) == \
        (FULL_N, 0, workloads), "paper snapshot settings"
    if snap3["trace_sha256"] != snap["trace_sha256"]:
        raise AssertionError("the paper snapshot was made from other traces")
    for name in PAPER:
        zero_counts()
        out = runner.run_batch(name, n=FULL_N, seed=0, cache=False)
        launches, _ = main_path_launches(name)
        snapshot_equal(name, out, snap3["systems"][name], FULL_N)
        digests = " (feats, pc4 by sha256)" if name == "radix_collect" \
            else ""
        print(f"{name}: 11 workloads equal the JAX paper snapshot on every "
              f"Stats leaf and extra{digests} ({launches} launches, all "
              f"{composition[name]} in shared memory)")
    # the last systems: Utopia and Revelator under nested paging over
    # the 11 workloads, the multicore systems on their mixes
    with open(os.path.join(ROOT, "tests", "golden",
                           "torch_fullsize_multicore_stats.json")) as f:
        snap4 = json.load(f)
    assert (snap4["n"], snap4["seed"], snap4["workloads"], snap4["mix"]) \
        == (FULL_N, 0, workloads, paper.MC_MIX), "multicore snapshot settings"
    if snap4["trace_sha256"] != snap["trace_sha256"]:
        raise AssertionError("the multicore snapshot was made from other "
                             "traces")
    for c, wl in mix_wl.items():
        if sha256_of(*[v for _, v in sorted(mix_trace(c, FULL_N).items())]) \
                != snap4["mix_sha256"][f"{wl}@{c}"]:
            raise AssertionError(f"{wl} at {c} cores: the port's mix "
                                 f"differs from the snapshot's")
    print(f"multicore snapshot mixes: {', '.join(snap4['mix_sha256'])} "
          f"equal (sha256)")
    for name in VIRT2:
        zero_counts()
        out = runner.run_batch(name, n=FULL_N, seed=0, cache=False)
        launches, _ = main_path_launches(name)
        snapshot_equal(name, out, snap4["systems"][name], FULL_N)
        print(f"{name}: 11 workloads equal the JAX multicore snapshot on "
              f"every Stats leaf and extra ({launches} launches, all "
              f"{composition[name]} in shared memory)")

    def cores_equal(name, got, want):
        """A multicore cell (a single-core one at one core) equals the
        snapshot's per-core entries on every Stats leaf and extra."""
        stats, extras, _ = got
        if systems.config(name).n_cores == 1:
            stats, extras = (stats,), (extras,)
        if len(stats) != len(want["cores"]):
            raise AssertionError(f"{name}: {len(stats)} core lanes")
        for c, (st, ex, w) in enumerate(zip(stats, extras, want["cores"])):
            for field, v in w["stats"].items():
                if np.asarray(getattr(st, field)).tolist() != v:
                    raise AssertionError(f"{name}/core {c}: Stats.{field} "
                                         f"differs from the snapshot")
            if sorted(ex) != sorted(w["extras"]) or any(
                    np.asarray(ex[k]).tolist() != v
                    for k, v in w["extras"].items()):
                raise AssertionError(f"{name}/core {c}: extras differ from "
                                     f"the snapshot")

    for name in MULTICORE:
        want = snap4["multicore"][name]
        zero_counts()
        got = runner.run(name, want["workload"], n=FULL_N, seed=0,
                         cache=False)
        launches, _ = main_path_launches(name)
        cores_equal(name, got, want)
        print(f"{name} on {want['workload']}: every core lane equals the "
              f"JAX multicore snapshot on every Stats leaf and extra "
              f"({launches} launches, all {composition[name]})")
    # the ladders through run_ladder, from a fresh cache: every member's
    # every workload against the snapshot that holds it
    ladder_snap = {**snap["systems"], **snap3["systems"], **snap4["systems"],
                   **{n: v["workloads"] for n, v in snap2["systems"].items()}}
    cache_dir = runner.CACHE_DIR
    for ladder, comp in LADDER_COMP.items():
        if ladder in MC_LADDERS:
            continue
        members = systems.LADDERS[ladder]
        base = systems.ladder_base_config(ladder)
        place = mmu_step.ladder_placement(base, default_stages(base)).name
        runner.CACHE_DIR = tempfile.mkdtemp(prefix="ladder_")
        try:
            zero_counts()
            t0 = time.perf_counter()
            out = runner.run_ladder(ladder, workloads, n=FULL_N, seed=0)
            wall = time.perf_counter() - t0
        finally:
            shutil.rmtree(runner.CACHE_DIR, ignore_errors=True)
            runner.CACHE_DIR = cache_dir
        by = {k: v for k, v in mmu_step.LAUNCHES_BY_PLACEMENT.items() if v}
        by_c = {k: v for k, v in mmu_step.LAUNCHES_BY_COMPOSITION.items()
                if v}
        if not mmu_step.LAUNCHES or by != {place: mmu_step.LAUNCHES} or \
                by_c != {comp: mmu_step.LAUNCHES}:
            raise AssertionError(f"ladder {ladder}: launches by placement "
                                 f"{by}, by composition {by_c}; want all "
                                 f"{comp} in {place}")
        for name in members:
            snapshot_equal(name, out[name], ladder_snap[name], FULL_N)
        print(f"run_ladder({ladder!r}): {len(members)} members x 11 "
              f"workloads equal the JAX snapshots on every Stats leaf and "
              f"extra ({mmu_step.LAUNCHES} launches, all {comp} in {place}; "
              f"{wall:.2f} s)")
    for ladder in MC_LADDERS:
        members = systems.LADDERS[ladder]
        wl = snap4["multicore"][members[0]]["workload"]
        runner.CACHE_DIR = tempfile.mkdtemp(prefix="ladder_")
        try:
            zero_counts()
            t0 = time.perf_counter()
            out = runner.run_ladder(ladder, [wl], n=FULL_N, seed=0)
            wall = time.perf_counter() - t0
        finally:
            shutil.rmtree(runner.CACHE_DIR, ignore_errors=True)
            runner.CACHE_DIR = cache_dir
        by = {k: v for k, v in mmu_step.LAUNCHES_BY_PLACEMENT.items() if v}
        by_c = {k: v for k, v in mmu_step.LAUNCHES_BY_COMPOSITION.items()
                if v}
        if not mmu_step.LAUNCHES or by != {"shared": mmu_step.LAUNCHES} or \
                by_c != {"ladder_mc": mmu_step.LAUNCHES}:
            raise AssertionError(f"ladder {ladder}: launches by placement "
                                 f"{by}, by composition {by_c}; want all "
                                 f"ladder_mc in shared")
        for name in members:
            cores_equal(name, out[name][wl], snap4["multicore"][name])
        print(f"run_ladder({ladder!r}) on {wl}: {len(members)} members x "
              f"{systems.mix_cores(members)} cores equal the JAX multicore "
              f"snapshot on every Stats leaf and extra "
              f"({mmu_step.LAUNCHES} launches, all ladder_mc in shared; "
              f"{wall:.2f} s)")
    print(f"phase 3: {time.perf_counter() - t:.1f} s")

    # ------------------------------------------------------------ 4
    t = phase(f"4. timing: the main path at n={TIMED_N}")
    W = len(workloads)
    print(f"trace generation alone (11 workloads, generate_many): "
          f"{gen_s:.2f} s")
    results, main_launches, by_placement, main_ms = {}, {}, {}, {}
    main_floor, main_wall = {}, {}
    for name in SYSTEMS + tuple(STAGED) + tuple(PAPER) + tuple(VIRT2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        results[name] = runner.run_batch(name, n=TIMED_N, seed=0,
                                         cache=False)
        wall = time.perf_counter() - t0
        main_launches[name], by_placement[name] = main_path_launches(name)
        peak = torch.cuda.max_memory_allocated() / 2**20
        # the kernel alone on the same inputs, between CUDA events
        cfg = systems.config(name)
        st = make_state(cfg, W, dev)
        ctr = on_card(main_tr)
        kms = cuda_time(lambda: mmu_step.launch(st, ctr, cfg,
                                                default_stages(cfg)))
        main_ms[name], main_wall[name] = kms, wall
        floor_ms, rounds = latency_floor(cfg, st, sm_ns, l1_ns, l2_ns)
        main_floor[name] = floor_ms
        print(f"{name} ({composition[name]}): run_batch wall {wall:.2f} s, "
              f"kernel {kms:.1f} ms ({main_launches[name]} launches, by "
              f"placement {by_placement[name]}), "
              f"{TIMED_N / kms * 1e3:,.0f} accesses/s per lane, "
              f"{TIMED_N * W / kms * 1e3:,.0f} accesses/s over {W} lanes, "
              f"peak device memory {peak:.0f} MiB; latency floor "
              f"{floor_ms:.1f} ms ({rounds:.1f} rounds per access, "
              f"{kms / floor_ms:.1f}x)")
    # the multicore systems on their mixes: run (its wall), then the
    # kernel alone on the same inputs; the floor counts the DRAM-cache
    # probes
    for name in MULTICORE:
        cfg = systems.config(name)
        c = cfg.n_cores
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        results[name] = runner.run(name, mix_wl[c], n=TIMED_N, seed=0,
                                   cache=False)
        wall = time.perf_counter() - t0
        main_launches[name], by_placement[name] = main_path_launches(name)
        tr = mix_trace(c, TIMED_N)
        if c == 1:
            tr.pop("core")
        st = make_state(cfg, c, dev)
        ctr = on_card(tr)
        kms = cuda_time(lambda: mmu_step.launch(st, ctr, cfg,
                                                default_stages(cfg)))
        main_ms[name], main_wall[name] = kms, wall
        floor_ms, rounds = latency_floor(cfg, st, sm_ns, l1_ns, l2_ns)
        main_floor[name] = floor_ms
        probes = max(int(st.hier.n_dramc_access.sum()), 1)
        dc = (f", DRAM-cache hit rate "
              f"{int(st.hier.n_dramc_hit.sum()) / probes:.3f}"
              if cfg.dram_cache_sets else "")
        print(f"{name} ({composition[name]}) on {mix_wl[c]}: run wall "
              f"{wall:.2f} s, kernel {kms:.1f} ms ({main_launches[name]} "
              f"launches, {c} lanes), {TIMED_N / kms * 1e3:,.0f} accesses/s "
              f"per lane, {TIMED_N * c / kms * 1e3:,.0f} over {c} lanes; "
              f"latency floor {floor_ms:.1f} ms ({rounds:.1f} rounds per "
              f"access, {kms / floor_ms:.1f}x){dc}")
        # the single-core system on the same lanes (the core leaf
        # dropped): what the shared tier costs, the inputs held equal
        single = name[:-len(f"_{c}c")]
        if c > 1 and single in systems.names():
            cfg1 = systems.config(single)
            tr1 = {k: v for k, v in tr.items() if k != "core"}
            st1, ctr1 = make_state(cfg1, c, dev), on_card(tr1)
            kms1 = cuda_time(lambda: mmu_step.launch(
                st1, ctr1, cfg1, default_stages(cfg1)))
            print(f"  {single} ({composition[single]}) on the same {c} "
                  f"lanes: kernel {kms1:.1f} ms; {name} "
                  f"{(kms / kms1 - 1) * 100:+.1f}%")
            del st1, ctr1
        del st, ctr
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

    # ------------------------------------------------------------ 4b
    t = phase(f"4b. the native ladder's fill at n={TIMED_N} beside its "
              f"members' static kernel runs")
    members = systems.LADDERS["radix"]
    S = len(members)
    base = systems.ladder_base_config("radix")
    lnames = default_stages(base)
    chunk = runner.CHUNK or runner.auto_chunk(W)
    tmp = tempfile.mkdtemp(prefix="ladder_fill_")
    cache_dir = runner.CACHE_DIR
    try:
        runner.CACHE_DIR = tmp
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        fill = runner.run_ladder("radix", workloads, n=TIMED_N, seed=0)
        fill_wall = time.perf_counter() - t0
    finally:
        runner.CACHE_DIR = cache_dir
        shutil.rmtree(tmp, ignore_errors=True)
    # the fill's record, derived from its ladder_fill span tree
    fill_rec = runner.LADDER_PERF[-1]
    if (fill_rec["backend"], fill_rec["n_members"], fill_rec["one_compile"],
            fill_rec["n_chunks"]) != ("cuda", S, True, -(-W // chunk)):
        raise AssertionError(f"the fill's LADDER_PERF record {fill_rec}")
    print(f"LADDER_PERF record of the fill (obs.report.fill_record of its "
          f"span tree): {json.dumps(fill_rec)}")
    fill_launches = mmu_step.LAUNCHES
    fill_peak = torch.cuda.max_memory_allocated() / 2**20
    by_c = {k: v for k, v in mmu_step.LAUNCHES_BY_COMPOSITION.items() if v}
    if not fill_launches or by_c != {"ladder_native": fill_launches}:
        raise AssertionError(f"the fill launched {by_c}, want all "
                             f"ladder_native")
    # the fill's kernel alone, chunk by chunk, on the fill's inputs (the
    # last chunk padded by repeating its final workload, lanes
    # system-major), between CUDA events
    lanes = S * chunk
    dyn = Dyn(*[x.to(dev).repeat_interleave(chunk)
                for x in systems.ladder_dyn(members)])
    fill_ms = 0.0
    for lo in range(0, W, chunk):
        cols = [min(c, W - 1) for c in range(lo, lo + chunk)]
        ctr = on_card({k: np.tile(v[:, cols], (1, S))
                       for k, v in main_tr.items()})
        st = make_state(base, lanes, dev)
        fill_ms += cuda_time(lambda: mmu_step.launch(st, ctr, base, lnames,
                                                     dyn=dyn))
        del st, ctr
    # each member's static kernel run on the same inputs, timed; every
    # lane of the fill must equal it on every Stats leaf and extra
    static_ms = {}
    ctr = on_card(main_tr)
    for name in members:
        cfg = systems.config(name)
        st = make_state(cfg, W, dev)
        static_ms[name] = cuda_time(lambda: mmu_step.launch(
            st, ctr, cfg, default_stages(cfg)))
        stats, *rest = mmu._finalize(st, cfg)
        del st
        for wi, w in enumerate(workloads):
            got, got_ex, _ = fill[name][w]
            want_ex = mmu._extras_of(cfg, *rest, index=lambda x, i=wi: x[i])
            same = (all(np.array_equal(a[wi], b)
                        for a, b in zip(stats, got))
                    and sorted(want_ex) == sorted(got_ex)
                    and all(np.array_equal(want_ex[k], got_ex[k])
                            for k in want_ex))
            if not same:
                raise AssertionError(f"fill lane {name}/{w} differs from "
                                     f"its static kernel run")
    del ctr
    static_sum = sum(static_ms.values())
    acc = S * W * TIMED_N
    ladder_fill = {
        "ladder": "radix", "members": S, "workloads": W, "n": TIMED_N,
        "chunk": chunk, "lanes_per_launch": lanes,
        "launches": fill_launches, "wall_s": fill_wall, "kernel_ms": fill_ms,
        "accesses_per_s_kernel": acc / fill_ms * 1e3,
        "accesses_per_s_wall": acc / fill_wall,
        "peak_device_mib": fill_peak, "placement": "device",
        "members_static_kernel_ms": static_ms,
        "members_static_kernel_ms_sum": static_sum,
        "ptxas": ladder_ptxas, "ladder_perf": fill_rec}
    print(f"run_ladder('radix') at n={TIMED_N} from a fresh cache: {S} "
          f"members x {W} workloads, chunk {chunk}, {lanes} lanes a launch "
          f"(ladder_native, device), {fill_launches} launches; fill wall "
          f"{fill_wall:.2f} s, kernel {fill_ms:.1f} ms, "
          f"{acc / fill_ms * 1e3:,.0f} accesses/s over all lanes (kernel), "
          f"{acc / fill_wall:,.0f} (wall); peak device memory "
          f"{fill_peak:.0f} MiB")
    print(f"the {S} members' static kernel runs (11 lanes each) on the same "
          f"inputs: {static_sum:.1f} ms in sum ("
          + ", ".join(f"{n} {v:.1f}" for n, v in static_ms.items())
          + f"); fill kernel / sum = {fill_ms / static_sum:.3f}")
    print(f"every lane of the fill equals its member's static kernel run on "
          f"every Stats leaf and extra")
    print(f"phase 4b: {time.perf_counter() - t:.1f} s")

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
    pl = mmu_step.placement(cfg)
    chain_ms, rounds = latency_floor(cfg, states[0], sm_ns, l1_ns, l2_ns)
    dev_chain_ms, dev_rounds = latency_floor_device(cfg, states[0], l1_ns,
                                                    l2_ns)
    # the instantiation for this placement and the Victima composition
    entry = mmu_entry(mmu_step.C_VICTIMA, pl.name)
    print(f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, max abs err "
          f"{unit_err}; bytes bound {bound_ms:.5f} ms ({nbytes:,} bytes)")
    print(f"placement {pl.name}: {pl.smem_bytes:,} bytes of dynamic shared "
          f"memory a block; ptxas: "
          f"{ptxas_usage(builds['mmu_step']['log'], entry)}")
    print(f"latency floor {chain_ms:.3f} ms ({rounds:.1f} dependent rounds "
          f"per access, shared {sm_ns:.1f} ns, L1 {l1_ns:.1f} ns, L2 "
          f"{l2_ns:.1f} ns); with the whole state in device memory "
          f"{dev_chain_ms:.3f} ms ({dev_rounds:.1f} rounds per access, L1 "
          f"{l1_ns:.1f} ns, L2 {l2_ns:.1f} ns)")
    # the profiled build (clock64() stamps) on the same unit, both systems
    breakdown = {}
    for name in SYSTEMS:
        c = systems.config(name)
        prof = mmu_step.stage_cycles(make_state(c, W, dev), unit, c,
                                     default_stages(c))
        lanes = prof.cpu().numpy().astype(np.float64)
        slow = int(np.argmax(lanes[:, 6]))
        for what, p in ((f"mean over {W} lanes", lanes.sum(axis=0)),
                        (f"slowest lane, {workloads[slow]}", lanes[slow])):
            per = {s: p[k] / p[7] for k, s in enumerate(mmu_step.STAGES)}
            per["loop"] = p[6] / p[7]
            breakdown.setdefault(name, {})[what.split(",")[0]] = per
            print(f"{name} cycles per access (profiled build, thread 0's "
                  f"clock64, {what}): " + ", ".join(
                      f"{s} {per[s]:.0f} ({per[s] / per['loop'] * 100:.1f}%)"
                      for s in mmu_step.STAGES) + f"; loop {per['loop']:.0f}")
    print(f"phase 5: {time.perf_counter() - t:.1f} s")

    # ------------------------------------------------------------ 6
    t = phase("6. attention kernels against their plain versions, on the "
              "card")
    attn_errs = attention_vs_plain(dev)
    print(f"phase 6: {time.perf_counter() - t:.1f} s")

    # ------------------------------------------------------------ 7
    t = phase("7. granite-3-2b at full width, 2 layers, against the JAX "
              "snapshot")
    full_width_vs_snapshot(dev)
    print(f"phase 7: {time.perf_counter() - t:.1f} s")

    # ------------------------------------------------------------ 8
    t = phase(f"8. serving path: granite-3-2b, full width and depth, "
              f"{SERVE_B} requests x {SERVE_PROMPT} prompt tokens, "
              f"{SERVE_STEPS} decode steps")
    serve = serving_path(dev, builds["flash_attention"]["log"],
                         builds["paged_attention"]["log"])
    print(f"phase 8: {time.perf_counter() - t:.1f} s")

    # ------------------------------------------------------------ 9
    t = phase("9. ssd_intra kernels against their plain version, on the "
              "card")
    ssd_err = ssd_vs_plain(dev)
    print(f"phase 9: {time.perf_counter() - t:.1f} s")

    # ------------------------------------------------------------ 10
    t = phase("10. mamba2-2.7b at full width, 2 layers, against the JAX "
              "snapshot; float32 chunked == recurrent")
    mamba2_vs_snapshot(dev)
    print(f"phase 10: {time.perf_counter() - t:.1f} s")

    # ------------------------------------------------------------ 11
    torch.cuda.empty_cache()
    t = phase(f"11. serving path: mamba2-2.7b, full width and depth, "
              f"{SSM_B} requests x {SSM_PROMPT} prompt tokens, {SSM_STEPS} "
              f"decode steps")
    mamba = mamba2_serving(dev, builds["ssd_scan"]["log"])
    print(f"phase 11: {time.perf_counter() - t:.1f} s")

    # ------------------------------------------------------------ 12
    torch.cuda.empty_cache()
    t = phase(f"12. the paper tables: every figure at n={FULL_N} against "
              f"the reference's rows, then at n={TIMED_N}")
    from repro_torch.core import ptwcp_nn
    figs = {**snap3["figures"], **snap4["figures"]}
    assert sorted(figs) == sorted(f.__name__ for f in paper.ALL)
    t2 = snap3["table2"]
    inits = {name: [(np.asarray(w, np.float32), np.asarray(b, np.float32))
                    for w, b in m["init"]] for name, m in t2["mlps"].items()}
    cache_dir = runner.CACHE_DIR
    tmp = tempfile.mkdtemp(prefix="paper_tables_")
    try:
        # n = 20,000, from a fresh cache: rows against the snapshot's
        runner.CACHE_DIR = os.path.join(tmp, "small")
        zero_counts()
        for fig in paper.ALL:
            extra = {"inits": inits} if fig is paper.table2_ptwcp else {}
            rows = [[r[0], r[2]] for r in fig(workloads=workloads, n=FULL_N,
                                               seed=0, device=dev, **extra)]
            want = figs[fig.__name__]
            if fig is paper.table2_ptwcp:
                # the MLP rows in numbers below; the rest as strings
                same = ([r[0] for r in rows] == [r[0] for r in want]
                        and rows[3:] == want[3:])
            else:
                same = rows == want
            if not same:
                raise AssertionError(f"{fig.__name__}: rows {rows} differ "
                                     f"from the reference's {want}")
        small_launches = mmu_step.LAUNCHES
        small_by = {k: v for k, v in
                    mmu_step.LAUNCHES_BY_COMPOSITION.items() if v}
        # every ladder member went through its ladder's instantiation: the
        # compositions only ladder members have are never launched
        of = {n: mmu_step.composition(systems.config(n), s.stages)[0]
              for n, s in systems.REGISTRY.items()}
        in_ladder = {m for ms in systems.LADDERS.values() for m in ms}
        ladder_only = ({of[m] for m in in_ladder}
                       - {c for n, c in of.items() if n not in in_ladder})
        if not set(LADDER_COMP.values()) <= set(small_by) or \
                ladder_only & set(small_by):
            raise AssertionError(f"the figures launched the compositions "
                                 f"{sorted(small_by)}: want both ladder "
                                 f"instantiations and none of "
                                 f"{sorted(ladder_only)}")
        print(f"{len(paper.ALL)} figures: every row equals the reference's "
              f"(Table 2's MLP rows below); {small_launches} launches, by "
              f"composition {small_by}")
        for name, want in snap3["systems"].items():
            out = runner.run_batch(name, workloads, n=FULL_N, seed=0,
                                   device=dev)  # from the cache
            snapshot_equal(name, out, want, FULL_N)
        print(f"the {len(snap3['systems'])} systems the paper snapshot "
              f"holds equal it on every Stats leaf and extra")
        out = runner.run_batch("radix_collect", workloads, n=FULL_N, seed=0,
                               device=dev)
        X, y = ptwcp_nn.build_dataset([out[w][1] for w in workloads])
        if (sha256_of(X), sha256_of(y), list(X.shape)) != \
                (t2["X_sha256"], t2["y_sha256"], t2["X_shape"]):
            raise AssertionError("Table 2's dataset differs from the "
                                 "reference's")
        box = ptwcp_nn.fit_box(X, y)
        if list(box) != t2["fit_box"]:
            raise AssertionError(f"fit_box {box} != {t2['fit_box']}")
        comps = [ptwcp_nn.comparator_result(X, y),
                 ptwcp_nn.comparator_result(
                     X, y, box, name=f"Comparator(refit {box})")]
        if [c.__dict__ for c in comps] != t2["comparators"]:
            raise AssertionError("Table 2's comparator rows differ")
        mlp_err = 0.0
        for name, idx, hidden in ptwcp_nn.MLPS:
            r = ptwcp_nn.train_mlp(X, y, idx, hidden, name=name, device=dev,
                                   init=inits[name])
            want = t2["mlps"][name]["result"]
            if r.params_bytes != want["params_bytes"]:
                raise AssertionError(f"{name}: {r.params_bytes} bytes")
            err = max(abs(getattr(r, k) - want[k]) for k in
                      ("accuracy", "precision", "recall", "f1"))
            mlp_err = max(mlp_err, err)
            if err > MLP_TOL:
                raise AssertionError(f"{name}: {r} differs from the "
                                     f"reference's {want} by {err}")
            print(f"Table 2 {name} from the reference's initial weights: "
                  f"acc {r.accuracy:.4f} prec {r.precision:.4f} rec "
                  f"{r.recall:.4f} F1 {r.f1:.4f} ({r.params_bytes} B), "
                  f"max |diff| {err:.2e} (tolerance {MLP_TOL})")
        print(f"Table 2 at n={FULL_N}: dataset {X.shape} and its labels "
              f"equal the reference's (sha256), fit_box {box}, both "
              f"comparator rows exact")

        # the whole table at n = 150,000, from a fresh cache
        runner.CACHE_DIR = os.path.join(tmp, "full")
        shutil.rmtree(os.path.join(tmp, "small"))
        zero_counts()
        walls = {}
        t0 = time.perf_counter()
        for fig in paper.ALL:
            t1 = time.perf_counter()
            rows = fig(workloads=workloads, n=TIMED_N, seed=0, device=dev)
            walls[fig.__name__] = time.perf_counter() - t1
            for name, us, derived in rows:
                print(f"  {name:42s} {derived}  ({us:.4f} us/access)")
            print(f"{fig.__name__}: {walls[fig.__name__]:.2f} s")
        paper_wall = time.perf_counter() - t0
        paper_launches = mmu_step.LAUNCHES
        if paper_launches == 0:
            raise AssertionError("the paper tables launched no kernel")
        print(f"the paper tables at n={TIMED_N} from a fresh cache: "
              f"{paper_wall:.2f} s in all, {paper_launches} launches, by "
              f"composition {dict(mmu_step.LAUNCHES_BY_COMPOSITION)}")
    finally:
        runner.CACHE_DIR = cache_dir
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 12: {time.perf_counter() - t:.1f} s")

    # ----------------------------------------------------------- 13
    t = phase("13. the serving engine on the card")
    zero_counts()
    serve_engine = serving_engine(dev, smi)
    print("serving engine: " + json.dumps(serve_engine))
    print(f"phase 13: {time.perf_counter() - t:.1f} s")

    # ----------------------------------------------------------- 14
    torch.cuda.empty_cache()
    t = phase(f"14. granite-moe-1b-a400m: 2 layers at full width against "
              f"the JAX snapshot, then full depth, {FD_B} requests x "
              f"{FD_PROMPT} prompt tokens, {FD_STEPS} decode steps")
    moe_snap = granite_moe_vs_snapshot(dev)
    torch.cuda.empty_cache()
    moe_serve = full_depth_serving(dev, "granite-moe-1b-a400m", smi)
    print(f"phase 14: {time.perf_counter() - t:.1f} s")

    # ----------------------------------------------------------- 15
    torch.cuda.empty_cache()
    t = phase(f"15. seamless-m4t-medium: 2 + 2 layers at full width against "
              f"the JAX snapshot, then full depth, {FD_B} x {FD_PROMPT} "
              f"source frames and target tokens, {FD_STEPS} decode steps")
    seamless_snap = seamless_vs_snapshot(dev)
    torch.cuda.empty_cache()
    seamless_serve = full_depth_serving(dev, "seamless-m4t-medium", smi)
    print(f"phase 15: {time.perf_counter() - t:.1f} s")

    # ----------------------------------------------------------- 16
    torch.cuda.empty_cache()
    t = phase("16. the dense options: qwen3-32b, mixtral-8x7b, qwen2-vl-7b "
              "(2 layers, full width) and mixtral's ring, kernel path "
              "against plain path")
    options = dense_options(dev, smi)
    print(f"phase 16: {time.perf_counter() - t:.1f} s")

    # ----------------------------------------------------------- 17
    torch.cuda.empty_cache()
    t = phase(f"17. recurrentgemma-2b: flash at hd {HYBRID_HD} against its "
              f"plain version, 3 layers at full width against the JAX "
              f"snapshot, then full depth, {FD_B} requests x {FD_PROMPT} "
              f"prompt tokens, {FD_STEPS} decode steps")
    hd256 = flash_hd256(dev, builds["flash_attention"]["log"], smi)
    torch.cuda.empty_cache()
    hybrid_snap = hybrid_vs_snapshot(dev, hybrid_inputs)
    torch.cuda.empty_cache()
    hybrid_serve = full_depth_serving(dev, "recurrentgemma-2b", smi,
                                      check=hybrid_kernel_vs_plain)
    hd256["launches_on_hybrid_path"] = (
        hybrid_serve["prefill_launches"]["flash_attention"])
    print(f"phase 17: {time.perf_counter() - t:.1f} s")

    # each registered system's static instantiation (composition/placement)
    # and, for a ladder member, the ladder instantiation the tables run
    ladder_of = {m: lad for lad, ms in systems.LADDERS.items() for m in ms}
    instantiation_by_system = {}
    for name, sys_ in systems.REGISTRY.items():
        cfg = sys_.config()
        got = [f"{mmu_step.composition(cfg, sys_.stages)[0]}/"
               f"{mmu_step.placement(cfg).name}"]
        if name in ladder_of:
            base = systems.ladder_base_config(ladder_of[name])
            names = default_stages(base)
            got.append(f"{mmu_step.composition(base, names, dyn=True)[0]}/"
                       f"{mmu_step.ladder_placement(base, names).name}")
        instantiation_by_system[name] = got
    shape = {"flash_attention": f"granite-3-2b prefill: B={SERVE_B}, "
                                f"S={SERVE_PROMPT}, H=32, K=8, hd=64, bf16, "
                                f"causal",
             "paged_attention": f"granite-3-2b decode: B={SERVE_B}, H=32, "
                                f"K=8, hd=64, bf16, page 128, nb 8, lens "
                                f"{SERVE_PROMPT + SERVE_STEPS}"}
    # each serving path's launches, its counts zeroed before it ran:
    # granite-3-2b (phase 8), granite-moe-1b-a400m (14) and
    # seamless-m4t-medium (15), a prefill and all decode steps each
    by_path = {"granite-3-2b": serve["launches"]}
    for model, r in (("granite-moe-1b-a400m", moe_serve),
                     ("seamless-m4t-medium", seamless_serve),
                     ("recurrentgemma-2b", hybrid_serve)):
        by_path[model] = {k: r["prefill_launches"][k]
                          + r["decode_launches"][k]
                          for k in r["prefill_launches"]}
    attn = [{"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{name}.cu",
             "replaces": f"src/repro/kernels/{name}.py:{line}",
             "launches": sum(p[name] for p in by_path.values()),
             "launches_by_path": {m: p[name] for m, p in by_path.items()},
             "max_abs_err": attn_errs[name],
             "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r["library_ms"], "unit": shape[name],
             "matches_plain": True,
             **({"hd256": hd256} if name == "flash_attention" else {}),
             **{x: r[x] for x in ("tflops", "plan", "rotated_ms",
                                  "cluster_ms", "cluster_rotated_ms",
                                  "two_pass_ms", "two_pass_rotated_ms",
                                  "long_context") if x in r}}
            for name, line, r in (("flash_attention", 85, serve["flash"]),
                                  ("paged_attention", 73, serve["paged"]))]
    print("models: " + json.dumps({
        "granite-moe-1b-a400m": {"snapshot": moe_snap, "serving": moe_serve},
        "seamless-m4t-medium": {"snapshot": seamless_snap,
                                "serving": seamless_serve},
        "recurrentgemma-2b": {"flash_hd256": hd256,
                              "snapshot": hybrid_snap,
                              "serving": hybrid_serve},
        "dense_options": options}))
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "mmu_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mmu_step.cu",
        "replaces": "src/repro/kernels/mmu_step.py:105",
        "launches": main_launches["victima"],
        "launches_by_system": main_launches,
        "launches_by_placement": by_placement["victima"],
        "compositions": list(mmu_step.LAUNCHES_BY_COMPOSITION),
        "instantiations": len(built),
        "ladder_fill": ladder_fill,
        "time_shard": serve_engine["time_shard"],
        "paper_tables": {"n": TIMED_N, "wall_s": paper_wall,
                         "wall_s_by_figure": walls,
                         "launches": paper_launches,
                         "rows_equal_reference_at_n": FULL_N,
                         "table2_mlp_max_abs_diff": mlp_err},
        "composition_by_system": composition,
        "instantiation_by_system": instantiation_by_system,
        "ptxas_by_instantiation": inst_ptxas,
        "main_path_wall_s": main_wall, "main_path_floor_ms": main_floor,
        "placement": pl.name, "smem_bytes": pl.smem_bytes,
        "main_path_ms": main_ms, "stage_cycles_per_access": breakdown,
        "max_abs_err": max(worst, unit_err),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None,
        "latency_floor_ms": chain_ms, "load_rounds_per_access": rounds,
        "latency_floor_device_ms": dev_chain_ms,
        "shared_ns": sm_ns, "l1_hit_ns": l1_ns, "l2_hit_ns": l2_ns,
        "unit": f"victima, Table-3 defaults, first {UNIT_N} accesses x "
                f"{W} lanes",
        "matches_plain": True, "matches_reference": True}] + attn + [{
        "name": "ssd_intra", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:49",
        "launches": mamba["launches"],
        "launches_by_kernel": mamba["launches_by_kernel"],
        "max_abs_err": ssd_err,
        **mamba["ssd"], "unit": mamba["unit"], "matches_plain": True}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The least time of the scan kernel's work, from the simulated
statistics and the shapes alone, at frozen constants: whatever
implements the scan, the same job reads the same floor.

The floor of a job is the larger of two terms:

- bytes: each workload's trace read once (``vpn`` int32, ``is2m`` byte,
  ``line`` int32, ``ipa`` float32), each lane's state read and written
  once at its own system's geometry, and its statistics written once,
  over the H100's 3.35 TB/s;
- dependent rounds: an access is a chain of row reads whose tag compare
  decides the next, so each lane is a chain of rounds.  The rounds are
  counted from the lane's statistics as the dependent-round model of the
  scan counts them (the first round of every access; per walk level,
  background walk and host-walk level an L2-cache row; an L3 row for
  the data line's background traffic and each L2 miss; a nested-TLB row
  per nested translation; a page-walk-cache row per background walk),
  and every round is charged one frozen latency, the H100's
  shared-memory dependent load, 14.5 ns, whatever level the program
  keeps the row in.  Rounds the statistics do not count (an L3 row for
  a walk level that missed the L2, inserts, retags) are left out, so
  this is a floor.  Lanes run side by side: the slowest lane of the job
  sets the term.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
ROUND_S = 14.5e-9           # shared-memory dependent load on the H100
TRACE_BYTES_PER_ACCESS = 4 + 1 + 4 + 4
LRU_WAY_BYTES = 4 + 1 + 4   # tag, valid, stamp
L2_WAY_BYTES = 4 + 1 + 4 + 4 + 4  # tag, valid, RRPV, block type, reuse
PWC_WAYS_ALL = 3 * 8 * 4    # three page-walk caches of 8 x 4
REUSE_BUCKETS, HIST_BUCKETS = 22, 64


def state_bytes(cfg: dict) -> int:
    """Bytes of one lane's state at system `cfg`'s geometry, without its
    statistics."""
    ways = (cfg["l1d4_sets"] * cfg["l1d4_ways"] + cfg["l1d2_sets"]
            * cfg["l1d2_ways"] + cfg["l2tlb_sets"] * cfg["l2tlb_ways"]
            + PWC_WAYS_ALL + cfg["l1_sets"] * cfg["l1_ways"]
            + cfg["l3_sets"] * cfg["l3_ways"])
    if cfg["virt"]:
        ways += cfg["ntlb_sets"] * cfg["ntlb_ways"]
    if cfg["l3tlb_sets"]:
        ways += cfg["l3tlb_sets"] * cfg["l3tlb_ways"]
    if cfg["pom"]:
        ways += cfg["pom_sets"] * cfg["pom_ways"]
    counters = cfg["n_pages4"] + cfg["n_pages2"] + (cfg["n_pagesh"]
                                                    if cfg["virt"] else 0)
    l2 = (cfg["l2_sets"] * cfg["l2_ways"] * L2_WAY_BYTES
          + 2 * REUSE_BUCKETS * 4 + 3 * 4)
    return LRU_WAY_BYTES * ways + l2 + 2 * counters + 4 + 6 * 4


def stats_bytes(stats: dict) -> int:
    return sum(int(v.size) * v.dtype.itemsize for v in stats.values())


def lane_rounds(cfg: dict, stats: dict, extras: dict) -> int:
    """Dependent rounds of one lane, from its statistics."""
    g = {k: int(v) for k, v in stats.items() if v.ndim == 0}
    acc, bgw, host = g["n_access"], g["n_bg_ptw"], g["n_host_ptw"]
    nested = g["n_ntlb_hit"] + g["n_nvictima_hit"] + host
    pte = g["n_demand_ptw"] + bgw + 4 * host
    if cfg["pom"]:
        pte += g["n_l2tlb_miss"] - g["n_victima_hit"]
    if cfg["utopia"]:
        pte += g["n_restseg_hit"] + g["n_restseg_miss"]
    if cfg["revelator"]:
        pte += g["n_rev_hit"] + g["n_rev_mispred"]
    l2_rounds = pte + int(extras["l2_access"])
    if cfg["victima"]:
        l2_rounds += bgw + host + g["n_nvictima_hit"]
    l3_rounds = acc + int(extras["l2_miss"])
    return acc + (bgw + nested) + l2_rounds + l3_rounds


def job_floor(system_cfgs: dict, workloads, n: int, results: dict) -> dict:
    """The floor of one job: ``{"floor_s", "rounds_s", "bytes_s",
    "bound"}``, from its lanes' results ``{(system, workload): (stats,
    extras)}`` and each system's configuration (``system_cfgs``)."""
    rounds = max(lane_rounds(system_cfgs[s], st, ex)
                 for (s, _w), (st, ex) in results.items())
    nbytes = (len(set(workloads)) * n * TRACE_BYTES_PER_ACCESS
              + sum(2 * state_bytes(system_cfgs[s]) + stats_bytes(st)
                    for (s, _w), (st, _ex) in results.items()))
    rounds_s = rounds * ROUND_S
    bytes_s = nbytes / HBM_BYTES_PER_S
    return {"floor_s": max(rounds_s, bytes_s), "rounds_s": rounds_s,
            "bytes_s": bytes_s,
            "bound": "rounds" if rounds_s >= bytes_s else "bytes"}

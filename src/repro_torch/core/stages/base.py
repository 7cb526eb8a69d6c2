"""Translation-pipeline contract + shared simulation types (port of
``repro.core.stages.base``).

A *stage* models one level of the address-translation path.  Stages obey
the reference's contract, so ``mmu.make_step`` folds a composition into
one per-access step:

  ``lookup(cfg, state, request, need) -> (state, StageResult)``
  ``fill(cfg, state, request, out) -> state``

Differences from the reference, all forced by torch:

- every state leaf carries a leading lane axis ``[W, ...]`` (the
  reference's ``vmap`` written out), and the stages update the state
  tensors IN PLACE (they still return the state, to keep the contract);
- ``SimConfig`` keeps every reference field, so configs carry over one
  for one, but rejects on construction any value this port cannot
  simulate yet, naming the field;
- the ``Dyn`` ladder views are not ported yet, so ``Request`` has no
  ``dyn`` field and every geometry is static.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import ptwcp
from repro_torch.core.assoc import Assoc, make
from repro_torch.core.caches import Hier, Lat, make_hier
from repro_torch.core.page_table import PWCs, make_pwcs

WALK_HIST_BUCKETS = 64  # 10-cycle buckets for the Fig.4 PTW latency CDF

# SimConfig values this slice simulates; anything else names the ROADMAP
# queue item that ports it
_STAGES = "Queue 1, the stages the paper's figures need"
_SUPPORTED = {
    "l3tlb_sets": (0, _STAGES + " (l3_tlb)"),
    "pom": (False, _STAGES + " (pom)"),
    "utopia": (False, "Queue 1, Utopia and Revelator"),
    "revelator": (False, "Queue 1, Utopia and Revelator"),
    "virt": (False, _STAGES + " (nested)"),
    "n_cores": (1, "Queue 1, Multicore"),
    "shared_tier_stats": (False, "Queue 1, Multicore"),
    "dram_cache_sets": (0, "Queue 1, Multicore (the DRAM-cache gate)"),
    "collect": (False, _STAGES + " (collect_feats)"),
}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration (Table 3 defaults)."""

    # --- TLB hierarchy
    l1d4_sets: int = 16   # 64-entry, 4-way (4K pages)
    l1d4_ways: int = 4
    l1d2_sets: int = 8    # 32-entry, 4-way (2M pages)
    l1d2_ways: int = 4
    l1tlb_lat: int = 1
    l2tlb_sets: int = 128  # 1536-entry, 12-way
    l2tlb_ways: int = 12
    l2tlb_lat: int = 12
    # --- optional hardware L3 TLB (0 sets = absent)
    l3tlb_sets: int = 0
    l3tlb_ways: int = 16
    l3tlb_lat: int = 15
    # --- POM-TLB (software L3 TLB resident in memory)
    pom: bool = False
    pom_sets: int = 4096
    pom_ways: int = 16
    # --- Victima
    victima: bool = False
    tlb_aware: bool = True       # TLB-aware SRRIP at the L2 cache
    use_ptwcp: bool = True       # False = insert every candidate (ablation)
    bypass_l2mpki: float = 5.0   # consult PTW-CP only if L2$ MPKI below this
    pressure_mpki: float = 5.0   # "translation pressure" threshold
    # --- Utopia hybrid RestSeg/FlexSeg mapping
    utopia: bool = False
    restseg4_sets: int = 8192
    restseg2_sets: int = 256
    restseg_ways: int = 16
    # --- Revelator hash-based speculative translation
    revelator: bool = False
    rev_sets: int = 4096
    rev_ways: int = 16
    rev_lat: int = 4
    rev_sig_bits: int = 20
    # --- caches
    l1_sets: int = 64
    l1_ways: int = 8
    l2_sets: int = 2048   # 2MB
    l2_ways: int = 16
    l3_sets: int = 2048   # 2MB/core
    l3_ways: int = 16
    lat: Lat = Lat()
    # --- multicore
    n_cores: int = 1
    shared_port_cyc: int = 2
    shared_tier_stats: bool = False
    # --- die-stacked DRAM cache below the L3 (0 sets = absent)
    dram_cache_sets: int = 0
    dram_cache_ways: int = 16
    # --- virtualization
    virt: bool = False
    ideal_shadow: bool = False
    ntlb_sets: int = 16
    ntlb_ways: int = 4
    # --- bookkeeping
    n_pages4: int = 1 << 21      # 4K-page counter-table entries (masked vpn)
    n_pages2: int = 1 << 14      # 2M-page counter-table entries
    n_pagesh: int = 1 << 14      # host-page counter table (virt)
    ipa: float = 3.0             # instructions per traced memory access
    collect: bool = False        # per-page feature collection (Table 2)
    n_feat: int = 1 << 20        # feature-table entries (hashed vpn)

    def __post_init__(self):
        for field, (want, item) in _SUPPORTED.items():
            got = getattr(self, field)
            if got != want:
                raise ValueError(
                    f"SimConfig.{field}={got!r}: this port simulates only "
                    f"{field}={want!r} so far; ROADMAP.md {item} ports it")


class Stats(NamedTuple):
    n_access: torch.Tensor
    n_l1tlb_hit: torch.Tensor
    n_l2tlb_hit: torch.Tensor
    n_l2tlb_miss: torch.Tensor
    n_victima_hit: torch.Tensor
    n_l3tlb_hit: torch.Tensor
    n_pom_hit: torch.Tensor
    n_demand_ptw: torch.Tensor      # native demand walks
    n_bg_ptw: torch.Tensor
    n_host_ptw: torch.Tensor        # virt: demand host walks
    n_ntlb_hit: torch.Tensor
    n_nvictima_hit: torch.Tensor
    sum_trans_cyc: torch.Tensor     # f32
    sum_l2miss_cyc: torch.Tensor    # f32 — translation cycles past the L2 TLB
    sum_data_cyc: torch.Tensor      # f32
    sum_walk_cyc: torch.Tensor      # f32 — demand walk cycles only
    hist_walk: torch.Tensor         # i32 [WALK_HIST_BUCKETS]
    sum_tlb4_live: torch.Tensor     # f32 — Σ live TLB blocks (reach, Fig 23)
    sum_tlb2_live: torch.Tensor     # f32
    n_restseg_hit: torch.Tensor
    n_restseg_miss: torch.Tensor
    n_restseg_mig: torch.Tensor
    n_restseg_conflict: torch.Tensor
    sum_restseg_cyc: torch.Tensor   # f32
    hist_restseg: torch.Tensor      # i32 [WALK_HIST_BUCKETS]
    n_rev_hit: torch.Tensor
    n_rev_mispred: torch.Tensor
    n_rev_enroll: torch.Tensor
    sum_rev_verify_cyc: torch.Tensor  # f32
    hist_rev_verify: torch.Tensor   # i32 [WALK_HIST_BUCKETS]


def zero_stats(lanes: int = 1, device="cpu") -> Stats:
    def z(dtype, *shape):
        return torch.zeros((lanes,) + shape, dtype=dtype, device=device)

    return Stats(*[
        z(torch.float32) if f.startswith("sum_")
        else z(torch.int32, WALK_HIST_BUCKETS) if f.startswith("hist_")
        else z(torch.int32)
        for f in Stats._fields])


class Feats(NamedTuple):
    """Per-page features for the Table-2 predictor study (sized 1: off)."""
    n_access: torch.Tensor     # uint16
    n_l1_miss: torch.Tensor    # uint16
    n_l2_miss: torch.Tensor    # uint16
    n_walk: torch.Tensor       # uint16
    walk_cyc: torch.Tensor     # float32
    is2m: torch.Tensor         # uint8


def zero_feats(n: int, lanes: int = 1, device="cpu") -> Feats:
    def z(dtype):
        return torch.zeros((lanes, n), dtype=dtype, device=device)

    return Feats(n_access=z(torch.uint16), n_l1_miss=z(torch.uint16),
                 n_l2_miss=z(torch.uint16), n_walk=z(torch.uint16),
                 walk_cyc=z(torch.float32), is2m=z(torch.uint8))


class RevTable(NamedTuple):
    """Revelator signature table (sized 1: off in this slice)."""

    tab: Assoc
    vpn: torch.Tensor   # int32 [W, S, ways]


class MMUState(NamedTuple):
    now: torch.Tensor   # int32 [W]
    l1d4: Assoc
    l1d2: Assoc
    l2tlb: Assoc
    l3tlb: Assoc        # sized 1 (no L3 TLB in this slice)
    pom: Assoc          # sized 1
    pwcs: PWCs
    hier: Hier
    ntlb: Assoc         # sized 1
    restseg4: Assoc     # sized 1
    restseg2: Assoc     # sized 1
    rev: RevTable       # sized 1
    pc4: ptwcp.PageCounters
    pc2: ptwcp.PageCounters
    pch: ptwcp.PageCounters  # sized 1
    feats: Feats        # sized 1
    stats: Stats


def make_state(cfg: SimConfig, lanes: int = 1, device="cpu") -> MMUState:
    """Zero state for `lanes` independent lanes, with the reference's
    shapes (placeholders of absent structures sized 1, as there)."""
    def mk(sets, ways):
        return make(sets, ways, lanes, device)

    return MMUState(
        now=torch.zeros((lanes,), dtype=torch.int32, device=device),
        l1d4=mk(cfg.l1d4_sets, cfg.l1d4_ways),
        l1d2=mk(cfg.l1d2_sets, cfg.l1d2_ways),
        l2tlb=mk(cfg.l2tlb_sets, cfg.l2tlb_ways),
        l3tlb=mk(1, cfg.l3tlb_ways),
        pom=mk(1, cfg.pom_ways),
        pwcs=make_pwcs(lanes=lanes, device=device),
        hier=make_hier(cfg.l1_sets, cfg.l1_ways, cfg.l2_sets, cfg.l2_ways,
                       cfg.l3_sets, cfg.l3_ways, 1, cfg.dram_cache_ways,
                       lanes=lanes, device=device),
        ntlb=mk(1, cfg.ntlb_ways),
        restseg4=mk(1, 1),
        restseg2=mk(1, 1),
        rev=RevTable(tab=mk(1, 1),
                     vpn=torch.zeros((lanes, 1, 1), dtype=torch.int32,
                                     device=device)),
        pc4=ptwcp.make_counters(cfg.n_pages4, lanes, device),
        pc2=ptwcp.make_counters(cfg.n_pages2, lanes, device),
        pch=ptwcp.make_counters(1, lanes, device),
        feats=zero_feats(1, lanes, device),
        stats=zero_stats(lanes, device),
    )


def state_leaves(st: MMUState) -> list[torch.Tensor]:
    """The state's tensors in the reference's ``jax.tree.leaves`` order
    (NamedTuple fields depth-first)."""
    out = []

    def rec(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        else:
            for y in x:
                rec(y)

    rec(st)
    return out


def _unflatten(template, leaves):
    it = iter(leaves)

    def rec(x):
        if isinstance(x, torch.Tensor):
            return next(it)
        return type(x)(*[rec(y) for y in x])

    return rec(template)


def state_from_numpy(leaves, cfg: SimConfig, device="cpu") -> MMUState:
    """The port's state from the reference ``MMUState`` given as numpy
    leaves in ``jax.tree.leaves`` order.

    Leaves without a lane axis (``now`` is a scalar) describe one lane;
    leaves of a vmapped state (``now`` is ``[W]``) keep their W lanes.
    Shapes and dtypes must match ``make_state(cfg)``; a mismatch raises.
    """
    leaves = [np.asarray(x) for x in leaves]
    if leaves and leaves[0].ndim == 0:
        leaves = [x[None] for x in leaves]
    lanes = leaves[0].shape[0]
    template = make_state(cfg, lanes, "meta")
    want = state_leaves(template)
    if len(leaves) != len(want):
        raise ValueError(f"expected {len(want)} state leaves, got "
                         f"{len(leaves)}")
    out = []
    for i, (x, w) in enumerate(zip(leaves, want)):
        t = torch.from_numpy(np.array(x, copy=True))
        if t.shape != w.shape or t.dtype != w.dtype:
            raise ValueError(f"state leaf {i}: got {t.dtype} "
                             f"{tuple(t.shape)}, want {w.dtype} "
                             f"{tuple(w.shape)}")
        out.append(t.to(device))
    return _unflatten(template, out)


def state_to_numpy(st: MMUState) -> list[np.ndarray]:
    """The state as numpy leaves in ``jax.tree.leaves`` order, each with
    its leading lane axis."""
    return [x.cpu().numpy() for x in state_leaves(st)]


class Request(NamedTuple):
    """One traced access per lane plus derived keys and step signals."""

    vpn: torch.Tensor       # int32 [W] 4K-page vpn
    is2m: torch.Tensor      # bool — access lands in a 2M-backed region
    line: torch.Tensor      # int32 data line id
    ipa: torch.Tensor       # f32 instructions per access
    vpn2: torch.Tensor      # vpn >> 9 (2M-page id)
    vpn_sz: torch.Tensor    # size-native page id
    key2: torch.Tensor      # unified L2 TLB key (page id + size bit)
    now: torch.Tensor       # logical time (LRU stamp)
    pressure: torch.Tensor  # bool — translation pressure (L2-TLB MPKI > thr)
    l2_bypass: torch.Tensor  # bool — L2$ MPKI high: bypass the PTW-CP


class StageResult(NamedTuple):
    hit: torch.Tensor         # bool [W] — accesses resolved by this stage
    cycles: torch.Tensor      # int32 [W] — latency charged by this stage
    info: dict                # stage-specific values for fills/stats
    need: Any = None          # bool [W] — still unresolved AFTER this stage


class Stage:
    """Base stage: a no-op level.  Subclasses override lookup/fill."""

    name: str = "?"
    past_l2: bool = True  # cycles count toward the past-L2-TLB metric

    def lookup(self, cfg: SimConfig, st: MMUState, req: Request, need):
        z = torch.zeros_like(need)
        return st, StageResult(hit=z, cycles=z.int(), info={})

    def fill(self, cfg: SimConfig, st: MMUState, req: Request,
             out: dict) -> MMUState:
        return st

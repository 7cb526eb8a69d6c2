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
- ``Dyn``'s leaves are ``[W]`` tensors on the state's device, one value
  a lane, where the reference vmaps scalars;
- the Table-2 feature counters keep the reference's uint16, but CPU
  torch neither adds nor puts into uint16, so ``collect_feats`` works on
  int16 views of them: int16 addition wraps modulo 2^16 as the
  reference's uint16 ``.at[].add`` does, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import ptwcp
from repro_torch.core.assoc import Assoc, make
from repro_torch.core.caches import Hier, L2Geom, Lat, make_hier
from repro_torch.core.page_table import PWCs, make_pwcs

WALK_HIST_BUCKETS = 64  # 10-cycle buckets for the Fig.4 PTW latency CDF

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
    # --- multicore: core lanes over a shared tier (the L3, POM-TLB and
    #     DRAM cache partitioned by the systems' sizes) and a rotating
    #     shared-port delay on L2-TLB misses; 1 core compiles it out
    n_cores: int = 1
    shared_port_cyc: int = 2     # cycles per losing arbitration slot
    shared_tier_stats: bool = False  # the shared-tier counters in extras
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


class Dyn(NamedTuple):
    """Per-lane sizing, latency and stage-gate overrides for
    ladder-batched simulation, each a ``[W]`` tensor.

    A batched ladder allocates its structures at the ladder's maximum
    shape (``sim.systems.dyn_base_config``); systems whose configs
    differ only in ``DYN_FIELDS`` then run as lanes of one step.  A lane
    whose gate is off masks every state write of that stage, bit-exactly
    reproducing the composition without it.
    """

    l2tlb_set_mask: torch.Tensor  # int32, = live L2-TLB sets - 1
    l2tlb_ways: torch.Tensor      # int32 effective ways
    l2tlb_lat: torch.Tensor       # int32 probe latency
    l3tlb_lat: torch.Tensor       # int32 probe latency (unused if no L3 TLB)
    l2_set_mask: torch.Tensor     # int32, = live L2-cache sets - 1
    l2_ways: torch.Tensor         # int32 effective L2-cache ways
    victima_en: torch.Tensor      # bool: the Victima stage is live
    utopia_en: torch.Tensor       # bool: the RestSeg stage is live
    restseg_ways: torch.Tensor    # int32 effective RestSeg ways
    l3tlb_en: torch.Tensor        # bool: the hardware L3 TLB is live
    pom_en: torch.Tensor          # bool: the POM-TLB is live
    rev_en: torch.Tensor          # bool: Revelator's stage is live
    dramc_en: torch.Tensor        # bool: the DRAM cache is live

    def to(self, device) -> "Dyn":
        return Dyn(*[x.to(device) for x in self])


# SimConfig fields a batched ladder may vary across members (the
# reference's list).  "victima", "utopia", "pom", "l3tlb_sets" and
# "revelator" are stage flags that a lane gates
# (sim.systems.DYN_GATED_STAGES), not geometry.
DYN_FIELDS = ("l2tlb_sets", "l2tlb_ways", "l2tlb_lat", "l3tlb_lat",
              "l2_sets", "l2_ways", "victima",
              "utopia", "restseg_ways", "l3tlb_sets", "pom", "revelator",
              "dram_cache_sets")


def dyn_of(cfg: "SimConfig") -> Dyn:
    """The Dyn equivalent to `cfg`'s static sizing: one lane, on the CPU
    (``stack_dyns`` joins lanes, ``Dyn.to`` moves them)."""
    vals = (cfg.l2tlb_sets - 1, cfg.l2tlb_ways, cfg.l2tlb_lat,
            cfg.l3tlb_lat, cfg.l2_sets - 1, cfg.l2_ways, cfg.victima,
            cfg.utopia, cfg.restseg_ways, cfg.l3tlb_sets > 0, cfg.pom,
            cfg.revelator, cfg.dram_cache_sets > 0)
    return Dyn(*[torch.full((1,), v, dtype=torch.bool if isinstance(v, bool)
                            else torch.int32) for v in vals])


def stack_dyns(dyns) -> Dyn:
    """One Dyn whose lanes are those of `dyns`, in order."""
    return Dyn(*[torch.cat(xs) for xs in zip(*dyns)])


def l2_geom_of(dyn: Dyn | None) -> L2Geom | None:
    """The per-lane L2-cache view a request carries (None = static)."""
    if dyn is None:
        return None
    return L2Geom(set_mask=dyn.l2_set_mask, n_ways=dyn.l2_ways)


def dramc_of(cfg: "SimConfig", dyn: Dyn | None = None):
    """The die-stacked DRAM-cache gate of the cache accesses: None (the
    probe left out) when the configuration has no DRAM cache, else True,
    or in a ladder each lane's ``dramc_en`` (a lane without it masks the
    probe off bit-exactly)."""
    if cfg.dram_cache_sets <= 0:
        return None
    return True if dyn is None else dyn.dramc_en


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
    """Per-page features for the Table-2 predictor study (hashed table,
    sized 1 when ``collect`` is off)."""
    n_access: torch.Tensor     # uint16 [W, n_feat]
    n_l1_miss: torch.Tensor    # uint16
    n_l2_miss: torch.Tensor    # uint16 — L2 TLB misses
    n_walk: torch.Tensor       # uint16 — walk count
    walk_cyc: torch.Tensor     # float32 — Σ demand-walk cycles
    is2m: torch.Tensor         # uint8


def zero_feats(n: int, lanes: int = 1, device="cpu") -> Feats:
    def z(dtype):
        return torch.zeros((lanes, n), dtype=dtype, device=device)

    return Feats(n_access=z(torch.uint16), n_l1_miss=z(torch.uint16),
                 n_l2_miss=z(torch.uint16), n_walk=z(torch.uint16),
                 walk_cyc=z(torch.float32), is2m=z(torch.uint8))


class RevTable(NamedTuple):
    """Revelator signature table: hashed VPN -> speculative frame (sized
    1 when ``revelator`` is off).

    ``tab`` is keyed by a lossy signature of the size-tagged page id;
    ``vpn`` shadows the enrolled page id per way, the ground truth the
    verification walk confirms against.
    """

    tab: Assoc          # tags = lossy signature, meta = LRU stamp
    vpn: torch.Tensor   # int32 [W, S, ways] — enrolled key2 per way


class MMUState(NamedTuple):
    now: torch.Tensor   # int32 [W]
    l1d4: Assoc
    l1d2: Assoc
    l2tlb: Assoc
    l3tlb: Assoc        # sized 1 when absent
    pom: Assoc          # sized 1 when absent
    pwcs: PWCs
    hier: Hier
    ntlb: Assoc         # nested TLB (virt; sized 1 otherwise)
    restseg4: Assoc     # Utopia 4K-page RestSeg (sized 1 when off)
    restseg2: Assoc     # Utopia 2M-page RestSeg (sized 1 when off)
    rev: RevTable       # Revelator signature table (sized 1 when off)
    pc4: ptwcp.PageCounters
    pc2: ptwcp.PageCounters
    pch: ptwcp.PageCounters  # host-page counters (virt; sized 1 otherwise)
    feats: Feats        # Table-2 features (sized 1 when collect is off)
    stats: Stats


def make_state(cfg: SimConfig, lanes: int = 1, device="cpu") -> MMUState:
    """Zero state for `lanes` independent lanes, with the reference's
    shapes (placeholders of absent structures sized 1, as there)."""
    def mk(sets, ways):
        return make(sets, ways, lanes, device)

    rs_ways = cfg.restseg_ways if cfg.utopia else 1
    rev_sets = cfg.rev_sets if cfg.revelator else 1
    rev_ways = cfg.rev_ways if cfg.revelator else 1

    return MMUState(
        now=torch.zeros((lanes,), dtype=torch.int32, device=device),
        l1d4=mk(cfg.l1d4_sets, cfg.l1d4_ways),
        l1d2=mk(cfg.l1d2_sets, cfg.l1d2_ways),
        l2tlb=mk(cfg.l2tlb_sets, cfg.l2tlb_ways),
        l3tlb=mk(max(cfg.l3tlb_sets, 1), cfg.l3tlb_ways),
        pom=mk(cfg.pom_sets if cfg.pom else 1, cfg.pom_ways),
        pwcs=make_pwcs(lanes=lanes, device=device),
        hier=make_hier(cfg.l1_sets, cfg.l1_ways, cfg.l2_sets, cfg.l2_ways,
                       cfg.l3_sets, cfg.l3_ways,
                       max(cfg.dram_cache_sets, 1), cfg.dram_cache_ways,
                       lanes=lanes, device=device),
        ntlb=mk(cfg.ntlb_sets if cfg.virt else 1, cfg.ntlb_ways),
        restseg4=mk(cfg.restseg4_sets if cfg.utopia else 1, rs_ways),
        restseg2=mk(cfg.restseg2_sets if cfg.utopia else 1, rs_ways),
        rev=RevTable(tab=mk(rev_sets, rev_ways),
                     vpn=torch.zeros((lanes, rev_sets, rev_ways),
                                     dtype=torch.int32, device=device)),
        pc4=ptwcp.make_counters(cfg.n_pages4, lanes, device),
        pc2=ptwcp.make_counters(cfg.n_pages2, lanes, device),
        pch=ptwcp.make_counters(cfg.n_pagesh if cfg.virt else 1, lanes,
                                device),
        feats=zero_feats(cfg.n_feat if cfg.collect else 1, lanes, device),
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
    dyn: Dyn | None = None  # ladder-batched overrides (None = static)


class StageResult(NamedTuple):
    hit: torch.Tensor         # bool [W] — accesses resolved by this stage
    cycles: torch.Tensor      # int32 [W] — latency charged by this stage
    info: dict                # stage-specific values for fills/stats
    need: Any = None          # bool [W] — still unresolved AFTER this stage


def ptwcp_walk_verdict(cfg: SimConfig, st: MMUState, req: Request,
                       walk_en):
    """Post-walk PTW-CP verdict shared by fill-time promotion engines
    (Utopia's RestSeg migration, Revelator's enrollment).

    Reads the freshly trained counters (callers run after whichever fill
    owns the counter traffic, see ``stages.fill_order``) and applies the
    standard overrides: ``use_ptwcp=False`` promotes every candidate,
    high L2$ MPKI (``req.l2_bypass``) bypasses the predictor.
    """
    if not cfg.use_ptwcp:
        return walk_en
    idx4 = req.vpn & (cfg.n_pages4 - 1)
    idx2 = req.vpn2 & (cfg.n_pages2 - 1)
    pred = torch.where(req.is2m, ptwcp.predict_page(st.pc2, idx2),
                       ptwcp.predict_page(st.pc4, idx4))
    return walk_en & (pred | req.l2_bypass)


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


def hash_h(x: torch.Tensor, n: int) -> torch.Tensor:
    """Fibonacci-ish hash for the host-page counter table.  The int32
    product wraps around, as in the reference (torch's int32 ``*`` does
    on the CPU and on CUDA)."""
    return (x * -1640531535) & (n - 1)

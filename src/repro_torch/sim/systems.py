"""Registry of evaluated systems (paper Table 3 + ablations); port of
``repro.sim.systems`` restricted to the systems this port simulates: the
single-core systems built from the radix, Victima, L3-TLB and POM-TLB
compositions, natively and under nested paging, Table 2's feature
collection, and Utopia and Revelator natively.

Each ``System`` names its stage composition plus the SimConfig overrides
that size it; its entry matches the reference's one for one.  A name the
reference registers but this port does not simulate yet raises and names
the ROADMAP.md queue item that will port it.

Ladders are discovered as in the reference (``discover_ladders``):
systems whose configs differ only in ``DYN_FIELDS`` (L2-TLB geometry and
latency, L3-TLB latency, L2-cache geometry, RestSeg ways and the gated
rev/victima/restseg/l3_tlb/pom stage flags) run as lanes of one
batched step (``mmu.simulate_systems``), the whole family in one kernel
launch per trace block.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.stages import (DYN_FIELDS, Dyn, SimConfig,
                                     default_stages, dyn_of, stack_dyns)

_RADIX = ("l1_tlb", "l2_tlb", "ptw")
_VICTIMA = ("l1_tlb", "l2_tlb", "victima", "ptw")
_L3 = ("l1_tlb", "l2_tlb", "l3_tlb", "ptw")
_POM = ("l1_tlb", "l2_tlb", "pom", "ptw")
_UTOPIA = ("l1_tlb", "l2_tlb", "restseg", "ptw")
_UTOPIA_VICTIMA = ("l1_tlb", "l2_tlb", "victima", "restseg", "ptw")
_REV = ("l1_tlb", "l2_tlb", "rev", "ptw")
_REV_VICTIMA = ("l1_tlb", "l2_tlb", "rev", "victima", "ptw")
_NP = ("l1_tlb", "l2_tlb", "ptw2d")
_VICTIMA_NP = ("l1_tlb", "l2_tlb", "victima", "ptw2d")
_POM_NP = ("l1_tlb", "l2_tlb", "pom", "ptw2d")


@dataclasses.dataclass(frozen=True)
class System:
    """One evaluated system: stage composition + config overrides."""

    name: str
    stages: tuple[str, ...]
    overrides: dict
    desc: str = ""
    tags: tuple[str, ...] = ()

    def config(self, base: SimConfig | None = None) -> SimConfig:
        return dataclasses.replace(base or SimConfig(), **self.overrides)


REGISTRY: dict[str, System] = {}

# reference systems not simulated here yet -> the ROADMAP.md item that
# ports them
_LATER_UR_VIRT = "Queue 1, Utopia and Revelator under nested paging"
_LATER_MULTICORE = "Queue 1, Multicore"
LATER: dict[str, str] = {
    "utopia_virt": _LATER_UR_VIRT, "revelator_virt": _LATER_UR_VIRT,
    **{f"{k}_{c}c": _LATER_MULTICORE
       for k in ("radix", "victima", "pom", "victima_dramc")
       for c in (1, 2, 4)},
}


def register(name: str, stages: tuple[str, ...], desc: str = "",
             tags: tuple[str, ...] = (), **overrides) -> System:
    if name in REGISTRY:
        raise ValueError(f"duplicate system {name!r}")
    sys_ = System(name=name, stages=stages, overrides=overrides,
                  desc=desc, tags=tags)
    got = default_stages(sys_.config())
    if stages != got:
        raise ValueError(
            f"system {name!r} declares stages {stages} but its config "
            f"implies {got}")
    REGISTRY[name] = sys_
    return sys_


def get(name: str) -> System:
    try:
        return REGISTRY[name]
    except KeyError:
        if name in LATER:
            raise NotImplementedError(
                f"system {name!r} is not simulated by this port yet; "
                f"ROADMAP.md {LATER[name]} ports it") from None
        raise KeyError(f"unknown system {name!r}; registered: "
                       f"{', '.join(sorted(REGISTRY))}") from None


def config(name: str) -> SimConfig:
    return get(name).config()


def names(tag: str | None = None) -> list[str]:
    return [n for n, s in REGISTRY.items() if tag is None or tag in s.tags]


# --------------------------------------------------------------- native
register("radix", _RADIX, "baseline 2-level TLB + 4-level radix PTW",
         tags=("native", "l2tlb_ladder"))
register("victima", _VICTIMA, "TLB blocks in L2$ + PTW-CP + TLB-aware SRRIP",
         tags=("native", "headline"), victima=True)
register("victima_agnostic", _VICTIMA, "Victima with TLB-agnostic SRRIP "
         "(Fig. 26 ablation)", tags=("native", "ablation"),
         victima=True, tlb_aware=False)
register("victima_noptwcp", _VICTIMA, "Victima inserting every candidate "
         "(no PTW-CP ablation)", tags=("native", "ablation"),
         victima=True, use_ptwcp=False)
register("pom", _POM, "64K-entry software-managed in-memory L3 TLB",
         tags=("native",), pom=True)

# optimistic large L2 TLBs (12-cycle regardless of size; Figs. 5-6)
for _n, _sets, _ways in [("3k", 256, 12), ("8k", 512, 16),
                         ("16k", 1024, 16), ("32k", 2048, 16),
                         ("64k", 4096, 16), ("128k", 8192, 16)]:
    register(f"l2tlb_{_n}", _RADIX, f"optimistic {_n}-entry L2 TLB",
             tags=("native", "l2tlb_ladder"),
             l2tlb_sets=_sets, l2tlb_ways=_ways)

# realistic latencies from CACTI 7.0 (paper §3.1: 1.4x per 2x; Fig. 7)
for _n, _sets, _lat in [("8k", 512, 17), ("16k", 1024, 23),
                        ("32k", 2048, 30), ("64k", 4096, 39)]:
    register(f"l2tlb_{_n}_real", _RADIX,
             f"{_n}-entry L2 TLB at CACTI latency {_lat}c",
             tags=("native", "l2tlb_ladder"),
             l2tlb_sets=_sets, l2tlb_ways=16, l2tlb_lat=_lat)

# hardware L3 TLB (64K entries) at various latencies (Fig. 8)
for _lat in (15, 24, 39):
    register(f"l3tlb_64k_{_lat}", _L3, f"64K-entry hardware L3 TLB @{_lat}c",
             tags=("native", "l3tlb_ladder"),
             l3tlb_sets=4096, l3tlb_lat=_lat)

# L2 cache size sensitivity (Fig. 25): 1/4/8 MB
for _n, _sets in [("1m", 1024), ("4m", 4096), ("8m", 8192)]:
    register(f"victima_l2_{_n}", _VICTIMA, f"Victima with {_n}B L2 cache",
             tags=("native", "sensitivity"), victima=True, l2_sets=_sets)
    register(f"radix_l2_{_n}", _RADIX, f"radix with {_n}B L2 cache",
             tags=("native", "sensitivity"), l2_sets=_sets)

# Table 2 feature collection
register("radix_collect", _RADIX, "radix + per-page feature collection",
         tags=("native", "collect"), collect=True)

# ------------------------------------------------------------- utopia
# Hybrid RestSeg/FlexSeg mapping: set-associative RestSegs resolve
# translations with one tag probe; the FlexSeg falls back to the radix
# walker.  The PTW-CP-guided migration engine shares Victima's predictor.
register("utopia", _UTOPIA, "hybrid RestSeg/FlexSeg mapping + "
         "PTW-CP-guided page migration", tags=("native", "headline",
         "utopia"), utopia=True)
register("utopia_victima", _UTOPIA_VICTIMA, "Utopia RestSegs + Victima "
         "TLB blocks in L2$ (shared PTW-CP)", tags=("native", "utopia"),
         utopia=True, victima=True)
# RestSeg-associativity sensitivity
for _w in (8, 32):
    register(f"utopia_rs{_w}", _UTOPIA, f"Utopia with {_w}-way RestSegs",
             tags=("native", "sensitivity", "utopia"),
             utopia=True, restseg_ways=_w)

# ------------------------------------------------------------ revelator
# Hash-based speculative translation: a signature hit on an L2-TLB miss
# resolves the translation at near-zero latency while the walk verifies
# off the critical path; only a mispredict pays the walk.  Enrollment
# reuses the PTW-CP predictor.
register("revelator", _REV, "hash-based speculative translation + "
         "verify-later walks", tags=("native", "headline", "revelator"),
         revelator=True)
register("revelator_victima", _REV_VICTIMA, "Revelator speculation over "
         "Victima TLB blocks in L2$ (shared PTW-CP)",
         tags=("native", "revelator"), revelator=True, victima=True)

# --------------------------------------------------------------- virtualized
register("np", _NP, "nested paging: 2-D walk + nested TLB",
         tags=("virt",), virt=True)
register("victima_virt", _VICTIMA_NP, "Victima under nested paging "
         "(gVA + nested TLB blocks in L2$)", tags=("virt", "headline"),
         virt=True, victima=True)
register("pom_virt", _POM_NP, "POM-TLB under nested paging",
         tags=("virt",), virt=True, pom=True)
register("isp", _RADIX, "ideal shadow paging: 1-D walk, free updates",
         tags=("virt",), virt=True, ideal_shadow=True)


# --------------------------------------------------------------- ladders
#
# Ladders are DISCOVERED, not declared: any group of registered systems
# whose configs agree after pinning DYN_FIELDS -- and whose compositions
# agree after dropping the gated stages -- runs as one batched call.

# stages a batched ladder switches off per lane through a Dyn gate (the
# stage still runs, its state writes masked to a no-op): stage name ->
# (SimConfig field, Dyn gate).  dyn_of derives the gate from the field
# (l3_tlb from l3tlb_sets > 0; the others from their bool flag).
DYN_GATED_STAGES: dict[str, tuple[str, str]] = {
    "rev": ("revelator", "rev_en"),
    "victima": ("victima", "victima_en"),
    "restseg": ("utopia", "utopia_en"),
    "l3_tlb": ("l3tlb_sets", "l3tlb_en"),
    "pom": ("pom", "pom_en"),
}


def _ladder_key(sys_: System):
    """Systems with equal keys are shape-compatible ladder mates."""
    cfg = sys_.config()
    pinned = dataclasses.replace(
        cfg, **{f: getattr(SimConfig(), f) for f in DYN_FIELDS})
    stages = tuple(s for s in sys_.stages if s not in DYN_GATED_STAGES)
    return stages, pinned


def discover_ladders(registry: dict[str, System] | None = None
                     ) -> dict[str, tuple[str, ...]]:
    """Group registry systems into shape-compatible ladders:
    {ladder name: member names} for every group of two or more, named
    after its first-registered member."""
    registry = REGISTRY if registry is None else registry
    groups: dict = {}
    for name, sys_ in registry.items():
        groups.setdefault(_ladder_key(sys_), []).append(name)
    return {g[0]: tuple(g) for g in groups.values() if len(g) >= 2}


def ladder_base_config(ladder: str | None = None, members=None) -> SimConfig:
    """Static config for a ladder: its structures at the ladder maximum.

    Members may differ only in DYN_FIELDS; every dyn field takes its
    ladder maximum (stage flags are ORed, so the base composition holds
    every stage any member needs).  The L3 TLB has a gate but no set
    mask, so a member that has one must have the maximum's.
    """
    members = members or LADDERS[ladder]
    cfgs = [config(n) for n in members]
    pinned = {f: getattr(cfgs[0], f) for f in DYN_FIELDS}
    if len({dataclasses.replace(c, **pinned) for c in cfgs}) != 1:
        raise ValueError(
            f"ladder {ladder or members[0]!r} members differ beyond "
            f"{DYN_FIELDS}")
    l3max = max(c.l3tlb_sets for c in cfgs)
    for n, c in zip(members, cfgs):
        if c.l3tlb_sets not in (0, l3max):
            raise ValueError(
                f"ladder member {n!r}: l3tlb_sets={c.l3tlb_sets} differs "
                f"from the ladder maximum {l3max} (the L3 TLB is "
                f"gateable but not geometry-virtualized)")
    return dyn_base_config(cfgs)


def dyn_base_config(cfgs) -> SimConfig:
    """The maximal static allocation covering every config's live view:
    each DYN_FIELDS entry takes its maximum (stage flags are ORed)."""
    maxima = {}
    for f in DYN_FIELDS:
        vals = [getattr(c, f) for c in cfgs]
        maxima[f] = (any(vals) if isinstance(getattr(SimConfig(), f), bool)
                     else max(vals))
    return dataclasses.replace(cfgs[0], **maxima)


def ladder_dyn(members) -> Dyn:
    """Per-member Dyn values stacked into ``[S]`` leaves on the CPU
    (``dyn_of`` of each member, so the field-to-config mapping lives in
    one place)."""
    return stack_dyns([dyn_of(config(n)) for n in members])


LADDERS: dict[str, tuple[str, ...]] = discover_ladders()

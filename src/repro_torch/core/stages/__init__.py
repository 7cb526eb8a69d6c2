"""Composable translation-pipeline stages (port of
``repro.core.stages``): L1 and L2 TLBs, Revelator, Victima, the L3
TLB, the POM-TLB, Utopia's RestSegs and the radix and nested-paging
walkers.

``STAGES`` maps stage names to singleton stage objects; a *composition*
is an ordered tuple of names ending in a walker stage (``"ptw"`` or
``"ptw2d"``).  ``default_stages(cfg)`` derives the canonical composition
from a SimConfig.
"""
from __future__ import annotations

from repro_torch.core.stages.base import (DYN_FIELDS, Dyn, Feats,
                                          MMUState, Request, SimConfig,
                                          Stage, StageResult, Stats,
                                          WALK_HIST_BUCKETS, dramc_of,
                                          dyn_of, l2_geom_of, make_state,
                                          stack_dyns, state_from_numpy,
                                          state_leaves, state_to_numpy,
                                          zero_feats, zero_stats)
from repro_torch.core.stages.l1_tlb import L1TLBStage
from repro_torch.core.stages.l2_tlb import L2TLBStage
from repro_torch.core.stages.l3_tlb import L3TLBStage
from repro_torch.core.stages.nested import NestedWalkStage
from repro_torch.core.stages.pom import POMStage
from repro_torch.core.stages.ptw import RadixWalkStage
from repro_torch.core.stages.revelator import RevelatorStage
from repro_torch.core.stages.utopia import RestSegStage
from repro_torch.core.stages.victima import VictimaStage

STAGES: dict[str, Stage] = {
    s.name: s for s in (L1TLBStage(), L2TLBStage(), RevelatorStage(),
                        VictimaStage(), L3TLBStage(), POMStage(),
                        RestSegStage(), RadixWalkStage(), NestedWalkStage())
}


def default_stages(cfg: SimConfig) -> tuple[str, ...]:
    """Canonical stage composition implied by a SimConfig."""
    names = ["l1_tlb", "l2_tlb"]
    if cfg.revelator:
        names.append("rev")  # speculate right at the L2-TLB miss
    if cfg.victima:
        names.append("victima")
    if cfg.l3tlb_sets > 0:
        names.append("l3_tlb")
    if cfg.pom:
        names.append("pom")
    if cfg.utopia:
        names.append("restseg")  # last resort before the FlexSeg walk
    names.append("ptw2d" if cfg.virt and not cfg.ideal_shadow else "ptw")
    return tuple(names)


def validate_stages(cfg: SimConfig, names: tuple[str, ...]) -> None:
    """A composition must agree with the config flags the stages read."""
    expect = default_stages(cfg)
    if tuple(names) != expect:
        raise ValueError(
            f"stage composition {tuple(names)} inconsistent with config "
            f"(expected {expect}: the rev/victima/l3/pom/utopia/virt "
            f"flags and the stage list must agree)")


def fill_order(names: tuple[str, ...]) -> tuple[str, ...]:
    """Refill/learning pass order for a composition.

    Victima systems: the L2 TLB refill's evicted entry feeds Victima's
    background walk, so it must land first.  Non-Victima systems update
    the walker's PTW-CP counters then refill the L2 TLB.  Utopia's
    migration engine and Revelator's enrollment read the post-walk PTW-CP
    counters, so they run right after whichever of those owns the
    counter traffic.  POM / L3-TLB learning and the L1 refill close out
    every composition.
    """
    order = (["l2_tlb", "victima"] if "victima" in names
             else [names[-1], "l2_tlb"])
    order += [n for n in ("restseg", "rev") if n in names]
    order += [n for n in ("pom", "l3_tlb") if n in names]
    order.append("l1_tlb")
    return tuple(order)


__all__ = [
    "DYN_FIELDS", "Dyn", "Feats", "MMUState", "Request", "STAGES",
    "SimConfig", "Stage", "StageResult", "Stats", "WALK_HIST_BUCKETS",
    "default_stages", "dramc_of", "dyn_of", "fill_order", "l2_geom_of",
    "make_state", "stack_dyns", "state_from_numpy", "state_leaves",
    "state_to_numpy", "validate_stages", "zero_feats", "zero_stats",
]

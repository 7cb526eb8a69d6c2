"""Registry of evaluated systems (paper Table 3 + ablations); port of
``repro.sim.systems`` restricted to the systems this port simulates: the
single-core native systems built from the radix and Victima
compositions.

Each ``System`` names its stage composition plus the SimConfig overrides
that size it; its entry matches the reference's one for one.  A name the
reference registers but this port does not simulate yet raises and names
the ROADMAP.md queue item that will port it.  Ladders (the ``Dyn``
batched form) wait for that queue's lane-batching item.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.stages import SimConfig, default_stages

_RADIX = ("l1_tlb", "l2_tlb", "ptw")
_VICTIMA = ("l1_tlb", "l2_tlb", "victima", "ptw")


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
_LATER_STAGES = "Queue 1, the stages the paper's figures need"
_LATER_UR = "Queue 1, Utopia and Revelator"
_LATER_MULTICORE = "Queue 1, Multicore"
LATER: dict[str, str] = {
    "pom": _LATER_STAGES,
    "l3tlb_64k_15": _LATER_STAGES, "l3tlb_64k_24": _LATER_STAGES,
    "l3tlb_64k_39": _LATER_STAGES,
    "radix_collect": _LATER_STAGES + " (collect_feats)",
    "utopia": _LATER_UR, "utopia_victima": _LATER_UR,
    "utopia_rs8": _LATER_UR, "utopia_rs32": _LATER_UR,
    "revelator": _LATER_UR, "revelator_victima": _LATER_UR,
    "np": _LATER_STAGES, "victima_virt": _LATER_STAGES,
    "pom_virt": _LATER_STAGES, "utopia_virt": _LATER_UR,
    "revelator_virt": _LATER_UR, "isp": _LATER_STAGES,
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

# L2 cache size sensitivity (Fig. 25): 1/4/8 MB
for _n, _sets in [("1m", 1024), ("4m", 4096), ("8m", 8192)]:
    register(f"victima_l2_{_n}", _VICTIMA, f"Victima with {_n}B L2 cache",
             tags=("native", "sensitivity"), victima=True, l2_sets=_sets)
    register(f"radix_l2_{_n}", _RADIX, f"radix with {_n}B L2 cache",
             tags=("native", "sensitivity"), l2_sets=_sets)

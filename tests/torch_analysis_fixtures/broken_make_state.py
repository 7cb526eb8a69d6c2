"""The port's make_state with the Revelator gate dropped from the
hoisted ``rev_sets`` (C004): an off lane would carry the full table."""


def make_state(cfg, lanes=1, device="cpu"):
    def mk(sets, ways):
        return make(sets, ways, lanes, device)  # noqa: F821

    rs_ways = cfg.restseg_ways if cfg.utopia else 1
    rev_sets = cfg.rev_sets                      # C004: gate dropped
    rev_ways = cfg.rev_ways if cfg.revelator else 1

    return MMUState(  # noqa: F821
        l3tlb=mk(max(cfg.l3tlb_sets, 1), cfg.l3tlb_ways),
        pom=mk(cfg.pom_sets if cfg.pom else 1, cfg.pom_ways),
        hier=make_hier(max(cfg.dram_cache_sets, 1),  # noqa: F821
                       cfg.dram_cache_ways),
        ntlb=mk(cfg.ntlb_sets if cfg.virt else 1, cfg.ntlb_ways),
        restseg4=mk(cfg.restseg4_sets if cfg.utopia else 1, rs_ways),
        restseg2=mk(cfg.restseg2_sets if cfg.utopia else 1, rs_ways),
        rev=RevTable(tab=mk(rev_sets, rev_ways),  # noqa: F821
                     vpn=zeros((lanes, rev_sets, rev_ways))),  # noqa: F821
        pch=make_counters(cfg.n_pagesh if cfg.virt else 1),  # noqa: F821
        feats=zero_feats(cfg.n_feat if cfg.collect else 1),  # noqa: F821
    )

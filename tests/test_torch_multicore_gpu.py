"""The mmu_step CUDA kernel's compositions for Utopia and Revelator under
nested paging and for the multicore shared tier (port contention, the
DRAM cache) against the plain PyTorch version, and the grown nested
ladder and the multicore ladder against the plain dyn step.

The ``gpu`` tests need the card and skip elsewhere; they import no jax:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_multicore_gpu.py

Small structures, so that every flow fires within a few thousand
accesses: a 64 x 8 L3 and a 64 x 8 DRAM cache below it (which then
hits), 16 x 4 POM-TLB, RestSegs and signature table.  The plain runs go
on the CPU; both start from the same zero state and numpy-made traces
(a core leaf per lane for the multicore ones), and every state leaf must
be equal.  Blocks of 97 rows put the launch seams inside the trace.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import mmu
from repro_torch.core.stages import (SimConfig, default_stages, dyn_of,
                                     make_state, stack_dyns, state_leaves)
from repro_torch.kernels import mmu_step
from repro_torch.sim import systems
from test_torch_kernel import (TINY, assert_leaves_equal, cuda,  # noqa: F401
                               mixed_traces)

SMALL = dict(TINY, n_pagesh=1 << 8, l3_sets=64, l3_ways=8, pom_sets=16,
             pom_ways=4, restseg4_sets=16, restseg2_sets=8, restseg_ways=4,
             rev_sets=16, rev_ways=4, rev_sig_bits=10)

# system -> the composition its launches must run
WANT = {"utopia_virt": "utopia_np", "revelator_virt": "revelator_np",
        "radix_2c": "radix_mc", "victima_2c": "victima_mc",
        "pom_2c": "pom_mc", "victima_dramc_2c": "victima_dramc",
        "radix_4c": "radix_mc", "victima_4c": "victima_mc",
        "pom_4c": "pom_mc", "victima_dramc_4c": "victima_dramc",
        "victima_dramc_1c": "victima_dramc", "radix_1c": "radix",
        "victima_1c": "victima", "pom_1c": "pom"}


def small(name: str) -> SimConfig:
    """`name` on SMALL structures (a DRAM cache of 64 x 8 where it has
    one)."""
    cfg = dataclasses.replace(systems.config(name), **SMALL)
    if cfg.dram_cache_sets:
        cfg = dataclasses.replace(cfg, dram_cache_sets=64, dram_cache_ways=8)
    return cfg


def core_traces(n: int, cores: int, seed: int = 7) -> dict:
    """mixed_traces with a core leaf: lane c is core c."""
    tr = mixed_traces(n, cores, seed)
    tr["core"] = np.ascontiguousarray(np.broadcast_to(
        np.arange(cores, dtype=np.int32), (n, cores)))
    return tr


def run(cfg, traces, device, kernel: bool, block=None, dyn=None):
    """(state leaves, the state) after the run."""
    names = default_stages(cfg)
    st = make_state(cfg, traces["vpn"].shape[1], device)
    tr = {k: torch.from_numpy(v).to(device) for k, v in traces.items()}
    if kernel:
        mmu_step.launch(st, tr, cfg, names, block,
                        dyn=None if dyn is None else dyn.to(device))
    else:
        mmu_step.plain_scan(mmu.make_step(
            cfg, names, None if dyn is None else dyn.to(device)), st, tr)
    torch.cuda.synchronize()
    return [x.cpu().numpy() for x in state_leaves(st)], st


@pytest.mark.gpu
@pytest.mark.parametrize("system", sorted(WANT))
def test_composition_matches_plain_on_small_structures(cuda, system):
    cfg = small(system)
    tr = core_traces(2500, max(cfg.n_cores, 2))
    comp = mmu_step.composition(cfg, default_stages(cfg))[0]
    assert comp == WANT[system]
    before = dict(mmu_step.LAUNCHES_BY_COMPOSITION)
    k, st = run(cfg, tr, cuda, kernel=True)
    assert mmu_step.LAUNCHES_BY_COMPOSITION[comp] == before[comp] + 1
    assert_leaves_equal(k, run(cfg, tr, torch.device("cpu"),
                               kernel=False)[0])
    if cfg.dram_cache_sets:
        assert int(st.hier.n_dramc_hit.min()) > 0, "the DRAM cache never hit"
    if cfg.virt:
        assert int(st.stats.n_ntlb_hit.min()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("system", ["revelator_virt", "victima_dramc_4c",
                                    "pom_2c"])
def test_composition_does_not_depend_on_block(cuda, system):
    cfg = small(system)
    tr = core_traces(1200, max(cfg.n_cores, 2), seed=11)
    assert_leaves_equal(run(cfg, tr, cuda, kernel=True)[0],
                        run(cfg, tr, cuda, kernel=True, block=97)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("system", ["utopia_virt", "revelator_virt",
                                    "victima_dramc_2c", "radix_4c"])
def test_composition_matches_plain_at_table3(cuda, system):
    cfg = systems.config(system)
    assert mmu_step.placement(cfg).name == "shared"
    tr = core_traces(600, max(cfg.n_cores, 2))
    assert_leaves_equal(run(cfg, tr, cuda, kernel=True)[0],
                        run(cfg, tr, torch.device("cpu"), kernel=False)[0])


# the grown nested ladder and a multicore ladder on SMALL structures: one
# lane a member flavour (the multicore one core by core)
LADDERS = {
    "ladder_np": [dict(virt=True), dict(virt=True, victima=True, l2_sets=16,
                                        l2_ways=4),
                  dict(virt=True, pom=True), dict(virt=True, utopia=True),
                  dict(virt=True, revelator=True)],
    "ladder_mc": [dict(n_cores=2, **over) for over in (
        dict(), dict(victima=True), dict(pom=True),
        dict(victima=True, dram_cache_sets=64, dram_cache_ways=8))],
}


def _ladder(comp):
    cfgs = [SimConfig(**{**SMALL, **v}) for v in LADDERS[comp]]
    base = systems.dyn_base_config(cfgs)
    return base, cfgs


@pytest.mark.gpu
@pytest.mark.parametrize("block", [None, 97])
@pytest.mark.parametrize("comp", sorted(LADDERS))
def test_ladder_matches_plain_dyn_step(cuda, comp, block):
    base, cfgs = _ladder(comp)
    assert mmu_step.composition(base, default_stages(base), dyn=True)[0] == \
        comp
    cores = base.n_cores
    dyn = stack_dyns([dyn_of(c) for c in cfgs])
    dyn = type(dyn)(*[x.repeat_interleave(cores) for x in dyn])
    lanes = len(cfgs) * cores
    tr = core_traces(2500, cores)
    tr = {k: np.ascontiguousarray(np.tile(v, (1, len(cfgs))))
          for k, v in tr.items()}
    tr = {k: v[:, :lanes] for k, v in tr.items()}
    before = mmu_step.LAUNCHES_BY_COMPOSITION[comp]
    k, st = run(base, tr, cuda, kernel=True, block=block, dyn=dyn)
    assert mmu_step.LAUNCHES_BY_COMPOSITION[comp] > before
    assert_leaves_equal(k, run(base, tr, torch.device("cpu"), kernel=False,
                               dyn=dyn)[0])
    if comp == "ladder_mc":  # only the DRAM-cache lanes probe it
        hits = st.hier.n_dramc_hit.view(len(cfgs), cores)
        assert int(hits[-1].min()) > 0 and int(hits[:-1].abs().sum()) == 0
    else:
        assert int(st.stats.n_restseg_mig[-2]) > 0
        assert int(st.stats.n_rev_enroll[-1]) > 0

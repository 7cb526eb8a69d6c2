"""The mmu_step CUDA kernel's compositions for Table 2 (``radix_collect``),
Utopia and Revelator against the plain PyTorch version, and every
instantiation launched in one process.

The ``gpu`` tests need the card and skip elsewhere; they import no jax:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_compositions_gpu.py

The plain runs go on the CPU (on the card the plain step waits on the
host, one small kernel at a time); both start from the same zero state
and numpy-made traces, and every state leaf must be equal.
"""
import dataclasses

import pytest
import torch

from repro_torch.core.stages import SimConfig, default_stages, make_state
from repro_torch.kernels import mmu_step
from repro_torch.sim import systems
from test_torch_kernel import (TINY, assert_leaves_equal, cuda,  # noqa: F401
                               mixed_traces, run, workload_traces)

NEW = ["radix_collect", "utopia", "utopia_rs8", "utopia_rs32",
       "utopia_victima", "revelator", "revelator_victima"]
# system -> the composition its launches must run
WANT = {"radix_collect": "radix_collect", "utopia": "utopia",
        "utopia_rs8": "utopia", "utopia_rs32": "utopia",
        "utopia_victima": "utopia_victima", "revelator": "revelator",
        "revelator_victima": "revelator_victima"}


def tiny(name: str) -> SimConfig:
    """`name` on TINY structures with test_systems_registry's small
    RestSegs and signature table; utopia_rs32 keeps its 32 ways (the
    whole warp) on 4 and 2 sets."""
    cfg = systems.get(name).config(SimConfig(**TINY, n_feat=1 << 10))
    if cfg.utopia:
        small = dict(restseg4_sets=16, restseg2_sets=8,
                     restseg_ways=min(cfg.restseg_ways, 8))
        if cfg.restseg_ways == 32:
            small = dict(restseg4_sets=4, restseg2_sets=2, restseg_ways=32)
        cfg = dataclasses.replace(cfg, **small)
    if cfg.revelator:
        cfg = dataclasses.replace(cfg, rev_sets=16, rev_ways=4,
                                  rev_sig_bits=10)
    return cfg


def _counts():
    return dict(mmu_step.LAUNCHES_BY_COMPOSITION)


@pytest.mark.gpu
@pytest.mark.parametrize("system", NEW)
def test_new_composition_matches_plain_on_small_structures(cuda, system):
    cfg = tiny(system)
    tr = mixed_traces(3000, 3)
    before = _counts()
    k = run(cfg, tr, cuda, kernel=True)
    after = _counts()
    assert after[WANT[system]] == before[WANT[system]] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    assert_leaves_equal(k, run(cfg, tr, torch.device("cpu"), kernel=False))


@pytest.mark.gpu
@pytest.mark.parametrize("system", NEW)
def test_new_composition_matches_plain_at_table3(cuda, system):
    cfg = systems.config(system)
    assert mmu_step.placement(cfg).name == "shared"
    tr = workload_traces(["rnd", "bc"], 1500)
    assert_leaves_equal(run(cfg, tr, cuda, kernel=True),
                        run(cfg, tr, torch.device("cpu"), kernel=False))


@pytest.mark.gpu
@pytest.mark.parametrize("system", NEW)
def test_new_composition_does_not_depend_on_block(cuda, system):
    cfg = tiny(system)
    tr = mixed_traces(1200, 2, seed=11)
    assert_leaves_equal(run(cfg, tr, cuda, kernel=True),
                        run(cfg, tr, cuda, kernel=True, block=97))


# a configuration of each instantiation: composition -> system, and for
# radix and Victima outside shared memory, placement -> geometry
_SYSTEM_OF = {"radix": "radix", "victima": "victima", "l3tlb": "l3tlb_64k_15",
              "pom": "pom", "np": "np", "victima_np": "victima_virt",
              "pom_np": "pom_virt", "utopia_np": "utopia_virt",
              "revelator_np": "revelator_virt", "radix_mc": "radix_2c",
              "victima_mc": "victima_2c", "pom_mc": "pom_2c",
              "victima_dramc": "victima_dramc_2c",
              **{v: v for v in WANT.values()}}
_GEOMETRY = {"shared": {}, "l2tlb_device": dict(l2tlb_sets=8192,
                                                l2tlb_ways=16),
             "l2_device": dict(l2_sets=8192),
             "device": dict(l2_sets=4096, l2tlb_sets=8192, l2tlb_ways=16)}


# the ladder instantiations: composition -> ladder
_LADDER_OF = {"ladder_native": "radix", "ladder_np": "np",
              "ladder_mc": "radix_2c"}


@pytest.mark.gpu
def test_every_instantiation_launches_in_one_process(cuda):
    """Each instantiation raises its own shared-memory limit once (its
    flag is indexed by its dense number): launched one after the other,
    at the geometries that take up to 217 KB of shared memory, every one
    runs; the three ladder instantiations on their ladder's base config,
    two members a launch."""
    built = mmu_step.instantiations()
    assert len(built) == 27 == len(set(built))
    tr = {k: torch.from_numpy(v).to(cuda)
          for k, v in workload_traces(["rnd", "bc"], 64).items()}
    for comp, place in built:
        dyn = None
        if comp in _LADDER_OF:
            cfg = systems.ladder_base_config(_LADDER_OF[comp])
            dyn = systems.ladder_dyn(
                systems.LADDERS[_LADDER_OF[comp]][:2]).to(cuda)
            assert mmu_step.ladder_placement(
                cfg, default_stages(cfg)).name == place, (comp, place)
        else:
            cfg = dataclasses.replace(systems.config(_SYSTEM_OF[comp]),
                                      **_GEOMETRY[place])
            assert mmu_step.placement(cfg).name == place, (comp, place)
        st = make_state(cfg, 2, cuda)
        before = _counts()
        mmu_step.launch(st, tr, cfg, default_stages(cfg), dyn=dyn)
        torch.cuda.synchronize()
        assert _counts()[comp] == before[comp] + 1, (comp, place)
        assert st.stats.n_access.tolist() == [64, 64], (comp, place)

"""The mmu_step CUDA kernel's ladder instantiations (``ladder_native``,
``ladder_np``) against the plain dyn step, and a ladder's lanes against
their members' static kernel runs.

The ``gpu`` tests need the card and skip elsewhere; they import no jax:

    PYTHONPATH=src:tests python -m pytest -q --noconftest -m gpu \
        tests/test_torch_ladder_gpu.py

The plain runs go on the CPU (on the card the plain step waits on the
host, one small kernel at a time); both start from the same zero state
and numpy-made traces, and every state leaf must be equal.
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
                               mixed_traces, workload_traces)

_SMALL = dict(n_pagesh=1 << 8, l3tlb_ways=4, pom_sets=16, pom_ways=4,
              restseg4_sets=16, restseg2_sets=8, restseg_ways=4,
              rev_sets=16, rev_ways=4, rev_sig_bits=10)
# each ladder on small structures: one lane a member flavour, whose union
# is the ladder's base composition (a radix lane with every gate off, the
# gated stages alone and together, the L2-cache and L2-TLB views)
SMALL_LADDERS = {
    "radix": [dict(), dict(utopia=True, victima=True, restseg_ways=8),
              dict(revelator=True), dict(revelator=True, victima=True),
              dict(pom=True), dict(l3tlb_sets=16, l3tlb_lat=24),
              dict(victima=True, l2_sets=16, l2_ways=4),
              dict(l2tlb_sets=2, l2tlb_ways=2, l2tlb_lat=17)],
    "np": [dict(virt=True), dict(virt=True, victima=True, l2_sets=16,
                                 l2_ways=4), dict(virt=True, pom=True),
           dict(virt=True, utopia=True), dict(virt=True, revelator=True)],
}


def small_ladder(ladder):
    """(base config, member configs) of `ladder` on small structures."""
    cfgs = [SimConfig(**{**TINY, **_SMALL, **v})
            for v in SMALL_LADDERS[ladder]]
    return systems.dyn_base_config(cfgs), cfgs


def run_dyn(base, cfgs, traces, device, kernel: bool, block=None):
    """All state leaves after a ladder run, one lane a config."""
    names = default_stages(base)
    dyn = stack_dyns([dyn_of(c) for c in cfgs]).to(device)
    st = make_state(base, len(cfgs), device)
    tr = {k: torch.from_numpy(v).to(device) for k, v in traces.items()}
    if kernel:
        mmu_step.launch(st, tr, base, names, block, dyn=dyn)
    else:
        mmu_step.plain_scan(mmu.make_step(base, names, dyn), st, tr)
    torch.cuda.synchronize()
    return [x.cpu().numpy() for x in state_leaves(st)]


@pytest.mark.gpu
@pytest.mark.parametrize("block", [None, 97])
@pytest.mark.parametrize("ladder,comp", [("radix", "ladder_native"),
                                         ("np", "ladder_np")])
def test_ladder_instantiation_matches_plain_dyn_step(cuda, ladder, comp,
                                                     block):
    base, cfgs = small_ladder(ladder)
    assert mmu_step.composition(base, default_stages(base), True)[0] == comp
    tr = mixed_traces(2500, len(cfgs))
    before = dict(mmu_step.LAUNCHES_BY_COMPOSITION)
    k = run_dyn(base, cfgs, tr, cuda, kernel=True, block=block)
    assert mmu_step.LAUNCHES_BY_COMPOSITION[comp] > before[comp]
    assert_leaves_equal(k, run_dyn(base, cfgs, tr, torch.device("cpu"),
                                   kernel=False))


@pytest.mark.gpu
@pytest.mark.parametrize("ladder,members", [
    ("radix", ("radix", "victima", "pom")),
    ("radix", ("utopia_rs32", "revelator_victima", "l2tlb_128k")),
    ("np", ("np", "victima_virt", "pom_virt"))])
def test_ladder_lanes_equal_static_kernel_runs(cuda, ladder, members):
    """Three members x two workloads at Table 3 in one ladder launch a
    block: each lane's Stats and extras equal the member's own kernel
    run."""
    traces = workload_traces(["rnd", "bc"], 3000)
    per, extras = mmu.simulate_systems(
        systems.ladder_base_config(ladder), systems.ladder_dyn(members),
        traces, device=cuda)
    for s, name in enumerate(members):
        want, want_ex = mmu.simulate_batch(systems.config(name), traces,
                                           device=cuda)
        for w in range(2):
            for f, a, b in zip(want[w]._fields, want[w], per[s][w]):
                assert np.array_equal(a, b), (name, w, f)
            assert sorted(want_ex[w]) == sorted(extras[s][w])
            for key in want_ex[w]:
                assert np.array_equal(want_ex[w][key], extras[s][w][key]), \
                    (name, w, key)


@pytest.mark.gpu
def test_ladder_launch_refuses_a_bad_view(cuda):
    base, cfgs = small_ladder("radix")
    wide = dataclasses.replace(cfgs[0], l2tlb_ways=base.l2tlb_ways * 2)
    dyn = stack_dyns([dyn_of(c) for c in (cfgs[1], wide)]).to(cuda)
    st = make_state(base, 2, cuda)
    tr = {k: torch.from_numpy(v).to(cuda)
          for k, v in mixed_traces(8, 2).items()}
    with pytest.raises(ValueError, match="allocation"):
        mmu_step.launch(st, tr, base, default_stages(base), dyn=dyn)

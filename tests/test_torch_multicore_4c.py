"""The port's four-core systems and a multicore ladder (``repro_torch``)
against the JAX package, on the CPU, core lane by core lane.

- the ``{radix,victima,pom,victima_dramc}_4c`` systems as
  tests/test_torch_multicore_systems.py checks the others;
- the ``radix_2c`` ladder's four members, two cores each, through the
  port's dyn step against the reference's dyn step under a plain
  ``jax.lax.scan`` (the reference's ``simulate_systems`` does not run
  under the installed jax), one run per member and core: every Stats
  leaf, extra and state leaf.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mmu as j_mmu
from repro.core.stages import base as j_base
from repro.sim import systems as j_systems
from repro_torch.core import mmu as t_mmu
from repro_torch.core.stages import base as t_base
from repro_torch.sim import systems as t_systems
from test_torch_mmu import assert_extras_equal, assert_stats_equal, port_cfg
from test_torch_multicore_systems import (MULTICORE, N, check_system,
                                          core_trace, small)


@pytest.mark.parametrize("name", [n for n in MULTICORE
                                  if t_systems.config(n).n_cores == 4])
def test_four_core_system_equals_the_reference_core_by_core(name):
    check_system(name)


# ------------------------------------------------ the multicore ladder

LADDER = "radix_2c"


def _ladder_cfgs():
    members = j_systems.LADDERS[LADDER]
    return members, [small(m) for m in members]


@functools.lru_cache(maxsize=None)
def _reference_dyn_runner(base):
    """The reference's dyn step under a plain ``lax.scan`` from
    ``make_state(base)``, the Dyn a traced argument."""
    @jax.jit
    def run(dyn, tr):
        st = jax.lax.scan(j_mmu.make_step(base, dyn=dyn),
                          j_base.make_state(base), tr)[0]
        return st, j_mmu._finalize(st)

    return run


def test_multicore_ladder_lanes_equal_the_reference_dyn_step():
    members, cfgs = _ladder_cfgs()
    assert len(members) == 4 and t_systems.mix_cores(members) == 2
    base = j_systems.dyn_base_config(cfgs)
    tbase = port_cfg(base)
    assert t_mmu.default_stages(tbase) == \
        ("l1_tlb", "l2_tlb", "victima", "pom", "ptw")
    C, S = base.n_cores, len(cfgs)
    tr = core_trace(N, C)
    dyn = t_base.stack_dyns([t_base.dyn_of(port_cfg(c)) for c in cfgs])
    dyn = t_base.Dyn(*[x.repeat_interleave(C) for x in dyn])
    st = t_base.make_state(tbase, S * C)
    t_mmu.scan_accesses(
        t_mmu.make_step(tbase, dyn=dyn), st,
        {k: torch.from_numpy(np.ascontiguousarray(np.tile(v, (1, S))))
         for k, v in tr.items()}, tbase, None)
    leaves = t_base.state_to_numpy(st)
    stats, *rest = t_mmu._finalize(st, tbase)
    run = _reference_dyn_runner(base)
    for s, cfg in enumerate(cfgs):
        for c in range(C):
            lane = s * C + c
            rst, (rstats, l2a, l2m, hd, ht, feats, pc4, shared) = run(
                j_base.dyn_of(cfg),
                {k: jnp.asarray(v[:, c]) for k, v in tr.items()})
            what = (members[s], c)
            assert_stats_equal(jax.tree.map(np.asarray, rstats),
                               t_base.Stats(*[x[lane] for x in stats]), what)
            assert_extras_equal(
                j_mmu._extras_of(base, l2a, l2m, hd, ht, feats, pc4,
                                 shared),
                t_mmu._extras_of(tbase, *rest,
                                 index=lambda x, i=lane: x[i]), what)
            want = [np.asarray(x) for x in jax.tree.leaves(rst)]
            assert len(want) == len(leaves)
            for i, (a, b) in enumerate(zip(want, leaves)):
                assert a.dtype == b.dtype and np.array_equal(a, b[lane]), \
                    (what, i)
    hits = rest[-1][3].reshape(S, C)  # n_dramc_hit: the DRAM-cache lanes'
    assert hits[-1].min() > 0 and not hits[:-1].any()
    assert int(stats.n_victima_hit.sum()) > 0
    assert int(stats.n_pom_hit.sum()) > 0

"""The port's multicore systems (``repro_torch``) against the JAX package,
on the CPU, core lane by core lane.

- every ``{radix,victima,pom,victima_dramc}_{1,2}c`` system at
  GOLDEN_CFG's small geometry (a 64 x 8 L3 and, where the system has
  one, a 64 x 8 DRAM cache below it, which then hits), over per-core
  traces with their ``core`` leaf, against the reference's
  ``simulate_batch``: every Stats leaf and extra of every core lane; the
  one-core systems also against their single-core systems' Stats;
- the four-core systems and the ``radix_2c`` ladder's lanes are in
  tests/test_torch_multicore_4c.py (a file a worker: the reference's
  compile of each system's step is most of a case's time).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from golden_trace import golden_trace
from repro.core import mmu as j_mmu
from repro.sim import systems as j_systems
from repro_torch.core import mmu as t_mmu
from repro_torch.sim import systems as t_systems
from test_torch_mmu import assert_extras_equal, assert_stats_equal, port_cfg

N = 500
MULTICORE = [n for n in t_systems.names("multicore")]
FEWER_CORES = [n for n in MULTICORE if t_systems.config(n).n_cores < 4]
# GOLDEN_CFG's structures, with the shared tier cut to size too
SMALL = dict(l2tlb_sets=4, l2tlb_ways=4, l1d4_sets=2, l1d4_ways=2,
             l1d2_sets=2, l1d2_ways=2, l2_sets=64, l2_ways=8, l3_sets=64,
             l3_ways=8, n_pages4=1 << 12, n_pages2=1 << 8, n_pagesh=1 << 8,
             n_feat=1, pom_sets=16, pom_ways=4)


def small(name: str):
    """The reference's config of `name` at SMALL (its core count, tier
    flags and stages kept)."""
    cfg = dataclasses.replace(j_systems.config(name), **SMALL)
    if cfg.dram_cache_sets:
        cfg = dataclasses.replace(cfg, dram_cache_sets=64, dram_cache_ways=8)
    return cfg


def core_trace(n: int, cores: int) -> dict:
    """One golden trace a core (seeds 100 + c), with the core leaf."""
    trs = [golden_trace(n, 100 + c) for c in range(cores)]
    tr = {k: np.stack([x[k] for x in trs], axis=1) for k in trs[0]}
    tr["core"] = np.ascontiguousarray(np.broadcast_to(
        np.arange(cores, dtype=np.int32), (n, cores)))
    return tr


@functools.lru_cache(maxsize=None)
def reference(name: str):
    cfg = small(name)
    tr = core_trace(N, max(cfg.n_cores, 2))
    per, extras = j_mmu.simulate_batch(
        cfg, {k: jnp.asarray(v) for k, v in tr.items()})
    return [jax.tree.map(np.asarray, p) for p in per], extras


def check_system(name):
    """`name`'s core lanes against the reference's, every leaf; a
    one-core system also against its single-core system."""
    cfg = small(name)
    tr = core_trace(N, max(cfg.n_cores, 2))
    per, extras = t_mmu.simulate_batch(port_cfg(cfg), tr, device="cpu")
    want, want_ex = reference(name)
    assert len(per) == len(want) == tr["vpn"].shape[1]
    for c, (a, b) in enumerate(zip(want, per)):
        assert_stats_equal(a, b, (name, c))
        assert_extras_equal(want_ex[c], extras[c], (name, c))
        assert {"l3_access", "l3_trans", "dramc_access",
                "dramc_hit"} <= set(extras[c])
        if cfg.dram_cache_sets:
            assert extras[c]["dramc_hit"] > 0, (name, c)
        else:
            assert extras[c]["dramc_access"] == 0, (name, c)
    if cfg.n_cores == 1 and not cfg.dram_cache_sets:
        # the one-core member is its single-core system, Stats for Stats
        single = name.rsplit("_", 1)[0]
        scfg = port_cfg(small(single))
        solo, solo_ex = t_mmu.simulate_batch(scfg, {
            k: v for k, v in tr.items() if k != "core"}, device="cpu")
        for c in range(len(per)):
            assert_stats_equal(solo[c], per[c], (name, "single", c))
            assert "l3_access" not in solo_ex[c]


@pytest.mark.parametrize("name", FEWER_CORES)
def test_system_equals_the_reference_core_by_core(name):
    check_system(name)

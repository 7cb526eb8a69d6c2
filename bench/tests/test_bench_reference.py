"""The benchmark's plain reference against the port, on the CPU: its
traces byte for byte, its statistics and extras leaf for leaf against
the port's plain path (at Table 3 through the cells' entries, and at
tiny geometries where structures fill and evict), and a changed counter
or a lower-precision sum caught by the check's comparison."""
import dataclasses

import numpy as np
import pytest

from bench.lib import check as chk
from bench.lib import manifest
from bench.lib.jobs import run_job, system_config
from bench.reference import mmu as ref_mmu
from bench.reference import traces as ref_traces

SEEDS = (7, 2**31 + 12345)


def _ref_lane(cfg, workload, n, seed, sum_dtype="float32"):
    return chk.reference_lane((cfg, workload, n, seed, sum_dtype))


@pytest.mark.parametrize("seed", SEEDS)
def test_traces_equal_the_ports(seed):
    from repro_torch.sim import trace_gen

    assert set(ref_traces.WORKLOADS) == set(trace_gen.WORKLOADS)
    for w in ref_traces.WORKLOADS:
        port = trace_gen.generate(w, 4000, seed)
        ref = ref_traces.generate(w, 4000, seed)
        for k, v in port["trace"].items():
            assert v.dtype == ref[k].dtype and np.array_equal(v, ref[k]), w
        assert ref["ipa"] == port["spec"].ipa


# (configuration, traffic mix) of each cell; virt.victima-t4 is out of
# the manifest for its host noise, but its mix, run_batch on the static
# victima_np instantiation, stays held to the reference
CELL_FILES = {"native.victima-t4": ("native", "victima-t4"),
              "virt.victima-t4": ("virt", "victima-virt-t4"),
              "native.l2-sweep-t4": ("native", "l2-sweep-t4"),
              "virt.np-pair-t4": ("virt", "np-pair-t4")}


@pytest.mark.parametrize("cell_name, n", [("native.victima-t4", 40),
                                          ("virt.victima-t4", 30),
                                          ("native.l2-sweep-t4", 16),
                                          ("virt.np-pair-t4", 30)])
def test_cells_entries_equal_the_reference(cell_name, n):
    """Every lane of one job of each cell, through the cell's own entry
    (run_batch or run_ladder) on the port's plain path."""
    config, mix = CELL_FILES[cell_name]
    config = manifest.load_json(manifest.config_path(config))
    traffic = manifest.load_json(manifest.traffic_path(mix))
    seed = 2**31 + 99
    got = run_job(traffic, n, seed, device="cpu")
    assert len(got) == len(traffic["systems"]) * len(traffic["workloads"])
    for (s, w), port in got.items():
        ref = _ref_lane(system_config(config, s), w, n, seed)
        assert chk.compare(port, ref) == [], (s, w)


def test_every_cell_has_its_files_listed():
    assert {w["name"] for w in manifest.load_json(manifest.MANIFEST)[
        "workloads"]} <= set(CELL_FILES)


# small structures, so that every level fills, evicts and ages within a
# few hundred accesses (SRRIP aging, the TLB-aware re-roll, background
# walks, nested-TLB evictions)
TINY = dict(l2_sets=64, l2_ways=4, l3_sets=64, l3_ways=4, l2tlb_sets=4,
            l2tlb_ways=4, ntlb_sets=2, ntlb_ways=2, l1_sets=4, l1_ways=2)


def _cfg_dict(cfg):
    d = dataclasses.asdict(cfg)
    d["lat"] = cfg.lat._asdict()
    return d


@pytest.mark.parametrize("system", ["radix", "victima", "np", "victima_virt"])
def test_tiny_geometry_equals_the_reference(system):
    from repro_torch.sim import runner, systems

    n, seed = 300, 3
    wls = ["bc", "rnd"]
    got = runner.run_batch(system, wls, n=n, seed=seed, overrides=TINY,
                           cache=False, device="cpu")
    cfg = _cfg_dict(dataclasses.replace(systems.config(system), **TINY))
    hits = 0
    for w in wls:
        st, ex, _ = got[w]
        port = ({k: np.asarray(v) for k, v in st._asdict().items()}, ex)
        ref = _ref_lane(cfg, w, n, seed)
        assert chk.compare(port, ref) == [], w
        hits += int(ref[0]["n_victima_hit"]) + int(ref[0]["n_nvictima_hit"])
    assert hits > 0 or not system.startswith("victima")


def test_tiny_dyn_views_equal_the_reference():
    """Ladder lanes on per-lane views of one maximal allocation equal
    the reference's systems of the members' own sizes."""
    from repro_torch.core import mmu
    from repro_torch.core.stages import SimConfig, dyn_of, stack_dyns
    from repro_torch.sim.systems import dyn_base_config

    base = dataclasses.replace(SimConfig(), **TINY)
    members = [base,
               dataclasses.replace(base, victima=True),
               dataclasses.replace(base, l2tlb_sets=2, l2tlb_ways=3,
                                   l2tlb_lat=17),
               dataclasses.replace(base, victima=True, l2_sets=8, l2_ways=3)]
    cfg = dataclasses.replace(dyn_base_config(members), l2tlb_sets=8,
                              l2_sets=128)
    n, seed, wls = 400, 11, ["bfs", "rnd"]
    gens = [ref_traces.generate(w, n, seed) for w in wls]
    traces = {k: np.stack([g[k] for g in gens], axis=1)
              for k in ("vpn", "is2m", "line")}
    traces["ipa"] = np.broadcast_to(
        np.asarray([g["ipa"] for g in gens], np.float32), (n, len(wls))).copy()
    per, extras = mmu.simulate_systems(
        cfg, stack_dyns([dyn_of(m) for m in members]), traces, device="cpu")
    for si, m in enumerate(members):
        for wi, w in enumerate(wls):
            port = ({k: np.asarray(v) for k, v in per[si][wi]._asdict().items()},
                    extras[si][wi])
            assert chk.compare(port, _ref_lane(_cfg_dict(m), w, n, seed)) == [], (
                si, w)


def test_changed_counter_or_lower_precision_sum_is_caught():
    cell = manifest.cell("native.victima-t4")
    cfg = system_config(cell.config, "victima")
    ref = _ref_lane(cfg, "rnd", 600, 5)
    assert chk.compare(ref, ref) == []
    for leaf in ("n_l2tlb_hit", "n_bg_ptw"):
        stats = dict(ref[0])
        stats[leaf] = np.int32(stats[leaf] + 1)
        assert chk.compare((stats, ref[1]), ref) == [f"stats.{leaf}"]
    hist = dict(ref[1])
    hist["hist_reuse_tlb"] = hist["hist_reuse_tlb"].copy()
    hist["hist_reuse_tlb"][3] += 1
    assert chk.compare((ref[0], hist), ref) == ["extras.hist_reuse_tlb"]
    low = _ref_lane(cfg, "rnd", 600, 5, "bfloat16")
    bad = chk.compare(low, ref)
    assert bad and all(b.startswith("stats.sum_") for b in bad)


def test_float_sum_is_sequential_float32():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 40000, 20000).astype(np.float32)
    acc = np.float32(0)
    for v in a:
        acc = np.float32(acc + v)
    assert ref_mmu.float_sum(a) == acc
    assert ref_mmu.float_sum(a, "bfloat16") != acc

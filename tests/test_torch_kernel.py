"""The mmu_step CUDA kernel against its plain PyTorch version.

The ``gpu`` tests need the card: they skip elsewhere with a reason, and
run on a machine with one through (jax is not needed there, hence
``--noconftest``)

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_kernel.py

Both paths start from the same zero state and the same numpy-made
traces, and every state leaf must be equal after the run.  The other
tests check, on CPU tensors, that the wrapper refuses what the kernel
does not take; they import no jax either.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import mmu
from repro_torch.core.stages import (SimConfig, default_stages, make_state,
                                     state_leaves)
from repro_torch.kernels import mmu_step
from repro_torch.sim import systems, trace_gen

# small structures: every flow (evictions, background walks, 2M pages,
# pressure, counter aliasing) within a few thousand accesses
TINY = dict(l2tlb_sets=4, l2tlb_ways=4, l1d4_sets=2, l1d4_ways=2,
            l1d2_sets=2, l1d2_ways=2, l2_sets=64, l2_ways=8, l3_sets=64,
            l3_ways=8, n_pages4=1 << 12, n_pages2=1 << 8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with -m gpu on a machine "
                    "that has one")
    return torch.device("cuda")


def mixed_traces(n: int, lanes: int, seed: int = 7) -> dict:
    """Per lane: half cyclic sweep, half random pages, 25% 2M-backed."""
    rng = np.random.default_rng(seed)
    cyc = np.tile(np.arange(512), n // 512 + 1)[:n]
    pages = np.where(rng.random((n, lanes)) < 0.5, cyc[:, None],
                     rng.integers(0, 4096, (n, lanes))).astype(np.int32)
    return {"vpn": pages, "is2m": rng.random((n, lanes)) < 0.25,
            "line": (pages * 64 + rng.integers(0, 64, (n, lanes))
                     ).astype(np.int32),
            "ipa": np.full((n, lanes), 3.0, np.float32)}


def workload_traces(names, n: int) -> dict:
    gens = trace_gen.generate_many(names, n=n, seed=0)
    tr = {k: np.stack([g["trace"][k] for g in gens], axis=1)
          for k in gens[0]["trace"]}
    tr["ipa"] = np.broadcast_to(np.asarray(
        [g["spec"].ipa for g in gens], np.float32), (n, len(gens))).copy()
    return tr


def run(cfg, traces, device, kernel: bool, block=None):
    """All state leaves after the run, as numpy."""
    names = default_stages(cfg)
    W = traces["vpn"].shape[1]
    st = make_state(cfg, W, device)
    tr = {k: torch.from_numpy(v).to(device) for k, v in traces.items()}
    if kernel:
        mmu_step.launch(st, tr, cfg, names, block)
    else:
        mmu_step.plain_scan(mmu.make_step(cfg, names), st, tr)
    torch.cuda.synchronize()
    return [x.cpu().numpy() for x in state_leaves(st)]


def assert_leaves_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and np.array_equal(x, y), i


@pytest.mark.gpu
@pytest.mark.parametrize("system", ["radix", "victima", "victima_agnostic",
                                    "victima_noptwcp"])
def test_kernel_matches_plain_on_small_structures(cuda, system):
    cfg = systems.get(system).config(SimConfig(**TINY))
    tr = mixed_traces(1500, 2)
    assert_leaves_equal(run(cfg, tr, cuda, kernel=False),
                        run(cfg, tr, cuda, kernel=True))


@pytest.mark.gpu
@pytest.mark.parametrize("system", ["radix", "victima"])
def test_kernel_matches_plain_at_table3(cuda, system):
    cfg = systems.config(system)
    tr = workload_traces(["rnd", "bc"], 300)
    assert_leaves_equal(run(cfg, tr, cuda, kernel=False),
                        run(cfg, tr, cuda, kernel=True))


# one system of each placement the registry reaches: everything in shared
# memory (Table 3), the L2 cache in device memory (8 MB), the L2 TLB in
# device memory (128k entries)
PLACED = {"radix": "shared", "victima": "shared",
          "victima_l2_8m": "l2_device", "radix_l2_8m": "l2_device",
          "l2tlb_128k": "l2tlb_device"}


@pytest.mark.gpu
@pytest.mark.parametrize("system", sorted(PLACED))
def test_kernel_matches_plain_in_every_placement(cuda, system):
    cfg = systems.config(system)
    tr = workload_traces(["rnd", "bc"], 1000)
    before = mmu_step.LAUNCHES_BY_PLACEMENT[PLACED[system]]
    got = run(cfg, tr, cuda, kernel=True)
    assert mmu_step.LAUNCHES_BY_PLACEMENT[PLACED[system]] == before + 1
    assert_leaves_equal(run(cfg, tr, cuda, kernel=False), got)


@pytest.mark.gpu
@pytest.mark.parametrize("system", ["victima", "victima_l2_8m"])
def test_state_survives_launch_boundaries_at_full_size(cuda, system):
    """97-row launches (each packs the L2 cache and its reuse shadow in
    and unpacks it out) equal one launch."""
    cfg = systems.config(system)
    tr = workload_traces(["rnd", "bc"], 600)
    assert_leaves_equal(run(cfg, tr, cuda, kernel=True),
                        run(cfg, tr, cuda, kernel=True, block=97))


@pytest.mark.gpu
def test_kernel_result_does_not_depend_on_block(cuda):
    cfg = systems.get("victima").config(SimConfig(**TINY))
    tr = mixed_traces(2000, 3)
    ref = run(cfg, tr, cuda, kernel=True)
    for block in (1, 333):
        assert_leaves_equal(ref, run(cfg, tr, cuda, kernel=True,
                                     block=block))


@pytest.mark.gpu
def test_launches_are_counted(cuda):
    cfg = SimConfig(**TINY)
    before = mmu_step.LAUNCHES
    run(cfg, mixed_traces(100, 1), cuda, kernel=True, block=30)
    assert mmu_step.LAUNCHES - before == 4
    stats, _ = mmu.simulate(cfg, {k: v[:, 0] for k, v in
                                  mixed_traces(100, 1).items()})
    assert mmu_step.LAUNCHES - before == 5
    assert int(stats.n_access) == 100


# ------------------------------------------ wrapper checks (on the CPU)

# every system the port simulates -> its placement; Table 3 takes 217,200
# bytes of shared memory, l2tlb_3k 231,024
WANT_PLACEMENT = {
    **dict.fromkeys(["radix", "victima", "victima_agnostic",
                     "victima_noptwcp", "l2tlb_3k", "victima_l2_1m",
                     "radix_l2_1m"], "shared"),
    **dict.fromkeys([f"l2tlb_{n}" for n in ("8k", "16k", "32k", "64k",
                                            "128k")]
                    + [f"l2tlb_{n}_real" for n in ("8k", "16k", "32k",
                                                   "64k")],
                    "l2tlb_device"),
    **dict.fromkeys(["victima_l2_4m", "radix_l2_4m", "victima_l2_8m",
                     "radix_l2_8m"], "l2_device")}


def test_placement_of_every_system():
    assert sorted(WANT_PLACEMENT) == sorted(systems.names())
    for name, want in WANT_PLACEMENT.items():
        pl = mmu_step.placement(systems.config(name))
        assert pl.name == want, name
        assert (pl.l2_shared, pl.l2tlb_shared) == mmu_step.PLACEMENTS[want]
        assert 0 < pl.smem_bytes <= mmu_step.SMEM_LIMIT == 232_448, name
    assert mmu_step.placement(systems.config("victima")).smem_bytes == 217_200
    assert mmu_step.placement(systems.config("l2tlb_3k")).smem_bytes == \
        231_024


def test_placement_is_a_function_of_the_geometry():
    assert mmu_step.placement(SimConfig(**TINY)).name == "shared"
    cfg = SimConfig(l2_sets=4096, l2tlb_sets=8192, l2tlb_ways=16)
    assert mmu_step.placement(cfg) == ("device", False, False, 6768)
    with pytest.raises(ValueError, match="L1 TLBs, PWCs and L1D"):
        mmu_step.placement(SimConfig(l1_sets=1 << 15))


def test_params_carry_the_placement():
    p = mmu_step._params(*cpu_args())
    assert (p.placement, p.l2_shared, p.l2tlb_shared, p.l2_pack) == \
        ("shared", 1, 1, None)
    assert p.smem_bytes == mmu_step.placement(SimConfig(**TINY)).smem_bytes
    cfg = SimConfig(**dict(TINY, l2_sets=1 << 14))
    p = mmu_step._params(*cpu_args(cfg))
    assert (p.placement, p.l2_shared) == ("l2_device", 0)
    assert p.scratch.shape == (2, 2, (1 << 14) * 8)
    assert p.l2_pack == p.scratch.data_ptr()


@pytest.mark.parametrize("system", ["radix", "victima", "victima_agnostic"])
def test_plain_run_keeps_what_the_packing_relies_on(system):
    """The kernel packs an L2 way's RRPV and block type into 2 bits each
    and its reuse count into a saturating byte read as min(reuse, 21):
    exact only while RRPV and btype lie in 0..3 and reuse is >= 0."""
    cfg = systems.get(system).config(SimConfig(**TINY))
    st = make_state(cfg, 2)
    tr = {k: torch.from_numpy(v) for k, v in mixed_traces(300, 2).items()}
    mmu_step.plain_scan(mmu.make_step(cfg, default_stages(cfg)), st, tr)
    l2 = st.hier.l2
    assert int(l2.valid.sum()) > 0 and int(l2.reuse.max()) > 0
    for leaf in (l2.rrpv, l2.btype):
        assert 0 <= int(leaf.min()) and int(leaf.max()) <= 3
    assert int(l2.reuse.min()) >= 0
    if cfg.victima:
        assert int(l2.btype.max()) > 0  # TLB blocks were inserted

def cpu_args(cfg=None, lanes=2, n=5):
    cfg = cfg or SimConfig(**TINY)
    st = make_state(cfg, lanes)
    tr = {k: torch.from_numpy(v) for k, v in mixed_traces(n, lanes).items()}
    return st, tr, cfg, default_stages(cfg)


def test_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        mmu_step.launch(*cpu_args())


def test_profiled_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        mmu_step.stage_cycles(*cpu_args())


def test_profiled_build_is_the_same_source_with_its_stamps():
    from repro_torch.kernels import build
    assert build.source("mmu_step_prof") == build.source("mmu_step")
    assert build.flags("mmu_step_prof") == \
        build.flags("mmu_step") + ("-DMMU_PROFILE",)
    assert "-fmad=false" in build.flags("mmu_step")
    assert build.library_path("mmu_step_prof") != \
        build.library_path("mmu_step")


def test_params_accept_a_consistent_state():
    p = mmu_step._params(*cpu_args())
    assert (p.lanes, p.l2.sets, p.l2.ways, p.pc4.n) == (2, 64, 8, 1 << 12)


@pytest.mark.parametrize("leaf", ["rrpv", "valid"])
def test_params_refuse_a_wrong_dtype(leaf):
    st, tr, cfg, names = cpu_args()
    l2 = st.hier.l2._replace(**{leaf: getattr(st.hier.l2, leaf).long()})
    st = st._replace(hier=st.hier._replace(l2=l2))
    with pytest.raises(TypeError, match=f"l2.{leaf}"):
        mmu_step._params(st, tr, cfg, names)


def test_params_refuse_a_wrong_shape():
    st, tr, cfg, names = cpu_args()
    tr["line"] = tr["line"][:, :1].contiguous()
    with pytest.raises(ValueError, match="trace\\['line'\\]"):
        mmu_step._params(st, tr, cfg, names)
    st, tr, cfg, names = cpu_args()
    with pytest.raises(ValueError, match="pc4.freq"):
        mmu_step._params(st._replace(pc4=st.pc4._replace(
            freq=st.pc4.freq[:, :8])), tr, cfg, names)


def test_params_refuse_non_contiguous_and_foreign_device():
    st, tr, cfg, names = cpu_args()
    tr["vpn"] = tr["vpn"].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        mmu_step._params(st, tr, cfg, names)
    st, tr, cfg, names = cpu_args()
    tr["ipa"] = tr["ipa"].to("meta")
    with pytest.raises(ValueError, match="is on meta"):
        mmu_step._params(st, tr, cfg, names)


def test_params_refuse_more_than_32_ways():
    cfg = SimConfig(**dict(TINY, l2_ways=64))
    with pytest.raises(ValueError, match="at most 32"):
        mmu_step._params(*cpu_args(cfg))


def test_params_refuse_other_compositions():
    st, tr, cfg, _ = cpu_args()
    with pytest.raises(ValueError, match="compositions"):
        mmu_step._params(st, tr, cfg, ("l1_tlb", "ptw"))
    with pytest.raises(ValueError, match="disagrees"):
        mmu_step._params(st, tr, cfg, ("l1_tlb", "l2_tlb", "victima", "ptw"))


def test_cpu_state_runs_the_plain_version_without_launching():
    st, tr, cfg, names = cpu_args(n=50)
    before = mmu_step.LAUNCHES
    step = mmu.make_step(cfg, names)
    mmu_step.blocked_scan(step, st, tr, cfg, names)
    assert mmu_step.LAUNCHES == before
    ref = make_state(cfg, 2)
    mmu_step.plain_scan(step, ref, tr)
    assert_leaves_equal([x.numpy() for x in state_leaves(ref)],
                        [x.numpy() for x in state_leaves(st)])
    assert int(st.stats.n_access[0]) == 50

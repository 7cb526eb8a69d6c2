"""MMU translation-pipeline driver (paper §§4-6, Table 3); port of
``repro.core.mmu``.

The translation path is a statically composed list of stages (see
``repro_torch.core.stages``): L1 TLB -> L2 TLB -> [Victima L2-cache
probe] -> [L3 TLB] -> [POM-TLB] -> radix or nested-paging (2-D) walker,
with Revelator's signature probe right after the L2 TLB and Utopia's
RestSeg probe right before the walker.  ``make_step`` folds the composition
into one per-access step over lane-batched state; ``scan_accesses`` runs
it over a trace through ``repro_torch.kernels.mmu_step.blocked_scan``,
which launches the hand-written CUDA kernel when the state lies on the
card and runs the step itself, access by access, when it lies on the CPU.

Three entry points share the step:
  simulate         — one (config, trace)
  simulate_batch   — one config, W workloads in lock-step (traces [T, W];
                     a multicore config's core lanes, [T, C])
  simulate_systems — S ladder members x W workloads in one scan: the
                     S x W grid flattened to S·W lanes, each with its own
                     ``Dyn`` geometry and stage gates; multicore traces
                     [T, W, C] flatten to S·W·C lanes, system-major

All run on ``device="cuda"`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ptwcp
from repro_torch.core.caches import BT_DATA, REUSE_BUCKETS, access_data
from repro_torch.core.stages import (Dyn, MMUState, Request, STAGES,
                                     SimConfig, Stats, WALK_HIST_BUCKETS,
                                     Feats, default_stages, dramc_of,
                                     fill_order, l2_geom_of, make_state,
                                     validate_stages)
from repro_torch.core.stages.fold import accum_stats, collect_feats
from repro_torch.kernels import mmu_step
from repro_torch.sim import parallel

__all__ = [
    "Dyn", "MMUState", "SimConfig", "Stats", "WALK_HIST_BUCKETS",
    "make_state", "make_step", "make_systems_runner", "resolve_device",
    "scan_accesses", "simulate", "simulate_batch", "simulate_systems",
]

# trace leaves the step reads, with their dtypes (``core``, the lane's
# core id, only in multiprogrammed-mix traces: ``trace_gen.generate_mix``)
TRACE_DTYPES = {"vpn": torch.int32, "is2m": torch.bool,
                "line": torch.int32, "ipa": torch.float32,
                "core": torch.int32}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another.  Raises when the card is asked for and absent (no
    silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version on the CPU")
    return dev


def make_step(cfg: SimConfig, stage_names=None, dyn: Dyn | None = None):
    """Build the per-access step for this configuration.

    ``step(state, access) -> state`` updates the lane-batched state in
    place.  ``access`` maps ``vpn`` (int32 4K-VPN), ``is2m`` (bool),
    ``line`` (int32 data line id) and ``ipa`` (float32 instructions per
    access) to ``[W]`` tensors.  `dyn` carries each lane's sizing and
    stage gates for ladder-batched runs (``[W]`` leaves on the state's
    device; `cfg` is then the ladder's maximal base config).
    """
    names = tuple(stage_names) if stage_names else default_stages(cfg)
    validate_stages(cfg, names)
    stages = [STAGES[n] for n in names]
    fills = [STAGES[n] for n in fill_order(names)]
    geom = l2_geom_of(dyn)  # the L2 cache's per-lane view (None = static)
    dramc = dramc_of(cfg, dyn)  # the DRAM-cache gate (None = absent)

    def step(st: MMUState, acc) -> MMUState:
        vpn, is2m, ipa = acc["vpn"], acc["is2m"], acc["ipa"]
        st.now.add_(1)
        now = st.now.clone()
        s0 = st.stats
        # both signals read the stats BEFORE this access, in float32
        instrs = s0.n_access.float().clamp_min(1.0) * ipa
        pressure = (s0.n_l2tlb_miss.float() * 1000.0
                    > cfg.pressure_mpki * instrs)
        l2_bypass = (st.hier.n_l2_miss.float() * 1000.0
                     >= cfg.bypass_l2mpki * instrs)
        vpn2 = vpn >> 9
        vpn_sz = torch.where(is2m, vpn2, vpn)
        req = Request(
            vpn=vpn, is2m=is2m, line=acc["line"], ipa=ipa, vpn2=vpn2,
            vpn_sz=vpn_sz, key2=(vpn_sz << 1) | is2m.int(), now=now,
            pressure=pressure, l2_bypass=l2_bypass, dyn=dyn,
        )

        # ---------------- lookup pass: fold the composition
        out: dict = {}
        need = torch.ones_like(is2m)
        trans = 0    # cycles up to and including the L2 TLB
        past_l2 = 0  # cycles past the L2 TLB (Fig 9/22/29)
        for stg in stages:
            st, res = stg.lookup(cfg, st, req, need)
            need = need & ~res.hit
            out[stg.name] = res._replace(need=need)
            if stg.past_l2:
                past_l2 = past_l2 + res.cycles
            else:
                trans = trans + res.cycles
        walk_res = out["_walk"] = out[names[-1]]

        # ---------------- fill pass: refills, learning, background walks
        for stg in fills:
            st = stg.fill(cfg, st, req, out)

        # shared-tier port contention (multicore only): an access past
        # the private L2 TLB waits its core's rotating arbitration slot,
        # a function of (core, now) alone, so core lanes stay independent
        if cfg.n_cores > 1:
            core = acc.get("core", 0)
            slot = (core + now) % cfg.n_cores
            past_l2 = past_l2 + (cfg.shared_port_cyc * slot
                                 * out["l2_tlb"].need.int())
        trans = trans + past_l2

        # ---------------- the data access itself
        _, dcyc = access_data(st.hier, req.line, now, pressure,
                              cfg.tlb_aware, cfg.lat, geom, dramc)
        accum_stats(st.stats, st, out, walk_res, trans, past_l2, dcyc)
        if cfg.collect:
            collect_feats(cfg, st, req, out, walk_res)
        return st

    return step


def scan_accesses(step, st0: MMUState, trace: dict, cfg: SimConfig,
                  stage_names, dyn: Dyn | None = None) -> MMUState:
    """Run the per-access ``step`` over ``trace`` (leaves ``[T, W]``).

    Updates ``st0`` in place and returns it.  The kernel wrapper picks
    the path from the state's device: the CUDA kernel on the card, the
    plain step on the CPU.  `dyn` is the step's per-lane ``Dyn``, which
    the kernel reads too.
    """
    return mmu_step.blocked_scan(step, st0, trace, cfg, stage_names, dyn)


def _final_hists(l2):
    """Fold still-resident blocks into the reuse histograms (blocks that
    were never evicted would otherwise be invisible to Figs. 11/24)."""
    lanes = l2.reuse.shape[0]
    bucket = l2.reuse.clamp_max(REUSE_BUCKETS - 1).reshape(lanes, -1).long()
    is_data = ((l2.btype == BT_DATA) & l2.valid).reshape(lanes, -1).int()
    is_tlb = ((l2.btype != BT_DATA) & l2.valid).reshape(lanes, -1).int()
    hd = l2.hist_reuse_data.clone().scatter_add_(1, bucket, is_data)
    ht = l2.hist_reuse_tlb.clone().scatter_add_(1, bucket, is_tlb)
    return hd, ht


def _finalize(st: MMUState, cfg: SimConfig):
    """The finished state as host numpy: (Stats, l2a, l2m, hd, ht, feats,
    pc4, shared) with a leading lane axis on every leaf (feats and pc4 are
    None unless ``cfg.collect``; shared is the L3 and DRAM-cache counters
    ``(n_l3_access, n_l3_trans, n_dramc_access, n_dramc_hit)``)."""
    hd, ht = _final_hists(st.hier.l2)

    def host(x):
        return x.cpu().numpy()

    h = st.hier
    stats = Stats(*[host(x) for x in st.stats])
    return (stats, host(h.n_l2_access), host(h.n_l2_miss),
            host(hd), host(ht),
            Feats(*[host(x) for x in st.feats]) if cfg.collect else None,
            ptwcp.PageCounters(*[host(x) for x in st.pc4])
            if cfg.collect else None,
            tuple(host(x) for x in (h.n_l3_access, h.n_l3_trans,
                                    h.n_dramc_access, h.n_dramc_hit)))


def _shared_tier_extras(cfg) -> bool:
    """Whether the shared-tier (L3 and DRAM-cache) counters go into the
    extras: single-core extras keep the reference's keys exactly."""
    return (cfg.n_cores > 1 or cfg.dram_cache_sets > 0
            or cfg.shared_tier_stats)


def _extras_of(cfg, l2a, l2m, hd, ht, feats, pc4, shared=None,
               index=lambda x: x) -> dict:
    e = {"l2_access": int(index(l2a)), "l2_miss": int(index(l2m)),
         "hist_reuse_data": np.asarray(index(hd)),
         "hist_reuse_tlb": np.asarray(index(ht))}
    if shared is not None and _shared_tier_extras(cfg):
        for k, x in zip(("l3_access", "l3_trans", "dramc_access",
                         "dramc_hit"), shared):
            e[k] = int(index(x))
    if cfg.collect:
        e["feats"] = type(feats)(*[np.asarray(index(x)) for x in feats])
        e["pc4"] = type(pc4)(*[np.asarray(index(x)) for x in pc4])
    return e


def _lane_trace(trace: dict, cfg: SimConfig, device, lanes: int | None):
    """Trace leaves as ``[T, W]`` tensors on `device` (``lanes=None``:
    one ``[T]`` trace, given one lane).  A missing ``ipa`` leaf takes
    ``cfg.ipa``, as in the reference, and ``core`` may be absent; other
    dtypes must match exactly."""
    out = {}
    for k, dtype in TRACE_DTYPES.items():
        if k not in trace:
            if k not in ("ipa", "core"):
                raise KeyError(f"trace has no {k!r} leaf")
            continue
        x = torch.tensor(np.asarray(trace[k]))
        if x.dtype != dtype:
            raise TypeError(f"trace leaf {k!r} is {x.dtype}, want {dtype}")
        out[k] = x
    shape = out["vpn"].shape
    if "ipa" not in out:
        out["ipa"] = torch.full(shape, cfg.ipa, dtype=torch.float32)
    want_nd = 1 if lanes is None else 2
    for k, x in out.items():
        if x.shape != shape or x.ndim != want_nd:
            raise ValueError(f"trace leaf {k!r} has shape "
                             f"{tuple(x.shape)}, want {want_nd}-d like "
                             f"vpn {tuple(shape)}")
    return {k: (x if lanes else x[:, None]).contiguous().to(device)
            for k, x in out.items()}


def simulate(cfg: SimConfig, trace: dict, stage_names=None, device=None,
             time_shards: int | None = None):
    """Run one trace under `cfg`; returns (Stats, extras) as numpy.

    ``time_shards > 1`` splits the trace's time axis into speculative
    blocks that run as lanes of one scan, resolved to the exact serial
    carry (``parallel.time_shard_scan``); the Stats equal the serial
    run's.
    """
    dev = resolve_device(device)
    names = tuple(stage_names) if stage_names else default_stages(cfg)
    step = make_step(cfg, names)
    tr = _lane_trace(trace, cfg, dev, None)
    st0 = make_state(cfg, 1, dev)
    t = int(time_shards or 1)
    if t > 1:
        st, _ = parallel.time_shard_scan(
            lambda s, trb: scan_accesses(step, s, trb, cfg, names),
            st0, tr, t)
    else:
        st = scan_accesses(step, st0, tr, cfg, names)
    stats, *rest = _finalize(st, cfg)
    return (Stats(*[x[0] for x in stats]),
            _extras_of(cfg, *rest, index=lambda x: x[0]))


def simulate_batch(cfg: SimConfig, traces: dict, stage_names=None,
                   device=None):
    """Run W workloads in lock-step: traces leaves are [T, W] (a
    multicore config's core lanes: ``trace_gen.generate_mix``'s [T, C]
    leaves, ``core`` among them).

    Returns (list of W Stats, list of W extras dicts), as numpy.
    """
    dev = resolve_device(device)
    names = tuple(stage_names) if stage_names else default_stages(cfg)
    step = make_step(cfg, names)
    tr = _lane_trace(traces, cfg, dev, lanes=True)
    W = tr["vpn"].shape[1]
    st = scan_accesses(step, make_state(cfg, W, dev), tr, cfg, names)
    stats, *rest = _finalize(st, cfg)
    per = [Stats(*[x[i] for x in stats]) for i in range(W)]
    extras = [_extras_of(cfg, *rest, index=lambda x, i=i: x[i])
              for i in range(W)]
    return per, extras


def make_systems_runner(cfg: SimConfig, stage_names=None, device=None,
                        plan=None, time_shards: int = 1):
    """A reusable S x W runner for one ladder base config.

    Returns ``run(dyns, traces) -> (per, extras)``: `dyns` has ``[S]``
    leaves (``sim.systems.ladder_dyn``), traces leaves are ``[T, W]``,
    shared by the systems.  A mesh block runs as S·W lanes, system-major
    (lane ``s * W + w``): each Dyn leaf repeated W times, the traces
    tiled S times.  ``per[s][w]`` is system s's Stats on workload w and
    ``extras[s][w]`` its extras, as numpy.  Multicore traces ``[T, W,
    C]`` (mixes stacked on axis 1) run as S·W·C lanes, lane ``(s * W +
    w) * C + c``, and ``per[s][w]`` and ``extras[s][w]`` are lists of C.

    `plan` (``parallel.plan_mesh`` for this S x W grid) spreads the grid
    over the visible cards (`device` repeated on the CPU), one block a
    mesh cell (``parallel.shard_wrap``); without
    one the grid runs on `device` alone.  ``time_shards > 1`` splits the
    trace's time axis into speculative blocks resolved to the exact
    serial carry (``parallel.time_shard_scan``, one scan of t·S·W lanes
    a round); it needs a 1x1 plan, as in the reference.  The runner
    records the last hand-off's info on ``run.last_time_shard_info``.
    """
    dev = resolve_device(device)
    names = tuple(stage_names) if stage_names else default_stages(cfg)
    t_shards = int(time_shards or 1)
    if t_shards > 1 and plan is not None \
            and plan.sys_dim * plan.wl_dim != 1:
        raise ValueError(
            f"time sharding needs a 1x1 ('sys', 'wl') plan (devices go "
            f"to the 't' mesh axis), got {plan.describe()}")

    def run_block(dyns: Dyn, traces: dict):
        # one mesh block, on its Dyn's device: outputs lead [S_b, W_b(, C)]
        bdev = dyns.l2tlb_lat.device
        S = dyns.l2tlb_lat.shape[0]
        vpn = np.asarray(traces["vpn"])
        W = vpn.shape[1]
        C = vpn.shape[2] if vpn.ndim == 3 else None
        if C is not None:  # core lanes ride the workload axis
            traces = {k: np.asarray(v).reshape((v.shape[0], W * C))
                      for k, v in traces.items()}
        tr = _lane_trace(traces, cfg, bdev, lanes=True)
        L = tr["vpn"].shape[1]
        tr = {k: x.repeat(1, S) for k, x in tr.items()}
        dyn = Dyn(*[x.to(bdev).repeat_interleave(L) for x in dyns])
        st0 = make_state(cfg, S * L, bdev)
        if t_shards > 1:
            def body(st, trb):
                # the blocks' lanes are block-major: tile the lane Dyn
                d = Dyn(*[x.repeat(st.now.shape[0] // (S * L))
                          for x in dyn])
                return scan_accesses(make_step(cfg, names, d), st, trb,
                                     cfg, names, d)

            st, info = parallel.time_shard_scan(body, st0, tr, t_shards)
            run.last_time_shard_info = info
        else:
            st = scan_accesses(make_step(cfg, names, dyn), st0, tr, cfg,
                               names, dyn)
        lead = (S, W) if C is None else (S, W, C)
        return parallel.tree_map(
            lambda x: x.reshape(lead + x.shape[1:]), _finalize(st, cfg))

    if plan is None:
        dispatch = run_block
    else:
        mesh_devices = None
        if dev.type != "cuda" or plan.n_devices == 1:
            mesh_devices = [dev] * plan.n_devices
        dispatch = parallel.shard_wrap(run_block, plan, mesh_devices)

    def run(dyns: Dyn, traces: dict):
        vpn = np.asarray(traces["vpn"])
        S, W = dyns.l2tlb_lat.shape[0], vpn.shape[1]
        C = vpn.shape[2] if vpn.ndim == 3 else None
        if plan is None:
            dyns = dyns.to(dev)
        stats, *rest = dispatch(dyns, traces)

        def lane(*ix):
            return (Stats(*[x[ix] for x in stats]),
                    _extras_of(cfg, *rest, index=lambda x: x[ix]))

        per = [[None] * W for _ in range(S)]
        extras = [[None] * W for _ in range(S)]
        for s in range(S):
            for w in range(W):
                if C is None:
                    per[s][w], extras[s][w] = lane(s, w)
                else:  # per-core lists
                    cores = [lane(s, w, c) for c in range(C)]
                    per[s][w] = [p for p, _ in cores]
                    extras[s][w] = [e for _, e in cores]
        return per, extras

    run.last_time_shard_info = None
    return run


def simulate_systems(cfg: SimConfig, dyns: Dyn, traces: dict,
                     stage_names=None, device=None, plan=None,
                     time_shards: int = 1):
    """Run S shape-compatible systems x W workloads in one scan.

    `cfg` is the ladder's base config (structures at the ladder maximum,
    every gated stage in its composition); `dyns` has ``[S]`` leaves of
    per-system sizing and gates; traces leaves are ``[T, W]``, or ``[T,
    W, C]`` for multicore mixes.  Returns (list[S] of list[W] Stats,
    extras likewise; per-core lists of C for mixes).  `plan` defaults,
    as in the reference, to ``parallel.plan_mesh(S, W)`` over the
    visible cards (1x1 on the CPU, and under ``time_shards > 1``).  The
    one-shot form of ``make_systems_runner``.
    """
    if plan is None:
        S = dyns.l2tlb_lat.shape[0]
        W = np.asarray(traces["vpn"]).shape[1]
        one = (int(time_shards or 1) > 1
               or resolve_device(device).type != "cuda")
        plan = parallel.plan_mesh(S, W, n_devices=1 if one else None)
    return make_systems_runner(cfg, stage_names, device, plan=plan,
                               time_shards=time_shards)(dyns, traces)

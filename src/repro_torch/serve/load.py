"""Serving load harness: production-traffic replay through lane-batched
engines; port of ``repro.serve.load``.

Replays open-loop request arrival traces — Poisson and bursty-diurnal,
request-length mixes drawn from the model shape configs
(``repro_torch.configs.base.SHAPES``) — through ``lanes`` independent
serving engines whose slot pools, KV page pools and VTCs ride a leading
lane axis, split over a 1-D ``("lane",)`` list of devices
(``sim.parallel.shard_lanes``; one card: one block).  A host-side
scheduler loop assigns arrivals to lanes/slots and drives one device
step per tick (admit → decode/translate → retire), under
``repro_torch.obs`` spans.

Observability contract (as in the reference): each run opens a
``serve.load_run`` span; every per-tick ``serve.decode_step`` span and
``serve.*`` count record is its descendant, and the run's SERVE_PERF
record is derived from the tracer's events by
``obs.report.serve_record`` — the same function the CLI applies to the
JSONL file, so ``python -m repro_torch.obs report TRACE --check
BENCH_serve.json`` is bit-exact.  Registry metrics are scoped per run
(``name[scope]``, see ``engine.scoped``).

``tune_gate`` fits the paper's PTW-CP comparator box on the port's
simulator features (``ptwcp_nn.fit_box``) and maps its lower edges onto
the engine's cluster-install gate.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.configs.base import SHAPES
from repro_torch.obs import names
from repro_torch.paged import block_table as btab
from repro_torch.serve import engine
from repro_torch.sim import parallel

# BENCH_serve records, one per completed run — appended ONLY via
# obs.report.serve_record, exactly like the reference's SERVE_PERF.
SERVE_PERF: list[dict] = []

# the records' timing fields: host-clock readings, different every run;
# every other field is a deterministic function of the inputs
TIMING_FIELDS = ("decode_p50_s", "decode_p99_s", "decode_mean_s", "wall_s",
                 "throughput_rps")


# ------------------------------------------------------- arrival traces

@dataclasses.dataclass(frozen=True)
class Request:
    arrive_tick: int
    prompt_blocks: int     # KV pages to prefill at admission
    decode_tokens: int     # decode ticks before the request finishes
    kind: str = ""         # shape-config name the length was drawn from


# shape-name → arrival weight: short train/chat-sized requests dominate,
# long-context requests are the rare tail — the mix that exercises both
# the TC (hot short contexts) and the cluster tier (block-dense long
# contexts)
MIX_WEIGHTS = {"train_4k": 0.45, "prefill_32k": 0.25,
               "decode_32k": 0.25, "long_500k": 0.05}


def length_mix(cfg: engine.EngineConfig, scale: int = 128):
    """(name, prompt_blocks, decode_tokens, weight) per shape config.

    Shape sequence lengths map to engine-sized page counts via
    ``seq_len / TOKENS_PER_PAGE / scale`` (clamped to the engine's
    per-request capacity); decode length scales with the shape kind.
    """
    cap = max(cfg.max_blocks_per_req - 1, 1)
    mix = []
    for name, sh in SHAPES.items():
        blocks = max(1, min(cap, sh.seq_len // btab.TOKENS_PER_PAGE // scale))
        decode = {"train": 4, "prefill": 6, "decode": 16}[sh.kind]
        mix.append((name, blocks, decode, MIX_WEIGHTS.get(name, 0.1)))
    return mix


def _mix_rng(mix, seed):
    p = np.asarray([m[3] for m in mix], np.float64)
    return np.random.default_rng(seed), p / p.sum()


def poisson_trace(rate: float, n_ticks: int,
                  cfg: engine.EngineConfig | None = None,
                  seed: int = 0, scale: int = 128) -> list[Request]:
    """Open-loop Poisson arrivals at ``rate`` requests/tick."""
    cfg = cfg or engine.EngineConfig()
    mix = length_mix(cfg, scale)
    rng, p = _mix_rng(mix, seed)
    out: list[Request] = []
    for t in range(n_ticks):
        for _ in range(rng.poisson(rate)):
            name, blocks, decode, _w = mix[rng.choice(len(mix), p=p)]
            out.append(Request(t, blocks, decode, name))
    return out


def diurnal_trace(rate: float, n_ticks: int,
                  cfg: engine.EngineConfig | None = None,
                  seed: int = 0, scale: int = 128,
                  period: int | None = None,
                  burst: float = 3.0, burst_prob: float = 0.02,
                  burst_len: int = 8) -> list[Request]:
    """Bursty diurnal arrivals: a sinusoidal day/night envelope over the
    base ``rate`` plus random ``burst``× spikes a few ticks long — the
    open-loop worst case that actually exhausts the page pool."""
    cfg = cfg or engine.EngineConfig()
    mix = length_mix(cfg, scale)
    rng, p = _mix_rng(mix, seed)
    period = period or max(n_ticks, 2)
    out: list[Request] = []
    burst_left = 0
    for t in range(n_ticks):
        envelope = 0.25 + 0.75 * (1 + np.sin(2 * np.pi * t / period)) / 2
        if burst_left == 0 and rng.random() < burst_prob:
            burst_left = burst_len
        lam = rate * envelope * (burst if burst_left > 0 else 1.0)
        burst_left = max(burst_left - 1, 0)
        for _ in range(rng.poisson(lam)):
            name, blocks, decode, _w = mix[rng.choice(len(mix), p=p)]
            out.append(Request(t, blocks, decode, name))
    return out


# --------------------------------------------------------- the harness

def _count(name: str, n: int, scope: str | None) -> None:
    """Scoped registry bump + base-name trace count record (per-run
    isolation in the trace comes from span parentage)."""
    if n:
        obs.REGISTRY.inc(engine.scoped(name, scope), n)
        obs.tracer().count(name, n)


def run_load(requests: list[Request],
             cfg: engine.EngineConfig | None = None,
             lanes: int = 1,
             run: str = "serve",
             arrival: str = "poisson",
             rate: float = 0.0,
             drain_ticks: int = 512,
             scope: str | None = None,
             device=None, tick_hook=None) -> dict:
    """Replay an arrival trace through ``lanes`` engines on `device`
    (default: the card).

    Arrivals are assigned to lanes round-robin; within a lane the host
    scheduler keeps a FIFO queue, maps queued requests onto free slots,
    and drives one device step per tick:

        admit_where → decode_translate → retire_where

    over the whole ``[lanes, ...]`` engine state (split over the visible
    cards by ``parallel.shard_lanes``).  Admissions the engine
    rejects (page pool exhausted) re-queue at the back and count into
    ``serve.pool_exhausted``.  After the last arrival the loop drains
    in-flight work for at most ``drain_ticks`` extra ticks.
    ``tick_hook(t, replay)``, when given, is called before tick ``t``'s
    step, outside its timing: ``replay()`` runs that tick's step on a
    copy of the state and returns the copy, leaving the run untouched
    (to profile a tick of the run without slowing the timed one).

    Returns the derived BENCH_serve record (also appended to
    :data:`SERVE_PERF`).
    """
    cfg = cfg or engine.EngineConfig()
    scope = scope or run
    gate = (cfg.gate_freq_min, cfg.gate_cost_min)
    n_slots = cfg.n_slots
    tr = obs.tracer()

    st = engine.init(cfg, lanes, device)
    dev = st.slot_len.device

    def lane_step(s, admit_blocks, targets):
        s, oks = engine.admit_where(s, admit_blocks)
        s, _phys, _src = engine.decode_translate(s, cfg)
        ret = s.slot_live & (targets > 0) & (s.slot_len >= targets)
        s, n_inval = engine.retire_where(s, ret)
        return s, oks, ret, n_inval

    step = parallel.shard_lanes(lane_step, lanes)

    # one warm-up tick on a COPY, outside the run span, so the p99 tail
    # reflects steady-state ticks, not first-call costs
    zeros = torch.zeros((lanes, n_slots), dtype=torch.int32, device=dev)
    step(engine.clone(st), zeros, zeros)
    engine.sync(dev)

    # host-side scheduler mirrors (updated from fetched step outputs)
    queues = [collections.deque() for _ in range(lanes)]
    free_slots = [set(range(n_slots)) for _ in range(lanes)]
    inflight: list[list] = [[None] * n_slots for _ in range(lanes)]
    targets_h = np.zeros((lanes, n_slots), np.int32)

    by_tick: dict[int, list] = {}
    for i, r in enumerate(requests):
        by_tick.setdefault(r.arrive_tick, []).append((i % lanes, r))
    last_tick = max((r.arrive_tick for r in requests), default=0)
    n_arr = len(requests)
    done = 0
    t = 0

    n_devices = (torch.cuda.device_count() if dev.type == "cuda" else 1)
    with obs.span(names.SPAN_SERVE_RUN, run=run, arrival=arrival,
                  rate=rate, lanes=lanes, mesh=step.mesh_dim,
                  devices=n_devices, n_slots=n_slots,
                  n_pool_pages=cfg.n_pool_pages,
                  gate=list(gate)) as run_span:
        while t <= last_tick or (done < n_arr and
                                 t <= last_tick + drain_ticks):
            for lane, r in by_tick.get(t, ()):
                queues[lane].append((r, t))
            admit_blocks = np.zeros((lanes, n_slots), np.int32)
            attempt: list[list] = [[None] * n_slots for _ in range(lanes)]
            for ln in range(lanes):
                while queues[ln] and free_slots[ln]:
                    slot = min(free_slots[ln])       # deterministic pick
                    free_slots[ln].remove(slot)
                    req, at = queues[ln].popleft()
                    attempt[ln][slot] = (req, at)
                    admit_blocks[ln, slot] = req.prompt_blocks
                    targets_h[ln, slot] = (
                        req.prompt_blocks * btab.TOKENS_PER_PAGE
                        + req.decode_tokens)

            if tick_hook is not None:
                def replay(s=st, a=admit_blocks, g=targets_h.copy()):
                    return step(engine.clone(s), torch.from_numpy(a).to(dev),
                                torch.from_numpy(g).to(dev))[0]
                tick_hook(t, replay)
            with obs.span(names.SPAN_DECODE_STEP):
                t0 = time.perf_counter()
                st, oks, rets, n_inval = step(
                    st, torch.from_numpy(admit_blocks).to(dev),
                    torch.from_numpy(targets_h).to(dev))
                engine.sync(dev)
                obs.observe(engine.scoped(names.HIST_DECODE_STEP_S, scope),
                            time.perf_counter() - t0)
            obs.REGISTRY.inc(engine.scoped(names.CTR_DECODE_STEPS, scope))

            oks_h = oks.cpu().numpy()
            rets_h = rets.cpu().numpy()
            n_adm = n_rej = n_ret = 0
            for ln in range(lanes):
                for sl in range(n_slots):
                    a = attempt[ln][sl]
                    if a is not None:
                        if oks_h[ln, sl]:
                            inflight[ln][sl] = a
                            n_adm += 1
                        else:
                            # pool exhausted: nothing was allocated —
                            # re-queue at the back, slot stays free
                            queues[ln].append(a)
                            free_slots[ln].add(sl)
                            targets_h[ln, sl] = 0
                            n_rej += 1
                    if rets_h[ln, sl]:
                        req, at = inflight[ln][sl]
                        inflight[ln][sl] = None
                        free_slots[ln].add(sl)
                        targets_h[ln, sl] = 0
                        obs.observe(
                            engine.scoped(names.HIST_REQ_TICKS, scope),
                            t - at + 1)
                        n_ret += 1
                        done += 1
            _count(names.CTR_REQS_ADMITTED, n_adm, scope)
            _count(names.CTR_POOL_EXHAUSTED, n_rej, scope)
            _count(names.CTR_REQS_RETIRED, n_ret, scope)
            _count(names.CTR_VTC_INVALIDATE, int(n_inval.sum()), scope)
            t += 1

        # run-level attrs the record derives via `attr` sources: summed
        # over lanes from the FINAL state (host ints)
        hit_tc = int(st.vtc.n_hit_tc.sum())
        hit_cl = int(st.vtc.n_hit_cluster.sum())
        walks = int(st.vtc.n_walk.sum())
        pool_stall = int(st.n_pool_stall.sum())
        run_span.set(n_ticks=t, n_arrivals=n_arr, pool_stall=pool_stall,
                     vtc_hit_tc=hit_tc, vtc_hit_cluster=hit_cl,
                     vtc_walk=walks)
        obs.REGISTRY.inc_to(
            engine.scoped(names.CTR_VTC_HIT_TC, scope), hit_tc)
        obs.REGISTRY.inc_to(
            engine.scoped(names.CTR_VTC_HIT_CLUSTER, scope), hit_cl)
        obs.REGISTRY.inc_to(
            engine.scoped(names.CTR_VTC_WALK, scope), walks)
        obs.REGISTRY.inc_to(
            engine.scoped(names.CTR_POOL_EXHAUSTED, scope), pool_stall)

    rec = obs.report.serve_record(tr.events, run_span.id, tr.path)
    SERVE_PERF.append(rec)
    return rec


# ----------------------------------------------------- PTW-CP gate tuning

def tune_gate(workloads=("bc", "xs"), n: int = 20_000,
              device=None) -> tuple[int, int]:
    """Tune the engine's cluster-install gate from the simulator's PTW-CP.

    Runs the port's collect-mode radix system over ``workloads``
    (``sim.runner.run_batch``, on `device`, default the card), refits
    the paper's comparator box on the collected (freq, cost) features
    (``ptwcp_nn.fit_box``, exhaustive F1 search), and maps the box's
    LOWER edges onto the serving gate ``(gate_freq_min, gate_cost_min)``.
    Only the lower edges transfer: the engine's per-leaf-row counters
    are lifetime-saturating, so the box's upper bounds would exclude
    every hot row once its counter saturates.
    """
    from repro_torch.core import ptwcp_nn
    from repro_torch.sim import runner
    out = runner.run_batch("radix_collect", workloads=list(workloads), n=n,
                           device=device)
    X, y = ptwcp_nn.build_dataset([out[w][1] for w in workloads])
    clo, _chi, flo, _fhi = ptwcp_nn.fit_box(X, y)
    return (min(int(flo), 7), min(int(clo), 15))

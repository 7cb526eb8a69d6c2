"""The span/event/metric taxonomy — every name the repo emits, declared.

The port's copy of ``repro.obs.names``: the names are identical, so a
trace of the port reads like the reference's.

Records are free-form (any name string is accepted), but the
*pipeline* instrumentation emits only names declared here, so every
``BENCH_sweep`` and ``BENCH_serve`` field derives from the trace:
``report.FIELD_SOURCES`` and ``report.SERVE_FIELD_SOURCES`` map each
record field to a span/event/attr source named here (the reference's
OB001 analyzer pass checks the same tables in ``repro.obs``).

Span taxonomy (docs/architecture.md, "Observability"):

  ladder_fill                 one ``runner.run_ladder`` fill (the unit
  | batch_fill                BENCH_sweep records); all other sweep
                              spans/events are its descendants.  The
                              port's ``runner.run_batch`` roots the same
                              tree at ``batch_fill`` (attrs system,
                              n_workloads, sim_n, backend), with one
                              chunk_wait and one dispatch
  ├─ trace_gen                one workload's trace generation, opened ON
  │                           the producer-pool worker thread with an
  │                           explicit ``parent=`` handle — producer-side
  │                           TRUE generation time
  ├─ chunk_wait               consumer-side wait for a chunk's traces
  │                           (generation NOT hidden behind simulation —
  │                           the legacy ``trace_gen_wall_s`` semantics;
  │                           in run_batch all of ``generate_many``)
  ├─ dispatch                 one compiled shard_map call over an
  │                           [S, chunk] block (+ host device_get); in
  │                           the port one call into ``core.mmu``, whose
  │                           three phases are its children:
  │   ├─ stage                the traces stacked, made host tensors,
  │   │                       copied to the device and tiled over the
  │   │                       ladder's lanes
  │   ├─ scan                 the state made, the kernel's parameters,
  │   │                       its launches and one stream synchronize
  │   │                       (attrs lanes, padded_lanes, accesses,
  │   │                       launches); nothing is left queued after it
  │   ├─ fold                 the finished state copied back and split
  │   │                       into each lane's Stats and extras (host
  │   │                       work only: the scan's synchronize waited)
  │   └─ time_shard_round     (event) one speculative hand-off round of
  │                           ``parallel.time_shard_scan``, with the
  │                           exact-known prefix after the round
  ├─ xla_compile              (event) in the port: one kernel library
  │                           built or loaded by ``kernels.build.load``
  │                           (the reference's jit-cache miss; the name
  │                           is kept), carrying the library's name
  ├─ pallas_kernel            (event, trace-time) a ``blocked_scan``
  │                           kernel build: block size, grid, interpret
  └─ device_memory            (event) each card's memory stats
                              (``torch.cuda.memory_stats``, emitted by
                              ``obs.torchprof`` at the end of a fill
                              that ran on the card)

  serve.decode_step           one timed serving decode tick
                              (``serve.engine.decode_step``)

  serve.load_run              one serving load-harness run (the unit
                              BENCH_serve records); its descendants are
                              the per-tick ``serve.decode_step`` spans
                              and ``serve.*`` count events, so every
                              BENCH_serve field re-derives from the
                              run's subtree alone (OB001, schema-5
                              discipline)

Counters the simulator bumps (``emit=True``, so ``report.rollup`` sums
them from the trace): ``sim_cache.hit`` / ``sim_cache.miss``, once for
each cell ``runner`` looks up in its result cache (only with
``cache=True``), and ``sim_cache.store``, once for each entry it writes.
"""
from __future__ import annotations

# ------------------------------------------------------------- spans
SPAN_LADDER_FILL = "ladder_fill"
SPAN_TRACE_GEN = "trace_gen"
SPAN_CHUNK_WAIT = "chunk_wait"
SPAN_DISPATCH = "dispatch"
SPAN_DECODE_STEP = "serve.decode_step"
SPAN_SERVE_RUN = "serve.load_run"

SPAN_NAMES = (SPAN_LADDER_FILL, SPAN_TRACE_GEN, SPAN_CHUNK_WAIT,
              SPAN_DISPATCH, SPAN_DECODE_STEP, SPAN_SERVE_RUN)

# the port's own spans: the reference emits none of them, so they stay
# out of SPAN_NAMES, which must equal the reference's
SPAN_BATCH_FILL = "batch_fill"
SPAN_STAGE = "stage"
SPAN_SCAN = "scan"
SPAN_FOLD = "fold"

PORT_SPAN_NAMES = (SPAN_BATCH_FILL, SPAN_STAGE, SPAN_SCAN, SPAN_FOLD)

# ------------------------------------------------------------ events
EV_COMPILE = "xla_compile"
EV_TIME_SHARD_ROUND = "time_shard_round"
EV_PALLAS_KERNEL = "pallas_kernel"
EV_DEVICE_MEMORY = "device_memory"

EVENT_NAMES = (EV_COMPILE, EV_TIME_SHARD_ROUND, EV_PALLAS_KERNEL,
               EV_DEVICE_MEMORY)

# ------------------------------------------- counters / gauges / hists
CTR_SIM_CACHE_HIT = "sim_cache.hit"
CTR_SIM_CACHE_MISS = "sim_cache.miss"
CTR_SIM_CACHE_STORE = "sim_cache.store"
CTR_VTC_HIT_TC = "serve.vtc.hit_tc"
CTR_VTC_HIT_CLUSTER = "serve.vtc.hit_cluster"
CTR_VTC_WALK = "serve.vtc.walk"
CTR_VTC_INVALIDATE = "serve.vtc.invalidate"
CTR_DECODE_STEPS = "serve.decode_steps"
CTR_REQS_ADMITTED = "serve.admitted"
CTR_REQS_RETIRED = "serve.retired"
CTR_POOL_EXHAUSTED = "serve.pool_exhausted"

GAUGE_PAGES_FREE = "serve.pages_free"
GAUGE_SLOT_OCCUPANCY = "serve.slot_occupancy"

HIST_DECODE_STEP_S = "serve.decode_step_s"
HIST_REQ_TICKS = "serve.req_ticks"

COUNTER_NAMES = (CTR_SIM_CACHE_HIT, CTR_SIM_CACHE_MISS,
                 CTR_SIM_CACHE_STORE, CTR_VTC_HIT_TC, CTR_VTC_HIT_CLUSTER,
                 CTR_VTC_WALK, CTR_VTC_INVALIDATE, CTR_DECODE_STEPS,
                 CTR_REQS_ADMITTED, CTR_REQS_RETIRED, CTR_POOL_EXHAUSTED)
GAUGE_NAMES = (GAUGE_PAGES_FREE, GAUGE_SLOT_OCCUPANCY)
HIST_NAMES = (HIST_DECODE_STEP_S, HIST_REQ_TICKS)

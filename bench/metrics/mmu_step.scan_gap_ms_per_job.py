"""mmu_step.scan_gap_ms_per_job: per job, the time inside the program's
scan spans in which no mmu_step kernel ran on the card (the state made,
the kernel's parameters checked, the gaps between launches, the
synchronize's wake-up), in ms: the spans are put on the profiler
trace's clock by the job's offset.  Moves sim_accesses_per_s."""
from bench.lib import devtrace, spans


def read(ctx):
    busy = devtrace.kernel_busy(ctx.device)

    def gap_s(job, scans):
        return 1e-6 * sum(
            (b - a) - devtrace.length(devtrace.clip(busy, a, b))
            for a, b in devtrace.union(spans.on_trace_clock(job, e)
                                       for e in scans))

    return spans.ms_per_job(ctx, "scan", gap_s)

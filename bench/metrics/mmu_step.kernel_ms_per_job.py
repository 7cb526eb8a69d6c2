"""mmu_step.kernel_ms_per_job: the scan kernel's device time per job, in
ms, from the profiler's trace (the window's time in which a kernel named
mmu_step_kernel ran).  Moves sim_accesses_per_s."""
from bench.lib import devtrace


def read(ctx):
    if not ctx.jobs:
        return None
    us = devtrace.kernel_us(ctx.device, *ctx.window)
    if us <= 0:
        return None
    return us / len(ctx.jobs) / 1e3

"""mmu_step.roofline_pct: the scan's least time over its device time,
in %: the jobs' floors (bench.lib.roofline: the larger of the bytes term
and the slowest lane's dependent rounds at 14.5 ns, counted from the
simulated statistics and the shapes alone) summed over the window's
jobs, over the window's time in which an mmu_step kernel ran.  Moves
sim_accesses_per_s."""
from bench.lib import devtrace


def read(ctx):
    us = devtrace.kernel_us(ctx.device, *ctx.window)
    if not ctx.jobs or us <= 0:
        return None
    return 100.0 * sum(j["floor"]["floor_s"] for j in ctx.jobs) / (us * 1e-6)

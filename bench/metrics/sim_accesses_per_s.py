"""sim_accesses_per_s: lane-accesses simulated per second of host time
(systems x workloads x trace length of every job completed in the
window, over the window's seconds on the host clock)."""


def read(ctx):
    if not ctx.jobs or ctx.window_s <= 0:
        return None
    return sum(j["work"] for j in ctx.jobs) / ctx.window_s

"""runner.host_gap_ms_per_job: per job, its wall time on the host clock
less the time inside it in which the scan kernel ran, in ms: the host
work (trace generation, stacking and copies, the fold into Stats) that
the card does not hide.  Moves sim_accesses_per_s."""
from bench.lib import devtrace


def read(ctx):
    if not ctx.jobs:
        return None
    gap_us = [(j["t1"] - j["t0"]) - devtrace.kernel_us(ctx.device, j["t0"],
                                                        j["t1"])
              for j in ctx.jobs]
    return sum(gap_us) / len(gap_us) / 1e3

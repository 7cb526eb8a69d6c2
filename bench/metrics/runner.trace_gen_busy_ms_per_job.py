"""runner.trace_gen_busy_ms_per_job: per job, the wall time in which at
least one of its trace_gen spans (one workload's generation, on a pool
thread) was open: the union of their intervals, not the sum of the
threads' time, in ms.  Moves sim_accesses_per_s."""
from bench.lib import spans


def read(ctx):
    return spans.union_ms_per_job(ctx, "trace_gen")

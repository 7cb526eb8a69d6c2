"""runner.trace_wait_ms_per_job: per job, the sum of the program's
chunk_wait spans (the dispatching thread waiting for traces: in
run_batch the whole of their generation, in run_ladder what the
previous chunk's scan does not hide), in ms.  Moves sim_accesses_per_s."""
from bench.lib import spans


def read(ctx):
    return spans.sum_ms_per_job(ctx, "chunk_wait")

"""runner.chunk_wait_ms_per_job: per job, the sum of run_ladder's
chunk_wait spans (the dispatch waiting on the trace generator's pool),
in ms; nothing to read in a cell whose jobs are not ladder fills.
Moves sim_accesses_per_s."""


def read(ctx):
    waits = [j["chunk_wait_s"] for j in ctx.jobs]
    if not waits or any(w is None for w in waits):
        return None
    return sum(waits) / len(waits) * 1e3

"""runner.stage_ms_per_job: per job, the sum of the program's stage
spans (the traces stacked, made host tensors, copied to the card and
tiled over the ladder's lanes), in ms.  Moves sim_accesses_per_s."""
from bench.lib import spans


def read(ctx):
    return spans.sum_ms_per_job(ctx, "stage")

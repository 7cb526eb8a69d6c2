"""runner.fold_ms_per_job: per job, the sum of the program's fold spans
(the finished state copied back and split into each lane's Stats and
extras, after the scan's synchronize), in ms.  Moves
sim_accesses_per_s."""
from bench.lib import spans


def read(ctx):
    return spans.sum_ms_per_job(ctx, "fold")

"""device.idle_pct: the share of the traced window in which no kernel,
copy or set ran on the card, in %.  Moves sim_accesses_per_s."""
from bench.lib import devtrace


def read(ctx):
    lo, hi = ctx.window
    if hi <= lo:
        return None
    busy = devtrace.length(devtrace.clip(
        devtrace.union((a, b) for _n, a, b in ctx.device), lo, hi))
    return 100.0 * (1.0 - busy / (hi - lo))

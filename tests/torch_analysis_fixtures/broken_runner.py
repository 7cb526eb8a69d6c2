"""A ladder fill that hand-assembles its LADDER_PERF record (OB001)."""
LADDER_PERF: list = []


def run_ladder(ladder, n):
    LADDER_PERF.append({"ladder": ladder, "sim_n": n})  # OB001

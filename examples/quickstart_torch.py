"""Quickstart on the PyTorch/CUDA port: the Victima mechanism on one
workload, printing the same metrics as examples/quickstart.py.

Runs the trace-driven simulator under the baseline Radix system and
under Victima, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/quickstart_torch.py [--workload rnd] \
        [-n 40000] [--device cpu]
"""
import argparse

from repro_torch.core import metrics, timing
from repro_torch.sim.runner import run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="rnd")
    ap.add_argument("-n", type=int, default=40_000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()

    print(f"simulating '{args.workload}' ({args.n} accesses)…")
    base, bex, spec = run("radix", args.workload, n=args.n,
                          device=args.device)
    vic, vex, _ = run("victima", args.workload, n=args.n,
                      device=args.device)

    print(f"\n=== {args.workload} (ipa={spec.ipa}) ===")
    print(f"L2 TLB MPKI            {metrics.l2tlb_mpki(base, spec.ipa):8.1f}")
    print(f"avg PTW latency        {metrics.avg_walk_cycles(base):8.0f} cyc")
    print(f"translation cycles     "
          f"{timing.translation_fraction(base, spec.ipa)*100:7.1f} %")
    print("--- Victima ---")
    print(f"PTW reduction          "
          f"{metrics.ptw_reduction(base, vic)*100:7.1f} %  (paper avg 50%)")
    print(f"L2-cache TLB-block hits{int(vic.n_victima_hit):8d}")
    print(f"L2TLB miss lat         "
          f"{metrics.avg_l2tlb_miss_latency(base):5.0f} -> "
          f"{metrics.avg_l2tlb_miss_latency(vic):5.0f} cyc")
    print(f"translation reach      "
          f"{metrics.translation_reach_mb(vic):8.0f} MB (paper 220 MB)")
    print(f"end-to-end speedup     "
          f"{(timing.speedup(base, vic, spec.ipa)-1)*100:7.1f} %")


if __name__ == "__main__":
    main()

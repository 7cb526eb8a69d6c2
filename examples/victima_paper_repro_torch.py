"""Reproduce the paper's headline results end to end (native + virt) on
the PyTorch/CUDA port, then, with ``--tables``, every paper table of
``repro_torch.sim.paper``.

Runs the evaluated systems on the workloads (all 11 by default; results
cached on disk by ``repro_torch.sim.runner`` are reused) on the card
unless ``--device cpu`` is given, and prints a side-by-side against the
paper's reported numbers.

    PYTHONPATH=src python examples/victima_paper_repro_torch.py \
        [-n 150000] [--workloads bc,rnd] [--device cpu] [--tables]
"""
import argparse
import time

import numpy as np

from repro_torch.core import metrics, timing
from repro_torch.sim import paper, trace_gen
from repro_torch.sim.runner import run_batch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=paper.N)
    ap.add_argument("--workloads", default=None,
                    help="comma-separated subset (default: all 11)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--tables", action="store_true",
                    help="also print every paper table (repro_torch.sim."
                         "paper.ALL)")
    args = ap.parse_args()
    wls = (args.workloads.split(",") if args.workloads
           else trace_gen.all_workloads())

    def get(name):
        return run_batch(name, workloads=wls, n=args.n, device=args.device)

    def gmean_speedup(base, new):
        sp = [timing.speedup(base[w][0], new[w][0], base[w][2].ipa)
              for w in wls]
        return float(np.exp(np.mean(np.log(sp))))

    print("== native execution ==")
    radix, vic, pom, l2128 = (get(s) for s in ("radix", "victima", "pom",
                                               "l2tlb_128k"))
    rows = [
        ("Victima vs Radix", gmean_speedup(radix, vic), "+7.4%"),
        ("Victima vs POM-TLB", gmean_speedup(pom, vic), "+6.2%"),
        ("Victima vs Opt.L2TLB-128K", gmean_speedup(l2128, vic), "≈ +0.3%"),
    ]
    for name, sp, ref in rows:
        print(f"  {name:28s} {(sp-1)*100:+6.1f}%   (paper {ref})")
    red = np.mean([metrics.ptw_reduction(radix[w][0], vic[w][0])
                   for w in wls])
    print(f"  {'PTW reduction':28s} {red*100:6.1f}%   (paper 50%)")
    reach = np.mean([metrics.translation_reach_mb(vic[w][0]) for w in wls])
    print(f"  {'translation reach':28s} {reach:6.0f}MB   (paper 220MB)")

    print("== virtualized execution (nested paging) ==")
    npg, vvirt, isp, pomv = (get(s) for s in ("np", "victima_virt", "isp",
                                              "pom_virt"))
    rows = [
        ("Victima vs NP", gmean_speedup(npg, vvirt), "+28.7%"),
        ("Victima vs POM-TLB", gmean_speedup(pomv, vvirt), "+20.1%"),
        ("Victima vs Ideal-SP", gmean_speedup(isp, vvirt), "+4.9%"),
    ]
    for name, sp, ref in rows:
        print(f"  {name:28s} {(sp-1)*100:+6.1f}%   (paper {ref})")
    h = np.mean([1 - float(vvirt[w][0].n_host_ptw)
                 / max(float(npg[w][0].n_host_ptw), 1) for w in wls])
    g = np.mean([metrics.ptw_reduction(npg[w][0], vvirt[w][0]) for w in wls])
    print(f"  {'guest PTW reduction':28s} {g*100:6.1f}%   (paper 50%)")
    print(f"  {'host PTW reduction':28s} {h*100:6.1f}%   (paper 99%)")

    if args.tables:
        print("== paper tables ==")
        for fig in paper.ALL:
            t0 = time.perf_counter()
            rows = fig(workloads=wls, n=args.n, device=args.device)
            for name, us, derived in rows:
                print(f"  {name:40s} {derived}   ({us:.3f} us/access)")
            print(f"  [{fig.__name__}: {time.perf_counter() - t0:.2f} s]")


if __name__ == "__main__":
    main()

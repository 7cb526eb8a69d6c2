"""Batched serving with the Victima Translation Cache, on the PyTorch/CUDA
port; mirrors examples/serve_paged.py.

Drives the paged-KV engine through a request storm: admissions, lock-step
decode (translations through TC → cluster pages → radix walk), retirement
shootdowns — and prints the translation-path mix.  Runs on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/serve_paged_torch.py --ticks 200 \
        [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.serve import engine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()

    cfg = engine.EngineConfig(n_slots=args.slots, max_blocks_per_req=32,
                              n_pool_pages=1024, n_leaf_rows=128,
                              tc_sets=8, tc_ways=2, n_clusters=128)
    st = engine.init(cfg, device=args.device)
    rng = np.random.default_rng(0)
    for s in range(args.slots):
        st, _ok = engine.admit(st, s, int(rng.integers(1, 6)))

    lifetimes = rng.integers(40, 160, size=args.slots)
    ages = np.zeros(args.slots, int)
    n_served = args.slots
    for t in range(args.ticks):
        st, phys, src = engine.decode_translate(st, cfg)
        ages += 1
        for s in range(args.slots):
            if ages[s] >= lifetimes[s]:
                # retire + admit a fresh request (continuous batching)
                st = engine.retire(st, s)
                st, _ok = engine.admit(st, s, int(rng.integers(1, 6)))
                ages[s] = 0
                lifetimes[s] = int(rng.integers(40, 160))
                n_served += 1
        if (t + 1) % 50 == 0:
            m = engine.stats(st)
            print(f"tick {t+1:4d}  served={n_served:3d}  "
                  f"TC {m['tc_hit_rate']*100:5.1f}%  "
                  f"cluster {m['cluster_hit_rate']*100:5.1f}%  "
                  f"walk {m['walk_rate']*100:5.1f}%  "
                  f"free pages {m['pages_free']}")

    m = engine.stats(st)
    print(f"\nfinal translation-path mix (Victima layer active, "
          f"{st.slot_len.device}):")
    print(f"  TC hits        {m['tc_hit_rate']*100:5.1f}%   (≈ L2 TLB)")
    print(f"  cluster hits   {m['cluster_hit_rate']*100:5.1f}%   "
          f"(TLB blocks in the KV pool — the paper's mechanism)")
    print(f"  radix walks    {m['walk_rate']*100:5.1f}%   (≈ PTWs)")


if __name__ == "__main__":
    main()

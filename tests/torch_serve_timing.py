"""Time the serving path of several checkouts on one card, each in a
process of its own, in the order given, to compare versions within one
run (say parent, change, change, parent):

    python tests/torch_serve_timing.py PARENT_ROOT . . PARENT_ROOT

Each ROOT is a checkout of this repository: its ``src/`` goes first on
the path and its kernels build into its own ``build/``.  For each root,
one JSON line: the root, the card (name and power limit, as nvidia-smi
gives them), and for granite-3-2b, mamba2-2.7b and recurrentgemma-2b at
full width and depth in bf16 (random weights from seed 0, drawn on the
card), B x S prompt tokens: the prefill's ms and a decode step's ms
(STEPS greedy steps after it; granite over a cache of CACHE positions,
the other two from ``init_cache``), each the median of ROUNDS rounds,
host clock after a sync, after one warm-up round.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

MODELS = ("granite-3-2b", "mamba2-2.7b", "recurrentgemma-2b")
B, S, CACHE, STEPS, ROUNDS = 8, 512, 640, 16, 3


def one(root: str) -> dict:
    import torch

    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    dev = torch.device("cuda")
    out = {"root": root}
    for name in MODELS:
        cfg = get_config(name)
        m = M.build(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = m.init(gen)
        batch = M.dummy_batch(cfg, B, S, gen)
        stateless = cfg.family in M.STATELESS_PREFILL
        pre, dec = [], []
        for _ in range(ROUNDS + 1):
            cache = None if stateless else m.init_cache(B, CACHE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = m.prefill(params, batch, cache)
            torch.cuda.synchronize()
            pre.append((time.perf_counter() - t0) * 1e3)
            if stateless:
                cache = m.init_cache(B, CACHE)
            t0 = time.perf_counter()
            for i in range(STEPS):
                tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
                pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
                lg, cache = m.decode_step(params, cache, tok, pos)
            torch.cuda.synchronize()
            dec.append((time.perf_counter() - t0) * 1e3 / STEPS)
        out[name] = {"prefill_ms": statistics.median(pre[1:]),
                     "decode_ms": statistics.median(dec[1:])}
        del m, params, cache, lg
        torch.cuda.empty_cache()
    return out


def main(roots: list[str]) -> int:
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({**rec, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(sys.argv[2])))
    else:
        sys.exit(main(sys.argv[1:]))

"""Time the bf16 flash kernel of several checkouts on one card, each in
a process of its own, in the order given, to compare versions within one
run (say parent, change, change, parent):

    python tests/torch_flash_timing.py PARENT_ROOT . . PARENT_ROOT

Each ROOT is a checkout of this repository: its ``src/`` goes first on
the path and its kernels build into its own ``build/``.  For each root,
one JSON line: the root, the card (name and power limit, as nvidia-smi
gives them), and the kernel's device ms at three prefills, the model's
[B,S,H,hd] views, causal: granite-3-2b's (B 8, S 512, H 32, K 8, hd 64),
the same at hd 128, and recurrentgemma-2b's (H 10, K 1, hd 256, window
2048) where the checkout's kernel takes hd 256.  A time is the median of
ROUNDS rounds of REPS launches between CUDA events, queued behind a spin
of the card, as ``chip_smoke.py``'s ``device_ms`` times them.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROUNDS, REPS = 7, 20
# (name, H, K, hd, window)
SHAPES = [("granite_hd64", 32, 8, 64, None),
          ("granite_hd128", 32, 8, 128, None),
          ("recurrentgemma_hd256", 10, 1, 256, 2048)]
B, S = 8, 512


def one(root: str) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {"root": root}
    for name, H, K, hd, window in SHAPES:
        if hd not in fa.KERNELS[torch.bfloat16][2]:   # widths built
            out[name] = None
            continue
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, S, n, hd), dtype=np.float32)).to(dev).to(
                torch.bfloat16).transpose(1, 2) for n in (H, K, K))

        def fn():
            return fa.flash_attention(q, k, v, causal=True, window=window)
        before = fa.LAUNCHES_BY_KERNEL["mma_bf16"]
        fn()
        if fa.LAUNCHES_BY_KERNEL["mma_bf16"] != before + 1:
            raise AssertionError(f"{name}: mma_bf16 did not launch")
        times = []
        for _ in range(ROUNDS):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)
            a.record()
            for _ in range(REPS):
                fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / REPS)
        out[name] = statistics.median(times)
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

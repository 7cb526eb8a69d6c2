"""Time builds of the float32 flash-attention kernel side by side on one
card, beside the plain version and SDPA, at the shapes of
``chip_smoke.py``'s phase 19 (a), ``F32_TIMED`` (hd 64, 128 and 256).

Each argument names one build, ``LABEL=SOURCE[:FLAG,FLAG...]``: a copy
of ``csrc/flash_attention.cu`` (this checkout's, or an older one written
out with ``git show``) compiled by nvcc with the build's flags and the
given extra ones (``-D`` macros that set the kernel's choices), in a
temporary directory.  The builds run in parallel; each is then checked
against ``ref.mha_reference`` (TF32 off) and timed in turns, in the
order given and then reversed, the plain version first and last, SDPA
(k and v repeated to every query head) once.  Times are device times
behind a spin (``chip_smoke.device_ms``); ptxas's registers, spills and
shared memory of each float32 entry are printed beside them, and each
shape's numbers once more as one JSON line.  Needs the card and nvcc:

    python tools/flash_f32_timing.py parent=build/parent/flash_attention.cu \\
        new=src/repro_torch/kernels/csrc/flash_attention.cu
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

REPS = 50


def parse(arg: str) -> tuple:
    """(label, source path, extra nvcc flags) of one build argument."""
    label, _, rest = arg.partition("=")
    src, _, extra = rest.partition(":")
    if not label or not src:
        raise SystemExit(f"a build is LABEL=SOURCE[:FLAG,...], not {arg!r}")
    return label, os.path.abspath(src), tuple(f for f in extra.split(",")
                                              if f)


def compile_one(src: str, extra: tuple, so: str) -> tuple:
    """(library, the float32 entries' ptxas lines) of one build."""
    p = subprocess.run([build.nvcc(), *build.flags("flash_attention"),
                        *extra, "-o", so, src], capture_output=True,
                       text=True)
    if p.returncode:
        raise RuntimeError(p.stdout + p.stderr)
    lib = ctypes.CDLL(so)
    lib.flash_attention_launch.argtypes = [fa._Args, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    usage, cur = {}, None
    for ln in (p.stdout + p.stderr).splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
        elif cur and "flash_mma" not in cur and (
                "Used" in ln or "spill" in ln):
            usage.setdefault(cur, []).append(ln.split(":", 1)[-1].strip())
    return lib, {k: "; ".join(v) for k, v in usage.items()}


def main(argv) -> int:
    builds = [parse(a) for a in argv]
    if not builds:
        raise SystemExit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(len(builds)) as pool:
        libs = dict(zip(
            [b[0] for b in builds],
            pool.map(lambda b: compile_one(
                b[1], b[2], os.path.join(tmp, f"{b[0]}.so")), builds)))
        for label, (_, usage) in libs.items():
            for entry, u in usage.items():
                print(f"  {label}: {entry}: {u}")
        rng = np.random.default_rng(19)

        def draw(*shape):
            return torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to(dev)

        for what, B, S, H, K, hd, causal, window in cs.F32_TIMED:
            q = draw(B, S, H, hd).transpose(1, 2)
            k, v = (draw(B, S, K, hd).transpose(1, 2) for _ in range(2))
            kx, vx = (x.repeat_interleave(H // K, dim=1) for x in (k, v))
            want = ref.mha_reference(q, k, v, causal=causal, window=window)

            def kernel(lib):
                o = torch.empty((B, S, H, hd), device=dev).transpose(1, 2)
                strides = [x.stride(d) for x in (q, k, v, o)
                           for d in (0, 1, 2)]
                args = fa._Args(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), *strides, B, H, K, S, S,
                                int(causal), int(window or 0),
                                1.0 / hd ** 0.5)
                err = lib.flash_attention_launch(
                    args, 0, hd, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
                return o

            def plain():
                return ref.mha_reference(q, k, v, causal=causal,
                                         window=window)

            row = {"shape": what, "B": B, "S": S, "H": H, "K": K, "hd": hd,
                   "window": window, "card": smi,
                   "plain_ms": [cs.device_ms(plain, reps=REPS)],
                   "sdpa_ms": cs.device_ms(
                       lambda: torch.nn.functional.
                       scaled_dot_product_attention(q, kx, vx,
                                                    is_causal=causal),
                       reps=REPS), "builds": {}}
            order = [b[0] for b in builds]
            for label in order + order[::-1]:
                lib = libs[label][0]
                r = row["builds"].setdefault(label, {"ms": []})
                got = kernel(lib)
                torch.cuda.synchronize()
                r["max_abs_err"] = float((got - want).abs().max())
                r["ms"].append(cs.device_ms(lambda: kernel(lib), reps=REPS))
            row["plain_ms"].append(cs.device_ms(plain, reps=REPS))
            row["bound_ms"], row["bound_by"] = cs.flash_bound_ms(
                q, k, causal, window)
            row["tensor_bound_ms"], row["tensor_bound_by"] = \
                cs.flash_tf32x3_bound_ms(q, k, causal, window)
            print(f"{what}: B={B}, S={S}, H={H}, K={K}, hd={hd}, float32, "
                  f"causal, window {window}: plain {row['plain_ms']} ms, "
                  f"SDPA {row['sdpa_ms']:.4f} ms; bounds "
                  f"{row['bound_ms']:.5f} ms ({row['bound_by']}, FMA) and "
                  f"{row['tensor_bound_ms']:.5f} ms "
                  f"({row['tensor_bound_by']}, 3xTF32); {smi}")
            for label, r in row["builds"].items():
                print(f"  {label}: {r['ms']} ms, max abs err "
                      f"{r['max_abs_err']:.3g}")
            print(json.dumps(row))
            del q, k, v, kx, vx, want
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

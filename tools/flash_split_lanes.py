"""Time ``flash_fma_split`` (float32 flash attention at hd 128 and 256)
with T lanes a query row, beside the plain version, at the shapes of
``chip_smoke.py``'s phase 19 (a), ``F32_TIMED``.

Each T is built by nvcc, with the build's flags, from a copy of
``csrc/flash_attention.cu`` whose ``Split<HD>::T`` is set to it, in a
temporary directory; the kernel's largest error against
``ref.mha_reference`` is printed beside its time, and ptxas's registers
and spills beside both.  Times are device times behind a spin
(``chip_smoke.device_ms``), the plain version's first and last.  Needs
the card and nvcc:

    python tools/flash_split_lanes.py
"""
from __future__ import annotations

import ctypes
import os
import re
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

LANES = (4, 8, 16, 32)
T_LINE = "  static constexpr int T = 8;\n"


def build_lanes(t: int, tmp: str) -> tuple:
    """(library, ptxas log) of the kernels with ``t`` lanes a row."""
    with open(build.source("flash_attention")) as f:
        src = f.read()
    assert src.count(T_LINE) == 1, "Split<HD>::T is not where it was"
    path = os.path.join(tmp, f"flash_t{t}.cu")
    with open(path, "w") as f:
        f.write(src.replace(T_LINE, f"  static constexpr int T = {t};\n"))
    so = path[:-3] + ".so"
    p = subprocess.run([build.nvcc(), *build.flags("flash_attention"),
                        "-o", so, path], capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(p.stdout + p.stderr)
    lib = ctypes.CDLL(so)
    lib.flash_attention_launch.argtypes = [fa._Args, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib, p.stdout + p.stderr


def main() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(len(LANES)) as pool:
        libs = dict(zip(LANES, pool.map(lambda t: build_lanes(t, tmp),
                                        LANES)))
        rng = np.random.default_rng(19)

        def draw(*shape):
            return torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to(dev)

        for what, B, S, H, K, hd, causal, window in cs.F32_TIMED:
            q = draw(B, S, H, hd).transpose(1, 2)
            k, v = (draw(B, S, K, hd).transpose(1, 2) for _ in range(2))
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

            plain = [cs.device_ms(lambda: ref.mha_reference(
                q, k, v, causal=causal, window=window), reps=50)]
            rows = {}
            for t in LANES + LANES[::-1]:
                lib, log = libs[t]
                err = float((kernel(lib) - want).abs().max())
                ms = cs.device_ms(lambda: kernel(lib), reps=50)
                m = re.search(rf"flash_fma_splitILi{hd}E.*?\n.*?\n(.*?)\n"
                              rf".*?Used (\d+) registers", log, re.S)
                rows.setdefault(t, (err, m.group(1).strip(), m.group(2),
                                    []))[3].append(ms)
            plain.append(cs.device_ms(lambda: ref.mha_reference(
                q, k, v, causal=causal, window=window), reps=50))
            bound, by = cs.flash_bound_ms(q, k, causal, window)
            print(f"{what}: B={B}, S={S}, H={H}, K={K}, hd={hd}, float32, "
                  f"causal, window {window}; plain {plain} ms; bound "
                  f"{bound:.5f} ms ({by}); {smi}")
            for t, (err, spills, regs, ms) in rows.items():
                print(f"  {t:2d} lanes a row ({hd // t} dims a lane): "
                      f"{ms} ms, max abs err {err:.3g}; {regs} registers, "
                      f"{spills}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

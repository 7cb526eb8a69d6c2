"""Build helper for the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/kernels/lib<name>-<hash>.so`` at the repository
root (listed in ``.gitignore``) the first time a wrapper needs it; the
hash of the source and its flags names the library, so an edited source
rebuilds and an unchanged one loads the library already built.  Nothing
is compiled at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import repro_torch.obs as obs

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.abspath(os.path.join(CSRC, "..", "..", "..", "..",
                                         "build", "kernels"))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

# flags of one source only: mmu_step must add its float32 sums exactly as
# the reference does, so it contracts no multiply-add into an FMA
EXTRA_FLAGS = {"mmu_step": ("-fmad=false",)}

# libraries built from another library's source with extra flags:
# name -> (source, flags).  mmu_step_prof is the scan kernel with its
# per-stage clock64() stamps compiled in (only chip_smoke.py loads it)
VARIANTS = {"mmu_step_prof": ("mmu_step", ("-DMMU_PROFILE",))}


def source(name: str) -> str:
    """Path of the .cu file library ``name`` is compiled from."""
    return os.path.join(CSRC, VARIANTS.get(name, (name,))[0] + ".cu")


def flags(name: str) -> tuple:
    src, extra = VARIANTS.get(name, (name, ()))
    return NVCC_FLAGS + EXTRA_FLAGS.get(src, ()) + extra


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(flags(name)).encode())
    with open(source(name), "rb") as f:
        h.update(f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def compile_kernel(name: str) -> dict:
    """Compile library ``name`` (``csrc/<name>.cu``, or a variant's
    source) unconditionally.

    Returns ``{"path", "seconds", "log"}``, where ``log`` is nvcc's
    output (``-Xptxas -v``: registers, shared memory and spills per
    kernel).  Raises with that output when nvcc fails.
    """
    out = library_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc(), *flags(name), "-o", tmp, source(name)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": log}


def load(name: str) -> ctypes.CDLL:
    """The kernel library, compiled first if this source has no build.

    Emits one ``EV_COMPILE`` event (``fn`` = ``name``, ``built``: whether
    nvcc ran, ``seconds``) under the caller's current span: the port's
    counterpart of the reference's jit-cache misses, which a ladder
    fill's ``dispatch_compiles`` counts.  The kernels' wrappers load
    each library once a process."""
    t0 = time.perf_counter()
    path = library_path(name)
    built = not os.path.exists(path)
    if built:
        path = compile_kernel(name)["path"]
    lib = ctypes.CDLL(path)
    obs.event(obs.names.EV_COMPILE, fn=name, built=built,
              seconds=time.perf_counter() - t0)
    return lib

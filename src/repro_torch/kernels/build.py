"""Build helper for the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/kernels/lib<name>-<hash>.so`` at the repository
root (listed in ``.gitignore``) the first time a wrapper needs it; the
hash of the source names the library, so an edited source rebuilds and
an unchanged one loads the library already built.  Nothing is compiled
at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.abspath(os.path.join(CSRC, "..", "..", "..", "..",
                                         "build", "kernels"))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def compile_kernel(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unconditionally.

    Returns ``{"path", "seconds", "log"}``, where ``log`` is nvcc's
    output (``-Xptxas -v``: registers, shared memory and spills per
    kernel).  Raises with that output when nvcc fails.
    """
    out = library_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": log}


def load(name: str) -> ctypes.CDLL:
    """The kernel library, compiled first if this source has no build."""
    path = library_path(name)
    if not os.path.exists(path):
        path = compile_kernel(name)["path"]
    return ctypes.CDLL(path)

"""Config registry: one module per assigned architecture.

The port's copy of ``repro.configs``: the same ``ARCHS`` list and
lookups.  granite-3-2b's and mamba2-2.7b's modules are ported so far;
the other names raise, naming the ROADMAP queue that brings them.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "qwen3-32b",
    "phi3-medium-14b",
    "granite-3-2b",
    "yi-6b",
    "mamba2-2.7b",
    "mixtral-8x7b",
    "granite-moe-1b-a400m",
    "seamless-m4t-medium",
    "recurrentgemma-2b",
    "qwen2-vl-7b",
]

PORTED = ("granite-3-2b", "mamba2-2.7b")


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCHS}")
    if name not in PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP Queue 1, Models); the port "
            f"has {list(PORTED)}")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE

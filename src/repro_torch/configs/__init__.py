"""Config registry: one module per assigned architecture.

The port's copy of ``repro.configs``: the same ``ARCHS`` list and
lookups, every architecture's module ported (``PORTED == ARCHS``).
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

PORTED = tuple(ARCHS)


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCHS}")
    return importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).SMOKE

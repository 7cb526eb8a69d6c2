"""The benchmark's manifest (``BENCHMARK.json``) and the files it names.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by its name:

- ``bench/configs/<config>.json``: the configuration (for the simulator,
  the deployment: Table 3's geometry, the systems it holds, the trace
  length);
- ``bench/traffic/<traffic>.json``: what one job of the cell runs; its
  ``kind`` names the module under ``bench/kinds/`` that runs and checks
  such jobs;
- ``bench/metrics/<metric>.py``: a reader with ``read(ctx)``, for
  end-to-end and per-layer metrics alike, which returns the metric's
  value, or None when the run gives it nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: tuple      # the manifest's end-to-end metrics of this cell
    per_layer: tuple       # the manifest's per-layer metrics of this cell


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def config_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "configs", f"{name}.json")


def traffic_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "traffic", f"{name}.json")


def metric_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "metrics", f"{name}.py")


def cell(name: str, manifest_path: str = MANIFEST) -> Cell:
    """The cell `name` of the manifest with its configuration and traffic
    loaded; raises KeyError for a cell the manifest lacks."""
    man = load_json(manifest_path)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in {manifest_path}; cells: "
                       f"{[w['name'] for w in man['workloads']]}")
    cfg_entry = next(c for c in man["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(traffic_path(entry["traffic"]))
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(entry["chips"]),
                end_to_end=tuple(m for m in man["end_to_end"]
                                 if _applies(m, name)),
                per_layer=tuple(m for m in man["per_layer"]
                                if _applies(m, name)))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(ctx)`` function of metric `metric`."""
    return _module(metric_path(metric), "bench_metric_" + metric.replace(
        ".", "_").replace("-", "_")).read


def kind(traffic: dict):
    """The module that runs and checks the jobs of `traffic`'s kind."""
    name = traffic["kind"]
    return _module(os.path.join(BENCH_DIR, "kinds", f"{name}.py"),
                   f"bench_kind_{name}")

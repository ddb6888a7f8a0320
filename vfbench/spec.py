"""Finding a cell's parts by name from files.

- ``BENCHMARK.json`` at the root of the checkout: the cells, the
  configurations (each with its ``file``) and the metrics;
- ``vfbench/traffic/<mix>.json``: a traffic mix's parameters, with the
  name of its public entry's driver, ``vfbench/drivers/<entry>.py``
  (``generator.driver_class``);
- ``vfbench/limits/<cell>.json``: the limits of the numbers that decide a
  cell's ``correct``;
- ``vfbench/metrics/<metric>.py``: a per-layer metric's reader, a module
  with ``read(reading)``; a metric's name maps to its module by turning
  "." and "-" into "_".
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return _load(Path(root) / "BENCHMARK.json")


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(spec: dict, name: str) -> dict:
    return _named(spec["workloads"], name, "workload")


def config(root: Path, spec: dict, name: str) -> dict:
    return _load(Path(root) / _named(spec["configs"], name, "config")["file"])


def traffic(root: Path, name: str) -> dict:
    return _load(Path(root) / "vfbench" / "traffic" / f"{name}.json")


def limits(root: Path, cell_name: str) -> dict:
    return _load(Path(root) / "vfbench" / "limits" / f"{cell_name}.json")


def metrics_of(spec: dict, kind: str, cell_name: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    without a ``workloads`` list and those whose list names the cell."""
    return [m for m in spec[kind] if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str):
    """The ``read`` function of a per-layer metric's module."""
    module = metric.replace(".", "_").replace("-", "_")
    return importlib.import_module(f"vfbench.metrics.{module}").read

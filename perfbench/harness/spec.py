"""Find a cell's pieces by name.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Its
configuration is ``perfbench/configs/<config>.json``, its traffic mix
``perfbench/traffic/<traffic>.json``, its offered rate and comparison
limits ``perfbench/cells/<cell>.json`` (``BENCHMARK.json``'s entries take
no further keys), and each metric a reader
``perfbench/metrics/<metric>.py`` with a function ``read(run)`` that
returns a number or None.  A new cell, mix or metric is new files and new
entries; no file here names one.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]      # the checkout's root
BENCH_DIR = "perfbench"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file, as run
    traffic: dict           # the mix's parameters
    params: dict            # the cell's own: rate and limits
    end_to_end: list        # this cell's end-to-end metric entries
    per_layer: list         # this cell's per-layer metric entries
    root: Path


def _read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(root: Path = ROOT) -> dict:
    return _read_json(Path(root) / "BENCHMARK.json")


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    base = root / BENCH_DIR
    return Cell(name=name, chips=int(entry["chips"]),
                config=_read_json(root / cfg["file"]),
                traffic=_read_json(base / "traffic" / f"{entry['traffic']}.json"),
                params=_read_json(base / "cells" / f"{name}.json"),
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name), root=root)


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    path = Path(root) / BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

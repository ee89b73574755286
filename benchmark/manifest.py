"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix:

* ``configs/<config>.json``: the configuration as it is run (the entry's ``file``);
* ``traffic/<traffic>.json``: the traffic mix, whose ``kind`` names the driver
  module ``traffic/<kind>.py`` that makes and sends that kind of work;
* ``workloads/<cell>.json``: the cell's correctness limits and the readings
  they were set from;
* ``metrics/<metric>.py``: the reader of each per-layer metric.

A later change adds a configuration, a mix, a cell or a metric by adding such
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

__all__ = ["load", "cell", "config", "traffic", "limits", "kind_module", "metric_module",
           "end_to_end", "per_layer", "ROOT", "CHECKOUT", "NAME"]


def _name(n: str) -> str:
    if not NAME.match(n):
        raise ValueError(f"not a benchmark name: {n!r}")
    return n


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(path: Path = CHECKOUT / "BENCHMARK.json") -> dict:
    return _json(path)


def _entry(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], _name(name), "workload")


def config(bench: dict, name: str) -> dict:
    entry = _entry(bench["configs"], _name(name), "configuration")
    return _json(CHECKOUT / entry["file"])


def traffic(name: str) -> dict:
    return _json(ROOT / "traffic" / f"{_name(name)}.json")


def limits(cell_name: str) -> Dict[str, float]:
    """The cell's limits: each number the check compares, and the largest it may read."""
    return {k: float(v) for k, v in _json(ROOT / "workloads" / f"{_name(cell_name)}.json")
            ["limits"].items()}


def _module(path: Path, tag: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(tag, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str) -> ModuleType:
    return _module(ROOT / "traffic" / f"{_name(kind)}.py", f"benchmark_kind_{kind}")


def metric_module(name: str) -> ModuleType:
    return _module(ROOT / "metrics" / f"{_name(name)}.py",
                   "benchmark_metric_" + name.replace(".", "_").replace("-", "_"))


def _reported_in(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"] if _reported_in(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics this cell reports."""
    return [m for m in bench["per_layer"] if _reported_in(m, cell_name)]

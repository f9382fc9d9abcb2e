"""Find everything a cell needs by the names in ``BENCHMARK.json``.

- a configuration: ``benchmark/configs/<config>.json``;
- a traffic mix: ``benchmark/traffic/<mix>.json``, parameters that the one
  generator and driver (``data.py``, ``cell.py``) read;
- a cell's limits on its comparison: ``benchmark/limits/<workload>.json``;
- a per-layer metric: ``benchmark/metrics/<metric>.py``, whose ``read(t)``
  takes a ``trace.Reading`` and gives a number or None;
- a bucket of device kernels: ``benchmark/buckets/<bucket>.json``;
- a configuration's reference net, conv list and fault leaf:
  ``benchmark/reference/models/<model lower-cased>.py`` (``reference.nets``).

A later cell, mix, metric, kernel or model adds a file here; no file is edited.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, NamedTuple

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    return _json(HERE / "limits" / f"{workload_name}.json")


def end_to_end(bench: dict, workload_name: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if workload_name in m.get("workloads", [workload_name])]


def per_layer(bench: dict, workload_name: str) -> List[dict]:
    return [m for m in bench["per_layer"] if workload_name in m.get("workloads", [workload_name])]


def reader(metric_name: str):
    """The ``read`` function of ``benchmark/metrics/<metric_name>.py``."""
    path = HERE / "metrics" / f"{metric_name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric_name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


class Bucket(NamedTuple):
    name: str
    order: int
    pattern: "re.Pattern"
    conv: bool        # its kernels do the work of 'same' convs
    merge: bool       # its kernels do the work of the MoDE gate merge


def buckets() -> List[Bucket]:
    out = []
    for path in sorted((HERE / "buckets").glob("*.json")):
        b = _json(path)
        flags = re.IGNORECASE if b.get("ignore_case") else 0
        out.append(Bucket(path.stem, b["order"], re.compile(b["pattern"], flags),
                          bool(b.get("conv")), bool(b.get("merge"))))
    return sorted(out, key=lambda b: b.order)


def bucket_of(name: str, table: List[Bucket]) -> str:
    """The first bucket (by ``order``) whose pattern the kernel name matches."""
    for b in table:
        if b.pattern.search(name):
            return b.name
    return "other"

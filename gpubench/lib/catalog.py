"""Find the benchmark's parts by name, from files alone.

- a cell: ``workloads/<cell>.json`` (its configuration, traffic, driver,
  trace slice and correctness limits);
- a configuration: ``configs/<config>.json``;
- a traffic mix: ``traffic/<traffic>.json``;
- a driver: ``drivers/<kind>.py`` with ``run(...)``;
- a per-layer metric: ``metrics/<metric>.py`` with ``read(ctx)``;
  ``<metric>.<kind>`` is read by the same file, the same quantity in
  cells that report other end-to-end metrics (``moves`` differs).

``BENCHMARK.json`` at the checkout's root says which metrics a cell
reports.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parents[1]


def _json(root: Path, kind: str, name: str) -> dict:
    path = Path(root) / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                       f"named {name!r} ({path})")
    with open(path) as f:
        out = json.load(f)
    out.setdefault("name", name)
    return out


def cell(name: str, root: Path = HERE) -> dict:
    return _json(root, "workloads", name)


def config(name: str, root: Path = HERE) -> dict:
    return _json(root, "configs", name)


def traffic(name: str, root: Path = HERE) -> dict:
    return _json(root, "traffic", name)


def _module(path: Path, label: str) -> ModuleType:
    if not path.is_file():
        raise KeyError(f"no {label} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"gpubench_{label.replace('/', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, root: Path = HERE) -> ModuleType:
    return _module(Path(root) / "drivers" / f"{kind}.py", f"driver/{kind}")


def metric(name: str, root: Path = HERE) -> ModuleType:
    reader = name.split(".")[0]
    return _module(Path(root) / "metrics" / f"{reader}.py",
                   f"metric/{reader}")


def benchmark(root: Path = HERE) -> dict:
    with open(Path(root).parent / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(entry: dict, cell_name: str) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


def end_to_end(cell_name: str, root: Path = HERE) -> List[str]:
    """The end-to-end metrics the cell reports."""
    return [m["name"] for m in benchmark(root)["end_to_end"]
            if _applies(m, cell_name)]


def per_layer(cell_name: str, root: Path = HERE) -> List[str]:
    """The per-layer metrics the cell's traced run reads."""
    return [m["name"] for m in benchmark(root)["per_layer"]
            if _applies(m, cell_name)]

"""Every part of the benchmark found by its name, in a file of its own.

- `configs/<config>.json`: a configuration (a deployment of the system);
- `traffic/<mix>.json`: a traffic mix: the driver it runs, its parameters
  and the limits of its checks;
- `drivers/<driver>.py`: one entry point of the program, driven call by call;
- `metrics/<metric>.py`: one metric and its reader.

A cell of `BENCHMARK.json` names a configuration and a mix; its metrics
are the entries of `end_to_end` and `per_layer` that list it (or list no
cells). Adding any of these is adding a file and an entry: no code here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

#: The benchmark's folder; `BENCHMARK.json` lies in its parent.
ROOT = Path(__file__).resolve().parents[1]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    name = re.sub(r"\W", "_", f"cudabench_{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root / "traffic" / f"{name}.json")


def driver(name: str, root: Path = ROOT) -> ModuleType:
    return _module(root / "drivers" / f"{name}.py")


def metric(name: str, root: Path = ROOT) -> ModuleType:
    return _module(root / "metrics" / f"{name}.py")


@dataclass
class Cell:
    """One workload of `BENCHMARK.json`, with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    driver: ModuleType
    end_to_end: dict  # metric name -> (entry, reader module)
    per_layer: dict


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def cell(workload: str, root: Path = ROOT, benchmark: Path = None) -> Cell:
    """The cell `workload` of the `BENCHMARK.json` beside `root` (or at `benchmark`)."""
    bench = _json(benchmark or root.parent / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = entries[0]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    mix = traffic(w["traffic"], root)

    def readers(kind):
        return {m["name"]: (m, metric(m["name"], root)) for m in bench[kind]
                if _applies(m, workload)}

    return Cell(
        name=workload, chips=int(w["chips"]), config=_json(root.parent / cfg["file"]),
        traffic=mix, driver=driver(mix["driver"], root),
        end_to_end=readers("end_to_end"), per_layer=readers("per_layer"),
    )

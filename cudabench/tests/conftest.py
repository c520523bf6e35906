"""Shared pieces of the benchmark's CPU tests: a copy of the benchmark in a
temporary folder, cut to a tiny shape, that runs on the CPU through the
program's plain versions."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path.insert(0, str(REPO))

#: The tiny shape: every layer's logic, none of its cost.
TINY = {"num_validators": 16, "num_miners": 64, "num_scenarios": 4}
TINY_EPOCHS = {"mc": 16, "horizon": 48}


def tiny_copy(dest: Path) -> Path:
    """`dest/BENCHMARK.json` and `dest/cudabench/` as the repo's, with every
    configuration cut to :data:`TINY` and every mix's epochs shortened.
    Returns the copy's benchmark folder."""
    root = dest / "cudabench"
    for part in ("configs", "traffic", "drivers", "metrics"):
        shutil.copytree(BENCH / part, root / part)
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for path in (root / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(TINY)
        cfg["snapshot"]["nnz_per_row"] = 8
        path.write_text(json.dumps(cfg))
    for path in (root / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["params"]["epochs"] = TINY_EPOCHS[path.stem]
        path.write_text(json.dumps(mix))
    return root


@pytest.fixture
def tiny_bench(tmp_path) -> Path:
    return tiny_copy(tmp_path)


def _run_on_cpu(root: Path, workload: str, seed: int = 2**31 + 7, seconds: float = 0.5,
                trace: bool = False) -> dict:
    """One run of `workload` of the copy at `root` on the CPU: the harness
    with its look for a card skipped."""
    import time

    import torch

    from cudabench.core import cell as cells
    from cudabench.core import registry

    cell = registry.cell(workload, root)
    return cells.run(cell, seed, seconds, trace, torch, torch.device("cpu"), time.perf_counter())


@pytest.fixture
def run_on_cpu():
    return _run_on_cpu

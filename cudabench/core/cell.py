"""One run of one cell: set-up, the measured window, the metrics, the check.

A driver (`drivers/<name>.py`) gives five functions:

- `setup(ctx) -> state`: makes the inputs from `ctx.seed`, puts them on
  `ctx.device` and warms up every shape the window uses;
- `call(state, i) -> output`: call `i` of the closed loop, ended when its
  results are on the host;
- `shape(state) -> dict`: one call's `scenarios`, `epochs`, `validators`
  and `miners`;
- `release(state)`: frees the program's device state;
- `check(state, outputs, control=None) -> {name: [(call, gap), ...]}`: the
  comparison with the plain reference of a sample of the answers drawn
  from the seed; with `control` (a dtype) the reference computed in that
  dtype stands in the program's place.

A metric (`metrics/<name>.py`) gives `read(window) -> float | None`.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass
from typing import Optional

from cudabench.core import trace as tracing


#: Seeds are taken modulo 2**64, so any whole number seeds numpy.
SEED_MASK = 2**64 - 1


@dataclass
class Context:
    torch: object
    device: object
    seed: int
    config: dict
    params: dict


@dataclass
class Window:
    """What the metrics read: the calls' host-clock spans, the shape of one
    call, the set-up time, the configuration, and the traced window (with
    `--trace 1`)."""

    spans: list
    shape: dict
    setup_s: float
    config: dict
    trace: Optional[tracing.Trace] = None

    @property
    def seconds(self) -> float:
        return self.spans[-1][1] - self.spans[0][0]

    @property
    def work_per_call(self) -> int:
        """Scenario-epochs one call completes."""
        return self.shape["scenarios"] * self.shape["epochs"]


def measure(driver, state, seconds: float):
    """Back-to-back calls until `seconds` have passed; the window ends with
    the last call."""
    outputs, spans = [], []
    start = time.perf_counter()
    while not spans or spans[-1][1] - start < seconds:
        t0 = time.perf_counter()
        outputs.append(driver.call(state, len(outputs)))
        spans.append((t0, time.perf_counter()))
    return outputs, spans


def checks(gaps: dict, limits: dict):
    """`(rows, failed calls, correct)`: each number compared, with its worst
    reading (None where a reading is not a number) and its limit. A call
    fails when any of its readings is over a limit or is not a number."""
    rows, failed = {}, set()
    for name, readings in gaps.items():
        limit = limits[name]
        failed.update(c for c, g in readings if not g <= limit)
        values = [float(g) for _, g in readings]
        worst = None if not values or any(math.isnan(g) for g in values) else max(values)
        rows[name] = {"value": worst, "limit": limit}
    correct = bool(rows) and not failed and all(r["value"] is not None for r in rows.values())
    return rows, sorted(failed), correct


def run(cell, seed: int, seconds: float, trace: bool, torch, device, started: float) -> dict:
    """Run `cell` once; returns the result line's object."""
    params = cell.traffic["params"]
    ctx = Context(torch=torch, device=device, seed=seed & SEED_MASK, config=cell.config,
                  params=params)
    driver = cell.driver
    state = driver.setup(ctx)
    setup_s = time.perf_counter() - started
    if trace:
        outputs, traced = tracing.traced_calls(torch, lambda i: driver.call(state, i), 0,
                                               int(params["trace_calls"]))
        window = Window(spans=[], shape=driver.shape(state), setup_s=setup_s,
                        config=cell.config, trace=traced)
        readers = cell.per_layer
    else:
        outputs, spans = measure(driver, state, seconds)
        window = Window(spans=spans, shape=driver.shape(state), setup_s=setup_s,
                        config=cell.config)
        readers = cell.end_to_end
        print(f"calls in the window: {len(outputs)}", file=sys.stderr, flush=True)
    cuda = device.type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {}
    for name, (entry, reader) in readers.items():
        value = reader.read(window)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": entry["unit"]}
    driver.release(state)
    if cuda:
        torch.cuda.empty_cache()
    rows, failed, correct = checks(driver.check(state, outputs), cell.traffic["limits"])
    line = {
        "correct": correct,
        "attempted": len(outputs),
        "failed": len(failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else device.type,
            "count": cell.chips,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if trace:
        line["device"]["busy_s"] = window.trace.busy_s
        line["device"]["window_s"] = window.trace.window_s
        line["breakdown"] = window.trace.breakdown()
    line["checks"] = rows
    return line

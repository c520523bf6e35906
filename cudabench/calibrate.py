"""The readings the limits of `correct` are set from, for one cell, in one
process: the program's gaps from the reference on many seeds, and the
control's on some of them. The control is the reference itself computed
in bfloat16 (:data:`CONTROL`, the precision below the configurations'
float32), put in the program's place.

    python3 cudabench/calibrate.py --workload <name> --seeds 1-12 \
        --control-seeds 1-3 --seconds 5

Each seed runs the cell's set-up, a window of `--seconds` and the check,
as `run.py` does, and prints one JSON line: the worst reading of each
number compared, for the program and, on a control seed, for the control,
each with the `correct` that the cell's limits give it (the control's has
to be false). The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run
import torch

CONTROL = torch.bfloat16


def _seeds(text: str) -> list:
    seeds = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        seeds += list(range(int(lo), int(hi or lo) + 1))
    return seeds


def _judged(gaps: dict, limits: dict) -> dict:
    """The worst reading of each number and the run's `correct`, as the
    harness's own comparison gives them."""
    from cudabench.core.cell import checks

    rows, _, correct = checks(gaps, limits)
    return {"worst": {name: row["value"] for name, row in rows.items()}, "correct": correct}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="e.g. 1-12 or 5,9,40-44")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)
    run._environment()
    from cudabench.core import cell as cells
    from cudabench.core import registry

    cell = registry.cell(args.workload)
    if not torch.cuda.is_available():
        print("cudabench: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    control_seeds = set(_seeds(args.control_seeds)) if args.control_seeds else set()
    for seed in _seeds(args.seeds):
        t0 = time.perf_counter()
        ctx = cells.Context(torch=torch, device=device, seed=seed & cells.SEED_MASK,
                            config=cell.config,
                            params=cell.traffic["params"])
        state = cell.driver.setup(ctx)
        outputs, spans = cells.measure(cell.driver, state, args.seconds)
        cell.driver.release(state)
        torch.cuda.empty_cache()
        limits = cell.traffic["limits"]
        record = {"workload": cell.name, "seed": seed, "calls": len(outputs),
                  "program": _judged(cell.driver.check(state, outputs), limits)}
        if seed in control_seeds:
            record["control"] = _judged(cell.driver.check(
                state, outputs, control=CONTROL), limits)
        record["seconds"] = time.perf_counter() - t0
        print(json.dumps(record), flush=True)
        del state, outputs
        torch.cuda.empty_cache()
    loaded = run.forbidden_modules()
    if loaded:
        print(f"cudabench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())

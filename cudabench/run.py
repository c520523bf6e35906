"""Run one cell of the benchmark once and print its result line.

    python3 cudabench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in `BENCHMARK.json`. With `--trace 0`
the last line of standard output carries the cell's end-to-end metrics,
with `--trace 1` its per-layer metrics, read from a torch.profiler trace of
`trace_calls` whole calls. Every run compares a sample of what the timed
calls produced with the plain reference (`cudabench/reference/`) and
prints each number compared beside its limit, as the last lines of
standard error and under `checks` in the result line.

It runs on the CUDA card only: without one (or with fewer cards than the
cell asks for) it exits with code 2 and prints no result; if JAX or the
JAX package was loaded in the process, with code 3. The kernel
libraries are built into `cudabench/.cache/`, so only the first run in a
checkout builds them.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"
#: Top-level module names that must not be loaded: JAX and the JAX package
#: (the root `yuma_simulation` shim and `tools` import it).
FORBIDDEN = ("jax", "jaxlib", "flax", "yuma_simulation_tpu", "yuma_simulation", "tools")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _environment() -> None:
    """The program's kernel-library cache (its only build cache: it builds
    with nvcc through `ops/_build.py`) at a fixed path in the checkout."""
    os.environ["YUMA_TORCH_BUILD_DIR"] = str(CACHE / "kernels")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    import torch

    from cudabench.core import cell as cells
    from cudabench.core import registry

    cell = registry.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cudabench: {cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = cells.run(cell, args.seed, args.seconds, bool(args.trace), torch,
                     torch.device("cuda", 0), STARTED)
    loaded = forbidden_modules()
    if loaded:
        print(f"cudabench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, row in line["checks"].items():
        print(f"check {name} {row['value']} limit {row['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

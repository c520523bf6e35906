"""Generate the per-beta chart-table HTML files.

The port's counterpart of the JAX package's `cli/charts_table_generator.py`
(the reference's `scripts/charts_table_generator.py`, which hard-codes its
parameters, reference charts_table_generator.py:12-48): the same flags for
the sweep values, the output directory, the case subset and the table
style, and the same file names (`simulation_results_b{beta}.html`), each
written as it completes. The suite is simulated on the card unless
`--device cpu` is given; rendering the charts needs matplotlib:

    python -m yuma_simulation_tpu_torch.cli.charts_table_generator \
        [--bond-penalty 0 0.5 0.99 1.0] [--cases "Case 3" ...] \
        [--out-dir DIR] [--no-draggable] [--device cuda|cpu] [--profile-dir DIR] \
        [--executable-cache DIR] [--fleet-store DIR]

The invocation is one telemetry run; `--profile-dir` writes a
`torch.profiler` Chrome trace of it. `--executable-cache DIR` makes DIR the
kernels' build directory (the library cache of `ops/_build.py`): a second
invocation against it loads the libraries without running `nvcc`, and its
`cache_stats.json` is printed and published there on exit. `--fleet-store
DIR` coordinates the tables through a shared fleet store
(:func:`..fabric.run_fleet_artifacts`): concurrent invocations split the
betas into lease-claimed units, each table is built exactly once across
them, and every invocation writes the whole HTML set.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

from yuma_simulation_tpu_torch.models.config import SimulationHyperparameters
from yuma_simulation_tpu_torch.models.variants import canonical_versions
from yuma_simulation_tpu_torch.scenarios import create_case, get_cases
from yuma_simulation_tpu_torch.simulation.aot import configure_executable_cache
from yuma_simulation_tpu_torch.simulation.engine import resolve_device
from yuma_simulation_tpu_torch.telemetry.runctx import RunContext
from yuma_simulation_tpu_torch.utils.logging import setup_logging
from yuma_simulation_tpu_torch.utils.profiling import profile_trace
from yuma_simulation_tpu_torch.v1.api import generate_chart_table


def main(argv: list[str] | None = None) -> dict[str, float]:
    """Write one table per `--bond-penalty` value, each as it completes (with
    `--fleet-store`, all of them once the fleet has published every table).
    Returns the wall seconds each table this process built took, by value."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--bond-penalty",
        nargs="+",
        default=["0", "0.5", "0.99", "1.0"],
        help="bond_penalty sweep values; kept as strings so output file "
        "names match the reference's (b0, b0.5, b0.99, b1.0)",
    )
    parser.add_argument(
        "--cases",
        nargs="*",
        default=None,
        help="registry keys of cases to include, e.g. 'Case 3' "
        "(default: all registered cases)",
    )
    parser.add_argument("--out-dir", type=pathlib.Path, default=pathlib.Path("."))
    parser.add_argument(
        "--no-draggable",
        action="store_true",
        help="emit the notebook-style table instead of the drag-to-scroll one",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="the device to simulate on (default: the card; without CUDA "
        "this raises: pass --device cpu to run on the CPU)",
    )
    parser.add_argument(
        "--profile-dir",
        default=None,
        help="write a torch.profiler trace of the run to DIR/trace.json",
    )
    parser.add_argument(
        "--executable-cache",
        default=None,
        metavar="DIR",
        help="build the CUDA kernels' libraries into DIR, the library cache: a "
        "second invocation against the same DIR loads them instead of running "
        "nvcc; cache_stats.json is published there on exit",
    )
    parser.add_argument(
        "--fleet-store",
        default=None,
        metavar="DIR",
        help="coordinate the per-beta tables through a shared fleet store: N "
        "concurrent invocations pointed at DIR split the betas into "
        "lease-claimed units, each table builds exactly once across them, a "
        "dying process's beta is requeued on lease expiry, and every "
        "invocation writes the complete HTML set",
    )
    args = parser.parse_args(argv)
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            "charts_table_generator renders its charts with matplotlib, which is "
            "not installed; the simulation itself does not need it "
            "(yuma_simulation_tpu_torch.v1.api._simulate_suite)"
        ) from exc
    setup_logging()
    device = resolve_device(args.device)
    cache = (
        configure_executable_cache(args.executable_cache) if args.executable_cache else None
    )
    cases = [create_case(name) for name in args.cases] if args.cases else get_cases()
    args.out_dir.mkdir(parents=True, exist_ok=True)
    seconds = {}

    def build_table(bond_penalty: str) -> bytes:
        t0 = time.perf_counter()
        hp = SimulationHyperparameters(bond_penalty=float(bond_penalty))
        table = generate_chart_table(
            cases, canonical_versions(), hp,
            draggable_table=not args.no_draggable, device=device,
        )
        seconds[bond_penalty] = time.perf_counter() - t0
        return table.data.encode("utf-8")

    def write_table(bond_penalty: str, data: bytes) -> None:
        file_name = args.out_dir / f"simulation_results_b{bond_penalty}.html"
        file_name.write_bytes(data)
        took = f" ({seconds[bond_penalty]:.3f} s)" if bond_penalty in seconds else ""
        print(f"HTML saved to {file_name}{took}")

    # One telemetry run for the invocation; each table's suite is a
    # "chart_suite" span under it (v1.api._simulate_suite).
    with RunContext(), profile_trace(args.profile_dir):
        if args.fleet_store is not None:
            from yuma_simulation_tpu_torch.fabric import run_fleet_artifacts

            tables = run_fleet_artifacts(
                args.bond_penalty, build_table, args.fleet_store,
                tag="chart_tables",
                config_fingerprint={
                    "driver": "yuma-charts",
                    "betas": list(args.bond_penalty),
                    "cases": [case.name for case in cases],
                    "draggable": not args.no_draggable,
                },
            )
            for bond_penalty, data in tables.items():
                write_table(bond_penalty, data)
        else:
            for bond_penalty in args.bond_penalty:
                write_table(bond_penalty, build_table(bond_penalty))
    if cache is not None:
        print(json.dumps({"executable_cache": cache.write_stats()}))
    return seconds


if __name__ == "__main__":
    main()

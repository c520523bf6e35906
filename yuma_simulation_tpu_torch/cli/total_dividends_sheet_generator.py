"""Generate the per-beta total-dividends CSV sheets.

The port's counterpart of the JAX package's
`cli/total_dividends_sheet_generator.py` (reference
scripts/total_dividends_sheet_generator.py:12-66): the same file names
(`total_dividends_b{beta}.csv`), the same `%.6f` rendering and the same NaN
check, each version's 14-case suite simulated as one batched call, on the
card unless `--device cpu` is given:

    python -m yuma_simulation_tpu_torch.cli.total_dividends_sheet_generator \
        [--bond-penalty 0 0.5 0.99 1.0] [--out-dir DIR] [--device cuda|cpu] \
        [--profile-dir DIR] [--executable-cache DIR] [--fleet-store DIR]

The invocation is one telemetry run, each sheet a span under it;
`--profile-dir` writes a `torch.profiler` Chrome trace of the whole run.
`--executable-cache DIR` makes DIR the kernels' build directory (the
library cache of `ops/_build.py`): a second invocation against it loads the
libraries without running `nvcc`, and its `cache_stats.json` is printed and
published there on exit. `--fleet-store DIR` coordinates the sheets through
a shared fleet store (:func:`..fabric.run_fleet_artifacts`): concurrent
invocations pointed at DIR split the betas into lease-claimed units, each
sheet is built exactly once across them, a dying process's beta is
requeued when its lease expires, and every invocation writes the whole
CSV set once every sheet is published.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

from yuma_simulation_tpu_torch.models.config import SimulationHyperparameters
from yuma_simulation_tpu_torch.models.variants import canonical_versions
from yuma_simulation_tpu_torch.reporting.tables import generate_total_dividends_table
from yuma_simulation_tpu_torch.scenarios import get_cases
from yuma_simulation_tpu_torch.simulation.aot import configure_executable_cache
from yuma_simulation_tpu_torch.simulation.engine import resolve_device
from yuma_simulation_tpu_torch.telemetry.runctx import RunContext, span
from yuma_simulation_tpu_torch.utils.logging import setup_logging
from yuma_simulation_tpu_torch.utils.profiling import profile_trace


def main(argv: list[str] | None = None) -> dict[str, float]:
    """Write one sheet per `--bond-penalty` value, each as it completes (with
    `--fleet-store`, all of them once the fleet has published every sheet).
    Returns the wall seconds each sheet this process built took, by value."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--bond-penalty",
        nargs="+",
        default=["0", "0.5", "0.99", "1.0"],
        help="bond_penalty sweep values; kept as strings so output file "
        "names match the reference's (b0, b0.5, b0.99, b1.0)",
    )
    parser.add_argument("--out-dir", type=pathlib.Path, default=pathlib.Path("."))
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
        help="coordinate the per-beta sheets through a shared fleet store: N "
        "concurrent invocations pointed at DIR split the betas into "
        "lease-claimed units, each sheet builds exactly once across them, a "
        "dying process's beta is requeued on lease expiry, and every "
        "invocation writes the complete CSV set",
    )
    args = parser.parse_args(argv)
    setup_logging()
    device = resolve_device(args.device)
    cache = (
        configure_executable_cache(args.executable_cache) if args.executable_cache else None
    )
    cases = get_cases()
    args.out_dir.mkdir(parents=True, exist_ok=True)
    seconds = {}

    def build_sheet(bond_penalty: str) -> bytes:
        print(f"Generating total dividends sheet for bond_penalty={bond_penalty}")
        t0 = time.perf_counter()
        hp = SimulationHyperparameters(bond_penalty=float(bond_penalty))
        with span(f"sheet:b{bond_penalty}"):
            table = generate_total_dividends_table(
                cases, canonical_versions(), hp, device=device
            )
        if table.has_nan():
            print("Warning: NaN values detected in the dividends table.")
        data = table.to_csv(float_format="%.6f").encode()
        seconds[bond_penalty] = time.perf_counter() - t0
        return data

    def write_sheet(bond_penalty: str, data: bytes) -> None:
        file_name = args.out_dir / f"total_dividends_b{bond_penalty}.csv"
        file_name.write_bytes(data)
        took = f" ({seconds[bond_penalty]:.3f} s)" if bond_penalty in seconds else ""
        print(f"CSV saved to {file_name}{took}")

    with RunContext(), profile_trace(args.profile_dir):
        if args.fleet_store is not None:
            # The fleet path writes after completion: the full set exists
            # only once every invocation's units are published.
            from yuma_simulation_tpu_torch.fabric import run_fleet_artifacts

            sheets = run_fleet_artifacts(
                args.bond_penalty, build_sheet, args.fleet_store,
                tag="dividend_sheets",
                config_fingerprint={"driver": "yuma-dividends",
                                    "betas": list(args.bond_penalty)},
            )
            for bond_penalty, data in sheets.items():
                write_sheet(bond_penalty, data)
        else:
            for bond_penalty in args.bond_penalty:
                write_sheet(bond_penalty, build_sheet(bond_penalty))
    if cache is not None:
        print(json.dumps({"executable_cache": cache.write_stats()}))
    return seconds


if __name__ == "__main__":
    main()

"""The generated-suite supervisor drill.

``python -m yuma_simulation_tpu_torch.foundry --drill --bundle-dir DIR``
draws a seeded population from the adversarial families (copiers,
cartels, churn shocks, takeovers — every draw a serializable DSL spec),
runs it through the supervised tier (`SweepSupervisor.run_batch`,
donor-packed, 100% numerics canaries) into a flight-recorder bundle at
DIR, and exits non-zero on quarantined lanes or confirmed drift; the JAX
package's ``python -m tools.obsreport DIR --check`` and ``tools.driftreport
DIR --check --require`` read the bundle. It runs on the card unless given
``--device cpu`` (the JAX package's drill forces the CPU). A donor-packed
suite carries miner masks, which only the eager rung takes, and the
supervisor's quarantine guard rides that rung too: on the card the drill
runs plain PyTorch, no kernel.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def build_drill_suite(seed: int, size: int):
    """The drill population: a deterministic rotation over the four
    adversarial families, each draw's parameters derived from (seed,
    index). Same (seed, size) -> the JAX package's suite, bitwise."""
    from yuma_simulation_tpu_torch.foundry.adversarial import (
        cartel_scenario,
        stake_churn_scenario,
        takeover_scenario,
        weight_copier_scenario,
    )
    from yuma_simulation_tpu_torch.foundry.montecarlo import derived_seed

    families = (
        lambda s: weight_copier_scenario(s, num_miners=4, num_epochs=16),
        lambda s: cartel_scenario(s, num_miners=4, num_epochs=16),
        lambda s: stake_churn_scenario(
            s, num_validators=3, num_miners=4, num_epochs=16
        ),
        lambda s: takeover_scenario(s, num_miners=4, num_epochs=16),
    )
    return [
        families[i % len(families)](derived_seed(seed, i)).scenario
        for i in range(size)
    ]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m yuma_simulation_tpu_torch.foundry",
        description=__doc__.split("\n\n")[0],
    )
    parser.add_argument(
        "--drill",
        action="store_true",
        help="run the generated-suite supervisor drill",
    )
    parser.add_argument(
        "--bundle-dir",
        default="foundry-bundle",
        help="flight-bundle directory the drill publishes into",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--suite-size", type=int, default=8,
        help="generated scenarios in the drill population",
    )
    parser.add_argument(
        "--version", default="Yuma 1 (paper)",
        help="Yuma version the drill sweeps",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="the device to simulate on (default: the card; without CUDA "
        "this raises: pass --device cpu to run on the CPU)",
    )
    args = parser.parse_args(argv)
    if not args.drill:
        parser.print_help()
        return 2

    import pathlib

    target = pathlib.Path(args.bundle_dir)
    if target.exists() and any(target.iterdir()):
        # A resumed drill satisfies units from the prior run's chunks
        # and generates nothing: refuse.
        print(
            f"--bundle-dir {args.bundle_dir!r} exists and is not empty; "
            "point the drill at a fresh directory",
            file=sys.stderr,
        )
        return 2

    from yuma_simulation_tpu_torch.resilience.supervisor import SweepSupervisor
    from yuma_simulation_tpu_torch.simulation.engine import resolve_device
    from yuma_simulation_tpu_torch.utils import setup_logging

    setup_logging()
    device = resolve_device(args.device)
    suite = build_drill_suite(args.seed, args.suite_size)
    supervisor = SweepSupervisor(
        directory=args.bundle_dir,
        unit_size=2,
        canary_fraction=1.0,
    )
    out = supervisor.run_batch(
        suite, args.version, pack=True, tag="foundry_drill", device=device
    )
    report = out["report"]
    quarantined = len(out["quarantine"].entries)
    print(
        f"foundry drill complete: {len(suite)} generated scenarios "
        f"(seed={args.seed}) units_completed={report.units_completed} "
        f"canaries={report.canaries_run} drift={report.drift_events} "
        f"quarantined={quarantined}"
    )
    return 1 if (quarantined or report.drift_events) else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())

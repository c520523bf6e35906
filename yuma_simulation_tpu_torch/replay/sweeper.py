"""The trailing-window scheduled sweep: timelines x variants -> fleet.

The chain-replay service's batch half: for every
subnet timeline in the archive and every requested Yuma variant,
compile the trailing window into the epoch-varying replay scenario and
run it as lease-claimed :func:`..fabric.scheduler.run_fleet_grid` units
— numerics canaries on, so every unit's per-epoch fingerprints ride the
fleet store's ``numerics.jsonl`` and ``tools/driftreport.py --check
--require`` gates the published bundle exactly like every other drill
artifact. Each (subnet, variant) pair gets its own fleet store (one
manifest = one scenario+version grid); N processes invoked with the
same ``store_root`` split the work through the fabric's ordinary
lease-claim path.

After each pair's fleet units publish, the sweep refreshes that pair's
:mod:`.statecache` baseline (segmented suffix-resume build, carry
checkpointed every ``stride`` epochs) — the warm state the serve tier's
what-ifs resume from, so the nightly sweep is also what keeps the
what-if API's cache hit rate high.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
import re
from typing import Optional, Sequence, Union

import numpy as np

from yuma_simulation_tpu_torch.replay.archive import SnapshotArchive
from yuma_simulation_tpu_torch.replay.statecache import StateCache
from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

logger = logging.getLogger(__name__)


def version_slug(version: str) -> str:
    """Filesystem-safe variant name (``"Yuma 1 (paper)"`` ->
    ``"yuma-1-paper"``)."""
    return re.sub(r"[^a-z0-9]+", "-", version.lower()).strip("-")


@dataclasses.dataclass
class SweepOutcome:
    """One (subnet, variant) pair's sweep result."""

    netuid: int
    version: str
    store: str
    units_completed: int
    canaries_run: int
    drift_events: int
    baseline_key: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def sweep_trailing_window(
    archive: SnapshotArchive,
    cache: StateCache,
    *,
    store_root: Union[str, pathlib.Path],
    versions: Sequence[str],
    subnets: Optional[Sequence[int]] = None,
    window: Optional[int] = None,
    epochs_per_snapshot: int = 4,
    stride: int = 8,
    canary_fraction: float = 1.0,
    unit_size: int = 8,
    config=None,
    device="cuda",
) -> dict:
    """Run the trailing-window sweep (module docstring). Returns the
    summary dict also published at ``<store_root>/sweep_summary.json``:
    per-pair unit/canary/drift counts, the fleet store paths (what CI
    gates with ``driftreport --check --require``), and the refreshed
    baseline keys. The fleet units and the baseline build run on
    `device` (the card by default): the units on the eager rung (a grid
    sweep's one rung, as the JAX package's run on its XLA rung), the
    baseline on its pinned rung (:func:`.statecache.pinned_engine`)."""
    from yuma_simulation_tpu_torch.fabric.scheduler import (
        FleetConfig,
        run_fleet_grid,
    )
    from yuma_simulation_tpu_torch.models.config import YumaConfig

    config = config if config is not None else YumaConfig()
    store_root = pathlib.Path(store_root)
    store_root.mkdir(parents=True, exist_ok=True)
    targets = list(subnets) if subnets is not None else archive.subnets()
    if not targets:
        raise ValueError(f"archive {archive.root} holds no timelines")
    if not versions:
        raise ValueError("sweep_trailing_window needs at least one version")
    outcomes: list[SweepOutcome] = []
    for netuid in targets:
        scenario = archive.window_scenario(
            netuid, window=window, epochs_per_snapshot=epochs_per_snapshot
        )
        fingerprint = archive.timeline_fingerprint(netuid, window=window)
        for version in versions:
            store = store_root / f"subnet_{netuid}" / version_slug(version)
            fleet = FleetConfig(
                directory=store,
                canary_fraction=canary_fraction,
                unit_size=unit_size,
            )
            # One-point grid on a default-valued axis: the baseline
            # trajectory as ONE lease-claimed, canaried, at-most-once-
            # published fleet unit (what-if sweeps over real axes ride
            # the same seam with more points).
            out = run_fleet_grid(
                scenario,
                version,
                fleet,
                axes={"bond_alpha": [float(config.bond_alpha)]},
                tag=f"replay:{netuid}:{version_slug(version)}",
                device=device,
            )
            report = out["report"]
            meta = cache.build_baseline(
                scenario,
                version,
                config,
                scenario_fingerprint=fingerprint,
                stride=stride,
                device=device,
            )
            # The fleet unit and the cache baseline simulate one
            # trajectory through two carriers, on different rungs on the
            # card (the unit on eager, the baseline on its pinned kernel
            # rung), so they are not bitwise: this checks their shapes
            # only. The tests and the card's replay phase hold the two
            # rungs to each other within ATOL.
            fleet_div = np.asarray(out["dividends"])[0]
            cached_div = cache.load_baseline(meta.key)["dividends"]
            if fleet_div.shape != cached_div.shape:
                raise RuntimeError(
                    f"replay sweep subnet {netuid} {version!r}: fleet "
                    f"dividends {fleet_div.shape} vs cached baseline "
                    f"{cached_div.shape}"
                )
            outcomes.append(
                SweepOutcome(
                    netuid=netuid,
                    version=version,
                    store=str(store),
                    units_completed=int(report.units_published),
                    canaries_run=int(report.canaries_run),
                    drift_events=int(report.drift_events),
                    baseline_key=meta.key,
                )
            )
            logger.info(
                "replay sweep subnet=%d version=%s units=%d canaries=%d "
                "drift=%d baseline=%s",
                netuid,
                version,
                report.units_published,
                report.canaries_run,
                report.drift_events,
                meta.key[:16],
            )
    summary = {
        "subnets": targets,
        "versions": list(versions),
        "window": window,
        "epochs_per_snapshot": epochs_per_snapshot,
        "outcomes": [o.to_json() for o in outcomes],
        "stores": [o.store for o in outcomes],
        "drift_events": sum(o.drift_events for o in outcomes),
        "canaries_run": sum(o.canaries_run for o in outcomes),
        "units_completed": sum(o.units_completed for o in outcomes),
    }
    publish_atomic(
        store_root / "sweep_summary.json",
        json.dumps(summary, indent=2, sort_keys=True).encode(),
    )
    return summary

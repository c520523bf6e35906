"""The continuous multi-subnet replay controller (ROADMAP item 5's
standing half): watch N archive timelines, sweep ONLY the suffix past a
durable watermark, and self-heal through crashes, corrupt blobs, and
stalled feeds.

The one-shot :mod:`.sweeper` re-simulates every (subnet x variant)
window from scratch each time it runs. This module is its standing
replacement for archives that KEEP APPENDING:

- **Watermarks** (:class:`WatermarkStore`) — one durable JSONL per
  (subnet x variant) recording the last swept block, the cumulative
  epoch count, and the cache baseline that holds the carry at that
  point. Appends republish the whole file through
  :func:`..utils.checkpoint.publish_atomic` (the
  :class:`..resilience.supervisor.FailureLedger` discipline), and loads
  tolerate a torn tail, so a SIGKILL at any instant leaves a parseable
  history whose newest valid record IS the resume point.
- **Incremental windows** — each cycle compiles the entries past the
  watermark into one scenario (:meth:`..replay.archive.SnapshotArchive
  .scenario_for_blocks`) and runs it as a lease-claimed
  :func:`..fabric.scheduler.run_fleet_grid` unit resumed from the
  cached carry (``initial_state=`` / ``epoch_offset=`` — the engine's
  suffix-resume contract), so an incremental window's dividends are
  BITWISE the corresponding rows of a full from-genesis re-simulation
  (cross-checked against the extended cache baseline on every sweep).
- **Exactly-once publication** — the window's fleet store path is
  derived from its block span and the window membership is pinned
  durably (``inflight.json``) BEFORE dispatch, so a controller killed
  between fleet publish and watermark advance resumes the SAME window:
  already-published units are satisfied instantly by the store's
  at-most-once publish gate and only genuinely in-flight work
  re-simulates. The watermark advances strictly AFTER publish +
  baseline extension — at-least-once sweep, exactly-once publication.
- **Quarantine** (corrupt blobs) — a snapshot whose blob fails its
  content-address check raises the archive's typed
  :class:`..replay.archive.ArchiveError`; the controller records a
  durable ``subnet_quarantined`` ledger entry, excludes the block from
  every future window (the window fingerprint covers exactly the
  entries compiled), and keeps the subnet draining.
- **Stall demotion** — a subnet whose head block stops moving past
  ``stall_deadline_seconds`` emits one typed ``subnet_stalled`` record
  and drops to the slow poll tier until it appends again.
- **Freshness SLO + backpressure** — per cycle, each live subnet feeds
  one good/bad verdict into the ``replay_freshness`` objective
  (:data:`..telemetry.slo.DEFAULT_SLO_SPECS`; ``replay_staleness_
  seconds`` is the gauge twin), and ``max_windows_per_cycle`` sheds the
  lowest-priority refreshes first when the backlog exceeds the budget.

Helper fleet hosts (:func:`run_host`, ``python -m
yuma_simulation_tpu_torch.replay --host``) scan the pair directories for
in-flight window specs, reconstruct the identical scenario + carry from
the shared archive/cache, and join the fleet store through the ordinary
lease-claim path — the manifest's carry digest rejects a host holding a
stale resume point instead of letting it publish different bits.

**The rung.** Every window sweeps on :attr:`ControllerConfig.device` (the
card by default), and the controller pins its whole pipeline to the
eager rung there (:data:`CONTROLLER_ENGINE`, the port's counterpart of
the JAX package's "xla" rung): the fleet units of a resumed window run
the supervisor's eager rung (a suffix-resume unit cannot arm the
quarantine guard), the from-scratch baselines are built with
``engine="eager"``, and :meth:`..replay.statecache.StateCache
.extend_baseline` keeps the prior baseline's rung. Left to
``StateCache.resolve``'s "auto", a baseline would pin K2 on the card
while the units ran eager, and the bitwise cross-check of every window
would fail there (on the CPU both are eager).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np

from yuma_simulation_tpu_torch.replay.archive import (
    ArchiveError,
    SnapshotArchive,
    entries_fingerprint,
)
from yuma_simulation_tpu_torch.replay.statecache import StateCache, StateCacheError
from yuma_simulation_tpu_torch.replay.sweeper import version_slug
from yuma_simulation_tpu_torch.utils.checkpoint import (
    publish_atomic,
    read_jsonl_tolerant,
)
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

#: The rung every window's units and baselines run on (module docstring).
CONTROLLER_ENGINE = "eager"


class ControllerError(RuntimeError):
    """A continuous-replay invariant violation (non-monotone watermark
    advance, a fleet/cache bitwise mismatch)."""


# ---------------------------------------------------------- watermarks


class WatermarkStore:
    """Durable per-(subnet x variant) sweep watermarks.

    Layout: ``<root>/subnet_<netuid>/<version-slug>.jsonl``, one JSON
    record per advance (append-ordered). Every append republishes the
    whole file atomically; loads skip torn/corrupt lines and take the
    highest-block valid record, so partial writes from a killed
    controller can delay progress by one window but never corrupt or
    regress it."""

    def __init__(self, root: Union[str, pathlib.Path]):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def path(self, netuid: int, version: str) -> pathlib.Path:
        return (
            self.root
            / f"subnet_{int(netuid)}"
            / f"{version_slug(version)}.jsonl"
        )

    def history(self, netuid: int, version: str) -> list[dict]:
        """All valid records, append order (torn lines skipped)."""
        return read_jsonl_tolerant(self.path(netuid, version))

    def load(self, netuid: int, version: str) -> Optional[dict]:
        """The current watermark: the highest-block valid record, or
        None when the pair has never been swept."""
        records = [
            r
            for r in self.history(netuid, version)
            if isinstance(r.get("block"), int)
        ]
        if not records:
            return None
        return max(records, key=lambda r: r["block"])

    def advance(
        self,
        netuid: int,
        version: str,
        *,
        block: int,
        epochs: int,
        baseline_key: str,
        window_store: str = "",
    ) -> dict:
        """Append one advance record (strictly monotone in block) and
        republish the file atomically. The caller MUST have published
        the window's fleet results and extended the cache baseline
        first — this record is the commit point that makes them
        visible to resume."""
        current = self.load(netuid, version)
        if current is not None and int(block) <= current["block"]:
            raise ControllerError(
                f"watermark subnet={netuid} {version!r} cannot advance "
                f"{current['block']} -> {block} (must be monotone)"
            )
        record = {
            "netuid": int(netuid),
            "version": version,
            "block": int(block),
            "epochs": int(epochs),
            "baseline_key": baseline_key,
            "window_store": window_store,
            "t": round(time.time(), 6),
        }
        records = self.history(netuid, version) + [record]
        payload = "".join(
            json.dumps(r, sort_keys=True) + "\n" for r in records
        )
        path = self.path(netuid, version)
        path.parent.mkdir(parents=True, exist_ok=True)
        publish_atomic(path, payload.encode())
        return record


# ------------------------------------------------------- window specs


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """One in-flight incremental window, pinned durably BEFORE
    dispatch: enough for a crashed controller to resume the identical
    window (same blocks -> same store -> same at-most-once units) and
    for a helper fleet host to reconstruct the identical scenario and
    carry from the shared archive/cache."""

    netuid: int
    version: str
    #: the blocks this window compiles (quarantine already applied).
    blocks: tuple
    epochs_per_snapshot: int
    #: epochs already swept — the suffix's global epoch offset.
    epoch_offset: int
    #: cache baseline holding the carry at `epoch_offset` ("" = full
    #: from-scratch window, no resume).
    prior_baseline_key: str
    #: watermark block this window extends (None = never swept) — a
    #: resume only reuses the spec while the watermark still matches.
    base_block: Optional[int]
    #: full-window fingerprint (prefix + this window, quarantine
    #: filtered) the extended cache baseline is keyed on.
    scenario_fingerprint: str
    #: the window's fleet store directory.
    store: str

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["blocks"] = list(self.blocks)
        return d

    @classmethod
    def from_json(cls, payload: dict) -> "WindowSpec":
        try:
            return cls(
                netuid=int(payload["netuid"]),
                version=str(payload["version"]),
                blocks=tuple(int(b) for b in payload["blocks"]),
                epochs_per_snapshot=int(payload["epochs_per_snapshot"]),
                epoch_offset=int(payload["epoch_offset"]),
                prior_baseline_key=str(payload["prior_baseline_key"]),
                base_block=(
                    None
                    if payload.get("base_block") is None
                    else int(payload["base_block"])
                ),
                scenario_fingerprint=str(payload["scenario_fingerprint"]),
                store=str(payload["store"]),
            )
        except (KeyError, TypeError, ValueError) as exc:
            raise ControllerError(f"corrupt window spec: {exc}") from None


def window_tag(spec: WindowSpec) -> str:
    """The fleet tag of one window's store: what the controller and every
    helper host pass to ``run_fleet_grid``, so that whichever of them
    writes the store's manifest first, the others verify the same one."""
    return (
        f"replay-controller:{spec.netuid}:{version_slug(spec.version)}:"
        f"{spec.blocks[0]}-{spec.blocks[-1]}"
    )


# ----------------------------------------------------------- config


@dataclasses.dataclass
class ControllerConfig:
    """The controller's knobs (defaults sized for the CPU soak)."""

    #: store root: per-pair fleet stores, watermarks, quarantine ledger.
    store_root: Union[str, pathlib.Path] = "replay-store"
    versions: Sequence[str] = ("Yuma 2 (Adrian-Fish)",)
    epochs_per_snapshot: int = 4
    #: carry-checkpoint stride of the cache baselines.
    stride: int = 8
    unit_size: int = 8
    canary_fraction: float = 1.0
    #: fast-tier poll period (live subnets).
    poll_seconds: float = 0.5
    #: slow-tier poll period (stalled subnets).
    slow_poll_seconds: float = 5.0
    #: head block unchanged this long -> subnet_stalled + slow tier.
    stall_deadline_seconds: float = 10.0
    #: staleness past this is a bad `replay_fresh` verdict.
    freshness_budget_seconds: float = 30.0
    #: windows swept per cycle before low-priority refreshes shed
    #: (None = unbounded).
    max_windows_per_cycle: Optional[int] = None
    #: netuid -> priority (higher sweeps first; missing = 0).
    priorities: dict = dataclasses.field(default_factory=dict)
    #: lease tuning forwarded to each window's FleetConfig.
    lease_ttl_seconds: float = 30.0
    max_wait_seconds: float = 600.0
    #: Yuma hyperparameters (None -> package defaults).
    config: object = None
    #: Continuous-telemetry rotation for the controller's flight bundle
    #: (``--rotate-flight``): ``True`` = default
    #: :class:`..telemetry.flight.RotationPolicy` bounds, a policy
    #: instance pins them, ``None`` (default) defers to the
    #: ``YUMA_TPU_FLIGHT_ROTATE`` env opt-in — rotation stays OFF
    #: unless explicitly requested.
    flight_rotation: object = None
    #: On-demand profiling (``--profile-window``): > 0 arms ONE guarded
    #: ``torch.profiler`` window (the ops plane's
    #: :class:`..telemetry.ops.ProfileSession`, which starts and stops
    #: the profiler on its own thread) of this many seconds over the
    #: first cycle that sweeps work, registered into the bundle's
    #: ``profiles.jsonl``. 0 disables (the default).
    profile_window_seconds: float = 0.0
    #: The device every window sweeps on: "cuda" (the default; raises
    #: without CUDA) or "cpu". Never a fallback.
    device: str = "cuda"


@dataclasses.dataclass
class CycleReport:
    """What one poll cycle did (returned by :meth:`ReplayController
    .run_cycle`, aggregated by the soak)."""

    subnets_seen: int = 0
    subnets_live: int = 0
    subnets_stalled: int = 0
    windows_swept: int = 0
    windows_shed: int = 0
    snapshots_quarantined: int = 0
    max_staleness_seconds: float = 0.0
    #: (netuid, version, block_from, block_to) per swept window.
    swept: list = dataclasses.field(default_factory=list)


# -------------------------------------------------------- controller


class ReplayController:
    """The standing sweep loop (module docstring). One instance owns
    one store root; restarts are crash-safe by construction — all
    progress state (watermarks, quarantine, in-flight windows, fleet
    units) is durable, everything in memory is a rebuildable view."""

    def __init__(
        self,
        archive: SnapshotArchive,
        cache: StateCache,
        cfg: ControllerConfig,
        *,
        bundle_dir: Optional[Union[str, pathlib.Path]] = None,
    ):
        from yuma_simulation_tpu_torch.resilience.supervisor import FailureLedger
        from yuma_simulation_tpu_torch.simulation.engine import resolve_device
        from yuma_simulation_tpu_torch.telemetry.flight import FlightRecorder
        from yuma_simulation_tpu_torch.telemetry.metrics import get_registry
        from yuma_simulation_tpu_torch.telemetry.runctx import RunContext

        self.archive = archive
        self.cache = cache
        self.cfg = cfg
        # Raises here when CUDA is absent and the CPU was not asked for.
        self.device = resolve_device(cfg.device)
        self.store_root = pathlib.Path(cfg.store_root)
        self.store_root.mkdir(parents=True, exist_ok=True)
        self.watermarks = WatermarkStore(self.store_root / "watermarks")
        self.bundle_dir = pathlib.Path(
            bundle_dir if bundle_dir is not None else self.store_root
        )
        # Continuous-telemetry mode: resolve the rotation policy once
        # (config wins, env opt-in otherwise); the lifetime run is
        # pinned open so retention never reclaims its segments while
        # the controller stands.
        from yuma_simulation_tpu_torch.telemetry.flight import (
            RotationPolicy,
            rotation_from_env,
        )
        from yuma_simulation_tpu_torch.telemetry.ops import OpsPlane

        if cfg.flight_rotation is True:
            self.rotation = RotationPolicy()
        elif cfg.flight_rotation:
            self.rotation = cfg.flight_rotation
        else:
            self.rotation = rotation_from_env()
        self.recorder = FlightRecorder(
            self.bundle_dir, rotation=self.rotation
        )
        self.run = RunContext()
        #: Run ids a prior incarnation registered open and never closed
        #: — a clean shutdown always closes its run, so a stale marker
        #: means SIGKILL/crash. The first cycle ledgers one
        #: ``controller_restarted`` per stale run INSIDE its span (the
        #: ledger stamps trace context from the active run), which is
        #: the typed cause behind process-loss incidents.
        self._stale_runs: list[str] = []
        if self.rotation is not None:
            self._stale_runs = [
                r
                for r in self.recorder.open_run_ids()
                if r != self.run.run_id
            ]
            self.recorder.mark_run_open(self.run.run_id)
        from yuma_simulation_tpu_torch.telemetry.slo import get_slo_engine

        #: The live ops plane (debug vars/spans/profile) — transport-
        #: free; an embedding host (or the soak harness) mounts it.
        self.ops = OpsPlane(
            self.bundle_dir,
            registry=get_registry(),
            slo_engine=get_slo_engine(),
            run=self.run,
        )
        self._profiled = False
        #: durable quarantine ledger (reloaded on restart).
        self.ledger = FailureLedger(self.bundle_dir / "ledger.jsonl")
        self._quarantined: set[tuple[int, int]] = {
            (int(r["netuid"]), int(r["block"]))
            for r in self.ledger.entries("subnet_quarantined")
            if "netuid" in r and "block" in r
        }
        #: netuid -> (head block, wall time the head last MOVED).
        self._progress: dict[int, tuple[int, float]] = {}
        self._stalled: set[int] = set()
        #: netuid -> earliest wall time of the next poll (slow tier).
        self._next_poll: dict[int, float] = {}
        #: test-only crash/fault points: name -> callable(netuid,
        #: version); "post_publish" fires between the window's fleet +
        #: cache publication and the watermark advance.
        self.test_hooks: dict[str, Callable] = {}
        registry = get_registry()
        self._staleness_gauge = registry.gauge(
            "replay_staleness_seconds",
            help="worst-case age of the oldest unswept archive suffix",
        )
        self._live_gauge = registry.gauge(
            "subnets_live",
            help="subnets on the fast poll tier (not stalled)",
        )
        self._swept_counter = registry.counter(
            "windows_swept_total",
            help="incremental windows published by the replay controller",
        )
        self._quarantine_counter = registry.counter(
            "snapshots_quarantined_total",
            help="corrupt snapshot blobs quarantined by the controller",
        )
        from yuma_simulation_tpu_torch.telemetry.incident import IncidentEngine

        #: Incident intelligence: per-cycle tick feeds the time-series
        #: store from the live registry, ledgers detector anomalies,
        #: and appends correlated incident state to incidents.jsonl.
        self.incidents = IncidentEngine(
            self.ledger,
            self.recorder,
            registry=registry,
            source=self.run.run_id,
        )

    # -- quarantine -----------------------------------------------------

    def _usable(self, netuid: int, entry) -> bool:
        """True iff the entry's blob loads and verifies. A corrupt blob
        is quarantined durably (once) and excluded from every window
        this and any future controller compiles."""
        if (netuid, entry.block) in self._quarantined:
            return False
        try:
            self.archive.load(netuid, entry.block)
            return True
        except ArchiveError as exc:
            self._quarantined.add((netuid, entry.block))
            self.ledger.append(
                "subnet_quarantined",
                netuid=int(netuid),
                block=int(entry.block),
                key=entry.key,
                reason=str(exc),
            )
            log_event(
                logger,
                "subnet_quarantined",
                netuid=int(netuid),
                block=int(entry.block),
                reason=str(exc),
            )
            self._quarantine_counter.inc()
            return False

    # -- windows --------------------------------------------------------

    def _pair_dir(self, netuid: int, version: str) -> pathlib.Path:
        return (
            self.store_root
            / f"subnet_{int(netuid)}"
            / version_slug(version)
        )

    def _inflight_path(self, netuid: int, version: str) -> pathlib.Path:
        return self._pair_dir(netuid, version) / "inflight.json"

    def _load_inflight(
        self, netuid: int, version: str
    ) -> Optional[WindowSpec]:
        path = self._inflight_path(netuid, version)
        if not path.exists():
            return None
        try:
            payload = json.loads(path.read_text(encoding="utf-8"))
        except (OSError, json.JSONDecodeError):
            return None  # torn marker: fall through to a fresh window
        if "blocks" not in payload:
            return None  # committed marker ({}) — no in-flight window
        try:
            return WindowSpec.from_json(payload)
        except ControllerError:
            return None

    def _plan_window(
        self, netuid: int, version: str, timeline: list
    ) -> Optional[WindowSpec]:
        """The next window for one pair, resume-aware: an in-flight
        spec whose base still matches the watermark is reused verbatim
        (same blocks -> same store -> already-published units satisfy
        instantly); otherwise the quarantine-filtered suffix past the
        watermark becomes a fresh window."""
        wm = self.watermarks.load(netuid, version)
        base_block = wm["block"] if wm is not None else None
        inflight = self._load_inflight(netuid, version)
        if inflight is not None and inflight.base_block == base_block:
            return inflight
        pending = [
            e
            for e in timeline
            if (base_block is None or e.block > base_block)
            and self._usable(netuid, e)
        ]
        if not pending:
            return None
        epoch_offset = wm["epochs"] if wm is not None else 0
        prior_key = wm["baseline_key"] if wm is not None else ""
        blocks = [e.block for e in pending]
        if prior_key:
            try:
                self.cache.final_state(prior_key)
            except StateCacheError:
                # The carry was evicted (or predates final-state
                # publication): rebuild the pair from genesis — still
                # exactly-once-published (the full window is its own
                # deterministic store) and bitwise by definition.
                log_event(
                    logger,
                    "state_cache_miss",
                    netuid=int(netuid),
                    version=version,
                    baseline=prior_key[:16],
                    reason="controller carry unavailable; full rebuild",
                )
                prior_key, epoch_offset, base_block = "", 0, None
                blocks = [
                    e.block
                    for e in timeline
                    if self._usable(netuid, e)
                ]
                if not blocks:
                    return None
        swept_and_window = [
            e
            for e in timeline
            if e.block <= blocks[-1]
            and (netuid, e.block) not in self._quarantined
        ]
        store = (
            self._pair_dir(netuid, version)
            / f"window_{blocks[0]}_{blocks[-1]}"
        )
        return WindowSpec(
            netuid=int(netuid),
            version=version,
            blocks=tuple(blocks),
            epochs_per_snapshot=self.cfg.epochs_per_snapshot,
            epoch_offset=int(epoch_offset),
            prior_baseline_key=prior_key,
            base_block=base_block,
            scenario_fingerprint=entries_fingerprint(swept_and_window),
            store=str(store),
        )

    def sweep_window(self, spec: WindowSpec) -> dict:
        """Execute one pinned window end to end: durable intent ->
        fleet grid (suffix-resumed, canaried, at-most-once published)
        -> cache baseline extension -> bitwise cross-check -> watermark
        advance. Crash-safe at every boundary (module docstring)."""
        from yuma_simulation_tpu_torch.fabric.scheduler import (
            FleetConfig,
            run_fleet_grid,
        )
        from yuma_simulation_tpu_torch.models.config import YumaConfig

        cfg = self.cfg
        config = cfg.config if cfg.config is not None else YumaConfig()
        netuid, version = spec.netuid, spec.version
        self._pair_dir(netuid, version).mkdir(parents=True, exist_ok=True)
        # Pin the window membership BEFORE dispatch: a controller
        # killed past this point resumes THIS window even if the
        # archive grew meanwhile — newer blocks wait for the next one.
        publish_atomic(
            self._inflight_path(netuid, version),
            json.dumps(spec.to_json(), sort_keys=True).encode(),
        )
        scenario = self.archive.scenario_for_blocks(
            netuid,
            spec.blocks,
            epochs_per_snapshot=spec.epochs_per_snapshot,
        )
        carry = None
        if spec.prior_baseline_key:
            carry = self.cache.final_state(spec.prior_baseline_key)
        store = pathlib.Path(spec.store)
        store.mkdir(parents=True, exist_ok=True)
        publish_atomic(
            store / "window.json",
            json.dumps(spec.to_json(), sort_keys=True).encode(),
        )
        fleet = FleetConfig(
            directory=store,
            unit_size=cfg.unit_size,
            canary_fraction=cfg.canary_fraction,
            lease_ttl_seconds=cfg.lease_ttl_seconds,
            max_wait_seconds=cfg.max_wait_seconds,
        )
        out = run_fleet_grid(
            scenario,
            version,
            fleet,
            axes={"bond_alpha": [float(config.bond_alpha)]},
            tag=window_tag(spec),
            initial_state=carry,
            epoch_offset=spec.epoch_offset,
            device=self.device,
        )
        if carry is not None:
            # Keeps the prior baseline's rung (CONTROLLER_ENGINE).
            meta = self.cache.extend_baseline(
                spec.prior_baseline_key,
                scenario,
                scenario_fingerprint=spec.scenario_fingerprint,
                config=config,
                device=self.device,
            )
        else:
            # From-scratch builds pin the eager rung: every fleet grid
            # unit computes on it, and the bitwise incremental contract
            # needs baseline and fleet on ONE engine for the pair's
            # whole lifetime.
            meta = self.cache.build_baseline(
                scenario,
                version,
                config,
                scenario_fingerprint=spec.scenario_fingerprint,
                stride=cfg.stride,
                engine=CONTROLLER_ENGINE,
                device=self.device,
            )
        fleet_div = np.asarray(out["dividends"])[0]
        cached_div = self.cache.load_baseline(meta.key)["dividends"][
            spec.epoch_offset :
        ]
        if not np.array_equal(fleet_div, cached_div):
            raise ControllerError(
                f"window subnet={netuid} {version!r} blocks "
                f"{spec.blocks[0]}..{spec.blocks[-1]}: fleet dividends "
                "are not bitwise the extended baseline's suffix — a "
                "carrier broke the suffix-resume contract"
            )
        hook = self.test_hooks.get("post_publish")
        if hook is not None:
            hook(netuid, version)
        suffix_epochs = len(spec.blocks) * spec.epochs_per_snapshot
        total_epochs = spec.epoch_offset + suffix_epochs
        self.watermarks.advance(
            netuid,
            version,
            block=spec.blocks[-1],
            epochs=total_epochs,
            baseline_key=meta.key,
            window_store=spec.store,
        )
        # {} = committed: the next cycle plans a fresh window.
        publish_atomic(self._inflight_path(netuid, version), b"{}")
        report = out["report"]
        self.ledger.append(
            "window_swept",
            netuid=int(netuid),
            version=version,
            block_from=int(spec.blocks[0]),
            block_to=int(spec.blocks[-1]),
            suffix_epochs=suffix_epochs,
            total_epochs=total_epochs,
            resumed=bool(carry is not None),
            units=int(report.units_published),
            canaries=int(report.canaries_run),
            drift=int(report.drift_events),
            store=spec.store,
        )
        self.ledger.append(
            "watermark_advanced",
            netuid=int(netuid),
            version=version,
            block=int(spec.blocks[-1]),
            epochs=total_epochs,
            baseline=meta.key[:16],
        )
        log_event(
            logger,
            "window_swept",
            level=logging.INFO,
            netuid=int(netuid),
            version=version,
            block_from=int(spec.blocks[0]),
            block_to=int(spec.blocks[-1]),
            suffix_epochs=suffix_epochs,
            total_epochs=total_epochs,
        )
        log_event(
            logger,
            "watermark_advanced",
            level=logging.INFO,
            netuid=int(netuid),
            version=version,
            block=int(spec.blocks[-1]),
            epochs=total_epochs,
        )
        self._swept_counter.inc()
        return {
            "netuid": netuid,
            "version": version,
            "blocks": list(spec.blocks),
            "baseline_key": meta.key,
            "suffix_epochs": suffix_epochs,
            "total_epochs": total_epochs,
        }

    # -- the cycle ------------------------------------------------------

    def _observe_subnet(
        self, netuid: int, timeline: list, now: float
    ) -> None:
        """Stall tracking + ingest events for one polled subnet."""
        head = timeline[-1].block if timeline else -1
        prev = self._progress.get(netuid)
        if prev is None or head > prev[0]:
            if prev is not None and head > prev[0]:
                new = sum(1 for e in timeline if e.block > prev[0])
                self.ledger.append(
                    "subnet_ingested",
                    netuid=int(netuid),
                    new_blocks=new,
                    head_block=int(head),
                )
                log_event(
                    logger,
                    "subnet_ingested",
                    level=logging.INFO,
                    netuid=int(netuid),
                    new_blocks=new,
                    head_block=int(head),
                )
            self._progress[netuid] = (head, now)
            if netuid in self._stalled:
                self._stalled.discard(netuid)
                self._next_poll.pop(netuid, None)
        elif (
            netuid not in self._stalled
            and now - prev[1] > self.cfg.stall_deadline_seconds
        ):
            self._stalled.add(netuid)
            self.ledger.append(
                "subnet_stalled",
                netuid=int(netuid),
                head_block=int(head),
                stalled_seconds=round(now - prev[1], 3),
            )
            log_event(
                logger,
                "subnet_stalled",
                netuid=int(netuid),
                head_block=int(head),
                stalled_seconds=round(now - prev[1], 3),
            )

    def _staleness(
        self, netuid: int, version: str, pending: bool, now: float
    ) -> float:
        """Seconds the pair's oldest unswept suffix has waited. Fully
        drained -> 0. Anchored on the durable watermark timestamp when
        one exists (conservative: survives controller restarts, which
        is exactly when freshness debt matters), else on the wall time
        this controller first saw the subnet's head move."""
        if not pending:
            return 0.0
        wm = self.watermarks.load(netuid, version)
        if wm is not None and isinstance(wm.get("t"), (int, float)):
            return max(0.0, now - wm["t"])
        prev = self._progress.get(netuid)
        return max(0.0, now - prev[1]) if prev is not None else 0.0

    def run_cycle(self) -> CycleReport:
        """One poll pass over every subnet: observe, quarantine, plan,
        shed, sweep, and publish the flight bundle. Safe to call from
        a fresh process at any time — all inputs are durable."""
        from yuma_simulation_tpu_torch.telemetry.metrics import get_registry
        from yuma_simulation_tpu_torch.telemetry.runctx import span
        from yuma_simulation_tpu_torch.telemetry.slo import (
            get_slo_engine,
            observe_event,
        )

        report = CycleReport()
        with self.run.activate(), span("replay_cycle"):
            # Publish the OPEN cycle span before any ledger-appending
            # work: every quarantine/stall/sweep record carries this
            # span's identity, and a SIGKILL before the end-of-cycle
            # publish must not leave them dangling (``obsreport
            # --check`` resolves every ledger record to a recorded
            # span; a status="open" span satisfies it, and the
            # end-of-cycle publish replaces it with the closed form).
            try:
                self.recorder.record(self.run)
            except Exception:
                logger.exception("open-span publish failed")
            now = time.time()
            work: list[tuple[int, int, WindowSpec]] = []
            staleness: dict[int, float] = {}
            for netuid in self.archive.subnets():
                if now < self._next_poll.get(netuid, 0.0):
                    report.subnets_seen += 1
                    report.subnets_stalled += 1
                    continue
                try:
                    timeline = self.archive.timeline(netuid)
                except ArchiveError as exc:
                    logger.warning(
                        "subnet %d timeline unreadable: %s", netuid, exc
                    )
                    continue
                report.subnets_seen += 1
                self._observe_subnet(netuid, timeline, now)
                if netuid in self._stalled:
                    report.subnets_stalled += 1
                    self._next_poll[netuid] = (
                        now + self.cfg.slow_poll_seconds
                    )
                pair_stale = 0.0
                for version in self.cfg.versions:
                    spec = self._plan_window(netuid, version, timeline)
                    if spec is not None:
                        work.append(
                            (
                                self.cfg.priorities.get(netuid, 0),
                                netuid,
                                spec,
                            )
                        )
                    pair_stale = max(
                        pair_stale,
                        self._staleness(
                            netuid, version, spec is not None, now
                        ),
                    )
                staleness[netuid] = pair_stale
            report.subnets_live = report.subnets_seen - (
                report.subnets_stalled
            )
            # Freshness verdicts BEFORE sweeping: the SLO judges the
            # backlog as found, so a killed controller's debt burns the
            # budget on the first post-restart cycle and recovery shows
            # up as the verdicts flipping good on later cycles.
            for netuid, stale in staleness.items():
                observe_event(
                    "replay_fresh",
                    stale <= self.cfg.freshness_budget_seconds,
                )
            report.max_staleness_seconds = max(
                staleness.values(), default=0.0
            )
            self._staleness_gauge.set(report.max_staleness_seconds)
            self._live_gauge.set(report.subnets_live)
            # Highest priority first; shed the tail past the budget
            # (they stay pending and age toward the freshness SLO,
            # which is the backpressure signal operators alert on).
            work.sort(key=lambda w: (-w[0], w[1], w[2].version))
            budget = self.cfg.max_windows_per_cycle
            if budget is not None and len(work) > budget:
                report.windows_shed = len(work) - budget
                work = work[:budget]
            if (
                work
                and self.cfg.profile_window_seconds > 0
                and not self._profiled
            ):
                # One guarded device-profile window over the first
                # cycle that actually sweeps (--profile-window): the
                # single-flight latch + auto-stop deadline live in the
                # ops plane; the artifact registers into the bundle.
                self._profiled = True
                try:
                    self.ops.debug_profile(
                        self.cfg.profile_window_seconds, mode="trace"
                    )
                except Exception:  # noqa: BLE001 — observation only
                    logger.warning(
                        "controller profile window failed", exc_info=True
                    )
            for _, netuid, spec in work:
                self.sweep_window(spec)
                report.windows_swept += 1
                report.swept.append(
                    (
                        netuid,
                        spec.version,
                        spec.blocks[0],
                        spec.blocks[-1],
                    )
                )
            # Incident intelligence, inside the cycle span so every
            # anomaly_detected / incident_* ledger record resolves to a
            # recorded span: first surface any crash a prior
            # incarnation left behind, then tick the engine over this
            # cycle's ledger + registry state.
            try:
                for stale_run in self._stale_runs:
                    self.ledger.append("controller_restarted", run=stale_run)
                    log_event(logger, "controller_restarted", run=stale_run)
                self._stale_runs = []
                self.incidents.tick()
            except Exception:  # noqa: BLE001 — observation only
                logger.exception("incident tick failed")
        report.snapshots_quarantined = len(self._quarantined)
        try:
            engine = get_slo_engine()
            engine.evaluate()  # burn state current before the snapshot
            self.recorder.record(self.run, registry=get_registry())
            self.recorder.record_slo(engine)
        except Exception:
            logger.exception("flight bundle publish failed")
        return report

    def run_forever(
        self,
        *,
        stop: Optional[Callable[[], bool]] = None,
        max_cycles: Optional[int] = None,
    ) -> int:
        """Poll until `stop()` goes true (or `max_cycles` elapse).
        Returns the number of cycles run."""
        cycles = 0
        try:
            while max_cycles is None or cycles < max_cycles:
                if stop is not None and stop():
                    break
                self.run_cycle()
                cycles += 1
                if stop is not None and stop():
                    break
                time.sleep(self.cfg.poll_seconds)
        finally:
            self.close()
        return cycles

    def close(self) -> None:
        """Graceful exit: publish any in-flight profile window, release
        the retention pin, and seal the live segment so the bundle on
        disk is whole. Idempotent; a SIGKILLed controller simply skips
        this — the next reader tolerates the torn tail."""
        try:
            self.ops.close()
        except Exception:  # noqa: BLE001 — shutdown must not raise
            logger.warning("ops-plane close failed", exc_info=True)
        if self.rotation is not None:
            try:
                self.recorder.mark_run_closed(self.run.run_id)
                self.recorder.seal_live_segment()
            except Exception:  # noqa: BLE001 — shutdown must not raise
                logger.warning("final segment seal failed", exc_info=True)


# -------------------------------------------------------- helper host


def run_host(
    archive: SnapshotArchive,
    cache: StateCache,
    store_root: Union[str, pathlib.Path],
    *,
    poll_seconds: float = 0.25,
    unit_size: int = 8,
    canary_fraction: float = 1.0,
    lease_ttl_seconds: float = 30.0,
    stop: Optional[Callable[[], bool]] = None,
    max_idle_polls: Optional[int] = None,
    device="cuda",
) -> int:
    """A helper fleet host for the controller's windows: scan the pair
    directories for in-flight :class:`WindowSpec` markers, reconstruct
    the identical scenario (``scenario_for_blocks`` over the spec's
    pinned blocks) and carry (the shared cache's final state), and join
    the window's fleet store through the ordinary lease-claim path
    (``finalize=False`` — the controller owns collection and the
    watermark commit). A host whose carry is unavailable skips the
    window rather than inventing a different resume point; the manifest
    carry digest would reject it anyway. Its units run on `device` (the
    card by default), on the controller's rung. Returns the number of
    windows joined."""
    from yuma_simulation_tpu_torch.fabric.scheduler import (
        FleetConfig,
        run_fleet_grid,
    )
    from yuma_simulation_tpu_torch.models.config import YumaConfig
    from yuma_simulation_tpu_torch.simulation.engine import resolve_device

    dev = resolve_device(device)
    store_root = pathlib.Path(store_root)
    config = YumaConfig()
    joined = 0
    idle = 0
    while True:
        if stop is not None and stop():
            break
        specs: list[WindowSpec] = []
        for marker in sorted(
            store_root.glob("subnet_*/*/inflight.json")
        ):
            try:
                payload = json.loads(marker.read_text(encoding="utf-8"))
            except (OSError, json.JSONDecodeError):
                continue
            if "blocks" not in payload:
                continue
            try:
                specs.append(WindowSpec.from_json(payload))
            except ControllerError:
                continue
        progressed = False
        for spec in specs:
            carry = None
            if spec.prior_baseline_key:
                try:
                    carry = cache.final_state(spec.prior_baseline_key)
                except StateCacheError:
                    continue  # stale resume point: not ours to invent
            try:
                scenario = archive.scenario_for_blocks(
                    spec.netuid,
                    spec.blocks,
                    epochs_per_snapshot=spec.epochs_per_snapshot,
                )
            except ArchiveError:
                continue  # the controller quarantines; we just skip
            fleet = FleetConfig(
                directory=spec.store,
                unit_size=unit_size,
                canary_fraction=canary_fraction,
                lease_ttl_seconds=lease_ttl_seconds,
            )
            run_fleet_grid(
                scenario,
                spec.version,
                fleet,
                axes={"bond_alpha": [float(config.bond_alpha)]},
                # The controller's own tag: the tag is part of the fleet
                # store manifest's identity, and a host that reaches a
                # new window's store before the controller writes the
                # manifest (the controller compiles the scenario first)
                # must not pin a manifest the controller then refuses.
                tag=window_tag(spec),
                initial_state=carry,
                epoch_offset=spec.epoch_offset,
                finalize=False,
                device=dev,
            )
            joined += 1
            progressed = True
        if progressed:
            idle = 0
        else:
            idle += 1
            if max_idle_polls is not None and idle >= max_idle_polls:
                break
        time.sleep(poll_seconds)
    return joined

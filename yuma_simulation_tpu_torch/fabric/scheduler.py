"""The work-stealing fleet scheduler: hosts, heartbeats, unit dispatch.

One :class:`FleetHost` per process. Each host loops over the store's
pending units, claims one at a time through the lease protocol
(:mod:`.lease`), computes it through its LOCAL
:class:`..resilience.supervisor.SweepSupervisor` (so every unit inherits
the full single-host resilience stack — deadline watchdog, engine
ladder, NaN quarantine, elastic mesh), and publishes the result
content-addressed into the shared store (:mod:`.store`). A heartbeat
thread renews the claim while the unit computes; when a host dies, its
lease stops renewing, expires, and any surviving host STEALS the unit
and re-executes it — re-execution is always safe (units are pure) and
the at-most-once publish gate keeps the store single-valued.

Telemetry: every fabric event rides the host's fleet-scoped span chain
``host -> fleetunit -> (the supervisor's unit/attempt/engine-rung
spans)`` and lands in the host's crash-safe ledger under
``hosts/<host_id>/`` — so ``tools/obsreport.py`` renders a per-host
fleet timeline and :func:`..fabric.health.build_fleet_report`
cross-checks against the merged ledgers.

Bitwise contract (the supervisor's drill guarantee, fleet-wide): unit
lane bounds come from the manifest, each unit dispatches through the same
deterministic `DispatchPlan` machinery regardless of WHICH host runs it,
and healthy lanes of a faulted fleet run are bitwise-identical to an
unfaulted run's.

Devices: every entry point takes the `device` its units run on (the card
by default, as every entry point of the port), and each unit's
supervisor runs there: a host never moves to another device. Under the
supervisor's quarantine default a unit lands on the eager rung; with
``quarantine=False`` on the card, on the varying scan (K3).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pathlib
import socket
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from yuma_simulation_tpu_torch.fabric.lease import (
    DEFAULT_TTL_SECONDS,
    ClaimedLease,
    LeaseStore,
)
from yuma_simulation_tpu_torch.fabric.store import FleetStore
from yuma_simulation_tpu_torch.resilience.errors import LeaseExpired
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)


def default_host_id() -> str:
    """Process-unique, operator-greppable host identity."""
    return f"host-{socket.gethostname()}-{os.getpid()}"


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Knobs for one host's participation in a fleet sweep.

    `directory` is the shared store; `lease_ttl_seconds` bounds how long
    a dead host's units stay locked (heartbeats renew at TTL/3 by
    default); `poll_seconds` is the idle re-scan interval while other
    hosts hold the remaining work; `max_wait_seconds` bounds the whole
    participation so a wedged store fails loudly instead of spinning
    forever. `unit_size` is the sweep-grid partition width (lanes per
    unit) used by the entry points that CREATE the manifest — joiners
    inherit the manifest's partition."""

    directory: str | pathlib.Path
    host_id: str = dataclasses.field(default_factory=default_host_id)
    lease_ttl_seconds: float = DEFAULT_TTL_SECONDS
    heartbeat_seconds: Optional[float] = None
    poll_seconds: float = 0.25
    #: Abort when NO fleet-wide progress (claims here, publishes
    #: anywhere) is observed for this long — a stuck-store bound, not a
    #: total-runtime cap: steady progress resets it, so arbitrarily
    #: long sweeps run as long as units keep landing.
    max_wait_seconds: float = 600.0
    unit_size: int = 64
    #: Soft unit affinity: this host claims its preferred units first,
    #: and defers claiming a VIRGIN (never-leased) foreign unit until
    #: `poach_after_seconds` after its own preferred work is done —
    #: spreading hosts across the grid instead of stampeding the front.
    #: STEALING an expired/torn lease is never deferred (host-loss
    #: recovery must not wait on politeness). Empty = no affinity.
    preferred_units: tuple = ()
    poach_after_seconds: float = 0.0
    #: Cross-engine numerics-canary fraction threaded into each unit's
    #: local :class:`..resilience.supervisor.SweepSupervisor` (see its
    #: ``canary_fraction``): selected units re-execute on the demoted
    #: rung, fingerprints compare epoch-by-epoch, and the per-unit
    #: canary/drift counts ride the host ledger's ``unit_ok`` records
    #: into :class:`..fabric.health.FleetHealthReport`. 0 disables.
    canary_fraction: float = 0.0
    #: AOT executable-cache directory (:mod:`..simulation.aot`),
    #: typically ON the shared store's filesystem so every host of the
    #: fleet shares one artifact set: the host preloads its unit-shaped
    #: executables BEFORE claiming its first lease (a lease must not
    #: burn TTL on a compile another host already published), and every
    #: miss it does compile is published for the next host. None
    #: (default) leaves the legacy always-compile path untouched.
    executable_cache_dir: Optional[str] = None
    #: Segmented flight-recorder rotation for the host bundle
    #: (:class:`..telemetry.flight.RotationPolicy`): ``True`` enables
    #: the defaults, a policy instance pins thresholds, ``None``
    #: (default) defers to the ``YUMA_TPU_FLIGHT_ROTATE`` env opt-in —
    #: rotation stays OFF unless requested, so existing monolithic
    #: host bundles are untouched.
    flight_rotation: object = None

    def heartbeat_interval(self) -> float:
        if self.heartbeat_seconds is not None:
            return self.heartbeat_seconds
        return self.lease_ttl_seconds / 3.0


class _Heartbeat(threading.Thread):
    """Renews one claimed lease until stopped. A renewal that raises the
    typed `LeaseExpired` (the claim was stolen after expiry or a torn
    record) sets `lost` and stops — the owner checks the flag before
    publishing."""

    def __init__(self, leases: LeaseStore, unit: int, interval: float):
        super().__init__(name=f"lease-heartbeat-u{unit}", daemon=True)
        self.leases = leases
        self.unit = unit
        self.interval = interval
        self.lost = False
        self._stop_event = threading.Event()

    def run(self) -> None:
        while not self._stop_event.wait(self.interval):
            try:
                self.leases.renew(self.unit)
            except LeaseExpired:
                self.lost = True
                return
            except Exception:
                # A transient shared-store hiccup must not kill the
                # heartbeat — the NEXT renewal may succeed within TTL.
                logger.warning(
                    "lease heartbeat for unit %d failed transiently",
                    self.unit,
                    exc_info=True,
                )

    def stop(self) -> None:
        self._stop_event.set()
        self.join(timeout=10.0)


@dataclasses.dataclass(frozen=True)
class FleetHostSummary:
    """One host's share of a fleet sweep, as seen from inside it."""

    host_id: str
    units_published: int
    units_stolen: int
    units_abandoned: int
    units_duplicate: int


class FleetHost:
    """One process's fleet participation (see the module docstring)."""

    def __init__(self, config: FleetConfig):
        self.config = config
        self.store = FleetStore(config.directory)
        self.leases = LeaseStore(
            self.store.leases_dir,
            config.host_id,
            ttl_seconds=config.lease_ttl_seconds,
        )
        self.host_dir = self.store.host_dir(config.host_id)
        from yuma_simulation_tpu_torch.telemetry.flight import (
            RotationPolicy,
            rotation_from_env,
        )
        from yuma_simulation_tpu_torch.telemetry.ops import OpsPlane

        fr = config.flight_rotation
        if fr is True:
            self.rotation = RotationPolicy()
        elif fr:
            self.rotation = fr
        else:
            self.rotation = rotation_from_env()
        #: The live-ops plane (:class:`..telemetry.ops.OpsPlane`):
        #: `ops.debug_vars()` / `ops.debug_spans()` / `ops.debug_profile()`
        #: against the host bundle. The active run is attached by
        #: :meth:`run_units` for span stitching.
        self.ops = OpsPlane(self.host_dir)
        self._numerics_records: list = []
        if config.executable_cache_dir:
            from yuma_simulation_tpu_torch.simulation.aot import (
                configure_executable_cache,
            )

            configure_executable_cache(config.executable_cache_dir)

    def preload_executables(
        self,
        shapes,
        yuma_version: str,
        *,
        batch: int = 1,
        quarantine: bool = True,
        config=None,
        dtype=None,
        device="cuda",
    ) -> int:
        """Build, load and launch the unit-shaped kernels BEFORE the first
        lease claim (:func:`..simulation.aot.preload_shapes`): a cache hit
        makes this host dispatch-ready in milliseconds; a miss pays the
        `nvcc` build NOW, outside any lease TTL, so a freshly claimed unit
        never stalls its heartbeat window on a build another host already
        published. `config` / `dtype` / `quarantine` must be the sweep's
        own: they select the rung. Returns the buckets launched (0 when
        no cache is active, or the plan runs no kernel)."""
        import torch

        from yuma_simulation_tpu_torch.simulation.aot import (
            active_cache,
            preload_shapes,
        )

        if active_cache() is None:
            return 0
        return preload_shapes(
            shapes,
            yuma_version=yuma_version,
            batch=batch,
            quarantine=quarantine,
            config=config,
            dtype=torch.float32 if dtype is None else dtype,
            # Fleet units always dispatch the batched program, even at
            # one lane (stack_scenarios yields [1, E, V, M]).
            batched=True,
            label=f"fleet:{self.config.host_id}",
            device=device,
        )

    def run_units(
        self,
        compute: Callable[[int, int, int], dict],
        *,
        num_units: int,
        unit_lanes: Sequence,
        tag: str,
        config_fingerprint: dict,
        result_keys: Sequence[str] = ("dividends",),
    ) -> FleetHostSummary:
        """Work-steal until every unit in the store has a verified
        result. `compute(idx, lo, hi)` produces one unit's arrays
        (keys in `result_keys` are published) plus underscore-prefixed
        bookkeeping (engine used, recovery counts, quarantine
        provenance) folded into the host ledger's ``unit_ok`` record.
        """
        from yuma_simulation_tpu_torch.resilience.supervisor import FailureLedger
        from yuma_simulation_tpu_torch.telemetry import (
            FlightRecorder,
            get_registry,
            span,
        )
        from yuma_simulation_tpu_torch.telemetry.propagation import (
            TraceContext,
            continue_trace,
            current_trace_context,
            span_prefix_for,
        )

        # Sweep-level trace continuity: the ambient context (an active
        # driver run, or the env a drill driver handed this subprocess)
        # is stamped into the write-once manifest; joiners with no
        # ambient trace inherit the manifest's, so every host of one
        # fleet sweep continues ONE trace instead of minting orphans.
        ctx = current_trace_context()
        if ctx is None:
            ctx = TraceContext.from_env()
        manifest = self.store.ensure_manifest(
            num_units=num_units,
            unit_lanes=unit_lanes,
            tag=tag,
            config=config_fingerprint,
            trace=ctx.to_manifest() if ctx is not None else None,
        )
        if ctx is None:
            ctx = TraceContext.from_manifest(manifest)
        ledger = FailureLedger(self.host_dir / "ledger.jsonl")
        registry = get_registry()
        published = stolen = abandoned = duplicates = 0
        #: This host's numerics records (fleet-global coordinates, from
        #: `compute`'s ``_numerics``), published into the host bundle's
        #: numerics.jsonl alongside spans/ledger/metrics.
        self._numerics_records: list = []
        cfg = self.config
        with continue_trace(
            ctx, prefix=span_prefix_for(cfg.host_id)
        ) as run:
            self.ops.run = run
            if self.rotation is not None:
                try:
                    FlightRecorder(
                        self.host_dir, rotation=self.rotation
                    ).mark_run_open(run.run_id)
                except Exception:
                    logger.warning(
                        "fleet host rotation open failed for %s",
                        self.host_dir,
                        exc_info=True,
                    )
            try:
                with span(
                    f"host:{cfg.host_id}", units=num_units, fleet=tag
                ):
                    ledger.append(
                        "host_started", host=cfg.host_id, units=num_units
                    )
                    deadline_t = time.monotonic() + cfg.max_wait_seconds
                    preferred = set(cfg.preferred_units)
                    own_work_done_at: Optional[float] = None
                    last_pending: Optional[tuple] = None
                    while True:
                        # Shallow scan (existence only) in the hot loop;
                        # the completion barrier below re-verifies every
                        # result in full, so a corrupt-but-present unit
                        # still requeues — without the poll loop
                        # re-hashing every published byte each pass.
                        pending = self.store.pending_units(deep=False)
                        if not pending:
                            pending = self.store.pending_units()
                            if not pending:
                                break
                        # The stall bound resets on fleet-wide progress
                        # (the pending set shrinking covers OTHER hosts'
                        # publishes too): it aborts a wedged store, not
                        # a legitimately long sweep.
                        if tuple(pending) != last_pending:
                            last_pending = tuple(pending)
                            deadline_t = (
                                time.monotonic() + cfg.max_wait_seconds
                            )
                        if time.monotonic() > deadline_t:
                            raise TimeoutError(
                                f"fleet host {cfg.host_id} saw no fleet "
                                f"progress for {cfg.max_wait_seconds}s "
                                f"with units {pending} outstanding "
                                f"(store {self.store.directory})"
                            )
                        candidates = self._claim_candidates(
                            pending, preferred, own_work_done_at
                        )
                        if (
                            preferred
                            and own_work_done_at is None
                            and not any(u in preferred for u in pending)
                        ):
                            own_work_done_at = time.monotonic()
                        progressed = False
                        for unit in candidates:
                            # Re-check right before claiming: another
                            # host may have published while we walked
                            # the pending list.
                            if self.store.verify_result(unit):
                                progressed = True
                                continue
                            claim = self.leases.try_claim(unit)
                            if claim is None:
                                continue
                            progressed = True
                            outcome = self._run_claimed_unit(
                                unit,
                                claim,
                                compute,
                                unit_lanes[unit],
                                ledger,
                                result_keys,
                            )
                            if outcome == "published":
                                published += 1
                            elif outcome == "abandoned":
                                abandoned += 1
                            elif outcome == "duplicate":
                                duplicates += 1
                            if claim.generation > 0:
                                stolen += 1
                        if not progressed:
                            time.sleep(cfg.poll_seconds)
                    ledger.append(
                        "host_finished",
                        host=cfg.host_id,
                        published=published,
                        stolen=stolen,
                        abandoned=abandoned,
                        duplicates=duplicates,
                    )
                    log_event(
                        logger,
                        "fleet_host_finished",
                        level=logging.INFO,
                        host=cfg.host_id,
                        published=published,
                        stolen=stolen,
                        abandoned=abandoned,
                        duplicates=duplicates,
                    )
            finally:
                # The host bundle publishes on failure too (the
                # supervisor's rule): a crashed host's spans and ledger
                # are exactly what the fleet post-mortem needs, and
                # every record written so far must resolve for
                # `obsreport --check`.
                try:
                    recorder = FlightRecorder(
                        self.host_dir, rotation=self.rotation
                    )
                    recorder.record(run, registry=registry)
                    recorder.record_numerics(
                        self._numerics_records, run_id=run.run_id
                    )
                    if self.rotation is not None:
                        recorder.mark_run_closed(run.run_id)
                        recorder.seal_live_segment()
                except Exception:
                    logger.warning(
                        "fleet host bundle publish failed for %s",
                        self.host_dir,
                        exc_info=True,
                    )
        return FleetHostSummary(
            host_id=cfg.host_id,
            units_published=published,
            units_stolen=stolen,
            units_abandoned=abandoned,
            units_duplicate=duplicates,
        )

    def _claim_candidates(
        self,
        pending: Sequence[int],
        preferred: set,
        own_work_done_at: Optional[float],
    ) -> list[int]:
        """The units this host should try to claim this scan, in order:
        its preferred units first; foreign units with a STEALABLE lease
        always (host-loss recovery never waits); virgin foreign units
        only after the poach grace has elapsed since this host's own
        preferred work completed. No affinity -> everything pending."""
        if not preferred:
            return list(pending)
        mine = [u for u in pending if u in preferred]
        foreign = [u for u in pending if u not in preferred]
        out = list(mine)
        poach_ok = (
            own_work_done_at is not None
            and (time.monotonic() - own_work_done_at)
            >= self.config.poach_after_seconds
        )
        for unit in foreign:
            info = self.leases.read(unit)
            if info is not None and self.leases.is_stealable(info):
                out.append(unit)
            elif info is None and poach_ok:
                out.append(unit)
        return out

    # -- one claimed unit ----------------------------------------------

    def _run_claimed_unit(
        self,
        unit: int,
        claim: ClaimedLease,
        compute: Callable,
        lanes,
        ledger,
        result_keys: Sequence[str],
    ) -> str:
        from yuma_simulation_tpu_torch.resilience import faults
        from yuma_simulation_tpu_torch.telemetry import span

        cfg = self.config
        lo, hi = int(lanes[0]), int(lanes[1])
        with span(
            f"fleetunit{unit}",
            lanes=[lo, hi],
            generation=claim.generation,
            host=cfg.host_id,
        ):
            if claim.generation > 0:
                # We stole this unit: the prior holder is lost (or its
                # claim record was corrupt). One fleet-level requeue
                # record — the host analogue of event=mesh_degraded.
                ledger.append(
                    "unit_stolen",
                    unit=unit,
                    generation=claim.generation,
                    prior_host=claim.stolen_from,
                    host=cfg.host_id,
                )
                log_event(
                    logger,
                    "host_lost",
                    host=claim.stolen_from or "<torn lease>",
                    unit=unit,
                    stolen_by=cfg.host_id,
                )
            ledger.append(
                "unit_claimed",
                unit=unit,
                host=cfg.host_id,
                generation=claim.generation,
                lanes=[lo, hi],
            )
            # Deterministic drill hook: a simulated host loss SIGKILLs
            # here — after the claim is durably ledgered (so survivors
            # can see what died holding what), before any compute.
            faults.maybe_crash_host(unit)
            heartbeat = _Heartbeat(
                self.leases, unit, cfg.heartbeat_interval()
            )
            heartbeat.start()
            try:
                out = compute(unit, lo, hi)
            finally:
                heartbeat.stop()
            if heartbeat.lost or not self.leases.still_owner(unit):
                # The lease was stolen mid-compute (expiry under a long
                # stall, or a torn record). The unit belongs to the
                # stealer now; publishing would race for nothing — the
                # result is deterministic either way.
                ledger.append(
                    "unit_abandoned",
                    unit=unit,
                    host=cfg.host_id,
                    reason="lease_lost",
                )
                return "abandoned"
            was_published = self.store.publish_result(
                unit, {k: np.asarray(out[k]) for k in result_keys}
            )
            if not was_published:
                # At-most-once publish: someone (a pre-steal holder that
                # finished in the race window) already published a
                # verified result. Ours is bitwise the same; suppress.
                ledger.append(
                    "unit_duplicate", unit=unit, host=cfg.host_id
                )
                self.leases.release(unit)
                return "duplicate"
            self._numerics_records.extend(out.get("_numerics") or ())
            ledger.append(
                "unit_ok",
                unit=unit,
                host=cfg.host_id,
                lanes=[lo, hi],
                generation=claim.generation,
                attempts=int(out.get("_attempts", 1)),
                engine=out.get("_engine", "eager"),
                stalls=int(out.get("_stalls", 0)),
                demotions=int(out.get("_demotions", 0)),
                mesh_shrinks=int(out.get("_mesh_shrinks", 0)),
                canaries=int(out.get("_canaries", 0)),
                drifts=int(out.get("_drifts", 0)),
                quarantined=out.get("_quarantined", []),
            )
            self.leases.release(unit)
            return "published"


# ---------------------------------------------------------------- entries


def _fleet_canary_fraction(fraction: float, idx: int) -> float:
    """Per-unit canary fraction for fleet unit `idx`: the stride
    selection has to happen at FLEET scope, because each fleet unit's
    local supervisor sees exactly one unit (local idx 0) and would
    otherwise canary every unit for any fraction > 0. Mirrors
    `SweepSupervisor._canary_selected`'s deterministic stride (the
    shared `canary_stride` spelling) so a re-run canaries the same
    fleet units."""
    from yuma_simulation_tpu_torch.resilience.supervisor import canary_stride

    if fraction <= 0.0:
        return 0.0
    return 1.0 if idx % canary_stride(fraction) == 0 else 0.0


def _globalize_numerics(records, idx: int, lo: int) -> list:
    """Re-stamp a unit-local supervisor's numerics records with the
    FLEET unit index and global lane bounds, so the merged stream
    speaks one coordinate system (the quarantine-provenance rule,
    applied to the numerics stream)."""
    out = []
    for rec in records or ():
        rec = dict(rec)
        rec["unit"] = idx
        lanes = rec.get("lanes") or [0, 0]
        rec["lanes"] = [lo + int(lanes[0]), lo + int(lanes[1])]
        out.append(rec)
    return out


def partition_lanes(n: int, unit_size: int) -> list[tuple[int, int]]:
    """Contiguous `(lo, hi)` unit bounds covering `range(n)` — the same
    partition rule as `SweepSupervisor._partition`, fixed in the fleet
    manifest so every host agrees on the unit map."""
    if n < 1:
        raise ValueError("cannot run an empty fleet sweep")
    if unit_size < 1:
        raise ValueError("unit_size must be >= 1")
    return [
        (lo, min(lo + unit_size, n)) for lo in range(0, n, unit_size)
    ]


def run_fleet_batch(
    scenarios,
    yuma_version: str,
    fleet: FleetConfig | str | pathlib.Path,
    *,
    config=None,
    dtype=None,
    tag: str = "",
    supervisor=None,
    finalize: bool = True,
    device="cuda",
) -> dict:
    """Run a scenario-batch sweep as this process's share of a FLEET:
    the fleet analogue of :meth:`..resilience.supervisor.SweepSupervisor
    .run_batch`, with the same output contract plus the fleet report.

    Every participating host calls this with the SAME scenarios/version/
    config against the same store directory (the manifest fingerprint
    enforces agreement); each claims units through the lease protocol
    and computes them through its local supervisor. Returns
    ``{"dividends": [B, E, V], "quarantine": QuarantineReport, "report":
    FleetHealthReport, "host": FleetHostSummary}`` once EVERY unit of
    the sweep is published (work other hosts did included).

    `finalize=False` skips the fleet-report publish and the result
    collection (used by the simulated-host drill workers, whose driver
    finalizes once after all hosts exit). Units run on `device` (the card
    by default; raises without CUDA unless `device="cpu"`)."""
    import torch

    from yuma_simulation_tpu_torch.fabric.health import (
        publish_fleet_report,
        quarantine_entries,
    )
    from yuma_simulation_tpu_torch.resilience.guards import QuarantineReport
    from yuma_simulation_tpu_torch.resilience.supervisor import SweepSupervisor

    if not isinstance(fleet, FleetConfig):
        fleet = FleetConfig(directory=fleet)
    dtype = torch.float32 if dtype is None else dtype
    scenarios = list(scenarios)
    lanes = partition_lanes(len(scenarios), fleet.unit_size)
    tag = tag or f"fleet_batch:{yuma_version}"

    def compute(idx: int, lo: int, hi: int) -> dict:
        sup = supervisor if supervisor is not None else SweepSupervisor(
            directory=None,
            unit_size=fleet.unit_size,
            canary_fraction=_fleet_canary_fraction(
                fleet.canary_fraction, idx
            ),
        )
        out = sup.run_batch(
            scenarios[lo:hi],
            yuma_version,
            config,
            dtype=dtype,
            tag=f"{tag}:fleetunit{idx}",
            device=device,
        )
        rep = out["report"]
        return {
            "dividends": np.asarray(out["dividends"]),
            "_engine": ",".join(rep.engines_used),
            "_attempts": 1 + rep.units_retried,
            "_stalls": rep.stalls_killed,
            "_demotions": rep.engine_demotions,
            "_mesh_shrinks": rep.mesh_shrinks,
            "_canaries": rep.canaries_run,
            "_drifts": rep.drift_events,
            "_numerics": _globalize_numerics(
                out.get("numerics_records"), idx, lo
            ),
            # Globalize the slice-local quarantine provenance: the
            # fleet ledger speaks global lane indices everywhere.
            "_quarantined": [
                [lo + e.case, e.epoch, e.tensor]
                for e in out["quarantine"].entries
            ],
        }

    host = FleetHost(fleet)
    if scenarios and fleet.executable_cache_dir:
        # Preload the unit-shaped kernels BEFORE the first lease claim:
        # hits make this host dispatch-ready in milliseconds; misses pay
        # the build outside any lease TTL and publish for every other
        # host on the shared store. The sweep's own config / dtype /
        # quarantine thread through (they select the rung), and both
        # distinct unit widths (the full units and the trailing
        # remainder) are warmed. Homogeneous-suite shapes only: a mixed
        # suite's per-unit shapes are not known until claim time.
        shapes = {np.shape(s.weights) for s in scenarios}
        if len(shapes) == 1:
            widths = {min(fleet.unit_size, len(scenarios))}
            if len(scenarios) % fleet.unit_size:
                widths.add(len(scenarios) % fleet.unit_size)
            for width in sorted(widths):
                host.preload_executables(
                    sorted(shapes),
                    yuma_version,
                    batch=width,
                    quarantine=(supervisor.quarantine if supervisor is not None
                                else True),
                    config=config,
                    dtype=dtype,
                    device=device,
                )
    summary = host.run_units(
        compute,
        num_units=len(lanes),
        unit_lanes=lanes,
        tag=tag,
        config_fingerprint={
            "driver": "run_fleet_batch",
            "version": yuma_version,
            "num_scenarios": len(scenarios),
            "unit_size": fleet.unit_size,
            "dtype": str(dtype).replace("torch.", ""),
        },
        result_keys=("dividends",),
    )
    if not finalize:
        return {"host": summary}
    report = publish_fleet_report(host.store)
    entries = quarantine_entries(host.store)
    return {
        "dividends": host.store.collect("dividends"),
        "quarantine": QuarantineReport(
            entries=tuple(entries), num_cases=len(scenarios)
        ),
        "report": report,
        "host": summary,
    }


def run_fleet_grid(
    scenario,
    yuma_version: str,
    fleet: FleetConfig | str | pathlib.Path,
    *,
    axes: Optional[dict] = None,
    configs=None,
    points: Optional[list] = None,
    tag: str = "",
    supervisor=None,
    finalize: bool = True,
    initial_state: Optional[dict] = None,
    epoch_offset: int = 0,
    device="cuda",
) -> dict:
    """Run a hyperparameter grid (or a Monte-Carlo parameter sample —
    any `axes` value lists, random draws included) as this process's
    share of a FLEET: the fleet analogue of
    :meth:`..resilience.supervisor.SweepSupervisor.run_grid` (the fleet
    driver for generated sweeps).

    `axes` maps config field names to value lists exactly as
    :func:`..simulation.sweep.config_grid` takes them; every
    participating host must call with the SAME scenario/version/axes
    against the same store (the manifest fingerprint enforces the grid
    shape). Alternatively pass a pre-built batched `configs` (+ its
    `points` list) — e.g. a seeded Monte-Carlo sample — which every
    host must construct identically (pass the seed, not the sample,
    between hosts). Grid points partition into `fleet.unit_size` units;
    each unit re-slices the batched config pytree and computes through
    the local supervisor, inheriting deadline/ladder/quarantine.

    Returns ``{"dividends": [P, E, V], "quarantine": QuarantineReport,
    "report": FleetHealthReport, "host": FleetHostSummary, "points":
    [...]}`` once every unit is published. `finalize=False` skips the
    report publish + collection (drill workers).

    `initial_state` / `epoch_offset` (additive) thread the engine's
    suffix-resume contract through every fleet unit — the continuous
    replay controller's incremental windows, where each unit simulates
    only the epochs past a durable watermark from the watermarked
    carry. The carry's content digest and the offset ride the manifest
    fingerprint, so every joining host must present the identical
    resume point (a host with a stale carry fails the manifest check
    instead of publishing silently different bits). Requires a
    `supervisor=` built with ``quarantine=False``. Units run on
    `device`."""
    from yuma_simulation_tpu_torch.fabric.health import (
        publish_fleet_report,
        quarantine_entries,
    )
    from yuma_simulation_tpu_torch.resilience.guards import QuarantineReport
    from yuma_simulation_tpu_torch.resilience.supervisor import (
        SweepSupervisor,
        _config_slice,
    )
    from yuma_simulation_tpu_torch.resilience.supervisor import (
        _state_digest as _supervisor_state_digest,
    )
    from yuma_simulation_tpu_torch.simulation.engine import config_lanes

    if not isinstance(fleet, FleetConfig):
        fleet = FleetConfig(directory=fleet)
    if configs is None:
        if not axes:
            raise ValueError(
                "run_fleet_grid needs axes={field: [values]} (or a "
                "pre-built configs batch)"
            )
        from yuma_simulation_tpu_torch.simulation.sweep import config_grid

        axes = {k: [float(v) for v in vs] for k, vs in sorted(axes.items())}
        configs, points = config_grid(**axes)
    num_points = config_lanes(configs)
    lanes = partition_lanes(num_points, fleet.unit_size)
    tag = tag or f"fleet_grid:{yuma_version}"

    def compute(idx: int, lo: int, hi: int) -> dict:
        unit_cfg = _config_slice(configs, lo, hi)
        sup = supervisor if supervisor is not None else SweepSupervisor(
            directory=None,
            unit_size=fleet.unit_size,
            canary_fraction=_fleet_canary_fraction(
                fleet.canary_fraction, idx
            ),
            # Suffix-resume units cannot arm the non-finite guard (it
            # rides a monolithic scan carry) — matching run_grid's own
            # contract rather than raising three layers down.
            quarantine=initial_state is None,
        )
        out = sup.run_grid(
            scenario,
            yuma_version,
            unit_cfg,
            tag=f"{tag}:fleetunit{idx}",
            initial_state=initial_state,
            epoch_offset=epoch_offset,
            device=device,
        )
        rep = out["report"]
        return {
            "dividends": np.asarray(out["dividends"]),
            "_engine": ",".join(rep.engines_used),
            "_attempts": 1 + rep.units_retried,
            "_stalls": rep.stalls_killed,
            "_demotions": rep.engine_demotions,
            "_mesh_shrinks": rep.mesh_shrinks,
            "_canaries": rep.canaries_run,
            "_drifts": rep.drift_events,
            "_numerics": _globalize_numerics(
                out.get("numerics_records"), idx, lo
            ),
            "_quarantined": [
                [lo + e.case, e.epoch, e.tensor]
                for e in out["quarantine"].entries
            ],
        }

    host = FleetHost(fleet)
    summary = host.run_units(
        compute,
        num_units=len(lanes),
        unit_lanes=lanes,
        tag=tag,
        config_fingerprint={
            "driver": "run_fleet_grid",
            "version": yuma_version,
            "num_points": int(num_points),
            "unit_size": fleet.unit_size,
            "axes": axes if axes is not None else "prebuilt-configs",
            "shape": [int(d) for d in np.shape(scenario.weights)],
            # Additive suffix-resume identity (absent for classic
            # from-zero grids, keeping existing manifests joinable).
            **(
                {
                    "epoch_offset": int(epoch_offset),
                    "initial_state": _supervisor_state_digest(
                        initial_state
                    ),
                }
                if initial_state is not None or epoch_offset
                else {}
            ),
        },
        result_keys=("dividends",),
    )
    if not finalize:
        return {"host": summary}
    report = publish_fleet_report(host.store)
    entries = quarantine_entries(host.store)
    return {
        "dividends": host.store.collect("dividends"),
        "quarantine": QuarantineReport(
            entries=tuple(entries), num_cases=int(num_points)
        ),
        "report": report,
        "host": summary,
        "points": points,
    }


def run_fleet_artifacts(
    labels: Sequence[str],
    build: Callable[[str], bytes],
    fleet: FleetConfig | str | pathlib.Path,
    *,
    tag: str,
    config_fingerprint: dict,
) -> dict:
    """Coordinate a per-label artifact build (CSV sheets, HTML tables)
    across concurrent CLI invocations: each label is one lease-claimed
    unit, `build(label) -> bytes` runs at most once per label across
    the whole fleet (a dying process's label is requeued via lease
    expiry), and every invocation returns the COMPLETE ``{label:
    bytes}`` map once all units are published — so N processes pointed
    at one store split the sweep and each still writes the full
    artifact set."""
    from yuma_simulation_tpu_torch.fabric.health import publish_fleet_report

    if not isinstance(fleet, FleetConfig):
        fleet = dataclasses.replace(
            FleetConfig(directory=fleet), unit_size=1
        )
    labels = [str(label) for label in labels]

    def compute(idx: int, lo: int, hi: int) -> dict:
        data = build(labels[idx])
        return {
            "artifact": np.frombuffer(bytearray(data), dtype=np.uint8),
        }

    host = FleetHost(fleet)
    host.run_units(
        compute,
        num_units=len(labels),
        unit_lanes=[(i, i + 1) for i in range(len(labels))],
        tag=tag,
        config_fingerprint=dict(config_fingerprint, labels=labels),
        result_keys=("artifact",),
    )
    publish_fleet_report(host.store)
    out = {}
    for i, label in enumerate(labels):
        loaded = host.store.load_result(i)
        assert loaded is not None  # run_units returned => verified
        out[label] = loaded["artifact"].tobytes()
    return out


def run_fleet_case(
    case,
    yuma_version: str,
    yuma_config=None,
    *,
    fleet: FleetConfig | str | pathlib.Path,
    supervised: bool = True,
    device="cuda",
    x64: bool = False,
) -> tuple:
    """One `run_simulation` executed under fleet coordination: the
    single case is one work unit in the shared store, so N processes
    invoked concurrently with the same store run it EXACTLY once
    (lease-arbitrated), survive the runner dying mid-simulation (lease
    expiry -> any peer re-executes), and all return the same published
    triple. `run_simulation(fleet=...)` routes here; the case runs on
    `device`."""
    from yuma_simulation_tpu_torch.fabric.health import publish_fleet_report
    from yuma_simulation_tpu_torch.simulation.engine import simulate

    if not isinstance(fleet, FleetConfig):
        fleet = FleetConfig(directory=fleet)

    supervision = {}
    if supervised:
        from yuma_simulation_tpu_torch.resilience.retry import (
            default_retry_policy,
        )
        from yuma_simulation_tpu_torch.resilience.supervisor import (
            default_deadline,
        )

        supervision = {
            "retry_policy": default_retry_policy(),
            "deadline": default_deadline(),
        }

    def compute(idx: int, lo: int, hi: int) -> dict:
        result = simulate(
            case,
            yuma_version,
            yuma_config,
            save_bonds=True,
            save_incentives=True,
            device=device,
            x64=x64,
            **supervision,
        )
        return {
            "dividends": np.asarray(result.dividends),
            "bonds": np.asarray(result.bonds),
            "incentives": np.asarray(result.incentives),
            "_engine": result.engine,
        }

    host = FleetHost(fleet)
    host.run_units(
        compute,
        num_units=1,
        unit_lanes=[(0, 1)],
        tag=f"fleet_case:{yuma_version}:{getattr(case, 'name', 'case')}",
        config_fingerprint={
            "driver": "run_fleet_case",
            "version": yuma_version,
            "case": getattr(case, "name", str(case)),
            "shape": [int(d) for d in np.shape(case.weights)],
        },
        result_keys=("dividends", "bonds", "incentives"),
    )
    publish_fleet_report(host.store)
    loaded = host.store.load_result(0)
    assert loaded is not None  # run_units returned => unit 0 verified
    dividends = loaded["dividends"]
    dividends_per_validator = {
        validator: [float(x) for x in dividends[:, i]]
        for i, validator in enumerate(case.validators)
    }
    return (
        dividends_per_validator,
        list(loaded["bonds"]),
        list(loaded["incentives"]),
    )

"""Fleet health: the merged-ledger report and its consistency gate.

Every fleet host writes its own crash-safe
:class:`..resilience.supervisor.FailureLedger` (plus a flight-recorder
bundle) under ``hosts/<host_id>/``; nothing at fleet level is recorded
anywhere else. The :class:`FleetHealthReport` is therefore DERIVED —
a pure function of the merged per-host ledgers plus the result store —
and :func:`check_fleet` is the cross-check: recompute the report from
the ledgers, compare it with the published one, and verify that every
claim on disk resolves to a ledger record (which the per-host bundle
check in turn resolves to a telemetry span). The same
shrink-and-continue semantics as the elastic mesh apply one level up:
:data:`FleetDegradation` IS :class:`..parallel.mesh.MeshDegradation`
with hosts in place of devices, and the surviving roster comes from the
same :func:`..parallel.mesh.surviving_members` filter.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
from typing import Optional

from yuma_simulation_tpu_torch.fabric.store import (
    FLEET_REPORT_NAME,
    FleetStore,
    is_fleet_store,
)
from yuma_simulation_tpu_torch.parallel.mesh import (
    MeshDegradation,
    surviving_members,
)
from yuma_simulation_tpu_torch.utils.checkpoint import (
    publish_atomic,
    read_jsonl_tolerant,
)

logger = logging.getLogger(__name__)

#: One elastic shrink of the fleet's host roster — the same record shape
#: as a mesh shrink, one level up (``from_devices``/``to_devices`` count
#: hosts, ``lost_device_ids`` carries host ids).
FleetDegradation = MeshDegradation

#: FleetHealthReport counts the merged ledgers must reproduce exactly
#: (the fleet half of ``obsreport --check``). Roster fields
#: (hosts_finished et al.) are deliberately NOT cross-checked: they keep
#: moving while late hosts exit, whereas these are fixed once every unit
#: has published.
FLEET_CROSS_CHECKED_COUNTS = (
    "units_published",
    "units_stolen",
    "units_abandoned",
    "units_duplicate",
    "stalls_killed",
    "engine_demotions",
    "mesh_shrinks",
    "lanes_quarantined",
    # Numerics-canary accounting (additive: a report without the keys
    # is skipped by the `key in published` guard).
    "canaries_run",
    "drift_events",
    # Incident accounting (additive, same guard).
    "anomalies_detected",
    "incidents_opened",
    "incidents_resolved",
)


@dataclasses.dataclass(frozen=True)
class FleetHealthReport:
    """What a fleet sweep survived — the cross-host twin of the
    single-host :class:`..resilience.supervisor.SweepHealthReport`,
    derived entirely from the merged per-host ledgers."""

    fleet: str
    num_units: int
    units_published: int
    #: hosts that appended a host_started record, sorted.
    hosts_seen: tuple
    #: hosts that also appended host_finished, sorted.
    hosts_finished: tuple
    #: started-but-never-finished hosts (crashed/preempted), sorted.
    hosts_lost: tuple
    #: distinct units whose lease was stolen after expiry/tear.
    units_stolen: int
    #: executions abandoned on a lost lease (no publish).
    units_abandoned: int
    #: executions whose publish found a verified result already there.
    units_duplicate: int
    #: summed from every accepted (unit_ok) execution:
    stalls_killed: int
    engine_demotions: int
    mesh_shrinks: int
    #: from each unit's LAST unit_ok record (the execution whose result
    #: stands in the store) — the supervisor's resume rule, fleet-wide.
    lanes_quarantined: int
    #: one roster shrink per lost host, in loss order.
    degradations: tuple = ()
    #: numerics-canary re-executions across every accepted execution
    #: (:mod:`..telemetry.numerics`), summed from the unit_ok records.
    canaries_run: int = 0
    #: canary comparisons that CONFIRMED cross-engine drift.
    drift_events: int = 0
    #: per-unit EXECUTED engine rung, from each unit's LAST unit_ok
    #: record (the execution whose result stands in the store) —
    #: `((unit, engine), ...)` sorted by unit. Closes the "pod-scale
    #: paths never show which engine actually ran" gap: the merged
    #: ledgers now answer it unit by unit.
    unit_engines: tuple = ()
    #: incident intelligence (additive): detector firings and
    #: correlated incident transitions across the merged host ledgers.
    anomalies_detected: int = 0
    incidents_opened: int = 0
    incidents_resolved: int = 0

    @property
    def clean(self) -> bool:
        """True iff nothing degraded fleet-wide: every host finished,
        nothing was stolen/abandoned, no unit-level recovery action
        fired, and no canary confirmed drift."""
        return not (
            self.hosts_lost
            or self.units_stolen
            or self.units_abandoned
            or self.stalls_killed
            or self.engine_demotions
            or self.mesh_shrinks
            or self.lanes_quarantined
            or self.drift_events
        )

    def to_json(self) -> dict:
        rec = dataclasses.asdict(self)
        rec["degradations"] = [
            dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d
            for d in self.degradations
        ]
        return rec


def merged_ledger(store: FleetStore) -> list[dict]:
    """Every host's ledger records, merged and time-ordered — the
    fleet's single auditable history."""
    records: list[dict] = []
    for host_id in store.host_ids():
        records.extend(
            read_jsonl_tolerant(store.host_dir(host_id) / "ledger.jsonl")
        )
    records.sort(key=lambda r: float(r.get("t") or 0.0))
    return records


def quarantine_entries(store: FleetStore) -> list:
    """Global-lane quarantine provenance from each unit's LAST unit_ok
    record (the execution whose result stands in the store)."""
    from yuma_simulation_tpu_torch.resilience.guards import QuarantineEntry

    last_ok: dict[int, dict] = {}
    for rec in merged_ledger(store):
        if rec.get("event") == "unit_ok" and "unit" in rec:
            last_ok[rec["unit"]] = rec
    entries = []
    for rec in last_ok.values():
        for item in rec.get("quarantined", ()):
            if isinstance(item, (list, tuple)) and len(item) == 3:
                entries.append(
                    QuarantineEntry(
                        case=int(item[0]),
                        epoch=int(item[1]),
                        tensor=str(item[2]),
                    )
                )
    entries.sort(key=lambda e: (e.case, e.epoch))
    return entries


def build_fleet_report(
    store: FleetStore | str | pathlib.Path,
) -> FleetHealthReport:
    """Derive the report from the merged ledgers + result store (pure;
    no mutation — :func:`publish_fleet_report` persists it)."""
    store = store if isinstance(store, FleetStore) else FleetStore(store)
    manifest = store.manifest()
    records = merged_ledger(store)

    def hosts(event: str) -> set:
        return {
            r.get("host")
            for r in records
            if r.get("event") == event and r.get("host")
        }

    seen = hosts("host_started")
    finished = hosts("host_finished")
    # Loss order follows the steal records (the survivors' view of the
    # failure); hosts that started and never finished but were never
    # stolen from (e.g. crashed after their last publish) append after.
    lost_in_order: list = []
    for r in records:
        if r.get("event") == "unit_stolen":
            prior = r.get("prior_host")
            if prior and prior in seen and prior not in finished:
                if prior not in lost_in_order:
                    lost_in_order.append(prior)
    for host in sorted(seen - finished):
        if host not in lost_in_order:
            lost_in_order.append(host)

    degradations = []
    roster = sorted(seen)
    for host in lost_in_order:
        survivors = surviving_members(roster, [host])
        degradations.append(
            FleetDegradation(
                from_devices=len(roster),
                to_devices=len(survivors),
                lost_device_ids=(host,),
                reason="host_lost",
            )
        )
        roster = survivors

    oks = [r for r in records if r.get("event") == "unit_ok"]
    last_ok: dict[int, dict] = {}
    for r in oks:
        if "unit" in r:
            last_ok[r["unit"]] = r
    published = [
        u
        for u in range(manifest["num_units"])
        if store.verify_result(u)
    ]
    return FleetHealthReport(
        fleet=manifest.get("fleet", "fleet"),
        num_units=manifest["num_units"],
        units_published=len(published),
        hosts_seen=tuple(sorted(seen)),
        hosts_finished=tuple(sorted(finished)),
        hosts_lost=tuple(lost_in_order),
        units_stolen=len(
            {
                r.get("unit")
                for r in records
                if r.get("event") == "unit_stolen"
            }
        ),
        units_abandoned=sum(
            1 for r in records if r.get("event") == "unit_abandoned"
        ),
        units_duplicate=sum(
            1 for r in records if r.get("event") == "unit_duplicate"
        ),
        stalls_killed=sum(int(r.get("stalls", 0)) for r in oks),
        engine_demotions=sum(int(r.get("demotions", 0)) for r in oks),
        mesh_shrinks=sum(int(r.get("mesh_shrinks", 0)) for r in oks),
        lanes_quarantined=sum(
            len(r.get("quarantined", ())) for r in last_ok.values()
        ),
        degradations=tuple(degradations),
        canaries_run=sum(int(r.get("canaries", 0)) for r in oks),
        drift_events=sum(int(r.get("drifts", 0)) for r in oks),
        unit_engines=tuple(
            (unit, str(last_ok[unit].get("engine", "?")))
            for unit in sorted(last_ok)
        ),
        anomalies_detected=sum(
            1 for r in records if r.get("event") == "anomaly_detected"
        ),
        incidents_opened=sum(
            1 for r in records if r.get("event") == "incident_opened"
        ),
        incidents_resolved=sum(
            1 for r in records if r.get("event") == "incident_resolved"
        ),
    )


def publish_fleet_report(
    store: FleetStore | str | pathlib.Path,
) -> FleetHealthReport:
    """Derive and atomically publish ``fleet_report.json``. Called by
    whoever finalizes the sweep (the driver, or any host that observes
    completion); idempotent — the content is a pure function of the
    on-disk ledgers, so re-finalizing after stragglers exit only makes
    the roster fields MORE complete."""
    store = store if isinstance(store, FleetStore) else FleetStore(store)
    report = build_fleet_report(store)
    publish_atomic(
        store.directory / FLEET_REPORT_NAME,
        json.dumps(report.to_json(), sort_keys=True).encode(),
    )
    return report


def load_fleet_report(
    store: FleetStore | str | pathlib.Path,
) -> Optional[dict]:
    store = store if isinstance(store, FleetStore) else FleetStore(store)
    path = store.directory / FLEET_REPORT_NAME
    if not path.exists():
        return None
    try:
        return json.loads(path.read_text())
    except json.JSONDecodeError:
        logger.warning("undecodable %s in %s", FLEET_REPORT_NAME, path.parent)
        return None


def check_fleet(directory: str | pathlib.Path) -> list[str]:
    """Fleet-store consistency problems (empty list = sound):

    - every unit has a verified published result;
    - every published unit has at least one ``unit_ok`` ledger record
      (a result nobody accounts for is a phantom write);
    - every CLAIM on disk resolves to a ledger record: each live lease
      file's (host, unit) matches a ``unit_claimed`` record, and each
      unit's tombstone count equals its ``unit_stolen`` record count
      (torn lease files are tolerated — they are stealable, not sound);
    - the published ``fleet_report.json`` (when present) matches the
      ledger-derived counts exactly (:data:`FLEET_CROSS_CHECKED_COUNTS`).

    Per-host span resolution (every ledger record -> a recorded span)
    is the existing per-host bundle gate
    (:func:`..telemetry.flight.check_bundle`), which ``obsreport``
    runs alongside this.
    """
    directory = pathlib.Path(directory)
    if not is_fleet_store(directory):
        return [f"{directory} is not a fleet store (no fleet manifest)"]
    store = FleetStore(directory)
    manifest = store.manifest()
    records = merged_ledger(store)
    problems: list[str] = []

    for unit in range(manifest["num_units"]):
        if not store.verify_result(unit):
            problems.append(f"unit {unit} has no verified result")
    oks = {
        r.get("unit") for r in records if r.get("event") == "unit_ok"
    }
    for unit in store.published_units():
        if unit not in oks:
            problems.append(
                f"unit {unit} result is published but no host ledger "
                "carries a unit_ok record for it"
            )

    claimed = {
        (r.get("host"), r.get("unit"))
        for r in records
        if r.get("event") == "unit_claimed"
    }
    stolen_counts: dict[int, int] = {}
    for r in records:
        if r.get("event") == "unit_stolen" and "unit" in r:
            stolen_counts[r["unit"]] = stolen_counts.get(r["unit"], 0) + 1
    for lease_path in sorted(store.leases_dir.glob("unit_*.lease")):
        tail = lease_path.stem.split("_", 1)[1]
        if not tail.isdigit():
            continue
        unit = int(tail)
        try:
            data = json.loads(lease_path.read_text())
            host = data.get("host") if isinstance(data, dict) else None
        except (json.JSONDecodeError, OSError):
            continue  # torn lease: stealable, tolerated
        if host and (host, unit) not in claimed:
            problems.append(
                f"lease for unit {unit} names host {host!r} but no "
                "ledger carries its unit_claimed record"
            )
    tombstones: dict[int, int] = {}
    for p in store.leases_dir.glob("stale_unit_*"):
        tail = p.name.split(".", 1)[0].rsplit("_", 1)[1]
        if tail.isdigit():
            unit = int(tail)
            tombstones[unit] = tombstones.get(unit, 0) + 1
    for unit in sorted(set(tombstones) | set(stolen_counts)):
        # Every LEDGERED steal must have its durable tombstone (the
        # rename happens strictly before the record is appended, so a
        # deficit means fabricated or lost evidence). The converse is
        # tolerated: a stealer killed between its tombstone rename and
        # its ledger append leaves an EXCESS tombstone — the store is
        # still recoverable (another host re-steals and completes), and
        # flagging it would make a sound, finished sweep fail --check
        # forever with no repair path.
        if tombstones.get(unit, 0) < stolen_counts.get(unit, 0):
            problems.append(
                f"unit {unit}: {stolen_counts.get(unit, 0)} unit_stolen "
                f"ledger records but only {tombstones.get(unit, 0)} "
                "steal tombstones on disk"
            )

    published = load_fleet_report(store)
    if published is not None:
        derived = build_fleet_report(store).to_json()
        for key in FLEET_CROSS_CHECKED_COUNTS:
            if key in published and int(published[key]) != int(derived[key]):
                problems.append(
                    f"fleet_report.{key}={published[key]} but the merged "
                    f"ledgers derive {derived[key]}"
                )
    return problems

"""Cross-signal incident correlation: anomalies + SLO transitions +
typed fault ledger events joined into durable incident records.

The join rule: a typed FAULT ledger event (quarantine,
stall, restart, worker loss, drift — :data:`CAUSE_EVENTS`) opens an
incident; SYMPTOM records (``anomaly_detected`` from :mod:`.anomaly`,
``slo_alert`` burn transitions) attach to the best-matching open cause
within a causal window, preferring subject overlap, then trace-context
parentage (shared ``run_id`` and span adjacency), then time proximity.
Symptoms with no cause candidate stay unattributed — they NEVER open
incidents, which is what makes the clean-run zero-incident bound
provable: no typed fault, no incident.

Incident identity is ``<cause-class>:<subject>`` — deterministic
across processes, so a restarted controller re-deriving the same
stall folds into the SAME incident when ``incidents.jsonl`` appends
from both incarnations merge (readers keep the last record per id,
:func:`latest_incidents`).

Two consumption modes:

- offline — :func:`correlate` / :func:`correlate_bundle` are pure
  functions of ledger records; ``tools/incidentreport.py`` runs them
  on any bundle (drill bundles have no runtime engine);
- runtime — :class:`IncidentEngine` rides a standing host's cycle
  (the JAX package's replay controller drives one): feeds the time-series store, ledgers detector anomalies,
  appends every incident state transition durably
  (:meth:`..flight.FlightRecorder.record_incident`, crash-safe via
  ``append_durable`` and segmented-rotation aware by construction —
  the sink lives at the bundle root), and keeps the
  ``incidents_open`` gauge / ``anomalies_total`` counter live in the
  metrics registry.

Host-only arithmetic over records: given the same record streams, the
port's anomalies and incidents equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import logging
import pathlib
import time
from typing import Iterable, Optional

from yuma_simulation_tpu_torch.telemetry.anomaly import (
    AnomalyEngine,
    default_replay_engine,
)
from yuma_simulation_tpu_torch.telemetry.timeseries import TimeSeriesStore

logger = logging.getLogger(__name__)

#: Typed ledger events that OPEN incidents, mapped to their cause
#: class. Symptom streams (anomaly_detected, slo_alert) are
#: deliberately absent: a symptom without a typed cause is a question,
#: not an incident.
CAUSE_EVENTS = {
    "subnet_quarantined": "snapshot-corruption",
    "subnet_stalled": "subnet-stall",
    "controller_restarted": "process-loss",
    "worker_lost": "worker-loss",
    "unit_stalled": "engine-stall",
    "engine_drift": "canary-drift",
    "canary_failed": "canary-failure",
}

#: Symptom record types that attach to (never open) incidents.
SYMPTOM_EVENTS = ("anomaly_detected", "slo_alert")

#: cause class -> ledger events that RESOLVE it (subject-matched when
#: the resolver carries the subject field). Classes absent here stay
#: open until an operator closes them out-of-band:
#: snapshot-corruption resolves on its own quarantine (the blast is
#: contained the moment the blob is excluded), canary-drift never
#: auto-resolves (a drifting rung is not healed by time).
RESOLVE_EVENTS = {
    "subnet-stall": ("subnet_ingested", "watermark_advanced"),
    "process-loss": ("watermark_advanced", "window_swept"),
    "worker-loss": ("worker_spawned",),
    "engine-stall": ("unit_ok",),
}

#: Record fields that identify WHO an event is about, in match-priority
#: order; the first present one is the incident subject.
SUBJECT_KEYS = ("netuid", "unit", "worker", "host", "run", "bucket")

#: Fields unioned into the blast radius, per dimension.
BLAST_KEYS = {
    "netuids": "netuid",
    "units": "unit",
    "workers": "worker",
    "tenants": "tenant",
    "hosts": "host",
    "versions": "version",
}

#: Seconds around a cause inside which symptoms may attach.
DEFAULT_CAUSAL_WINDOW = 120.0

#: Most symptom-timeline entries one incident record retains.
MAX_SYMPTOMS = 32

#: Every ledger event type correlate() can act on — causes, symptoms,
#: resolvers. The runtime engine feeds ONLY these into its correlation
#: window; everything else in the ledger is noise to the join.
CORRELATION_EVENTS = (
    frozenset(CAUSE_EVENTS)
    | frozenset(SYMPTOM_EVENTS)
    | frozenset(ev for evs in RESOLVE_EVENTS.values() for ev in evs)
)

#: Most records the runtime engine keeps in its correlation window.
#: Bounds tick() cost on long soaks; cause records are never trimmed
#: (dropping one would flip its incident back to unseen).
MAX_CORRELATE_RECORDS = 4096


def _subject(record: dict) -> str:
    for key in SUBJECT_KEYS:
        if key in record and record[key] is not None:
            return f"{key}={record[key]}"
    return ""


def _timeline_entry(record: dict, kind: str) -> dict:
    entry = {"kind": kind, "event": record.get("event"),
             "t": record.get("t")}
    for key in ("series", "detail", "reason", "slo", "state", "netuid",
                "unit", "worker", "value"):
        if key in record:
            entry[key] = record[key]
    return entry


@dataclasses.dataclass
class Incident:
    """One correlated incident: cause, symptom timeline, blast radius,
    resolution state."""

    incident: str
    cause_class: str
    subject: str
    state: str  #: "open" | "resolved"
    opened_t: float
    cause: dict
    symptoms: list = dataclasses.field(default_factory=list)
    blast_radius: dict = dataclasses.field(default_factory=dict)
    resolved_t: Optional[float] = None
    resolution: str = ""
    run_id: str = ""
    span_id: str = ""

    def to_json(self) -> dict:
        rec = dataclasses.asdict(self)
        rec["symptoms"] = list(self.symptoms[:MAX_SYMPTOMS])
        return rec

    def _absorb(self, record: dict) -> None:
        for dim, key in BLAST_KEYS.items():
            if key in record and record[key] is not None:
                values = self.blast_radius.setdefault(dim, [])
                if record[key] not in values:
                    values.append(record[key])


def _relatedness(incident: Incident, symptom: dict) -> int:
    """Attachment score: 3 subject overlap, 2 span adjacency in the
    same run, 1 same run, 0 unrelated-but-in-window."""
    if _subject(symptom) and _subject(symptom) == incident.subject:
        return 3
    if symptom.get("run_id") and symptom.get("run_id") == incident.run_id:
        cause = incident.cause
        near = {cause.get("span_id"), cause.get("parent_id")} - {None, ""}
        if symptom.get("span_id") in near or symptom.get("parent_id") in near:
            return 2
        return 1
    return 0


def correlate(
    records: Iterable[dict],
    *,
    causal_window: float = DEFAULT_CAUSAL_WINDOW,
) -> list[Incident]:
    """Pure correlation over ledger-shaped records (any order):
    incidents keyed by ``(cause_class, subject)``, earliest matching
    cause wins, recurrences and symptoms fold into the timeline,
    resolution derived from matching recovery events."""
    ordered = sorted(
        (r for r in records if isinstance(r, dict)),
        key=lambda r: float(r.get("t") or 0.0),
    )
    incidents: dict[str, Incident] = {}
    for rec in ordered:
        cls = CAUSE_EVENTS.get(rec.get("event", ""))
        if cls is None:
            continue
        subject = _subject(rec)
        ident = f"{cls}:{subject}" if subject else cls
        inc = incidents.get(ident)
        if inc is None:
            inc = Incident(
                incident=ident,
                cause_class=cls,
                subject=subject,
                state="open",
                opened_t=float(rec.get("t") or 0.0),
                cause=dict(rec),
                run_id=str(rec.get("run_id") or ""),
                span_id=str(rec.get("span_id") or ""),
            )
            incidents[ident] = inc
        else:
            inc.symptoms.append(_timeline_entry(rec, "recurrence"))
        inc._absorb(rec)
    if not incidents:
        return []

    for rec in ordered:
        if rec.get("event") not in SYMPTOM_EVENTS:
            continue
        t = float(rec.get("t") or 0.0)
        best: Optional[tuple] = None
        for inc in incidents.values():
            if abs(t - inc.opened_t) > causal_window:
                continue
            score = _relatedness(inc, rec)
            if score < 1 and _subject(rec):
                continue  # a subject-bearing symptom must actually match
            key = (score, -abs(t - inc.opened_t))
            if best is None or key > best[0]:
                best = (key, inc)
        if best is not None:
            kind = "anomaly" if rec.get("event") == "anomaly_detected" \
                else "slo_transition"
            best[1].symptoms.append(_timeline_entry(rec, kind))
            best[1]._absorb(rec)

    for inc in incidents.values():
        if inc.cause_class == "snapshot-corruption":
            # The quarantine IS the mitigation: the corrupt blob is
            # durably excluded the instant the cause event exists.
            inc.state = "resolved"
            inc.resolved_t = inc.opened_t
            inc.resolution = "quarantined"
            continue
        resolvers = RESOLVE_EVENTS.get(inc.cause_class, ())
        if not resolvers:
            continue
        subject_key = inc.subject.split("=", 1)[0] if inc.subject else ""
        for rec in ordered:
            if rec.get("event") not in resolvers:
                continue
            t = float(rec.get("t") or 0.0)
            if t <= inc.opened_t:
                continue
            if subject_key and subject_key in rec and \
                    _subject(rec) != inc.subject:
                continue
            inc.state = "resolved"
            inc.resolved_t = t
            inc.resolution = str(rec.get("event"))
            break
    out = sorted(incidents.values(), key=lambda i: i.opened_t)
    for inc in out:
        inc.symptoms.sort(key=lambda e: float(e.get("t") or 0.0))
        del inc.symptoms[MAX_SYMPTOMS:]
    return out


def correlate_bundle(bundle, **kwargs) -> list[Incident]:
    """Offline correlation over a loaded :class:`..flight.Bundle`."""
    return correlate(bundle.ledger, **kwargs)


def unattributed_symptoms(
    records: Iterable[dict],
    incidents: Iterable[Incident],
) -> list[dict]:
    """Symptom records no incident's timeline absorbed — rendered (not
    failed) by incidentreport: a symptom without a cause is a question
    for the operator, not a correlation defect."""
    attached = set()
    for inc in incidents:
        for entry in inc.symptoms:
            attached.add((entry.get("event"), entry.get("t")))
    return [
        r
        for r in records
        if isinstance(r, dict)
        and r.get("event") in SYMPTOM_EVENTS
        and (r.get("event"), r.get("t")) not in attached
    ]


# ------------------------------------------------- durable record I/O


def latest_incidents(records: Iterable[dict]) -> list[dict]:
    """Fold raw ``incidents.jsonl`` append-order records to current
    state: last record per incident id wins (every transition
    re-appends the full state)."""
    latest: dict[str, dict] = {}
    for rec in records:
        if isinstance(rec, dict) and rec.get("incident"):
            latest[str(rec["incident"])] = rec
    return sorted(
        latest.values(), key=lambda r: float(r.get("opened_t") or 0.0)
    )


def load_incidents(directory) -> list[dict]:
    """Current incident states from a bundle directory's
    ``incidents.jsonl`` ([] when the sink does not exist — the
    unfaulted control arms never create it)."""
    from yuma_simulation_tpu_torch.telemetry.flight import INCIDENTS_NAME
    from yuma_simulation_tpu_torch.utils.checkpoint import read_jsonl_tolerant

    path = pathlib.Path(directory) / INCIDENTS_NAME
    if not path.exists():
        return []
    return latest_incidents(read_jsonl_tolerant(path))


def open_incident_count(directory) -> int:
    """How many incidents are currently open."""
    return sum(
        1 for rec in load_incidents(directory) if rec.get("state") == "open"
    )


# ------------------------------------------------------ runtime engine


class IncidentEngine:
    """The controller-cycle runtime: time-series feed -> anomaly scan
    -> ledgered symptoms -> correlation -> durable incident records +
    live gauges. One instance per controller; everything host-side."""

    def __init__(
        self,
        ledger,
        recorder,
        *,
        registry=None,
        anomaly_engine: Optional[AnomalyEngine] = None,
        causal_window: float = DEFAULT_CAUSAL_WINDOW,
        source: str = "",
    ):
        from yuma_simulation_tpu_torch.telemetry.metrics import get_registry

        self.ledger = ledger
        self.recorder = recorder
        self.registry = registry if registry is not None else get_registry()
        self.anomalies = (
            anomaly_engine if anomaly_engine is not None
            else default_replay_engine()
        )
        self.causal_window = float(causal_window)
        self.source = source
        self.store = TimeSeriesStore()
        self._known: dict[str, str] = {}  # incident id -> last state
        # Incremental correlation window: tick() consumes only the
        # ledger entries appended since the last tick (the in-memory
        # ledger is append-only, so an index cursor is exact) and keeps
        # the correlation-relevant ones, bounded — NOT the full ledger,
        # which would make every cycle O(ledger) and the run quadratic.
        self._ledger_cursor = 0
        self._window: list[dict] = []
        self._open_gauge = self.registry.gauge(
            "incidents_open",
            help="correlated incidents currently open in this bundle",
        )
        self._anomaly_counter = self.registry.counter(
            "anomalies_total",
            help="detector anomalies ledgered as anomaly_detected",
        )
        # Fold incidents a prior incarnation already recorded so a
        # restarted controller re-deriving the same incident appends a
        # transition only when the state actually moved.
        try:
            for rec in load_incidents(self.recorder.directory):
                self._known[str(rec["incident"])] = str(
                    rec.get("state") or "open"
                )
        except Exception:
            logger.warning("prior incident reload failed", exc_info=True)

    def feed_snapshot(self, now: Optional[float] = None) -> int:
        """Fold one live registry snapshot (+ dispatch sketches) into
        the time-series store; returns how many anomalies fired and
        were ledgered."""
        from yuma_simulation_tpu_torch.telemetry.metrics import _next_seq
        from yuma_simulation_tpu_torch.telemetry.slo import dispatch_snapshot
        from yuma_simulation_tpu_torch.utils.logging import log_event

        # Same seq counter as the persisted snapshot paths (metrics.py),
        # so live and bundle records share one dedupe identity — without
        # it the store falls back to (source, rounded t) and two
        # snapshots on a coarse/stepped clock silently collapse.
        record = {
            "t": round(now if now is not None else time.time(), 6),
            "seq": _next_seq(),
            **self.registry.snapshot(),
        }
        sketches = dispatch_snapshot()
        if sketches:
            record["dispatch_sketches"] = sketches
        self.store.ingest_snapshot(record, source=self.source or "live")
        fired = self.anomalies.scan(self.store)
        for a in fired:
            self.ledger.append(
                "anomaly_detected",
                kind=a.kind,
                series=a.series,
                value=a.value,
                baseline=a.baseline,
                threshold=a.threshold,
                window=a.window,
                detail=a.detail,
            )
            log_event(
                logger,
                "anomaly_detected",
                kind=a.kind,
                series=a.series,
                detail=a.detail,
            )
            self._anomaly_counter.inc()
        return len(fired)

    def _advance_window(self) -> list[dict]:
        """Fold ledger entries appended since the last tick into the
        bounded correlation window and return it."""
        entries = self.ledger.entries()
        for rec in entries[self._ledger_cursor:]:
            if isinstance(rec, dict) and \
                    rec.get("event") in CORRELATION_EVENTS:
                self._window.append(rec)
        self._ledger_cursor = len(entries)
        if len(self._window) > MAX_CORRELATE_RECORDS:
            causes = [
                r for r in self._window if r.get("event") in CAUSE_EVENTS
            ]
            rest = [
                r for r in self._window
                if r.get("event") not in CAUSE_EVENTS
            ]
            keep = max(MAX_CORRELATE_RECORDS - len(causes), 0)
            self._window = causes + rest[len(rest) - keep:]
        return self._window

    def tick(self, now: Optional[float] = None) -> list[Incident]:
        """One correlation pass: feed the snapshot, re-derive incidents
        from the correlation window (pure + idempotent; fed
        incrementally and bounded, so a cycle costs O(window), not
        O(ledger lifetime)), durably append every state transition,
        ledger the typed open/resolve events, refresh the gauge.
        Returns the current incident set."""
        from yuma_simulation_tpu_torch.utils.logging import log_event

        self.feed_snapshot(now)
        incidents = correlate(
            self._advance_window(), causal_window=self.causal_window
        )
        for inc in incidents:
            prior = self._known.get(inc.incident)
            if prior == inc.state:
                continue
            self._known[inc.incident] = inc.state
            self.recorder.record_incident(inc.to_json())
            if prior is None:
                self.ledger.append(
                    "incident_opened",
                    incident=inc.incident,
                    cause_class=inc.cause_class,
                    cause_event=str(inc.cause.get("event")),
                    subject=inc.subject,
                    state=inc.state,
                )
                log_event(
                    logger,
                    "incident_opened",
                    incident=inc.incident,
                    cause_class=inc.cause_class,
                )
            if inc.state == "resolved":
                self.ledger.append(
                    "incident_resolved",
                    incident=inc.incident,
                    cause_class=inc.cause_class,
                    resolution=inc.resolution,
                )
                log_event(
                    logger,
                    "incident_resolved",
                    incident=inc.incident,
                    resolution=inc.resolution,
                )
        self._open_gauge.set(
            sum(1 for i in incidents if i.state == "open")
        )
        return incidents

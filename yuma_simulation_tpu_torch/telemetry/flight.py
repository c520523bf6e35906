"""The sweep flight recorder: one on-disk bundle per supervised run (the
JAX package's `telemetry/flight.py`; file names and record formats are
the same, so `tools/obsreport`, `tools/sloreport` and `tools/driftreport`
read a port bundle as they read a JAX one).

A supervised sweep already leaves a crash-safe ledger
(:class:`..resilience.supervisor.FailureLedger`); this module adds the
two sides the ledger cannot tell on its own — WHEN everything happened
(the span tree) and HOW FAST/BIG it was (metrics snapshots) — and the
loader/consistency half that `tools/obsreport.py` renders.

Bundle layout (inside the supervisor's checkpoint `directory`):

- ``ledger.jsonl``  — per-unit outcomes (the supervisor writes it live,
  each record stamped with ``run_id``/``span_id``/``t``);
- ``spans.jsonl``   — every closed span of every run, close order
  (appended per run, atomic whole-file republish);
- ``metrics.jsonl`` — one registry snapshot line per run;
- ``costs.jsonl``   — AOT cost records (:class:`..cost.CostRecord`
  lines, run-stamped) when anything captured them — the supervisor's
  opt-in, bench, or an operator's explicit capture;
- ``numerics.jsonl`` — per-epoch tensor-stat records
  (:mod:`..numerics`): one line per (unit, stream, role) with per-lane
  finite fraction / min / max / absmax and the bit-cast-u32 reduction
  fingerprint, primary and canary roles side by side — what
  ``tools/driftreport.py --check`` compares;
- ``report.json``   — the LAST run's :class:`SweepHealthReport` (plus
  its ``run_id``), for the ledger<->report cross-check.

All four accumulate across resumes — the bundle is the full history of
the directory, grouped by ``run_id``. Every sink publishes atomically
(temp + fsync + rename) and every loader tolerates torn/undecodable
lines, matching the ledger's crash-safety contract; the formats only
ever gain keys (old readers still parse them).

Continuous mode (0.23.0): a *standing* service (the replay controller,
the serve tier) never closes, so the monolithic whole-file republish
above is O(total-spans) per flush and the bundle grows without bound.
Rotation (:class:`RotationPolicy`, opt-in via the ``rotation=``
argument or ``YUMA_TPU_FLIGHT_ROTATE=1``; default OFF) re-routes the
span/metrics/numerics streams into crash-safe segment files::

    segments/seg_000000/{open.json, spans.jsonl, metrics.jsonl,
                         numerics.jsonl, seal.json}

The live segment is append-only (``append_durable`` — O(batch) on the
hot thread, torn-tail-tolerant like the watermark store); when it
exceeds the policy's size/age bound it is SEALED by publishing
``seal.json`` atomically (a ``segment_sealed`` record naming the
segment's run ids and byte size), and the next append opens the next
segment. Retention compaction deletes the oldest sealed segments past
``max_retained_bytes`` — never one whose run ids intersect the open
runs registered via :meth:`FlightRecorder.mark_run_open` — and leaves
an atomic ``compacted.json`` tombstone so ``check_bundle`` can exempt
exactly the history that was traded for bounded disk. ``ledger.jsonl``
/ ``report.json`` / ``slo.json`` / ``costs.jsonl`` stay at the root
(already O(batch) or point-in-time singletons). ``profiles.jsonl``
(root, append-only) registers on-demand profiler trace artifacts.
:func:`load_bundle` unions root + segments (newest span per
``(run_id, span_id)`` wins, numerics deduped by identity) so
``check_bundle``/``merge_bundles``/``check_stitched`` and every gate
read segmented and monolithic bundles identically — a monolithic
bundle (no ``segments/``) loads bit-for-bit as before.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pathlib
import shutil
import time
from typing import Optional, Union

from yuma_simulation_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    get_registry,
)
from yuma_simulation_tpu_torch.telemetry.runctx import RunContext
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

LEDGER_NAME = "ledger.jsonl"
SPANS_NAME = "spans.jsonl"
METRICS_NAME = "metrics.jsonl"
COSTS_NAME = "costs.jsonl"
REPORT_NAME = "report.json"
SLO_NAME = "slo.json"
NUMERICS_NAME = "numerics.jsonl"
SEGMENTS_DIR = "segments"
SEGMENT_PREFIX = "seg_"
SEAL_NAME = "seal.json"
OPEN_NAME = "open.json"
COMPACTED_NAME = "compacted.json"
OPEN_RUNS_NAME = "open_runs.json"
PROFILES_NAME = "profiles.jsonl"
INCIDENTS_NAME = "incidents.jsonl"

#: Env opt-in for rotation (see :class:`RotationPolicy`): "1"/"true"
#: turns it on with defaults for processes whose construction the
#: operator does not control (the supervisor inside a CLI sweep).
ROTATE_ENV = "YUMA_TPU_FLIGHT_ROTATE"


@dataclasses.dataclass(frozen=True)
class RotationPolicy:
    """When and how the segmented flight recorder rotates.

    A segment seals when its JSONL payload exceeds
    ``max_segment_bytes`` OR its age exceeds
    ``max_segment_age_seconds`` (either bound <= 0 disables that
    trigger). Retention keeps every sealed segment until their total
    size exceeds ``max_retained_bytes`` (<= 0 = keep everything), then
    deletes oldest-first — but never below ``min_retained_segments``
    sealed segments, and NEVER a segment whose recorded run ids
    intersect the directory's open runs (:meth:`FlightRecorder
    .mark_run_open`)."""

    max_segment_bytes: int = 1 << 20
    max_segment_age_seconds: float = 300.0
    max_retained_bytes: int = 0
    min_retained_segments: int = 2


def rotation_from_env() -> Optional[RotationPolicy]:
    """The :data:`ROTATE_ENV` opt-in: a default policy when set truthy,
    else None (rotation stays off — the 0.22-and-earlier behavior).
    An integer value > 1 is a segment byte bound (``"1"`` stays the
    plain on-with-defaults spelling): the CI soak lane uses a small
    bound so rotation demonstrably seals within a short run."""
    raw = os.environ.get(ROTATE_ENV, "").strip().lower()
    if raw in ("", "0", "false", "no", "off"):
        return None
    if raw.isdigit() and int(raw) > 1:
        return RotationPolicy(max_segment_bytes=int(raw))
    return RotationPolicy()

#: The SweepHealthReport action counts the ledger must reproduce exactly
#: (report field -> derivation, see :func:`ledger_counts`).
CROSS_CHECKED_COUNTS = (
    "stalls_killed",
    "units_requeued",
    "engine_demotions",
    "mesh_shrinks",
    "lanes_quarantined",
    # 0.14.0 — numerics-canary accounting (additive: pre-0.14 reports
    # lack the keys and are skipped by the `key in fields` guard).
    "canaries_run",
    "drift_events",
)


def _read_jsonl(path: pathlib.Path) -> list[dict]:
    """The shared tolerant JSONL reader (see
    :func:`..utils.checkpoint.read_jsonl_tolerant`) — lazy import to
    keep this module import-light."""
    from yuma_simulation_tpu_torch.utils.checkpoint import read_jsonl_tolerant

    return read_jsonl_tolerant(path)


class FlightRecorder:
    """Writes the per-run bundle. One instance per directory; `record`
    is called once per run by the supervisor (success AND failure paths
    — a crashed sweep's spans are exactly the ones worth keeping).

    `rotation` (a :class:`RotationPolicy`; default: the
    :data:`ROTATE_ENV` opt-in, else None/off) switches the span/
    metrics/numerics streams into segmented continuous mode — see the
    module docstring. The recorder itself is stateless across
    instances: segment liveness, open-run registration, and tombstones
    all live on disk, so a fresh ``FlightRecorder(dir)`` per flush (the
    serving tier's pattern) continues exactly where the last left off."""

    def __init__(
        self,
        directory: Union[str, pathlib.Path],
        *,
        rotation: Optional[RotationPolicy] = None,
    ):
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.rotation = (
            rotation if rotation is not None else rotation_from_env()
        )

    # -- segmented continuous mode --------------------------------------

    def _segments_root(self) -> pathlib.Path:
        return self.directory / SEGMENTS_DIR

    def _segment_dirs(self) -> list[pathlib.Path]:
        root = self._segments_root()
        if not root.is_dir():
            return []
        out = []
        for p in root.iterdir():
            tail = p.name[len(SEGMENT_PREFIX):]
            if p.is_dir() and p.name.startswith(SEGMENT_PREFIX) and tail.isdigit():
                out.append(p)
        return sorted(out, key=lambda p: int(p.name[len(SEGMENT_PREFIX):]))

    @staticmethod
    def _segment_sealed(seg: pathlib.Path) -> bool:
        return (seg / SEAL_NAME).exists()

    @staticmethod
    def _segment_bytes(seg: pathlib.Path) -> int:
        total = 0
        for name in (SPANS_NAME, METRICS_NAME, NUMERICS_NAME):
            try:
                total += (seg / name).stat().st_size
            except OSError:
                continue
        return total

    def _open_segment(self, index: int) -> pathlib.Path:
        from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

        seg = self._segments_root() / f"{SEGMENT_PREFIX}{index:06d}"
        seg.mkdir(parents=True, exist_ok=True)
        if not (seg / OPEN_NAME).exists():
            publish_atomic(
                seg / OPEN_NAME,
                json.dumps(
                    {"index": index, "t_opened": round(time.time(), 6)}
                ).encode(),
            )
        return seg

    def live_segment(self) -> pathlib.Path:
        """The segment the next append lands in: the highest-numbered
        unsealed one (a restarted writer continues its predecessor's
        open segment — at most its torn tail is at risk), else a fresh
        segment after the highest sealed index."""
        segs = self._segment_dirs()
        if segs and not self._segment_sealed(segs[-1]):
            return segs[-1]
        nxt = (
            int(segs[-1].name[len(SEGMENT_PREFIX):]) + 1 if segs else 0
        )
        return self._open_segment(nxt)

    def mark_run_open(self, run_id: str) -> None:
        """Register `run_id` as OPEN in this directory: retention will
        never delete a sealed segment holding its records. Long-lived
        hosts register their lifetime run at startup; idempotent."""
        from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

        runs = set(self.open_run_ids())
        if run_id in runs:
            return
        runs.add(run_id)
        publish_atomic(
            self.directory / OPEN_RUNS_NAME,
            json.dumps({"run_ids": sorted(runs)}).encode(),
        )

    def mark_run_closed(self, run_id: str) -> None:
        """Release `run_id`'s retention pin (idempotent)."""
        from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

        runs = set(self.open_run_ids())
        if run_id not in runs:
            return
        runs.discard(run_id)
        publish_atomic(
            self.directory / OPEN_RUNS_NAME,
            json.dumps({"run_ids": sorted(runs)}).encode(),
        )

    def open_run_ids(self) -> list[str]:
        path = self.directory / OPEN_RUNS_NAME
        if not path.exists():
            return []
        try:
            return [
                str(r) for r in json.loads(path.read_text()).get("run_ids", [])
            ]
        except (json.JSONDecodeError, OSError):
            return []

    def seal_live_segment(self) -> Optional[pathlib.Path]:
        """Seal the live segment NOW (rotation normally does this when a
        bound trips): publish its ``seal.json`` atomically, bump the
        telemetry metrics, run retention. Returns the sealed segment
        (None when the live segment holds no records yet — an empty
        seal would be noise)."""
        from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

        segs = self._segment_dirs()
        if not segs or self._segment_sealed(segs[-1]):
            return None  # nothing live — and never mint an empty one
        seg = segs[-1]
        size = self._segment_bytes(seg)
        if size == 0:
            return None
        run_ids: dict[str, None] = {}
        for name in (SPANS_NAME, NUMERICS_NAME, METRICS_NAME):
            for rec in _read_jsonl(seg / name):
                rid = rec.get("run_id")
                if rid:
                    run_ids.setdefault(str(rid), None)
        index = int(seg.name[len(SEGMENT_PREFIX):])
        seal = {
            "event": "segment_sealed",
            "segment": seg.name,
            "index": index,
            "t": round(time.time(), 6),
            "bytes": size,
            "run_ids": list(run_ids),
        }
        publish_atomic(seg / SEAL_NAME, json.dumps(seal, sort_keys=True).encode())
        log_event(
            logger,
            "segment_sealed",
            segment=seg.name,
            t=seal["t"],
            bytes=size,
            run_ids=",".join(run_ids),
            runs=len(run_ids),
        )
        reg = get_registry()
        reg.counter(
            "telemetry_segments_total",
            help="flight-recorder segments sealed by rotation",
        ).inc()
        self._compact_retained()
        reg.gauge(
            "telemetry_bytes_retained",
            help="bytes of sealed flight segments currently retained",
        ).set(
            sum(
                self._segment_bytes(s)
                for s in self._segment_dirs()
                if self._segment_sealed(s)
            )
        )
        return seg

    def _maybe_rotate(self) -> None:
        """Post-append trigger: seal the live segment once a size/age
        bound trips. Contained — rotation must never fail the flush
        that fed it."""
        policy = self.rotation
        if policy is None:
            return
        try:
            seg = self.live_segment()
            size = self._segment_bytes(seg)
            if size == 0:
                return
            over_size = (
                policy.max_segment_bytes > 0
                and size >= policy.max_segment_bytes
            )
            over_age = False
            if policy.max_segment_age_seconds > 0:
                try:
                    opened = float(
                        json.loads((seg / OPEN_NAME).read_text()).get(
                            "t_opened", 0.0
                        )
                    )
                except (OSError, json.JSONDecodeError, ValueError):
                    opened = 0.0
                over_age = (
                    opened > 0
                    and time.time() - opened
                    >= policy.max_segment_age_seconds
                )
            if over_size or over_age:
                self.seal_live_segment()
        except Exception:
            logger.warning(
                "segment rotation failed in %s", self.directory,
                exc_info=True,
            )

    def _compact_retained(self) -> None:
        """Retention: delete oldest sealed segments past the policy's
        ``max_retained_bytes``, skipping any whose run ids intersect
        the open runs; each pass merges into the atomic
        ``compacted.json`` tombstone that check_bundle honors."""
        from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

        policy = self.rotation
        if policy is None or policy.max_retained_bytes <= 0:
            return
        open_runs = set(self.open_run_ids())
        sealed = [s for s in self._segment_dirs() if self._segment_sealed(s)]
        sizes = {s: self._segment_bytes(s) for s in sealed}
        total = sum(sizes.values())
        dropped: list[dict] = []
        for seg in sealed:
            if (
                total <= policy.max_retained_bytes
                or len(sealed) - len(dropped)
                <= max(0, policy.min_retained_segments)
            ):
                break
            try:
                seal = json.loads((seg / SEAL_NAME).read_text())
            except (OSError, json.JSONDecodeError):
                seal = {"segment": seg.name, "run_ids": []}
            if open_runs & set(seal.get("run_ids", ())):
                # An open run's history is live evidence: a segment it
                # touched is never reclaimed, whatever the byte bound
                # says. (Oldest-first means later segments may still
                # free space below.)
                continue
            shutil.rmtree(seg, ignore_errors=True)
            total -= sizes[seg]
            dropped.append(
                {
                    "segment": seal.get("segment", seg.name),
                    "bytes": sizes[seg],
                    "run_ids": list(seal.get("run_ids", ())),
                }
            )
        if not dropped:
            return
        path = self.directory / COMPACTED_NAME
        prior = {"segments": 0, "bytes": 0, "run_ids": []}
        if path.exists():
            try:
                prior.update(json.loads(path.read_text()))
            except (OSError, json.JSONDecodeError):
                pass
        run_ids = set(prior.get("run_ids", ())) | {
            rid for d in dropped for rid in d["run_ids"]
        }
        tombstone = {
            "event": "segments_compacted",
            "t": round(time.time(), 6),
            "segments": int(prior.get("segments", 0)) + len(dropped),
            "bytes": int(prior.get("bytes", 0))
            + sum(d["bytes"] for d in dropped),
            "run_ids": sorted(run_ids),
        }
        publish_atomic(path, json.dumps(tombstone, sort_keys=True).encode())
        log_event(
            logger,
            "segments_compacted",
            segments=len(dropped),
            bytes=sum(d["bytes"] for d in dropped),
        )

    def record_profile(self, record: dict) -> None:
        """Register one on-demand profiler capture (`profile_published`
        consumers read ``profiles.jsonl``): append-only at the bundle
        root — profile sessions are rare and their artifact directories
        live outside the rotation streams."""
        from yuma_simulation_tpu_torch.utils.checkpoint import append_durable

        line = dict(record)
        line.setdefault("t", round(time.time(), 6))
        append_durable(
            self.directory / PROFILES_NAME,
            (json.dumps(line, sort_keys=True) + "\n").encode(),
        )

    def record_incident(self, record: dict) -> None:
        """Append one incident state record (``incidents.jsonl``): an
        append-only root sink like ``profiles.jsonl`` — incidents are
        rare, span segment rotations, and re-append their full state on
        every transition, so readers keep the LAST record per incident
        id and a torn tail costs one transition, never history."""
        from yuma_simulation_tpu_torch.utils.checkpoint import append_durable

        line = dict(record)
        line.setdefault("t", round(time.time(), 6))
        append_durable(
            self.directory / INCIDENTS_NAME,
            (json.dumps(line, sort_keys=True) + "\n").encode(),
        )

    def record(
        self,
        run: RunContext,
        *,
        registry: Optional[MetricsRegistry] = None,
        report=None,
        extra_runs=(),
        slo_engine=None,
    ) -> None:
        """Append `run`'s spans to ``spans.jsonl``, one registry
        snapshot line to ``metrics.jsonl``, and (when given) publish the
        run's health report to ``report.json``.

        Spans are merged by ``(run_id, span_id)``, newest wins: a
        mid-run publish records still-open ancestors as
        ``status="open"``, and a later publish of the same run (a second
        supervised sweep under one operator RunContext) replaces them
        with their closed form instead of duplicating them.
        `extra_runs` (further :class:`RunContext`s — e.g. a server's
        per-request ingress runs continuing remote traces) merge into
        the SAME republish so a bundle publish stays one atomic write
        per sink.

        The process SLO state (:mod:`..slo`) publishes alongside as
        ``slo.json`` whenever an engine with specs exists — pass
        `slo_engine` to pin a specific one (the serving tier's), default
        is the process engine. SLO capture failures are contained: the
        span/metrics record above must never be misreported as failed
        because the SLO snapshot was."""
        from yuma_simulation_tpu_torch.utils.checkpoint import (
            append_durable,
            publish_atomic,
        )

        new_records: list = run.span_records()
        for extra in extra_runs:
            new_records.extend(extra.span_records())
        reg = registry if registry is not None else get_registry()
        if self.rotation is not None:
            # Continuous mode: O(batch) appends into the live segment —
            # the loader's (run_id, span_id) newest-wins dedupe supplies
            # the open->closed span replacement the monolithic merge
            # used to do, and rotation bounds what any one file holds.
            if new_records:
                append_durable(
                    self.live_segment() / SPANS_NAME,
                    "".join(
                        json.dumps(s, sort_keys=True) + "\n"
                        for s in new_records
                    ).encode(),
                )
        else:
            spans_path = self.directory / SPANS_NAME
            merged: dict[tuple, dict] = {}
            for rec in _read_jsonl(spans_path) + new_records:
                merged[(rec.get("run_id"), rec.get("span_id"))] = rec
            payload = "".join(
                json.dumps(s, sort_keys=True) + "\n" for s in merged.values()
            )
            publish_atomic(spans_path, payload.encode())
        self.snapshot_metrics(reg, run_id=run.run_id)

        if report is not None:
            publish_atomic(
                self.directory / REPORT_NAME,
                json.dumps(
                    {
                        "run_id": run.run_id,
                        "report": dataclasses.asdict(report),
                    },
                    sort_keys=True,
                ).encode(),
            )
        try:
            self.record_slo(slo_engine, run_id=run.run_id)
        except Exception:
            logger.warning(
                "SLO snapshot publish failed for %s", self.directory,
                exc_info=True,
            )

    def snapshot_metrics(self, registry=None, **meta) -> None:
        """One metrics-registry snapshot line into the bundle, routed
        by mode: under rotation an O(1) durable append into the live
        segment (which may seal it), monolithic the atomic whole-file
        publish. The dispatch timing sketches
        (:func:`..slo.dispatch_snapshot`) ride along as plain meta
        (additive — old readers ignore unknown keys); perfattrib joins
        them against the bundle's cost records."""
        reg = registry if registry is not None else get_registry()
        try:
            from yuma_simulation_tpu_torch.telemetry.slo import dispatch_snapshot

            sketches = dispatch_snapshot()
            if sketches:
                meta.setdefault("dispatch_sketches", sketches)
        except Exception:
            logger.warning("dispatch sketch capture failed", exc_info=True)
        if self.rotation is not None:
            reg.append_snapshot(self.live_segment() / METRICS_NAME, **meta)
            self._maybe_rotate()
        else:
            reg.publish_snapshot(self.directory / METRICS_NAME, **meta)

    def append_spans(self, runs) -> None:
        """Append completed runs' span records to ``spans.jsonl``
        WITHOUT the whole-file merge :meth:`record` does — O(batch),
        for a long-lived server's periodic ingress flushes (a full
        merge republish there is O(total-spans) on a request handler
        thread and quadratic over the server's lifetime). Callers must
        serialize against concurrent publishes to the same directory
        (the serving tier's publish lock) and flush each run at most
        once: nothing here dedupes — the next full :meth:`record`
        (close) merges by identity and republishes atomically, which
        also heals a torn tail from a crash mid-append (readers are
        torn-tail tolerant). Under rotation the append lands in the
        LIVE SEGMENT only — flush cost stays O(batch) however many
        sealed segments the directory has accumulated — and may seal
        it."""
        records: list = []
        for run in runs:
            records.extend(run.span_records())
        if not records:
            return
        payload = "".join(
            json.dumps(s, sort_keys=True) + "\n" for s in records
        )
        from yuma_simulation_tpu_torch.utils.checkpoint import append_durable

        if self.rotation is not None:
            append_durable(self.live_segment() / SPANS_NAME, payload.encode())
            self._maybe_rotate()
        else:
            append_durable(self.directory / SPANS_NAME, payload.encode())

    def append_numerics(
        self, records, *, run_id: Optional[str] = None
    ) -> None:
        """Append numerics records to ``numerics.jsonl`` WITHOUT the
        whole-file merge :meth:`record_numerics` does — the
        :meth:`append_spans` contract applied to the numerics stream
        (O(batch) on a handler thread, caller serializes publishes,
        the next full :meth:`record_numerics` merge dedupes by
        identity and heals a torn tail)."""
        lines = []
        for rec in records:
            line = dict(rec)
            if run_id is not None:
                line["run_id"] = run_id
            lines.append(line)
        if not lines:
            return
        payload = "".join(
            json.dumps(r, sort_keys=True) + "\n" for r in lines
        )
        from yuma_simulation_tpu_torch.utils.checkpoint import append_durable

        if self.rotation is not None:
            append_durable(
                self.live_segment() / NUMERICS_NAME, payload.encode()
            )
            self._maybe_rotate()
        else:
            append_durable(self.directory / NUMERICS_NAME, payload.encode())

    def record_slo(self, engine=None, *, run_id: Optional[str] = None) -> None:
        """Publish the SLO engine's state (specs, per-SLO burn state,
        sketches, alert history) as ``slo.json`` — what
        ``tools/sloreport.py`` renders and gates. No engine / no specs
        -> no file (a bundle without SLOs stays additive for old
        readers)."""
        from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

        if engine is None:
            from yuma_simulation_tpu_torch.telemetry.slo import peek_slo_engine

            engine = peek_slo_engine()
        if engine is None or not engine.specs:
            return
        snap = engine.snapshot()
        if run_id is not None:
            snap["run_id"] = run_id
        publish_atomic(
            self.directory / SLO_NAME,
            json.dumps(snap, sort_keys=True).encode(),
        )

    def record_numerics(
        self, records, *, run_id: Optional[str] = None
    ) -> None:
        """Append per-epoch numerics records (the serialized sketches
        of :func:`..numerics.sketch_records`) to ``numerics.jsonl``,
        each stamped with `run_id`. Merged by the engine-free
        :func:`..numerics.numerics_identity`, newest wins — so the
        stream SURVIVES a failed/resumed sweep exactly like
        ``costs.jsonl``: a resumed run's bundle keeps the prior run's
        records for units it never re-executed, and a re-executed
        unit's capture replaces its prior line instead of duplicating
        it — even when the retry landed on a DIFFERENT rung (a stale
        other-engine primary left behind would mispair against later
        canaries)."""
        from yuma_simulation_tpu_torch.telemetry.numerics import (
            numerics_identity,
        )
        from yuma_simulation_tpu_torch.utils.checkpoint import (
            append_durable,
            publish_atomic,
        )

        lines = []
        for rec in records:
            line = dict(rec)
            if run_id is not None:
                line["run_id"] = run_id
            lines.append(line)
        if self.rotation is not None:
            # Continuous mode: O(batch) — the loader's identity dedupe
            # (newest wins) replaces the monolithic merge below.
            if lines:
                append_durable(
                    self.live_segment() / NUMERICS_NAME,
                    "".join(
                        json.dumps(r, sort_keys=True) + "\n" for r in lines
                    ).encode(),
                )
                self._maybe_rotate()
            return
        if not lines and not (self.directory / NUMERICS_NAME).exists():
            return
        path = self.directory / NUMERICS_NAME
        merged: dict[tuple, dict] = {}
        for rec in _read_jsonl(path) + lines:
            merged[numerics_identity(rec)] = rec
        publish_atomic(
            path,
            "".join(
                json.dumps(r, sort_keys=True) + "\n" for r in merged.values()
            ).encode(),
        )

    def record_costs(self, records, *, run_id: Optional[str] = None) -> None:
        """Append cost records (:class:`..cost.CostRecord` instances or their
        ``to_json`` dicts) to ``costs.jsonl``, each stamped with `run_id`.
        Merged by ``(run_id, engine, V, M, epochs)``, newest wins: a resumed
        run's re-capture replaces its earlier line; distinct shapes and runs
        accumulate."""
        from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

        lines = []
        for rec in records.values() if isinstance(records, dict) else records:
            line = rec.to_json() if hasattr(rec, "to_json") else dict(rec)
            if run_id is not None:
                line["run_id"] = run_id
            lines.append(line)
        path = self.directory / COSTS_NAME
        merged: dict[tuple, dict] = {}
        for rec in _read_jsonl(path) + lines:
            key = tuple(rec.get(k) for k in ("run_id", "engine", "V", "M", "epochs"))
            merged[key] = rec
        publish_atomic(
            path,
            "".join(json.dumps(r, sort_keys=True) + "\n" for r in merged.values()).encode(),
        )


@dataclasses.dataclass
class Bundle:
    """A loaded flight-recorder bundle (see the module docstring)."""

    directory: pathlib.Path
    spans: list
    metrics: list
    ledger: list
    report: Optional[dict] = None
    costs: list = dataclasses.field(default_factory=list)
    slo: Optional[dict] = None
    numerics: list = dataclasses.field(default_factory=list)
    #: sealed-segment ``seal.json`` records, index order (continuous
    #: mode; empty for monolithic bundles).
    segments: list = dataclasses.field(default_factory=list)
    #: registered profiler captures (``profiles.jsonl``).
    profiles: list = dataclasses.field(default_factory=list)
    #: raw incident state records (``incidents.jsonl``), append order —
    #: every transition re-appends the incident's full state; dedupe to
    #: current state via :func:`..incident.latest_incidents`.
    incidents: list = dataclasses.field(default_factory=list)
    #: the retention tombstone (``compacted.json``) when compaction has
    #: reclaimed sealed segments, else None.
    compacted: Optional[dict] = None

    def run_ids(self) -> list[str]:
        """Distinct run ids, first-seen order (spans then ledger)."""
        seen: dict[str, None] = {}
        for rec in list(self.spans) + list(self.ledger):
            rid = rec.get("run_id")
            if rid:
                seen.setdefault(rid, None)
        return list(seen)

    def latest_run_id(self) -> Optional[str]:
        ids = self.run_ids()
        return ids[-1] if ids else None


def load_bundle(directory: Union[str, pathlib.Path]) -> Bundle:
    """Load a bundle, monolithic or segmented, as ONE logical Bundle.

    Root sinks load exactly as they always did; when a ``segments/``
    directory exists, every segment's streams are unioned in (segment
    index order, so chronology holds) and deduped — spans by
    ``(run_id, span_id)`` and numerics by identity, newest wins,
    reproducing the open->closed replacement the monolithic merge
    republish performed at write time. A bundle without ``segments/``
    takes none of these paths: monolithic bundles load bit-for-bit as
    before."""
    directory = pathlib.Path(directory)

    def _json_file(name: str) -> Optional[dict]:
        path = directory / name
        if not path.exists():
            return None
        try:
            return json.loads(path.read_text())
        except json.JSONDecodeError:
            logger.warning("undecodable %s in %s", name, directory)
            return None

    spans = _read_jsonl(directory / SPANS_NAME)
    metrics = _read_jsonl(directory / METRICS_NAME)
    numerics = _read_jsonl(directory / NUMERICS_NAME)
    segments: list = []
    seg_root = directory / SEGMENTS_DIR
    if seg_root.is_dir():
        seg_dirs = []
        for p in seg_root.iterdir():
            tail = p.name[len(SEGMENT_PREFIX):]
            if p.is_dir() and p.name.startswith(SEGMENT_PREFIX) and tail.isdigit():
                seg_dirs.append(p)
        seg_dirs.sort(key=lambda p: int(p.name[len(SEGMENT_PREFIX):]))
        for seg in seg_dirs:
            spans.extend(_read_jsonl(seg / SPANS_NAME))
            metrics.extend(_read_jsonl(seg / METRICS_NAME))
            numerics.extend(_read_jsonl(seg / NUMERICS_NAME))
            seal_path = seg / SEAL_NAME
            if seal_path.exists():
                try:
                    segments.append(json.loads(seal_path.read_text()))
                except (OSError, json.JSONDecodeError):
                    logger.warning("undecodable %s", seal_path)
        merged_spans: dict[tuple, dict] = {}
        for rec in spans:
            merged_spans[(rec.get("run_id"), rec.get("span_id"))] = rec
        spans = list(merged_spans.values())
        from yuma_simulation_tpu_torch.telemetry.numerics import (
            numerics_identity,
        )

        merged_num: dict[tuple, dict] = {}
        for rec in numerics:
            merged_num[numerics_identity(rec)] = rec
        numerics = list(merged_num.values())

    return Bundle(
        directory=directory,
        spans=spans,
        metrics=metrics,
        ledger=_read_jsonl(directory / LEDGER_NAME),
        report=_json_file(REPORT_NAME),
        costs=_read_jsonl(directory / COSTS_NAME),
        slo=_json_file(SLO_NAME),
        numerics=numerics,
        segments=segments,
        profiles=_read_jsonl(directory / PROFILES_NAME),
        incidents=_read_jsonl(directory / INCIDENTS_NAME),
        compacted=_json_file(COMPACTED_NAME),
    )


def ledger_counts(ledger: list, run_id: str) -> dict:
    """The ledger-derived twin of the :class:`SweepHealthReport` action
    counts for one run. Quarantine provenance follows the supervisor's
    resume rule: the RETURNED output carries each unit's LAST `unit_ok`
    record across the whole ledger, resumed units included."""
    this_run = [r for r in ledger if r.get("run_id") == run_id]
    oks = [r for r in this_run if r.get("event") == "unit_ok"]
    last_ok: dict = {}
    for r in ledger:
        if r.get("event") == "unit_ok" and "unit" in r:
            last_ok[r["unit"]] = r
    return {
        "stalls_killed": sum(
            1 for r in this_run if r.get("event") == "unit_stalled"
        ),
        # DISTINCT units, matching SweepHealthReport.units_requeued: a
        # unit torn twice emits one unit_requeued record per re-entry
        # but counts once in the report.
        "units_requeued": len(
            {
                r.get("unit")
                for r in this_run
                if r.get("event") == "unit_requeued"
            }
        ),
        "engine_demotions": sum(int(r.get("demotions", 0)) for r in oks),
        "mesh_shrinks": sum(int(r.get("mesh_shrinks", 0)) for r in oks),
        "lanes_quarantined": sum(
            len(r.get("quarantined", ())) for r in last_ok.values()
        ),
        "canaries_run": sum(int(r.get("canaries", 0)) for r in oks),
        "drift_events": sum(int(r.get("drifts", 0)) for r in oks),
    }


def check_bundle(bundle: Bundle) -> list[str]:
    """Consistency problems in a bundle (empty list = sound):

    - every ledger record must carry ``run_id``/``span_id`` resolving to
      a recorded span of that run (the obsreport ``--check`` gate);
    - every span's ``parent_id`` must resolve within its run — EXCEPT
      spans flagged ``remote_parent`` (a continued cross-process trace,
      :mod:`..propagation`): their parent lives in a sibling process's
      bundle and is checked by :func:`check_stitched` instead;
    - when ``report.json`` is present, its action counts must match the
      ledger-derived counts exactly (:data:`CROSS_CHECKED_COUNTS`);
    - every ``costs.jsonl`` record must name its engine, and a null
      analysis field must carry a ``reason`` (the explicit-null
      contract of :class:`..cost.CostRecord`);
    - every ``numerics.jsonl`` record must name its stream/engine/role
      and carry a per-lane fingerprint whose epoch length matches its
      declared ``epochs`` (the driftreport comparison basis — a record
      that cannot be compared is rot, not data).
    """
    from yuma_simulation_tpu_torch.telemetry.numerics import (
        check_numerics_records,
    )

    problems: list[str] = list(check_numerics_records(bundle.numerics))
    for i, rec in enumerate(bundle.costs):
        if not rec.get("engine"):
            problems.append(f"costs[{i}] names no engine")
            continue
        for field in ("flops", "bytes_accessed", "peak_bytes"):
            if field in rec and rec[field] is None and not rec.get("reason"):
                problems.append(
                    f"costs[{i}] engine={rec['engine']} has null {field} "
                    "with no reason"
                )
    # Retention compaction (continuous mode) deletes whole sealed
    # segments; the tombstone names exactly the runs whose history was
    # traded for bounded disk, and ONLY those runs are exempt from the
    # resolution gates below — everything else is still held to them.
    compacted_runs: set = set()
    if bundle.compacted is not None:
        compacted_runs = {str(r) for r in bundle.compacted.get("run_ids", ())}
    spans_by_run: dict[str, set] = {}
    for s in bundle.spans:
        spans_by_run.setdefault(s.get("run_id", ""), set()).add(
            s.get("span_id")
        )
    for s in bundle.spans:
        parent = s.get("parent_id", "")
        if s.get("remote_parent"):
            continue  # resolved across bundles by check_stitched
        if s.get("run_id") in compacted_runs:
            continue  # parent may have been compacted away
        if parent and parent not in spans_by_run.get(s.get("run_id", ""), ()):
            problems.append(
                f"span {s.get('span_id')} (run {s.get('run_id')}) has "
                f"unresolvable parent {parent!r}"
            )
    for i, rec in enumerate(bundle.ledger):
        event = rec.get("event", "?")
        rid, sid = rec.get("run_id"), rec.get("span_id")
        if not rid or not sid:
            problems.append(
                f"ledger[{i}] event={event} lacks run/span identity "
                f"(run_id={rid!r} span_id={sid!r})"
            )
            continue
        if rid in compacted_runs:
            continue  # its span may have been compacted away
        if sid not in spans_by_run.get(rid, ()):
            problems.append(
                f"ledger[{i}] event={event} span {sid} does not resolve "
                f"in run {rid}"
            )
    if bundle.report is not None:
        rid = bundle.report.get("run_id")
        fields = bundle.report.get("report", {})
        if rid is None:
            problems.append("report.json carries no run_id")
        else:
            derived = ledger_counts(bundle.ledger, rid)
            for key in CROSS_CHECKED_COUNTS:
                if key in fields and int(fields[key]) != int(derived[key]):
                    problems.append(
                        f"report.{key}={fields[key]} but the ledger "
                        f"derives {derived[key]} for run {rid}"
                    )
    return problems


def merge_bundles(bundles, directory=None) -> Bundle:
    """The UNION of several sibling bundles (one per process of a
    distributed run) as one logical bundle: spans/ledger/metrics/costs
    concatenated, deduped by identity, time-ordered — what the stitched
    cross-process timeline renders. `report`/`slo` keep the first
    non-None (the driver's, by caller convention)."""
    spans: dict[tuple, dict] = {}
    ledger: list = []
    metrics: list = []
    costs: list = []
    numerics: list = []
    segments: list = []
    profiles: list = []
    incidents: list = []
    report = None
    slo = None
    compacted = None
    for b in bundles:
        for s in b.spans:
            spans.setdefault((s.get("run_id"), s.get("span_id")), s)
        ledger.extend(b.ledger)
        metrics.extend(b.metrics)
        costs.extend(b.costs)
        numerics.extend(b.numerics)
        segments.extend(b.segments)
        profiles.extend(b.profiles)
        incidents.extend(b.incidents)
        if report is None:
            report = b.report
        if slo is None:
            slo = b.slo
        if b.compacted is not None:
            if compacted is None:
                compacted = dict(b.compacted)
            else:
                # Union of sibling tombstones: counts add, run ids merge
                # — check_bundle's exemption must cover every sibling's
                # reclaimed history.
                compacted = {
                    "event": "segments_compacted",
                    "t": max(
                        float(compacted.get("t") or 0.0),
                        float(b.compacted.get("t") or 0.0),
                    ),
                    "segments": int(compacted.get("segments", 0))
                    + int(b.compacted.get("segments", 0)),
                    "bytes": int(compacted.get("bytes", 0))
                    + int(b.compacted.get("bytes", 0)),
                    "run_ids": sorted(
                        set(compacted.get("run_ids", ()))
                        | set(b.compacted.get("run_ids", ()))
                    ),
                }
    ledger.sort(key=lambda r: float(r.get("t") or 0.0))
    return Bundle(
        directory=pathlib.Path(directory) if directory else pathlib.Path("."),
        spans=sorted(
            spans.values(), key=lambda s: float(s.get("t_start") or 0.0)
        ),
        metrics=metrics,
        ledger=ledger,
        report=report,
        costs=costs,
        slo=slo,
        numerics=numerics,
        segments=segments,
        profiles=profiles,
        incidents=incidents,
        compacted=compacted,
    )


def check_stitched(bundles) -> list[str]:
    """The cross-process half of the orphan-span gate: over the UNION of
    sibling bundles, every span flagged ``remote_parent`` must resolve
    to a recorded span of the same run in SOME bundle, and every parent
    chain must terminate at a true root (empty ``parent_id``) without a
    cycle. A span whose remote parent no sibling recorded is an orphan —
    a tampered, truncated, or mis-propagated trace — and fails the
    check. Empty list = one sound stitched trace."""
    bundles = list(bundles)
    by_run: dict[str, dict[str, dict]] = {}
    for b in bundles:
        for s in b.spans:
            rid, sid = s.get("run_id", ""), s.get("span_id")
            if sid:
                by_run.setdefault(rid, {})[sid] = s
    problems: list[str] = []
    for rid, spans in sorted(by_run.items()):
        for sid, s in sorted(spans.items()):
            parent = s.get("parent_id", "")
            if parent and parent not in spans:
                problems.append(
                    f"span {sid} (run {rid}) is an orphan: parent "
                    f"{parent!r} resolves in no sibling bundle"
                )
        # Chain termination: walk each span to a root, bounded by the
        # span count so a cycle cannot hang the gate.
        for sid in sorted(spans):
            cur, hops = sid, 0
            while cur and hops <= len(spans):
                parent = spans[cur].get("parent_id", "")
                if not parent or parent not in spans:
                    break
                cur = parent
                hops += 1
            if hops > len(spans):
                problems.append(
                    f"span {sid} (run {rid}) sits on a parent cycle"
                )
    return problems


def build_timeline(bundle: Bundle, run_id: str) -> dict:
    """One run's recovery timeline: the span tree (children in start
    order) with each span's ledger records attached.

    Returns ``{"run_id", "spans": {span_id: span}, "roots": [span_id],
    "children": {span_id: [span_id]}, "records": {span_id: [ledger
    record]}}`` — everything obsreport needs to render, nothing
    presentation-specific."""
    spans = {
        s["span_id"]: s
        for s in bundle.spans
        if s.get("run_id") == run_id and s.get("span_id")
    }
    children: dict[str, list] = {sid: [] for sid in spans}
    roots: list[str] = []
    for sid, s in spans.items():
        parent = s.get("parent_id", "")
        if parent and parent in spans:
            children[parent].append(sid)
        else:
            roots.append(sid)

    def start(sid: str) -> float:
        return float(spans[sid].get("t_start") or 0.0)

    for sid in children:
        children[sid].sort(key=start)
    roots.sort(key=start)
    records: dict[str, list] = {}
    for rec in bundle.ledger:
        if rec.get("run_id") != run_id:
            continue
        records.setdefault(rec.get("span_id", ""), []).append(rec)
    for recs in records.values():
        recs.sort(key=lambda r: float(r.get("t") or 0.0))
    return {
        "run_id": run_id,
        "spans": spans,
        "roots": roots,
        "children": children,
        "records": records,
    }

"""The ops and incident plane of the port (`telemetry/{ops,timeseries,
anomaly,incident}.py`, `log_event`'s events-ring hook,
`SweepSupervisor(profile_every=)`) on the CPU, against the JAX package's.

Contracts: the events ring holds every structured record `log_event`
emits (a record below its logger's level is not emitted), oldest first
and bounded; `ProfileSession` is single-flight on the
process's one `torch.profiler` (a second window, or one under
`profile_trace`, raises `ProfileBusyError`, and `profile_trace` raises
under an open window), stops itself at its deadline, writes its trace and
registers it in `profiles.jsonl`; a memory snapshot without CUDA raises
and writes nothing; `OpsPlane` reports its sections; the time-series
store, the four detector families and the incident correlation give
outputs EQUAL to JAX's on the same record streams; a supervised sweep
with `profile_every=2` traces units 0 and 2 and registers both.
"""

import dataclasses
import json
import logging
import pathlib
import random
import time

import numpy as np
import pytest

from yuma_simulation_tpu.resilience.supervisor import FailureLedger as JLedger
from yuma_simulation_tpu.telemetry import anomaly as janomaly
from yuma_simulation_tpu.telemetry import incident as jincident
from yuma_simulation_tpu.telemetry import timeseries as jts
from yuma_simulation_tpu.telemetry.flight import FlightRecorder as JRecorder
from yuma_simulation_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from yuma_simulation_tpu_torch.resilience import Deadline, SweepSupervisor
from yuma_simulation_tpu_torch.resilience.supervisor import FailureLedger
from yuma_simulation_tpu_torch.scenarios import get_cases
from yuma_simulation_tpu_torch.telemetry import anomaly, incident, ops
from yuma_simulation_tpu_torch.telemetry import timeseries as ts
from yuma_simulation_tpu_torch.telemetry.flight import FlightRecorder
from yuma_simulation_tpu_torch.telemetry.metrics import MetricsRegistry
from yuma_simulation_tpu_torch.telemetry.runctx import RunContext, span
from yuma_simulation_tpu_torch.utils.logging import log_event
from yuma_simulation_tpu_torch.utils.profiling import profile_trace

logger = logging.getLogger("test_torch_ops_plane")
#: Probe records: test names, kept out of the wire-schema lock (the lock
#: lists the records the packages emit, not the tests' probes).
_PROBES = {"below": ("probe_below_level", dict(level=logging.DEBUG, unit=0)),
           "drill": ("probe_drill", dict(unit=3, note="a b")),
           "unit": ("probe_unit", dict(unit=4))}


def _probe(key, **extra):
    name, fields = _PROBES[key]
    log_event(logger, name, **{**fields, **extra})
    return name


def test_events_ring_and_log_event_hook():
    ops.clear_events()
    _probe("below")  # below the logger's level: dropped, never formatted
    drill = _probe("drill")
    with RunContext("ring-run"), span("s"):
        unit = _probe("unit")
    events = ops.recent_events()
    assert [e["event"] for e in events] == [drill, unit]
    assert events[0]["unit"] == 3 and events[0]["note"] == "a b"
    assert events[1]["run_id"] == "ring-run"
    for i in range(ops.EVENTS_RING_SIZE + 5):
        ops.note_event("tick", {"i": i, "obj": object})
    assert len(ops.recent_events(0)) == ops.EVENTS_RING_SIZE
    assert ops.recent_events(2)[-1]["i"] == ops.EVENTS_RING_SIZE + 4
    assert isinstance(ops.recent_events(1)[0]["obj"], str)
    ops.clear_events()
    assert ops.recent_events() == []


def _wait_published(sess, n, timeout=20.0):
    end = time.time() + timeout
    while sess.status()["profiles_published"] < n and time.time() < end:
        time.sleep(0.05)
    return sess.status()["profiles_published"]


def test_profile_session_single_flight_and_deadline(tmp_path):
    sess = ops.ProfileSession(tmp_path)
    started = sess.start(0.3, mode="trace")
    assert started["mode"] == "trace" and sess.status()["active"]
    with pytest.raises(ops.ProfileBusyError) as err:
        sess.start(0.3)
    assert err.value.status["serial"] == started["serial"]
    with pytest.raises(ops.ProfileBusyError):  # another session: one profiler
        ops.ProfileSession(tmp_path).start(1.0)
    assert _wait_published(sess, 1) == 1, "the auto-stop deadline never fired"
    assert not sess.status()["active"]
    records = [json.loads(x) for x in (tmp_path / "profiles.jsonl").read_text().splitlines()]
    assert records[-1]["event"] == "profile_published"
    assert records[-1]["artifact"] == started["artifact"]
    assert (pathlib.Path(started["artifact"]) / ops.TRACE_FILE).exists()
    # A new window opens once the latch is free; stop is idempotent.
    sess.start(5.0)
    assert sess.stop()["mode"] == "trace"
    assert sess.stop() is None
    assert _wait_published(sess, 2) == 2


def test_profile_session_busy_against_profile_trace(tmp_path):
    sess = ops.ProfileSession(tmp_path)
    with profile_trace(str(tmp_path / "region")):
        with pytest.raises(ops.ProfileBusyError) as err:
            sess.start(1.0)
        assert err.value.status["mode"] == "profile_trace"
    assert (tmp_path / "region" / "trace.json").exists()
    sess.start(5.0)
    try:
        with pytest.raises(ops.ProfileBusyError):
            with profile_trace(str(tmp_path / "second")):
                pass
    finally:
        sess.stop()
    assert not (tmp_path / "second" / "trace.json").exists()
    with ops.hold_profiler({"mode": "caller"}):
        with pytest.raises(ops.ProfileBusyError):
            sess.start(1.0)


def test_profile_session_rejects_bad_requests(tmp_path):
    sess = ops.ProfileSession(tmp_path)
    with pytest.raises(ValueError):
        sess.start(0.0)
    with pytest.raises(ValueError):
        sess.start(1.0, mode="flamegraph")
    with pytest.raises(ValueError):
        ops.ProfileSession(None).start(1.0)
    # No CUDA here: a memory snapshot raises and writes nothing.
    with pytest.raises(ValueError, match="no CUDA device"):
        sess.start(1.0, mode="memory")
    assert not (tmp_path / "profiles.jsonl").exists()
    assert not list(tmp_path.rglob("memory_*"))


def test_ops_plane_sections(tmp_path):
    plane = ops.OpsPlane(tmp_path, registry=MetricsRegistry())
    plane.registry.counter("units_total").inc(3)
    unit = _probe("unit")
    with RunContext("ops-run") as run:
        plane.run = run
        with span("live-work"):
            out = plane.debug_vars()
            spans_out = plane.debug_spans()
    assert out["metrics"]["counters"]["units_total"] == 3
    assert out["events"][-1]["event"] == unit
    assert out["profile"] == {"active": False, "profiles_published": 0}
    assert out["segments"] == {"rotation": False}
    assert any(s["name"] == "live-work" for s in spans_out["spans"].values())
    assert plane.debug_incidents() == {"incidents": [], "open": 0}
    FlightRecorder(tmp_path).record_incident(
        {"incident": "subnet-stall:netuid=3", "state": "open", "opened_t": 1.0})
    assert plane.debug_incidents()["open"] == 1
    with pytest.raises(ValueError, match="no run_id"):
        ops.OpsPlane(tmp_path).debug_spans()
    plane.debug_profile(5.0)
    assert plane.debug_vars()["profile"]["active"]
    plane.close()
    assert not plane.debug_vars()["profile"]["active"]


# ---------------------------------------------- the incident plane vs JAX


def _snapshots(n, seed):
    rng = random.Random(seed)
    recs = []
    for i in range(n):
        spike = 900.0 if i in (30, 31, 55) else 0.0
        recs.append({
            "t": float(i) + rng.random() * 0.1,
            "seq": i + 1,
            "counters": {"windows_swept_total": float(i // 3 if i < 40 else 13),
                         "cycles_total": float(i)},
            "gauges": {"replay_staleness_seconds": 5.0 + rng.random() + spike,
                       "queue_depth": 10.0 if 45 <= i < 52 else rng.random() * 5.0},
        })
    return recs


def _detectors(mod):
    return [
        mod.MadDetector("gauge:replay_staleness_seconds", window=16, min_samples=8,
                        threshold=6.0, mad_floor=0.5),
        mod.RateOfChangeDetector("gauge:replay_staleness_seconds", max_per_second=100.0),
        mod.CounterStallDetector("counter:windows_swept_total", "counter:cycles_total",
                                 horizon_seconds=10.0),
        mod.SaturationDetector("gauge:queue_depth", capacity=10.0, high_fraction=0.9,
                               min_samples=3),
    ]


def _plain(x):
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    return x


def test_timeseries_and_detectors_equal_jax():
    recs = _snapshots(70, 1)
    shuffled = recs[:]
    random.Random(2).shuffle(shuffled)
    got_store = ts.TimeSeriesStore()
    want_store = jts.TimeSeriesStore()
    for rec in shuffled + recs[:10]:  # out of order, with duplicates
        got_store.ingest_snapshot(dict(rec), source="a")
        want_store.ingest_snapshot(dict(rec), source="a")
    assert got_store.keys() == want_store.keys()
    for key in want_store.keys():
        assert got_store.series(key) == want_store.series(key), key
    got = anomaly.AnomalyEngine(_detectors(anomaly)).scan(got_store)
    want = janomaly.AnomalyEngine(_detectors(janomaly)).scan(want_store)
    assert [_plain(a) for a in got] == [_plain(a) for a in want]
    assert {a.kind for a in got} == {"mad", "rate_of_change", "counter_stall", "saturation"}
    a = ts.store_from_metrics(recs, source="b")
    b = jts.store_from_metrics(recs, source="b")
    assert [a.series(k) for k in a.keys()] == [b.series(k) for k in b.keys()]


def _ledger_records():
    return [
        {"event": "subnet_quarantined", "t": 10.0, "netuid": 7, "block": 1100,
         "reason": "digest mismatch", "run_id": "r1", "span_id": "s1"},
        {"event": "subnet_stalled", "t": 20.0, "netuid": 3, "stalled_seconds": 40.0,
         "run_id": "r1", "span_id": "s2"},
        {"event": "anomaly_detected", "t": 24.0, "kind": "mad",
         "series": "gauge:replay_staleness_seconds", "run_id": "r1", "span_id": "s2"},
        {"event": "slo_alert", "t": 26.0, "slo": "replay_fresh", "run_id": "r1"},
        {"event": "engine_stall", "t": 27.0, "unit": 2, "run_id": "r1"},
        {"event": "lane_quarantined", "t": 28.0, "unit": 2, "case": 1, "run_id": "r1"},
        {"event": "controller_restarted", "t": 40.0, "run": "r0", "run_id": "r2",
         "span_id": "s9"},
        {"event": "watermark_advanced", "t": 50.0, "netuid": 5, "block": 1200,
         "run_id": "r2"},
        {"event": "subnet_stalled", "t": 70.0, "netuid": 3, "stalled_seconds": 90.0,
         "run_id": "r2"},
        {"event": "unit_ok", "t": 71.0, "unit": 4},
        {"event": "subnet_ingested", "t": 90.0, "netuid": 3, "new_blocks": 2,
         "head_block": 1300},
    ]


def test_correlation_equals_jax():
    recs = _ledger_records()
    for window in (5.0, incident.DEFAULT_CAUSAL_WINDOW):
        got = [i.to_json() for i in incident.correlate(recs, causal_window=window)]
        want = [i.to_json() for i in jincident.correlate(recs, causal_window=window)]
        assert got == want
    assert got and incident.correlate(recs[2:4]) == []
    records = [{"incident": "a", "state": "open", "opened_t": 2.0},
               {"incident": "b", "state": "open", "opened_t": 1.0},
               {"incident": "a", "state": "resolved", "opened_t": 2.0}]
    assert incident.latest_incidents(records) == jincident.latest_incidents(records)


def _drive_engine(led_cls, rec_cls, reg_cls, eng_mod, inc_mod, directory):
    ledger = led_cls(directory / "ledger.jsonl")
    reg = reg_cls()
    gauge = reg.gauge("replay_staleness_seconds")
    engine = inc_mod.IncidentEngine(ledger, rec_cls(directory), registry=reg,
                                    anomaly_engine=eng_mod.default_replay_engine())
    for i in range(20):
        gauge.set(3.0 + (i % 2) * 0.2)
        engine.feed_snapshot(now=float(i))
    gauge.set(5000.0)
    fired = engine.feed_snapshot(now=30.0)
    ledger.append("subnet_stalled", netuid=3, head_block=1100, stalled_seconds=40.0)
    engine.tick(now=100.0)
    ledger.append("subnet_ingested", netuid=3, new_blocks=2, head_block=1200)
    engine.tick(now=102.0)
    drop = ("t", "opened_t", "resolved_t", "last_t", "seq")

    def strip(x):  # the wall-clock stamps of the two runs differ
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k not in drop}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x

    return (fired, reg.snapshot()["gauges"]["incidents_open"],
            reg.snapshot()["counters"]["anomalies_total"],
            [strip(r) for r in inc_mod.load_incidents(directory)],
            [strip(r)["event"] for r in ledger.entries()])


def test_incident_engine_equals_jax(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _drive_engine(FailureLedger, FlightRecorder, MetricsRegistry, anomaly, incident,
                        tmp_path / "port")
    want = _drive_engine(JLedger, JRecorder, JRegistry, janomaly, jincident, tmp_path / "jax")
    assert got == want
    assert got[0] == 1 and got[3][-1]["state"] == "resolved"


def test_supervisor_profile_every(tmp_path):
    cases = get_cases()[:4]
    sup = SweepSupervisor(directory=tmp_path, unit_size=1, profile_every=2,
                          deadline=Deadline(120.0))
    out = sup.run_batch(cases, "Yuma 1 (paper)", device="cpu")
    plain = SweepSupervisor(unit_size=1, deadline=Deadline(120.0)).run_batch(
        cases, "Yuma 1 (paper)", device="cpu")
    np.testing.assert_array_equal(out["dividends"], plain["dividends"])
    records = [json.loads(x) for x in (tmp_path / "profiles.jsonl").read_text().splitlines()]
    assert [(r["mode"], r["unit"]) for r in records] == [("unit", 0), ("unit", 2)]
    for r in records:
        assert (pathlib.Path(r["artifact"]) / "trace.json").exists()
    assert not (tmp_path / "profiles" / "unit0001").exists()
    # Under an open ops-plane window a profiled unit refuses to open a
    # second profiler; the sweep's failure is typed, not a crash.
    sess = ops.ProfileSession(tmp_path / "ops")
    sess.start(30.0)
    try:
        with pytest.raises(Exception) as err:
            SweepSupervisor(directory=tmp_path / "busy", unit_size=4, profile_every=1,
                            deadline=Deadline(120.0)).run_batch(cases, "Yuma 1 (paper)",
                                                                device="cpu")
        assert "profile window is already active" in str(err.value) or isinstance(
            err.value, ops.ProfileBusyError)
    finally:
        sess.stop()

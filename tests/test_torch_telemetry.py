"""The port's telemetry core against the JAX package's, on the CPU: spans
(`telemetry/runctx.py`), structured log lines (`utils/logging.py`), the
metrics registry and its sinks (`telemetry/metrics.py`), latency sketches,
SLO burn rates and the dispatch table (`telemetry/slo.py`), trace
propagation (`telemetry/propagation.py`), the name registry, the profiler
and timing utilities, the device sample, and the wiring of all of it into
the entry points (`simulate`, `simulate_batch`, the sharded batch, the
chart suite, the sheet CLI).

Contracts: the same operations give the same records, lines, snapshots,
Prometheus text, quantiles, burn verdicts and wire headers as the JAX
package's (wall-clock times and sequence numbers masked); every name the
port emits is declared with the JAX package's spec; each entry point
leaves JAX's spans, step annotations and plan stamps.
"""

import json
import logging
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from yuma_simulation_tpu.telemetry import metrics as jmetrics
from yuma_simulation_tpu.telemetry import propagation as jprop
from yuma_simulation_tpu.telemetry import registry as jregistry
from yuma_simulation_tpu.telemetry import runctx as jrunctx
from yuma_simulation_tpu.telemetry import slo as jslo
from yuma_simulation_tpu.utils import logging as jlogging
from yuma_simulation_tpu_torch.models.config import YumaConfig
from yuma_simulation_tpu_torch.models.variants import variant_for_version
from yuma_simulation_tpu_torch.scenarios import create_case, get_cases
from yuma_simulation_tpu_torch.simulation.engine import simulate
from yuma_simulation_tpu_torch.simulation.planner import bucket_shape, plan_dispatch
from yuma_simulation_tpu_torch.simulation.sweep import simulate_batch, stack_scenarios
from yuma_simulation_tpu_torch.telemetry import metrics as tmetrics
from yuma_simulation_tpu_torch.telemetry import propagation as tprop
from yuma_simulation_tpu_torch.telemetry import registry as tregistry
from yuma_simulation_tpu_torch.telemetry import runctx as trunctx
from yuma_simulation_tpu_torch.telemetry import slo as tslo
from yuma_simulation_tpu_torch.telemetry.device import (
    record_device_telemetry,
    sample_device_telemetry,
)
from yuma_simulation_tpu_torch.utils import logging as tlogging
from yuma_simulation_tpu_torch.utils.profiling import (
    profile_trace,
    timed,
    trace_range_windows,
    within,
)
from yuma_simulation_tpu_torch.utils.timing import time_best

PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / "yuma_simulation_tpu_torch"


def _mask(records, keys=("t_start", "t_end", "t", "seq")):
    """Records with their wall-clock and sequence fields blanked."""
    if isinstance(records, list):
        return [_mask(r, keys) for r in records]
    if isinstance(records, dict):
        return {k: ("*" if k in keys else _mask(v, keys)) for k, v in records.items()}
    return records


def _span_script(rc, span):
    """The same span tree in either package: nested spans with attrs, an
    error span, an already-closed span, and one span left open."""
    with rc.RunContext("run-0123456789ab") as run:
        with span("sweep", unit=3):
            with span("attempt") as s:
                s.attrs["steps"] = [1, 2]
            with pytest.raises(RuntimeError):
                with span("failing"):
                    raise RuntimeError("boom")
            run.record_span("queue_wait", 1.0, 2.0, parent_id="s0001", lane=2)
            fields = rc.current_fields()
        opened = run._open_span("still_open", None)
        records = run.span_records()
        run._close_span(opened)
    return records, fields


# ---------------------------------------------------------------------------
# spans and log lines


def test_span_records_and_fields_equal_jax():
    """The span tree's records (ids, parents, names, status, attrs, open
    spans) and the stamped identity fields are JAX's."""
    got, got_fields = _span_script(trunctx, trunctx.span)
    want, want_fields = _span_script(jrunctx, jrunctx.span)
    assert _mask(got) == _mask(want)
    assert got_fields == want_fields == {"run_id": "run-0123456789ab", "span_id": "s0001"}
    assert trunctx.current_run() is None and trunctx.current_fields() == {}
    with trunctx.span("no run") as s:
        assert s is None
    assert re.fullmatch(r"run-[0-9a-f]{12}", trunctx.new_run_id())


def test_ensure_run_and_remote_parents_equal_jax():
    """`ensure_run` joins an open run; a continued trace's spans root under
    the remote parent with ``remote_parent: true``, ids under the prefix."""
    for rc, prop in ((trunctx, tprop), (jrunctx, jprop)):
        with rc.ensure_run("run-outer") as outer:
            with rc.ensure_run() as inner:
                assert inner is outer
    recs = []
    for rc, prop in ((trunctx, tprop), (jrunctx, jprop)):
        ctx = prop.TraceContext("run-up", "s0007", (("tenant", "a"),))
        with prop.child_run(ctx, prefix="abc123") as run:
            with rc.span("child"):
                pass
        recs.append(_mask(run.span_records()))
    assert recs[0] == recs[1]
    assert recs[0][0]["span_id"] == "abc123.s0001" and recs[0][0]["remote_parent"] is True
    with pytest.raises(ValueError):
        trunctx.RunContext(span_prefix="a-b")


#: Synthetic records (names and fields no code emits), passed through
#: variables so the repository's static wire-schema extraction, which reads
#: literal `log_event` calls under tests/ too, does not take them for the
#: package's records.
_PLAIN_RECORD = ("probe_plain", dict(unit=3, label="Case 3", empty=""))
_QUOTED_RECORD = ("probe_quoted", dict(level=logging.DEBUG, label='say "hi"',
                                       why="a=b; c\\d", run_id="run-mine", n=1.5))


def _log_lines(logging_mod, rc, caplog, logger_name):
    logger = logging.getLogger(logger_name)
    caplog.clear()
    with caplog.at_level(logging.DEBUG, logger=logger_name):
        for name, fields in (_PLAIN_RECORD,):
            logging_mod.log_event(logger, name, **fields)
        with rc.RunContext("run-feedfacecafe"):
            with rc.span("outer"), rc.span("inner"):
                name, fields = _QUOTED_RECORD
                logging_mod.log_event(logger, name, **fields)
    return [r.getMessage() for r in caplog.records]


def test_log_event_lines_equal_jax_and_parse_alike(caplog):
    """`log_event` writes JAX's lines (quoting, dropped empty fields, the
    run/span stamp, caller fields winning), and each package's
    `parse_event_line` reads the other's lines the same."""
    got = _log_lines(tlogging, trunctx, caplog, "yuma_simulation_tpu_torch.test")
    want = _log_lines(jlogging, jrunctx, caplog, "yuma_simulation_tpu.test")
    assert got == want and len(got) == 2
    assert "span_id=s0002" in got[1] and "parent_id=s0001" in got[1] and "run_id=run-mine" in got[1]
    for line in got + ["12:00:01 INFO x: " + got[1], "no record", 'msg="event=fake" x=1',
                       'event=torn a=1 b="unterminated']:
        assert tlogging.parse_event_line(line) == jlogging.parse_event_line(line)
    parsed = tlogging.parse_event_line(got[1])
    assert parsed["label"] == 'say "hi"' and parsed["why"] == "a=b; c\\d"


def test_log_event_below_level_formats_nothing_and_plans_still_stamp(caplog):
    """A record below the logger's level is dropped before any field is
    formatted; `DispatchPlan.record()` at INFO logs nothing and still
    stamps its plan on the open span."""
    formatted = []

    class Probe:
        def __str__(self):
            formatted.append(1)
            return "probe"

    logger = logging.getLogger("yuma_simulation_tpu_torch.test")
    name, _ = _PLAIN_RECORD
    with caplog.at_level(logging.INFO, logger="yuma_simulation_tpu_torch"):
        tlogging.log_event(logger, name, level=logging.DEBUG, value=Probe())
        assert not formatted and not caplog.records
        tlogging.log_event(logger, name, level=logging.INFO, value=Probe())
        assert formatted == [1] and len(caplog.records) == 1
        caplog.clear()
        plan = plan_dispatch("probe", (4, 3, 5), variant_for_version("Yuma 1 (paper)"),
                             YumaConfig(), torch.float32, device=torch.device("cpu"))
        with trunctx.RunContext("run-feedfacecafe"), trunctx.span("planned") as s:
            plan.record()
        assert s.attrs["plan"] == plan.span_attr()
        assert not caplog.records


# ---------------------------------------------------------------------------
# metrics


def _metrics_script(mod, tmp, logger_name):
    reg = mod.MetricsRegistry()
    reg.counter("engine_retries", help="same-rung retries").inc(2)
    reg.counter("engine_retries").inc()
    reg.gauge("device_peak_bytes", help="peak\nbytes \\ max").set(1 << 40)
    reg.gauge("slo_fast_burn_active").inc(0.5)
    h = reg.histogram("compile_seconds", help="compile", buckets=(0.5, 0.1, float("inf"), 2.0))
    for v in (0.05, 0.1, 0.3, 3.0, 0.5, 10.0):
        h.observe(v)
    reg.histogram("serve_request_seconds")
    rate = mod.record_epoch_rate("bench", epochs=640, seconds=1.6, cv=0.01234, registry=reg,
                                 logger_=logging.getLogger(logger_name))
    published = reg.publish_snapshot(tmp / "metrics.jsonl", run_id="run-x")
    appended = reg.append_snapshot(tmp / "append.jsonl", source="host-a")
    with pytest.raises(TypeError):
        reg.gauge("engine_retries")
    with pytest.raises(ValueError):
        reg.counter("bad-name")
    with pytest.raises(ValueError):
        reg.counter("engine_retries").inc(-1)
    lines = [json.loads(x) for x in (tmp / "metrics.jsonl").read_text().splitlines()]
    return reg.snapshot(), reg.prometheus_text(), rate, published, appended, lines


def test_metrics_registry_equal_jax(tmp_path, caplog):
    """After the same operations: the snapshot, the Prometheus text (HELP
    escaping, cumulative buckets ending in +Inf), the epoch-rate record and
    the JSONL sinks' lines are JAX's (times and sequence numbers masked)."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    with caplog.at_level(logging.INFO):
        got = _metrics_script(tmetrics, tmp_path / "t", "yuma_simulation_tpu_torch.test")
        want = _metrics_script(jmetrics, tmp_path / "j", "yuma_simulation_tpu.test")
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2] == 400.0
    assert _mask(list(got[3:])) == _mask(list(want[3:]))
    rates = [r.getMessage() for r in caplog.records if "event=epoch_rate" in r.getMessage()]
    assert len(rates) == 2 and rates[0] == rates[1]
    assert 'compile_seconds_bucket{le="+Inf"} 6' in got[1]
    # A torn tail is dropped on read, and the next append heals it.
    sink = tmp_path / "t" / "append.jsonl"
    sink.write_bytes(sink.read_bytes() + b'{"torn": ')
    tmetrics.MetricsRegistry().append_snapshot(sink)
    from yuma_simulation_tpu.utils.checkpoint import read_jsonl_tolerant as j_read
    from yuma_simulation_tpu_torch.utils.checkpoint import read_jsonl_tolerant

    assert len(read_jsonl_tolerant(sink)) == 2 and read_jsonl_tolerant(sink) == j_read(sink)


# ---------------------------------------------------------------------------
# SLOs: sketches, burn rates, the dispatch table


def test_latency_sketch_quantiles_and_merges_equal_jax():
    """The same samples (zeros and negatives included): JAX's quantiles,
    serialized form and merges, and a merge of halves equals the whole."""
    rng = np.random.default_rng(7)
    samples = np.concatenate([rng.lognormal(-3, 1.5, 500), [0.0, -1e-3, 7.5, 1e-9]]).tolist()
    sketches = {}
    for name, mod in (("t", tslo), ("j", jslo)):
        whole, a, b = mod.LatencySketch(), mod.LatencySketch(), mod.LatencySketch()
        for i, v in enumerate(samples):
            whole.observe(v)
            (a if i % 3 else b).observe(v)
        a.merge(b)
        sketches[name] = (whole, a)
    qs = [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0]
    for which in (0, 1):
        t, j = sketches["t"][which], sketches["j"][which]
        assert [t.quantile(q) for q in qs] == [j.quantile(q) for q in qs]
        assert t.to_json() == j.to_json()
        assert t.count == j.count and t.sum == j.sum
    whole, merged = (dict(sk.to_json()) for sk in sketches["t"])
    assert math.isclose(whole.pop("sum"), merged.pop("sum"), rel_tol=1e-12) and whole == merged
    back = tslo.LatencySketch.from_json(jslo.LatencySketch(0.02).to_json())
    assert back.quantile(0.5) is None
    with pytest.raises(ValueError):
        sketches["t"][0].merge(tslo.LatencySketch(0.05))


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _slo_script(mod, metrics_mod):
    specs = [
        mod.SLOSpec("latency", objective=0.99, sketch="unit_seconds", threshold_seconds=1.0,
                    fast_window_seconds=10.0, slow_window_seconds=100.0, min_events=3),
        mod.SLOSpec("errors", objective=0.99, event="ok_stream", fast_window_seconds=5.0,
                    slow_window_seconds=50.0, degrade=False),
    ]
    clock = _Clock()
    seen = []
    reg = metrics_mod.MetricsRegistry()
    engine = mod.SLOEngine(specs, clock=clock, registry=reg,
                           on_transition=lambda rec: seen.append(dict(rec)))
    states = []
    for step in range(40):
        clock.now += 1.5
        engine.observe("unit_seconds", 2.0 if 5 <= step < 12 else 0.2)
        engine.event("ok_stream", not (20 <= step < 23))
        states.append((engine.state("latency"), engine.state("errors"), engine.degraded(),
                       engine.fast_burning()))
    clock.now += 500
    states.append(engine.evaluate())
    return (states, _mask(engine.alerts()), _mask(seen), _mask(engine.snapshot()),
            reg.snapshot())


def test_slo_engine_burn_verdicts_equal_jax():
    """Under an injected clock, the same observations walk both engines
    through the same ok / slow_burn / fast_burn states, with the same alert
    records, degradation verdicts, snapshot (alert times masked) and alert
    metrics."""
    got = _slo_script(tslo, tmetrics)
    want = _slo_script(jslo, jmetrics)
    assert got == want
    assert any(s[0] == "fast_burn" for s in got[0][:-1]) and got[0][-1]["latency"]["state"] == "ok"
    assert len(got[1]) >= 2
    with pytest.raises(ValueError):
        tslo.SLOSpec("bad", objective=1.5, event="x")
    assert [s.to_json() for s in tslo.DEFAULT_SLO_SPECS] == [
        s.to_json() for s in jslo.DEFAULT_SLO_SPECS]


def test_dispatch_stats_equal_jax():
    """The dispatch table's snapshot (keys, totals, serialized sketches,
    the overflow key past `max_keys`) is JAX's; the process table's switch
    turns observation off and back."""
    snaps = []
    for mod in (tslo, jslo):
        stats = mod.DispatchStats(max_keys=3)
        for i in range(12):
            stats.observe(engine=f"rung{i % 5}", bucket="b1e64v256m4096", backend="gpu",
                          seconds=0.01 * (i + 1), epochs=64)
        snaps.append(stats.snapshot())
    assert snaps[0] == snaps[1] and "overflow" in snaps[0]
    tslo.get_dispatch_stats().reset()
    prev = tslo.set_dispatch_observation(False)
    tslo.observe_dispatch(engine="eager", bucket="b", backend="cpu", seconds=1.0)
    assert tslo.dispatch_snapshot() == {}
    tslo.set_dispatch_observation(prev)
    tslo.observe_dispatch(engine="eager", bucket="b", backend="cpu", seconds=1.0, epochs=4)
    assert tslo.dispatch_snapshot()["eager|b|cpu"]["epochs_total"] == 4


# ---------------------------------------------------------------------------
# propagation


def test_trace_context_wire_forms_equal_jax():
    """The same ids give JAX's traceparent, baggage, env and manifest
    forms, and both parsers read every header (malformed ones included)
    the same."""
    for run_id, span_id, bag in (("run-abc123def456", "s0003", (("tenant", "t1"),)),
                                 ("run-x", "", ()), ("run-a-b", "p1.s0001", (("k", "v=w"),))):
        t, j = tprop.TraceContext(run_id, span_id, bag), jprop.TraceContext(run_id, span_id, bag)
        assert t.to_traceparent() == j.to_traceparent()
        assert t.to_baggage() == j.to_baggage() and t.to_env() == j.to_env()
        assert t.to_manifest() == j.to_manifest()
        assert t.with_baggage(req="7").to_baggage() == j.with_baggage(req="7").to_baggage()
    headers = ["00-run-abc-s0001-01", "00-run-abc-root-01", "01-run-abc-s1-01", "garbage", "",
               None, "00--s1-01", " 00-run-a-b-c-s0002-01 "]
    for h in headers:
        got, want = tprop.TraceContext.from_traceparent(h, "a=1, b = 2,bad"), \
            jprop.TraceContext.from_traceparent(h, "a=1, b = 2,bad")
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.run_id, got.span_id, got.baggage) == (want.run_id, want.span_id,
                                                              want.baggage)
    env = {"YUMA_TRACEPARENT": "00-run-e-s0009-01", "YUMA_BAGGAGE": "x=1"}
    assert tprop.TraceContext.from_env(env).to_env() == jprop.TraceContext.from_env(env).to_env()
    assert tprop.span_prefix_for("host-3") == jprop.span_prefix_for("host-3")
    assert tprop.current_trace_context() is None
    with trunctx.RunContext("run-live"), trunctx.span("s"):
        ctx = tprop.current_trace_context(tenant="a")
    assert ctx.to_traceparent() == "00-run-live-s0001-01" and ctx.baggage == (("tenant", "a"),)
    with tprop.continue_trace(ctx, prefix="p9") as run:
        assert run.run_id == "run-live" and run.remote_parent == "s0001"


# ---------------------------------------------------------------------------
# the name registry


def _emitted_names():
    """Every event and metric name the port's code emits, read from its
    source: `log_event(logger, "<event>", ...)` calls, the supervisor's
    `ledger.append("<event>", ...)` records, and
    `counter` / `gauge` / `histogram("<name>", ...)` calls."""
    events, metrics = set(), {}
    for path in PORT_ROOT.rglob("*.py"):
        src = path.read_text()
        events |= set(re.findall(r'log_event\(\s*[^,()]+,\s*"(\w+)"', src))
        events |= set(re.findall(r'ledger\.append\(\s*"(\w+)"', src))
        events |= set(re.findall(r'"slo_alert"|"slo_recovered"', src))
        for kind, name in re.findall(r'\.(counter|gauge|histogram)\(\s*"(\w+)"', src):
            metrics[name] = kind
    return {e.strip('"') for e in events}, metrics


def test_registry_declares_what_the_port_emits_with_jax_specs():
    """Every emitted name is declared, with the JAX package's spec (and so
    its kind); nothing is declared that the port does not emit (the
    dispatch table's sketch family apart); the registry's checks pass."""
    events, metrics = _emitted_names()
    assert {"dispatch_planned", "preflight_rejected", "epoch_rate", "slo_alert"} <= events
    assert set(tregistry.EVENTS) == events
    assert set(tregistry.METRICS) == set(metrics) | {"dispatch_seconds"}
    for name, kind in metrics.items():
        assert tregistry.METRICS[name].kind == kind == jregistry.METRICS[name].kind, name
    for name, spec in tregistry.EVENTS.items():
        assert dataclass_tuple(spec) == dataclass_tuple(jregistry.EVENTS[name]), name
    for name, spec in tregistry.METRICS.items():
        assert dataclass_tuple(spec) == dataclass_tuple(jregistry.METRICS[name]), name
    assert tregistry.validate_registry() == []
    assert tregistry.declared_events() == frozenset(events)


def dataclass_tuple(spec):
    import dataclasses

    return dataclasses.astuple(spec)


# ---------------------------------------------------------------------------
# the wiring into the entry points


def test_simulate_stamps_spans_rates_and_dispatch_stats(caplog):
    """`simulate` inside a span: the plan (the keys of JAX's
    `DispatchPlan.span_attr`) and one step on the span, one
    `event=epoch_rate` line stamped with the run and span, `epochs_total`
    up by E, and one dispatch-table observation under (eager, the plan's
    bucket, cpu). (JAX's own spans stay bare under jax 0.9: its
    `_tracing_now` probes `jax.core.trace_state_clean`, which that version
    no longer has, and so reads every host call as traced.)"""
    from yuma_simulation_tpu.models.config import YumaConfig as JConfig
    from yuma_simulation_tpu.simulation.planner import plan_dispatch as j_plan_dispatch

    reg = tmetrics.get_registry()
    before = reg.counter("epochs_total").value
    tslo.get_dispatch_stats().reset()
    with caplog.at_level(logging.INFO, logger="yuma_simulation_tpu_torch"):
        with trunctx.RunContext("run-sim") as run, trunctx.span("case") as s:
            r = simulate(create_case("Case 3"), "Yuma 1 (paper)", device="cpu")
    E, V, M = create_case("Case 3").weights.shape
    j_attr = j_plan_dispatch("simulate", (E, V, M), "Yuma 1 (paper)", JConfig(),
                             np.float32).span_attr()
    assert set(s.attrs) == {"plan", "steps"} and len(s.attrs["steps"]) == 1
    assert set(s.attrs["plan"]) == set(j_attr)
    assert s.attrs["plan"]["engine"] == r.engine == "eager"
    lines = [tlogging.parse_event_line(rec.getMessage()) for rec in caplog.records]
    rates = [x for x in lines if x and x["event"] == "epoch_rate"]
    assert len(rates) == 1 and rates[0]["run_id"] == "run-sim" and rates[0]["span_id"] == "s0001"
    assert rates[0]["label"] == "simulate:Yuma 1 (paper)" and rates[0]["epochs"] == str(E)
    assert reg.counter("epochs_total").value == before + E
    assert reg.gauge("epochs_per_sec").value > 0
    table = tslo.dispatch_snapshot()
    key = f"eager|{bucket_shape(V, M, epochs=E).key}|cpu"
    assert list(table) == [key] and table[key]["dispatches"] == 1 and table[key]["epochs_total"] == E
    assert [rec["name"] for rec in run.span_records()] == ["case"]


def test_batch_sharded_and_suite_spans():
    """`simulate_batch` annotates its dispatch, the sharded batch opens
    JAX's `mesh:<n>dev` span with one step per shard, and the chart suite
    JAX's `chart_suite` span with a `version:<name>` span per version."""
    from yuma_simulation_tpu.models.config import SimulationHyperparameters as JSim
    from yuma_simulation_tpu.models.variants import canonical_versions as j_versions
    from yuma_simulation_tpu.scenarios import get_cases as j_get_cases
    from yuma_simulation_tpu.v1.api import _simulate_suite as j_suite
    from yuma_simulation_tpu_torch.models.config import SimulationHyperparameters
    from yuma_simulation_tpu_torch.models.variants import canonical_versions
    from yuma_simulation_tpu_torch.parallel import make_mesh, simulate_batch_sharded
    from yuma_simulation_tpu_torch.v1.api import _simulate_suite

    cases = get_cases()[:3]
    with trunctx.RunContext() as run:
        with trunctx.span("batch") as s:
            W, S, ri, re_ = stack_scenarios(cases, device="cpu")
            simulate_batch(W, S, ri, re_, YumaConfig(), variant_for_version("Yuma 1 (paper)"))
        assert len(s.attrs["steps"]) == 1 and s.attrs["plan"]["engine"] == "eager"
        simulate_batch_sharded(cases, "Yuma 1 (paper)", mesh=make_mesh(devices=["cpu"] * 2))
    # Each shard's dispatch is two nested ranges: "sharded_batch:2dev"
    # around its simulate_batch's own "simulate_batch:eager".
    mesh_span = run.span_records()[-1]
    assert mesh_span["name"] == "mesh:2dev" and len(mesh_span["attrs"]["steps"]) == 4
    versions = canonical_versions()[:2]
    trees = []
    for suite, rc, args in (
        (_simulate_suite, trunctx, (cases, versions, SimulationHyperparameters())),
        (j_suite, jrunctx, (j_get_cases()[:3], j_versions()[:2], JSim())),
    ):
        kw = {"device": "cpu"} if suite is _simulate_suite else {}
        with rc.RunContext("run-suite") as run:
            suite(*args, **kw)
        recs = run.span_records()
        names = {r["span_id"]: r["name"] for r in recs}
        # JAX's suite runs each version under its retry ladder, whose
        # "engine:<rung>" spans come with the resilience slice.
        trees.append([(r["name"], names.get(r["parent_id"], "")) for r in recs
                      if not r["name"].startswith("engine:")])
    assert trees[0] == trees[1]
    assert trees[0] == [(f"version:{v}", "chart_suite") for v, _ in versions] + [("chart_suite", "")]


def test_profile_trace_holds_the_dispatch_range(tmp_path):
    """`profile_trace` writes a Chrome trace whose host timeline holds the
    `simulate:<rung>` range of each dispatch; `profile_trace(None)` is a
    no-op; the sheet CLI's `--profile-dir` traces its batched dispatches."""
    with profile_trace(str(tmp_path / "a")) as prof:
        simulate(create_case("Case 2"), "Yuma 1 (paper)", device="cpu")
    assert prof is not None
    events = json.loads((tmp_path / "a" / "trace.json").read_text())["traceEvents"]
    assert [e["name"] for e in events if e.get("name", "").startswith("simulate:")] == [
        "simulate:eager"]
    with profile_trace(None) as nothing:
        assert nothing is None
    from yuma_simulation_tpu_torch.cli.total_dividends_sheet_generator import main

    main(["--bond-penalty", "0", "--device", "cpu", "--out-dir", str(tmp_path / "out"),
          "--profile-dir", str(tmp_path / "b")])
    events = json.loads((tmp_path / "b" / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("name", "").startswith("simulate_batch:")]
    assert len(names) == 9 and set(names) == {"simulate_batch:eager"}
    assert (tmp_path / "out" / "total_dividends_b0.csv").exists()


def test_trace_range_windows_reads_ranges_and_kernels(tmp_path):
    """`trace_range_windows` splits a named range into its host and card
    windows and joins each matching kernel to its launch by correlation
    id; `within` holds a window to them with the trace's rounding slack."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "simulate:fused_varying", "ts": 100, "dur": 50},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "simulate:fused_varying",
         "ts": 120, "dur": 80},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110, "dur": 5,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "void k_bond<16>(float*)", "ts": 130, "dur": 20,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_orphan", "ts": 300, "dur": 1,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "elementwise_kernel", "ts": 140, "dur": 1},
        {"ph": "i", "cat": "user_annotation", "name": "simulate:fused_varying", "ts": 0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    win = trace_range_windows(str(path), "simulate:fused_varying")
    assert win["cpu"] == [(100.0, 150.0)] and win["gpu"] == [(120.0, 200.0)]
    assert win["kernels"] == [("void k_bond<16>(float*)", (130.0, 150.0), (110.0, 115.0)),
                              ("k_orphan", (300.0, 301.0), None)]
    assert within((110.0, 115.0), win["cpu"]) and within((99.5, 150.5), win["cpu"])
    assert not within((98.0, 115.0), win["cpu"]) and not within(None, win["cpu"])
    assert not within((300.0, 301.0), win["gpu"])


def test_device_sample_and_timers_on_the_cpu(caplog):
    """Without CUDA the device sample is the JAX package's CPU one (no
    memory figures) and leaves the gauges untouched; `timed` without
    epochs logs a plain timer, with epochs one epoch-rate record;
    `time_best` keeps JAX's contract (grid-rounded counts, the cap, the
    refusal of a cap below the grid)."""
    if torch.cuda.is_available():
        pytest.skip("the CPU sample needs a machine without CUDA")
    sample = sample_device_telemetry()
    assert sample == {"backend": "cpu", "num_devices": 1, "device_peak_bytes": None,
                      "device_bytes_in_use": None, "live_buffers": None}
    reg = tmetrics.MetricsRegistry()
    assert record_device_telemetry(reg) == sample and reg.snapshot()["gauges"] == {}
    with caplog.at_level(logging.INFO, logger="yuma_simulation_tpu_torch"):
        with timed("plain") as t:
            pass
        with timed("rate", epochs=10) as r:
            sum(range(1000))
    msgs = [rec.getMessage() for rec in caplog.records]
    assert any(m.startswith("plain: ") for m in msgs) and t.epochs_per_sec is None
    assert sum("event=epoch_rate label=rate epochs=10" in m for m in msgs) == 1
    assert math.isclose(r.epochs_per_sec, 10 / r.seconds)
    calls = []
    rate, n, times, cv = time_best(lambda k: calls.append(k), 5, granularity=4, max_n=64,
                                   target_seconds=0.0005, reps=3)
    assert n % 4 == 0 and n <= 64 and len(times) == 3 and rate > 0 and cv >= 0
    assert all(c % 4 == 0 for c in calls)
    with pytest.raises(ValueError, match="no timeable"):
        time_best(lambda k: None, 1, granularity=8, max_n=4)

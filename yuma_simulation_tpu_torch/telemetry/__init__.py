"""Telemetry of the port: the JAX package's `telemetry/` as far as ported.

- :mod:`.cost`: the rungs' work (cost records from the shape, rooflines
  against the device spec) and the HBM half (the analytic footprint and
  the preflight every dispatch plan runs);
- :mod:`.numerics`: the per-epoch numerics sketches every `simulate`,
  `simulate_streamed`, `simulate_batch` and `sweep_hyperparams` result
  carries (``YUMA_NUMERICS=0`` turns them off);
- :mod:`.runctx`: `RunContext` and nested `span` timers; `log_event`
  records carry ``run_id`` / ``span_id``, and `dispatch_annotation` names
  each dispatch in a `torch.profiler` trace;
- :mod:`.metrics`: the process registry of counters, gauges and
  histograms, with JSONL and Prometheus sinks;
- :mod:`.registry`: every event and metric name the port emits;
- :mod:`.slo`: latency sketches, SLO burn rates, the dispatch timing table;
- :mod:`.propagation`: cross-process trace continuation;
- :mod:`.device`: the card's memory, sampled between dispatches, and the
  kernel builds counted onto ``recompiles``;
- :mod:`.flight`: the per-run on-disk bundle of a supervised sweep (ledger,
  spans, metrics, numerics, report, SLO state) and its loader and
  consistency checks, in the JAX package's formats (``python -m
  tools.obsreport DIR --check`` reads it);
- :mod:`.timeseries` / :mod:`.anomaly` / :mod:`.incident`: bounded
  per-key series folded from the metric snapshot stream, robust anomaly
  detectors (MAD, rate of change, counter stall, saturation), and the
  correlation of anomalies, SLO transitions and typed fault records into
  durable ``incidents.jsonl`` records;
- :mod:`.ops`: the live operations plane of a standing host (the events
  ring, ``debug_vars`` / ``debug_spans`` / ``debug_incidents``, and
  on-demand ``torch.profiler`` windows behind one process-wide latch).

Host-side only: nothing here synchronizes the card on its own.
"""

from yuma_simulation_tpu_torch.telemetry.cost import (  # noqa: F401
    DEVICE_SPECS,
    ENGINE_RUNGS,
    CostRecord,
    DeviceSpec,
    FootprintEstimate,
    HBMPreflightError,
    PreflightVerdict,
    Roofline,
    capture_engine_cost,
    capture_engine_costs,
    estimate_hbm_bytes,
    preflight_hbm,
    resolve_device_spec,
    roofline,
)
from yuma_simulation_tpu_torch.telemetry.anomaly import (  # noqa: F401
    Anomaly,
    AnomalyEngine,
    CounterStallDetector,
    MadDetector,
    RateOfChangeDetector,
    SaturationDetector,
)
from yuma_simulation_tpu_torch.telemetry.device import (  # noqa: F401
    CompileTracker,
    record_device_telemetry,
    sample_device_telemetry,
)
from yuma_simulation_tpu_torch.telemetry.flight import (  # noqa: F401
    Bundle,
    FlightRecorder,
    RotationPolicy,
    build_timeline,
    check_bundle,
    check_stitched,
    ledger_counts,
    load_bundle,
    merge_bundles,
    rotation_from_env,
)
from yuma_simulation_tpu_torch.telemetry.incident import (  # noqa: F401
    CAUSE_EVENTS,
    Incident,
    IncidentEngine,
    correlate,
    correlate_bundle,
    latest_incidents,
    load_incidents,
    open_incident_count,
)
from yuma_simulation_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    record_epoch_rate,
)
from yuma_simulation_tpu_torch.telemetry.propagation import (  # noqa: F401
    TraceContext,
    child_run,
    continue_trace,
    current_trace_context,
    span_prefix_for,
)
from yuma_simulation_tpu_torch.telemetry.runctx import (  # noqa: F401
    RunContext,
    Span,
    current_fields,
    current_run,
    current_span,
    dispatch_annotation,
    ensure_run,
    new_run_id,
    span,
)
from yuma_simulation_tpu_torch.telemetry.slo import (  # noqa: F401
    DEFAULT_SLO_SPECS,
    LatencySketch,
    SLOEngine,
    SLOSpec,
    dispatch_snapshot,
    get_slo_engine,
    observe_dispatch,
    observe_duration,
    observe_event,
    set_slo_engine,
)
from yuma_simulation_tpu_torch.telemetry.ops import (  # noqa: F401
    OpsPlane,
    ProfileBusyError,
    ProfileSession,
    clear_events,
    note_event,
    recent_events,
)
from yuma_simulation_tpu_torch.telemetry.timeseries import (  # noqa: F401
    TimeSeriesStore,
    store_from_metrics,
)

"""The telemetry name registry: every structured event and metric name the
port emits.

The counterpart of the JAX package's `telemetry/registry.py`. Each name the
port's code emits is declared here with the JAX package's own spec (kind,
summary, consumers or operator reason), so records and series read the
same in both packages' tools; names the port does not emit are not
declared. Every entry names its consumers (report tools, or package
modules in the JAX package's dotted names) or carries an
``operator_reason``; :func:`validate_registry` checks the shapes, and
``tests/test_torch_telemetry.py`` checks that every emitted name is
declared with the JAX package's kind.

Import-light (stdlib only) and literal, so tools can read it without the
port's runtime dependencies.
"""

from __future__ import annotations

import dataclasses

#: Report tools (under ``tools/``) that may be named as consumers.
REPORT_TOOLS = ("obsreport", "sloreport", "driftreport", "incidentreport")


@dataclasses.dataclass(frozen=True)
class EventSpec:
    """One declared structured-event name.

    ``consumers`` lists who reads the name back: a report tool (bare
    name from :data:`REPORT_TOOLS`) or a package module (dotted path
    under ``yuma_simulation_tpu``, the JAX package's names). Events nobody consumes by name must
    say why they are worth emitting in ``operator_reason`` — "somebody
    might grep it" is exactly the claim the registry forces into
    review."""

    summary: str
    consumers: tuple = ()
    operator_reason: str = ""


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One declared metric series (kind pinned so a counter cannot
    silently become a gauge across a refactor)."""

    kind: str  # "counter" | "gauge" | "histogram" | "sketch"
    summary: str
    consumers: tuple = ()
    operator_reason: str = ""


EVENTS = {
    "dispatch_planned": EventSpec(
        "one DispatchPlan resolved (engine rung, bucket, memory plan)",
        operator_reason="DEBUG-level; the plan summary rides span "
        "attrs, which obsreport renders per request/unit",
    ),
    "preflight_rejected": EventSpec(
        "analytic HBM preflight rejected a dispatch before compile",
        operator_reason="capacity forensics; the typed "
        "HBMPreflightError carries the same payload to the caller",
    ),
    "distributed_init_failed": EventSpec(
        "multi-host jax.distributed initialization failed",
        operator_reason="pod-bringup forensics (single-host fallback "
        "continues)",
    ),
    "epoch_rate": EventSpec(
        "one throughput measurement (epochs/s with dispersion)",
        operator_reason="bench forensics; the epochs_per_sec gauge is "
        "the machine-readable twin",
    ),
    "slo_alert": EventSpec(
        "burn-rate alert entered fast/slow burn",
        consumers=("serve.service",),
    ),
    "slo_recovered": EventSpec(
        "burn-rate alert recovered to ok",
        consumers=("serve.service",),
    ),
}


METRICS = {
    "epochs_total": MetricSpec(
        "counter", "simulated epochs (lanes x E), from the epoch-rate "
        "reporters",
    ),
    "epochs_per_sec": MetricSpec(
        "gauge", "last observed throughput (event=epoch_rate twin)",
        consumers=("obsreport",),
    ),
    "epochs_per_sec_cv": MetricSpec(
        "gauge", "timing dispersion (CV) of the last rate",
    ),
    "device_peak_bytes": MetricSpec(
        "gauge", "peak device memory at last sample (None-safe on CPU)",
    ),
    "device_bytes_in_use": MetricSpec(
        "gauge", "device memory in use at last sample",
    ),
    "live_buffers": MetricSpec(
        "gauge", "live jax.Array count at last sample",
    ),
    "dispatch_seconds": MetricSpec(
        "sketch", "always-on per-(engine rung x shape bucket x backend) "
        "dispatch wall-time quantile sketches (DispatchStats), riding "
        "metrics lines as the dispatch_sketches field; "
        "tools/perfattrib.py joins them against cost/roofline records",
        consumers=("obsreport",),
    ),
    "slo_alerts_total": MetricSpec(
        "counter", "burn-rate alert transitions (any direction)",
    ),
    "slo_fast_burn_active": MetricSpec(
        "gauge", "SLOs currently in fast burn",
    ),
    "slo_slow_burn_active": MetricSpec(
        "gauge", "SLOs currently in slow burn",
    ),
}


def declared_events() -> frozenset:
    return frozenset(EVENTS)


def declared_metrics() -> frozenset:
    return frozenset(METRICS)


def validate_registry() -> list:
    """The registry's shape checks: every entry either names consumers or
    justifies itself, and every kind is legal. Returns a list of problem
    strings (empty = healthy)."""
    problems = []
    for name, spec in EVENTS.items():
        if not spec.consumers and not spec.operator_reason:
            problems.append(
                f"event {name!r}: no consumers and no operator_reason"
            )
    for name, spec in METRICS.items():
        # "sketch": a quantile-sketch family riding metrics lines
        # (dispatch_seconds) rather than a registry series.
        if spec.kind not in ("counter", "gauge", "histogram", "sketch"):
            problems.append(f"metric {name!r}: unknown kind {spec.kind!r}")
    return problems

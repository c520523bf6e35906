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
    # -- engine ladder / watchdog / quarantine / supervisor (resilience) ----
    "engine_retry": EventSpec(
        "same-rung retry with backoff (resilience.retry.run_ladder)",
        operator_reason="recovery forensics: one greppable record per burned "
                        "attempt; counted via the engine_retries metric",
    ),
    "engine_demoted": EventSpec(
        "ladder demotion onto a lower engine rung",
        operator_reason="recovery forensics; counted via the engine_demotions "
                        "metric obsreport reconciles",
    ),
    "engine_stalled": EventSpec(
        "watchdog deadline kill of a hung dispatch",
        operator_reason='incident forensics; counted via stalls_killed',
    ),
    "sweep_supervised": EventSpec(
        "supervised sweep finished (one summary record per sweep)",
        operator_reason="sweep-level summary line for operator greps; per-unit "
                        "accounting rides unit_ok records",
    ),
    "unit_ok": EventSpec(
        "one sweep unit finished and published",
        consumers=(
            "obsreport",
            "fabric.health",
            "telemetry.flight",
            "resilience.supervisor",
        ),
    ),
    "unit_failed": EventSpec(
        "one sweep unit exhausted every recovery path",
        operator_reason="terminal per-unit failure record; resumed sweeps skip "
                        "completed units via unit_ok, failures re-run",
    ),
    "unit_retry": EventSpec(
        "one sweep unit re-dispatched after a retryable failure",
        operator_reason='per-unit recovery forensics between the attempt spans',
    ),
    "unit_requeued": EventSpec(
        "one sweep unit pushed back onto the work queue",
        consumers=("telemetry.flight",),
    ),
    "unit_stalled": EventSpec(
        "one sweep unit killed by the deadline watchdog",
        consumers=("telemetry.flight",),
    ),
    "unit_canary": EventSpec(
        "cross-engine numerics canary re-execution for one unit",
        operator_reason="canary audit trail; verdicts feed the engine_drift_ok "
                        "SLO stream and the engine_drift event",
    ),
    "canary_failed": EventSpec(
        "a numerics canary re-execution itself errored (no verdict)",
        operator_reason="canary infrastructure failure is not drift; record "
                        "keeps the no-verdict case auditable",
    ),
    "engine_drift": EventSpec(
        "CONFIRMED cross-engine numerics drift (bitwise divergence localized to"
        " its first epoch)",
        consumers=("telemetry.slo", "serve.service"),
        operator_reason="the typed incident record; gates ride the "
                        "engine_drift_ok SLO stream and driftreport's "
                        "numerics.jsonl comparison",
    ),
    "checkpoint_chunk_requeued": EventSpec(
        "corrupt/torn checkpoint chunk detected and requeued",
        operator_reason='crash-recovery forensics for resumed sweeps',
    ),
    "fault_injected": EventSpec(
        "deterministic fault armed by a chaos drill",
        operator_reason="drill forensics: pairs each injected fault with the "
                        "recovery records it provoked",
    ),
    "mesh_degraded": EventSpec(
        "elastic mesh shrank after device loss",
        operator_reason="counted via mesh_shrinks which obsreport reconciles; "
                        "record carries the lost device ids",
    ),
    "segment_sealed": EventSpec(
        "the flight recorder's live rotation segment hit a size/age bound (or "
        "was sealed at close) and published its seal.json (record carries "
        "segment name, bytes, run ids)",
        consumers=("obsreport",),
    ),
    "segments_compacted": EventSpec(
        "retention reclaimed sealed segments past the policy's byte bound and "
        "merged them into the compacted.json tombstone that exempts their runs "
        "from span checks",
        consumers=("obsreport",),
    ),
    # -- dispatch planning / memory / telemetry core ---------------------------
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
    # -- the kernel-library cache (ops._build, simulation.aot) ------------------
    "executable_cache_hit": EventSpec(
        "one published executable deserialized and dispatched (cold "
        "start skipped a compile)",
        operator_reason="cold-start forensics: one record per program "
        "load; the executable_cache_hits counter is the reconciled "
        "aggregate the CI cold-start lane asserts on via "
        "cache_stats.json",
    ),
    "executable_cache_miss": EventSpec(
        "no loadable artifact for this program (reason: absent / "
        "corrupt / torn / undeserializable) — dispatch requeued to JIT",
        operator_reason="typed miss taxonomy: a corrupt or truncated "
        "artifact must surface as a greppable reason, never a crash or "
        "a silent slow start",
    ),
    "executable_cache_stale": EventSpec(
        "artifacts for this exact program exist only under another "
        "toolchain/device — rebuilt instead of misexecuted",
        operator_reason="upgrade forensics: a jax/jaxlib bump or a "
        "device swap shows up as stale misses, the signal to re-warm "
        "the cache",
    ),
    # -- scenario foundry -------------------------------------------------------
    "scenario_compiled": EventSpec(
        "one foundry ScenarioSpec materialized to dense Scenario arrays",
        operator_reason="DEBUG-level log-stream provenance per generated "
        "scenario; the scenarios_generated counter (obsreport-rendered) "
        "is the machine-readable process-lifetime aggregate",
    ),
    "metagraph_loaded": EventSpec(
        "one metagraph snapshot file ingested (netuid/block/shape)",
        operator_reason="ingestion audit trail on the log stream: which "
        "snapshot file fed which generated suite (grep event=)",
    ),
    # -- the fleet fabric and the ops / incident plane -----------------------
    "host_started": EventSpec(
        'fleet host joined the sweep',
        consumers=('fabric.health',),
    ),
    "host_finished": EventSpec(
        'fleet host drained its queue and published its tallies',
        consumers=('fabric.health',),
    ),
    "fleet_host_finished": EventSpec(
        'log twin of the host_finished ledger record',
        operator_reason='one INFO line per finished host for operator tails; the ledger record is the accounted copy',
    ),
    "host_lost": EventSpec(
        'fleet host declared dead (lease expired, no heartbeat)',
        consumers=('fabric.health',),
    ),
    "unit_claimed": EventSpec(
        'fleet unit lease claimed',
        consumers=('fabric.health',),
    ),
    "unit_stolen": EventSpec(
        'fleet unit lease stolen from a stalled host',
        consumers=('fabric.health',),
    ),
    "unit_abandoned": EventSpec(
        'fleet unit abandoned after repeated steal generations',
        consumers=('fabric.health',),
    ),
    "unit_duplicate": EventSpec(
        'fleet unit result published twice (at-most-once collision)',
        consumers=('fabric.health',),
    ),
    "lease_stolen": EventSpec(
        'lease-level steal detail (inode generation handoff)',
        operator_reason='steal forensics below the unit_stolen ledger record',
    ),
    "profile_started": EventSpec(
        "an on-demand device-profiling window opened (POST /debug/profile, SweepSupervisor profile_every, or the replay controller's --profile-window; record carries mode, artifact dir, deadline)",
        consumers=('obsreport',),
    ),
    "profile_published": EventSpec(
        "a profiling window closed and its trace artifact was registered into the bundle's profiles.jsonl",
        consumers=('obsreport',),
    ),
    "anomaly_detected": EventSpec(
        'a robust detector (MAD / rate-of-change / counter-stall / saturation) fired on a metric time series; record carries kind, series, value, baseline, threshold, window',
        consumers=('incidentreport', 'obsreport', 'telemetry.incident'),
    ),
    "incident_opened": EventSpec(
        'the correlation engine opened an incident around a typed fault ledger event (record carries incident id, cause_class, cause_event, subject); full state rides incidents.jsonl',
        consumers=('incidentreport', 'obsreport', 'fabric.health'),
    ),
    "incident_resolved": EventSpec(
        "an open incident's cause class observed its recovery event (record carries incident id, resolution)",
        consumers=('incidentreport', 'obsreport', 'fabric.health'),
    ),
    # -- the serving tier and chain replay (serve/, replay/) ---------------
    "serve_warmed": EventSpec(
        'serve warmup finished (buckets compiled before first request)',
        operator_reason='cold-start forensics; compile cost rides the compile_seconds histogram and cold_start SLO',
    ),
    "serve_closed": EventSpec(
        'serve service closed and published its flight bundle',
        operator_reason='shutdown marker closing the request ledger',
    ),
    "breaker_tripped": EventSpec(
        'circuit breaker opened an engine rung fleet-wide',
        operator_reason='breaker forensics; serve_breaker_trips / serve_breaker_open are the reconciled aggregates',
    ),
    "breaker_half_open": EventSpec(
        'circuit breaker probing a tripped rung',
        operator_reason='breaker state-machine forensics',
    ),
    "breaker_probe_aborted": EventSpec(
        'half-open probe failed; rung re-opened',
        operator_reason='breaker state-machine forensics',
    ),
    "breaker_closed": EventSpec(
        'circuit breaker closed a recovered rung',
        operator_reason='breaker state-machine forensics',
    ),
    "state_cache_hit": EventSpec(
        'a what-if resumed from a cached epoch-state checkpoint (suffix-sized re-simulation)',
        operator_reason="per-resolve forensics on the log stream; the state_cache_hits counter is the reconciled aggregate the replay drill and obsreport's replay section read",
    ),
    "state_cache_miss": EventSpec(
        'a what-if found no usable cached epoch state (reason: baseline not built / no checkpoint before the perturb epoch / state unreadable) — full-trajectory re-simulation',
        operator_reason='typed miss taxonomy on the log stream; the state_cache_misses counter is the reconciled aggregate',
    ),
    # -- the multi-process serving and replay tier -------------------
    "autoscale_down": EventSpec(
        "autoscaler retired one idle worker (youngest-first)",
        operator_reason="capacity forensics; the ledgered "
        "worker_retired record is the reconciled event",
    ),
    "autoscale_up": EventSpec(
        "autoscaler spawned one worker on an SLO fast burn",
        operator_reason="capacity forensics; the ledgered "
        "worker_spawned record carries the same reason string",
    ),
    "controller_restarted": EventSpec(
        "a restarting replay controller found a stale open-run marker "
        "from a prior incarnation that never closed (SIGKILL/crash) — "
        "the typed cause behind process-loss incidents",
        consumers=("incidentreport", "telemetry.incident"),
    ),
    "router_stopped": EventSpec(
        "router closed: pool retired, merged ingress bundle published",
        operator_reason="shutdown marker closing the router's ledger",
    ),
    "subnet_ingested": EventSpec(
        "the controller observed fresh archive entries for a subnet "
        "(record carries netuid, new blocks, latest block)",
        consumers=("obsreport",),
    ),
    "subnet_quarantined": EventSpec(
        "a corrupt or truncated snapshot blob was quarantined (typed "
        "reason; the entry is excluded and the subnet keeps draining)",
        consumers=("obsreport",),
    ),
    "subnet_stalled": EventSpec(
        "a subnet's archive stopped appending past the stall deadline; "
        "the controller demoted it to the slow poll tier",
        consumers=("obsreport",),
    ),
    "watermark_advanced": EventSpec(
        "a durable per-(subnet x variant) watermark moved forward after "
        "a window's fleet results published (the at-least-once sweep / "
        "exactly-once publication commit point)",
        consumers=("obsreport",),
    ),
    "window_swept": EventSpec(
        "one incremental (subnet x variant) window swept, published and "
        "baseline-extended (record carries netuid, version, block span, "
        "epoch span, suffix vs full epochs)",
        consumers=("obsreport",),
    ),
    "worker_lease_lost": EventSpec(
        "worker's own slot lease expired under it (missed heartbeats) "
        "— it must stop serving rather than split-brain the slot",
        operator_reason="incident forensics for the worker side of a "
        "partition; the router side rides worker_lost",
    ),
    "worker_lost": EventSpec(
        "a worker observed dead on a forward leg (connection "
        "reset/refused mid-request) — routing stops considering it "
        "before its lease even expires",
        consumers=("obsreport",),
    ),
    "worker_ready": EventSpec(
        "worker claimed its slot lease and began heartbeating ads",
        operator_reason="startup marker in the worker's own log; the "
        "router-side worker_spawned record is the reconciled event",
    ),
    "worker_spawning": EventSpec(
        "router forked a worker process onto a free slot (precedes "
        "the ledgered worker_spawned, which waits for readiness)",
        operator_reason="spawn forensics: pins the pid/slot when a "
        "worker dies before ever advertising",
    ),
    "worker_stopped": EventSpec(
        "worker drained, published its bundle, and released its slot",
        operator_reason="shutdown marker closing the worker's log",
    ),
}


METRICS = {
    # -- resilience and the flight recorder ---------------------------------
    "engine_retries": MetricSpec(
        "counter",
        "same-rung ladder retries",
    ),
    "engine_demotions": MetricSpec(
        "counter",
        "engine-ladder demotions",
        consumers=("obsreport",),
    ),
    "stalls_killed": MetricSpec(
        "counter",
        "watchdog deadline kills",
        consumers=("obsreport",),
    ),
    "mesh_shrinks": MetricSpec(
        "counter",
        "elastic mesh degradations",
        consumers=("obsreport",),
    ),
    "quarantined_lanes": MetricSpec(
        "counter",
        "non-finite lanes masked by the quarantine guard",
    ),
    "checkpoint_bytes": MetricSpec(
        "counter",
        "bytes of published checkpoint chunk snapshots",
    ),
    "numerics_canaries": MetricSpec(
        "counter",
        "cross-engine canary re-executions",
    ),
    "engine_drift_total": MetricSpec(
        "counter",
        "canary comparisons that CONFIRMED drift",
    ),
    "engine_drift_expected": MetricSpec(
        "counter",
        "canary drift crossings stamped expected (the documented u16-fallback "
        "pairing class)",
    ),
    "telemetry_segments_total": MetricSpec(
        "counter",
        "flight-recorder segments sealed by rotation",
        consumers=("obsreport",),
    ),
    "telemetry_bytes_retained": MetricSpec(
        "gauge",
        "bytes currently retained across sealed rotation segments (post-compaction)",
        consumers=("obsreport",),
    ),
    # -- rates, device, SLO ---------------------------------------------------
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
    # -- compiles and the kernel-library cache -----------------------------------
    "compile_seconds": MetricSpec(
        "histogram", "wall seconds of sentinel regions that added "
        "jit-cache entries (compile-time upper bound)",
    ),
    "recompiles": MetricSpec(
        "counter", "new jit-cache entries observed by "
        "RecompilationSentinel regions",
    ),
    "executable_cache_hits": MetricSpec(
        "counter", "published executables deserialized from the cache "
        "(compiles skipped)",
    ),
    "executable_cache_misses": MetricSpec(
        "counter", "cache lookups with no loadable artifact (absent or "
        "corrupt — dispatch requeued to JIT)",
    ),
    "executable_cache_stale": MetricSpec(
        "counter", "lookups that found only other-toolchain/device "
        "artifacts for the program",
    ),
    "executable_cache_builds": MetricSpec(
        "counter", "programs AOT-exported and published after a miss "
        "(true compiles, counted by RecompilationSentinel budgets)",
    ),
    # -- scenario foundry -------------------------------------------------------
    "scenarios_generated": MetricSpec(
        "counter", "foundry-generated scenarios (DSL compiles + "
        "metagraph ingestions + adversarial builds)",
        consumers=("obsreport",),
    ),
    # -- the incident plane (telemetry.incident) ---------------------------
    "anomalies_total": MetricSpec(
        'counter',
        'detector firings ledgered as anomaly_detected',
        consumers=('incidentreport', 'obsreport'),
    ),
    "incidents_open": MetricSpec(
        'gauge',
        'correlated incidents currently open in this bundle (also the open-incident count /healthz reports)',
        consumers=('incidentreport', 'serve.service'),
    ),
    # -- the serving tier and chain replay (serve/, replay/) ---------------
    "serve_requests_total": MetricSpec(
        'counter',
        'serving-tier requests handled (any outcome)',
    ),
    "serve_queue_depth": MetricSpec(
        'gauge',
        'run-queue occupancy right now',
    ),
    "serve_requests_shed": MetricSpec(
        'counter',
        '429-shed requests (tenant quota or queue bound)',
    ),
    "serve_admission_rejected": MetricSpec(
        'counter',
        'typed admission rejections (pre-compile)',
    ),
    "serve_coalesced_lanes": MetricSpec(
        'counter',
        'requests donor-packed into a shared dispatch',
    ),
    "serve_breaker_trips": MetricSpec(
        'counter',
        'circuit-breaker rung trips',
    ),
    "serve_breaker_open": MetricSpec(
        'gauge',
        'engine rungs currently tripped open',
    ),
    "serve_request_seconds": MetricSpec(
        'histogram',
        'request wall time, admission to reply',
    ),
    "serve_canary_ticks": MetricSpec(
        'counter',
        'background numerics-canary bucket re-executions',
    ),
    "serve_canary_drift": MetricSpec(
        'counter',
        'serve canary comparisons that confirmed drift',
    ),
    "state_cache_hits": MetricSpec(
        'counter',
        'what-if suffix resumes served from a cached epoch state',
        consumers=('obsreport',),
    ),
    "state_cache_misses": MetricSpec(
        'counter',
        'what-if requests with no usable cached epoch state (full re-simulation)',
        consumers=('obsreport',),
    ),
    "replay_suffix_epochs_saved": MetricSpec(
        'counter',
        'epochs cached carries let what-ifs skip re-simulating (suffix-vs-full savings)',
        consumers=('obsreport',),
    ),
    # -- the multi-process serving and replay tier -------------------
    "affinity_hits_total": MetricSpec(
        "counter", "requests the claim scorer placed on a worker "
        "already holding useful state (cache prefix or warm bucket)",
        consumers=("obsreport",),
    ),
    "replay_staleness_seconds": MetricSpec(
        "gauge", "per-cycle worst-case age of the oldest unswept "
        "archive suffix across live subnets (freshness SLO input)",
        consumers=("obsreport",),
    ),
    "serve_reroutes_total": MetricSpec(
        "counter", "forward legs rerouted off a lost worker onto a "
        "survivor",
        consumers=("obsreport",),
    ),
    "serve_workers_live": MetricSpec(
        "gauge", "live serve workers behind the router (fresh lease + "
        "advertisement) right now",
        consumers=("obsreport",),
    ),
    "snapshots_quarantined_total": MetricSpec(
        "counter", "corrupt/truncated snapshot blobs quarantined by the "
        "controller",
        consumers=("obsreport",),
    ),
    "subnets_live": MetricSpec(
        "gauge", "subnets on the fast poll tier (not stalled)",
        consumers=("obsreport",),
    ),
    "windows_swept_total": MetricSpec(
        "counter", "incremental (subnet x variant) windows published by "
        "the continuous replay controller",
        consumers=("obsreport",),
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

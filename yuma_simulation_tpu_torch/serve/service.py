"""The simulation service core: admission -> queue -> coalesce -> dispatch.

The long-lived, transport-agnostic heart of the serving tier (the HTTP
layer in :mod:`.server` is a thin adapter over :meth:`SimulationService
.handle`). One process, one service, one telemetry
:class:`..telemetry.runctx.RunContext` for its whole lifetime — every
request rides the pipeline:

1. **admission** (:mod:`.admission`): validate + price through the
   planner and the analytic memory preflight of the service's device,
   zero launches — typed
   :class:`..resilience.errors.AdmissionRejected` -> structured 400;
2. **backpressure** (:mod:`.quotas`): per-tenant token bucket, then the
   global bounded run queue — typed `QueueOverflow` -> 429 +
   ``Retry-After``, never an unbounded backlog;
3. **coalescing** (:mod:`.coalescer`): same shape bucket within the
   window -> one batched dispatch (donor-packed on the eager rung,
   stacked on a kernel rung), per-request lanes sliced back bitwise;
4. **supervised execution**: every dispatch runs through
   :class:`..resilience.supervisor.SweepSupervisor` — the request's
   deadline threads into the watchdog, NaN lanes quarantine into
   ``"partial"`` responses, device loss shrinks the mesh into a
   ``degraded`` flag, engine failures demote down the ladder — and the
   per-rung :class:`.lifecycle.CircuitBreaker` re-anchors future plans
   below a rung that keeps failing, recovering via half-open probes.

The failure contract is total: every request receives a typed JSON
response — result, partial-with-quarantine, 429, structured rejection,
or structured failure — never a bare 500. The service's flight bundle
(spans + request ledger + metrics snapshot, published at close and
gated by ``obsreport --check``) is the ops record of all of it.

Every dispatch runs on the service's device (:attr:`ServeConfig.device`,
the card by default; construction raises without CUDA unless the CPU
was asked for). Only the dispatcher thread — and the watchdog workers
it starts — launches work on it: the HTTP handler threads parse, price
and wait.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import math
import pathlib
import threading
import time
from typing import Optional

import numpy as np

from yuma_simulation_tpu_torch.resilience.errors import (
    AdmissionRejected,
    EngineFailure,
    QueueOverflow,
    SloShed,
    classify_failure,
)
from yuma_simulation_tpu_torch.serve.admission import AdmissionTicket, admit
from yuma_simulation_tpu_torch.serve.coalescer import (
    gather_group,
    slice_simulate_response,
)
from yuma_simulation_tpu_torch.serve.lifecycle import CircuitBreaker, warmup
from yuma_simulation_tpu_torch.serve.quotas import BoundedRunQueue, TenantQuotas
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Service knobs; the CLI (:mod:`.__main__`) exposes the subset an
    operator tunes. Defaults are sized for the CPU smoke/test scale —
    a production deployment raises the queue and quota bounds."""

    queue_limit: int = 64
    coalesce_window_seconds: float = 0.05
    max_batch: int = 8
    tenant_rate: float = 20.0
    tenant_burst: int = 10
    #: tenant -> (rate, burst) negotiated quota overrides.
    tenant_overrides: Optional[dict] = None
    default_deadline_seconds: float = 120.0
    breaker_threshold: int = 3
    breaker_cooldown_seconds: float = 30.0
    #: Flight-bundle directory (spans + request ledger + metrics). None
    #: disables the on-disk bundle (tests); production sets it.
    bundle_dir: Optional[str] = None
    #: The device every dispatch runs on: the card by default; "cpu"
    #: must be asked for (construction raises when CUDA is absent).
    device: str = "cuda"
    #: `(epochs, V, M)` shapes to warm at startup (:func:`.lifecycle.warmup`).
    warmup_shapes: tuple = ()
    #: Kernel-library cache directory (:mod:`..simulation.aot`). When
    #: set, warmup loads published libraries instead of building them,
    #: and misses publish for the next process. None (default) uses the
    #: build directory the kernels already use.
    executable_cache_dir: Optional[str] = None
    #: Optional device mesh for sharded dispatch (elastic shrink rides
    #: the supervisor's existing path).
    mesh: object = None
    elastic: bool = True
    drain_estimate_seconds: float = 0.25
    #: SLO objectives this service evaluates (:mod:`..telemetry.slo`).
    #: None = the process engine with its default specs; a tuple of
    #: `SLOSpec` builds a service-owned engine over exactly those.
    slo_specs: Optional[tuple] = None
    #: While any `degrade=True` SLO fast-burns, requests with
    #: ``priority`` below this floor shed 429 BEFORE touching the
    #: queue (observability driving degradation). Default floor 1:
    #: normal traffic (priority 0) sheds, negotiated priority>=1 rides.
    shed_priority_below: int = 1
    #: tenant -> maximum accepted ``priority`` (the negotiated
    #: ceiling). When set, admission clamps the untrusted payload
    #: field to the tenant's entry (absent tenants to 0) so a client
    #: cannot opt out of SLO-driven shedding by claiming priority.
    #: None (default) trusts the payload — single-operator deployments.
    tenant_priority: Optional[dict] = None
    #: Retry-After for SLO-driven sheds (seconds).
    slo_shed_retry_after: float = 5.0
    #: Signed-API-key keyfile (:mod:`.apikeys`): JSON mapping
    #: ``tenant -> secret``. When set, every POST must carry a valid
    #: ``X-Api-Key`` — the verified key RESOLVES the tenant id before
    #: the negotiated quota/priority tables, so the payload's claimed
    #: ``tenant``/``priority`` is never trusted; unauthenticated
    #: requests get a typed 401. None (default) keeps the legacy
    #: payload-claimed tenant — single-operator deployments.
    api_keys_path: Optional[str] = None
    #: Background numerics-canary cadence: every this-many seconds of
    #: dispatcher idle time, re-execute one warm shape bucket on the
    #: plan's primary rung AND its demoted rung and compare per-epoch
    #: fingerprints (:mod:`..telemetry.numerics`). Confirmed drift is a
    #: typed ``engine_drift`` ledger event, a bad ``engine_drift_ok``
    #: SLO event (fast-burns -> `/healthz` degraded), and a breaker
    #: failure on the primary rung — plans re-anchor below a rung whose
    #: bits diverge from its own fallback. 0 disables (the default:
    #: a canary re-pays a bucket's compute).
    canary_interval_seconds: float = 0.0
    #: Chain-replay mount (:mod:`..replay`): when BOTH directories are
    #: set, the service answers ``POST /v1/whatif`` (admitted and
    #: priced suffix-sized through the planner like every other
    #: request) and ``GET /v1/replay[/NETUID]`` index reads. None
    #: (default) leaves the replay tier unmounted — what-ifs reject
    #: with a typed ``replay_unconfigured``.
    replay_archive_dir: Optional[str] = None
    replay_cache_dir: Optional[str] = None
    #: trailing window (snapshots) a what-if replays; None = the whole
    #: timeline.
    replay_window: Optional[int] = None
    replay_epochs_per_snapshot: int = 4
    #: carry-checkpoint stride (epochs) of cached baselines.
    replay_stride: int = 8
    #: LRU bound on cached baseline trajectories.
    replay_max_baselines: int = 64
    #: Continuous-telemetry rotation for the flight bundle
    #: (:class:`..telemetry.flight.RotationPolicy`): ``True`` opts in
    #: with default bounds, a policy instance pins them, ``None``
    #: (default) defers to the ``YUMA_TPU_FLIGHT_ROTATE`` env opt-in —
    #: i.e. rotation stays OFF unless explicitly requested, and
    #: monolithic bundles keep their exact legacy layout.
    flight_rotation: object = None
    #: Test-only: construct the service without its dispatcher thread
    #: (so queue-bound behavior can be observed deterministically).
    start_dispatcher: bool = True


class _Pending:
    """One admitted request waiting for its dispatch: the ticket plus
    the handler's rendezvous (`done` event, resolved status/body) and
    the critical-path timestamps the dispatcher stamps as the request
    moves — queue wait / coalesce wait / compile / execute become
    request-span children and the ``Server-Timing`` response header."""

    __slots__ = (
        "ticket",
        "done",
        "status",
        "response",
        "synthetic",
        "t_enqueued",
        "t_taken",
        "t_exec_start",
        "t_exec_end",
        "compile_seconds",
    )

    def __init__(self, ticket: AdmissionTicket, synthetic: bool = False):
        self.ticket = ticket
        self.done = threading.Event()
        self.status: Optional[int] = None
        self.response: Optional[dict] = None
        self.synthetic = synthetic
        self.t_enqueued = time.time()
        self.t_taken: Optional[float] = None
        self.t_exec_start: Optional[float] = None
        self.t_exec_end: Optional[float] = None
        self.compile_seconds = 0.0

    def resolve(self, status: int, body: dict) -> None:
        self.status = status
        self.response = body
        # Stamp the execute end HERE (not only in the dispatcher's
        # finally): the handler thread wakes on `done` and must never
        # observe a half-stamped critical path.
        if self.t_exec_start is not None and self.t_exec_end is None:
            self.t_exec_end = time.time()
        self.done.set()


class SimulationService:
    """See the module docstring. Thread-safe: `handle` is called from
    the HTTP server's per-connection threads; one dispatcher thread
    drains the queue."""

    def __init__(
        self,
        config: Optional[ServeConfig] = None,
        registry=None,
        slo_engine=None,
    ):
        from yuma_simulation_tpu_torch.resilience.supervisor import FailureLedger
        from yuma_simulation_tpu_torch.telemetry.metrics import get_registry
        from yuma_simulation_tpu_torch.telemetry.runctx import RunContext
        from yuma_simulation_tpu_torch.telemetry.slo import SLOEngine, get_slo_engine

        from yuma_simulation_tpu_torch.simulation.engine import resolve_device
        from yuma_simulation_tpu_torch.telemetry.cost import resolve_device_spec

        self.config = config if config is not None else ServeConfig()
        # No fallback: a service asked for the card raises here when
        # CUDA is absent. The device is pinned to an index and its spec
        # resolved now, on the constructing thread, so that admission on
        # the handler threads prices against a cached spec and never
        # queries the runtime.
        dev = resolve_device(self.config.device)
        if dev.type == "cuda" and dev.index is None:
            import torch

            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        resolve_device_spec(device=dev)
        self.registry = registry if registry is not None else get_registry()
        if self.config.executable_cache_dir:
            # Cold-start economics (simulation.aot): activate the kernel
            # cache BEFORE warmup, so the warmup pass below loads
            # published libraries instead of re-paying every build.
            from yuma_simulation_tpu_torch.simulation.aot import (
                configure_executable_cache,
            )

            configure_executable_cache(self.config.executable_cache_dir)
        self.run = RunContext()
        # Tenant identity (apikeys): load eagerly so a bad keyfile
        # fails construction, not the first request.
        self.keyring = None
        if self.config.api_keys_path:
            from yuma_simulation_tpu_torch.serve.apikeys import ApiKeyring

            self.keyring = ApiKeyring.load(self.config.api_keys_path)
        self._slo_installed = False
        if slo_engine is not None:
            self.slo = slo_engine
        elif self.config.slo_specs is not None:
            self.slo = SLOEngine(
                self.config.slo_specs, registry=self.registry
            )
            # Operator-declared objectives replace the process engine so
            # the supervisor's unit durations and the sentinel's compile
            # seconds (which feed through `observe_duration` -> the
            # process engine) land on THESE specs, not the defaults.
            # Restored at close() if still installed.
            from yuma_simulation_tpu_torch.telemetry.slo import set_slo_engine

            self._slo_previous = set_slo_engine(self.slo)
            self._slo_installed = True
        else:
            self.slo = get_slo_engine()
        # SLO transitions are typed ledger events: alert + recovery land
        # in the request ledger under their own span. Unhooked at
        # close() so a later service sharing the process engine can
        # claim the hook.
        if self.slo.on_transition is None:
            self.slo.on_transition = self._slo_transition
        #: Per-request ingress runs continuing REMOTE traces — held for
        #: the bundle publish so their spans resolve; flushed to disk in
        #: batches so a long-lived server's memory stays bounded. The
        #: publish lock serializes flush vs close: two concurrent
        #: read-merge-write passes over one spans.jsonl would drop
        #: whichever batch lands first.
        self._ingress_lock = threading.Lock()
        self._ingress_runs: list = []
        self._publish_lock = threading.Lock()
        self.started_t = time.time()
        self.quotas = TenantQuotas(
            rate=self.config.tenant_rate,
            burst=self.config.tenant_burst,
            overrides=self.config.tenant_overrides,
        )
        self.queue = BoundedRunQueue(
            self.config.queue_limit,
            drain_estimate_seconds=self.config.drain_estimate_seconds,
            registry=self.registry,
        )
        self.breaker = CircuitBreaker(
            threshold=self.config.breaker_threshold,
            cooldown_seconds=self.config.breaker_cooldown_seconds,
            registry=self.registry,
        )
        bundle_dir = self.config.bundle_dir
        if bundle_dir is not None:
            pathlib.Path(bundle_dir).mkdir(parents=True, exist_ok=True)
        # Continuous-telemetry mode: resolve the rotation policy ONCE
        # (config wins, env opt-in otherwise) and thread it through
        # every FlightRecorder this service constructs, so the flush
        # path and the close publish agree on the bundle's layout.
        self._rotation = None
        if bundle_dir is not None:
            from yuma_simulation_tpu_torch.telemetry.flight import (
                FlightRecorder,
                RotationPolicy,
                rotation_from_env,
            )

            fr = self.config.flight_rotation
            if fr is True:
                self._rotation = RotationPolicy()
            elif fr:
                self._rotation = fr
            else:
                self._rotation = rotation_from_env()
            if self._rotation is not None:
                # Pin the service's lifetime run: retention must never
                # reclaim a sealed segment this run's records live in
                # while the service is still up.
                FlightRecorder(
                    bundle_dir, rotation=self._rotation
                ).mark_run_open(self.run.run_id)
        # The live ops plane (GET /debug/vars, /debug/spans, POST
        # /debug/profile): transport-free; the HTTP layer mounts it.
        from yuma_simulation_tpu_torch.telemetry.ops import OpsPlane

        self.ops = OpsPlane(
            bundle_dir,
            registry=self.registry,
            slo_engine=self.slo,
            run=self.run,
        )
        self.ledger = FailureLedger(
            pathlib.Path(bundle_dir) / "ledger.jsonl"
            if bundle_dir is not None
            else None
        )
        self._ledger_lock = threading.Lock()
        # Eager registration: the acceptance surface (queue depth, shed
        # count, breaker state) must appear on /metrics from request
        # zero, not after the first increment.
        self._requests_total = self.registry.counter(
            "serve_requests_total", help="serving-tier requests handled"
        )
        self._admission_rejected = self.registry.counter(
            "serve_admission_rejected",
            help="typed admission rejections (pre-compile)",
        )
        self._coalesced_lanes = self.registry.counter(
            "serve_coalesced_lanes",
            help="requests donor-packed into a shared dispatch",
        )
        self._request_seconds = self.registry.histogram(
            "serve_request_seconds",
            help="request wall time, admission to reply",
        )
        # The background numerics canary (ticked from the dispatcher's
        # idle loop): warm shape buckets round-robined, per-tick state
        # surfaced on /healthz, serialized sketch records stashed for
        # the bundle's numerics.jsonl.
        self._canary_lock = threading.Lock()
        self._canary_buckets: dict[str, tuple] = {}
        self._canary_order: list[str] = []
        self._canary_idx = 0
        self._canary_last = time.monotonic()
        self._canary_state: dict = {
            "ticks": 0, "drift": 0, "last_bucket": None,
        }
        self._numerics_lock = threading.Lock()
        self._numerics_records: list = []
        self._canary_ticks_metric = self.registry.counter(
            "serve_canary_ticks",
            help="background numerics-canary bucket re-executions",
        )
        self._canary_drift_metric = self.registry.counter(
            "serve_canary_drift",
            help="canary comparisons that confirmed numerics drift",
        )
        for shape in self.config.warmup_shapes:
            self._remember_canary_bucket(shape, "Yuma 1 (paper)")
        # The chain-replay mount: archive + state cache
        # behind one facade; what-ifs dispatch through the ordinary
        # admission -> queue -> dispatcher pipeline, so quotas, SLO
        # shedding, deadlines, and the flight bundle cover them too.
        self.replay = None
        if self.config.replay_archive_dir and self.config.replay_cache_dir:
            from yuma_simulation_tpu_torch.replay import ReplayService

            self.replay = ReplayService(
                self.config.replay_archive_dir,
                self.config.replay_cache_dir,
                window=self.config.replay_window,
                epochs_per_snapshot=self.config.replay_epochs_per_snapshot,
                stride=self.config.replay_stride,
                max_baselines=self.config.replay_max_baselines,
                device=self.device,
            )
        self._counter = itertools.count(1)
        self._stopping = False
        self._closed = False
        if self.config.warmup_shapes:
            with self.run.activate():
                warmup(self.config.warmup_shapes, device=self.device)
        self._dispatcher: Optional[threading.Thread] = None
        if self.config.start_dispatcher:
            self.start_dispatcher()

    def start_dispatcher(self) -> None:
        """Start the queue-draining dispatcher thread (idempotent).
        Split from construction so tests — and a future multi-process
        pre-fork — can fill the queue deterministically first."""
        if self._dispatcher is not None:
            return
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop,
            name="yuma-serve-dispatcher",
            daemon=True,
        )
        self._dispatcher.start()

    # -- bookkeeping -----------------------------------------------------

    def _append_ledger(self, event: str, **fields) -> None:
        with self._ledger_lock:
            self.ledger.append(event, **fields)

    def _append_ledger_rootspan(self, event: str, **fields) -> None:
        """A ledger record under its own fresh root span of the SERVICE
        run — for records born outside any request span (401s rejected
        before the pipeline, pool lifecycle events), which must still
        resolve under ``obsreport --check``'s span gate."""
        from yuma_simulation_tpu_torch.telemetry.runctx import span

        with self.run.activate():
            with span(f"{event}:{fields.get('request', '')}", root=True):
                self._append_ledger(event, **fields)

    def _slo_transition(self, rec: dict) -> None:
        """The burn-rate engine's alert hook: every transition is a
        typed ledger record under its own span of the SERVICE run (a
        transition may fire from any handler thread, traced or not)."""
        from yuma_simulation_tpu_torch.telemetry.runctx import span

        with self.run.activate():
            # root=True: a transition may fire mid-request of a CONTINUED
            # trace, where the innermost span belongs to the caller's
            # run — inheriting it would record an unresolvable parent.
            with span(f"slo:{rec['slo']}", root=True, state=rec["to"]):
                self._append_ledger(
                    "slo_alert" if rec["to"] != "ok" else "slo_recovered",
                    slo=rec["slo"],
                    state=rec["to"],
                    was=rec["from"],
                    burn_rate=rec["burn_rate"],
                )

    def mint_request_id(self) -> str:
        """Process-unique request id — the HTTP layer mints one per
        connection-handled request so even pre-pipeline rejections
        (404/413/bad JSON) echo ``X-Request-Id``."""
        return f"r{next(self._counter):06d}"

    def _remember_ingress(self, run) -> None:
        """Keep a completed ingress run (a remote trace's request spans)
        for the bundle publish; flush batches to disk so memory stays
        bounded on a long-lived server."""
        flush = None
        with self._ingress_lock:
            self._ingress_runs.append(run)
            if len(self._ingress_runs) > 256:
                flush, self._ingress_runs = self._ingress_runs, []
        if flush and self.config.bundle_dir is not None:
            from yuma_simulation_tpu_torch.telemetry.flight import FlightRecorder

            try:
                with self._publish_lock:
                    # Append-only (no whole-file merge) so the unlucky
                    # 257th request's handler thread pays O(batch), not
                    # O(total-spans); close() merge-republishes. Under
                    # rotation everything lands in the LIVE segment, so
                    # the cost stays O(batch) however many sealed
                    # segments have accumulated.
                    rec = FlightRecorder(
                        self.config.bundle_dir, rotation=self._rotation
                    )
                    rec.append_spans(flush)
                    rec.snapshot_metrics(
                        self.registry, run_id=self.run.run_id
                    )
                    rec.record_slo(self.slo, run_id=self.run.run_id)
                    with self._numerics_lock:
                        nrecs = self._numerics_records
                        self._numerics_records = []
                    # Append-only here too: close() merge-dedupes.
                    rec.append_numerics(nrecs, run_id=self.run.run_id)
            except Exception:
                logger.warning(
                    "ingress span flush failed for %s",
                    self.config.bundle_dir,
                    exc_info=True,
                )

    # -- the request pipeline -------------------------------------------

    def handle(
        self, kind: str, payload, *, request_id=None, trace=None,
        api_key=None,
    ) -> tuple[int, dict, dict]:
        """One request, end to end; returns `(status, body, headers)`.
        Total by construction: every exit path is a typed JSON body
        carrying ``X-Request-Id`` (and ``Server-Timing`` with the
        request's critical-path breakdown once it was dispatched).

        `trace` (a :class:`..telemetry.propagation.TraceContext` or a
        raw traceparent header value) JOINS the caller's distributed
        trace: the request span tree roots under the caller's span in
        the caller's run, published into this server's flight bundle."""
        from yuma_simulation_tpu_torch.telemetry.propagation import (
            TraceContext,
            child_run,
            span_prefix_for,
        )
        from yuma_simulation_tpu_torch.telemetry.runctx import span

        if isinstance(trace, str):
            trace = TraceContext.from_traceparent(trace)
        rid = request_id if request_id else self.mint_request_id()
        t0 = time.perf_counter()
        t_wall0 = time.time()
        self._requests_total.inc()
        if self.keyring is not None:
            # Keys configured: the VERIFIED key is the tenant identity.
            # The payload's claimed tenant/priority is overwritten (not
            # merely clamped) before admission ever sees it — an
            # unauthenticated request is a typed 401, never a silent
            # fall-through to the anonymous tenant's quota.
            resolved = self.keyring.resolve(api_key)
            if resolved is None:
                self._append_ledger_rootspan(
                    "request_done",
                    request=rid,
                    tenant="<unauthenticated>",
                    endpoint=kind,
                    status=401,
                    outcome="rejected",
                )
                return (
                    401,
                    {
                        "status": "rejected",
                        "error": "Unauthenticated",
                        "message": "a valid X-Api-Key is required by "
                        "this deployment",
                        "request_id": rid,
                    },
                    {"X-Request-Id": rid},
                )
            if isinstance(payload, dict):
                payload = dict(payload, tenant=resolved)
            else:
                payload = {"tenant": resolved}
        tenant = (
            payload.get("tenant", "anonymous")
            if isinstance(payload, dict)
            else "anonymous"
        )
        if trace is not None:
            run = child_run(trace, prefix=span_prefix_for())
            cm = run
            ingress = run
        else:
            run = self.run
            cm = self.run.activate()
            ingress = None
        with cm:
            with span(
                f"request:{rid}", tenant=tenant, endpoint=kind, request=rid
            ) as s:
                pending = None
                try:
                    status, body, headers, pending = self._handle_inner(
                        kind, payload, rid, tenant
                    )
                except BaseException as exc:  # noqa: BLE001 — typed below
                    # The no-bare-500 backstop: anything the pipeline
                    # did not already structure becomes a typed failure
                    # body here.
                    logger.exception("unhandled serve failure for %s", rid)
                    status, body = self._failure_response(exc, rid)
                    headers = {}
                if s is not None:
                    s.attrs["status"] = status
                    s.attrs["outcome"] = body.get("status", "?")
                timing = self._record_phases(
                    run, s, pending, t_wall0, time.time()
                )
                headers = dict(headers)
                headers.setdefault("X-Request-Id", rid)
                if timing:
                    headers.setdefault("Server-Timing", timing)
                self._append_ledger(
                    "request_done",
                    request=rid,
                    tenant=tenant,
                    endpoint=kind,
                    status=status,
                    outcome=body.get("status", "?"),
                )
        elapsed = time.perf_counter() - t0
        self._request_seconds.observe(elapsed)
        # The SLO signals: request latency, error rate (5xx), shed rate.
        self.slo.observe("serve_request_seconds", elapsed)
        self.slo.event("serve_request_ok", status < 500)
        self.slo.event("serve_admitted", status != 429)
        if ingress is not None:
            self._remember_ingress(ingress)
        return status, body, headers

    def _record_phases(
        self, run, request_span, pending, t_wall0: float, t_wall1: float
    ) -> str:
        """Synthesize the request's critical-path child spans from the
        dispatcher's timestamps and return the ``Server-Timing`` header
        value (RFC 9211 metric syntax, durations in ms)."""
        parts = []
        parent = request_span.span_id if request_span is not None else ""

        def phase(name: str, t0, t1, **attrs) -> None:
            if t0 is None or t1 is None or t1 < t0:
                return
            run.record_span(name, t0, t1, parent_id=parent, **attrs)
            parts.append(f"{name};dur={1000.0 * (t1 - t0):.1f}")

        if pending is not None and pending.t_exec_end is not None:
            phase("queue", pending.t_enqueued, pending.t_taken)
            phase("coalesce", pending.t_taken, pending.t_exec_start)
            if pending.compile_seconds > 0 and pending.t_exec_start is not None:
                phase(
                    "compile",
                    pending.t_exec_start,
                    pending.t_exec_start + pending.compile_seconds,
                )
            else:
                parts.append("compile;dur=0.0")
            phase(
                "execute",
                pending.t_exec_start,
                pending.t_exec_end,
                compile_s=round(pending.compile_seconds, 6),
            )
        parts.append(f"total;dur={1000.0 * (t_wall1 - t_wall0):.1f}")
        return ", ".join(parts)

    def _handle_inner(
        self, kind: str, payload, rid: str, tenant: str
    ) -> tuple[int, dict, dict, Optional[_Pending]]:
        if self._stopping:
            return (
                503,
                {
                    "status": "shutting_down",
                    "error": "ServiceUnavailable",
                    "message": "the service is draining; retry elsewhere",
                    "request_id": rid,
                },
                {"Retry-After": "5"},
                None,
            )
        try:
            ticket = admit(
                payload,
                request_id=rid,
                kind=kind,
                default_deadline_seconds=self.config.default_deadline_seconds,
                # Price sweeps at the unit size _execute_sweep dispatches.
                max_unit_lanes=self.config.max_batch * 8,
                tenant_priority=self.config.tenant_priority,
                replay=self.replay,
                device=self.device,
            )
        except AdmissionRejected as exc:
            self._admission_rejected.inc()
            body = {
                "status": "rejected",
                "error": "AdmissionRejected",
                "reason": exc.reason,
                "message": str(exc),
                "request_id": rid,
            }
            if exc.suggestion:
                body["suggestion"] = exc.suggestion
            return 400, body, {}, None

        # Deterministic overload drill (test-only hook, one `is None`
        # check in production): push the armed burst of synthetic
        # requests through the same quota/queue path first, so the shed
        # and breaker responses below are exercised under real pressure.
        from yuma_simulation_tpu_torch.resilience import faults

        overload = faults.active_overload_fault()
        if overload is not None:
            self._inject_overload(overload)

        try:
            # SLO-driven degradation FIRST: while a degrade=True SLO
            # fast-burns, lowest-priority work sheds here — before it
            # can fill the queue and before the quota spends a token on
            # work the service has already decided to drop.
            burning = self.slo.degraded()
            if burning and ticket.priority < self.config.shed_priority_below:
                raise SloShed(
                    f"SLO fast burn ({', '.join(burning)}): shedding "
                    f"priority<{self.config.shed_priority_below} work",
                    retry_after=self.config.slo_shed_retry_after,
                    slos=burning,
                )
            try:
                self.quotas.admit(ticket.tenant)
            except QueueOverflow:
                # The queue's put() counts its own sheds; quota sheds
                # ride the same counter from here.
                self.queue.record_shed()
                raise
            pending = _Pending(ticket)
            self.queue.put(pending)
        except QueueOverflow as exc:
            retry_after = max(0.1, exc.retry_after)
            if isinstance(exc, SloShed):
                self.queue.record_shed()
            shed_fields = {}
            if isinstance(exc, SloShed):
                shed_fields["slos"] = list(exc.slos)
            self._append_ledger(
                "request_shed",
                request=rid,
                tenant=ticket.tenant,
                retry_after=round(retry_after, 3),
                **shed_fields,
            )
            body = {
                "status": "shed",
                "error": type(exc).__name__,
                "message": str(exc),
                "retry_after": retry_after,
                "request_id": rid,
            }
            if isinstance(exc, SloShed):
                body["slo"] = list(exc.slos)
            return (
                429,
                body,
                {"Retry-After": str(int(math.ceil(retry_after)))},
                None,
            )

        if not pending.done.wait(self._wall_cap(ticket)):
            return (
                504,
                {
                    "status": "failed",
                    "error": "DeadlineExhausted",
                    "message": "the request did not complete within its "
                    "deadline envelope",
                    "retryable": True,
                    "request_id": rid,
                },
                {},
                pending,
            )
        headers = {}
        assert pending.status is not None and pending.response is not None
        if "retry_after" in pending.response:
            headers["Retry-After"] = str(
                int(math.ceil(pending.response["retry_after"]))
            )
        return pending.status, pending.response, headers, pending

    def _wall_cap(self, ticket: AdmissionTicket) -> float:
        """The handler's rendezvous bound: generous enough for a full
        supervised ladder walk (attempts x rungs x (budget + grace)),
        finite so a lost dispatcher cannot hold a connection forever."""
        return 12.0 * ticket.deadline_seconds + 60.0

    def _inject_overload(self, fault) -> None:
        """The armed OverloadFault's synthetic burst: N tiny admitted
        tickets through the real queue (sheds counted on the same
        metrics the drill asserts on). Synthetic pendings execute and
        are dropped — nobody waits on them."""
        for i in range(fault.requests):
            try:
                ticket = admit(
                    {
                        "tenant": fault.tenant,
                        "case": "Case 1",
                        "deadline_seconds": 30,
                    },
                    request_id=f"synthetic-{i:04d}",
                    kind="simulate",
                    default_deadline_seconds=30.0,
                    device=self.device,
                )
            except AdmissionRejected:  # pragma: no cover — Case 1 is valid
                return
            try:
                self.queue.put(_Pending(ticket, synthetic=True))
            except QueueOverflow:
                continue  # counted by the queue; keep pushing the burst

    # -- the background numerics canary ---------------------------------

    def _remember_canary_bucket(self, shape, version: str) -> None:
        """Register a warm `(E, V, M)` shape as a canary target (warmup
        shapes at startup, every successfully dispatched simulate shape
        thereafter)."""
        try:
            E, V, M = (int(d) for d in shape)
        except (TypeError, ValueError):
            return
        key = f"{E}x{V}x{M}"
        with self._canary_lock:
            if key in self._canary_buckets:
                # Most-recently-dispatched rotates to the back, so the
                # eviction below sheds the coldest bucket, not a hot one.
                self._canary_order.remove(key)
            self._canary_buckets[key] = ((E, V, M), version)
            self._canary_order.append(key)
            # LRU bound: a hostile (or merely varied) client shedding a
            # fresh shape per request must not grow the rotation — or
            # the per-tick cold compiles that come with it — without
            # limit. 32 warm buckets is far past any real serving mix.
            while len(self._canary_order) > 32:
                evicted = self._canary_order.pop(0)
                del self._canary_buckets[evicted]

    def _stash_numerics(self, records) -> None:
        """Hold serialized sketch records for the bundle publish (close
        + the periodic ingress flush); bounded — the on-disk merge keys
        by (unit, stream, role, label), so only the newest capture per
        identity survives anyway."""
        if not records:
            return
        with self._numerics_lock:
            self._numerics_records.extend(records)
            del self._numerics_records[:-4096]

    def _maybe_canary(self) -> None:
        """Dispatcher-idle hook: tick the canary when the interval has
        elapsed. Never raises — the canary observes the service, it must
        not take it down."""
        if self.config.canary_interval_seconds <= 0 or self._stopping:
            return
        now = time.monotonic()
        with self._canary_lock:
            due = (
                bool(self._canary_order)
                and now - self._canary_last
                >= self.config.canary_interval_seconds
            )
            if due:
                self._canary_last = now
        if not due:
            return
        try:
            self.run_canary_once()
        except Exception:
            logger.warning("serve numerics canary tick failed", exc_info=True)

    def run_canary_once(self) -> Optional[dict]:
        """Force one canary tick through the next warm bucket (the smoke
        drill's deterministic entry point; production ticks ride the
        dispatcher's idle loop on ``canary_interval_seconds``). Returns
        the canary state snapshot, or None when nothing could run (no
        warm buckets, numerics capture disabled)."""
        from yuma_simulation_tpu_torch.telemetry.numerics import numerics_enabled

        if not numerics_enabled():
            return None
        with self._canary_lock:
            if not self._canary_order:
                return None
            key = self._canary_order[self._canary_idx % len(self._canary_order)]
            self._canary_idx += 1
            shape, version = self._canary_buckets[key]
        return self._canary_tick(key, shape, version)

    def _canary_tick(self, key: str, shape: tuple, version: str) -> dict:
        """One cross-engine canary comparison on a warm bucket: the
        plan's primary rung vs its demoted rung over the same
        deterministic workload, compared fingerprint-by-fingerprint per
        epoch. See ``ServeConfig.canary_interval_seconds`` for what a
        confirmed drift drives. On the card both rungs are kernels (the
        planner's ladder there stops at the last kernel rung): K3 against
        the next kernel rung below it, never against the eager rung."""
        from yuma_simulation_tpu_torch.models.config import YumaConfig
        from yuma_simulation_tpu_torch.models.variants import variant_for_version
        from yuma_simulation_tpu_torch.resilience import faults
        from yuma_simulation_tpu_torch.scenarios.base import Scenario
        from yuma_simulation_tpu_torch.simulation.planner import plan_dispatch
        from yuma_simulation_tpu_torch.simulation.sweep import (
            simulate_batch,
            stack_scenarios,
        )
        from yuma_simulation_tpu_torch.telemetry.numerics import (
            compare_sketches,
            sketch_records,
            to_host,
        )
        from yuma_simulation_tpu_torch.telemetry.runctx import span

        E, V, M = shape
        spec = variant_for_version(version)
        config = YumaConfig()
        validators = [f"v{i}" for i in range(V)]
        scenario = Scenario(
            name=f"canary:{key}",
            validators=validators,
            base_validator=validators[0],
            weights=np.zeros((E, V, M), np.float32),
            stakes=np.ones((E, V), np.float32),
            num_epochs=E,
        )
        W, S, ri, re = stack_scenarios([scenario], device=self.device)
        plan = plan_dispatch(
            f"serve_canary:{key}", (1, E, V, M), spec, config, W.dtype,
            check_memory=False, device=self.device,
        )
        ladder = self.breaker.filter_ladder(plan.ladder)
        primary_rung = ladder[0]
        canary_rung = ladder[1] if len(ladder) > 1 else ladder[-1]
        label = f"canary:{key}"
        with self.run.activate():
            # root=True: the tick runs on the dispatcher thread between
            # requests; it must not parent under whatever span a traced
            # request last left behind.
            with span(
                label, root=True, primary=primary_rung, canary=canary_rung
            ):
                try:
                    ys_a = simulate_batch(
                        W, S, ri, re, config, spec,
                        epoch_impl=primary_rung,
                    )
                    self._synchronize()
                    with faults.canary_scope():
                        ys_b = simulate_batch(
                            W, S, ri, re, config, spec,
                            epoch_impl=canary_rung,
                        )
                        self._synchronize()
                except BaseException:
                    # A tick that DIED is not drift evidence; release a
                    # half-open probe latch the filter may have taken.
                    self.breaker.abort_probe(primary_rung)
                    raise
                primary = to_host(ys_a["numerics"])
                canary = to_host(ys_b["numerics"])
                self._stash_numerics(
                    sketch_records(
                        primary, unit=0, lanes=(0, 1), engine=primary_rung,
                        role="primary", label=label,
                    )
                    + sketch_records(
                        canary, unit=0, lanes=(0, 1), engine=canary_rung,
                        role="canary", label=label,
                    )
                )
                divergences = compare_sketches(primary, canary)
                self._canary_ticks_metric.inc()
                with self._canary_lock:
                    self._canary_state["ticks"] += 1
                    self._canary_state["last_bucket"] = key
                self.slo.event("engine_drift_ok", not divergences)
                if not divergences:
                    self.breaker.record_success(primary_rung)
                    self._append_ledger(
                        "canary_ok",
                        bucket=key,
                        primary_engine=primary_rung,
                        canary_engine=canary_rung,
                    )
                else:
                    self._canary_drift_metric.inc(len(divergences))
                    with self._canary_lock:
                        self._canary_state["drift"] += len(divergences)
                    # Confirmed drift counts as a primary-rung failure:
                    # after `threshold` confirming ticks the rung trips
                    # open fleet-wide and plans re-anchor below it.
                    self.breaker.record_failure(primary_rung)
                    for stream, lanes in sorted(divergences.items()):
                        first = lanes[0]
                        self._append_ledger(
                            "engine_drift",
                            bucket=key,
                            stream=stream,
                            primary_engine=primary_rung,
                            canary_engine=canary_rung,
                            lanes=[
                                [
                                    d["lane"],
                                    d["first_divergent_epoch"],
                                    d["ulp_distance"],
                                ]
                                for d in lanes
                            ],
                        )
                        log_event(
                            logger,
                            "engine_drift",
                            level=logging.ERROR,
                            bucket=key,
                            stream=stream,
                            primary=primary_rung,
                            canary=canary_rung,
                            lane=first["lane"],
                            epoch=first["first_divergent_epoch"],
                            ulp=first["ulp_distance"],
                        )
        with self._canary_lock:
            return dict(self._canary_state)

    def _synchronize(self) -> None:
        """Wait for the service's device (the JAX package's
        ``block_until_ready``); nothing to wait for on the CPU."""
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    # -- dispatcher ------------------------------------------------------

    def _dispatch_loop(self) -> None:
        with self.run.activate():
            while True:
                item = self.queue.get(timeout=0.05)
                if item is None:
                    if self._stopping:
                        return
                    self._maybe_canary()
                    continue
                item.t_taken = time.time()
                if self._stopping:
                    item.resolve(
                        503,
                        {
                            "status": "shutting_down",
                            "error": "ServiceUnavailable",
                            "message": "the service is draining",
                            "request_id": item.ticket.request_id,
                        },
                    )
                    continue
                group = gather_group(
                    self.queue,
                    item,
                    window_seconds=self.config.coalesce_window_seconds,
                    # The sharded path stacks raw shapes (no donor-pack
                    # miner masks), so a mesh-backed service dispatches
                    # solo — bucket-mates may differ in raw [V, M].
                    max_batch=(
                        1 if self.config.mesh is not None
                        else self.config.max_batch
                    ),
                )
                self._execute_group(group)

    def _execute_group(self, group: list) -> None:
        from yuma_simulation_tpu_torch.telemetry.runctx import span

        first = group[0].ticket
        now = time.time()
        compile_hist = self.registry.histogram(
            "compile_seconds",
            help=(
                "wall seconds of sentinel regions that added "
                "jit-cache entries (compile-time upper bound)"
            ),
        )
        compile_before = compile_hist.snapshot()["sum"]
        for p in group:
            # Coalesce-gathered members were taken off the queue by
            # gather_group, not the dispatcher's get(): stamp them now.
            if p.t_taken is None:
                p.t_taken = now
            p.t_exec_start = now
        with span(
            f"dispatch:{first.kind}",
            requests=[p.ticket.request_id for p in group],
            bucket=first.plan.bucket.key,
        ):
            try:
                if first.kind == "simulate":
                    self._execute_simulate(group)
                elif first.kind == "sweep":
                    self._execute_sweep(group[0])
                elif first.kind == "whatif":
                    self._execute_whatif(group[0])
                else:
                    self._execute_table(group[0])
            except BaseException as exc:  # noqa: BLE001 — typed below
                logger.warning(
                    "serve dispatch failed for %s",
                    [p.ticket.request_id for p in group],
                    exc_info=True,
                )
                for p in group:
                    status, body = self._failure_response(
                        exc, p.ticket.request_id
                    )
                    p.resolve(status, body)
            finally:
                t_end = time.time()
                compile_delta = max(
                    0.0, compile_hist.snapshot()["sum"] - compile_before
                )
                for p in group:
                    if p.t_exec_end is None:
                        p.t_exec_end = t_end
                    p.compile_seconds = compile_delta

    def _remaining_or_fail(self, group: list) -> Optional[float]:
        """The batch's conservative remaining deadline (the tightest
        member's). Exhausted -> every member resolved 504 and None."""
        remaining = min(p.ticket.remaining_seconds() for p in group)
        if remaining <= 0.05:
            for p in group:
                p.resolve(
                    504,
                    {
                        "status": "failed",
                        "error": "DeadlineExhausted",
                        "message": "the deadline expired while queued",
                        "retryable": True,
                        "request_id": p.ticket.request_id,
                    },
                )
            return None
        return remaining

    def _supervisor(
        self, *, engine: str, quarantine: bool, remaining: float, unit_size: int
    ):
        from yuma_simulation_tpu_torch.resilience.retry import default_retry_policy
        from yuma_simulation_tpu_torch.resilience.supervisor import SweepSupervisor
        from yuma_simulation_tpu_torch.resilience.watchdog import Deadline

        return SweepSupervisor(
            directory=None,
            unit_size=unit_size,
            deadline=Deadline(
                budget_seconds=max(0.1, remaining),
                grace_seconds=max(0.1, remaining),
            ),
            retry_policy=default_retry_policy(),
            quarantine=quarantine,
            elastic=self.config.elastic,
            engine=engine,
        )

    def _feed_breaker(self, start_rung: str, report) -> None:
        if report.engine_demotions > 0:
            self.breaker.record_failure(start_rung)
            for rung in report.engines_used:
                if rung != start_rung:
                    self.breaker.record_success(rung)
        else:
            self.breaker.record_success(start_rung)

    def _execute_simulate(self, group: list) -> None:
        remaining = self._remaining_or_fail(group)
        if remaining is None:
            return
        first = group[0].ticket
        ladder = self.breaker.filter_ladder(first.plan.ladder)
        start = ladder[0]
        # The plan this dispatch actually runs: the admission plan,
        # re-anchored below any tripped rung. record() stamps it (with
        # the breaker's WHY) on the dispatch span, so flight bundles
        # show which rung ran and on what grounds.
        plan = first.plan.demoted(start)
        plan.record()
        quarantine = first.quarantine and start == "eager"
        pack = start == "eager" and self.config.mesh is None
        real = sum(1 for p in group if not p.synthetic)
        sup = self._supervisor(
            engine=start,
            quarantine=quarantine,
            remaining=remaining,
            unit_size=max(1, len(group)),
        )
        try:
            out = sup.run_batch(
                [p.ticket.scenario for p in group],
                first.version,
                first.config,
                mesh=self.config.mesh if start == "eager" else None,
                tag=f"serve:{first.plan.bucket.key}",
                pack=pack,
                device=self.device,
            )
        except BaseException as exc:
            typed = classify_failure(exc)
            if isinstance(typed, EngineFailure):
                self.breaker.record_failure(start)
            else:
                # A failure the breaker must not count (caller error,
                # unclassified crash) still has to release a half-open
                # probe latch, or the rung stays dead forever.
                self.breaker.abort_probe(start)
            raise
        report = out["report"]
        self._feed_breaker(start, report)
        self._stash_numerics(out.get("numerics_records"))
        self._remember_canary_bucket(
            np.shape(first.scenario.weights), first.version
        )
        if real > 1:
            self._coalesced_lanes.inc(real)
        dividends = np.asarray(out["dividends"])
        entries = out["quarantine"].entries
        for lane, p in enumerate(group):
            if p.synthetic:
                p.resolve(200, {"status": "ok", "synthetic": True})
                continue
            p.resolve(
                200,
                slice_simulate_response(
                    dividends,
                    lane,
                    p.ticket,
                    quarantine_entries=entries,
                    report=report,
                    coalesced=real,
                ),
            )

    def _execute_sweep(self, pending: _Pending) -> None:
        remaining = self._remaining_or_fail([pending])
        if remaining is None:
            return
        t = pending.ticket
        from yuma_simulation_tpu_torch.simulation.sweep import config_grid

        configs, points = config_grid(**t.axes)
        sup = self._supervisor(
            engine="eager",
            quarantine=t.quarantine,
            remaining=remaining,
            unit_size=max(1, min(len(points), self.config.max_batch * 8)),
        )
        out = sup.run_grid(
            t.scenario, t.version, configs, tag=f"serve:sweep:{t.request_id}",
            device=self.device,
        )
        # Re-label the numerics captures by shape bucket, not request id:
        # the on-disk merge keys by label, so per-request labels would
        # grow numerics.jsonl without bound on a long-lived server
        # (newest capture per bucket is all the drift render needs —
        # spans keep the per-request identity).
        self._stash_numerics(
            [
                {**rec, "label": f"serve:sweep:{t.plan.bucket.key}"}
                for rec in out.get("numerics_records") or ()
            ]
        )
        report = out["report"]
        dividends = np.asarray(out["dividends"])  # [P, E, V]
        entries = out["quarantine"].entries
        quarantined_points = sorted({e.case for e in entries})
        body = {
            "status": "partial" if quarantined_points else "ok",
            "request_id": t.request_id,
            "tenant": t.tenant,
            "points": points,
            "total_dividends": dividends.sum(axis=1).tolist(),  # [P, V]
            "degraded": not report.clean,
            "report": {
                "stalls_killed": report.stalls_killed,
                "engine_demotions": report.engine_demotions,
                "mesh_shrinks": report.mesh_shrinks,
                "units_retried": report.units_retried,
                "lanes_quarantined": report.lanes_quarantined,
                "engines_used": list(report.engines_used),
            },
        }
        if quarantined_points:
            body["quarantined_points"] = [int(i) for i in quarantined_points]
        pending.resolve(200, body)

    def _execute_whatif(self, pending: _Pending) -> None:
        remaining = self._remaining_or_fail([pending])
        if remaining is None:
            return
        t = pending.ticket
        assert self.replay is not None and t.whatif is not None
        from yuma_simulation_tpu_torch.resilience.watchdog import (
            Deadline,
            run_with_deadline,
        )

        result = run_with_deadline(
            lambda: self.replay.whatif(t.whatif),
            Deadline(budget_seconds=max(0.1, remaining)),
            label=f"serve:whatif:{t.request_id}",
        )
        full_epochs = result.epochs_simulated + result.epochs_saved
        # The per-request replay ledger record obsreport's replay
        # section aggregates: cache effectiveness and the suffix-vs-full
        # epoch savings, per tenant.
        self._append_ledger(
            "whatif_served",
            request=t.request_id,
            tenant=t.tenant,
            netuid=t.whatif.netuid,
            version=t.whatif.version,
            cache_hit=result.cache_hit,
            resume_epoch=result.resume_epoch,
            suffix_epochs=result.epochs_simulated,
            full_epochs=full_epochs,
            epochs_saved=result.epochs_saved,
        )
        delta = result.dividend_delta
        pending.resolve(
            200,
            {
                "status": "ok",
                "request_id": t.request_id,
                "tenant": t.tenant,
                "netuid": t.whatif.netuid,
                "version": t.whatif.version,
                "spec_key": t.whatif.spec_key(),
                "from_epoch": t.whatif.from_epoch,
                "cache_hit": result.cache_hit,
                "resume_epoch": result.resume_epoch,
                "epochs_simulated": result.epochs_simulated,
                "epochs_saved": result.epochs_saved,
                "total_dividend_delta": [
                    float(x) for x in result.total_dividend_delta
                ],
                "total_incentive_delta": [
                    float(x) for x in result.total_incentive_delta
                ],
                "max_abs_dividend_delta": float(np.abs(delta).max()),
                "baseline_key": result.baseline_key,
            },
        )

    def replay_get(self, path: str) -> tuple[int, dict]:
        """The read-only replay surface (``GET /v1/replay`` index,
        ``GET /v1/replay/NETUID`` one timeline + its cached baselines)
        — index/meta reads only, served inline by the HTTP thread."""
        from yuma_simulation_tpu_torch.replay import ArchiveError

        if self.replay is None:
            return 404, {
                "status": "rejected",
                "error": "ReplayUnconfigured",
                "message": "this deployment mounts no replay tier",
            }
        tail = path[len("/v1/replay"):].strip("/")
        try:
            if not tail:
                return 200, {"status": "ok", **self.replay.index()}
            if not tail.isdigit():
                return 404, {
                    "status": "rejected",
                    "error": "NotFound",
                    "message": f"no replay route {path!r} (want "
                    "/v1/replay or /v1/replay/NETUID)",
                }
            return 200, {
                "status": "ok",
                **self.replay.timeline_info(int(tail)),
            }
        except ArchiveError as exc:
            return 404, {
                "status": "rejected",
                "error": "UnknownSubnet",
                "message": str(exc),
            }

    def _execute_table(self, pending: _Pending) -> None:
        remaining = self._remaining_or_fail([pending])
        if remaining is None:
            return
        t = pending.ticket
        from yuma_simulation_tpu_torch.models.config import YumaParams
        from yuma_simulation_tpu_torch.reporting.tables import (
            generate_total_dividends_table,
        )
        from yuma_simulation_tpu_torch.resilience.watchdog import (
            Deadline,
            run_with_deadline,
        )
        from yuma_simulation_tpu_torch.scenarios.base import get_cases

        versions = [(v, t.config.yuma_params or YumaParams()) for v in t.versions]
        df = run_with_deadline(
            lambda: generate_total_dividends_table(
                get_cases(), versions, t.config.simulation, device=self.device
            ),
            Deadline(budget_seconds=max(0.1, remaining)),
            label=f"serve:table:{t.request_id}",
        )
        pending.resolve(
            200,
            {
                "status": "ok",
                "request_id": t.request_id,
                "tenant": t.tenant,
                "versions": list(t.versions),
                # "%s": the shortest round-trip spelling of each float,
                # as pandas writes a float column without a format.
                "csv": df.to_csv(float_format="%s"),
            },
        )

    def _failure_response(self, exc: BaseException, rid: str) -> tuple[int, dict]:
        """Every non-admission failure as a typed body: classified
        engine failures are client-retryable 503s (the ladder already
        did its best — a later request may find a recovered rung),
        anything else a structured 503 naming the type. Never a bare
        500 with a traceback."""
        typed = classify_failure(exc)
        name = type(typed if typed is not None else exc).__name__
        return (
            503,
            {
                "status": "failed",
                "error": name,
                "message": str(exc)[:500],
                "retryable": isinstance(typed, EngineFailure),
                "request_id": rid,
            },
        )

    # -- ops surface -----------------------------------------------------

    def healthz(self) -> dict:
        slo_states = self.slo.evaluate()
        fast = sorted(
            name
            for name, s in slo_states.items()
            if s["state"] == "fast_burn"
        )
        degraded = [n for n in fast if slo_states[n]["degrade"]]
        if self._stopping:
            status = "draining"
        elif fast:
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            # Readiness: a fast-burning service is alive but should not
            # receive fresh low-priority traffic.
            "ready": not self._stopping and not fast,
            "uptime_seconds": round(time.time() - self.started_t, 3),
            "run_id": self.run.run_id,
            "queue_depth": len(self.queue),
            "queue_limit": self.queue.limit,
            "breaker": self.breaker.snapshot(),
            "requests_total": int(self._requests_total.value),
            "slo": {
                "states": {
                    name: s["state"] for name, s in slo_states.items()
                },
                "fast_burn": fast,
                "degraded": degraded,
            },
            "canary": self._canary_snapshot(),
            # Open-incident count from the bundle's durable
            # incidents.jsonl; the incidents_open gauge mirrors it so
            # /metrics scrapes agree with /healthz. 0 on a clean host
            # (the sink is never created without an incident).
            "incidents_open": self._incidents_open(),
        }

    def _incidents_open(self) -> int:
        from yuma_simulation_tpu_torch.telemetry.incident import (
            open_incident_count,
        )

        if self.config.bundle_dir is None:
            return 0
        try:
            count = open_incident_count(self.config.bundle_dir)
        except Exception:  # noqa: BLE001 — health must answer anyway
            logger.warning("incident count failed", exc_info=True)
            return 0
        self.registry.gauge(
            "incidents_open",
            help="correlated incidents currently open in this bundle",
        ).set(count)
        return count

    def warm_buckets(self) -> list[str]:
        """The `ExVxM` shape buckets this process holds warm (warmup
        shapes + every successfully dispatched simulate shape, most
        recent last) — advertised by scale-out workers so the router's
        claim scoring can prefer a worker that already ran the
        requested shape."""
        with self._canary_lock:
            return list(self._canary_order)

    def _canary_snapshot(self) -> dict:
        with self._canary_lock:
            return dict(
                self._canary_state,
                buckets=len(self._canary_order),
                enabled=self.config.canary_interval_seconds > 0,
            )

    def metrics_text(self) -> str:
        return self.registry.prometheus_text()

    def close(self) -> None:
        """Graceful shutdown: stop admitting, drain the queue (queued
        requests resolve with a structured shutting-down 503), publish
        the flight bundle. Idempotent."""
        if self._closed:
            return
        self._stopping = True
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=30.0)
        # The dispatcher drains on its way out; anything still queued
        # (dispatcher never started, or died) resolves here.
        for item in self.queue.take_matching(lambda _p: True):
            item.resolve(
                503,
                {
                    "status": "shutting_down",
                    "error": "ServiceUnavailable",
                    "message": "the service is draining",
                    "request_id": item.ticket.request_id,
                },
            )
        self._closed = True
        # Release the process-global SLO hooks: a later service in the
        # same process must be able to claim the transition hook, and
        # the supervisor/sentinel `observe_duration` feeds must fall
        # back to whatever engine was installed before us.
        # `==`, not `is`: each attribute access mints a fresh bound
        # method; equality compares the underlying (self, func) pair.
        if self.slo.on_transition == self._slo_transition:
            self.slo.on_transition = None
        if self._slo_installed:
            from yuma_simulation_tpu_torch.telemetry.slo import (
                peek_slo_engine,
                set_slo_engine,
            )

            if peek_slo_engine() is self.slo:
                set_slo_engine(self._slo_previous)
        if self.config.bundle_dir is not None:
            from yuma_simulation_tpu_torch.ops.launches import publish_launch_counts
            from yuma_simulation_tpu_torch.telemetry.flight import FlightRecorder

            try:
                # The dispatcher has stopped: this process launches no more
                # for this service, so its counts can be read after it exits.
                publish_launch_counts(self.config.bundle_dir)
            except Exception:
                logger.warning("launch-count publish failed", exc_info=True)
            with self._ingress_lock:
                ingress, self._ingress_runs = self._ingress_runs, []
            with self._numerics_lock:
                nrecs = self._numerics_records
                self._numerics_records = []
            try:
                with self._publish_lock:
                    recorder = FlightRecorder(
                        self.config.bundle_dir, rotation=self._rotation
                    )
                    recorder.record(
                        self.run,
                        registry=self.registry,
                        extra_runs=ingress,
                        slo_engine=self.slo,
                    )
                    recorder.record_numerics(nrecs, run_id=self.run.run_id)
                    if self._rotation is not None:
                        # Graceful exit: release the retention pin and
                        # seal the tail so the bundle on disk is whole
                        # (no torn live segment for the next reader).
                        recorder.mark_run_closed(self.run.run_id)
                        recorder.seal_live_segment()
            except Exception:
                logger.warning(
                    "serve flight-bundle publish failed for %s",
                    self.config.bundle_dir,
                    exc_info=True,
                )
        try:
            # Stop any in-flight profile window so the trace publishes
            # rather than tears with the process.
            self.ops.close()
        except Exception:
            logger.warning("ops-plane close failed", exc_info=True)
        log_event(
            logger,
            "serve_closed",
            level=logging.INFO,
            requests=int(self._requests_total.value),
        )

"""Deterministic fault injection — test-only hooks for the resilience tests
(the JAX package's `resilience/faults.py`).

Every recovery path in this layer (engine demotion, lane quarantine,
checkpoint requeue) exists because of failures a CPU test run cannot
naturally provoke: an out-of-memory kernel launch needs a real card, NaNs
need pathological inputs, torn checkpoint chunks need a crash at the wrong
instant. These hooks let a test provoke each one *on purpose and
deterministically*, so every ladder rung runs on the CPU and on the card:

- `FaultPlan.fused_oom_dispatches=N` — the first N fused-engine
  dispatches raise a simulated :class:`..errors.EngineResourceExhausted`
  before the kernel is entered;
- `FaultPlan.nan` — lane `case`'s per-epoch dividends are overwritten
  with NaN at epoch `epoch`, inside the eager rung's epoch step (a select
  on a per-lane poison epoch), so the quarantine carry sees the failure
  exactly where a real numerical blow-up would appear.
  The injection is at the step's outputs rather than its inputs by
  necessity: the consensus kernel is reference-faithfully
  NaN-sanitizing (`nan_to_num` on every bond normalization, `where`
  guards on every divide), so corrupted input weights/stakes are
  swallowed before they can reach an output — verified empirically; a
  genuinely propagating NaN needs a non-finite *hyperparameter*, which
  the quarantine tests also cover via a NaN config-grid lane;
- `FaultPlan.truncate_chunks` / `corrupt_chunks` — a just-published
  checkpoint chunk file is truncated / bit-flipped ONCE (simulating
  disk corruption between runs), so resume-time checksum verification
  and requeue are exercised end to end;
- `FaultPlan.stall` — the watchdog's worker thread sleeps through the
  deadline before the real dispatch (a simulated hung compile: no
  heartbeat, a typed `EngineStall` in the caller);
- `FaultPlan.device_loss` — every elastic sharded dispatch whose mesh
  still routes to the named device raises a simulated
  :class:`..errors.DeviceLossError`, until the mesh is rebuilt without
  it (the semantics of real hardware loss: only shrinking recovers);
- `FaultPlan.host_crash` — SIGKILL the current process (a simulated
  fleet host) after N lease claims, so the fleet drill proves lease
  EXPIRY recovers the dead host's units (no teardown code runs);
- `FaultPlan.lease_tear` — truncate the host's own live lease file
  after N heartbeat renewals (simulated shared-store corruption), so
  torn-lease tolerance and the LeaseExpired abandon path are exercised;
- `FaultPlan.overload` — a one-shot burst of synthetic requests at the
  serving tier's admission layer, so the 429/Retry-After shed path and
  the queue-depth/shed metrics are drill-able on the CPU;
- `FaultPlan.drift` — flip one lane's dividend by EXACTLY one ulp at a
  target epoch, inside numerics-canary re-executions ONLY
  (:func:`canary_scope` / :func:`active_drift_fault`), so the numerics
  flight recorder's whole drift pipeline — per-epoch fingerprints ->
  cross-engine canary -> typed ``engine_drift`` ledger event -> drift
  SLO -> ``driftreport --check`` — is drill-able on the CPU.

The hooks are consulted at host level by the engines and
`CheckpointedSweep`; with no plan armed (the production state) each is
a single `is None` check. Arm a plan only via the
:func:`inject_faults` context manager — it is process-global and
test-only by design, never part of a production configuration.

Hooks are INERT while `torch.compile` traces (:func:`_tracing_now`): a
hook firing at trace time would bake the armed plan (or its absence) into
a compiled graph, so a later call with the opposite arming state would
silently reuse the wrong program. Fault injection therefore targets the
host-level entry points only, which is where every resilience test drives
it. (The JAX package's probe of `jax.core.trace_state_clean` fails closed
on a jax without that name, and its hooks then never fire; the port
follows the intended behaviour.)
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import logging
import os
import sys
from typing import Optional

import torch

from yuma_simulation_tpu_torch.resilience.errors import (
    DeviceLossError,
    EngineResourceExhausted,
)
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class StallFault:
    """Hold the first `dispatches` supervised dispatches (after letting
    `skip` through) hostage for `seconds` of wall clock — a simulated
    hung compile/collective. The sleep happens on the watchdog's WORKER
    thread (:func:`maybe_stall_dispatch` is called there, host level,
    just before the real dispatch), so a deadline shorter than `seconds`
    sees exactly what a real hang produces: no heartbeat, an abandoned
    worker, a typed `EngineStall` in the caller."""

    seconds: float = 5.0
    dispatches: int = 1
    skip: int = 0


@dataclasses.dataclass(frozen=True)
class DeviceLossFault:
    """Simulate device `device_id` dropping out of the mesh: every
    elastic sharded dispatch whose mesh still contains that device
    raises a :class:`..errors.DeviceLossError` naming it. The fault
    keeps firing until the mesh no longer includes the device — exactly
    the semantics of real hardware loss (retrying on the same mesh
    cannot succeed; only shrinking recovers), so the drill proves the
    degradation actually happened rather than a lucky retry."""

    device_id: int


@dataclasses.dataclass(frozen=True)
class HostCrashFault:
    """SIGKILL the CURRENT PROCESS (a simulated fleet host) after it has
    claimed `after_claims` work-unit leases — the fleet drill's host
    loss. SIGKILL by design: no atexit, no finally, no lease release —
    exactly what a preempted VM or OOM-killed worker leaves behind, so
    the drill proves lease EXPIRY (not polite cleanup) is what recovers
    the unit. Consulted by the fabric scheduler via
    :func:`maybe_crash_host` immediately after a claim is ledgered, so
    the claim is durably visible to the survivors before the host
    dies."""

    after_claims: int = 1


@dataclasses.dataclass(frozen=True)
class LeaseTearFault:
    """Truncate the current host's OWN LIVE lease file to `keep_bytes`
    after its `after_renewals`-th heartbeat renewal — simulated shared-
    filesystem corruption of a claim record. A torn lease is unparseable
    to every scanner, which must treat it as stealable (corrupt claims
    cannot gate work forever); the original holder discovers the theft
    at its next renewal (identity mismatch -> typed
    :class:`..errors.LeaseExpired`) and abandons the unit without
    publishing. Consulted by the fabric lease store via
    :func:`maybe_tear_lease`."""

    after_renewals: int = 1
    keep_bytes: int = 8


@dataclasses.dataclass(frozen=True)
class OverloadFault:
    """Inject a deterministic BURST of synthetic requests at the serving
    tier's admission layer (:mod:`..serve`): the next real request first
    pushes `requests` synthetic tickets (tiny built-in scenario, tenant
    `tenant`) through the same quota + bounded-queue path it is about to
    take, so the shed/backpressure/breaker responses are drill-able on
    CPU CI without a real traffic generator. One-shot per armed plan —
    the burst fires exactly once, consumed via
    :func:`active_overload_fault`."""

    requests: int = 32
    tenant: str = "synthetic-burst"


@dataclasses.dataclass(frozen=True)
class NaNFault:
    """Poison scenario lane `case`'s dividends at epoch `epoch` (global
    epoch index). `case=None` targets a single-scenario run — or every
    lane of a batch."""

    epoch: int
    case: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DriftFault:
    """Flip scenario lane `case`'s dividend (validator 0) by EXACTLY
    one ulp at global epoch `epoch` — the smallest representable
    cross-engine drift, injected so CI proves the numerics flight
    recorder's whole pipeline (per-epoch fingerprints -> cross-engine
    canary -> typed ``engine_drift`` ledger event -> drift SLO ->
    ``driftreport --check`` exit != 0) detects real drift end to end.

    Scoped to CANARY re-executions only (:func:`canary_scope` /
    :func:`active_drift_fault`): a flip applied to both the primary and
    its canary would cancel in the comparison, so the fault fires only
    while a canary dispatch is executing — exactly modeling a demoted
    rung whose reduction spelling drifted from the primary's.
    `case=None` flips every lane of the canary batch."""

    epoch: int
    case: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A declarative set of faults to inject. Immutable; the mutable
    firing state (dispatch counters, one-shot chunk marks) lives in the
    :class:`_FaultState` the context manager creates."""

    nan: Optional[NaNFault] = None
    #: single-ulp lane flip inside canary re-executions (drift drill).
    drift: Optional[DriftFault] = None
    fused_oom_dispatches: int = 0
    #: fused dispatches to let through before the failures start —
    #: targets a mid-stream chunk rather than the first dispatch.
    fused_oom_skip: int = 0
    #: chunk index -> bytes to KEEP of the published file (truncation).
    truncate_chunks: dict = dataclasses.field(default_factory=dict)
    #: chunk indices whose published file gets one byte flipped.
    corrupt_chunks: tuple = ()
    #: hold supervised dispatches past their deadline (hang simulation).
    stall: Optional[StallFault] = None
    #: drop one device out of the elastic sharded mesh.
    device_loss: Optional[DeviceLossFault] = None
    #: SIGKILL this process (a simulated fleet host) after N lease claims.
    host_crash: Optional[HostCrashFault] = None
    #: truncate this host's live lease file after N heartbeat renewals.
    lease_tear: Optional[LeaseTearFault] = None
    #: burst of synthetic requests at the serve tier's admission layer.
    overload: Optional[OverloadFault] = None


class _FaultState:
    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.fused_dispatches_seen = 0
        self.fused_dispatches_failed = 0
        self.stall_dispatches_seen = 0
        self.stall_dispatches_fired = 0
        self.mangled_chunks: set = set()
        self.claims_seen = 0
        self.renewals_seen = 0
        self.lease_torn = False
        self.overload_fired = False


_ACTIVE: Optional[_FaultState] = None


def _tracing_now() -> bool:
    """Whether `torch.compile` is tracing this host code. Fault hooks are
    inert there — see the module docstring."""
    return torch.compiler.is_compiling()


@contextlib.contextmanager
def inject_faults(plan: FaultPlan):
    """Arm `plan` for the duration of the `with` block. Nesting is
    rejected — overlapping plans would make the injected failures
    order-dependent, which defeats the point."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a FaultPlan is already armed; nesting not supported")
    _ACTIVE = _FaultState(plan)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE.plan if _ACTIVE is not None else None


def maybe_fail_fused_dispatch() -> None:
    """Engine hook: called immediately before each fused dispatch (K2 / K3
    and their tensor-core twins) of the case-scan entry points.
    Raises a simulated resource-exhaustion for the plan's first N calls."""
    state = _ACTIVE
    if state is None or state.plan.fused_oom_dispatches <= 0:
        return
    if _tracing_now():
        return
    state.fused_dispatches_seen += 1
    if (
        state.fused_dispatches_seen > state.plan.fused_oom_skip
        and state.fused_dispatches_failed < state.plan.fused_oom_dispatches
    ):
        state.fused_dispatches_failed += 1
        log_event(
            logger,
            "fault_injected",
            kind="fused_oom",
            dispatch=state.fused_dispatches_failed,
        )
        raise EngineResourceExhausted(
            "injected fault: simulated RESOURCE_EXHAUSTED on fused dispatch "
            f"{state.fused_dispatches_failed}/{state.plan.fused_oom_dispatches}"
        )


def maybe_stall_dispatch() -> None:
    """Watchdog-worker hook: called on the worker thread immediately
    before a supervised dispatch. Sleeps through the armed plan's stall
    window for its first N supervised calls — the caller's deadline
    expires while this thread is asleep, exactly as it would during a
    real native-code hang."""
    state = _ACTIVE
    if state is None or state.plan.stall is None:
        return
    if _tracing_now():
        return
    plan_stall = state.plan.stall
    state.stall_dispatches_seen += 1
    if (
        state.stall_dispatches_seen > plan_stall.skip
        and state.stall_dispatches_fired < plan_stall.dispatches
    ):
        state.stall_dispatches_fired += 1
        log_event(
            logger,
            "fault_injected",
            kind="stall",
            dispatch=state.stall_dispatches_fired,
            hold_s=f"{plan_stall.seconds:.3f}",
        )
        import time

        time.sleep(plan_stall.seconds)


def maybe_lose_device(devices) -> None:
    """Elastic-dispatch hook: called with the mesh's device list before
    each sharded dispatch. Raises a simulated
    :class:`..errors.DeviceLossError` while the armed plan's lost device
    is still part of the mesh; once the mesh has been rebuilt without
    it, the hook goes quiet — retrying on the degraded mesh succeeds."""
    state = _ACTIVE
    if state is None or state.plan.device_loss is None:
        return
    if _tracing_now():
        return
    lost = state.plan.device_loss.device_id
    if any(getattr(d, "id", None) == lost for d in devices):
        log_event(logger, "fault_injected", kind="device_loss", device=lost)
        raise DeviceLossError(
            f"injected fault: simulated loss of device {lost} "
            "(mesh still routes work to it)",
            device_ids=(lost,),
        )


def active_nan_fault() -> Optional[NaNFault]:
    """Engine hook: the armed plan's NaN fault, or None. The engines
    translate it into a per-lane poison epoch of the eager rung (`-1` =
    healthy lane), logging one `event=fault_injected` record when armed."""
    state = _ACTIVE
    if state is None or state.plan.nan is None:
        return None
    if _tracing_now():
        return None
    f = state.plan.nan
    log_event(
        logger, "fault_injected", kind="nan",
        case="all" if f.case is None else f.case, epoch=f.epoch,
    )
    return f


#: Whether the current (host) execution is a numerics-canary
#: re-dispatch. A ContextVar, not a flag on the fault state: the serve
#: tier's canary tick runs on its dispatcher thread concurrently with
#: request handlers, and only the canary's own dispatch may see the
#: armed DriftFault.
_CANARY_EXECUTION = contextvars.ContextVar(
    "yuma_canary_execution", default=False
)


@contextlib.contextmanager
def canary_scope():
    """Mark the enclosed dispatch as a numerics-canary re-execution —
    the only scope in which :func:`active_drift_fault` fires. Used by
    the supervisor's canary scheduler and the serve tier's background
    canary tick; production primaries never enter it."""
    token = _CANARY_EXECUTION.set(True)
    try:
        yield
    finally:
        _CANARY_EXECUTION.reset(token)


def in_canary_scope() -> bool:
    return _CANARY_EXECUTION.get()


def active_drift_fault() -> Optional[DriftFault]:
    """Engine hook: the armed plan's drift fault, inside a canary scope
    only (see :class:`DriftFault`). The batched eager rung translates
    it into a per-lane flip-epoch operand (`-1` = clean lane), logging
    one `event=fault_injected` record when armed."""
    state = _ACTIVE
    if state is None or state.plan.drift is None:
        return None
    if not _CANARY_EXECUTION.get():
        return None
    if _tracing_now():
        return None
    f = state.plan.drift
    log_event(
        logger, "fault_injected", kind="drift",
        case="all" if f.case is None else f.case, epoch=f.epoch,
    )
    return f


def active_overload_fault() -> Optional[OverloadFault]:
    """Serve-admission hook, called by the serving tier
    (``serve/service.py``, before admission): the armed plan's overload burst, exactly
    once per armed plan (a burst that re-fired on every subsequent
    request would never let the drill observe recovery). The serve tier
    translates it into `requests` synthetic admission tickets pushed
    through the real quota + bounded-queue path."""
    state = _ACTIVE
    if state is None or state.plan.overload is None or state.overload_fired:
        return None
    if _tracing_now():
        return None
    state.overload_fired = True
    f = state.plan.overload
    log_event(
        logger,
        "fault_injected",
        kind="overload",
        requests=f.requests,
        tenant=f.tenant,
    )
    return f


def maybe_crash_host(unit) -> None:
    """Fabric-scheduler hook (:mod:`..fabric.scheduler`): called (host level) immediately after a
    work-unit lease claim has been ledgered. SIGKILLs the process once
    the armed plan's claim count is reached — no Python teardown runs,
    matching a real preemption/OOM kill. The unit id is logged BEFORE
    the kill so the drill can assert which claim died."""
    state = _ACTIVE
    if state is None or state.plan.host_crash is None:
        return
    if _tracing_now():
        return
    state.claims_seen += 1
    if state.claims_seen >= state.plan.host_crash.after_claims:
        log_event(
            logger, "fault_injected", kind="host_crash", unit=unit,
            claims=state.claims_seen,
        )
        import signal

        # Flush stdio: SIGKILL gives buffered log lines no second chance.
        for stream in (sys.stdout, sys.stderr):
            try:
                stream.flush()
            except Exception:
                pass
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_tear_lease(path, unit) -> None:
    """Lease-store hook (:mod:`..fabric.lease`): called (host level) after each successful
    heartbeat renewal of this host's own lease. Truncates the live lease
    file ONCE per armed plan — simulated shared-store corruption of a
    claim record — so scanners exercise torn-lease tolerance and the
    holder exercises the LeaseExpired abandon path."""
    state = _ACTIVE
    if state is None or state.plan.lease_tear is None or state.lease_torn:
        return
    if _tracing_now():
        return
    tear = state.plan.lease_tear
    state.renewals_seen += 1
    if state.renewals_seen >= tear.after_renewals:
        state.lease_torn = True
        try:
            data = path.read_bytes()
        except OSError:
            return
        path.write_bytes(data[: tear.keep_bytes])
        log_event(
            logger, "fault_injected", kind="lease_tear", unit=unit,
            kept_bytes=tear.keep_bytes,
        )


def mangle_chunk_file(path, chunk_index: int) -> None:
    """Checkpoint hook: called after a chunk is published (written,
    checksummed, renamed). Truncates or bit-flips the file ONCE per
    chunk per armed plan — modeling corruption that happens between the
    publish and a later read, which is exactly what the checksum
    manifest exists to catch."""
    state = _ACTIVE
    if state is None or chunk_index in state.mangled_chunks:
        return
    plan = state.plan
    if chunk_index in plan.truncate_chunks:
        keep = plan.truncate_chunks[chunk_index]
        state.mangled_chunks.add(chunk_index)
        data = path.read_bytes()
        path.write_bytes(data[:keep])
        log_event(
            logger, "fault_injected", kind="truncate_chunk",
            chunk=chunk_index, kept_bytes=keep,
        )
    elif chunk_index in plan.corrupt_chunks:
        state.mangled_chunks.add(chunk_index)
        with open(path, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([last[0] ^ 0xFF]))
        log_event(
            logger, "fault_injected", kind="corrupt_chunk", chunk=chunk_index
        )

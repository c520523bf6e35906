"""Typed failure taxonomy for the resilience layer (the JAX package's
`resilience/errors.py`, with the CUDA messages added).

The engines raise a zoo of stringly-typed errors: `torch.cuda.OutOfMemoryError`
and "CUDA out of memory" for an allocation the card cannot serve, an
`nvcc` or link failure from :mod:`..ops._build` when a kernel cannot be
built, NCCL / gloo timeouts from a collective whose peer stopped, the
sticky CUDA errors after which the process's context on the card is
unusable, and plain `ValueError` for caller mistakes. The degradation
ladder (:mod:`.retry`) must distinguish "this engine cannot run this
workload here" (demote a rung and retry) from "the caller's request is
wrong" (raise immediately) and from "this device is gone for this
process" (neither retry nor demote here), so every failure the ladder may
act on is classified into one of the typed exceptions below via
:func:`classify_failure` before any policy decision is made. JAX's XLA and
Mosaic markers are kept, so a message classifies the same in both
packages.
"""

from __future__ import annotations

from typing import Optional

import torch


class ResilienceError(RuntimeError):
    """Base class of every typed failure the resilience layer raises."""


class EngineFailure(ResilienceError):
    """An engine could not produce a result for an otherwise-valid
    request (compile failure, resource exhaustion). Retryable: the
    ladder may demote to a lower rung."""


class EngineCompileError(EngineFailure):
    """The engine's program failed to build: an nvcc or ptxas failure, a
    kernel library that will not load (the JAX package's Mosaic lowering
    abort or XLA compile failure). On the card the ladder raises it at once
    (:func:`.retry.run_ladder`, ``on_card``): no retry rebuilds a broken
    kernel, and no lower rung may stand in for it."""


class EngineResourceExhausted(EngineFailure):
    """The engine ran out of device resources: the card's memory (CUDA
    out of memory; the JAX package's VMEM scratch, HBM,
    RESOURCE_EXHAUSTED at dispatch)."""


class EngineStall(EngineFailure):
    """A build or dispatch exceeded its deadline (a hung kernel build, a
    wedged collective, a dead coordinator). Raised by the watchdog
    (:mod:`.watchdog`) when a budget expires, and by classification of
    NCCL / gloo timeouts and the JAX package's ``DEADLINE_EXCEEDED`` /
    collective-timeout runtime errors. Retryable: a stall on one rung
    demotes like any other engine failure — the lower rungs launch
    different kernels and do not share the wedged channel."""

    def __init__(self, message: str, budget_seconds: Optional[float] = None):
        super().__init__(message)
        self.budget_seconds = budget_seconds


class DeviceLossError(EngineFailure):
    """A device dropped out of the mesh mid-sweep (a card reset, an NVLink
    down, a preempted host). Carries the failed device ids so the elastic
    path (:mod:`..parallel.sharded`) can rebuild the mesh over the
    survivors.

    `context_lost=True` marks the sticky CUDA errors ("an illegal memory
    access was encountered", "unspecified launch failure", "device-side
    assert triggered"): after one of them every later call on that card in
    this process fails, so the ladder (:func:`.retry.run_ladder`) neither
    retries nor demotes on it; only a mesh without the device, or a new
    process, runs again."""

    def __init__(self, message: str, device_ids=(), *, context_lost: bool = False):
        super().__init__(message)
        self.device_ids = tuple(device_ids)
        self.context_lost = context_lost


class HostLossError(EngineStall):
    """A WHOLE HOST dropped out of the fleet mid-sweep (SIGKILLed
    worker, preempted VM, coordinator connection lost, heartbeat
    stopped). The fleet analogue of :class:`DeviceLossError` one level
    up (:mod:`..fabric`): the lost host's leased work units are requeued
    by the survivors via lease expiry, exactly as `surviving_mesh`
    rebuilds a mesh over surviving devices.

    Subclasses :class:`EngineStall` deliberately: a host loss first
    SURFACES on the healthy peers as a stall (missed heartbeat, wedged
    collective, dead coordinator channel), so every existing
    stall-handling path — watchdog kill, ladder retry, supervisor
    bookkeeping — handles it unchanged, while fleet-aware callers can
    match the narrower type and steal the dead host's leases instead of
    merely retrying. Retryable by construction: the unit is pure and
    any surviving host can re-execute it."""

    def __init__(self, message: str, host_ids=(), budget_seconds=None):
        super().__init__(message, budget_seconds=budget_seconds)
        self.host_ids = tuple(host_ids)


class WorkerLost(HostLossError):
    """A serve-pool WORKER process died (or became unreachable) with a
    routed request in flight: the router's forward hit a reset/refused
    connection, or the worker's slot lease expired mid-request. The
    scale-out analogue of :class:`HostLossError` on the serving tier —
    and it subclasses it deliberately, so every fleet-aware handler
    (typed, retryable, stall-shaped) treats it identically, while the
    router matches the narrower type to reroute the SAME request onto a
    surviving worker instead of surfacing a client-visible error.
    Retryable by construction: serve requests are pure and idempotent,
    so a reroute re-executes at worst duplicate work, never duplicate
    effects. Carries the dead worker's id and how many reroute attempts
    the router has burned so far."""

    def __init__(self, message: str, *, worker_id: str = "", attempts: int = 0):
        super().__init__(message, host_ids=(worker_id,) if worker_id else ())
        self.worker_id = worker_id
        self.attempts = attempts


class ClientRetriesExhausted(ResilienceError):
    """The client's bounded retry budget is spent and the LAST attempt
    still failed at the transport level (connection reset/refused,
    unreachable server). NOT an :class:`EngineFailure`: nothing
    server-side can act on it — the caller must surface it. Carries the
    attempt count and the last transport error so the caller's log says
    how hard the client tried. HTTP-level 429/503 responses do NOT
    raise this: after the budget is spent they are RETURNED (the
    server's typed body is the contract and must reach the caller)."""

    def __init__(self, message: str, *, attempts: int = 0, last_error=None):
        super().__init__(message)
        self.attempts = attempts
        self.last_error = last_error


class LeaseExpired(ResilienceError):
    """A fleet work-unit lease was lost: the holder's renewal found the
    claim file replaced (stolen after expiry), torn, or gone. NOT an
    :class:`EngineFailure`: the unit now belongs to another host —
    retrying the dispatch here would race the new owner for nothing
    (results are content-addressed and deterministic, so even the race
    is harmless, but the polite move is to abandon and claim other
    work). Carries the unit id and, when known, the usurping holder."""

    def __init__(self, message: str, unit=None, holder=None):
        super().__init__(message)
        self.unit = unit
        self.holder = holder


class DistributedInitError(ResilienceError):
    """A multi-host distributed join failed within its initialization
    timeout (peer crashed before the barrier, wrong coordinator
    address). NOT an :class:`EngineFailure`: there is no lower rung to
    demote to before the backend exists — the caller must decide whether
    to re-launch or abort the job."""


class AdmissionRejected(ResilienceError):
    """A serving-tier request failed admission control BEFORE any
    compile or dispatch: malformed payload, unknown version/engine, or
    an analytic HBM preflight verdict that the shape deterministically
    cannot fit. NOT retryable and NOT an :class:`EngineFailure` — the
    same request is rejected again no matter which rung runs it, so the
    ladder must never burn retries on it (the HTTP layer maps it to a
    structured 4xx). Carries the preflight's way out when there is one
    (``suggestion``: shard count / max_resident_epochs) so the client
    can reshape instead of guessing."""

    def __init__(
        self,
        message: str,
        *,
        reason: str = "invalid_request",
        suggestion: Optional[str] = None,
    ):
        super().__init__(message)
        self.reason = reason
        self.suggestion = suggestion


class QueueOverflow(ResilienceError):
    """The serving tier shed this request: the global run queue is at
    its bound or the tenant's token bucket is empty. Retryable BY THE
    CLIENT — and only by the client: re-dispatching server-side would
    be exactly the unbounded growth the bound exists to prevent, so
    this is NOT an :class:`EngineFailure` and the engine ladder never
    acts on it. ``retry_after`` (seconds) is the backoff the HTTP layer
    surfaces as ``429`` + ``Retry-After``."""

    #: Client-retryable: resubmitting after ``retry_after`` is expected
    #: to succeed once the queue drains / the bucket refills.
    retryable = True

    def __init__(
        self,
        message: str,
        *,
        retry_after: float = 1.0,
        queue_depth: Optional[int] = None,
    ):
        super().__init__(message)
        self.retry_after = float(retry_after)
        self.queue_depth = queue_depth


class SloShed(QueueOverflow):
    """The serving tier shed this request because an SLO is
    FAST-BURNING its error budget (:mod:`..telemetry.slo`) and the
    request's priority sits below the degradation floor — load is
    dropped while there is still budget left, BEFORE the queue
    overflows. Inherits :class:`QueueOverflow`'s whole contract
    (client-retryable, ``retry_after``, 429 + ``Retry-After``, immune
    to engine-failure marker matching); carries the burning SLO names
    so the structured body says WHICH objective forced the shed."""

    def __init__(
        self,
        message: str,
        *,
        retry_after: float = 1.0,
        slos=(),
    ):
        super().__init__(message, retry_after=retry_after)
        self.slos = tuple(slos)


class EngineLadderExhausted(EngineFailure):
    """Every rung of the degradation ladder failed. Carries the
    per-demotion records so the caller can see the full walk."""

    def __init__(self, message: str, records=()):
        super().__init__(message)
        self.records = tuple(records)


class NonFiniteOutputError(ResilienceError):
    """An engine output contained NaN/Inf and no quarantine was armed to
    contain it (see :mod:`.guards`)."""


class CheckpointCorruptionError(ResilienceError):
    """A checkpoint chunk failed its checksum (or could not be decoded)
    and re-execution did not heal it."""


#: Substrings of the sticky CUDA errors: the kernel that raised them left
#: the process's context on the card unusable (every later call there
#: fails the same way). Checked first, case-insensitively.
_CONTEXT_LOST_MARKERS = (
    "an illegal memory access was encountered",
    "unspecified launch failure",
    "device-side assert triggered",
)

#: Substrings that identify a resource-exhaustion failure in the raw
#: message of an XLA/Mosaic or CUDA error. Checked case-insensitively.
_RESOURCE_MARKERS = (
    "cuda out of memory",
    "cuda error: out of memory",
    "resource_exhausted",
    "resource exhausted",
    "out of memory",
    "ran out of memory",
    "vmem limit",
    "exceeds available vmem",
    "scoped vmem",
    "allocation failure",
)

#: Substrings that identify a hang/timeout failure in the raw message of
#: a runtime error: the status name XLA stamps on an expired operation
#: deadline and the collective/channel timeout phrasings of the JAX
#: package's runtime, then NCCL's and gloo's: a wedged collective
#: surfaces on the HEALTHY hosts as one of these, not as a device error.
_STALL_MARKERS = (
    "deadline_exceeded",
    "deadline exceeded",
    "collective operation timed out",
    "collective timed out",
    "channel timed out",
    "channel is in an error state",
    "timed out waiting for",
    "barrier timed out",
    "heartbeat timeout",
    # NCCL's watchdog and gloo's pair timeouts.
    "collective operation timeout",
    "watchdog caught collective operation timeout",
    "nccl timeout",
    "timed out waiting",
    "operation timed out",
)

#: Substrings that identify the loss of a WHOLE HOST rather than a
#: single wedged operation: coordinator-channel loss, stopped
#: heartbeats, and the TCP-level phrasings a dead peer's kernel sends
#: back ("connection reset by peer" et al.). Checked BEFORE the stall
#: markers — a host loss is still stall-shaped (HostLossError subclasses
#: EngineStall, so non-fleet callers behave identically), but the
#: narrower type lets the fleet fabric steal the dead host's leases
#: instead of merely retrying into the void. Deliberately NOT here:
#: bare local-I/O phrasings ("broken pipe", "socket closed") — they
#: appear in ordinary OSErrors (a closed stdout, a dropped log pipe)
#: far more often than in peer-death reports, and classifying those as
#: retryable would silently re-execute units whose real failure is the
#: caller's environment. Raw OSErrors are additionally exempted in
#: :func:`classify_failure` for the same reason: runtime peer-death
#: surfaces as XLA RuntimeErrors, local plumbing as OSError.
_HOST_LOSS_MARKERS = (
    "heartbeat timeout",
    "heartbeat timed out",
    "missed heartbeats",
    "coordinator unreachable",
    "coordinator unavailable",
    "coordination service unavailable",
    "lost connection to coordinator",
    "coordinator disconnected",
    "connection reset by peer",
    "connection refused",
    "peer closed connection",
    "host unreachable",
    "worker task died",
    # torch.distributed's phrasings of a peer that died.
    "connection closed by peer",
    "ncclremoteerror",
    "remote process exited",
)

#: Substrings that identify a kernel/program compile failure.
_COMPILE_MARKERS = (
    "mosaic failed",
    "mosaic lowering",
    "internal: mosaic",
    "failed to compile",
    "compilation failure",
    "unsupported lowering",
    "xla compilation",
    # ops/_build.py: an nvcc or ptxas failure, a library that will not load.
    "nvcc not found",
    "ptxas error",
    "ptxas fatal",
    "undefined symbol",
    "no kernel image is available",
)


def classify_failure(exc: BaseException) -> Optional[EngineFailure]:
    """Map a raw exception onto the engine-failure taxonomy.

    The CUDA cases: `torch.cuda.OutOfMemoryError` and "CUDA out of memory"
    are :class:`EngineResourceExhausted`; a kernel build that fails in
    :mod:`..ops._build` (nvcc, ptxas, a library that will not load) is
    :class:`EngineCompileError`; an NCCL or gloo timeout is
    :class:`EngineStall`, or :class:`HostLossError` where it says the peer
    died; the sticky context errors are a :class:`DeviceLossError` with
    ``context_lost=True``, which the ladder does not retry.

    Returns an :class:`EngineFailure` (the exception itself if already
    typed, else a new typed wrapper chaining `exc`) when the failure is
    one the degradation ladder may act on, or ``None`` for everything
    else — caller errors (`ValueError`/`TypeError`), keyboard
    interrupts, and unrecognized runtime errors must propagate untouched
    rather than silently trigger an engine demotion.
    """
    if isinstance(exc, EngineFailure):
        return exc
    if isinstance(exc, ResilienceError):
        # Typed but deliberately NON-retryable (LeaseExpired,
        # DistributedInitError, CheckpointCorruptionError, ...): the
        # type is the decision — its message must never be re-matched
        # against the engine-failure markers.
        return None
    if isinstance(exc, (ValueError, TypeError, KeyboardInterrupt)):
        return None
    msg = str(exc).lower()
    if any(marker in msg for marker in _CONTEXT_LOST_MARKERS):
        err = DeviceLossError(
            f"{exc} -- the CUDA context of this process on that device is unusable "
            "after this error: no retry or demotion runs on it in this process "
            "(drop the device from the mesh, or restart the process)",
            context_lost=True,
        )
        err.__cause__ = exc
        return err
    if isinstance(exc, torch.OutOfMemoryError) or any(
        marker in msg for marker in _RESOURCE_MARKERS
    ):
        err = EngineResourceExhausted(str(exc))
        err.__cause__ = exc
        return err
    if not isinstance(exc, OSError) and any(
        marker in msg for marker in _HOST_LOSS_MARKERS
    ):
        # Checked before the generic stall markers: "heartbeat timeout:
        # coordinator unreachable" is a stall AND a host loss, and the
        # narrower type must win so fleet callers can requeue the dead
        # host's leases (non-fleet callers see an EngineStall subclass
        # and behave exactly as before). Raw OSErrors are excluded: a
        # local EPIPE/ECONNRESET from the caller's own plumbing shares
        # these phrasings, and retrying a unit cannot fix the caller's
        # environment — peer death reported by the runtime arrives as a
        # RuntimeError, which still classifies.
        host_err = HostLossError(str(exc))
        host_err.__cause__ = exc
        return host_err
    if any(marker in msg for marker in _STALL_MARKERS):
        # Checked before the compile markers: a hung compile surfaces as
        # "deadline exceeded while compiling", which must classify as a
        # stall (the retry may succeed where the hang was transient),
        # not as a deterministic compile abort.
        err = EngineStall(str(exc))
        err.__cause__ = exc
        return err
    if any(marker in msg for marker in _COMPILE_MARKERS) or (
        "nvcc" in msg and "failed" in msg
    ):
        err = EngineCompileError(str(exc))
        err.__cause__ = exc
        return err
    return None

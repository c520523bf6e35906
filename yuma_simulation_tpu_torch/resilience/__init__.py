"""Resilience layer: typed failures, the engine-degradation ladder,
numerical quarantine, deterministic fault injection, the deadline watchdog
and the sweep supervisor (the JAX package's `resilience/`).

- :mod:`.errors` — the typed failure taxonomy + :func:`classify_failure`,
  which also reads the CUDA messages (out of memory, kernel builds, NCCL
  and gloo timeouts, the sticky context errors);
- :mod:`.retry` — :class:`RetryPolicy` and the explicit engine ladder
  (fused_varying_mxu -> fused_varying -> fused_scan_mxu -> fused_scan ->
  eager) with jittered bounded retry; every rung runs on the card;
- :mod:`.guards` — the opt-in per-lane `isfinite` quarantine folded into
  the eager rung's carry, plus the host-side :class:`QuarantineReport`;
- :mod:`.watchdog` — the deadline watchdog: supervised dispatch on a
  worker thread (on the caller's device and stream), typed `EngineStall`
  on a missed heartbeat;
- :mod:`.supervisor` — the sweep supervisor composing every tier over
  idempotent work units, with the crash-safe :class:`FailureLedger`, the
  :class:`SweepHealthReport` and the flight bundle;
- :mod:`.faults` — test-only deterministic fault hooks so every ladder
  rung and recovery path runs on the CPU and on the card.
"""

from yuma_simulation_tpu_torch.resilience.errors import (  # noqa: F401
    AdmissionRejected,
    CheckpointCorruptionError,
    ClientRetriesExhausted,
    DeviceLossError,
    DistributedInitError,
    EngineCompileError,
    EngineFailure,
    EngineLadderExhausted,
    EngineResourceExhausted,
    EngineStall,
    HostLossError,
    LeaseExpired,
    NonFiniteOutputError,
    QueueOverflow,
    ResilienceError,
    SloShed,
    WorkerLost,
    classify_failure,
)
from yuma_simulation_tpu_torch.resilience.faults import (  # noqa: F401
    DeviceLossFault,
    DriftFault,
    FaultPlan,
    HostCrashFault,
    LeaseTearFault,
    NaNFault,
    OverloadFault,
    StallFault,
    canary_scope,
    inject_faults,
)
from yuma_simulation_tpu_torch.resilience.guards import (  # noqa: F401
    QuarantineEntry,
    QuarantineReport,
    assert_all_finite,
    build_quarantine_report,
)
from yuma_simulation_tpu_torch.resilience.watchdog import (  # noqa: F401
    Deadline,
    run_with_deadline,
)
from yuma_simulation_tpu_torch.resilience.retry import (  # noqa: F401
    ENGINE_LADDER,
    DemotionRecord,
    RetryPolicy,
    default_retry_policy,
    ladder_from,
    run_ladder,
)
from yuma_simulation_tpu_torch.resilience.supervisor import (  # noqa: F401
    FailureLedger,
    SweepHealthReport,
    SweepSupervisor,
    default_deadline,
)

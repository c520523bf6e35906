"""The engine-degradation ladder: bounded retry with explicit demotion (the
JAX package's `resilience/retry.py`).

Engine selection is resolve-once (the dispatch planner,
:func:`..simulation.planner.plan_dispatch`): "auto" picks the varying scan
(K3) on the card, and without a ladder a failure at build or launch time
aborts the whole run. The ladder makes the fallback explicit and bounded
instead: each case-scan rung has a fixed set of strictly-less-demanding
rungs below it (`DispatchPlan.ladder`, from :data:`..planner.ENGINE_LADDER`)

    fused_varying_mxu -> fused_varying -> fused_scan_mxu -> fused_scan -> eager

and a classified engine failure (:func:`..errors.classify_failure`) on
one rung retries on the same rung up to `max_attempts_per_rung` times
(jittered exponential backoff — transient memory pressure from a
co-resident program does clear) before *demoting* one rung, emitting a
structured log record per demotion. Caller errors are never retried.

Three rules of the port:

- **Demotion never leaves the device.** Every rung runs where the
  dispatch's tensors live.
- **Demotion never trades a kernel for its plain version.** On the card a
  fused plan's ladder stops at the last hand-written rung
  (`DispatchPlan.on_card`); the eager rung runs there only when the plan
  picked it (the quarantine guard, a miner mask) or the caller asked for
  it. A kernel that will not build or launch on the card
  (:class:`..errors.EngineCompileError`) raises at once: it is a defect of
  the checkout's kernels, which no retry clears. Out-of-memory failures
  and stalls retry and demote between the kernel rungs.
- **Demotion never hides a kernel.** Each demotion logs
  ``event=engine_demoted``, adds one to the ``engine_demotions`` counter
  and shows in the result's ``engine`` (the rung that ran) and
  ``demotions``, and the kernels' launch counters show which kernel ran.

A sticky CUDA error (a :class:`..errors.DeviceLossError` with
``context_lost``) is neither retried nor demoted: the process's context on
that card is gone, so it propagates. If the bottom rung fails too,
:class:`..errors.EngineLadderExhausted` carries the full demotion history.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, Optional, Sequence

from yuma_simulation_tpu_torch.resilience.errors import (
    DeviceLossError,
    EngineCompileError,
    EngineLadderExhausted,
    classify_failure,
)

# Rung ordering is owned by the dispatch planner (one decision surface for
# the engine choice and the ladder below it); re-exported here because the
# ladder is this module's vocabulary.
from yuma_simulation_tpu_torch.simulation.planner import (  # noqa: F401
    ENGINE_LADDER,
    ladder_from,
)
from yuma_simulation_tpu_torch.telemetry.metrics import get_registry
from yuma_simulation_tpu_torch.resilience.watchdog import (
    block_until_ready,
    run_with_deadline,
)
from yuma_simulation_tpu_torch.telemetry.runctx import span as telemetry_span
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry knobs for the degradation ladder.

    `max_attempts_per_rung` attempts run on each rung before demotion;
    sleeps between attempts follow `backoff_base * backoff_factor**k`
    with `+/- jitter` fractional noise. `seed=None` (the default) draws
    the jitter PRNG from OS entropy per ladder run, so N replicas that
    fail a shared device simultaneously spread their retries instead of
    redispatching in lockstep; pass an explicit seed only for
    reproducible tests.
    """

    max_attempts_per_rung: int = 2
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    jitter: float = 0.25
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        if self.max_attempts_per_rung < 1:
            raise ValueError("max_attempts_per_rung must be >= 1")
        if self.backoff_base < 0 or self.backoff_factor < 1:
            raise ValueError("backoff_base >= 0 and backoff_factor >= 1 required")
        if not 0 <= self.jitter < 1:
            raise ValueError("jitter must be in [0, 1)")

    def backoff_seconds(self, attempt: int, rng: random.Random) -> float:
        """Sleep before retry number `attempt` (0-based) on a rung."""
        base = self.backoff_base * self.backoff_factor**attempt
        return base * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))


def default_retry_policy() -> RetryPolicy:
    """The production default: two attempts per rung, 50 ms base backoff."""
    return RetryPolicy()


@dataclasses.dataclass(frozen=True)
class DemotionRecord:
    """One structured record per ladder demotion (also logged via
    :func:`..utils.logging.log_event` as `event=engine_demoted`)."""

    from_engine: str
    to_engine: str
    attempts: int  # attempts spent on `from_engine` before demoting
    error_type: str
    message: str


def run_ladder(
    dispatch: Callable[[str], object],
    engine: str,
    policy: RetryPolicy,
    *,
    rungs: Optional[Sequence[str]] = None,
    label: str = "",
    deadline=None,
    on_failure: Optional[Callable[[BaseException, str, int], None]] = None,
    on_card: bool = False,
):
    """Run `dispatch(rung)` down the ladder starting at `engine`.

    Returns `(result, engine_used, demotions)` where `demotions` is the
    list of :class:`DemotionRecord` accumulated on the way down (empty
    on the happy path). Non-engine failures propagate immediately;
    exhausting the ladder raises :class:`EngineLadderExhausted` chaining
    the last rung's failure.

    `deadline` (a :class:`..watchdog.Deadline`, default None = no hang
    supervision) runs every attempt under the deadline watchdog: an
    attempt that posts no heartbeat within its budget raises a typed
    `EngineStall`, which classifies as retryable — so a hung compile or
    wedged dispatch walks the same retry-then-demote ladder as an
    out-of-memory launch instead of blocking the sweep forever.

    `on_failure(typed, rung, attempt)` is called for every CLASSIFIED
    failure, including ones a same-rung retry then absorbs — the
    supervisor's accounting hook: demotion records alone undercount
    (a stall killed on attempt 1 that succeeds on attempt 2 leaves no
    demotion), and the health report must account for every recovery
    action, not just the ones that moved rungs.

    `on_card=True` (a plan's `on_card`): an :class:`EngineCompileError`
    raises at once, with neither a retry nor a demotion.
    """
    rungs = tuple(rungs) if rungs is not None else ladder_from(engine)
    # Constructed lazily on the failure path only: the happy path never
    # needs the backoff jitter.
    rng: Optional[random.Random] = None
    demotions: list = []
    last_failure: Optional[BaseException] = None
    for rung_idx, rung in enumerate(rungs):
        last_failure = None
        for attempt in range(policy.max_attempts_per_rung):
            try:
                # One telemetry span per rung attempt — the innermost
                # level of the supervisor's sweep -> unit -> attempt ->
                # engine-rung chain (no-op without an active RunContext).
                with telemetry_span(
                    f"engine:{rung}", attempt=attempt + 1
                ):
                    if deadline is None:
                        return dispatch(rung), rung, demotions
                    result = run_with_deadline(
                        # Bind by value: an abandoned (stalled) worker
                        # that wakes later must not dispatch whatever
                        # rung the ladder has since advanced to.
                        lambda r=rung: dispatch(r),
                        deadline,
                        label=f"{label}:{rung}" if label else rung,
                        attempt=attempt,
                    )
                    return result, rung, demotions
            except BaseException as exc:  # noqa: BLE001 — classified below
                typed = classify_failure(exc)
                if typed is None:
                    raise
                if isinstance(typed, DeviceLossError) and typed.context_lost:
                    # The card's context is unusable in this process:
                    # every rung would fail the same way there.
                    if typed is exc:
                        raise
                    raise typed from exc
                if on_card and isinstance(typed, EngineCompileError):
                    # A kernel of the checkout that will not build or
                    # launch: no retry clears it, and no rung below may
                    # stand in for it.
                    if typed is exc:
                        raise
                    raise typed from exc
                if on_failure is not None:
                    on_failure(typed, rung, attempt)
                last_failure = typed
                retries_left = policy.max_attempts_per_rung - attempt - 1
                if retries_left:
                    get_registry().counter(
                        "engine_retries", help="same-rung ladder retries"
                    ).inc()
                    if rng is None:
                        rng = random.Random(policy.seed)
                    delay = policy.backoff_seconds(attempt, rng)
                    log_event(
                        logger,
                        "engine_retry",
                        level=logging.INFO,
                        label=label,
                        engine=rung,
                        attempt=attempt + 1,
                        backoff_s=f"{delay:.3f}",
                        error=type(typed).__name__,
                    )
                    if delay > 0:
                        time.sleep(delay)
        if rung_idx + 1 < len(rungs):
            record = DemotionRecord(
                from_engine=rung,
                to_engine=rungs[rung_idx + 1],
                attempts=policy.max_attempts_per_rung,
                error_type=type(last_failure).__name__,
                message=str(last_failure),
            )
            demotions.append(record)
            get_registry().counter(
                "engine_demotions", help="engine-ladder demotions"
            ).inc()
            log_event(
                logger,
                "engine_demoted",
                label=label,
                from_engine=record.from_engine,
                to_engine=record.to_engine,
                attempts=record.attempts,
                error=record.error_type,
            )
    raise EngineLadderExhausted(
        f"every engine rung failed ({' -> '.join(rungs)}); "
        f"last: {last_failure}",
        records=demotions,
    ) from last_failure


def supervise(
    dispatch: Callable[[str], object],
    plan,
    retry_policy: Optional[RetryPolicy] = None,
    deadline=None,
    *,
    label: str = "",
    on_failure: Optional[Callable[[BaseException, str, int], None]] = None,
):
    """Run one planned dispatch as every entry point supervises it:
    `dispatch(rung)` down `plan.ladder` under `retry_policy` (the ladder,
    :func:`run_ladder`), or on `plan.engine` alone under `deadline` (the
    watchdog; inline when both are None). A supervised attempt ends in
    :func:`..watchdog.block_until_ready`, so a launch failure surfaces
    inside the ladder's try and the watchdog's budget covers the card's
    work. Returns `(result, engine_used, demotions)`."""
    supervised = retry_policy is not None or deadline is not None

    def attempt(rung: str):
        out = dispatch(rung)
        return block_until_ready(out) if supervised else out

    if retry_policy is None:
        out = run_with_deadline(lambda: attempt(plan.engine), deadline, label=label)
        return out, plan.engine, []
    return run_ladder(
        attempt, plan.engine, retry_policy, rungs=plan.ladder, label=label,
        deadline=deadline, on_failure=on_failure, on_card=plan.on_card,
    )

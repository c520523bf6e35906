"""Serving-tier lifecycle: the per-engine-rung circuit breaker + warmup.

The graceful-degradation backstop. The engine ladder already demotes a
FAILING dispatch rung by rung — but on a service, every request that
walks the ladder pays the failing rung's latency (attempts x backoff x
deadline) before landing on the rung that works. The
:class:`CircuitBreaker` remembers: after `threshold` consecutive
batches whose typed failures demoted off a rung, the rung TRIPS OPEN
fleet-wide (process-wide — every tenant, every shape bucket) and new
dispatch plans are re-anchored below it
(:meth:`..simulation.planner.DispatchPlan.demoted`), skipping the
failing rung entirely. After `cooldown_seconds` the rung goes HALF-OPEN:
exactly one probe batch is allowed to try it again — success closes the
rung, failure re-opens it with a fresh cooldown. Classic breaker
semantics, engine-rung granular.

State feeds the metrics registry (``serve_breaker_trips`` counter,
``serve_breaker_open`` gauge) and `/healthz`, so a tripped rung is an
operator-visible event, not a silent slowdown that recovered.

:func:`warmup` is the warm-engine half of the service's name: run one
throwaway dispatch per configured shape bucket at startup, so the first
real tenant request finds its kernel libraries built and loaded (and the
allocator warm) instead of paying the build inside its own deadline.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional, Sequence

from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)


class _RungState:
    __slots__ = ("failures", "opened_at", "probing")

    def __init__(self) -> None:
        self.failures = 0
        self.opened_at: Optional[float] = None
        self.probing = False


class CircuitBreaker:
    """Per-engine-rung trip/half-open/close state (see module docstring).

    Thread-safe; the clock is injectable for deterministic tests. The
    LAST rung of any ladder is never filtered out — a breaker that
    could open every rung would turn "degraded" into "down", which is
    the opposite of its job (the final rung's failures still count, so
    `/healthz` shows it red)."""

    def __init__(
        self,
        threshold: int = 3,
        cooldown_seconds: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        registry=None,
    ):
        if threshold < 1:
            raise ValueError("CircuitBreaker threshold must be >= 1")
        self.threshold = threshold
        self.cooldown_seconds = cooldown_seconds
        self._clock = clock
        self._lock = threading.Lock()
        self._rungs: dict[str, _RungState] = {}
        if registry is None:
            from yuma_simulation_tpu_torch.telemetry.metrics import get_registry

            registry = get_registry()
        self._trips = registry.counter(
            "serve_breaker_trips", help="circuit-breaker engine-rung trips"
        )
        self._open_gauge = registry.gauge(
            "serve_breaker_open", help="engine rungs currently tripped open"
        )

    def _state(self, rung: str) -> _RungState:
        st = self._rungs.get(rung)
        if st is None:
            st = self._rungs[rung] = _RungState()
        return st

    def _publish_open_count(self) -> None:
        self._open_gauge.set(
            sum(1 for s in self._rungs.values() if s.opened_at is not None)
        )

    def filter_ladder(self, ladder: Sequence[str]) -> tuple:
        """The sub-ladder a new dispatch should start at: open rungs are
        skipped unless their cooldown has elapsed, in which case exactly
        ONE caller is admitted as the half-open probe (`probing` latches
        under the lock until that probe reports). The last rung always
        remains available."""
        ladder = tuple(ladder)
        with self._lock:
            for i, rung in enumerate(ladder[:-1]):
                st = self._state(rung)
                if st.opened_at is None:
                    return ladder[i:]
                if (
                    not st.probing
                    and self._clock() - st.opened_at >= self.cooldown_seconds
                ):
                    st.probing = True
                    log_event(
                        logger, "breaker_half_open", rung=rung,
                        level=logging.INFO,
                    )
                    return ladder[i:]
            return ladder[-1:]

    def record_success(self, rung: str) -> None:
        """A batch completed ON `rung` (no demotion off it): close it."""
        with self._lock:
            st = self._state(rung)
            was_open = st.opened_at is not None
            st.failures = 0
            st.opened_at = None
            st.probing = False
            self._publish_open_count()
        if was_open:
            log_event(
                logger, "breaker_closed", rung=rung, level=logging.INFO
            )

    def record_failure(self, rung: str) -> None:
        """A batch's typed failures demoted off `rung` (or its probe
        failed): count toward the threshold / re-open immediately."""
        with self._lock:
            st = self._state(rung)
            st.failures += 1
            tripped = False
            if st.probing:
                # The half-open probe failed: re-open, fresh cooldown.
                st.opened_at = self._clock()
                st.probing = False
                tripped = True
            elif st.opened_at is None and st.failures >= self.threshold:
                st.opened_at = self._clock()
                tripped = True
            if tripped:
                self._trips.inc()
                self._publish_open_count()
            failures = st.failures
        if tripped:
            log_event(
                logger,
                "breaker_tripped",
                rung=rung,
                failures=failures,
                cooldown_s=f"{self.cooldown_seconds:.1f}",
            )

    def abort_probe(self, rung: str) -> None:
        """Un-latch a half-open probe that failed for a reason the
        breaker should NOT count (a caller error, an unclassified
        crash): `probing` clears but the rung stays open with its
        original `opened_at`, so the next caller is immediately
        admitted as a fresh probe. Without this, a probe dying on a
        non-engine failure would leave `probing` latched forever and
        the rung dead for the process lifetime. No-op when the rung is
        not probing."""
        with self._lock:
            st = self._rungs.get(rung)
            if st is None or not st.probing:
                return
            st.probing = False
        log_event(
            logger, "breaker_probe_aborted", rung=rung, level=logging.INFO
        )

    def snapshot(self) -> dict:
        """`{rung: {"state": "closed"|"open"|"half_open", "failures": n}}`
        for `/healthz`."""
        with self._lock:
            out = {}
            for rung, st in self._rungs.items():
                state = "closed"
                if st.opened_at is not None:
                    state = "half_open" if st.probing else "open"
                out[rung] = {"state": state, "failures": st.failures}
            return out


def warmup(
    shapes: Sequence[tuple],
    *,
    version: str = "Yuma 1 (paper)",
    logger_: Optional[logging.Logger] = None,
    device="cuda",
) -> int:
    """Warm the serving path on `device` for each `(epochs, V, M)` shape:
    one throwaway donor-packed batch through the same
    `simulate_batch`/quarantine path default requests ride (the eager
    rung), and on the card one launch of the kernel rung the planner
    gives a ``quarantine: false`` request of that shape
    (:func:`..simulation.aot.preload_shapes`: its libraries built or
    loaded through the kernel cache). Returns the number of shapes
    warmed.

    A shape that is not three positive integers is logged and skipped,
    as the JAX package logs every warmup failure — a service that
    refuses to start because a warmup shape was bad would be less
    available, not more. A kernel library that fails to build, or a
    launch that fails, raises: that is the fault the port must not hide
    behind a slower rung."""
    import numpy as np

    from yuma_simulation_tpu_torch.models.config import YumaConfig
    from yuma_simulation_tpu_torch.models.variants import variant_for_version
    from yuma_simulation_tpu_torch.scenarios.base import Scenario
    from yuma_simulation_tpu_torch.simulation.aot import (
        preload_shapes,
        process_stats,
    )
    from yuma_simulation_tpu_torch.simulation.engine import resolve_device
    from yuma_simulation_tpu_torch.simulation.sweep import (
        pack_scenarios,
        simulate_batch,
    )

    dev = resolve_device(device)
    warmed = 0
    spec = variant_for_version(version)
    # Cold-start accounting (simulation.aot): with a kernel cache active,
    # each warmup launch below resolves its libraries through it — hits
    # load published libraries in milliseconds, misses build once and
    # publish for the next process. The before/after stats delta rides
    # the serve_warmed event, so a process that re-paid builds it should
    # have loaded is visible in one grep.
    stats_before = process_stats().to_json()
    for shape in shapes:
        try:
            E, V, M = (int(d) for d in shape)
            if min(E, V, M) < 1:
                raise ValueError(f"non-positive dimension in {shape}")
        except (TypeError, ValueError):
            (logger_ or logger).warning(
                "warmup shape %r is not (epochs, V, M); skipped", shape,
                exc_info=True,
            )
            continue
        validators = [f"v{i}" for i in range(V)]
        scenario = Scenario(
            name=f"warmup:{E}x{V}x{M}",
            validators=validators,
            base_validator=validators[0],
            weights=np.zeros((E, V, M), np.float32),
            stakes=np.ones((E, V), np.float32),
            num_epochs=E,
        )
        W, S, ri, re, mask = pack_scenarios([scenario], device=dev)
        simulate_batch(
            W, S, ri, re, YumaConfig(), spec,
            miner_mask=mask, quarantine=True,
        )
        if dev.type == "cuda":
            preload_shapes(
                [(E, V, M)], yuma_version=version, quarantine=False,
                label="serve_warmup", device=dev,
            )
        warmed += 1
    if warmed:
        stats_after = process_stats().to_json()
        log_event(
            logger_ or logger,
            "serve_warmed",
            level=logging.INFO,
            shapes=warmed,
            aot_hits=stats_after["hits"] - stats_before["hits"],
            aot_builds=stats_after["builds"] - stats_before["builds"],
        )
    return warmed

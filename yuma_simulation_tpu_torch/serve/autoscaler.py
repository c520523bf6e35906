"""SLO-burn-driven pool sizing for the horizontal serving tier.

The burn-rate engine (:mod:`..telemetry.slo`) already decides *when
the service is in trouble* — a fast-burning ``degrade=True`` SLO is
the page-worthy signal the admission tier sheds on. The autoscaler
closes the loop the other way: instead of (only) shedding demand,
**add supply**. Each :meth:`Autoscaler.tick`:

- **scale up** when any degrade-eligible SLO is fast-burning and the
  pool is below ``max_workers`` — one worker per tick (spawns load
  their kernels from the shared kernel-library cache instead of
  building them, so a new worker pays its process start and CUDA
  context only; adding one at a time keeps the control loop stable);
- **scale down** when a worker has sat idle (zero in-flight, no
  fast burn) past ``idle_retire_seconds`` and the pool is above
  ``min_workers`` — retired gracefully (drain + bundle publish), the
  most-recently-spawned first so long-lived workers keep their warm
  caches;
- **hold** otherwise. Consecutive spawns are separated by at least
  ``cooldown_seconds`` so one burn episode cannot stampede the pool
  to ``max_workers`` before the first new worker absorbs any load.

Deliberately synchronous and dependency-injected (`clock`,
`slo_engine`, any pool exposing ``live()/spawn()/retire()``): the unit
tests drive it with fakes and the router's serve loop ticks it from a
plain background thread (:meth:`start`)."""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)


class Autoscaler:
    """See the module docstring. ``router`` is a
    :class:`.router.RouterService` (or any object exposing
    ``pool.live()``, ``spawn_worker(reason=...)`` and
    ``retire_worker(worker_id, reason=...)`` — the ledger entries ride
    those methods)."""

    def __init__(
        self,
        router,
        slo_engine=None,
        *,
        min_workers: int = 1,
        max_workers: int = 4,
        idle_retire_seconds: float = 300.0,
        cooldown_seconds: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        from yuma_simulation_tpu_torch.telemetry.slo import get_slo_engine

        if min_workers < 0 or max_workers < max(1, min_workers):
            raise ValueError(
                f"need 0 <= min_workers <= max_workers (got "
                f"{min_workers}..{max_workers})"
            )
        self.router = router
        self.slo = slo_engine if slo_engine is not None else get_slo_engine()
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.idle_retire_seconds = float(idle_retire_seconds)
        self.cooldown_seconds = float(cooldown_seconds)
        self.clock = clock
        self._last_spawn_t: Optional[float] = None
        #: worker_id -> clock() when it was first seen idle; cleared
        #: the moment it reports in-flight work again.
        self._idle_since: dict[str, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- one control-loop step ----------------------------------------

    def tick(self) -> Optional[str]:
        """One decision: returns ``"spawn"``, ``"retire"``, or ``None``
        (hold). Never raises past a failed spawn — supply problems must
        not kill the serve loop that ticks it."""
        now = self.clock()
        ads = self.router.pool.live()
        burning = tuple(self.slo.degraded())
        # -- up --
        if burning and len(ads) < self.max_workers:
            if (
                self._last_spawn_t is None
                or now - self._last_spawn_t >= self.cooldown_seconds
            ):
                self._last_spawn_t = now
                try:
                    ad = self.router.spawn_worker(
                        reason=f"slo_fast_burn:{','.join(burning)}"
                    )
                except Exception:  # noqa: BLE001 — see docstring
                    logger.warning("autoscale spawn failed", exc_info=True)
                    return None
                log_event(
                    logger,
                    "autoscale_up",
                    worker=ad.get("worker_id", "?"),
                    burning=",".join(burning),
                    live=len(ads) + 1,
                )
                return "spawn"
            return None
        # -- down --
        live_ids = set()
        for ad in ads:
            worker_id = str(ad.get("worker_id", ""))
            live_ids.add(worker_id)
            if int(ad.get("inflight", 0)) > 0 or burning:
                self._idle_since.pop(worker_id, None)
            else:
                self._idle_since.setdefault(worker_id, now)
        for gone in set(self._idle_since) - live_ids:
            self._idle_since.pop(gone, None)
        if len(ads) > self.min_workers:
            # Youngest-first: long-lived workers keep their warm caches.
            for ad in sorted(
                ads,
                key=lambda a: float(a.get("started_t", 0.0)),
                reverse=True,
            ):
                worker_id = str(ad.get("worker_id", ""))
                idle_t = self._idle_since.get(worker_id)
                if (
                    idle_t is not None
                    and now - idle_t >= self.idle_retire_seconds
                ):
                    self._idle_since.pop(worker_id, None)
                    if self.router.retire_worker(
                        worker_id, reason="idle"
                    ):
                        log_event(
                            logger,
                            "autoscale_down",
                            worker=worker_id,
                            idle_seconds=round(now - idle_t, 3),
                            live=len(ads) - 1,
                        )
                        return "retire"
        return None

    # -- background mode ----------------------------------------------

    def start(self, interval_seconds: float = 1.0) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval_seconds):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — keep the loop alive
                    logger.warning("autoscaler tick failed", exc_info=True)

        self._thread = threading.Thread(
            target=loop, name="yuma-serve-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

"""One warm worker of the horizontal serving pool.

A worker is the full single-process serving stack
(:class:`.service.SimulationService` behind
:class:`.server.SimulationServer`) made *discoverable*: it claims one
pool **slot** as a lease unit in the shared
:class:`..fabric.lease.LeaseStore` directory and heartbeats an
**advertisement** beside the claim — its URL, pid, in-flight depth,
the :class:`..replay.statecache.StateCache` prefixes it physically
holds (content-addressed baseline keys + on-disk carry checkpoints),
and its warm ``ExVxM`` shape buckets. The router
(:mod:`.router`) never talks to a registry service: liveness is the
lease protocol's existing mtime-freshness rule, and placement quality
is whatever the last heartbeat advertised. A SIGKILLed worker simply
stops renewing; within one TTL its claim is stealable and the router
stops scoring it — the same crash semantics the fleet tier already
proved for simulation units.

Lifecycle:

- **claim**: ``try_claim(slot)`` — losing the race to a live worker is
  a typed startup failure, not a silent double-bind;
- **serve**: the ordinary HTTP front on an ephemeral port (the ad is
  how anyone learns the port);
- **heartbeat**: every ``ttl/3`` seconds, ``renew(slot)`` +
  ``annotate(slot, ad)``. A torn/missed renewal raises the lease
  tier's typed :class:`..resilience.errors.LeaseExpired` and the
  worker exits rather than serve unclaimed;
- **retire** (SIGTERM): advertise ``retired=True`` (the router stops
  routing NEW work immediately), drain via ``SimulationServer.close``
  (in-flight finishes, flight bundle publishes), release the slot.

The worker runs its service on ``ServeConfig.device`` (the card by
default; a worker never falls back to the CPU): the router passes its
own ``--device`` to every worker it spawns, and each worker process
holds its own CUDA context.

Run one: ``python -m yuma_simulation_tpu_torch.serve --worker-pool DIR
--worker-slot N [--device cuda]`` (the router's
:class:`.router.WorkerPool` spawns exactly this).
"""

from __future__ import annotations

import logging
import os
import pathlib
import signal
import threading
import time
from typing import Optional, Union

from yuma_simulation_tpu_torch.fabric.lease import LeaseStore
from yuma_simulation_tpu_torch.resilience.errors import LeaseExpired
from yuma_simulation_tpu_torch.serve.server import SimulationServer
from yuma_simulation_tpu_torch.serve.service import ServeConfig
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

#: Subdirectory of the pool root holding slot leases + advertisements.
LEASES_DIR = "leases"
#: Subdirectory of the pool root holding per-worker flight bundles.
WORKERS_DIR = "workers"


def pool_leases_dir(pool_dir: Union[str, pathlib.Path]) -> pathlib.Path:
    return pathlib.Path(pool_dir) / LEASES_DIR


def worker_bundle_dir(
    pool_dir: Union[str, pathlib.Path], worker_id: str
) -> pathlib.Path:
    """Where a worker publishes its flight bundle: the router merges
    every worker's bundle with its own at drill/ops time."""
    return pathlib.Path(pool_dir) / WORKERS_DIR / worker_id / "bundle"


class ServeWorker:
    """One pool member: slot lease + HTTP server + heartbeat ads.

    ``ttl_seconds`` is the liveness contract: miss renewals for one TTL
    and the router treats the worker as dead. The heartbeat runs at
    ``ttl/3`` so a single slow beat never looks like a crash."""

    def __init__(
        self,
        pool_dir: Union[str, pathlib.Path],
        slot: int,
        worker_id: str,
        config: Optional[ServeConfig] = None,
        *,
        host: str = "127.0.0.1",
        ttl_seconds: float = 3.0,
    ):
        self.pool_dir = pathlib.Path(pool_dir)
        self.slot = int(slot)
        self.worker_id = worker_id
        self.ttl_seconds = float(ttl_seconds)
        self.leases = LeaseStore(
            pool_leases_dir(self.pool_dir),
            worker_id,
            ttl_seconds=ttl_seconds,
        )
        claim = self.leases.try_claim(self.slot)
        if claim is None:
            raise RuntimeError(
                f"pool slot {self.slot} is already held by a live "
                f"worker (pool {self.pool_dir})"
            )
        self._stop = threading.Event()
        self._expired = False
        self.started_t = time.time()
        # The server construction IS the warmup (library preload, replay
        # mount): only once it returns is the worker worth advertising.
        self.server = SimulationServer(config, host=host, port=0)

    # -- the advertisement --------------------------------------------

    def advertisement(self, *, retired: bool = False) -> dict:
        """The heartbeat payload the router scores claims from. Every
        field is a *hint* — the lease freshness beside it is the only
        liveness truth."""
        from yuma_simulation_tpu_torch.ops._build import process_stats

        service = self.server.service
        held = []
        if service.replay is not None:
            try:
                held = service.replay.cache.held_prefixes()
            except Exception:  # noqa: BLE001 — ads must never kill a beat
                logger.warning(
                    "held-prefix enumeration failed", exc_info=True
                )
        return {
            "worker_id": self.worker_id,
            "slot": self.slot,
            "url": self.server.url,
            # pid / heartbeat_t / requests_total are operator
            # forensics (read by humans off the lease file when a slot
            # wedges), deliberately not placement inputs — reviewed
            # wirecheck asymmetry, not drift.
            "pid": os.getpid(),
            "started_t": self.started_t,
            "heartbeat_t": time.time(),
            "inflight": len(service.queue),
            "requests_total": int(service._requests_total.value),
            "held_prefixes": held,
            "warm_buckets": service.warm_buckets(),
            # Cold-start proof for the autoscaler drill: a worker
            # spawned against a warm kernel-library cache must advertise
            # zero builds.
            "aot_builds": int(process_stats().builds),
            "retired": bool(retired),
        }

    def heartbeat(self, *, retired: bool = False) -> None:
        """One beat: renew the claim, then refresh the ad. Raises the
        typed :class:`LeaseExpired` when the claim was lost — the
        worker must stop serving rather than run unclaimed."""
        self.leases.renew(self.slot)
        self.leases.annotate(self.slot, self.advertisement(retired=retired))

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "ServeWorker":
        self.server.start()
        self.heartbeat()
        log_event(
            logger,
            "worker_ready",
            worker=self.worker_id,
            slot=self.slot,
            url=self.server.url,
        )
        return self

    def stop(self) -> None:
        """Request a graceful retire (signal-handler safe)."""
        self._stop.set()

    def run(self) -> int:
        """Serve until stopped (SIGTERM/SIGINT) or the lease is lost.
        Returns the process exit code."""
        signal.signal(signal.SIGTERM, lambda *_: self.stop())
        signal.signal(signal.SIGINT, lambda *_: self.stop())
        self.start()
        interval = max(0.05, self.ttl_seconds / 3.0)
        try:
            while not self._stop.wait(interval):
                try:
                    self.heartbeat()
                except LeaseExpired:
                    # Someone stole the slot (we stalled past TTL, or
                    # an operator tombstoned us): serving on would mean
                    # two workers answering one slot's traffic.
                    self._expired = True
                    log_event(
                        logger,
                        "worker_lease_lost",
                        worker=self.worker_id,
                        slot=self.slot,
                    )
                    break
        finally:
            self.close()
        return 1 if self._expired else 0

    def close(self) -> None:
        """Graceful retire: flip the ad to ``retired`` (routers stop
        placing new work immediately — before the drain), drain +
        publish the bundle, release the slot."""
        if not self._expired:
            try:
                self.heartbeat(retired=True)
            except LeaseExpired:
                self._expired = True
        self.server.close()
        if not self._expired:
            self.leases.release(self.slot)
        log_event(
            logger,
            "worker_stopped",
            worker=self.worker_id,
            slot=self.slot,
            expired=self._expired,
        )


def run_worker(args) -> int:
    """The ``--worker-pool`` CLI mode (see :mod:`.__main__`)."""
    from yuma_simulation_tpu_torch.serve.__main__ import _build_config
    from yuma_simulation_tpu_torch.utils.logging import setup_logging

    setup_logging()
    worker_id = args.worker_id or f"worker-{os.getpid()}"
    if not args.bundle_dir:
        args.bundle_dir = str(
            worker_bundle_dir(args.worker_pool, worker_id)
        )
    config = _build_config(args)
    worker = ServeWorker(
        args.worker_pool,
        args.worker_slot,
        worker_id,
        config,
        host=args.host,
        ttl_seconds=args.worker_ttl,
    )
    return worker.run()

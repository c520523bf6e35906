"""The stateless serving router: horizontal scale-out for the
warm-engine service.

One front-end process admits/prices every request through the SAME
:func:`.admission.admit` path the single-process service uses (typed
400s, zero launches), then places it on one of N warm
:mod:`.worker` processes discovered through the
:class:`..fabric.lease.LeaseStore` directory the workers heartbeat
into. The router holds NO request state worth preserving — every
placement decision is recomputed from the latest advertisements, so a
router restart loses nothing but in-flight sockets.

**Claim scoring** (:func:`claim_score` — pure, unit-testable): a
request is routed to the live worker with the highest

``(suffix_epochs_saved, warm_bucket, -inflight, stable_host_hash)``

- *suffix_epochs_saved*: for what-ifs, how many baseline epochs the
  worker's held :class:`..replay.statecache.StateCache` prefix lets it
  skip (``min(max held checkpoint, perturb epoch)``) — the whole point
  of affinity: repeated what-ifs land on the worker already holding
  the carry checkpoints;
- *warm_bucket*: the worker already ran this request's ``ExVxM``
  shape bucket (its buffers and plan are warm);
- *-inflight*: least-loaded among equals;
- *stable_host_hash*: a deterministic tiebreak so equal workers don't
  flap placement between heartbeats.

A dead worker (stale lease, torn/absent ad, ``retired`` flag) NEVER
wins: :func:`claim_score` returns ``None`` for it. A worker that dies
**mid-request** surfaces as a transport failure on the forward leg;
the router ledgers the typed ``worker_lost`` + ``request_rerouted``
events and retries the surviving workers — the client sees the
survivor's answer, never a connection reset. Only when every live
worker has been tried does the router answer, and even then it is the
typed, retryable :class:`..resilience.errors.WorkerLost` 503, not a
bare error.

The router prices for the device its workers run on
(:attr:`RouterConfig.device`, the card by default) and passes that
device to every worker it spawns (``--device``): a baseline key the
router resolves for a what-if names the same pinned rung as the key the
worker that builds it publishes, so affinity scores against the
workers' own held prefixes. Every worker is a fresh process started by
exec (``subprocess.Popen``), never a fork of a process that touched
CUDA, and holds its own CUDA context.

Run it: ``python -m yuma_simulation_tpu_torch.serve --router --worker-pool
DIR --workers N [--device cuda]`` (see ``--scaleout-drill`` for the
chaos proof).
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import json
import logging
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import uuid
from dataclasses import dataclass
from typing import Optional, Sequence, Union

from yuma_simulation_tpu_torch.fabric.lease import LeaseStore
from yuma_simulation_tpu_torch.resilience.errors import (
    AdmissionRejected,
    ClientRetriesExhausted,
    WorkerLost,
)
from yuma_simulation_tpu_torch.serve.admission import admit
from yuma_simulation_tpu_torch.serve.server import (
    SimulationClient,
    wait_until_ready,
)
from yuma_simulation_tpu_torch.serve.worker import (
    pool_leases_dir,
    worker_bundle_dir,
)
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

#: request kind -> worker POST route (the inverse of server._ROUTES).
_KIND_PATHS = {
    "simulate": "/v1/simulate",
    "sweep": "/v1/sweep",
    "table": "/v1/table",
    "whatif": "/v1/whatif",
}

#: Transport-level failures on a forward leg that mean "this worker is
#: gone", triggering a reroute (NOT a client-visible error).
_FORWARD_FAILURES = (
    ClientRetriesExhausted,
    urllib.error.URLError,
    ConnectionError,
    OSError,
)


# -- claim scoring (pure) ------------------------------------------------


def stable_host_hash(worker_id: str) -> int:
    """Deterministic per-worker tiebreak: equal-scored workers must not
    flap placement between heartbeats (stability keeps their caches
    divergent in a USEFUL way — each keeps winning its own tenants)."""
    digest = hashlib.sha256(worker_id.encode()).digest()
    return int.from_bytes(digest[:8], "big")


def canonical_key(key) -> str:
    """Content-addressed baseline keys cross a JSON boundary on their
    way through the heartbeat ad (tuples become lists, nested ones
    too): compare them in JSON form so a held prefix matches its own
    key regardless of which side of the wire it sits on."""
    return json.dumps(key, default=str, separators=(",", ":"))


def suffix_epochs_saved(
    ad: dict,
    baseline_key: Optional[Sequence],
    perturb_epoch: Optional[int],
) -> int:
    """Baseline epochs this worker's held state-cache prefix would let
    a what-if skip: the best on-disk carry checkpoint at or before the
    perturbation epoch, 0 when it holds nothing useful."""
    if baseline_key is None:
        return 0
    want = canonical_key(baseline_key)
    best = 0
    for held in ad.get("held_prefixes", ()):
        key = held.get("key")
        if key is None or canonical_key(key) != want:
            continue
        for cp in held.get("checkpoints", ()):
            cp = int(cp)
            if perturb_epoch is not None and cp > int(perturb_epoch):
                continue
            best = max(best, cp)
    return best


def claim_score(
    ad: dict,
    *,
    baseline_key: Optional[Sequence] = None,
    perturb_epoch: Optional[int] = None,
    bucket: Optional[str] = None,
) -> Optional[tuple]:
    """The placement score for one advertisement, or ``None`` when the
    worker can never win (not alive, or draining). Higher is better;
    compare tuples lexicographically."""
    if not ad.get("alive") or ad.get("retired"):
        return None
    saved = suffix_epochs_saved(ad, baseline_key, perturb_epoch)
    warm = (
        1 if bucket and bucket in tuple(ad.get("warm_buckets", ())) else 0
    )
    return (
        saved,
        warm,
        -int(ad.get("inflight", 0)),
        stable_host_hash(str(ad.get("worker_id", ""))),
    )


def rank_claims(
    ads: Sequence[dict],
    *,
    baseline_key: Optional[Sequence] = None,
    perturb_epoch: Optional[int] = None,
    bucket: Optional[str] = None,
) -> list[dict]:
    """Live workers best-first; dead ones dropped entirely."""
    scored = []
    for ad in ads:
        score = claim_score(
            ad,
            baseline_key=baseline_key,
            perturb_epoch=perturb_epoch,
            bucket=bucket,
        )
        if score is not None:
            scored.append((score, ad))
    scored.sort(key=lambda pair: pair[0], reverse=True)
    return [ad for _, ad in scored]


# -- the worker pool -----------------------------------------------------


class WorkerPool:
    """Spawns, observes, and retires the worker processes behind one
    pool directory. Discovery is reading the lease directory — the
    pool object is NOT the source of truth (a worker some other
    operator started is just as routable), it only owns the processes
    it spawned."""

    def __init__(
        self,
        pool_dir: Union[str, pathlib.Path],
        *,
        max_slots: int = 8,
        ttl_seconds: float = 3.0,
        worker_args: Sequence[str] = (),
        python: str = sys.executable,
        registry=None,
        spawn_wait_seconds: float = 120.0,
        device: str = "cuda",
    ):
        self.directory = pathlib.Path(pool_dir)
        #: Every spawned worker runs on this device (``--device``).
        self.device = str(device)
        self.max_slots = int(max_slots)
        self.ttl_seconds = float(ttl_seconds)
        self.worker_args = tuple(worker_args)
        self.python = python
        self.spawn_wait_seconds = float(spawn_wait_seconds)
        # Observer-only store: the router never claims a slot, it only
        # reads claims + ads. host_id still matters for tombstones.
        self.leases = LeaseStore(
            pool_leases_dir(self.directory),
            f"router-{os.getpid()}",
            ttl_seconds=ttl_seconds,
        )
        self._procs: dict[str, subprocess.Popen] = {}
        self._lost: set[str] = set()
        self._lock = threading.Lock()
        self._gauge = None
        if registry is not None:
            self._gauge = registry.gauge(
                "serve_workers_live",
                help="live serve workers (fresh lease + ad)",
            )

    def scan(self) -> list[dict]:
        """Every advertised worker with an ``alive`` verdict attached:
        fresh un-stealable lease, ad from the SAME holder, not retired,
        not marked lost by a failed forward."""
        ads = []
        with self._lock:
            lost = set(self._lost)
        for slot in range(self.max_slots):
            ad = self.leases.read_annotation(slot)
            if ad is None:
                continue
            info = self.leases.read(slot)
            alive = (
                info is not None
                and not self.leases.is_stealable(info)
                and info.host == ad.get("worker_id")
                and not ad.get("retired")
                and ad.get("worker_id") not in lost
                and bool(ad.get("url"))
            )
            ads.append(dict(ad, alive=alive, slot=slot))
        if self._gauge is not None:
            self._gauge.set(sum(1 for a in ads if a["alive"]))
        return ads

    def live(self) -> list[dict]:
        return [ad for ad in self.scan() if ad["alive"]]

    def _free_slot(self) -> int:
        for slot in range(self.max_slots):
            info = self.leases.read(slot)
            if info is None or self.leases.is_stealable(info):
                return slot
        raise RuntimeError(
            f"no free slot: all {self.max_slots} pool slots hold live "
            "leases"
        )

    def spawn(
        self, *, extra_argv: Sequence[str] = (), wait: bool = True
    ) -> dict:
        """Start one worker process on a free slot and (by default)
        block until its first advertisement answers ``/healthz``.
        Returns the worker's ad."""
        slot = self._free_slot()
        worker_id = f"w{slot}-{uuid.uuid4().hex[:6]}"
        argv = [
            self.python,
            "-m",
            "yuma_simulation_tpu_torch.serve",
            "--device",
            self.device,
            "--worker-pool",
            str(self.directory),
            "--worker-slot",
            str(slot),
            "--worker-id",
            worker_id,
            "--worker-ttl",
            str(self.ttl_seconds),
        ]
        # "{worker_id}" templating lets per-worker paths (a private
        # replay cache, a private bundle) ride one shared argv.
        for arg in (*self.worker_args, *extra_argv):
            argv.append(str(arg).replace("{worker_id}", worker_id))
        logdir = worker_bundle_dir(self.directory, worker_id).parent
        logdir.mkdir(parents=True, exist_ok=True)
        logfile = open(logdir / "worker.log", "ab")
        # Exec, never fork: a forked child of a process that touched
        # CUDA cannot use the card. The package's root rides PYTHONPATH
        # so a router started from any directory spawns importable
        # workers.
        env = dict(os.environ)
        root = str(pathlib.Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in [root, env.get("PYTHONPATH", "")] if p
        )
        try:
            proc = subprocess.Popen(
                argv, stdout=logfile, stderr=subprocess.STDOUT, env=env
            )
        finally:
            logfile.close()
        with self._lock:
            self._procs[worker_id] = proc
        log_event(
            logger, "worker_spawning", worker=worker_id, slot=slot,
            pid=proc.pid,
        )
        if not wait:
            return {"worker_id": worker_id, "slot": slot, "alive": False}
        deadline = time.monotonic() + self.spawn_wait_seconds
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"worker {worker_id} exited rc={proc.returncode} "
                    f"before advertising (see {logdir / 'worker.log'})"
                )
            for ad in self.scan():
                if ad.get("worker_id") == worker_id and ad["alive"]:
                    if wait_until_ready(ad["url"], timeout=5.0):
                        return ad
            time.sleep(0.05)
        proc.kill()
        raise RuntimeError(
            f"worker {worker_id} did not become ready within "
            f"{self.spawn_wait_seconds:.0f}s"
        )

    def mark_lost(self, worker_id: str) -> bool:
        """Record a worker observed dead on a forward leg so routing
        stops considering it before its lease even expires. Returns
        True the FIRST time (callers ledger ``worker_lost`` once)."""
        with self._lock:
            if worker_id in self._lost:
                return False
            self._lost.add(worker_id)
        return True

    def owned(self) -> list[str]:
        with self._lock:
            return list(self._procs)

    def retire(self, worker_id: str, *, timeout: float = 30.0) -> bool:
        """Graceful SIGTERM retire of a pool-owned worker: it flips its
        ad, drains, publishes its bundle, releases its slot."""
        with self._lock:
            proc = self._procs.get(worker_id)
        if proc is None:
            return False
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
        with self._lock:
            self._procs.pop(worker_id, None)
        return True

    def kill(self, worker_id: str) -> bool:
        """SIGKILL (the chaos drill's mid-request crash): no drain, no
        release — the lease goes stale and the router reroutes."""
        with self._lock:
            proc = self._procs.get(worker_id)
        if proc is None or proc.poll() is not None:
            return False
        proc.kill()
        proc.wait(timeout=10.0)
        return True

    def close(self) -> None:
        for worker_id in self.owned():
            try:
                self.retire(worker_id)
            except Exception:  # noqa: BLE001 — best-effort teardown
                logger.warning(
                    "retire of %s failed", worker_id, exc_info=True
                )


# -- the router service --------------------------------------------------


@dataclass(frozen=True)
class RouterConfig:
    """Everything the stateless front-end needs. ``worker_args`` is
    forwarded verbatim to every spawned worker's CLI (with
    ``{worker_id}`` substituted), so the pool's serve knobs — replay
    mounts, kernel-library cache, warmup shapes — live in ONE place.
    ``device`` is where the workers run (each is passed ``--device``)
    and the device the router prices and resolves baseline keys for."""

    pool_dir: str = "serve-pool"
    workers: int = 2
    max_workers: int = 8
    worker_args: tuple = ()
    lease_ttl_seconds: float = 3.0
    bundle_dir: Optional[str] = None
    api_keys_path: Optional[str] = None
    #: affinity=False routes purely by load (the drill's control arm).
    affinity: bool = True
    #: extra placement attempts after the first (each on a distinct
    #: worker) before the typed WorkerLost 503.
    reroute_attempts: int = 3
    default_deadline_seconds: float = 120.0
    max_batch: int = 8
    tenant_priority: Optional[dict] = None
    forward_timeout: float = 120.0
    spawn_wait_seconds: float = 120.0
    #: Router-side replay mount (read-only pricing + affinity keys):
    #: MUST use the same archive + replay geometry as the workers or
    #: the content-addressed baseline keys will not match theirs.
    replay_archive_dir: Optional[str] = None
    replay_cache_dir: Optional[str] = None
    replay_window: Optional[int] = None
    replay_epochs_per_snapshot: int = 4
    replay_stride: int = 8
    replay_max_baselines: int = 64
    #: The workers' device: "cuda" (the default; raises without CUDA)
    #: or "cpu". Never a fallback.
    device: str = "cuda"


class RouterService:
    """Drop-in for :class:`.service.SimulationService` behind
    :class:`.server.SimulationServer` (same ``handle`` contract), but
    ``handle`` PLACES work instead of executing it."""

    def __init__(self, config: Optional[RouterConfig] = None, registry=None):
        from yuma_simulation_tpu_torch.resilience.supervisor import FailureLedger
        from yuma_simulation_tpu_torch.simulation.engine import resolve_device
        from yuma_simulation_tpu_torch.telemetry.metrics import get_registry
        from yuma_simulation_tpu_torch.telemetry.runctx import RunContext
        from yuma_simulation_tpu_torch.telemetry.slo import get_slo_engine

        self.config = config if config is not None else RouterConfig()
        # The workers' device, resolved once (raises without CUDA unless
        # the CPU was asked for): admission prices for it and the replay
        # mount resolves baseline keys for it. The router itself never
        # launches anything.
        self.device = resolve_device(self.config.device)
        self.registry = registry if registry is not None else get_registry()
        self.run = RunContext()
        self.slo = get_slo_engine()
        self.keyring = None
        if self.config.api_keys_path:
            from yuma_simulation_tpu_torch.serve.apikeys import ApiKeyring

            self.keyring = ApiKeyring.load(self.config.api_keys_path)
        bundle_dir = self.config.bundle_dir
        if bundle_dir is not None:
            pathlib.Path(bundle_dir).mkdir(parents=True, exist_ok=True)
        self.ledger = FailureLedger(
            pathlib.Path(bundle_dir) / "ledger.jsonl"
            if bundle_dir is not None
            else None
        )
        self._ledger_lock = threading.Lock()
        self._requests_total = self.registry.counter(
            "serve_requests_total", help="serving-tier requests handled"
        )
        self._admission_rejected = self.registry.counter(
            "serve_admission_rejected",
            help="typed admission rejections (pre-compile)",
        )
        self._request_seconds = self.registry.histogram(
            "serve_request_seconds",
            help="request wall time, admission to reply",
        )
        self._reroutes = self.registry.counter(
            "serve_reroutes_total",
            help="forward legs rerouted off a lost worker",
        )
        self._affinity_hits = self.registry.counter(
            "affinity_hits_total",
            help="requests placed on a worker holding useful state "
            "(cache prefix or warm bucket)",
        )
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
        self.pool = WorkerPool(
            self.config.pool_dir,
            max_slots=self.config.max_workers,
            ttl_seconds=self.config.lease_ttl_seconds,
            worker_args=self.config.worker_args,
            registry=self.registry,
            spawn_wait_seconds=self.config.spawn_wait_seconds,
            device=self.config.device,
        )
        self._clients: dict[str, SimulationClient] = {}
        self._clients_lock = threading.Lock()
        self._ingress_lock = threading.Lock()
        self._ingress_runs: list = []
        self._publish_lock = threading.Lock()
        self._counter = itertools.count(1)
        #: affinity-off placement cursor (plain round-robin).
        self._rr = itertools.count()
        self.started_t = time.time()
        self._stopping = False
        self._closed = False

    # -- bookkeeping --------------------------------------------------

    def _append_ledger(self, event: str, **fields) -> None:
        with self._ledger_lock:
            self.ledger.append(event, **fields)

    def _append_ledger_rootspan(self, event: str, **fields) -> None:
        with self._rootspan(f"{event}:{fields.get('request', '')}"):
            self._append_ledger(event, **fields)

    @contextlib.contextmanager
    def _rootspan(self, name: str):
        """A fresh root span of the ROUTER run, for ledger records born
        outside any request span (pool lifecycle) — they must still
        resolve under ``obsreport --check``'s span gate."""
        from yuma_simulation_tpu_torch.telemetry.runctx import span

        with self.run.activate():
            with span(name, root=True):
                yield

    def mint_request_id(self) -> str:
        return f"g{next(self._counter):06d}"

    def _remember_ingress(self, run) -> None:
        flush = None
        with self._ingress_lock:
            self._ingress_runs.append(run)
            if len(self._ingress_runs) > 256:
                flush, self._ingress_runs = self._ingress_runs, []
        if flush and self.config.bundle_dir is not None:
            from yuma_simulation_tpu_torch.telemetry.flight import FlightRecorder

            try:
                with self._publish_lock:
                    FlightRecorder(self.config.bundle_dir).append_spans(
                        flush
                    )
            except Exception:  # noqa: BLE001 — telemetry must not kill serving
                logger.warning(
                    "router ingress flush failed", exc_info=True
                )

    # -- pool lifecycle ----------------------------------------------

    def start_workers(self, count: Optional[int] = None) -> list[dict]:
        """Bring up the initial fleet (``RouterConfig.workers`` by
        default); each spawn is a ledgered ``worker_spawned``."""
        ads = []
        for _ in range(self.config.workers if count is None else count):
            ads.append(self.spawn_worker())
        return ads

    def spawn_worker(self, *, reason: str = "startup") -> dict:
        ad = self.pool.spawn()
        with self._rootspan("worker_spawned:"):
            self._append_ledger(
                "worker_spawned",
                request="",
                worker=ad.get("worker_id", "?"),
                slot=ad.get("slot", -1),
                url=ad.get("url", ""),
                reason=reason,
                aot_builds=int(ad.get("aot_builds", 0)),
            )
        return ad

    def retire_worker(self, worker_id: str, *, reason: str = "idle") -> bool:
        ok = self.pool.retire(worker_id)
        if ok:
            with self._rootspan("worker_retired:"):
                self._append_ledger(
                    "worker_retired",
                    request="",
                    worker=worker_id,
                    reason=reason,
                )
        return ok

    # -- the request path --------------------------------------------

    def handle(
        self, kind: str, payload, *, request_id=None, trace=None,
        api_key=None,
    ) -> tuple[int, dict, dict]:
        """Same contract as ``SimulationService.handle``: one typed
        ``(status, body, headers)`` for every input, no bare errors."""
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
        self._requests_total.inc()
        if self.keyring is not None:
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
                try:
                    status, body, headers, worker, affinity = self._route(
                        kind, payload, rid, tenant
                    )
                except BaseException:  # noqa: BLE001 — no-bare-500 backstop
                    logger.exception(
                        "unhandled router failure for %s", rid
                    )
                    status = 500
                    body = {
                        "status": "failed",
                        "error": "RouterError",
                        "message": "unexpected router failure",
                        "retryable": True,
                        "request_id": rid,
                    }
                    headers, worker, affinity = {}, None, False
                if s is not None:
                    s.attrs["status"] = status
                    s.attrs["outcome"] = body.get("status", "?")
                    if worker:
                        s.attrs["worker"] = worker
                headers = dict(headers)
                headers.setdefault("X-Request-Id", rid)
                self._append_ledger(
                    "request_done",
                    request=rid,
                    tenant=tenant,
                    endpoint=kind,
                    status=status,
                    outcome=body.get("status", "?"),
                    worker=worker or "",
                    affinity=bool(affinity),
                )
        elapsed = time.perf_counter() - t0
        self._request_seconds.observe(elapsed)
        self.slo.observe("serve_request_seconds", elapsed)
        self.slo.event("serve_request_ok", status < 500)
        self.slo.event("serve_admitted", status != 429)
        if ingress is not None:
            self._remember_ingress(ingress)
        return status, body, headers

    def _route(
        self, kind: str, payload, rid: str, tenant: str
    ) -> tuple[int, dict, dict, Optional[str], bool]:
        from yuma_simulation_tpu_torch.telemetry.runctx import span

        if self._stopping:
            return (
                503,
                {
                    "status": "shutting_down",
                    "error": "ServiceUnavailable",
                    "message": "the router is draining; retry elsewhere",
                    "request_id": rid,
                },
                {"Retry-After": "5"},
                None,
                False,
            )
        # Admission FIRST, in the router process: malformed or
        # un-runnable work is a typed 400 before any forward leg, and
        # the ticket's plan/spec is what affinity scores against.
        try:
            ticket = admit(
                payload,
                request_id=rid,
                kind=kind,
                default_deadline_seconds=(
                    self.config.default_deadline_seconds
                ),
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
            return 400, body, {}, None, False

        baseline_key = None
        perturb_epoch = None
        bucket = None
        if self.config.affinity:
            plan_bucket = getattr(ticket.plan, "bucket", None)
            if plan_bucket is not None:
                bucket = (
                    f"{plan_bucket.epochs}x{plan_bucket.V}"
                    f"x{plan_bucket.M}"
                )
            if ticket.whatif is not None and self.replay is not None:
                try:
                    desc = self.replay.describe(ticket.whatif)
                    baseline_key = desc["key"]
                    perturb_epoch = int(ticket.whatif.from_epoch)
                except Exception:  # noqa: BLE001 — affinity is best-effort
                    logger.warning(
                        "affinity describe failed for %s", rid,
                        exc_info=True,
                    )

        forward_payload = (
            dict(payload, tenant=ticket.tenant)
            if isinstance(payload, dict)
            else {"tenant": ticket.tenant}
        )
        attempted: list[str] = []
        for attempt in range(self.config.reroute_attempts + 1):
            ads = [
                ad
                for ad in self.pool.scan()
                if ad.get("worker_id") not in attempted
            ]
            if self.config.affinity:
                ranked = rank_claims(
                    ads,
                    baseline_key=baseline_key,
                    perturb_epoch=perturb_epoch,
                    bucket=bucket,
                )
            else:
                # No affinity: plain round-robin over the live workers
                # (slot order) — the drill's control arm, and the
                # neutral policy for state-free deployments.
                alive = sorted(
                    (ad for ad in ads if ad["alive"]),
                    key=lambda a: int(a.get("slot", 0)),
                )
                if alive:
                    start = next(self._rr) % len(alive)
                    ranked = alive[start:] + alive[:start]
                else:
                    ranked = []
            if not ranked:
                break
            ad = ranked[0]
            worker_id = str(ad.get("worker_id", "?"))
            attempted.append(worker_id)
            score = claim_score(
                ad,
                baseline_key=baseline_key,
                perturb_epoch=perturb_epoch,
                bucket=bucket,
            )
            affinity_hit = bool(score) and (score[0] > 0 or score[1] > 0)
            with span(
                f"route:{worker_id}",
                request=rid,
                worker=worker_id,
                attempt=attempt,
                affinity=affinity_hit,
            ):
                try:
                    resp = self._forward(ad, kind, forward_payload, tenant)
                except _FORWARD_FAILURES as exc:
                    lost = WorkerLost(
                        f"worker {worker_id} lost mid-request "
                        f"{rid}: {exc}",
                        worker_id=worker_id,
                        attempts=attempt + 1,
                    )
                    if self.pool.mark_lost(worker_id):
                        self._append_ledger(
                            "worker_lost",
                            request=rid,
                            worker=worker_id,
                            error=type(exc).__name__,
                            message=str(lost)[:200],
                        )
                        log_event(
                            logger,
                            "worker_lost",
                            worker=worker_id,
                            request=rid,
                        )
                    self._reroutes.inc()
                    self._append_ledger(
                        "request_rerouted",
                        request=rid,
                        tenant=tenant,
                        worker=worker_id,
                        attempt=attempt,
                    )
                    continue
            if affinity_hit:
                self._affinity_hits.inc()
            headers = {
                k: v
                for k, v in resp.headers.items()
                if k in ("Retry-After", "Server-Timing")
            }
            headers["X-Worker"] = worker_id
            return resp.status, dict(resp.body), headers, worker_id, (
                affinity_hit
            )
        # Every live worker tried (or none left): typed + retryable.
        return (
            503,
            {
                "status": "failed",
                "error": "WorkerLost",
                "message": (
                    f"no live worker could serve request {rid} "
                    f"({len(attempted)} attempt(s): "
                    f"{', '.join(attempted) or 'no live workers'})"
                ),
                "retryable": True,
                "request_id": rid,
            },
            {"Retry-After": "1"},
            None,
            False,
        )

    def _forward(self, ad: dict, kind: str, payload: dict, tenant: str):
        """One forward leg to one worker. ``retries=0``: the router's
        reroute loop IS the retry policy (retrying the same dead
        worker would just burn the deadline)."""
        url = str(ad["url"])
        with self._clients_lock:
            client = self._clients.get(url)
            if client is None:
                client = SimulationClient(
                    url,
                    tenant=tenant,
                    timeout=self.config.forward_timeout,
                    retries=0,
                )
                self._clients[url] = client
        path = _KIND_PATHS.get(kind)
        if path is None:
            raise AdmissionRejected(  # pragma: no cover — admit() gates kinds
                f"unknown kind {kind!r}"
            )
        return client._request("POST", path, payload)

    # -- ops surface --------------------------------------------------

    def replay_get(self, path: str) -> tuple[int, dict]:
        """GET /v1/replay[/NETUID] — answered from the router's own
        read-only replay mount (index reads, no state materialized)."""
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
                    "message": f"no replay route {path!r}",
                }
            return 200, {
                "status": "ok",
                **self.replay.timeline_info(int(tail)),
            }
        except (ArchiveError, KeyError, ValueError) as exc:
            return 404, {
                "status": "rejected",
                "error": "NotFound",
                "message": str(exc)[:200],
            }

    def healthz(self) -> dict:
        ads = self.pool.scan()
        live = [ad for ad in ads if ad["alive"]]
        return {
            "status": "draining" if self._stopping else (
                "ok" if live else "degraded"
            ),
            "ready": not self._stopping and bool(live),
            "role": "router",
            "uptime_seconds": round(time.time() - self.started_t, 3),
            "run_id": self.run.run_id,
            "requests_total": int(self._requests_total.value),
            "workers": {
                "live": len(live),
                "advertised": len(ads),
                "ids": sorted(ad["worker_id"] for ad in live),
            },
            "affinity": self.config.affinity,
        }

    def metrics_text(self) -> str:
        return self.registry.prometheus_text()

    def close(self) -> None:
        """Drain: stop placing, retire the owned workers gracefully,
        publish the router's own flight bundle."""
        if self._closed:
            return
        self._closed = True
        self._stopping = True
        self.pool.close()
        if self.config.bundle_dir is not None:
            from yuma_simulation_tpu_torch.telemetry.flight import (
                METRICS_NAME,
                FlightRecorder,
            )

            with self._ingress_lock:
                ingress = self._ingress_runs
                self._ingress_runs = []
            try:
                with self._publish_lock:
                    rec = FlightRecorder(self.config.bundle_dir)
                    rec.record(self.run, extra_runs=ingress)
                    self.registry.publish_snapshot(
                        pathlib.Path(self.config.bundle_dir)
                        / METRICS_NAME,
                        run_id=self.run.run_id,
                    )
                    rec.record_slo(self.slo, run_id=self.run.run_id)
            except Exception:  # noqa: BLE001 — teardown telemetry is best-effort
                logger.warning(
                    "router bundle publish failed", exc_info=True
                )
        log_event(
            logger,
            "router_stopped",
            requests=int(self._requests_total.value),
        )

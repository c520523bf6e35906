"""CLI: ``python -m yuma_simulation_tpu_torch.serve`` — run (or smoke) the
warm-engine simulation service.

Foreground mode serves until interrupted; ``--smoke`` is the contract
drill: start a server on an ephemeral port, fire one of each
contract-defining request — a happy path, a structured admission
rejection, a quota shed (429 + Retry-After), and a coalesced same-bucket
pair — then shut down gracefully and leave the flight bundle for
``python -m tools.obsreport BUNDLE --check`` to gate. Exit 0 only when
every expectation held.

The service runs on the card (``--device cuda``, the default; without
CUDA it raises); ``--device cpu`` runs it on the CPU. The multi-process
modes take the same flag and pass it on: ``--worker-pool DIR`` runs one
pool worker, ``--router --worker-pool DIR --workers N`` spawns N workers
(each exec'd with the router's ``--device``) and places requests on them,
``--scaleout-drill`` is the kill-a-worker chaos drill, and
``--replay-controller DIR`` co-hosts the continuous replay controller
beside the service.
"""

from __future__ import annotations

import argparse
import concurrent.futures


def _build_config(args, **overrides) -> "ServeConfig":  # noqa: F821
    from yuma_simulation_tpu_torch.serve.service import ServeConfig

    return ServeConfig(
        **overrides,
        device=args.device,
        queue_limit=args.queue_limit,
        coalesce_window_seconds=args.coalesce_window,
        max_batch=args.max_batch,
        tenant_rate=args.tenant_rate,
        tenant_burst=args.tenant_burst,
        default_deadline_seconds=args.deadline,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_seconds=args.breaker_cooldown,
        bundle_dir=args.bundle_dir,
        warmup_shapes=tuple(
            tuple(int(d) for d in shape.split("x"))
            for shape in (args.warmup or [])
        ),
        canary_interval_seconds=args.canary_interval,
        executable_cache_dir=args.executable_cache,
        replay_archive_dir=args.replay_archive,
        replay_cache_dir=args.replay_cache,
        replay_epochs_per_snapshot=args.replay_epochs_per_snapshot,
        replay_stride=args.replay_stride,
        api_keys_path=getattr(args, "api_keys", None),
        flight_rotation=getattr(args, "rotate_flight", False) or None,
    )


def run_smoke(args) -> int:
    """The serve smoke drill (see module docstring), on ``args.device``."""
    from yuma_simulation_tpu_torch.serve.server import (
        SimulationClient,
        SimulationServer,
        wait_until_ready,
    )
    from yuma_simulation_tpu_torch.utils import setup_logging

    setup_logging()
    failures: list[str] = []

    def expect(cond: bool, what: str) -> None:
        print(("ok   " if cond else "FAIL ") + what)
        if not cond:
            failures.append(what)

    # The greedy tenant gets a NON-REFILLING bucket (rate 0): its burst
    # deterministically exhausts regardless of how fast this runner
    # executes requests — the shed path must not depend on a race
    # between the drill loop and the refill clock.
    server = SimulationServer(
        _build_config(
            args, tenant_overrides={"greedy": (0.0, args.tenant_burst)}
        )
    ).start()
    try:
        expect(wait_until_ready(server.url), "server answers /healthz")
        client = SimulationClient(server.url, tenant="smoke")

        # Happy path: a built-in case through the full pipeline, with
        # the correlation contract — an X-Request-Id echo that
        # resolves into the flight bundle and a Server-Timing
        # critical-path breakdown.
        r = client.simulate(case="Case 1")
        expect(
            r.status == 200 and r.body.get("status") == "ok",
            f"happy path simulate -> 200 ok (got {r.status} "
            f"{r.body.get('status')})",
        )
        expect(
            r.request_id is not None,
            f"happy path echoes X-Request-Id (got {r.request_id})",
        )
        timing = r.server_timing
        expect(
            "execute" in timing and "queue" in timing,
            f"happy path returns Server-Timing critical path "
            f"(got {sorted(timing)})",
        )

        # Structured admission rejection: malformed payload, typed 400 —
        # STILL carrying the request id (rejections must correlate too).
        r = client.simulate(weights=[[1.0]])  # wrong rank, no stakes
        expect(
            r.status == 400 and r.body.get("error") == "AdmissionRejected",
            f"malformed payload -> 400 AdmissionRejected (got {r.status} "
            f"{r.body.get('error')})",
        )
        expect(
            r.request_id is not None,
            "rejection echoes X-Request-Id",
        )

        # Quota shed: exhaust one tenant's burst back-to-back; the
        # bucket refills at tenant_rate, so with the smoke's small burst
        # a tight loop must see a 429 with Retry-After.
        greedy = SimulationClient(server.url, tenant="greedy")
        shed = None
        for _ in range(args.tenant_burst + 2):
            r = greedy.simulate(case="Case 2")
            if r.status == 429:
                shed = r
                break
        expect(
            shed is not None
            and shed.retry_after is not None
            and shed.body.get("error") == "QueueOverflow",
            "tenant burst -> 429 QueueOverflow with Retry-After",
        )

        # Coalescing: two same-bucket requests in flight together ride
        # one donor-packed dispatch (coalesced=2 on both responses).
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futs = [
                pool.submit(
                    SimulationClient(server.url, tenant=f"t{i}").simulate,
                    case="Case 3",
                )
                for i in range(2)
            ]
            results = [f.result() for f in futs]
        expect(
            all(r.status == 200 for r in results)
            and max(r.body.get("coalesced", 1) for r in results) >= 2,
            "concurrent same-bucket pair -> coalesced dispatch",
        )

        # The acceptance metrics surface on /metrics.
        metrics = client.metrics()
        for series in (
            "serve_queue_depth",
            "serve_requests_shed",
            "serve_breaker_open",
        ):
            expect(series in metrics, f"/metrics exposes {series}")

        # The SLO surface: /healthz reflects burn state (healthy here).
        h = client.healthz()
        expect(
            h.body.get("ready") is True and "slo" in h.body,
            f"/healthz reports SLO readiness (got {h.body.get('slo')})",
        )

        # The numerics canary: one forced tick through a warm
        # bucket must compare the primary rung against its demoted
        # fallback drift-clean, and /healthz must surface the tick.
        state = server.service.run_canary_once()
        expect(
            state is not None
            and state.get("ticks", 0) >= 1
            and state.get("drift", 0) == 0,
            f"numerics canary tick drift-clean (got {state})",
        )
        h = client.healthz()
        expect(
            h.body.get("canary", {}).get("ticks", 0) >= 1
            and h.body.get("status") == "ok",
            f"/healthz surfaces the canary tick, still ok "
            f"(got {h.body.get('canary')})",
        )
    finally:
        server.close()
        if args.executable_cache:
            # The cold-start artifact: process-lifetime cache stats
            # (hits/misses/builds) beside the artifacts, so the CI
            # cold-start lane asserts on run 2's copy.
            from yuma_simulation_tpu_torch.simulation.aot import active_cache

            cache = active_cache()
            if cache is not None:
                cache.write_stats()

    if failures:
        print(f"\nserve smoke FAILED ({len(failures)} expectation(s))")
        return 1
    print("\nserve smoke passed")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m yuma_simulation_tpu_torch.serve",
        description=__doc__.split("\n\n")[0],
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument(
        "--bundle-dir",
        default=None,
        help="flight-bundle directory (spans + request ledger + metrics)",
    )
    parser.add_argument("--queue-limit", type=int, default=64)
    parser.add_argument("--coalesce-window", type=float, default=0.05)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--tenant-rate", type=float, default=20.0)
    parser.add_argument("--tenant-burst", type=int, default=10)
    parser.add_argument("--deadline", type=float, default=120.0)
    parser.add_argument("--breaker-threshold", type=int, default=3)
    parser.add_argument("--breaker-cooldown", type=float, default=30.0)
    parser.add_argument(
        "--canary-interval",
        type=float,
        default=0.0,
        help="background numerics-canary cadence in seconds (0 "
        "disables): re-execute a warm shape bucket on the demoted "
        "rung and compare per-epoch fingerprints",
    )
    parser.add_argument(
        "--warmup",
        action="append",
        metavar="ExVxM",
        help="warm this shape at startup (repeatable), e.g. 40x3x2",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="the device the service runs on (default: the card; without "
        "CUDA this raises: pass --device cpu to run on the CPU)",
    )
    parser.add_argument(
        "--executable-cache",
        default=None,
        metavar="DIR",
        help="kernel-library cache directory (simulation.aot): warmup "
        "loads published libraries, misses build once and publish for "
        "the next process",
    )
    parser.add_argument(
        "--replay-archive",
        default=None,
        metavar="DIR",
        help="snapshot-timeline archive root (replay/): mounts "
        "POST /v1/whatif and GET /v1/replay when --replay-cache is "
        "also set",
    )
    parser.add_argument(
        "--replay-cache",
        default=None,
        metavar="DIR",
        help="epoch-state cache root for what-if suffix resume",
    )
    parser.add_argument(
        "--replay-epochs-per-snapshot", type=int, default=4,
        help="epochs each archived snapshot contributes to the replay "
        "scenario",
    )
    parser.add_argument(
        "--replay-stride", type=int, default=8,
        help="carry-checkpoint stride (epochs) of cached baselines",
    )
    parser.add_argument(
        "--replay-controller",
        default=None,
        metavar="DIR",
        help="co-host the continuous replay controller: sweep the "
        "mounted --replay-archive into this store root (durable "
        "watermarks, incremental fleet windows) on a background "
        "thread, keeping the shared --replay-cache warm for what-ifs",
    )
    parser.add_argument(
        "--replay-versions",
        nargs="+",
        default=["Yuma 2 (Adrian-Fish)"],
        help="Yuma variants the co-hosted controller sweeps",
    )
    parser.add_argument(
        "--api-keys",
        default=None,
        metavar="PATH",
        help="signed-API-key keyfile (JSON tenant -> secret): requests "
        "must present a valid X-Api-Key and the verified tenant "
        "replaces any payload claim (typed 401 otherwise)",
    )
    parser.add_argument(
        "--rotate-flight",
        action="store_true",
        help="segmented flight-recorder rotation for the bundle: "
        "spans/metrics/numerics append into crash-safe size/age-bounded "
        "segments under BUNDLE/segments/ (default: monolithic files; "
        "YUMA_TPU_FLIGHT_ROTATE=1 also opts in)",
    )
    parser.add_argument(
        "--smoke",
        action="store_true",
        help="CI smoke: ephemeral port, contract-defining requests, "
        "graceful shutdown, exit nonzero on any miss",
    )
    # -- horizontal scale-out ----------------------------------------
    scale = parser.add_argument_group(
        "scale-out",
        "worker-pool mode (one warm worker claiming a lease slot), "
        "router mode (the stateless front placing onto the pool), and "
        "the kill-a-worker chaos drill",
    )
    scale.add_argument(
        "--worker-pool",
        default=None,
        metavar="DIR",
        help="join this pool directory as a WORKER: claim "
        "--worker-slot, serve on an ephemeral port, heartbeat "
        "state-cache/warm-bucket advertisements",
    )
    scale.add_argument(
        "--worker-slot", type=int, default=0,
        help="pool slot (lease unit) this worker claims",
    )
    scale.add_argument(
        "--worker-id", default=None,
        help="stable worker identity (default: worker-<pid>)",
    )
    scale.add_argument(
        "--worker-ttl", type=float, default=3.0,
        help="lease TTL seconds: miss heartbeats this long and the "
        "router treats the worker as dead",
    )
    scale.add_argument(
        "--router",
        action="store_true",
        help="run the stateless ROUTER: spawn --workers warm workers "
        "into --worker-pool (each exec'd with this --device) and place "
        "every request by state-cache affinity",
    )
    scale.add_argument(
        "--workers", type=int, default=2,
        help="initial worker count for --router",
    )
    scale.add_argument(
        "--max-workers", type=int, default=8,
        help="pool slot ceiling (router + autoscaler)",
    )
    scale.add_argument(
        "--no-affinity",
        action="store_true",
        help="router: round-robin placement instead of "
        "state-cache-affinity claim scoring",
    )
    scale.add_argument(
        "--worker-arg",
        action="append",
        default=None,
        metavar="ARG",
        help="extra CLI arg forwarded to every spawned worker "
        "(repeatable; '{worker_id}' substitutes)",
    )
    scale.add_argument(
        "--scaleout-drill",
        action="store_true",
        help="chaos drill: 3 workers + router, kill one mid-load, "
        "prove typed reroutes + affinity + autoscaler, merge and "
        "gate every flight bundle; exit nonzero on any miss",
    )
    args = parser.parse_args(argv)

    if args.smoke:
        return run_smoke(args)
    if args.scaleout_drill:
        from yuma_simulation_tpu_torch.serve.drill import run_scaleout_drill

        return run_scaleout_drill(args)
    if args.worker_pool and not args.router:
        from yuma_simulation_tpu_torch.serve.worker import run_worker

        return run_worker(args)

    from yuma_simulation_tpu_torch.utils import setup_logging

    setup_logging()
    if args.router:
        from yuma_simulation_tpu_torch.serve.router import (
            RouterConfig,
            RouterService,
        )
        from yuma_simulation_tpu_torch.serve.server import SimulationServer

        if not args.worker_pool:
            parser.error("--router requires --worker-pool DIR")
        router = RouterService(
            RouterConfig(
                pool_dir=args.worker_pool,
                workers=args.workers,
                max_workers=args.max_workers,
                worker_args=tuple(args.worker_arg or ()),
                lease_ttl_seconds=args.worker_ttl,
                bundle_dir=args.bundle_dir,
                api_keys_path=args.api_keys,
                affinity=not args.no_affinity,
                default_deadline_seconds=args.deadline,
                max_batch=args.max_batch,
                replay_archive_dir=args.replay_archive,
                replay_cache_dir=args.replay_cache,
                replay_epochs_per_snapshot=(
                    args.replay_epochs_per_snapshot
                ),
                replay_stride=args.replay_stride,
                device=args.device,
            )
        )
        router.start_workers()
        server = SimulationServer(
            service=router, host=args.host, port=args.port
        )
        print(
            f"routing on {server.url} "
            f"({args.workers} workers on {args.device}; Ctrl-C to stop)"
        )
        server.serve_forever()
        return 0

    from yuma_simulation_tpu_torch.serve.server import SimulationServer

    if args.replay_controller and not (
        args.replay_archive and args.replay_cache
    ):
        parser.error(
            "--replay-controller requires --replay-archive and "
            "--replay-cache"
        )
    server = SimulationServer(
        _build_config(args), host=args.host, port=args.port
    )
    stop = None
    if args.replay_controller:
        stop = start_replay_controller(args, server.service.device)
        print(f"replay controller sweeping into {args.replay_controller}")
    print(f"serving on {server.url} (Ctrl-C to stop)")
    try:
        server.serve_forever()
    finally:
        if stop is not None:
            stop.set()
    return 0


#: The co-hosted replay controller's thread: besides the service's
#: dispatcher (and its watchdog workers), the one thread of a serving
#: process that launches work on the device.
CONTROLLER_THREAD = "replay-controller"


def start_replay_controller(args, device):
    """Start the co-hosted continuous replay controller on a daemon
    thread named :data:`CONTROLLER_THREAD`, its sweeps on `device` (the
    service's). The thread makes `device` its current CUDA device before
    its first launch. Returns the event that stops it."""
    import threading

    from yuma_simulation_tpu_torch.replay import (
        ControllerConfig,
        ReplayController,
        SnapshotArchive,
        StateCache,
    )

    # The co-hosted controller sweeps into the SAME cache the what-if
    # handlers resume from, so serving traffic rides warm carries the
    # standing sweep keeps extending.
    controller = ReplayController(
        SnapshotArchive(args.replay_archive),
        StateCache(args.replay_cache),
        ControllerConfig(
            store_root=args.replay_controller,
            versions=tuple(args.replay_versions),
            epochs_per_snapshot=args.replay_epochs_per_snapshot,
            stride=args.replay_stride,
            device=str(device),
        ),
    )
    stop = threading.Event()

    def sweep() -> None:
        if device.type == "cuda":
            import torch

            torch.cuda.set_device(device)
        controller.run_forever(stop=stop.is_set)

    threading.Thread(target=sweep, name=CONTROLLER_THREAD, daemon=True).start()
    return stop


if __name__ == "__main__":
    raise SystemExit(main())

"""The scale-out chaos drill (``--scaleout-drill``): the CI proof that
the horizontal serving tier survives a worker killed mid-load.

What it stages, on one machine with real processes and real sockets:

1. a synthetic snapshot archive (two subnets; 3 x 4 by default), a
   shared kernel-library cache, and a 3-worker pool behind one
   :class:`.router.RouterService` front, every worker exec'd with the
   drill's ``--device`` (the card by default) and warming the kill
   load's shape at startup;
2. **affinity proof**: repeated what-ifs for one subnet all route to
   the worker that built the baseline (``X-Worker`` stable,
   ``cache_hit`` true, suffix epochs saved > 0), while the
   affinity-OFF control router round-robins the same traffic onto
   cold workers that must rebuild — with bitwise-identical deltas
   either way;
3. **kill drill**: a concurrent simulate load while one worker is
   SIGKILLed mid-flight — every response must be a typed 200 bitwise
   equal to a solo single-process reference, with ``worker_lost`` +
   ``request_rerouted`` ledgered and ``serve_reroutes_total`` > 0.
   Zero client-visible transport errors;
4. **autoscaler proof**: a synthetic fast-burn SLO makes one
   :meth:`.autoscaler.Autoscaler.tick` spawn a worker that pays ZERO
   kernel-library builds (the shared cache is its warmup), and idling
   makes a later tick retire it gracefully;
5. every flight bundle (router, control router, each worker) merges
   into ONE bundle directory, which passes the port's
   :func:`..telemetry.flight.check_bundle` and
   :func:`..telemetry.flight.check_stitched` — the cross-process trace
   must stitch (no orphan spans) and every ledger record must resolve.

Exit 0 only when every expectation held. :func:`run_scaleout_drill` also
takes the drill's sizes (`sizes`, over :data:`DRILL_DEFAULTS`) and, given
a `report` dict, fills it with what it measured (spawn seconds, what-if
latencies, the router hop, the rerouted requests' latency, each worker's
pid and bundle, and which worker answered each request).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import pathlib
import shutil
import statistics
import tempfile
import time
from typing import Optional

#: The version every drill request runs (a registered Yuma version).
VERSION = "Yuma 2 (Adrian-Fish)"

#: The drill's sizes, each overridable through `run_scaleout_drill`'s
#: `sizes`: the archive's subnet width and timeline, the what-if's
#: perturbation epoch, the simulate payload of the kill load, its count,
#: the shapes every worker warms at startup, and the workspace.
DRILL_DEFAULTS = {
    "validators": 3,
    "miners": 4,
    "snapshots": 2,
    "epochs_per_snapshot": 2,
    "stride": 2,
    "from_epoch": 2,
    "simulate": {"case": "Case 1"},
    "requests": 16,
    "warmup": ("40x3x2",),
    "workdir": None,
}


def _merge_bundle_dirs(dirs, out_dir: pathlib.Path) -> list[str]:
    """Concatenate sibling bundles' jsonl streams into one on-disk
    bundle (dedup is the reader's job — identities are unique by
    construction). ``slo.json``/``report.json`` keep the FIRST
    bundle's copy (caller passes the router first)."""
    from yuma_simulation_tpu_torch.telemetry.flight import (
        COSTS_NAME,
        LEDGER_NAME,
        METRICS_NAME,
        NUMERICS_NAME,
        REPORT_NAME,
        SLO_NAME,
        SPANS_NAME,
    )

    out_dir.mkdir(parents=True, exist_ok=True)
    # Only PUBLISHED bundles merge: a SIGKILLed worker leaves its
    # crash-safe ledger.jsonl behind but its spans died with the
    # process, so its torn bundle (ledger, no spans) would only add
    # unresolvable records — its loss is the ROUTER's `worker_lost`
    # ledger entry, which does resolve.
    published = [
        pathlib.Path(d)
        for d in dirs
        if (pathlib.Path(d) / SPANS_NAME).exists()
    ]
    for name in (
        LEDGER_NAME, SPANS_NAME, METRICS_NAME, COSTS_NAME, NUMERICS_NAME,
    ):
        lines = []
        for d in published:
            path = d / name
            if path.exists():
                text = path.read_text()
                lines.extend(
                    ln for ln in text.splitlines() if ln.strip()
                )
        if lines:
            (out_dir / name).write_text("\n".join(lines) + "\n")
    for name in (SLO_NAME, REPORT_NAME):
        for d in published:
            path = d / name
            if path.exists():
                shutil.copyfile(path, out_dir / name)
                break
    return [str(d) for d in published]


class _FakeBurn:
    """A hand-cranked SLO engine for the autoscaler phase: `degraded()`
    returns whatever the drill set, nothing else consulted."""

    def __init__(self):
        self.burning: tuple = ()

    def degraded(self) -> tuple:
        return self.burning


def _median(values) -> float:
    return float(statistics.median(values)) if values else 0.0


def run_scaleout_drill(
    args,
    *,
    sizes: Optional[dict] = None,
    report: Optional[dict] = None,
    probe=None,
) -> int:
    """See the module docstring. Runs on ``args.device``; ~3 worker
    subprocesses. `sizes` overrides entries of :data:`DRILL_DEFAULTS`
    (None keeps the default). `probe`, when given, is called once with
    the live workers' pids while all three serve (before the kill); what
    it returns lands in ``report["probe"]``. ``report["served"]`` lists
    every answered request as ``[worker, kind, body]`` (kind "simulate"
    or "whatif"; the body of a what-if only)."""
    from yuma_simulation_tpu_torch.replay import SnapshotArchive
    from yuma_simulation_tpu_torch.replay.archive import synthetic_timeline
    from yuma_simulation_tpu_torch.serve.autoscaler import Autoscaler
    from yuma_simulation_tpu_torch.serve.router import RouterConfig, RouterService
    from yuma_simulation_tpu_torch.serve.server import (
        SimulationClient,
        SimulationServer,
        wait_until_ready,
    )
    from yuma_simulation_tpu_torch.serve.service import (
        ServeConfig,
        SimulationService,
    )
    from yuma_simulation_tpu_torch.utils import setup_logging

    setup_logging()
    failures: list[str] = []

    def expect(cond: bool, what: str) -> None:
        print(("ok   " if cond else "FAIL ") + what)
        if not cond:
            failures.append(what)

    unknown = set(sizes or ()) - set(DRILL_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown drill sizes: {sorted(unknown)}")
    sizes = {
        name: default if (sizes or {}).get(name) is None else sizes[name]
        for name, default in DRILL_DEFAULTS.items()
    }
    report = report if report is not None else {}
    served: list = []
    report["served"] = served

    def answered(r, kind: str, worker=None) -> None:
        """Note which worker answered `r` (the router's ``X-Worker``)."""
        if r.status == 200:
            served.append([
                worker or r.headers.get("X-Worker"), kind,
                r.body if kind == "whatif" else None,
            ])
    device = getattr(args, "device", "cuda")
    merged_dir = pathlib.Path(args.bundle_dir or "scaleout-bundle")
    if sizes["workdir"]:
        work = pathlib.Path(sizes["workdir"])
        work.mkdir(parents=True, exist_ok=True)
    else:
        work = pathlib.Path(tempfile.mkdtemp(prefix="yuma-scaleout-"))
    print(f"scale-out drill workspace: {work}")
    report["workdir"] = str(work)
    eps = str(sizes["epochs_per_snapshot"])
    stride = str(sizes["stride"])

    # -- stage: archive + pool ----------------------------------------
    archive_dir = work / "archive"
    arch = SnapshotArchive(archive_dir)
    for netuid, seed in ((1, 0), (2, 1)):
        synthetic_timeline(
            arch, netuid, snapshots=sizes["snapshots"], seed=seed,
            num_validators=sizes["validators"], num_miners=sizes["miners"],
        )
    exec_cache = work / "exec-cache"
    warmup_args = []
    for shape in sizes["warmup"]:
        warmup_args += ["--warmup", str(shape)]
    worker_args = (
        "--replay-archive", str(archive_dir),
        "--replay-cache", str(work / "caches" / "{worker_id}"),
        "--replay-epochs-per-snapshot", eps,
        "--replay-stride", stride,
        "--executable-cache", str(exec_cache),
        "--queue-limit", "64",
        "--tenant-rate", "1000",
        "--tenant-burst", "1000",
        "--coalesce-window", "0.0",
        "--deadline", "120",
        *warmup_args,
    )
    config = RouterConfig(
        pool_dir=str(work / "pool"),
        workers=3,
        max_workers=5,
        worker_args=worker_args,
        lease_ttl_seconds=1.5,
        bundle_dir=str(work / "router-bundle"),
        affinity=True,
        reroute_attempts=3,
        default_deadline_seconds=120.0,
        forward_timeout=60.0,
        replay_archive_dir=str(archive_dir),
        replay_cache_dir=str(work / "router-scratch"),
        replay_epochs_per_snapshot=int(eps),
        replay_stride=int(stride),
        spawn_wait_seconds=300.0,
        device=device,
    )
    router = RouterService(config)
    control = RouterService(
        dataclasses.replace(
            config,
            affinity=False,
            bundle_dir=str(work / "control-bundle"),
            replay_cache_dir=str(work / "control-scratch"),
        )
    )
    # The solo single-process reference the routed answers must match
    # bitwise (same serve knobs, no pool).
    solo = SimulationService(
        ServeConfig(
            device=device,
            coalesce_window_seconds=0.0,
            tenant_rate=1000.0,
            tenant_burst=1000,
            replay_archive_dir=str(archive_dir),
            replay_cache_dir=str(work / "solo-cache"),
            replay_epochs_per_snapshot=int(eps),
            replay_stride=int(stride),
        )
    )
    front = SimulationServer(service=router)
    control_front = SimulationServer(service=control)
    heartbeat = config.lease_ttl_seconds / 3.0

    def wait_ads(predicate, timeout: float = 20.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate(router.pool.scan()):
                return True
            time.sleep(heartbeat / 2.0)
        return False

    killed_worker = None
    try:
        # One spawn at a time (what start_workers does), each timed: the
        # first pays the kernel-library builds into the empty shared
        # cache, the others load what it published.
        spawns = []
        for _ in range(config.workers):
            t0 = time.perf_counter()
            ad = router.spawn_worker()
            spawns.append({
                "worker": ad.get("worker_id"),
                "pid": ad.get("pid"),
                "seconds": time.perf_counter() - t0,
                "aot_builds": int(ad.get("aot_builds", -1)),
            })
        report["spawns"] = spawns
        front.start()
        control_front.start()
        expect(
            wait_until_ready(front.url), "router answers /healthz"
        )
        client = SimulationClient(front.url, tenant="drill")
        h = client.healthz()
        expect(
            h.body.get("role") == "router"
            and h.body.get("workers", {}).get("live") == 3,
            f"3 workers live behind the router "
            f"(got {h.body.get('workers')})",
        )

        # -- phase A: state-cache affinity ----------------------------
        def whatif_spec(netuid: int, factor: float) -> dict:
            return {
                "netuid": netuid,
                "version": VERSION,
                "from_epoch": int(sizes["from_epoch"]),
                "stake_scale": [[0, factor]],
            }

        t0 = time.perf_counter()
        r = client.whatif(whatif_spec(1, 2.0))
        report["whatif_miss_seconds"] = time.perf_counter() - t0
        answered(r, "whatif")
        expect(
            r.status == 200 and r.body.get("status") == "ok",
            f"first what-if builds the baseline (got {r.status} "
            f"{r.body.get('error', r.body.get('status'))})",
        )
        holder = r.headers.get("X-Worker")
        expect(bool(holder), f"routed response names its worker ({holder})")
        # Let the holder's next heartbeat advertise the new prefix.
        expect(
            wait_ads(
                lambda ads: any(
                    ad.get("worker_id") == holder
                    and ad.get("held_prefixes")
                    for ad in ads
                )
            ),
            "holder advertises its state-cache prefix",
        )
        on_durs: list[float] = []
        on_workers: set = set()
        hits_saved = 0
        on_deltas = []
        for i in range(3):
            t0 = time.perf_counter()
            r = client.whatif(whatif_spec(1, 3.0 + i))
            on_durs.append(time.perf_counter() - t0)
            answered(r, "whatif")
            on_workers.add(r.headers.get("X-Worker"))
            if r.body.get("cache_hit"):
                hits_saved += int(r.body.get("epochs_saved", 0))
            on_deltas.append(r.body.get("total_dividend_delta"))
        expect(
            on_workers == {holder},
            f"repeated what-ifs all route to the checkpoint holder "
            f"(got {sorted(on_workers)} vs {holder})",
        )
        expect(
            hits_saved > 0,
            f"affinity hits resume from held suffix state "
            f"(epochs saved {hits_saved})",
        )
        affinity_hits = router.registry.counter("affinity_hits_total").value
        expect(
            affinity_hits >= 3,
            f"affinity_hits_total counted the placements "
            f"({affinity_hits})",
        )

        # Control arm: same shape of traffic on subnet 2 through the
        # affinity-OFF router — round-robin lands cold workers that
        # must rebuild the baseline the holder already has.
        control_client = SimulationClient(
            control_front.url, tenant="drill"
        )
        seed = client.whatif(whatif_spec(2, 2.0))  # seed ONE holder
        answered(seed, "whatif")
        expect(
            seed.status == 200,
            f"subnet-2 baseline seeded (got {seed.status})",
        )
        off_durs: list[float] = []
        off_misses = 0
        off_deltas = []
        for i in range(3):
            t0 = time.perf_counter()
            r = control_client.whatif(whatif_spec(2, 3.0 + i))
            off_durs.append(time.perf_counter() - t0)
            answered(r, "whatif")
            if r.status == 200 and not r.body.get("cache_hit"):
                off_misses += 1
            off_deltas.append(r.body.get("total_dividend_delta"))
        expect(
            off_misses >= 1,
            f"affinity-off round-robin pays cold rebuilds "
            f"({off_misses} misses)",
        )
        # Bitwise cross-worker proof: the SAME spec served twice by
        # the round-robin control (two different workers — one a cold
        # rebuild, one a held-suffix resume) must agree exactly, and
        # the routed affinity answer must equal the solo reference.
        dup_a = control_client.whatif(whatif_spec(2, 9.0))
        dup_b = control_client.whatif(whatif_spec(2, 9.0))
        answered(dup_a, "whatif")
        answered(dup_b, "whatif")
        expect(
            dup_a.status == 200
            and dup_b.status == 200
            and dup_a.body.get("total_dividend_delta")
            == dup_b.body.get("total_dividend_delta"),
            "same what-if on two workers is bitwise identical",
        )
        solo_w_status, solo_w_body, _ = solo.handle(
            "whatif",
            {"whatif": whatif_spec(1, 3.0), "tenant": "drill"},
        )
        expect(
            solo_w_status == 200
            and solo_w_body.get("total_dividend_delta") == on_deltas[0],
            "routed affinity what-if is bitwise the solo reference",
        )
        # The control arm's answers, rebuilt or resumed, against the
        # same specs served in this process.
        off_mismatch = 0
        for i, delta in enumerate(off_deltas):
            _st, ref, _ = solo.handle(
                "whatif",
                {"whatif": whatif_spec(2, 3.0 + i), "tenant": "drill"},
            )
            if ref.get("total_dividend_delta") != delta:
                off_mismatch += 1
        expect(
            off_mismatch == 0,
            f"affinity-off what-ifs are bitwise the solo reference "
            f"({off_mismatch} mismatched)",
        )
        p50_on = _median(on_durs)
        p50_off = _median(off_durs)
        print(
            f"     what-if p50: affinity on {p50_on * 1000:.1f} ms, "
            f"off {p50_off * 1000:.1f} ms"
        )
        report["whatif"] = {
            "holder": holder,
            "affinity_seconds": on_durs,
            "control_seconds": off_durs,
            "epochs_saved": hits_saved,
            "control_misses": off_misses,
        }

        # The router hop: one simulate request straight to a worker
        # against the same request through the router, alternating.
        payload = dict(sizes["simulate"])
        live = router.pool.live()
        direct_client = SimulationClient(
            str(live[0]["url"]), tenant="drill"
        )
        routed_s, direct_s = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            r_routed = client.simulate(**payload)
            routed_s.append(time.perf_counter() - t0)
            answered(r_routed, "simulate")
            t0 = time.perf_counter()
            r_direct = direct_client.simulate(**payload)
            direct_s.append(time.perf_counter() - t0)
            answered(r_direct, "simulate", live[0].get("worker_id"))
        expect(
            r_routed.status == 200
            and r_direct.status == 200
            and r_routed.body.get("dividends")
            == r_direct.body.get("dividends"),
            "routed and direct answers are bitwise identical",
        )
        report["router_hop"] = {
            "routed_seconds": routed_s,
            "direct_seconds": direct_s,
        }
        if probe is not None:
            report["probe"] = probe(
                [int(ad["pid"]) for ad in router.pool.live()]
            )

        # -- phase B: kill a worker mid-load --------------------------
        solo_status, solo_body, _ = solo.handle(
            "simulate", dict(payload, tenant="drill")
        )
        expect(
            solo_status == 200 and solo_body.get("status") == "ok",
            "solo reference simulate succeeds",
        )
        killed_worker = holder
        results = []
        n_requests = int(sizes["requests"])

        def timed_simulate():
            t0 = time.perf_counter()
            r = SimulationClient(front.url, tenant="drill").simulate(
                **payload
            )
            return r, time.perf_counter() - t0

        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            futs = [pool.submit(timed_simulate) for _ in range(n_requests)]
            time.sleep(0.2)
            expect(
                router.pool.kill(killed_worker),
                f"SIGKILLed worker {killed_worker} mid-load",
            )
            timed = [f.result() for f in futs]
        results = [r for r, _ in timed]
        for r in results:
            answered(r, "simulate")
        bad = [
            (r.status, r.body.get("error"))
            for r in results
            if r.status != 200 or r.body.get("status") != "ok"
        ]
        expect(
            not bad,
            f"all {n_requests} concurrent requests answered 200 ok "
            f"through the kill (bad: {bad})",
        )
        mismatched = sum(
            1
            for r in results
            if r.body.get("dividends") != solo_body.get("dividends")
            or r.body.get("total_dividends")
            != solo_body.get("total_dividends")
        )
        expect(
            mismatched == 0,
            f"every routed response is bitwise the solo reference "
            f"({mismatched} mismatched)",
        )
        reroutes = router.registry.counter("serve_reroutes_total").value
        expect(
            reroutes > 0,
            f"serve_reroutes_total > 0 after the kill ({reroutes})",
        )
        ledger_events = [e.get("event") for e in router.ledger.entries()]
        expect(
            "worker_lost" in ledger_events,
            "worker_lost ledgered for the killed worker",
        )
        expect(
            "request_rerouted" in ledger_events,
            "request_rerouted ledgered for the moved requests",
        )
        rerouted = {
            e.get("request")
            for e in router.ledger.entries("request_rerouted")
        }
        report["kill"] = {
            "worker": killed_worker,
            "requests": n_requests,
            "errors": len(bad),
            "mismatched": mismatched,
            "reroutes": int(reroutes),
            "rerouted_seconds": [
                s for r, s in timed if r.request_id in rerouted
            ],
            "other_seconds": [
                s for r, s in timed if r.request_id not in rerouted
            ],
        }

        # -- phase C: SLO-burn autoscaler -----------------------------
        burn = _FakeBurn()
        scaler = Autoscaler(
            router,
            slo_engine=burn,
            min_workers=2,
            max_workers=4,
            idle_retire_seconds=0.8,
            cooldown_seconds=0.0,
        )
        burn.burning = ("serve_request_seconds",)
        live_before = len(router.pool.live())
        t0 = time.perf_counter()
        outcome = scaler.tick()
        autoscale_s = time.perf_counter() - t0
        expect(
            outcome == "spawn",
            f"fast-burn tick spawns a worker (got {outcome!r})",
        )
        expect(
            wait_ads(
                lambda ads: sum(1 for a in ads if a["alive"])
                == live_before + 1
            ),
            "spawned worker joins the pool",
        )
        spawned = [
            ad
            for ad in router.pool.live()
            if ad.get("started_t", 0) == max(
                a.get("started_t", 0) for a in router.pool.live()
            )
        ]
        expect(
            spawned and int(spawned[0].get("aot_builds", -1)) == 0,
            f"spawned worker paid ZERO kernel-library builds (ad: "
            f"{spawned[0].get('aot_builds') if spawned else '?'})",
        )
        report["autoscaled"] = {
            "worker": spawned[0].get("worker_id") if spawned else None,
            "seconds": autoscale_s,
            "aot_builds": (
                int(spawned[0].get("aot_builds", -1)) if spawned else None
            ),
        }
        burn.burning = ()
        scaler.tick()  # records idle_since for everyone
        time.sleep(1.0)
        outcome = scaler.tick()
        expect(
            outcome == "retire",
            f"idle tick retires the youngest worker (got {outcome!r})",
        )
        ledger_events = [e.get("event") for e in router.ledger.entries()]
        expect(
            "worker_spawned" in ledger_events
            and "worker_retired" in ledger_events,
            "worker_spawned + worker_retired ledgered",
        )
    finally:
        control_front.close()
        front.close()
        solo.close()

    # -- merge + gate the flight bundles ------------------------------
    worker_bundles = sorted(
        (work / "pool" / "workers").glob("*/bundle")
    )
    merged_from = _merge_bundle_dirs(
        [work / "router-bundle", work / "control-bundle", *worker_bundles],
        merged_dir,
    )
    # The killed worker publishes NO bundle (that is the point of
    # SIGKILL) — everyone else must have.
    expect(
        len(merged_from) >= 3,
        f"router + control + surviving workers published bundles "
        f"({len(merged_from)} merged into {merged_dir})",
    )
    killed_bundle = str(
        work / "pool" / "workers" / str(killed_worker) / "bundle"
    )
    expect(
        killed_bundle not in merged_from,
        "SIGKILLed worker published no bundle (its spans died with it)",
    )
    from yuma_simulation_tpu_torch.telemetry.flight import (
        check_bundle,
        check_stitched,
        load_bundle,
    )

    bundle = load_bundle(merged_dir)
    problems = check_bundle(bundle)
    expect(
        not problems,
        f"merged bundle passes check_bundle ({problems[:3]})",
    )
    stitched = check_stitched([bundle])
    expect(
        not stitched,
        f"cross-process trace stitches with no orphan spans "
        f"({stitched[:3]})",
    )
    lost_ads = [
        e
        for e in bundle.ledger
        if e.get("event") == "worker_lost"
        and e.get("worker") == killed_worker
    ]
    expect(
        bool(lost_ads),
        "merged ledger pins the kill to the killed worker id",
    )

    report["worker_bundles"] = [str(b) for b in worker_bundles]
    report["merged_bundle"] = str(merged_dir)
    report["failures"] = list(failures)
    if failures:
        print(f"\nscale-out drill FAILED ({len(failures)} expectation(s))")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"\nscale-out drill passed (merged bundle: {merged_dir})")
    return 0

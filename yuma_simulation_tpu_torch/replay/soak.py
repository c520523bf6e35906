"""The continuous-replay chaos soak: the CI ``soak`` lane's engine.

``python -m yuma_simulation_tpu_torch.replay --soak --bundle-dir DIR
[--device cuda]`` stands up the whole continuous-replay stack as REAL
processes, each exec'd with the soak's ``--device`` (the card by default;
no child falls back to the CPU), and breaks it on purpose:

- a **writer process** appends synthetic snapshots to N subnet
  timelines on a cadence (the cross-process archive append lock is on
  the hot path), stops feeding one subnet (the stall injection), and
  publishes one snapshot with a TORN blob — a timeline entry whose
  content address the stored bytes no longer hash to (the corruption
  injection);
- a **controller process** (:mod:`.controller`) sweeps every
  (subnet x variant) suffix past its durable watermark as incremental
  fleet windows;
- a **helper fleet host process** joins the in-flight windows through
  the ordinary lease-claim path;
- a **serve tier** (in the orchestrator, its own flight bundle) takes
  continuous what-if traffic throughout.

Mid-soak the orchestrator SIGKILLs the fleet host and then the
controller, waits out a downtime window while the writer keeps
appending (freshness debt accrues against the durable watermark
timestamps), and restarts the controller COLD. The soak passes only
when the durable artifacts prove self-healing end to end:

- zero client-visible what-if errors through the kill;
- the torn blob is quarantined (typed ``subnet_quarantined`` ledger
  record) and its subnet keeps draining past it;
- the starved subnet emits ``subnet_stalled`` and demotes to the slow
  poll tier;
- every (subnet x variant) watermark drains to its timeline head, each
  window is published exactly once (no duplicate ``window_swept``),
  and the fleet-unit ledgers show the restart re-simulated only
  genuinely in-flight units;
- the ``replay_freshness`` SLO fast-burns on the first post-restart
  cycles and recovers once the backlog drains;
- the controller's final baselines are BITWISE a from-scratch
  re-simulation of the full (quarantine-filtered) timelines;
- the flight bundles and every window's fleet store pass the port's
  own gates (:func:`_gate_bundle`, :func:`_gate_store`,
  :func:`_incident_problems`: the checks of ``obsreport --check``,
  ``sloreport --check --require``, ``driftreport --check --require``
  and ``incidentreport --check`` as the port's telemetry spells them —
  those tools import the JAX package, which the card's machine lacks);
- incident intelligence correlated every injected fault to exactly
  one durable incident with the right typed cause (torn blob ->
  snapshot-corruption on the corrupted subnet only, starved subnet ->
  subnet-stall, controller SIGKILL -> process-loss resolved by
  post-restart progress); the downtime legitimately starves EVERY
  subnet past the stall deadline, so those restart-collateral stalls
  are true positives that must all come out resolved — while the
  serve control arm shows ZERO incidents and the incident gate holds
  the record of truth.

The final baselines are held to from-scratch builds on the controller's
rung (:data:`.controller.CONTROLLER_ENGINE`).
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import re
import subprocess
import sys
import threading
import time
from collections import Counter

BASE_BLOCK = 1000
BLOCKS_PER_SNAPSHOT = 100


def _snapshot_block(index: int) -> int:
    return BASE_BLOCK + index * BLOCKS_PER_SNAPSHOT


# ------------------------------------------------------------- writer


def _append_torn(archive, snap) -> None:
    """Archive `snap` with a TORN blob: the timeline entry carries the
    content address of the fully serialized bytes, but the published
    blob is truncated to half — what a non-atomic blob writer dying
    mid-write would have left behind. Reaches past the public
    ``append`` on purpose: ``append`` can only publish sound blobs,
    and corrupting after a normal append races the controller's sweep
    of the very block under test. Subsequent idempotent re-appends of
    the same snapshot match the (sound) index key and no-op, so the
    corruption is stable for the controller to find."""
    from yuma_simulation_tpu_torch.replay.archive import (
        TIMELINE_FORMAT,
        TimelineEntry,
        _serialize_snapshot,
    )
    from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

    blob = _serialize_snapshot(snap)
    key = hashlib.sha256(blob).hexdigest()
    with archive._append_lock(snap.netuid):
        entries = []
        if archive._timeline_path(snap.netuid).exists():
            entries = archive.timeline(snap.netuid)
        if any(e.block == int(snap.block) for e in entries):
            return  # already archived (idempotent, like append)
        entry = TimelineEntry(
            block=int(snap.block),
            key=key,
            validators=snap.num_validators,
            miners=snap.num_miners,
        )
        blob_path = archive._blob_path(snap.netuid, key)
        blob_path.parent.mkdir(parents=True, exist_ok=True)
        publish_atomic(blob_path, blob[: max(1, len(blob) // 2)])
        payload = {
            "format": TIMELINE_FORMAT,
            "netuid": int(snap.netuid),
            "entries": [e.to_json() for e in entries + [entry]],
        }
        publish_atomic(
            archive._timeline_path(snap.netuid),
            json.dumps(payload, sort_keys=True).encode(),
        )
    print(
        f"[writer] TORN blob injected: subnet {snap.netuid} "
        f"block {snap.block}",
        flush=True,
    )


def _extend_timeline(
    archive, netuid: int, *, snapshots: int, seed: int, num_validators: int,
    num_miners: int,
) -> None:
    """``synthetic_timeline(archive, netuid, snapshots=..., seed=...)``,
    generating only the snapshots whose blocks the timeline lacks: the
    same timeline, without drawing the whole prefix again every round
    (which at 256 x 4096 outgrows the writer's interval)."""
    from yuma_simulation_tpu_torch.foundry.metagraph import synthetic_snapshot

    have = set()
    if archive._timeline_path(netuid).exists():
        have = {e.block for e in archive.timeline(netuid)}
    for i in range(snapshots):
        if _snapshot_block(i) in have:
            continue
        archive.append(
            synthetic_snapshot(
                seed + i,
                num_validators=num_validators,
                num_miners=num_miners,
                netuid=netuid,
                block=_snapshot_block(i),
            )
        )


def run_writer(args) -> int:
    """The standing archive feed (``--writer``): one snapshot per
    subnet per round, skipping the stall-injected subnet past its
    cutoff and publishing the corruption-injected snapshot with a torn
    blob. Rounds are absolute snapshot counts, so the writer is
    idempotent over restarts the same way ``synthetic_timeline`` is; a
    round starts every ``--interval`` seconds (JAX's writer sleeps the
    interval after each round, so its cadence stretches with the width)."""
    from yuma_simulation_tpu_torch.foundry.metagraph import synthetic_snapshot
    from yuma_simulation_tpu_torch.replay.archive import SnapshotArchive

    archive = SnapshotArchive(args.archive)
    t0 = time.time()
    for rnd in range(3, args.rounds + 1):
        t_round = time.time()
        for netuid in range(args.subnets):
            if netuid == args.stall_netuid and rnd > args.stall_after:
                continue  # the stall injection: this feed went quiet
            if (
                netuid == args.corrupt_netuid
                and rnd == args.corrupt_round
            ):
                snap = synthetic_snapshot(
                    args.seed + netuid * 1000 + (rnd - 1),
                    num_validators=args.validators,
                    num_miners=args.miners,
                    netuid=netuid,
                    block=_snapshot_block(rnd - 1),
                )
                _append_torn(archive, snap)
                continue
            _extend_timeline(
                archive,
                netuid,
                snapshots=rnd,
                seed=args.seed + netuid * 1000,
                num_validators=args.validators,
                num_miners=args.miners,
            )
        print(
            f"[writer] round {rnd}/{args.rounds} appended "
            f"(+{time.time() - t0:.2f}s)",
            flush=True,
        )
        # A fixed cadence: a round starts every `interval` seconds however
        # long the last took to draw and publish (at most back to back).
        time.sleep(max(0.0, t_round + args.interval - time.time()))
    print("[writer] done", flush=True)
    return 0


# ------------------------------------------------------ orchestration


def _gate_bundle(directory, *, require_slo: bool = False) -> list[str]:
    """The problems ``obsreport --check`` (and, with `require_slo`,
    ``sloreport --check --require``) would report for one flight bundle,
    from the port's own checks: the bundle is sound, and it recorded SLO
    state with no objective fast-burning."""
    from yuma_simulation_tpu_torch.telemetry.flight import (
        check_bundle,
        load_bundle,
    )

    bundle = load_bundle(directory)
    problems = list(check_bundle(bundle))
    if require_slo:
        states = (bundle.slo or {}).get("states")
        if not isinstance(states, dict):
            problems.append("no SLO state recorded")
        else:
            problems.extend(
                f"SLO {name} fast-burning"
                for name, st in states.items()
                if (st.get("state") if isinstance(st, dict) else st)
                == "fast_burn"
            )
    return problems


def _gate_store(store) -> list[str]:
    """The problems ``obsreport --check`` + ``driftreport --check
    --require`` would report for one window's fleet store:
    :func:`..fabric.health.check_fleet` (the manifest, every unit
    published once, the hosts' ledgers and bundles, no drift)."""
    from yuma_simulation_tpu_torch.fabric.health import check_fleet

    return list(check_fleet(store))


def _incident_problems(directory) -> list[str]:
    """The problems ``incidentreport --check`` would report for one
    bundle: every incident has an identity, a known state and a typed
    cause that supports its class, and every typed fault event of the
    ledger belongs to an incident."""
    from yuma_simulation_tpu_torch.telemetry.flight import load_bundle
    from yuma_simulation_tpu_torch.telemetry.incident import (
        CAUSE_EVENTS,
        _subject,
        correlate,
        latest_incidents,
    )

    bundle = load_bundle(directory)
    if bundle.incidents:
        records = latest_incidents(bundle.incidents)
    else:
        records = [i.to_json() for i in correlate(bundle.ledger)]
    problems: list[str] = []
    known = set()
    for rec in records:
        if not isinstance(rec, dict) or not rec.get("incident"):
            problems.append(f"incident record without identity: {rec!r:.120}")
            continue
        ident = str(rec["incident"])
        known.add(ident)
        if rec.get("state") not in ("open", "resolved"):
            problems.append(f"{ident}: undecodable state {rec.get('state')!r}")
        cause = rec.get("cause")
        event = cause.get("event") if isinstance(cause, dict) else None
        if event not in CAUSE_EVENTS:
            problems.append(f"{ident}: no cause candidate ({event!r})")
        elif CAUSE_EVENTS[event] != rec.get("cause_class"):
            problems.append(
                f"{ident}: cause {event} does not support class "
                f"{rec.get('cause_class')!r}"
            )
    for rec in bundle.ledger:
        if not isinstance(rec, dict):
            continue
        cls = CAUSE_EVENTS.get(rec.get("event", ""))
        if cls is None:
            continue
        subject = _subject(rec)
        ident = f"{cls}:{subject}" if subject else cls
        if ident not in known:
            problems.append(
                f"uncorrelated cause: ledger {rec.get('event')} "
                f"({subject or 'bundle'}) has no incident {ident}"
            )
    return problems


def run_soak(args) -> int:
    import os

    from yuma_simulation_tpu_torch.models.config import YumaConfig
    from yuma_simulation_tpu_torch.replay.archive import (
        SnapshotArchive,
        entries_fingerprint,
        synthetic_timeline,
    )
    from yuma_simulation_tpu_torch.replay.controller import (
        CONTROLLER_ENGINE,
        WatermarkStore,
    )
    from yuma_simulation_tpu_torch.replay.statecache import StateCache
    from yuma_simulation_tpu_torch.serve.server import (
        SimulationClient,
        SimulationServer,
        wait_until_ready,
    )
    from yuma_simulation_tpu_torch.serve.service import ServeConfig
    from yuma_simulation_tpu_torch.telemetry.flight import load_bundle
    from yuma_simulation_tpu_torch.utils import setup_logging
    from yuma_simulation_tpu_torch.utils.checkpoint import (
        publish_atomic,
        read_jsonl_tolerant,
    )

    setup_logging()
    t_start = time.time()
    target = pathlib.Path(args.bundle_dir).resolve()
    archive_dir = target / "archive"
    cache_dir = target / "cache"
    store_dir = target / "store"
    logs_dir = target / "logs"
    logs_dir.mkdir(parents=True, exist_ok=True)

    failures: list[str] = []

    def expect(cond: bool, what: str) -> None:
        print(("ok   " if cond else "FAIL ") + what, flush=True)
        if not cond:
            failures.append(what)

    subnets = args.subnets
    stall_netuid = subnets - 1
    corrupt_netuid = args.corrupt_netuid
    if subnets < 3 or corrupt_netuid in (0, stall_netuid):
        print(
            "--soak needs >= 3 subnets with the corruption injection on "
            "a middle netuid (subnet 0 is the bitwise-verify control, "
            "the last subnet is the stall injection)",
            file=sys.stderr,
        )
        return 2
    corrupt_block = _snapshot_block(args.corrupt_round - 1)
    heads = {
        n: _snapshot_block(args.rounds - 1) for n in range(subnets)
    }
    heads[stall_netuid] = _snapshot_block(args.stall_after - 1)

    # 1. Seed every timeline (two snapshots) so the first controller
    # cycle has a full backlog and the shed budget bites immediately.
    archive = SnapshotArchive(archive_dir)
    for n in range(subnets):
        synthetic_timeline(
            archive,
            n,
            snapshots=2,
            seed=args.seed + n * 1000,
            num_validators=args.validators,
            num_miners=args.miners,
        )
    print(f"[soak] seeded {subnets} subnets x 2 snapshots", flush=True)

    env = dict(os.environ)
    root = str(pathlib.Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [root, env.get("PYTHONPATH", "")] if p
    )
    # Continuous-telemetry rotation, byte-bounded small so a soak-length
    # run demonstrably seals >= 2 flight segments: every spawned process
    # (controller, host, writer) inherits the opt-in.
    env["YUMA_TPU_FLIGHT_ROTATE"] = "16384"
    # Every child is exec'd (never forked from this process, which may
    # hold a CUDA context) and runs on the soak's device.
    mod = [
        sys.executable, "-m", "yuma_simulation_tpu_torch.replay",
        "--device", args.device,
    ]
    procs: list[subprocess.Popen] = []
    logfiles = []

    def spawn(name: str, extra: list) -> subprocess.Popen:
        log = open(logs_dir / f"{name}.log", "ab")
        logfiles.append(log)
        proc = subprocess.Popen(
            mod + extra, stdout=log, stderr=subprocess.STDOUT, env=env
        )
        procs.append(proc)
        return proc

    common = [
        "--archive", str(archive_dir),
        "--cache", str(cache_dir),
        "--store", str(store_dir),
    ]

    # The soak's own knob defaults: the shed budget must bite (well
    # under the pair count), the freshness budget must be overrun by
    # the injected downtime (else the kill never burns the SLO), and
    # the stall deadline must fire within the post-restart drain.
    max_windows = (
        args.max_windows if args.max_windows is not None else 2
    )
    freshness_budget = (
        args.freshness_budget
        if args.freshness_budget is not None
        else min(2.0, args.downtime / 2)
    )
    stall_deadline = (
        args.stall_deadline if args.stall_deadline is not None else 4.0
    )

    def spawn_controller() -> subprocess.Popen:
        return spawn(
            "controller",
            ["--controller"]
            + common
            + [
                "--versions", *args.versions,
                "--epochs-per-snapshot", str(args.epochs_per_snapshot),
                "--stride", str(args.stride),
                "--unit-size", "1",
                "--poll", "0.25",
                "--freshness-budget", str(freshness_budget),
                "--stall-deadline", str(stall_deadline),
                "--max-windows", str(max_windows),
                "--lease-ttl", "3",
            ],
        )

    server = None
    load_stop = threading.Event()
    load_stats = {"ok": 0, "errors": []}
    try:
        writer = spawn(
            "writer",
            ["--writer"]
            + common
            + [
                "--subnets", str(subnets),
                "--rounds", str(args.rounds),
                "--interval", str(args.interval),
                "--stall-netuid", str(stall_netuid),
                "--stall-after", str(args.stall_after),
                "--corrupt-netuid", str(corrupt_netuid),
                "--corrupt-round", str(args.corrupt_round),
                "--seed", str(args.seed),
                "--validators", str(args.validators),
                "--miners", str(args.miners),
            ],
        )
        host = spawn(
            "host",
            ["--host"]
            + common
            + ["--unit-size", "1", "--poll", "0.25", "--lease-ttl", "3"],
        )
        controller = spawn_controller()

        # 2. Continuous what-if load through a real server mounted on
        # the same (growing) archive, its own cache + flight bundle.
        # The corruption-injected subnet is the controller's problem,
        # not the load's: its full-window scenario is unreadable by
        # construction, so clients steer to the sound subnets.
        server = SimulationServer(
            ServeConfig(
                device=args.device,
                bundle_dir=str(target / "serve"),
                replay_archive_dir=str(archive_dir),
                replay_cache_dir=str(target / "serve-cache"),
                replay_epochs_per_snapshot=args.epochs_per_snapshot,
                replay_stride=args.stride,
                executable_cache_dir=str(target / "aot"),
            )
        ).start()
        expect(wait_until_ready(server.url), "server answers /healthz")
        load_subnets = [
            n for n in range(subnets) if n != corrupt_netuid
        ]

        def load_loop() -> None:
            client = SimulationClient(server.url, tenant="replay-soak")
            i = 0
            while not load_stop.is_set():
                netuid = load_subnets[i % len(load_subnets)]
                i += 1
                try:
                    r = client.replay(netuid)
                    if r.status != 200:
                        load_stats["errors"].append(
                            f"replay/{netuid} -> {r.status}"
                        )
                        continue
                    epochs = int(r.body["epochs"])
                    w = client.whatif(
                        {
                            "netuid": netuid,
                            "version": args.versions[0],
                            "from_epoch": max(1, epochs - 1),
                            "stake_scale": [[1, 2.0]],
                            "weight_rows": [
                                [0, [1.0] + [0.0] * (args.miners - 1)]
                            ],
                        }
                    )
                    if (
                        w.status != 200
                        or w.body.get("status") != "ok"
                    ):
                        load_stats["errors"].append(
                            f"whatif/{netuid} -> {w.status} "
                            f"{w.body.get('error')}"
                        )
                    else:
                        load_stats["ok"] += 1
                except Exception as exc:  # client-visible by definition
                    load_stats["errors"].append(
                        f"whatif/{netuid} raised {exc!r}"
                    )
                time.sleep(0.35)

        load_thread = threading.Thread(target=load_loop, daemon=True)
        load_thread.start()

        # 3. The chaos: SIGKILL the fleet host, then the controller —
        # most likely mid-window — and keep the writer feeding debt
        # while nothing drains it.
        t0 = time.time()
        time.sleep(args.kill_after)
        host.kill()
        controller.kill()
        host.wait()
        controller.wait()
        print(
            f"[soak] SIGKILLed controller+host at +{time.time() - t0:.1f}s",
            flush=True,
        )
        # Rotation routes the metrics stream into flight segments, so
        # count through load_bundle (root + segments in index order) —
        # appends only ever extend the tail, so positional slicing
        # against this count stays chronological.
        lines_at_kill = len(load_bundle(store_dir).metrics)
        time.sleep(args.downtime)
        controller = spawn_controller()
        print(
            f"[soak] controller restarted COLD at +{time.time() - t0:.1f}s",
            flush=True,
        )

        rc = writer.wait(timeout=args.rounds * args.interval + 120)
        expect(rc == 0, f"writer exited clean (rc={rc})")

        # 4. Drain: every (subnet x variant) watermark reaches its
        # timeline head — including past the quarantined block.
        marks = WatermarkStore(store_dir / "watermarks")

        def drained() -> bool:
            for n in range(subnets):
                for v in args.versions:
                    rec = marks.load(n, v)
                    if rec is None or rec["block"] != heads[n]:
                        return False
            return True

        deadline = time.time() + args.drain_timeout
        while time.time() < deadline and not drained():
            if controller.poll() is not None:
                break  # controller died; fail below with its rc
            time.sleep(0.5)
        expect(
            drained(),
            "every (subnet x variant) watermark drained to its head "
            f"block (controller rc={controller.poll()})",
        )

        load_stop.set()
        load_thread.join(timeout=15)
        expect(
            load_stats["ok"] > 0 and not load_stats["errors"],
            f"what-if load clean through the kill "
            f"({load_stats['ok']} ok, "
            f"errors={load_stats['errors'][:3]})",
        )
        server.close()
        server = None

        # 5. Recovery: the freshness SLO must un-flip before the final
        # bundle capture (sloreport --check fails an active fast burn).
        slo_path = store_dir / "slo.json"

        def fast_burning() -> bool:
            try:
                snap = json.loads(slo_path.read_text(encoding="utf-8"))
            except (OSError, json.JSONDecodeError):
                return True
            state = snap.get("states", {}).get("replay_freshness", {})
            return state.get("state") == "fast_burn"

        deadline = time.time() + args.recovery_timeout
        while time.time() < deadline and fast_burning():
            if controller.poll() is not None:
                break
            time.sleep(0.5)
        expect(
            not fast_burning(),
            "replay_freshness recovered from the kill-induced burn",
        )
        controller.terminate()
        controller.wait(timeout=60)
    finally:
        load_stop.set()
        if server is not None:
            server.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logfiles:
            log.close()

    # ---- verdicts from the durable artifacts only ---------------------
    ledger = read_jsonl_tolerant(store_dir / "ledger.jsonl")
    quarantined = [
        r for r in ledger if r.get("event") == "subnet_quarantined"
    ]
    expect(
        any(
            r.get("netuid") == corrupt_netuid
            and r.get("block") == corrupt_block
            for r in quarantined
        ),
        f"torn blob quarantined (subnet {corrupt_netuid} block "
        f"{corrupt_block})",
    )
    expect(
        any(
            r.get("event") == "subnet_stalled"
            and r.get("netuid") == stall_netuid
            for r in ledger
        ),
        f"starved subnet {stall_netuid} emitted subnet_stalled",
    )

    swept = [r for r in ledger if r.get("event") == "window_swept"]
    by_window = Counter(
        (
            r.get("netuid"),
            r.get("version"),
            r.get("block_from"),
            r.get("block_to"),
        )
        for r in swept
    )
    dupes = {k: c for k, c in by_window.items() if c > 1}
    expect(
        bool(swept) and not dupes,
        f"every window published exactly once "
        f"({len(swept)} windows, duplicates={dupes})",
    )
    expect(
        any(r.get("resumed") for r in swept),
        "incremental windows resumed from cached carry",
    )
    expect(
        all(r.get("drift") == 0 for r in swept),
        "every window drift-clean",
    )

    # Exactly-once unit economy: every store complete, and the global
    # unit_ok count exceeds the published-unit count only by the few
    # genuinely in-flight units the kills forced a second simulation of.
    stores = sorted(
        {r["store"] for r in swept if isinstance(r.get("store"), str)}
    )
    store_problems: list[str] = []
    total_units = 0
    total_unit_ok = 0
    for s in stores:
        sp = pathlib.Path(s)
        try:
            manifest = json.loads(
                (sp / "manifest.json").read_text(encoding="utf-8")
            )
        except (OSError, json.JSONDecodeError) as exc:
            store_problems.append(f"{s}: unreadable manifest ({exc})")
            continue
        num_units = int(manifest["num_units"])
        published = len(list((sp / "results").glob("unit_*.npz")))
        if published != num_units:
            store_problems.append(
                f"{s}: {published}/{num_units} units published"
            )
        total_units += num_units
        hosts_dir = sp / "hosts"
        if hosts_dir.is_dir():
            for host_dir in hosts_dir.iterdir():
                total_unit_ok += sum(
                    1
                    for r in read_jsonl_tolerant(
                        host_dir / "ledger.jsonl"
                    )
                    if r.get("event") == "unit_ok"
                )
    expect(
        bool(stores) and not store_problems,
        f"every window store complete ({len(stores)} stores"
        + (f"; problems={store_problems[:3]}" if store_problems else "")
        + ")",
    )
    resim_slack = 2 * len(args.versions) + 2
    expect(
        total_units <= total_unit_ok <= total_units + resim_slack,
        f"restart re-simulated only in-flight units "
        f"(unit_ok={total_unit_ok} for {total_units} published, "
        f"slack<={resim_slack})",
    )

    # The SLO story, from the metrics stream: no fast burn active at
    # the kill snapshot boundary is not required (startup backlog may
    # legitimately burn) — what must hold is a fast burn AFTER the
    # restart and a final snapshot with none.
    metrics_lines = load_bundle(store_dir).metrics
    post_restart = metrics_lines[lines_at_kill:]

    def burn_active(line: dict) -> float:
        return float(
            (line.get("gauges") or {}).get("slo_fast_burn_active", 0)
        )

    expect(
        any(burn_active(l) >= 1 for l in post_restart),
        "freshness SLO fast-burned after the cold restart",
    )
    expect(
        bool(metrics_lines) and burn_active(metrics_lines[-1]) == 0,
        "no fast burn active at the final snapshot",
    )

    # Backpressure: the controller's own cycle lines prove shedding.
    ctl_text = (logs_dir / "controller.log").read_text(
        encoding="utf-8", errors="replace"
    )
    sheds = [int(m) for m in re.findall(r"shed=(\d+)", ctl_text)]
    # Each cycle's windows and seconds (both controller incarnations).
    cycle_lines = [
        {"swept": int(sw), "seconds": float(sec)}
        for sw, sec in re.findall(
            r"cycle=\d+ swept=(\d+) .*seconds=([0-9.]+)", ctl_text
        )
    ]
    expect(
        any(s > 0 for s in sheds),
        f"backlog shed low-priority refreshes "
        f"(max shed={max(sheds, default=0)})",
    )

    # Continuous telemetry: the byte-bounded rotation opt-in must have
    # produced a multi-segment bundle with sealed, crash-safe segments
    # (the obsreport/sloreport gates below then read the same bundle
    # through the segment-aware loader).
    sealed_segments = sorted(
        p.parent.name
        for p in (store_dir / "segments").glob("seg_*/seal.json")
    )
    expect(
        len(sealed_segments) >= 2,
        f"flight recorder sealed >= 2 rotated segments "
        f"({len(sealed_segments)}: {sealed_segments[:4]})",
    )

    # 6. Bitwise: the controller's final incremental baselines against
    # from-scratch re-simulations of the full (quarantine-filtered)
    # timelines — the clean control subnet AND the corrupted one.
    cache = StateCache(cache_dir)
    verify_cache = StateCache(target / "verify-cache")
    config = YumaConfig()
    for netuid in (0, corrupt_netuid):
        entries = [
            e
            for e in archive.timeline(netuid)
            if not (
                netuid == corrupt_netuid and e.block == corrupt_block
            )
        ]
        scenario = archive.scenario_for_blocks(
            netuid,
            [e.block for e in entries],
            epochs_per_snapshot=args.epochs_per_snapshot,
        )
        for version in args.versions:
            rec = marks.load(netuid, version)
            if rec is None:
                expect(False, f"subnet {netuid} {version}: no watermark")
                continue
            meta = verify_cache.build_baseline(
                scenario,
                version,
                config,
                scenario_fingerprint=entries_fingerprint(entries),
                stride=args.stride,
                engine=CONTROLLER_ENGINE,
                device=args.device,
            )
            expect(
                meta.key == rec["baseline_key"],
                f"subnet {netuid} {version}: incremental baseline key "
                f"IS the from-scratch key",
            )
            import numpy as np

            incremental = cache.load_baseline(rec["baseline_key"])
            full = verify_cache.load_baseline(meta.key)
            expect(
                np.array_equal(
                    incremental["dividends"], full["dividends"]
                ),
                f"subnet {netuid} {version}: incremental dividends "
                f"bitwise the full re-simulation",
            )

    # 7. Incident intelligence: every injected fault class correlated
    # to exactly one durable incident with the right typed cause, and
    # the unfaulted control arms stayed at zero. This is the proof the
    # correlation engine attributes rather than pattern-matches.
    from yuma_simulation_tpu_torch.telemetry.incident import load_incidents

    incidents = load_incidents(store_dir)
    by_class = Counter(r.get("cause_class") for r in incidents)
    corruption = [
        r
        for r in incidents
        if r.get("cause_class") == "snapshot-corruption"
    ]
    expect(
        len(corruption) == 1
        and corruption[0].get("subject") == f"netuid={corrupt_netuid}"
        and (corruption[0].get("cause") or {}).get("event")
        == "subnet_quarantined"
        and corruption[0].get("state") == "resolved",
        f"torn blob -> exactly one resolved snapshot-corruption "
        f"incident on netuid={corrupt_netuid} "
        f"(got {[r.get('incident') for r in corruption]})",
    )
    stalls = {
        r.get("subject"): r
        for r in incidents
        if r.get("cause_class") == "subnet-stall"
    }
    starved = stalls.get(f"netuid={stall_netuid}")
    expect(
        starved is not None
        and (starved.get("cause") or {}).get("event") == "subnet_stalled",
        f"starved subnet -> a subnet-stall incident on "
        f"netuid={stall_netuid} caused by subnet_stalled "
        f"(got {sorted(stalls)})",
    )
    # The downtime starves EVERY subnet past the stall deadline —
    # those restart-collateral stalls are TRUE positives (the feed
    # really was stale), deduped to one incident per subject by
    # identity, and the drain must have resolved every one of them.
    unresolved = [
        s for s, r in stalls.items() if r.get("state") != "resolved"
    ]
    expect(
        not unresolved,
        f"every subnet-stall incident resolved by the drain "
        f"({len(stalls)} stalled subject(s), "
        f"unresolved={unresolved})",
    )
    losses = [
        r for r in incidents if r.get("cause_class") == "process-loss"
    ]
    expect(
        len(losses) == 1
        and (losses[0].get("cause") or {}).get("event")
        == "controller_restarted",
        f"controller SIGKILL -> exactly one process-loss incident "
        f"(got {[r.get('incident') for r in losses]})",
    )
    expect(
        all(
            r.get("subject") == f"netuid={corrupt_netuid}"
            for r in corruption
        )
        and not any(
            r.get("subject") == "netuid=0" for r in corruption
        ),
        "corruption blamed on the corrupted subnet only "
        f"(classes={dict(by_class)})",
    )
    problems = _incident_problems(store_dir)
    expect(
        not problems,
        f"incident gate green on the controller bundle ({problems[:3]})",
    )
    serve_incidents = load_incidents(target / "serve")
    expect(
        not serve_incidents,
        f"serve control arm: zero incidents "
        f"(got {len(serve_incidents)})",
    )

    # 8. The same artifact gates every other drill bundle passes.
    problems = _gate_bundle(store_dir, require_slo=True)
    expect(
        not problems,
        f"bundle + SLO gates green on the controller bundle "
        f"({problems[:3]})",
    )
    problems = _gate_bundle(target / "serve")
    expect(
        not problems,
        f"bundle gate green on the serve bundle ({problems[:3]})",
    )
    gate_failures = 0
    for s in stores:
        problems = _gate_store(s)
        if problems:
            gate_failures += 1
            print(f"FAIL fleet-store gate {s}: {problems[:3]}", flush=True)
    expect(
        gate_failures == 0,
        f"fleet-store gates green on all {len(stores)} window stores",
    )
    if gate_failures:
        failures.append(f"{gate_failures} window-store gate failures")

    publish_atomic(
        target / "soak_summary.json",
        json.dumps(
            {
                "subnets": subnets,
                "versions": list(args.versions),
                "windows_swept": len(swept),
                "stores": stores,
                "units_published": total_units,
                "unit_ok_records": total_unit_ok,
                "whatifs_ok": load_stats["ok"],
                "quarantined_block": corrupt_block,
                "stalled_netuid": stall_netuid,
                "sealed_segments": len(sealed_segments),
                "device": args.device,
                "seconds": round(time.time() - t_start, 6),
                "cycles": cycle_lines,
                "incidents": {
                    str(cls): int(count)
                    for cls, count in sorted(by_class.items())
                    if cls
                },
                "failures": failures,
            },
            indent=2,
            sort_keys=True,
        ).encode(),
    )
    print(
        f"\nreplay soak {'FAILED' if failures else 'passed'}: "
        f"{len(swept)} windows across {subnets} subnets x "
        f"{len(args.versions)} variant(s), {load_stats['ok']} what-ifs, "
        f"1 torn blob, 1 stall, 2 SIGKILLs"
    )
    return 1 if failures else 0

"""The chain-replay CLI: one-shot drill, continuous-controller modes,
and the multi-process chaos soak.

Modes (mutually exclusive):

- ``--drill``      — the CI ``replay`` lane's one-shot engine (below);
- ``--controller`` — the standing continuous-replay controller
  (:mod:`.controller`): poll the archive, sweep watermark suffixes
  forever (or ``--cycles N``);
- ``--host``       — a helper fleet host joining the controller's
  in-flight windows through the lease-claim path;
- ``--writer``     — the synthetic archive feed the soak's chaos rides
  on (stall + torn-blob injections, :mod:`.soak`);
- ``--soak``       — the CI ``soak`` lane's engine: writer, controller,
  and host as real processes, SIGKILLs mid-sweep, and a verdict from
  the durable artifacts only (:func:`.soak.run_soak`).

Every mode runs on ``--device`` (``cuda``, the default, raises without
CUDA; ``--device cpu`` runs on the CPU) and passes it to every process
it starts: no child falls back to the CPU.

``python -m yuma_simulation_tpu_torch.replay --drill --bundle-dir DIR`` runs
the whole product loop end to end, deterministically:

1. seed a synthetic 3-snapshot timeline into ``DIR/archive`` (the
   foundry generator — no network, no fixtures);
2. run the trailing-window fleet sweep over it (every requested variant
   as lease-claimed, 100%-canaried fleet units) into ``DIR/store`` —
   the driftreport-gated bundles — refreshing the epoch-state cache at
   ``DIR/cache``;
3. serve two identical what-ifs through a real HTTP server mounted on
   the archive with a FRESH state cache (flight bundle at
   ``DIR/serve``): the first is the typed **state_cache_miss** that
   builds and checkpoints the baseline, the second a **state_cache
   hit** that re-simulates only the suffix, adds **zero kernel-library
   builds**, and returns bitwise the first's deltas.

The artifacts then pass ``obsreport --check`` (serve bundle + fleet
stores) and ``driftreport --check --require`` (fleet stores), the same
gates every other drill bundle passes. Exit 0 only when every
expectation held and the sweep saw no drift.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

DRILL_VERSIONS = ("Yuma 1 (paper)", "Yuma 2 (Adrian-Fish)")


def run_drill(args) -> int:
    import pathlib

    from yuma_simulation_tpu_torch.replay import (
        SnapshotArchive,
        StateCache,
        synthetic_timeline,
        sweep_trailing_window,
    )
    from yuma_simulation_tpu_torch.serve.server import (
        SimulationClient,
        SimulationServer,
        wait_until_ready,
    )
    from yuma_simulation_tpu_torch.ops._build import process_stats
    from yuma_simulation_tpu_torch.serve.service import ServeConfig
    from yuma_simulation_tpu_torch.telemetry.metrics import get_registry
    from yuma_simulation_tpu_torch.utils import setup_logging
    from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

    setup_logging()
    target = pathlib.Path(args.bundle_dir)
    failures: list[str] = []

    def expect(cond: bool, what: str) -> None:
        print(("ok   " if cond else "FAIL ") + what)
        if not cond:
            failures.append(what)

    # 1. the synthetic timeline (deterministic: same seed -> same bits).
    archive = SnapshotArchive(target / "archive")
    entries = synthetic_timeline(
        archive,
        args.netuid,
        snapshots=3,
        seed=args.seed,
        num_validators=args.validators,
        num_miners=args.miners,
    )
    expect(
        len(entries) == 3
        and [e.block for e in entries]
        == sorted(e.block for e in entries),
        f"timeline seeded: 3 snapshots at blocks "
        f"{[e.block for e in entries]}",
    )

    # 2. the trailing-window fleet sweep (canaries on, stores gated by
    # CI's driftreport pass).
    cache = StateCache(target / "cache")
    summary = sweep_trailing_window(
        archive,
        cache,
        store_root=target / "store",
        versions=list(args.versions),
        epochs_per_snapshot=args.epochs_per_snapshot,
        stride=args.stride,
        canary_fraction=1.0,
        unit_size=1,
        device=args.device,
    )
    expect(
        summary["units_completed"] == len(args.versions),
        f"fleet sweep published {summary['units_completed']} unit(s) "
        f"across {len(args.versions)} variant(s)",
    )
    expect(
        summary["canaries_run"] >= len(args.versions),
        f"every sweep unit ran its numerics canary "
        f"({summary['canaries_run']} run)",
    )
    expect(
        summary["drift_events"] == 0,
        f"sweep drift-clean (drift_events={summary['drift_events']})",
    )

    # 3. two what-ifs through a real server mounted on the swept state.
    E = 3 * args.epochs_per_snapshot
    perturb_epoch = E - args.epochs_per_snapshot + 1
    spec = {
        "netuid": args.netuid,
        "version": args.versions[0],
        "from_epoch": perturb_epoch,
        "stake_scale": [[1, 2.0]],
        "weight_rows": [[0, [1.0] + [0.0] * (args.miners - 1)]],
    }
    # The serve tier gets its OWN state cache (not the sweep's), so
    # what-if #1 exercises the full miss path end to end — typed
    # state_cache_miss, baseline build, checkpoints published — and
    # what-if #2 proves the hit path returns bitwise the same deltas.
    server = SimulationServer(
        ServeConfig(
            device=args.device,
            bundle_dir=str(target / "serve"),
            replay_archive_dir=str(target / "archive"),
            replay_cache_dir=str(target / "serve-cache"),
            replay_epochs_per_snapshot=args.epochs_per_snapshot,
            replay_stride=args.stride,
            executable_cache_dir=str(target / "aot"),
        )
    ).start()
    try:
        expect(wait_until_ready(server.url), "server answers /healthz")
        client = SimulationClient(server.url, tenant="replay-drill")
        r = client.replay(args.netuid)
        expect(
            r.status == 200 and r.body.get("epochs") == E,
            f"GET /v1/replay/{args.netuid} -> {E}-epoch window "
            f"(got {r.status} {r.body.get('epochs')})",
        )
        first = client.whatif(spec)
        expect(
            first.status == 200 and first.body.get("status") == "ok",
            f"what-if #1 -> 200 ok (got {first.status} "
            f"{first.body.get('error')})",
        )
        expect(
            first.body.get("cache_hit") is False
            and first.body.get("epochs_simulated") == E,
            f"what-if #1 is the typed miss that builds the baseline "
            f"(got cache_hit={first.body.get('cache_hit')} "
            f"epochs={first.body.get('epochs_simulated')})",
        )
        hits_before = get_registry().counter("state_cache_hits").value
        builds_before = process_stats().builds
        second = client.whatif(spec)
        hits_after = get_registry().counter("state_cache_hits").value
        builds_after = process_stats().builds
        expect(
            second.status == 200 and second.body.get("cache_hit") is True,
            f"what-if #2 is a state_cache_hit (got "
            f"{second.body.get('cache_hit')})",
        )
        expect(
            hits_after == hits_before + 1,
            f"state_cache_hits counted the hit "
            f"({hits_before} -> {hits_after})",
        )
        expect(
            builds_after == builds_before,
            f"what-if #2 added zero kernel-library builds "
            f"({builds_before} -> {builds_after})",
        )
        suffix = second.body.get("epochs_simulated")
        saved = second.body.get("epochs_saved")
        expect(
            isinstance(suffix, int)
            and isinstance(saved, int)
            and suffix + saved == E
            and suffix <= E - args.stride + args.epochs_per_snapshot
            and saved > 0,
            f"suffix-sized re-simulation: {suffix} of {E} epochs "
            f"({saved} saved)",
        )
        expect(
            first.body.get("total_dividend_delta")
            == second.body.get("total_dividend_delta"),
            "hit-path deltas bitwise the miss-path build's",
        )
    finally:
        server.close()

    publish_atomic(
        target / "drill_summary.json",
        json.dumps(
            {
                "netuid": args.netuid,
                "versions": list(args.versions),
                "stores": summary["stores"],
                "serve_bundle": str(target / "serve"),
                "failures": failures,
            },
            indent=2,
            sort_keys=True,
        ).encode(),
    )
    print(
        f"\nreplay drill {'FAILED' if failures else 'passed'}: "
        f"{len(entries)} snapshots -> {summary['units_completed']} fleet "
        f"unit(s) -> 2 what-ifs (stores: {', '.join(summary['stores'])})"
    )
    return 1 if failures else 0


def run_controller_mode(args) -> int:
    """The standing controller process (``--controller``): one
    :class:`.controller.ReplayController` on the shared archive/cache/
    store, polling until killed (crash-safe by construction — SIGKILL
    at any instant is the soak's bread and butter) or ``--cycles``
    elapse. One cycle line per poll on stdout — the soak parses
    ``shed=`` for the backpressure verdict."""
    import time

    from yuma_simulation_tpu_torch.replay.archive import SnapshotArchive
    from yuma_simulation_tpu_torch.replay.controller import (
        ControllerConfig,
        ReplayController,
    )
    from yuma_simulation_tpu_torch.replay.statecache import StateCache
    from yuma_simulation_tpu_torch.utils import setup_logging

    setup_logging()
    controller = ReplayController(
        SnapshotArchive(args.archive),
        StateCache(args.cache),
        ControllerConfig(
            store_root=args.store,
            versions=tuple(args.versions),
            epochs_per_snapshot=args.epochs_per_snapshot,
            stride=args.stride,
            unit_size=args.unit_size,
            poll_seconds=args.poll,
            slow_poll_seconds=args.slow_poll,
            stall_deadline_seconds=(
                args.stall_deadline
                if args.stall_deadline is not None
                else 10.0
            ),
            freshness_budget_seconds=(
                args.freshness_budget
                if args.freshness_budget is not None
                else 30.0
            ),
            max_windows_per_cycle=args.max_windows,
            lease_ttl_seconds=args.lease_ttl,
            flight_rotation=args.rotate_flight or None,
            profile_window_seconds=args.profile_window,
            device=args.device,
        ),
    )
    cycles = 0
    try:
        while args.cycles is None or cycles < args.cycles:
            t0 = time.perf_counter()
            report = controller.run_cycle()
            seconds = time.perf_counter() - t0
            cycles += 1
            print(
                f"cycle={cycles} swept={report.windows_swept} "
                f"shed={report.windows_shed} "
                f"stalled={report.subnets_stalled} "
                f"quarantined={report.snapshots_quarantined} "
                f"stale={report.max_staleness_seconds:.2f} "
                f"seconds={seconds:.6f}",
                flush=True,
            )
            time.sleep(args.poll)
    finally:
        controller.close()
    return 0


def run_host_mode(args) -> int:
    """A helper fleet host process (``--host``) for the controller's
    in-flight windows."""
    from yuma_simulation_tpu_torch.replay.archive import SnapshotArchive
    from yuma_simulation_tpu_torch.replay.controller import run_host
    from yuma_simulation_tpu_torch.replay.statecache import StateCache
    from yuma_simulation_tpu_torch.utils import setup_logging

    setup_logging()
    joined = run_host(
        SnapshotArchive(args.archive),
        StateCache(args.cache),
        args.store,
        poll_seconds=args.poll,
        unit_size=args.unit_size,
        lease_ttl_seconds=args.lease_ttl,
        max_idle_polls=args.max_idle_polls,
        device=args.device,
    )
    print(f"host joined {joined} window(s)", flush=True)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m yuma_simulation_tpu_torch.replay",
        description=__doc__.split("\n\n")[0],
    )
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument(
        "--drill",
        action="store_true",
        help="run the chain-replay drill (CI smoke)",
    )
    mode.add_argument(
        "--soak",
        action="store_true",
        help="run the multi-process continuous-replay chaos soak "
        "(CI soak lane)",
    )
    mode.add_argument(
        "--controller",
        action="store_true",
        help="run the standing continuous-replay controller",
    )
    mode.add_argument(
        "--host",
        action="store_true",
        help="run a helper fleet host joining in-flight windows",
    )
    mode.add_argument(
        "--writer",
        action="store_true",
        help="run the soak's synthetic archive feed",
    )
    parser.add_argument(
        "--bundle-dir",
        default="replay-bundle",
        help="drill/soak output root (archive/, cache/, store/, "
        "serve/)",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="the device every mode runs on, passed to every process it "
        "starts (default: the card; without CUDA this raises: pass "
        "--device cpu to run on the CPU)",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--netuid", type=int, default=0)
    parser.add_argument(
        "--validators", type=int, default=3,
        help="synthetic subnet validator count",
    )
    parser.add_argument(
        "--miners", type=int, default=4,
        help="synthetic subnet miner count",
    )
    parser.add_argument("--epochs-per-snapshot", type=int, default=4)
    parser.add_argument(
        "--stride", type=int, default=4,
        help="carry-checkpoint stride of the cached baselines",
    )
    parser.add_argument(
        "--versions",
        nargs="+",
        default=list(DRILL_VERSIONS),
        help="Yuma variants to sweep",
    )
    shared = parser.add_argument_group(
        "controller/host/writer", "shared directories"
    )
    shared.add_argument(
        "--archive", default=None, help="snapshot archive directory"
    )
    shared.add_argument(
        "--cache", default=None, help="epoch-state cache directory"
    )
    shared.add_argument(
        "--store", default=None,
        help="controller store root (watermarks, window fleet stores, "
        "flight bundle)",
    )
    ctl = parser.add_argument_group("controller")
    ctl.add_argument("--poll", type=float, default=0.5)
    ctl.add_argument("--slow-poll", type=float, default=5.0)
    # Defaults are per mode (standing controller: 10s/30s; soak: tight
    # enough that the injected downtime overruns the budget), so None
    # here means "mode default".
    ctl.add_argument("--stall-deadline", type=float, default=None)
    ctl.add_argument("--freshness-budget", type=float, default=None)
    ctl.add_argument(
        "--max-windows", type=int, default=None,
        help="windows swept per cycle before shedding (backpressure)",
    )
    ctl.add_argument("--unit-size", type=int, default=8)
    ctl.add_argument("--lease-ttl", type=float, default=30.0)
    ctl.add_argument(
        "--cycles", type=int, default=None,
        help="stop after N cycles (default: run forever)",
    )
    ctl.add_argument(
        "--rotate-flight", action="store_true",
        help="continuous telemetry: rotate the controller's flight "
        "bundle into crash-safe sealed segments (default bounds; "
        "YUMA_TPU_FLIGHT_ROTATE=1 is the env equivalent)",
    )
    ctl.add_argument(
        "--profile-window", type=float, default=0.0,
        help="arm ONE guarded torch.profiler window of this many "
        "seconds over the first cycle that sweeps work (the ops "
        "plane's ProfileSession; the artifact registers into the "
        "bundle's profiles.jsonl; 0 disables)",
    )
    ctl.add_argument(
        "--max-idle-polls", type=int, default=None,
        help="host only: exit after N consecutive idle polls",
    )
    soak = parser.add_argument_group("writer/soak chaos injections")
    soak.add_argument(
        "--subnets", type=int, default=4,
        help="synthetic subnet count",
    )
    soak.add_argument(
        "--rounds", type=int, default=10,
        help="final snapshot count per (unstalled) subnet",
    )
    soak.add_argument(
        "--interval", type=float, default=0.8,
        help="seconds from the start of one writer round to the next",
    )
    soak.add_argument(
        "--stall-netuid", type=int, default=-1,
        help="writer: subnet whose feed goes quiet (soak picks the "
        "last subnet)",
    )
    soak.add_argument(
        "--stall-after", type=int, default=3,
        help="snapshot count after which the stalled feed goes quiet",
    )
    soak.add_argument(
        "--corrupt-netuid", type=int, default=1,
        help="subnet that receives the torn-blob injection",
    )
    soak.add_argument(
        "--corrupt-round", type=int, default=5,
        help="snapshot index (1-based) published with a torn blob",
    )
    soak.add_argument(
        "--kill-after", type=float, default=4.0,
        help="soak: seconds before SIGKILLing controller + host",
    )
    soak.add_argument(
        "--downtime", type=float, default=4.0,
        help="soak: seconds the controller stays dead (freshness debt)",
    )
    soak.add_argument("--drain-timeout", type=float, default=300.0)
    soak.add_argument("--recovery-timeout", type=float, default=180.0)
    args = parser.parse_args(argv)

    import pathlib

    # Raises here, before any process starts, when the card is asked for
    # and CUDA is absent: no mode falls back to the CPU.
    from yuma_simulation_tpu_torch.simulation.engine import resolve_device

    if args.controller or args.host or args.writer:
        missing = [
            flag
            for flag, value in (
                ("--archive", args.archive),
                ("--cache", args.cache),
                ("--store", args.store),
            )
            if value is None and not (args.writer and flag != "--archive")
        ]
        if missing:
            parser.error(
                f"{' '.join(missing)} required for this mode"
            )
        resolve_device(args.device)
        if args.controller:
            return run_controller_mode(args)
        if args.host:
            return run_host_mode(args)
        from yuma_simulation_tpu_torch.replay.soak import run_writer

        return run_writer(args)

    if not (args.drill or args.soak):
        parser.print_help()
        return 2
    target = pathlib.Path(args.bundle_dir)
    if target.exists() and any(target.iterdir()):
        # A resumed drill satisfies sweep units from the prior run's
        # store and hits a pre-warmed cache — refuse, like the other
        # drills do.
        print(
            f"--bundle-dir {args.bundle_dir!r} exists and is not empty; "
            "point the drill at a fresh directory",
            file=sys.stderr,
        )
        return 2
    resolve_device(args.device)
    if args.soak:
        from yuma_simulation_tpu_torch.replay.soak import run_soak

        return run_soak(args)
    return run_drill(args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())

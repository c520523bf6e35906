"""Simulated fleet hosts: the multiprocess pod-level chaos drill.

A *simulated host* is a real OS process running the real fleet scheduler
against a real shared store, on the device its driver names with
``--device`` (the card by default; the CPU in the CPU tests). A host
never falls back from one device to another: without CUDA a
``--device cuda`` host raises. Two entry points:

- ``python -m yuma_simulation_tpu_torch.fabric.simhost --store DIR --host-id
  H --device D ...`` — ONE host process: builds the deterministic
  built-in scenario suite, runs one unit of it once outside any lease
  (the device's context, the first dispatch and, with a cache, the
  kernels' load all happen before the first claim, so none of them can
  outlive a lease's TTL), optionally arms a
  :class:`..resilience.faults.FaultPlan` from its flags (host crash,
  lease tear, stall, NaN lane), and participates in the fleet sweep
  until every unit is published.
- :func:`run_drill` — the drill DRIVER: computes the unfaulted oracle
  in-process, spawns >=3 simulated hosts with one fault each (kill /
  lease tear / stall+NaN), waits them out, finalizes the fleet report,
  and VERIFIES the whole pod-level guarantee: the sweep completes, no
  unit is lost, none double-publishes, healthy lanes are
  bitwise-identical to the unfaulted run, and the
  :class:`..fabric.health.FleetHealthReport` reconciles with the merged
  ledgers (``obsreport --check`` semantics). Raises on any violation.
  Every child and every wait is bounded by the drill's `timeout`.

Determinism notes: the scenario suite is the built-in case registry (a
pure function of nothing), unit bounds live in the write-once manifest,
and every fault is one of the deterministic hooks in
:mod:`..resilience.faults`. WHICH host executes a given unit is
scheduling-dependent (that is the point of work stealing), but unit
RESULTS are not — any healthy host produces bitwise the same bytes.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import signal
import subprocess
import sys
import time

DEFAULT_VERSION = "Yuma 1 (paper)"

#: Drill geometry: 10 cases x unit_size 2 = 5 units, partitioned by
#: affinity as crash-host:[0], stall+NaN host:[1,2], tear host:[3,4].
DRILL_NUM_CASES = 10
DRILL_UNIT_SIZE = 2
DRILL_TTL = 3.0

#: The drill DRIVER's bundle directory name under ``hosts/``: the root
#: of the stitched cross-process trace (every simulated host's spans
#: chain up to the driver's ``fleet_drill`` span through the env-
#: propagated trace context).
DRIVER_HOST_ID = "driver"


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="simhost", description=__doc__.split("\n\n")[0]
    )
    p.add_argument("--store", required=True, help="shared fleet store dir")
    p.add_argument("--host-id", required=True)
    p.add_argument("--version", default=DEFAULT_VERSION)
    p.add_argument(
        "--device", default="cuda",
        help="the device this host's units run on (default: the card; "
        "raises without CUDA, never falls back to the CPU)",
    )
    p.add_argument("--num-cases", type=int, default=DRILL_NUM_CASES)
    p.add_argument("--unit-size", type=int, default=DRILL_UNIT_SIZE)
    p.add_argument("--ttl", type=float, default=DRILL_TTL)
    p.add_argument("--heartbeat", type=float, default=0.5)
    p.add_argument("--poll", type=float, default=0.1)
    p.add_argument("--max-wait", type=float, default=300.0)
    p.add_argument(
        "--preferred", default="",
        help="comma-separated unit indices this host claims first",
    )
    p.add_argument("--poach-after", type=float, default=30.0)
    p.add_argument(
        "--executable-cache",
        default=None,
        metavar="DIR",
        help="kernel-library cache directory (simulation.aot): this host "
        "builds or loads and launches its unit-shaped kernels before "
        "claiming its first lease, and publishes what it builds",
    )
    # Deadline knobs (the stall host's first attempts; retries get the
    # grace on top).
    p.add_argument("--deadline", type=float, default=240.0)
    p.add_argument("--grace", type=float, default=240.0)
    # Fault knobs — each maps onto one deterministic hook.
    p.add_argument("--crash-after-claims", type=int, default=0)
    p.add_argument("--tear-after-renewals", type=int, default=0)
    p.add_argument("--stall-seconds", type=float, default=0.0)
    p.add_argument("--stall-dispatches", type=int, default=0)
    p.add_argument("--nan-epoch", type=int, default=-1)
    p.add_argument("--nan-case", type=int, default=-1)
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    from yuma_simulation_tpu_torch.fabric.scheduler import (
        FleetConfig,
        run_fleet_batch,
    )
    from yuma_simulation_tpu_torch.resilience import (
        Deadline,
        FaultPlan,
        HostCrashFault,
        LeaseTearFault,
        NaNFault,
        RetryPolicy,
        StallFault,
        SweepSupervisor,
        inject_faults,
    )
    from yuma_simulation_tpu_torch.scenarios import get_cases
    from yuma_simulation_tpu_torch.simulation.engine import resolve_device
    from yuma_simulation_tpu_torch.utils import setup_logging

    setup_logging()
    device = resolve_device(args.device)
    cases = get_cases()[: args.num_cases]
    policy = RetryPolicy(max_attempts_per_rung=2, backoff_base=0.0, seed=0)
    preferred = tuple(
        int(u) for u in args.preferred.split(",") if u.strip() != ""
    )
    fleet = FleetConfig(
        directory=args.store,
        host_id=args.host_id,
        lease_ttl_seconds=args.ttl,
        heartbeat_seconds=args.heartbeat,
        poll_seconds=args.poll,
        max_wait_seconds=args.max_wait,
        unit_size=args.unit_size,
        preferred_units=preferred,
        poach_after_seconds=args.poach_after,
        executable_cache_dir=args.executable_cache,
    )

    plan_kwargs: dict = {}
    if args.crash_after_claims > 0:
        plan_kwargs["host_crash"] = HostCrashFault(
            after_claims=args.crash_after_claims
        )
    if args.tear_after_renewals > 0:
        plan_kwargs["lease_tear"] = LeaseTearFault(
            after_renewals=args.tear_after_renewals
        )
    if args.stall_dispatches > 0:
        plan_kwargs["stall"] = StallFault(
            seconds=args.stall_seconds, dispatches=args.stall_dispatches
        )
    if args.nan_epoch >= 0:
        plan_kwargs["nan"] = NaNFault(
            epoch=args.nan_epoch,
            case=None if args.nan_case < 0 else args.nan_case,
        )

    # Warm one unit outside any lease, under a roomy budget: the device's
    # context and the first dispatch (and the NaN-operand variant when
    # that fault is armed) must never be what a lease's TTL or the stall
    # host's tight deadline measures.
    roomy = SweepSupervisor(
        directory=None,
        unit_size=args.unit_size,
        deadline=Deadline(240.0, grace_seconds=240.0),
        retry_policy=policy,
    )
    warm_cases = cases[: args.unit_size]
    roomy.run_batch(warm_cases, args.version, device=device)
    if plan_kwargs.get("nan") is not None:
        with inject_faults(FaultPlan(nan=plan_kwargs["nan"])):
            roomy.run_batch(warm_cases, args.version, device=device)
    budget = args.deadline
    if plan_kwargs.get("stall") is not None:
        # The tight deadline must kill the injected hold and, on a slow
        # device, should not kill a healthy warm unit: it is at least
        # three warm units, and the hold at least three deadlines.
        t0 = time.perf_counter()
        roomy.run_batch(warm_cases, args.version, device=device)
        budget = max(args.deadline, 3.0 * (time.perf_counter() - t0))
        stall = plan_kwargs["stall"]
        plan_kwargs["stall"] = StallFault(
            seconds=max(stall.seconds, 3.0 * budget), dispatches=stall.dispatches
        )
    deadline = Deadline(budget, grace_seconds=args.grace)

    supervisor = SweepSupervisor(
        directory=None,
        unit_size=args.unit_size,
        deadline=deadline,
        retry_policy=policy,
    )

    def participate():
        return run_fleet_batch(
            cases,
            args.version,
            fleet,
            tag="fleet_drill",
            supervisor=supervisor,
            finalize=False,
            device=device,
        )

    if plan_kwargs:
        with inject_faults(FaultPlan(**plan_kwargs)):
            out = participate()
    else:
        out = participate()
    summary = out["host"]
    print(
        f"FLEET_HOST_DONE {args.host_id} "
        f"published={summary.units_published} "
        f"stolen={summary.units_stolen} "
        f"abandoned={summary.units_abandoned} "
        f"duplicates={summary.units_duplicate}",
        flush=True,
    )
    return 0


# -------------------------------------------------------------- the drill


def _spawn_host(
    store: str,
    host_args: list[str],
    out_dir: pathlib.Path,
    extra_env: dict | None = None,
):
    """One simulated host subprocess with file-backed stdio (a crashing
    host's traceback must not deadlock a pipe). `extra_env` carries the
    driver's trace context (``YUMA_TRACEPARENT``) so the host's run
    continues the drill-level trace. The child inherits the environment,
    the kernels' build directory (``YUMA_TORCH_BUILD_DIR``) included, so it
    loads what its parent built."""
    repo = pathlib.Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    env.update(extra_env or {})
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [str(repo), env.get("PYTHONPATH", "")] if p
    )
    host_id = host_args[host_args.index("--host-id") + 1]
    out = open(out_dir / f"{host_id}.out", "w+")
    err = open(out_dir / f"{host_id}.err", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "yuma_simulation_tpu_torch.fabric.simhost",
         "--store", store, *host_args],
        env=env,
        stdout=out,
        stderr=err,
        text=True,
    )
    return proc, out, err


def run_drill(
    directory: str | pathlib.Path,
    *,
    timeout: float = 420.0,
    version: str = DEFAULT_VERSION,
    device="cuda",
) -> dict:
    """The pod-level chaos drill (module docstring), its host processes on
    `device` (each one passed ``--device``). Verifies every acceptance
    property and raises on violation; every host still running when
    `timeout` seconds are up is killed and the drill raises. Returns a
    summary dict (`report`, `oracle`, `merged`, per-host rc / stdout /
    stderr)."""
    import numpy as np

    from yuma_simulation_tpu_torch.fabric.health import (
        build_fleet_report,
        check_fleet,
        merged_ledger,
        publish_fleet_report,
        quarantine_entries,
    )
    from yuma_simulation_tpu_torch.fabric.store import FleetStore
    from yuma_simulation_tpu_torch.telemetry.flight import (
        FlightRecorder,
        check_bundle,
        check_stitched,
        load_bundle,
    )
    from yuma_simulation_tpu_torch.telemetry.propagation import (
        BAGGAGE_ENV,
        TRACEPARENT_ENV,
        current_trace_context,
    )
    from yuma_simulation_tpu_torch.telemetry.runctx import RunContext, span

    target = pathlib.Path(directory)
    if target.exists() and any(target.iterdir()):
        raise SystemExit(
            f"fleet-drill target {str(target)!r} already exists and is "
            "not empty; point the drill at a fresh directory (a resumed "
            "drill exercises none of its faults)"
        )
    target.mkdir(parents=True, exist_ok=True)
    logs = target / "drill-logs"
    logs.mkdir()

    store_dir = str(target / "store")
    oracle_store_dir = str(target / "oracle-store")
    common = [
        "--version", version,
        "--device", str(device),
        "--num-cases", str(DRILL_NUM_CASES),
        "--unit-size", str(DRILL_UNIT_SIZE),
        "--ttl", str(DRILL_TTL),
        "--poach-after", "60.0",
    ]
    # Host roles (>=3 hosts, one fault family each): crash / stall+NaN /
    # lease tear. Affinity spreads the initial claims so each fault
    # lands regardless of startup jitter; stealing recovers the crash.
    # A fourth, UNFAULTED host runs the same sweep into its own store —
    # the oracle: computed in an identical subprocess environment so
    # "healthy lanes bitwise-identical to the unfaulted run" compares
    # like with like.
    hosts = {
        "crash-host": (store_dir, common + [
            "--host-id", "crash-host",
            "--preferred", "0",
            "--crash-after-claims", "1",
        ]),
        "stall-host": (store_dir, common + [
            "--host-id", "stall-host",
            "--preferred", "1,2",
            "--stall-seconds", "1.0",
            "--stall-dispatches", "1",
            "--nan-epoch", "2",
            "--nan-case", "1",
            "--deadline", "0.15",
            "--grace", "60.0",
        ]),
        "tear-host": (store_dir, common + [
            "--host-id", "tear-host",
            "--preferred", "3,4",
            "--tear-after-renewals", "1",
        ]),
        "oracle-host": (oracle_store_dir, common + [
            "--host-id", "oracle-host",
        ]),
    }
    # The drill is ONE distributed trace: the driver opens the root run
    # + span, hands its context to the faulted hosts through the env
    # (the oracle runs a SEPARATE sweep into its own store and gets a
    # scrubbed env so its self-contained bundle stays self-resolving),
    # and publishes its own bundle under hosts/driver so every host
    # span's parent chain roots at the driver's run on disk.
    driver_run = RunContext()
    procs = {}
    files = []
    results = {}
    with driver_run:
        with span("fleet_drill", hosts=list(hosts)):
            ctx = current_trace_context()
            assert ctx is not None  # the driver run/span is open
            trace_env = ctx.to_env()
            scrubbed = {TRACEPARENT_ENV: "", BAGGAGE_ENV: ""}
            for host_id, (host_store, host_args) in hosts.items():
                proc, out, err = _spawn_host(
                    host_store,
                    host_args,
                    logs,
                    extra_env=(
                        scrubbed if host_id == "oracle-host" else trace_env
                    ),
                )
                procs[host_id] = proc
                files.extend([out, err])
            try:
                deadline_t = time.monotonic() + timeout
                for host_id, proc in procs.items():
                    remaining = max(1.0, deadline_t - time.monotonic())
                    rc = proc.wait(timeout=remaining)
                    results[host_id] = rc
            finally:
                # A host still running here (a timeout, or any other
                # failure) is killed: the drill leaves no process behind.
                for proc in procs.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait(timeout=30)
                streams = {}
                for f in files:
                    f.seek(0)
                    streams[pathlib.Path(f.name).name] = f.read()
                    f.close()
    FlightRecorder(
        FleetStore(store_dir).host_dir(DRIVER_HOST_ID)
    ).record(driver_run)

    def _log(host_id: str, stream: str) -> str:
        return streams.get(f"{host_id}.{stream}", "")

    # -- verification ---------------------------------------------------
    problems: list[str] = []
    if results["crash-host"] != -signal.SIGKILL:
        problems.append(
            f"crash-host exited {results['crash-host']}, expected "
            f"SIGKILL ({-signal.SIGKILL}):\n{_log('crash-host', 'err')[-2000:]}"
        )
    for host_id in ("stall-host", "tear-host", "oracle-host"):
        if results[host_id] != 0:
            problems.append(
                f"{host_id} exited {results[host_id]}:\n"
                f"{_log(host_id, 'err')[-3000:]}"
            )
    if "kind=lease_tear" not in _log("tear-host", "err"):
        problems.append("tear-host never injected its lease tear")
    if problems:
        raise AssertionError("fleet drill host failures:\n" + "\n".join(problems))

    store = FleetStore(store_dir)
    report = publish_fleet_report(store)
    merged = merged_ledger(store)
    oracle = FleetStore(oracle_store_dir).collect("dividends")
    oracle_report = publish_fleet_report(oracle_store_dir)
    if not oracle_report.clean:
        problems.append(
            f"the unfaulted oracle run was not clean: {oracle_report}"
        )

    # The sweep completed: every unit published, none lost.
    if report.units_published != report.num_units:
        problems.append(
            f"{report.units_published}/{report.num_units} units published"
        )
    # At-most-once publish: exactly one accepted execution per unit.
    ok_units = [r["unit"] for r in merged if r.get("event") == "unit_ok"]
    if sorted(ok_units) != list(range(report.num_units)):
        problems.append(
            f"unit_ok records {sorted(ok_units)} != exactly one per unit"
        )
    # The faults all fired and were survived.
    if "crash-host" not in report.hosts_lost:
        problems.append(f"hosts_lost={report.hosts_lost} misses crash-host")
    if report.units_stolen < 1:
        problems.append("no unit was stolen despite the host kill")
    if report.stalls_killed < 1:
        problems.append("no stall was killed despite the stall fault")
    if report.lanes_quarantined < 1:
        problems.append("no lane was quarantined despite the NaN fault")

    # Healthy lanes: bitwise-identical to the unfaulted oracle; poisoned
    # lanes: bitwise prefix before the injected epoch, zero-masked after.
    dividends = store.collect("dividends")
    entries = quarantine_entries(store)
    poisoned = {e.case: e.epoch for e in entries}
    for lane in range(dividends.shape[0]):
        if lane in poisoned:
            epoch = poisoned[lane]
            if not np.array_equal(
                dividends[lane][:epoch], oracle[lane][:epoch]
            ):
                problems.append(
                    f"poisoned lane {lane} prefix differs from oracle"
                )
            if not (dividends[lane][epoch:] == 0).all():
                problems.append(
                    f"poisoned lane {lane} not zero-masked from epoch "
                    f"{epoch}"
                )
        elif not np.array_equal(dividends[lane], oracle[lane]):
            problems.append(
                f"healthy lane {lane} is not bitwise-identical to the "
                "unfaulted run"
            )

    # The report reconciles with the merged ledgers, and every FINISHED
    # host's bundle is sound (ledger records resolve to spans). A
    # SIGKILLed host never runs its bundle-publish finally — its live
    # ledger IS its surviving record; demanding spans of the dead is
    # exactly the false positive the gate must not produce.
    problems.extend(check_fleet(store.directory))
    for host_id in report.hosts_finished:
        bundle = load_bundle(store.host_dir(host_id))
        problems.extend(
            f"host {host_id}: {p}" for p in check_bundle(bundle)
        )
    derived = build_fleet_report(store)
    if derived != report:
        problems.append("re-derived fleet report differs from published")

    # ONE stitched trace: the union of every host bundle (driver
    # included) must resolve — no orphan spans — and every span in
    # every FINISHED host's bundle must chain up to a root span of the
    # DRIVER's run (the env-propagated trace actually took).
    all_bundles = [
        load_bundle(store.host_dir(h)) for h in store.host_ids()
    ]
    problems.extend(check_stitched(all_bundles))
    union: dict = {}
    for b in all_bundles:
        for s in b.spans:
            union[s.get("span_id")] = s
    driver_span_ids = {
        s.get("span_id")
        for b in all_bundles
        if b.directory.name == DRIVER_HOST_ID
        for s in b.spans
    }
    def _chain_root(s: dict):
        cur = s
        for _ in range(len(union) + 1):
            parent = cur.get("parent_id", "")
            if not parent:
                return cur
            cur = union.get(parent)
            if cur is None:
                return None  # broken chain (check_stitched flagged it)
        return None  # cycle (check_stitched flagged it)

    for host_id in report.hosts_finished:
        for s in load_bundle(store.host_dir(host_id)).spans:
            if s.get("run_id") != driver_run.run_id:
                problems.append(
                    f"host {host_id} span {s.get('span_id')} minted run "
                    f"{s.get('run_id')} instead of continuing the "
                    f"driver's {driver_run.run_id}"
                )
                continue
            root = _chain_root(s)
            if root is not None and root.get("span_id") not in driver_span_ids:
                problems.append(
                    f"host {host_id} span {s.get('span_id')} roots at "
                    f"{root.get('span_id')}, not a driver span"
                )

    if problems:
        raise AssertionError(
            "fleet drill verification failed:\n"
            + "\n".join(f"  - {p}" for p in problems)
        )
    return {
        "store": store_dir,
        "report": report,
        "oracle": oracle,
        "dividends": dividends,
        "merged": merged,
        "rcs": results,
        "logs": streams,
    }


if __name__ == "__main__":
    raise SystemExit(main())

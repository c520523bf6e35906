"""The fleet fabric of the port (`fabric/{lease,store,scheduler,health,
simhost}.py`, the CLIs' `--fleet-store`, `run_simulation(fleet=)`,
`run_montecarlo(route="fleet")`) on the CPU, against the JAX package's.

The cases of the JAX package's `tests/unit/test_fabric.py`, each on the
port: claim and steal exclusivity under randomized interleavings, torn
leases, expiry-driven stealing with its attempt history, at-most-once
publish with corruption requeue, the fleet bitwise the supervised run,
resume as pure collection, `check_fleet`'s tamper and loss flags, the
v1 knob, the CLI store, the grid driver. Three of them fail in the JAX
package on this toolchain (its fault hooks never fire under jax 0.9:
the lease tear, the host crash and the NaN lane); the port's hooks fire,
and those cases hold the port to the behaviour the JAX package's README
("Fleet sweeps") states. Then: the 14 built-in cases through
`run_fleet_batch` bitwise JAX's `run_fleet_batch`, and a two-host
`simhost` run in separate processes, each with a timeout.
"""

import errno
import json
import pathlib
import random
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from yuma_simulation_tpu.fabric import FleetConfig as JFleetConfig
from yuma_simulation_tpu.fabric import run_fleet_batch as j_run_fleet_batch
from yuma_simulation_tpu.scenarios import get_cases as j_get_cases
from yuma_simulation_tpu_torch.fabric import (
    FleetConfig,
    FleetStore,
    LeaseStore,
    build_fleet_report,
    check_fleet,
    merged_ledger,
    partition_lanes,
    publish_fleet_report,
    run_fleet_batch,
    run_fleet_grid,
)
from yuma_simulation_tpu_torch.resilience import (
    FaultPlan,
    LeaseTearFault,
    NaNFault,
    SweepSupervisor,
    inject_faults,
)
from yuma_simulation_tpu_torch.resilience.errors import LeaseExpired
from yuma_simulation_tpu_torch.scenarios import create_case, get_cases
from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

VERSION = "Yuma 1 (paper)"
REPO = pathlib.Path(__file__).resolve().parents[1]


def _fleet(directory, **kw):
    kw.setdefault("lease_ttl_seconds", 30.0)
    return FleetConfig(directory=directory, **kw)


# ------------------------------------------------------------- the lease


def test_claim_is_exclusive_and_released(tmp_path):
    a = LeaseStore(tmp_path, "hostA", ttl_seconds=30.0)
    b = LeaseStore(tmp_path, "hostB", ttl_seconds=30.0)
    claim = a.try_claim(0)
    assert claim is not None and claim.generation == 0
    assert b.try_claim(0) is None
    a.renew(0)
    a.release(0)
    assert not a.lease_path(0).exists()
    second = b.try_claim(0)
    assert second is not None and second.generation == 0


def test_expired_lease_is_stolen_with_generation_and_typed_abandon(tmp_path):
    dead = LeaseStore(tmp_path, "dead-host", ttl_seconds=0.1)
    assert dead.try_claim(0) is not None
    time.sleep(0.25)
    thief = LeaseStore(tmp_path, "thief", ttl_seconds=0.1)
    stolen = thief.try_claim(0)
    assert stolen is not None and stolen.generation == 1
    assert stolen.stolen_from == "dead-host"
    with pytest.raises(LeaseExpired) as exc:
        dead.renew(0)
    assert exc.value.unit == 0 and exc.value.holder == "thief"
    assert not dead.still_owner(0)
    assert thief.generation(0) == 1


def test_torn_lease_is_tolerated_and_stealable(tmp_path):
    holder = LeaseStore(tmp_path, "holder", ttl_seconds=60.0)
    assert holder.try_claim(0) is not None
    path = holder.lease_path(0)
    path.write_bytes(path.read_bytes()[:7])
    scanner = LeaseStore(tmp_path, "scanner", ttl_seconds=60.0)
    info = scanner.read(0)
    assert info is not None and info.torn
    assert scanner.is_stealable(info)
    stolen = scanner.try_claim(0)
    assert stolen is not None and stolen.generation == 1 and stolen.stolen_from == ""
    with pytest.raises(LeaseExpired):
        holder.renew(0)


def _race(tmp_path, trials, ttl, names, dead_first):
    for trial in range(trials):
        d = tmp_path / f"trial{trial}"
        if dead_first:
            assert LeaseStore(d, "dead-host", ttl_seconds=ttl).try_claim(0) is not None
            time.sleep(ttl + 0.2)
        winners, lock, barrier = [], threading.Lock(), threading.Barrier(2)

        def host(name, seed):
            rng = random.Random(seed)
            ls = LeaseStore(d, name, ttl_seconds=ttl)
            ls._pause = lambda stage: time.sleep(rng.random() * 0.005)
            barrier.wait()
            claim = ls.try_claim(0)
            if claim is not None:
                with lock:
                    winners.append((name, claim.generation))

        threads = [threading.Thread(target=host, args=(n, f"{trial}:{n}")) for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(winners) == 1, (trial, winners)
        yield d, winners[0]


def test_claim_race_exactly_one_winner_randomized_interleavings(tmp_path):
    for _ in _race(tmp_path, 20, 30.0, ("hostA", "hostB"), dead_first=False):
        pass


def test_steal_race_exactly_one_winner_randomized_interleavings(tmp_path):
    for d, (name, generation) in _race(tmp_path, 12, 0.3, ("thiefA", "thiefB"),
                                       dead_first=True):
        assert generation == 1
        info = LeaseStore(d, "observer", ttl_seconds=60.0).read(0)
        assert info is not None and not info.torn and info.host == name


def test_lease_tear_fault_tears_own_live_lease(tmp_path):
    ls = LeaseStore(tmp_path, "hostA", ttl_seconds=60.0)
    assert ls.try_claim(0) is not None
    with inject_faults(FaultPlan(lease_tear=LeaseTearFault(after_renewals=2))):
        ls.renew(0)
        assert not ls.read(0).torn
        ls.renew(0)  # the tear fires, once
        assert ls.read(0).torn
        ls.renew(0)  # the inode is unchanged: the holder still renews
        assert ls.read(0).torn


def test_host_crash_fault_sigkills_after_n_claims(tmp_path):
    code = (
        "from yuma_simulation_tpu_torch.resilience.faults import ("
        "FaultPlan, HostCrashFault, inject_faults, maybe_crash_host)\n"
        "with inject_faults(FaultPlan(host_crash=HostCrashFault(after_claims=2))):\n"
        "    maybe_crash_host(0)\n"
        "    print('survived-first-claim', flush=True)\n"
        "    maybe_crash_host(1)\n"
        "    print('NEVER-REACHED', flush=True)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert "survived-first-claim" in proc.stdout and "NEVER-REACHED" not in proc.stdout


# ------------------------------------------------------- publish_atomic


def test_publish_atomic_exdev_falls_back_to_copy_rename(tmp_path, monkeypatch):
    calls = {"exdev": 0}
    orig = pathlib.Path.replace

    def fake_replace(self, target):
        if calls["exdev"] == 0 and ".xdev." not in self.name:
            calls["exdev"] += 1
            raise OSError(errno.EXDEV, "Invalid cross-device link")
        return orig(self, target)

    monkeypatch.setattr(pathlib.Path, "replace", fake_replace)
    publish_atomic(tmp_path / "x.json", b'{"a": 1}')
    assert calls["exdev"] == 1
    assert (tmp_path / "x.json").read_bytes() == b'{"a": 1}'
    assert not list(tmp_path.glob("*.tmp"))


def test_publish_atomic_tmp_dir_staging(tmp_path):
    staging = tmp_path / "staging"
    staging.mkdir()
    target = tmp_path / "store" / "rec.json"
    target.parent.mkdir()
    publish_atomic(target, b'{"b": 2}', tmp_dir=staging)
    assert target.read_bytes() == b'{"b": 2}'
    assert not list(staging.iterdir())


def test_publish_atomic_unexpected_oserror_propagates(tmp_path, monkeypatch):
    def always_fail(self, target):
        raise OSError(errno.EACCES, "Permission denied")

    monkeypatch.setattr(pathlib.Path, "replace", always_fail)
    with pytest.raises(OSError) as exc:
        publish_atomic(tmp_path / "x.json", b"{}")
    assert exc.value.errno == errno.EACCES


# ------------------------------------------------------------- the store


def test_store_at_most_once_publish_and_corruption_requeue(tmp_path):
    store = FleetStore(tmp_path)
    store.ensure_manifest(num_units=2, unit_lanes=[(0, 1), (1, 2)], tag="t", config={"v": 1})
    first = np.arange(6.0).reshape(1, 2, 3)
    assert store.publish_result(0, {"dividends": first})
    assert not store.publish_result(0, {"dividends": np.zeros((1, 2, 3))})
    np.testing.assert_array_equal(store.load_result(0)["dividends"], first)
    path = store.result_path(0)
    path.write_bytes(path.read_bytes()[:20])
    assert not store.verify_result(0)
    assert 0 in store.pending_units()
    assert store.publish_result(0, {"dividends": first})
    assert store.verify_result(0)


def test_store_manifest_rejects_a_different_sweep(tmp_path):
    FleetStore(tmp_path).ensure_manifest(num_units=1, unit_lanes=[(0, 4)], tag="a",
                                         config={"v": 1})
    again = FleetStore(tmp_path)
    again.ensure_manifest(num_units=1, unit_lanes=[(0, 4)], tag="a", config={"v": 1})
    with pytest.raises(ValueError, match="different"):
        again.ensure_manifest(num_units=1, unit_lanes=[(0, 4)], tag="a", config={"v": 2})


def test_partition_lanes_matches_supervisor_rule():
    assert partition_lanes(7, 3) == [(0, 3), (3, 6), (6, 7)]
    with pytest.raises(ValueError, match="empty"):
        partition_lanes(0, 3)
    with pytest.raises(ValueError, match="unit_size"):
        partition_lanes(3, 0)


# --------------------------------------------------------- the scheduler


def test_fleet_batch_single_host_matches_supervised_run(tmp_path):
    cases = get_cases()[:4]
    clean = SweepSupervisor(directory=None, unit_size=2).run_batch(cases, VERSION,
                                                                   device="cpu")
    out = run_fleet_batch(cases, VERSION, _fleet(tmp_path, unit_size=2), device="cpu")
    report = out["report"]
    assert report.units_published == report.num_units == 2 and report.clean
    np.testing.assert_array_equal(out["dividends"], clean["dividends"])
    assert check_fleet(tmp_path) == []
    # The host's ops plane reads its own bundle.
    assert FleetStore(tmp_path).host_ids()


def test_fleet_two_hosts_share_the_grid_no_double_publish(tmp_path):
    cases = get_cases()[:4]
    clean = SweepSupervisor(directory=None, unit_size=1).run_batch(cases, VERSION,
                                                                   device="cpu")
    errors = []

    def host(host_id):
        try:
            run_fleet_batch(cases, VERSION,
                            _fleet(tmp_path, host_id=host_id, unit_size=1, poll_seconds=0.05,
                                   max_wait_seconds=240.0),
                            finalize=False, device="cpu")
        except BaseException as exc:  # noqa: BLE001 — surfaced below
            errors.append((host_id, exc))

    threads = [threading.Thread(target=host, args=(f"host{i}",)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not errors, errors
    store = FleetStore(tmp_path)
    report = publish_fleet_report(store)
    assert report.units_published == 4 and report.hosts_lost == ()
    ok_units = sorted(r["unit"] for r in merged_ledger(store) if r.get("event") == "unit_ok")
    assert ok_units == [0, 1, 2, 3]
    np.testing.assert_array_equal(store.collect("dividends"), np.asarray(clean["dividends"]))
    assert check_fleet(tmp_path) == []


def test_lease_expiry_steal_requeues_with_attempt_history(tmp_path):
    cases = get_cases()[:4]
    lanes = partition_lanes(len(cases), 2)
    store = FleetStore(tmp_path)
    store.ensure_manifest(
        num_units=len(lanes), unit_lanes=lanes, tag=f"fleet_batch:{VERSION}",
        config={"driver": "run_fleet_batch", "version": VERSION,
                "num_scenarios": len(cases), "unit_size": 2, "dtype": "float32"},
    )
    dead = LeaseStore(store.leases_dir, "doomed-host", ttl_seconds=0.2)
    assert dead.try_claim(0) is not None
    time.sleep(0.4)
    out = run_fleet_batch(cases, VERSION,
                          FleetConfig(directory=tmp_path, host_id="survivor", unit_size=2,
                                      lease_ttl_seconds=0.2, poll_seconds=0.05),
                          device="cpu")
    report = out["report"]
    assert report.units_published == 2 and report.units_stolen == 1
    records = merged_ledger(FleetStore(tmp_path))
    stolen = [r for r in records if r.get("event") == "unit_stolen"]
    assert len(stolen) == 1 and stolen[0]["unit"] == 0
    assert stolen[0]["prior_host"] == "doomed-host" and stolen[0]["generation"] == 1
    ok0 = [r for r in records if r.get("event") == "unit_ok" and r.get("unit") == 0]
    assert len(ok0) == 1 and ok0[0]["generation"] == 1
    assert LeaseStore(store.leases_dir, "observer").generation(0) == 1
    assert check_fleet(tmp_path) == []


def test_fleet_nan_lane_quarantines_globally_healthy_lanes_bitwise(tmp_path):
    cases = get_cases()[:4]
    clean = SweepSupervisor(directory=None, unit_size=2).run_batch(cases, VERSION,
                                                                   device="cpu")
    with inject_faults(FaultPlan(nan=NaNFault(epoch=2, case=1))):
        out = run_fleet_batch(cases, VERSION, _fleet(tmp_path, unit_size=2), device="cpu")
    report = out["report"]
    # Local lane 1 of each two-lane unit poisons global lanes 1 and 3.
    assert report.lanes_quarantined == 2
    assert out["quarantine"].quarantined_cases == (1, 3)
    for lane in (0, 2):
        np.testing.assert_array_equal(out["dividends"][lane], np.asarray(clean["dividends"])[lane])
    for lane in (1, 3):
        np.testing.assert_array_equal(out["dividends"][lane][:2],
                                      np.asarray(clean["dividends"])[lane][:2])
        assert (out["dividends"][lane][2:] == 0).all()
    assert np.isfinite(out["dividends"]).all()
    assert check_fleet(tmp_path) == []


def test_fleet_resume_is_pure_collection(tmp_path):
    cases = get_cases()[:4]
    first = run_fleet_batch(cases, VERSION, _fleet(tmp_path, unit_size=2), device="cpu")
    second = run_fleet_batch(cases, VERSION,
                             _fleet(tmp_path, host_id="late-joiner", unit_size=2),
                             device="cpu")
    np.testing.assert_array_equal(first["dividends"], second["dividends"])
    assert second["host"].units_published == 0
    ok = [r for r in merged_ledger(FleetStore(tmp_path)) if r.get("event") == "unit_ok"]
    assert len(ok) == 2


def test_check_fleet_flags_missing_result_and_tampered_report(tmp_path):
    run_fleet_batch(get_cases()[:4], VERSION, _fleet(tmp_path, unit_size=2), device="cpu")
    assert check_fleet(tmp_path) == []
    store = FleetStore(tmp_path)
    report_path = tmp_path / "fleet_report.json"
    data = json.loads(report_path.read_text())
    data["units_stolen"] = 7
    report_path.write_text(json.dumps(data))
    assert any("units_stolen" in p for p in check_fleet(tmp_path))
    publish_fleet_report(store)
    store.result_path(1).unlink()
    assert any("unit 1" in p and "verified" in p for p in check_fleet(tmp_path))


def test_fleet_report_derivation_is_pure(tmp_path):
    run_fleet_batch(get_cases()[:2], VERSION, _fleet(tmp_path, unit_size=2), device="cpu")
    assert build_fleet_report(tmp_path) == build_fleet_report(tmp_path)


# ------------------------------------------------------------ v1 surface


def test_run_simulation_fleet_knob_matches_plain(tmp_path):
    from yuma_simulation_tpu_torch.simulation.engine import run_simulation

    case = create_case("Case 2")
    plain = run_simulation(case, VERSION, device="cpu")
    fleet = run_simulation(case, VERSION, fleet=tmp_path, device="cpu")
    assert set(plain[0]) == set(fleet[0])
    for validator in plain[0]:
        np.testing.assert_array_equal(plain[0][validator], fleet[0][validator])
    np.testing.assert_array_equal(np.asarray(plain[1]), np.asarray(fleet[1]))
    np.testing.assert_array_equal(np.asarray(plain[2]), np.asarray(fleet[2]))
    again = run_simulation(case, VERSION, fleet=tmp_path, device="cpu")
    for validator in plain[0]:
        np.testing.assert_array_equal(fleet[0][validator], again[0][validator])
    ok = [r for r in merged_ledger(FleetStore(tmp_path)) if r.get("event") == "unit_ok"]
    assert len(ok) == 1


def test_dividends_cli_fleet_store_builds_each_sheet_once(tmp_path):
    from yuma_simulation_tpu_torch.cli.total_dividends_sheet_generator import main

    out1, out2, plain = tmp_path / "o1", tmp_path / "o2", tmp_path / "plain"
    store = tmp_path / "store"
    built = main(["--bond-penalty", "1.0", "--out-dir", str(out1), "--fleet-store", str(store),
                  "--device", "cpu"])
    assert list(built) == ["1.0"]
    csv_bytes = (out1 / "total_dividends_b1.0.csv").read_bytes()
    assert built == {"1.0": built["1.0"]} and csv_bytes.count(b"\n") == 15
    again = main(["--bond-penalty", "1.0", "--out-dir", str(out2), "--fleet-store", str(store),
                  "--device", "cpu"])
    assert again == {}  # pure collection: nothing built
    assert (out2 / "total_dividends_b1.0.csv").read_bytes() == csv_bytes
    main(["--bond-penalty", "1.0", "--out-dir", str(plain), "--device", "cpu"])
    assert (plain / "total_dividends_b1.0.csv").read_bytes() == csv_bytes
    ok = [r for r in merged_ledger(FleetStore(store)) if r.get("event") == "unit_ok"]
    assert len(ok) == 1
    assert check_fleet(store) == []


# --------------------------------------------------------- mesh plumbing


def test_surviving_members_is_the_shared_shrink_filter():
    from yuma_simulation_tpu_torch.parallel import surviving_members

    assert surviving_members(["h0", "h1", "h2"], ["h1"]) == ["h0", "h2"]

    class Dev:
        def __init__(self, i):
            self.id = i

    assert [d.id for d in surviving_members([Dev(0), Dev(1), Dev(2)], [1])] == [0, 2]


# --------------------------------------------------------- fleet grid


def test_run_fleet_grid_matches_supervised_grid_bitwise(tmp_path):
    from yuma_simulation_tpu_torch.simulation.sweep import config_grid

    case = get_cases()[0]
    axes = {"bond_penalty": [0.0, 0.5, 1.0], "kappa": [0.4, 0.5]}
    out = run_fleet_grid(case, VERSION, FleetConfig(directory=tmp_path, unit_size=4),
                         axes=axes, device="cpu")
    configs, points = config_grid(**{k: list(v) for k, v in sorted(axes.items())})
    ref = SweepSupervisor(directory=None, unit_size=4).run_grid(case, VERSION, configs,
                                                                device="cpu")
    assert out["points"] == points
    np.testing.assert_array_equal(np.asarray(out["dividends"]), np.asarray(ref["dividends"]))
    assert out["host"].units_published == 2 and out["report"].units_published == 2


def test_run_fleet_grid_second_invocation_is_pure_collection(tmp_path):
    case = get_cases()[0]
    axes = {"bond_penalty": [0.0, 1.0]}
    first = run_fleet_grid(case, VERSION, FleetConfig(directory=tmp_path, unit_size=1),
                           axes=axes, device="cpu")
    second = run_fleet_grid(case, VERSION,
                            FleetConfig(directory=tmp_path, unit_size=1, host_id="late-joiner"),
                            axes=axes, device="cpu")
    assert second["host"].units_published == 0
    np.testing.assert_array_equal(np.asarray(first["dividends"]), np.asarray(second["dividends"]))


def test_run_fleet_grid_requires_axes_or_configs(tmp_path):
    with pytest.raises(ValueError, match="axes"):
        run_fleet_grid(get_cases()[0], VERSION, tmp_path, device="cpu")


# ------------------------------------------------ the port against JAX's


def test_fleet_batch_builtin_suite_bitwise_jax(tmp_path):
    out = run_fleet_batch(get_cases(), VERSION, _fleet(tmp_path / "port", unit_size=5),
                          device="cpu")
    want = j_run_fleet_batch(j_get_cases(), VERSION,
                             JFleetConfig(directory=tmp_path / "jax", unit_size=5,
                                          lease_ttl_seconds=30.0))
    assert out["dividends"].shape == (14, 40, 3)
    np.testing.assert_array_equal(out["dividends"], np.asarray(want["dividends"]))
    assert out["report"].units_published == want["report"].units_published == 3
    # The foundry's fleet route over the same store is pure collection.
    from yuma_simulation_tpu_torch.foundry.montecarlo import run_montecarlo

    again = run_montecarlo(get_cases(), VERSION, route="fleet",
                           fleet=_fleet(tmp_path / "port", unit_size=5, host_id="late"),
                           device="cpu")
    np.testing.assert_array_equal(again["dividends"], out["dividends"])
    assert again["host"].units_published == 0


def test_two_simhosts_share_one_store(tmp_path):
    """Two `simhost` processes on the CPU split a 4-case sweep: every unit
    published exactly once, lanes bitwise the in-process supervised run,
    the fleet gate clean. Each child is bounded by a timeout."""
    import os

    store = tmp_path / "store"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in [str(REPO), env.get("PYTHONPATH", "")] if p)
    procs = []
    for host in ("h0", "h1"):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "yuma_simulation_tpu_torch.fabric.simhost",
             "--store", str(store), "--host-id", host, "--device", "cpu",
             "--num-cases", "4", "--unit-size", "1", "--ttl", "30", "--max-wait", "50"],
            env=env, cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    try:
        outs = [p.communicate(timeout=55) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "FLEET_HOST_DONE" in out
    fleet = FleetStore(store)
    report = publish_fleet_report(fleet)
    assert report.units_published == 4 and report.hosts_lost == ()
    ok_units = sorted(r["unit"] for r in merged_ledger(fleet) if r.get("event") == "unit_ok")
    assert ok_units == [0, 1, 2, 3]
    clean = SweepSupervisor(directory=None, unit_size=1).run_batch(get_cases()[:4], VERSION,
                                                                   device="cpu")
    np.testing.assert_array_equal(fleet.collect("dividends"), np.asarray(clean["dividends"]))
    assert check_fleet(store) == []

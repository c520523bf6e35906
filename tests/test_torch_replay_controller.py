"""The continuous replay controller of the port (`replay/controller.py`,
`replay/soak.py`'s writer injection, `replay/__main__.py`) on the CPU,
against the JAX package's.

The contracts of the JAX package's `tests/unit/test_replay_controller.py`,
each on the port: watermarks (monotone advance, torn tail, independent
pairs), window specs (round trip, typed corruption, in-flight reuse only
while the base matches), self-healing (corrupt-blob quarantine drained
past, stall demotion and recovery, backlog shedding by priority), and
randomized kill points between publication and the watermark advance
converging bitwise with every window published exactly once. Held against
JAX on the same archive: the watermark file's format both ways, the
window spec each controller plans, and the windows each controller
sweeps, watermark by watermark with bitwise baselines (the port's eager
rung against JAX's XLA rung; [E, 3, 4] is in ROADMAP §C's bitwise list).
The port's own: incremental windows bitwise a from-genesis build on the
controller's rung, a helper host joining an in-flight window, the
co-hosted controller thread of the serve CLI, and the CLI modes
(`--controller` in process, `--drill` as a subprocess) on ``--device
cpu``, raising without CUDA otherwise.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from yuma_simulation_tpu.replay.archive import SnapshotArchive as JSnapshotArchive
from yuma_simulation_tpu.replay.archive import synthetic_timeline as j_synthetic_timeline
from yuma_simulation_tpu.replay.controller import ControllerConfig as JControllerConfig
from yuma_simulation_tpu.replay.controller import ReplayController as JReplayController
from yuma_simulation_tpu.replay.controller import WatermarkStore as JWatermarkStore
from yuma_simulation_tpu.replay.statecache import StateCache as JStateCache
from yuma_simulation_tpu_torch.replay import (
    ArchiveError,
    ControllerConfig,
    ControllerError,
    ReplayController,
    SnapshotArchive,
    StateCache,
    WatermarkStore,
    WindowSpec,
    run_host,
    synthetic_timeline,
)
from yuma_simulation_tpu_torch.replay.archive import entries_fingerprint
from yuma_simulation_tpu_torch.replay.controller import CONTROLLER_ENGINE

VERSION = "Yuma 2 (Adrian-Fish)"
REPO = pathlib.Path(__file__).resolve().parents[1]

KNOBS = dict(
    versions=(VERSION,),
    epochs_per_snapshot=2,
    stride=2,
    unit_size=1,
    poll_seconds=0.01,
    slow_poll_seconds=0.0,
    stall_deadline_seconds=3600.0,
    freshness_budget_seconds=3600.0,
)


@pytest.fixture(autouse=True)
def _fresh_slo_engines():
    from yuma_simulation_tpu.telemetry import slo as jslo
    from yuma_simulation_tpu_torch.telemetry import slo

    slo.set_slo_engine(None)
    jslo.set_slo_engine(None)
    yield
    slo.set_slo_engine(None)
    jslo.set_slo_engine(None)


def make_controller(root, **overrides) -> ReplayController:
    knobs = dict(KNOBS, store_root=root / "store", device="cpu")
    knobs.update(overrides)
    return ReplayController(
        SnapshotArchive(root / "archive"), StateCache(root / "cache"), ControllerConfig(**knobs))


def make_jax_controller(root, **overrides):
    knobs = dict(KNOBS, store_root=root / "store")
    knobs.update(overrides)
    return JReplayController(
        JSnapshotArchive(root / "archive"), JStateCache(root / "cache"),
        JControllerConfig(**knobs))


def seed(root, netuid=0, snapshots=2, seed_=11, make=synthetic_timeline, cls=SnapshotArchive):
    return make(cls(root / "archive"), netuid, snapshots=snapshots, seed=seed_ + netuid * 1000,
                num_validators=3, num_miners=4)


# ------------------------------------------------------------ watermarks


def test_watermark_advance_is_strictly_monotone(tmp_path):
    marks = WatermarkStore(tmp_path)
    marks.advance(0, VERSION, block=1100, epochs=4, baseline_key="a")
    with pytest.raises(ControllerError, match="monotone"):
        marks.advance(0, VERSION, block=1100, epochs=8, baseline_key="b")
    marks.advance(0, VERSION, block=1200, epochs=8, baseline_key="b")
    assert marks.load(0, VERSION)["baseline_key"] == "b"
    assert marks.load(1, VERSION) is None and marks.load(0, "Yuma 1 (paper)") is None


def test_watermark_torn_tail_and_jax_format(tmp_path):
    """A torn tail resumes from the last valid record; the file is JAX's
    format both ways (the same path, records each package reads)."""
    marks = WatermarkStore(tmp_path)
    marks.advance(0, VERSION, block=1100, epochs=4, baseline_key="a")
    marks.advance(0, VERSION, block=1200, epochs=8, baseline_key="b")
    ref = JWatermarkStore(tmp_path)
    assert marks.path(0, VERSION) == ref.path(0, VERSION)
    with open(marks.path(0, VERSION), "ab") as f:
        f.write(b'{"netuid": 0, "block": 13')  # SIGKILL mid-write
    for store in (WatermarkStore(tmp_path), ref):
        wm = store.load(0, VERSION)
        assert wm["block"] == 1200 and wm["baseline_key"] == "b"
    ref.advance(0, VERSION, block=1300, epochs=12, baseline_key="c")
    assert WatermarkStore(tmp_path).load(0, VERSION)["baseline_key"] == "c"


# ------------------------------------------------------------ window specs


def test_window_spec_round_trip_and_corruption():
    spec = WindowSpec(netuid=3, version=VERSION, blocks=(1100, 1200), epochs_per_snapshot=2,
                      epoch_offset=4, prior_baseline_key="k", base_block=1000,
                      scenario_fingerprint="fp", store="/s")
    assert WindowSpec.from_json(spec.to_json()) == spec
    assert WindowSpec.from_json({**spec.to_json(), "base_block": None}).base_block is None
    with pytest.raises(ControllerError, match="corrupt window spec"):
        WindowSpec.from_json({"netuid": "x"})


def test_planned_window_spec_equals_jax(tmp_path):
    """On one archive (a corrupt blob included) both controllers plan the
    same window: blocks, offsets, fingerprint, and the store path under
    their own store roots. After a swept window they plan the same
    resumed suffix window."""
    entries = seed(tmp_path, snapshots=4)
    archive = SnapshotArchive(tmp_path / "archive")
    blob = archive._blob_path(0, entries[2].key)
    blob.write_bytes(blob.read_bytes()[:10])
    mine = make_controller(tmp_path, store_root=tmp_path / "store-port")
    ref = make_jax_controller(tmp_path, store_root=tmp_path / "store-jax")

    def planned(ctl, root):
        spec = ctl._plan_window(0, VERSION, ctl.archive.timeline(0))
        out = spec.to_json()
        out["store"] = str(pathlib.Path(out["store"]).relative_to(root))
        return out

    first = planned(mine, tmp_path / "store-port")
    assert first == planned(ref, tmp_path / "store-jax")
    assert first["blocks"] == [1000, 1100, 1300] and first["epoch_offset"] == 0
    seed(tmp_path, snapshots=4)
    mine.run_cycle()
    ref.run_cycle()
    synthetic_timeline(archive, 0, snapshots=6, seed=11, num_validators=3, num_miners=4)
    resumed = planned(mine, tmp_path / "store-port")
    jresumed = planned(ref, tmp_path / "store-jax")
    assert resumed["blocks"] == [1400, 1500] and resumed["epoch_offset"] == 6
    # The prior key names the rung each package pins: equal but for it.
    assert resumed.pop("prior_baseline_key") != jresumed.pop("prior_baseline_key")
    assert resumed == jresumed


def test_inflight_reused_only_while_base_matches(tmp_path):
    seed(tmp_path, snapshots=2)
    controller = make_controller(tmp_path)
    timeline = controller.archive.timeline(0)
    spec = controller._plan_window(0, VERSION, timeline)
    controller._pair_dir(0, VERSION).mkdir(parents=True, exist_ok=True)
    controller._inflight_path(0, VERSION).write_text(json.dumps(spec.to_json()))
    assert controller._plan_window(0, VERSION, timeline) == spec
    controller.watermarks.advance(0, VERSION, block=spec.blocks[0], epochs=2, baseline_key="")
    replanned = controller._plan_window(0, VERSION, timeline)
    assert replanned is not None and replanned != spec
    assert replanned.base_block == spec.blocks[0]


# ------------------------------------------------------------ self-healing


def test_corrupt_blob_quarantined_and_drained_past(tmp_path):
    entries = seed(tmp_path, snapshots=3)
    archive = SnapshotArchive(tmp_path / "archive")
    blob = archive._blob_path(0, entries[1].key)
    blob.write_bytes(blob.read_bytes()[:10])  # torn mid-write
    controller = make_controller(tmp_path)
    report = controller.run_cycle()
    assert report.snapshots_quarantined == 1
    quarantined = controller.ledger.entries("subnet_quarantined")
    assert [(r["netuid"], r["block"]) for r in quarantined] == [(0, entries[1].block)]
    wm = controller.watermarks.load(0, VERSION)
    assert wm["block"] == entries[-1].block and wm["epochs"] == 2 * 2
    again = make_controller(tmp_path)
    assert (0, entries[1].block) in again._quarantined


def test_stall_demotes_then_recovers(tmp_path):
    seed(tmp_path, snapshots=2)
    controller = make_controller(tmp_path, stall_deadline_seconds=0.05)
    controller.run_cycle()
    time.sleep(0.1)
    report = controller.run_cycle()
    assert report.subnets_stalled == 1 and 0 in controller._stalled
    events = controller.ledger.entries("subnet_stalled")
    assert len(events) == 1 and events[0]["netuid"] == 0
    seed(tmp_path, snapshots=3)
    report = controller.run_cycle()
    assert 0 not in controller._stalled and report.subnets_stalled == 0


def test_backlog_sheds_lowest_priority(tmp_path):
    seed(tmp_path, netuid=0)
    seed(tmp_path, netuid=1)
    controller = make_controller(tmp_path, max_windows_per_cycle=1, priorities={1: 10})
    report = controller.run_cycle()
    assert report.windows_swept == 1 and report.windows_shed == 1
    assert [s[0] for s in report.swept] == [1]
    assert controller.watermarks.load(0, VERSION) is None
    report = controller.run_cycle()
    assert [s[0] for s in report.swept] == [0] and report.windows_shed == 0


def test_torn_blob_injection_is_detected(tmp_path):
    """The soak writer's corruption injection publishes an entry whose blob
    cannot verify, and idempotent re-appends never heal it."""
    from yuma_simulation_tpu_torch.foundry.metagraph import synthetic_snapshot
    from yuma_simulation_tpu_torch.replay.soak import _append_torn

    archive = SnapshotArchive(tmp_path / "archive")
    synthetic_timeline(archive, 0, snapshots=2, seed=11, num_validators=3, num_miners=4)
    snap = synthetic_snapshot(13, num_validators=3, num_miners=4, netuid=0, block=1200)
    _append_torn(archive, snap)
    for _ in range(2):
        with pytest.raises(ArchiveError, match="corruption"):
            archive.load(0, 1200)
        archive.append(snap)
    assert [e.block for e in archive.entries_after(0, 1000)] == [1100, 1200]
    assert archive.entries_after(0, 1200) == []


@pytest.mark.parametrize("seed", [0, 7])
def test_writer_timelines_equal_jax(tmp_path, capsys, seed):
    """The soak writer (which draws only the snapshots a timeline lacks)
    leaves every subnet's timeline entry for entry JAX's writer's (which
    draws the whole prefix every round), the torn entry and the stalled
    feed included, and a rerun over its own archive changes nothing."""
    from yuma_simulation_tpu.replay.soak import run_writer as j_run_writer
    from yuma_simulation_tpu_torch.replay.soak import run_writer

    def args(root):
        return argparse.Namespace(
            archive=str(root), subnets=3, rounds=6, interval=0.0, stall_netuid=2,
            stall_after=4, corrupt_netuid=1, corrupt_round=5, seed=seed,
            validators=3, miners=4,
        )

    def timelines(root, cls):
        archive = cls(root)
        return {n: [e.to_json() for e in archive.timeline(n)] for n in range(3)}

    for root, cls, make in ((tmp_path / "mine", SnapshotArchive, synthetic_timeline),
                            (tmp_path / "jax", JSnapshotArchive, j_synthetic_timeline)):
        for n in range(3):
            make(cls(root), n, snapshots=2, seed=seed + n * 1000, num_validators=3,
                 num_miners=4)
    assert run_writer(args(tmp_path / "mine")) == 0
    assert j_run_writer(args(tmp_path / "jax")) == 0
    mine = timelines(tmp_path / "mine", SnapshotArchive)
    assert mine == timelines(tmp_path / "jax", JSnapshotArchive)
    assert [len(mine[n]) for n in range(3)] == [6, 6, 4]
    assert run_writer(args(tmp_path / "mine")) == 0
    assert timelines(tmp_path / "mine", SnapshotArchive) == mine
    capsys.readouterr()


# ------------------------------------------------------------ kill points


class Boom(RuntimeError):
    pass


def drain(root, *, factory=make_controller, rng=None, kill_p=0.0, max_cycles=40) -> int:
    """Cycle a (fresh-per-crash) controller until a cycle sweeps nothing;
    with `rng`, the post-publish point raises with probability `kill_p`
    and the controller is rebuilt cold. Returns the number of kills."""
    kills = 0

    def fresh():
        controller = factory(root)
        if rng is not None:
            def maybe_boom(netuid, version):
                if rng.random() < kill_p:
                    raise Boom()

            controller.test_hooks["post_publish"] = maybe_boom
        return controller

    controller = fresh()
    for _ in range(max_cycles):
        try:
            report = controller.run_cycle()
        except Boom:
            kills += 1
            controller = fresh()
            continue
        if report.windows_swept == 0:
            return kills
    raise AssertionError(f"did not drain in {max_cycles} cycles")


@pytest.mark.parametrize("seed_", [0, 1, 2])
def test_randomized_kill_points_converge_bitwise(tmp_path, seed_):
    """Interrupted between window publication and watermark advance at
    randomized sweeps and restarted cold each time, the controller
    converges to bitwise an uninterrupted run's baselines, every window
    published exactly once and the watermark history strictly monotone."""
    rng = np.random.default_rng(seed_)
    control_dir, chaos_dir = tmp_path / "control", tmp_path / "chaos"
    kills = 0
    for phase_snapshots in (2, 3, 4):
        seed(control_dir, snapshots=phase_snapshots)
        seed(chaos_dir, snapshots=phase_snapshots)
        drain(control_dir)
        kills += drain(chaos_dir, rng=rng, kill_p=0.6)
    control, chaos = make_controller(control_dir), make_controller(chaos_dir)
    wm_control = control.watermarks.load(0, VERSION)
    wm_chaos = chaos.watermarks.load(0, VERSION)
    for key in ("block", "epochs", "baseline_key"):
        assert wm_chaos[key] == wm_control[key], key
    np.testing.assert_array_equal(
        chaos.cache.load_baseline(wm_chaos["baseline_key"])["dividends"],
        control.cache.load_baseline(wm_control["baseline_key"])["dividends"])
    spans = [(r["block_from"], r["block_to"]) for r in chaos.ledger.entries("window_swept")]
    assert len(spans) == len(set(spans))
    history = [r["block"] for r in chaos.watermarks.history(0, VERSION)
               if isinstance(r.get("block"), int)]
    assert history == sorted(set(history))
    assert kills >= 1


# ------------------------------------------------------------ against JAX


def test_controller_windows_equal_jax(tmp_path):
    """The same growing archive (two subnets, appended in three phases)
    drained by both controllers: the same windows swept in the same
    order, the same watermark blocks and epochs after every phase, and
    each pair's extended baseline bitwise JAX's."""
    port, ref = tmp_path / "port", tmp_path / "jax"
    sweeps = {}
    for phase_snapshots in (2, 3, 5):
        for netuid in (0, 1):
            seed(port, netuid=netuid, snapshots=phase_snapshots)
            seed(ref, netuid=netuid, snapshots=phase_snapshots, make=j_synthetic_timeline,
                 cls=JSnapshotArchive)
        drain(port)
        drain(ref, factory=make_jax_controller)
        mine, theirs = make_controller(port), make_jax_controller(ref)
        for netuid in (0, 1):
            a = mine.watermarks.load(netuid, VERSION)
            b = theirs.watermarks.load(netuid, VERSION)
            assert (a["block"], a["epochs"]) == (b["block"], b["epochs"]), netuid
            np.testing.assert_array_equal(
                mine.cache.load_baseline(a["baseline_key"])["dividends"],
                np.asarray(theirs.cache.load_baseline(b["baseline_key"])["dividends"]))
            assert mine.cache.meta(a["baseline_key"]).engine == "eager"
            assert theirs.cache.meta(b["baseline_key"]).engine == "xla"
        for name, ctl in (("port", mine), ("jax", theirs)):
            sweeps[name] = [(r["netuid"], r["block_from"], r["block_to"], r["resumed"])
                            for r in ctl.ledger.entries("window_swept")]
        assert sweeps["port"] == sweeps["jax"]
    assert sum(1 for s in sweeps["port"] if s[3]) == 4


def test_incremental_windows_bitwise_from_genesis(tmp_path):
    """Every watermark's baseline, extended window by window, is bitwise
    (and keyed as) a from-scratch build of its timeline on the
    controller's rung, and the fleet units' rows are its rows."""
    for phase_snapshots in (2, 4, 5):
        seed(tmp_path, snapshots=phase_snapshots)
        drain(tmp_path)
    controller = make_controller(tmp_path)
    wm = controller.watermarks.load(0, VERSION)
    assert wm["epochs"] == 10
    entries = controller.archive.timeline(0)
    scenario = controller.archive.scenario_for_blocks(0, [e.block for e in entries],
                                                      epochs_per_snapshot=2)
    verify = StateCache(tmp_path / "verify")
    meta = verify.build_baseline(scenario, VERSION, scenario_fingerprint=entries_fingerprint(
        entries), stride=2, engine=CONTROLLER_ENGINE, device="cpu")
    assert meta.key == wm["baseline_key"]
    np.testing.assert_array_equal(controller.cache.load_baseline(wm["baseline_key"])["dividends"],
                                  verify.load_baseline(meta.key)["dividends"])
    swept = controller.ledger.entries("window_swept")
    assert [r["resumed"] for r in swept] == [False, True, True]


def test_helper_host_joins_an_inflight_window(tmp_path):
    """`run_host` reconstructs a pinned window from the shared archive and
    cache and publishes its units, writing the store's manifest first;
    the controller's sweep of the same window verifies that manifest (the
    host passes the controller's tag: JAX's host passes its own, and a
    controller that arrives second refuses the store) and finds the unit
    published."""
    from yuma_simulation_tpu_torch.fabric import FleetStore
    from yuma_simulation_tpu_torch.fabric.health import merged_ledger
    from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

    seed(tmp_path, snapshots=2)
    drain(tmp_path)
    seed(tmp_path, snapshots=3)
    controller = make_controller(tmp_path)
    spec = controller._plan_window(0, VERSION, controller.archive.timeline(0))
    assert spec.prior_baseline_key and spec.epoch_offset == 4
    controller._pair_dir(0, VERSION).mkdir(parents=True, exist_ok=True)
    publish_atomic(controller._inflight_path(0, VERSION),
                   json.dumps(spec.to_json()).encode())
    polls = iter(range(3))
    joined = run_host(controller.archive, controller.cache, tmp_path / "store",
                      poll_seconds=0.0, unit_size=1, stop=lambda: next(polls) >= 1,
                      device="cpu")
    assert joined == 1
    out = controller.sweep_window(spec)
    assert out["total_epochs"] == 6
    ok = [r for r in merged_ledger(FleetStore(spec.store)) if r.get("event") == "unit_ok"]
    assert len(ok) == 1


# ------------------------------------------------------------ processes and CLIs


def test_cohosted_controller_thread_sweeps(tmp_path):
    """The serve CLI's `--replay-controller` thread sweeps the mounted
    archive into its store on the service's device, under its own name."""
    import threading

    import torch

    from yuma_simulation_tpu_torch.serve.__main__ import CONTROLLER_THREAD, start_replay_controller

    seed(tmp_path, snapshots=2)
    args = argparse.Namespace(
        replay_archive=str(tmp_path / "archive"), replay_cache=str(tmp_path / "cache"),
        replay_controller=str(tmp_path / "store"), replay_versions=[VERSION],
        replay_epochs_per_snapshot=2, replay_stride=2)
    stop = start_replay_controller(args, torch.device("cpu"))
    try:
        assert CONTROLLER_THREAD in {t.name for t in threading.enumerate()}
        marks = WatermarkStore(tmp_path / "store" / "watermarks")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and marks.load(0, VERSION) is None:
            time.sleep(0.05)
        assert marks.load(0, VERSION)["epochs"] == 4
    finally:
        stop.set()


def test_controller_cli_mode_and_device(tmp_path, monkeypatch, capsys):
    """`--controller --cycles 1 --device cpu` sweeps one cycle and prints
    its line; every mode raises without CUDA when the card is asked for
    (the default)."""
    import torch

    from yuma_simulation_tpu_torch.replay.__main__ import main

    seed(tmp_path, snapshots=2)
    dirs = ["--archive", str(tmp_path / "archive"), "--cache", str(tmp_path / "cache"),
            "--store", str(tmp_path / "store")]
    assert main(["--controller", *dirs, "--versions", VERSION, "--epochs-per-snapshot", "2",
                 "--stride", "2", "--unit-size", "1", "--poll", "0", "--cycles", "1",
                 "--device", "cpu"]) == 0
    assert "cycle=1 swept=1 shed=0" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in (["--controller", *dirs], ["--host", *dirs], ["--writer", "--archive", "a"],
                 ["--drill", "--bundle-dir", str(tmp_path / "d")],
                 ["--soak", "--bundle-dir", str(tmp_path / "s")]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(mode)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReplayController(SnapshotArchive(tmp_path / "archive"), StateCache(tmp_path / "cache"),
                         ControllerConfig(store_root=tmp_path / "store2"))


def test_replay_drill_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    done = subprocess.run(
        [sys.executable, "-m", "yuma_simulation_tpu_torch.replay", "--drill", "--device", "cpu",
         "--bundle-dir", str(tmp_path / "drill")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=90)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    assert "replay drill passed" in done.stdout and "FAIL" not in done.stdout
    summary = json.loads((tmp_path / "drill" / "drill_summary.json").read_text())
    assert summary["failures"] == [] and len(summary["stores"]) == 2

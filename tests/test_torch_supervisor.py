"""The port's supervised sweep — `resilience/supervisor.py`,
`utils/checkpoint.py::CheckpointedSweep` and `telemetry/flight.py` —
against the JAX package on the CPU.

Contracts: a supervised run's lanes are bitwise an unsupervised run's,
through a killed run resumed from its checkpoint directory and a torn
chunk requeued; the port's flight bundle passes the JAX package's
`check_bundle` and `tools/obsreport`, `tools/sloreport` and
`tools/driftreport` unchanged; a checkpoint directory written by either
package resumes in the other; the numerics canary localizes a one-ulp
`DriftFault` to its lane, epoch and ulp.
"""

import json

import numpy as np
import pytest

from tools import driftreport, obsreport, sloreport
from yuma_simulation_tpu.telemetry.flight import check_bundle as j_check_bundle
from yuma_simulation_tpu.telemetry.flight import load_bundle as j_load_bundle
from yuma_simulation_tpu.utils.checkpoint import CheckpointedSweep as JCheckpointedSweep
from yuma_simulation_tpu_torch.models.config import YumaConfig
from yuma_simulation_tpu_torch.models.variants import variant_for_version
from yuma_simulation_tpu_torch.parallel import make_mesh
from yuma_simulation_tpu_torch.resilience import (
    Deadline,
    DeviceLossFault,
    DriftFault,
    FaultPlan,
    RetryPolicy,
    StallFault,
    SweepSupervisor,
    inject_faults,
)
from yuma_simulation_tpu_torch.resilience import supervisor as tsupervisor
from yuma_simulation_tpu_torch.scenarios import create_case, get_cases
from yuma_simulation_tpu_torch.simulation.sweep import (
    config_grid,
    simulate_batch,
    stack_scenarios,
    sweep_hyperparams,
)
from yuma_simulation_tpu_torch.telemetry.flight import FlightRecorder, check_bundle, load_bundle
from yuma_simulation_tpu_torch.telemetry.slo import set_slo_engine
from yuma_simulation_tpu_torch.utils.checkpoint import CheckpointedSweep

VERSION = "Yuma 2 (Adrian-Fish)"
POLICY = RetryPolicy(backoff_base=0.0, seed=0)


def _suite():
    """Ten built-in cases; case 6's weights turn NaN from epoch 3 (Yuma 2
    carries them into `w_prev`, which the quarantine catches)."""
    cases = get_cases()[:10]
    bad = cases[6]
    W = bad.weights.copy()
    W[3:, 0, 1] = np.nan
    cases[6] = type(bad)(**{**bad.__dict__, "weights": W})
    return cases


def _plain(cases):
    W, S, ri, re_ = stack_scenarios(cases, device="cpu")
    return simulate_batch(W, S, ri, re_, YumaConfig(), variant_for_version(VERSION),
                          quarantine=True)["dividends"].numpy()


def _supervisor(directory, **kw):
    return SweepSupervisor(directory=directory, unit_size=4, deadline=Deadline(60.0),
                           retry_policy=POLICY, **kw)


@pytest.fixture(autouse=True)
def fresh_slo_engine():
    """Each test's SLO burn state starts clean (the engine is process-wide,
    and a drift drill fast-burns the `engine_drift` objective)."""
    previous = set_slo_engine(None)
    yield
    set_slo_engine(previous)


def _gates(directory, slo_check=0, drift_check=0):
    """The JAX package's bundle checks and the three report tools."""
    assert j_check_bundle(j_load_bundle(directory)) == []
    assert check_bundle(load_bundle(directory)) == []
    assert obsreport.main([str(directory), "--check"]) == 0
    assert sloreport.main([str(directory), "--check", "--require"]) == slo_check
    assert driftreport.main([str(directory), "--check", "--require"]) == drift_check


def test_run_batch_killed_resumed_and_torn_chunk_requeued(tmp_path, monkeypatch):
    """Unit 2 of three dies with an unclassified error: the run raises,
    units 0 and 1 stay on disk, and the bundle of the failed run passes
    the gates. The resumed run reads them from disk, runs unit 2 once
    more after its chunk is torn, and returns the unsupervised lanes
    bitwise, with the NaN lane's quarantine carried over from the ledger."""
    cases = _suite()
    real = tsupervisor._batch_on_rung
    calls = []

    def dies_on_unit_2(W, *args, **kw):
        calls.append(W.shape[0])
        if len(calls) == 3:
            raise RuntimeError("simulated kill")
        return real(W, *args, **kw)

    monkeypatch.setattr(tsupervisor, "_batch_on_rung", dies_on_unit_2)
    with pytest.raises(RuntimeError, match="simulated kill"):
        _supervisor(tmp_path, canary_fraction=0.0).run_batch(cases, VERSION, device="cpu")
    assert sorted(p.name for p in tmp_path.glob("chunk_*.npz")) == [
        "chunk_00000.npz", "chunk_00001.npz"]
    assert j_check_bundle(j_load_bundle(tmp_path)) == []
    monkeypatch.setattr(tsupervisor, "_batch_on_rung", real)

    with inject_faults(FaultPlan(truncate_chunks={2: 10})):
        out = _supervisor(tmp_path, canary_fraction=1.0).run_batch(cases, VERSION,
                                                                    device="cpu")
    report = out["report"]
    assert (report.units_total, report.units_resumed, report.units_requeued) == (3, 2, 1)
    assert report.lanes_quarantined == 1 and report.engines_used == ("eager",)
    assert [(e.case, e.epoch, e.tensor) for e in out["quarantine"].entries] == [
        (6, 3, "w_prev")]
    np.testing.assert_array_equal(out["dividends"], _plain(cases))
    _gates(tmp_path)
    ledger = [json.loads(x) for x in (tmp_path / "ledger.jsonl").read_text().splitlines()]
    assert [r["event"] for r in ledger].count("unit_failed") == 1
    assert {r["unit"] for r in ledger if r["event"] == "unit_requeued"} == {2}


def test_run_grid_resumes_every_unit_from_disk(tmp_path, monkeypatch):
    """A grid sweep with a checkpoint directory: lanes bitwise
    `sweep_hyperparams`; run again, every unit comes from disk and nothing
    dispatches."""
    cfg, _ = config_grid(bond_alpha=[0.05, 0.1], kappa=[0.5, 0.6])
    scen = create_case("Case 3")
    sup = _supervisor(tmp_path, quarantine=False)
    first = sup.run_grid(scen, "Yuma 1 (paper)", cfg, device="cpu")
    ref = sweep_hyperparams(scen, "Yuma 1 (paper)", cfg, device="cpu", epoch_impl="eager")
    np.testing.assert_array_equal(first["dividends"], ref["dividends"].numpy())

    def never(*args, **kw):
        raise AssertionError("a resumed unit dispatched")

    monkeypatch.setattr(tsupervisor, "_grid_on_eager", never)
    again = sup.run_grid(scen, "Yuma 1 (paper)", cfg, device="cpu")
    assert again["report"].units_resumed == 1 and again["report"].engines_used == ("resumed",)
    np.testing.assert_array_equal(again["dividends"], first["dividends"])
    _gates(tmp_path)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_directory_resumes_across_packages(tmp_path, writer):
    """The same `manifest.json` / `checksums.json` / `chunk_*.npz` layout:
    a directory one package wrote resumes in the other without running a
    chunk, and a chunk torn on disk is requeued by the reader."""
    chunks = [np.arange(6, dtype=np.float32).reshape(2, 3) + i for i in range(3)]
    config = {"driver": "test", "version": VERSION}
    write, read = ((CheckpointedSweep, JCheckpointedSweep) if writer == "port"
                   else (JCheckpointedSweep, CheckpointedSweep))
    done = write(tmp_path, num_chunks=3, tag="x", config=config).run(lambda i: chunks[i])

    def never(i):
        raise AssertionError(f"chunk {i} ran again")

    np.testing.assert_array_equal(read(tmp_path, num_chunks=3, tag="x", config=config)
                                  .run(never), done)
    path = tmp_path / "chunk_00001.npz"
    path.write_bytes(path.read_bytes()[:10])
    reran = []
    back = read(tmp_path, num_chunks=3, tag="x", config=config).run(
        lambda i: reran.append(i) or chunks[i])
    assert reran == [1]
    np.testing.assert_array_equal(back, done)
    with pytest.raises(ValueError, match="different sweep"):
        read(tmp_path, num_chunks=3, tag="x", config={"other": 1})


def test_canary_localizes_a_drift_fault(tmp_path):
    """A one-ulp `DriftFault` inside the canary re-executions: one
    `engine_drift` record per unit on the dividends stream, at lane 0 of
    the unit, epoch 2, one ulp; the bundle stays sound and driftreport's
    gate fails on it. Without the fault the same canaries reproduce the
    primary bitwise and every gate passes."""
    cases = get_cases()[:4]
    sup = SweepSupervisor(directory=tmp_path, unit_size=2, deadline=None, retry_policy=POLICY,
                          canary_fraction=1.0)
    with inject_faults(FaultPlan(drift=DriftFault(epoch=2, case=0))):
        out = sup.run_batch(cases, "Yuma 1 (paper)", device="cpu")
    assert (out["report"].canaries_run, out["report"].drift_events) == (2, 2)
    ledger = [json.loads(x) for x in (tmp_path / "ledger.jsonl").read_text().splitlines()]
    drifts = [r for r in ledger if r["event"] == "engine_drift"]
    assert [(r["unit"], r["stream"], r["lanes"]) for r in drifts] == [
        (0, "dividends", [[0, 2, 1]]), (1, "dividends", [[2, 2, 1]])]
    # The drift fast-burns the engine_drift objective: both gates fail.
    _gates(tmp_path, slo_check=2, drift_check=1)
    set_slo_engine(None)
    clean = SweepSupervisor(directory=tmp_path / "clean", unit_size=2, deadline=None,
                            retry_policy=POLICY, canary_fraction=1.0)
    out = clean.run_batch(cases, "Yuma 1 (paper)", device="cpu")
    assert (out["report"].canaries_run, out["report"].drift_events) == (2, 0)
    _gates(tmp_path / "clean")


def test_stall_and_device_loss_units(tmp_path):
    """A stalled unit retried under its deadline, and sharded units over
    four CPU devices with device 1 lost: the report and the ledger agree
    (the bundle gates), every unit's numerics are captured, and the lanes
    are the unsupervised run's."""
    cases = get_cases()[:2]
    # One case a unit: a real dispatch ends well inside the 0.4 s budget,
    # the injected 0.5 s hold does not.
    sup = SweepSupervisor(directory=tmp_path, unit_size=1, quarantine=False,
                          deadline=Deadline(0.4, grace_seconds=30.0), retry_policy=POLICY)
    with inject_faults(FaultPlan(stall=StallFault(seconds=0.5, dispatches=1))):
        out = sup.run_batch(cases, "Yuma 1 (paper)", device="cpu")
    assert out["report"].stalls_killed == 1 and not out["report"].clean
    W, S, ri, re_ = stack_scenarios(cases, device="cpu")
    ref = simulate_batch(W, S, ri, re_, YumaConfig(),
                         variant_for_version("Yuma 1 (paper)"))["dividends"].numpy()
    np.testing.assert_array_equal(out["dividends"], ref)
    _gates(tmp_path)
    cases = get_cases()[:6]
    W, S, ri, re_ = stack_scenarios(cases, device="cpu")
    ref = simulate_batch(W, S, ri, re_, YumaConfig(),
                         variant_for_version("Yuma 1 (paper)"))["dividends"].numpy()
    sharded = SweepSupervisor(directory=tmp_path / "mesh", unit_size=3, deadline=Deadline(60.0),
                              retry_policy=POLICY)
    with inject_faults(FaultPlan(device_loss=DeviceLossFault(device_id=1))):
        out = sharded.run_batch(cases, "Yuma 1 (paper)", mesh=make_mesh(devices=["cpu"] * 4),
                                device="cpu")
    # Each unit starts on the full mesh and loses device 1 once.
    assert out["report"].mesh_shrinks == 2 and out["report"].engines_used == ("sharded",)
    np.testing.assert_array_equal(out["dividends"], ref)
    assert len(out["numerics_records"]) == 4  # two streams, two units
    _gates(tmp_path / "mesh")


def test_unported_options_raise(tmp_path):
    """A fused start under quarantine raises, and so does a negative
    profiling cadence. The options of the slices ported since no longer
    raise: `capture_costs=True` is accepted and `record_costs([])`
    publishes an empty ``costs.jsonl`` (tests/test_torch_cost.py drives
    both); `profile_every=2` is accepted (tests/test_torch_ops_plane.py
    drives it)."""
    assert SweepSupervisor(capture_costs=True).capture_costs
    assert SweepSupervisor(profile_every=2).profile_every == 2
    with pytest.raises(ValueError, match="profile_every must be >= 0"):
        SweepSupervisor(profile_every=-1)
    FlightRecorder(tmp_path).record_costs([])
    assert (tmp_path / "costs.jsonl").read_text() == ""
    with pytest.raises(ValueError, match="quarantine rides"):
        SweepSupervisor(engine="fused_varying")
    assert SweepSupervisor(engine="xla").engine == "eager"

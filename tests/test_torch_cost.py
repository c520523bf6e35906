"""The cost half of `telemetry/cost.py` against the JAX package's, on the
CPU: the record's fields, the work model, the roofline's arithmetic, the
plan's `attach_cost` and the supervisor's cost capture into the flight
bundle.

Contracts: `CostRecord.to_json()` has the JAX package's keys and `roofline`
is JAX's arithmetic bit for bit on the same record and spec. The port's
records count the rung's work from the shape over every epoch (JAX's count
a scan body once, so no test compares flops across the packages): the same
for every rung at a shape, flops linear in epochs, bytes affine in them,
and at 256 x 4096 x 64 the roofline of the varying scan is the bound
`chip_smoke.py` prints for K3 (0.0814 ms, by bytes).
"""

import dataclasses

import jax  # noqa: F401  (the JAX package's conftest configures it)
import numpy as np
import pytest
import torch

from yuma_simulation_tpu.models.config import YumaConfig as JConfig
from yuma_simulation_tpu.telemetry import cost as jcost
from yuma_simulation_tpu.telemetry import flight as jflight
from yuma_simulation_tpu_torch.models.config import YumaConfig, YumaParams
from yuma_simulation_tpu_torch.ops._build import library_digest
from yuma_simulation_tpu_torch.resilience import SweepSupervisor
from yuma_simulation_tpu_torch.scenarios import get_cases
from yuma_simulation_tpu_torch.simulation.planner import (
    ENGINE_LADDER,
    plan_dispatch,
    scan_scratch_bytes,
)
from yuma_simulation_tpu_torch.telemetry import FlightRecorder, check_bundle, load_bundle
from yuma_simulation_tpu_torch.telemetry import cost as tcost

H100 = tcost.DeviceSpec("NVIDIA H100", tcost.PEAK_OPS_PER_S, tcost.PEAK_BYTES_PER_S, 80 * 2**30)


def test_record_fields_and_rungs_equal_jax():
    names = [f.name for f in dataclasses.fields(tcost.CostRecord)]
    assert names == [f.name for f in dataclasses.fields(jcost.CostRecord)]
    assert list(tcost.capture_engine_cost("eager", 4, 8, 2).to_json()) == names
    assert [f.name for f in dataclasses.fields(tcost.Roofline)] == [
        f.name for f in dataclasses.fields(jcost.Roofline)]
    assert tcost.ENGINE_RUNGS == jcost.ENGINE_RUNGS[:-1] + ("eager",) == ENGINE_LADDER


@pytest.mark.parametrize("V,M,E", [(3, 2, 40), (8, 128, 16), (256, 4096, 64)])
def test_every_rung_counts_the_same_work(V, M, E):
    recs = tcost.capture_engine_costs(V, M, E)
    assert list(recs) == list(tcost.ENGINE_RUNGS)
    work = {(r.flops, r.bytes_accessed, r.transcendentals, r.argument_bytes,
             r.output_bytes) for r in recs.values()}
    assert len(work) == 1
    cells = E * V * M
    rec = recs["fused_varying"]
    assert rec.flops == cells * (tcost.BISECT_OPS + tcost.ELEMENTWISE_OPS)
    assert rec.bytes_accessed == 4 * (cells + 2 * E * V + V * M)
    assert rec.flops_per_epoch == V * M * 52 and rec.transcendentals == 0.0
    for engine, r in recs.items():
        fused = engine != "eager"
        est = tcost.estimate_hbm_bytes(
            V, M, resident_epochs=E, scratch_bytes=scan_scratch_bytes(engine, V, M))
        assert r.peak_bytes == est.total_bytes and r.peak_bytes_source == "estimate_hbm_bytes"
        assert r.temp_bytes == est.breakdown["working_set"] + est.breakdown.get("scan_scratch", 0)
        assert r.hlo_fingerprint == (library_digest("case_scan.cu") if fused else None)
        assert r.reason and (r.generated_code_bytes is None)
        assert (r.engine, r.V, r.M, r.epochs, r.backend) == (engine, V, M, E, "cpu")


def test_work_is_linear_in_epochs_and_follows_the_options():
    one, two, three = (tcost.capture_engine_cost("fused_scan", 16, 32, e) for e in (5, 10, 15))
    assert two.flops == 2 * one.flops and three.flops == 3 * one.flops
    assert two.bytes_accessed - one.bytes_accessed == three.bytes_accessed - two.bytes_accessed
    saved = tcost.capture_engine_cost("fused_scan", 16, 32, 5, save_bonds=True,
                                      save_incentives=True)
    assert saved.bytes_accessed == one.bytes_accessed + 4 * (5 * 16 * 32 + 5 * 32)
    liquid = YumaConfig(yuma_params=YumaParams(liquid_alpha=True))
    assert tcost.capture_engine_cost("eager", 16, 32, 5, config=liquid).transcendentals == 5 * 16 * 32
    assert tcost.capture_engine_cost("xla", 16, 32, 5).engine == "eager"
    assert tcost.capture_engine_cost("eager", 4, 4, 2, dtype=torch.float64).bytes_accessed == (
        8 * (2 * 16 + 2 * 2 * 4 + 16))
    with pytest.raises(ValueError, match="unknown engine"):
        tcost.capture_engine_cost("pallas", 4, 4, 2)
    with pytest.raises(ValueError, match="Invalid Yuma function"):
        tcost.capture_engine_cost("eager", 4, 4, 2, yuma_version="Yuma 9")


def _jrecord(rec: tcost.CostRecord) -> jcost.CostRecord:
    return jcost.CostRecord(**rec.to_json())


SPECS = [
    H100,
    tcost.DeviceSpec("ridge", 1e3, 1.0),  # every record compute-bound
    tcost.DeviceSpec("bandwidth only", None, 2e12),
    tcost.DeviceSpec("cpu"),
]


@pytest.mark.parametrize("spec", SPECS, ids=[s.name for s in SPECS])
@pytest.mark.parametrize("measured", [None, 1234.5])
def test_roofline_bitwise_jax(spec, measured):
    jspec = jcost.DeviceSpec(spec.name, spec.peak_flops, spec.hbm_bandwidth, spec.memory_bytes)
    records = [
        tcost.capture_engine_cost("fused_varying", 256, 4096, 64),
        tcost.capture_engine_cost("eager", 3, 2, 40),
        tcost.CostRecord("fused_scan", "cpu", 4, 8, 0, flops=10.0, bytes_accessed=0.0),
        tcost.CostRecord("eager", "cpu", 4, 8, 3, reason="null capture"),
    ]
    for rec in records:
        got = tcost.roofline(rec, spec, measured_epochs_per_sec=measured).to_json()
        want = jcost.roofline(_jrecord(rec), jspec, measured_epochs_per_sec=measured).to_json()
        assert got == want


def test_k3_roofline_is_the_kernel_line_bound():
    """At the main path's 256 x 4096 x 64 the varying scan's roofline is
    bytes-bound at 0.0814 ms, the bound `chip_smoke.py` prints for K3."""
    E, V, M = 64, 256, 4096
    rec = tcost.capture_engine_cost("fused_varying", V, M, E)
    roof = tcost.roofline(rec, H100, measured_epochs_per_sec=E / 1.42e-3)
    ms, by = tcost.bound_ms(4 * (E * V * M + 2 * E * V + V * M), E * 17 * 2 * V * M)
    assert by == "bytes" and round(ms, 4) == 0.0814 and roof.bound == "memory"
    assert roof.predicted_seconds * 1e3 == pytest.approx(ms, rel=1e-12)
    assert 0.05 < roof.attained_fraction < 0.06
    assert tcost.bound_ms(0, tcost.PEAK_OPS_PER_S, tcost.PEAK_INT8_OPS_PER_S) == (2e3, "operations")
    assert tcost.DEVICE_SPECS["h100"].peak_flops == tcost.PEAK_OPS_PER_S


def test_attach_cost_and_plan_json_keys_equal_jax():
    from yuma_simulation_tpu.simulation import planner as jplanner

    plan = plan_dispatch("p", (16, 8, 128), "Yuma 1 (paper)", YumaConfig(), torch.float32,
                         device="cpu")
    assert plan.cost is None and plan.executable is None
    costed = plan.attach_cost()
    assert costed.cost == tcost.capture_engine_cost("eager", 8, 128, 16).to_json()
    assert costed == dataclasses.replace(plan, cost=costed.cost)
    assert plan.attach_executable() is plan  # the CPU plan launches no library
    jplan = jplanner.plan_dispatch("p", (16, 8, 128), "Yuma 1 (paper)", JConfig(), np.float32)
    assert set(costed.to_json()) == set(jplan.to_json()) | {"on_card"}
    assert costed.to_json()["executable"] is None
    card = plan_dispatch("p", (16, 8, 128), "Yuma 1 (paper)", YumaConfig(), torch.float32,
                         device="cuda", check_memory=False)
    assert card.engine == "fused_varying"
    assert card.attach_cost().cost["hlo_fingerprint"] == library_digest("case_scan.cu")
    assert card.demoted("fused_scan").executable is None


def test_record_costs_merges_and_checks(tmp_path):
    rec = FlightRecorder(tmp_path)
    rec.record_costs([])
    assert load_bundle(tmp_path).costs == []
    rec.record_costs(tcost.capture_engine_costs(4, 8, 2), run_id="r1")
    rec.record_costs([tcost.capture_engine_cost("eager", 4, 8, 2).to_json()], run_id="r1")
    rec.record_costs({"e": tcost.capture_engine_cost("eager", 4, 8, 3)}, run_id="r2")
    costs = load_bundle(tmp_path).costs
    assert len(costs) == 6 and {c["run_id"] for c in costs} == {"r1", "r2"}
    assert costs == jflight._read_jsonl(tmp_path / jflight.COSTS_NAME)


def test_supervisor_capture_costs_into_the_bundle(tmp_path):
    """`SweepSupervisor(capture_costs=True)` writes one record per rung at
    the sweep's shape, stamped with its run, and the bundle passes the
    port's and the JAX package's checks."""
    from yuma_simulation_tpu_torch.telemetry.slo import set_slo_engine

    set_slo_engine(None)
    sup = SweepSupervisor(directory=tmp_path, unit_size=7, capture_costs=True)
    out = sup.run_batch(get_cases(), "Yuma 2 (Adrian-Fish)", device="cpu")
    assert out["report"].units_completed == 2
    bundle = load_bundle(tmp_path)
    assert [c["engine"] for c in bundle.costs] == list(tcost.ENGINE_RUNGS)
    assert {(c["V"], c["M"], c["epochs"]) for c in bundle.costs} == {(3, 2, 40)}
    assert len({c["run_id"] for c in bundle.costs}) == 1
    assert check_bundle(bundle) == []
    assert jflight.check_bundle(jflight.load_bundle(tmp_path)) == []

"""The port's dispatch planner (`simulation/planner.py`) and HBM preflight
(`telemetry/cost.py`) against the JAX package's, on the CPU.

Contracts: the same plan for the same request, with the bottom rung's
names mapped ("xla" in JAX, "eager" in the port): engine, consensus,
fallback consensus, ladder, shape bucket, and the same errors; under a
`YUMA_TPU_DEVICE_SPEC` override the same memory plan on the eager rung
(the `estimate_hbm_bytes` breakdown term for term, `fits`, `chunk_epochs`,
the `HBMPreflightError` message with its `max_resident_epochs`
suggestion); equal requests give equal plans; planning never asks the card
for its free memory.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yuma_simulation_tpu.models.config import YumaConfig as JConfig
from yuma_simulation_tpu.simulation import planner as jp
from yuma_simulation_tpu.telemetry import cost as jcost
from yuma_simulation_tpu_torch.models.config import (
    SimulationHyperparameters,
    YumaConfig,
)
from yuma_simulation_tpu_torch.ops.cuda_epoch import _scratch_layout, varying_scan_epoch_tile
from yuma_simulation_tpu_torch.simulation import planner as tp
from yuma_simulation_tpu_torch.telemetry import cost as tcost

CPU = torch.device("cpu")


def _jname(rung: str) -> str:
    return "xla" if rung == "eager" else rung


def _tname(rung: str) -> str:
    return "eager" if rung == "xla" else rung


def _plans(shape, epoch_impl="auto", **kw):
    """(JAX's plan or its ValueError, the port's plan or its ValueError)."""
    out = []
    for plan, impl, dtype, extra in (
        (jp.plan_dispatch, _jname(epoch_impl), jnp.float32, {}),
        (tp.plan_dispatch, epoch_impl, torch.float32, {"device": CPU}),
    ):
        cfg = JConfig() if plan is jp.plan_dispatch else YumaConfig()
        try:
            out.append(plan("t", shape, "Yuma 1 (paper)", cfg, dtype, epoch_impl=impl,
                            **kw, **extra))
        except ValueError as err:
            out.append(err)
    return out


REQUESTS = [
    dict(epoch_impl=impl, consensus_impl=cons, **flags)
    for impl in ("auto", "eager", "fused_scan", "fused_scan_mxu", "fused_varying",
                 "fused_varying_mxu", "nope")
    for cons in ("auto", "bisect", "sorted")
    for flags in ({}, {"has_miner_mask": True})
]


@pytest.mark.parametrize("shape", [(40, 3, 2), (3, 12, 8, 300), (17, 5, 128)],
                         ids=["case", "batched", "prime-E"])
def test_plan_matches_jax(shape):
    """Every request of REQUESTS on the CPU: the same engine (names
    mapped), consensus, fallback consensus, ladder and bucket as JAX's
    plan, or a ValueError from both."""
    for req in REQUESTS:
        ref, got = _plans(shape, check_memory=False, **req)
        if isinstance(ref, ValueError):
            assert isinstance(got, ValueError), (req, got)
            continue
        assert not isinstance(got, ValueError), (req, got)
        assert got.engine == _tname(ref.engine), req
        assert (got.consensus_impl, got.fallback_consensus) == (
            ref.consensus_impl, ref.fallback_consensus), req
        assert got.ladder == tuple(_tname(r) for r in ref.ladder), req
        assert got.bucket.to_json() == ref.bucket.to_json(), req
        assert (got.batch_lanes, got.miner_shards) == (ref.batch_lanes, ref.miner_shards)


def test_xla_runs_eager_with_a_reason():
    plan = tp.plan_dispatch("t", (40, 3, 2), "Yuma 1 (paper)", YumaConfig(), torch.float32,
                            epoch_impl="xla", device=CPU)
    assert plan.engine == "eager" and plan.ladder == ("eager",)
    assert any("'xla'" in r for r in plan.reasons)
    assert plan.demoted("xla") is plan


def test_auto_on_the_card_plans_without_a_device_query(monkeypatch):
    """Planning for the card is host arithmetic: it never calls
    `torch.cuda.mem_get_info` (so no card is needed here), picks K3 where
    an epoch tile >= 2 divides E and K2 where none does, with the VPU
    support where JAX would take the `_mxu` twin, and sends a miner mask
    and the dyadic bound to the eager rung."""

    def refuse(*_):
        raise AssertionError("plan_dispatch asked the card for its free memory")

    monkeypatch.setattr(torch.cuda, "mem_get_info", refuse)
    cfg = YumaConfig()

    def plan(shape, **kw):
        return tp.plan_dispatch("t", shape, "Yuma 1 (paper)", cfg, torch.float32,
                                device="cuda", **kw)

    varying = plan((64, 256, 4096), check_memory=False)
    assert varying.engine == "fused_varying" and "tile=16" in varying.reasons[0]
    assert "_mxu" in varying.reasons[0]
    assert plan((17, 256, 4096), check_memory=False).engine == "fused_scan"
    assert plan((64, 256, 4096), has_miner_mask=True, check_memory=False).engine == "eager"
    assert plan((64, 8, 16384), check_memory=False).engine == "eager"
    # Explicit fused rungs past the dyadic bound carry JAX's drift note.
    assert tp.EXPECTED_DRIFT_U16_FALLBACK in plan(
        (64, 8, 16384), epoch_impl="fused_scan", check_memory=False).reasons
    assert varying.demoted("fused_scan").engine == "fused_scan"
    with pytest.raises(ValueError, match="only walks DOWN"):
        plan((17, 256, 4096), epoch_impl="fused_scan", check_memory=False).demoted(
            "fused_varying")


@pytest.mark.parametrize("memory", [3_000_000, 5_000_000, 9_000_000])
def test_streaming_slabs_tile_at_16(monkeypatch, memory):
    """A streaming plan on K3 rounds its slab length down to a multiple of
    16 once it is at least 16, so every re-sliced slab runs at K3's
    largest tile; the eager rung's slab length stays JAX's formula."""
    monkeypatch.setattr(torch.cuda, "mem_get_info", None)
    _spec_env(monkeypatch, memory)
    args = ("t", (512, 8, 256), "Yuma 1 (paper)", YumaConfig(), torch.float32)
    kw = dict(streaming=True, save_bonds=True)
    fused = tp.plan_dispatch(*args, device="cuda", **kw)
    eager = tp.plan_dispatch(*args, device=CPU, **kw)
    assert fused.engine == "fused_varying" and eager.engine == "eager"
    budget = int(memory * tcost.DEFAULT_MEMORY_FRACTION)

    def raw_slab(engine):
        est = [tcost.estimate_hbm_bytes(8, 256, resident_epochs=e, save_bonds=True,
                                        scratch_bytes=tp.scan_scratch_bytes(engine, 8, 256))
               for e in (0, 1)]
        return (budget - est[0].total_bytes) // (
            tp.STREAM_BUFFERS * (est[1].total_bytes - est[0].total_bytes))

    raw = raw_slab("fused_varying")
    assert raw >= 16 and raw % 16, raw  # the rounding is exercised
    chunk = fused.memory.chunk_epochs
    assert chunk == raw - raw % 16
    assert varying_scan_epoch_tile((chunk, 8, 256)) == 16
    assert eager.memory.chunk_epochs == raw_slab("eager")


def test_plans_are_deterministic():
    kw = dict(epoch_impl="auto", save_bonds=True, device=CPU)
    a = tp.plan_dispatch("t", (40, 3, 2), "Yuma 2 (Adrian-Fish)", YumaConfig(), torch.float32,
                         **kw)
    b = tp.plan_dispatch("t", (40, 3, 2), "Yuma 2 (Adrian-Fish)", YumaConfig(), torch.float32,
                         **kw)
    assert a == b and json.dumps(a.to_json()) == json.dumps(b.to_json())
    assert a.span_attr()["bucket"] == "b1e40v8m128"


@pytest.mark.parametrize(
    "V,M,E,saves",
    [(3, 2, 40, (True, True, False)), (256, 4096, 64, (False, False, False)),
     (7, 300, 5, (True, False, True))],
    ids=["case", "real", "saves"],
)
def test_estimate_matches_jax_term_for_term(V, M, E, saves):
    kw = dict(resident_epochs=E, save_bonds=saves[0], save_incentives=saves[1],
              save_consensus=saves[2], batch_lanes=3)
    got = tcost.estimate_hbm_bytes(V, M, **kw)
    assert got.to_json() == jcost.estimate_hbm_bytes(V, M, **kw).to_json()
    # A fused rung adds its scan's scratch at the largest tile, per lane.
    scratch = tp.scan_scratch_bytes("fused_varying", V, M)
    assert scratch == _scratch_layout(16, 1, V, M)[0] and tp.scan_scratch_bytes("eager", V, M) == 0
    fused = tcost.estimate_hbm_bytes(V, M, scratch_bytes=scratch, **kw)
    assert fused.breakdown["scan_scratch"] == 3 * scratch
    assert fused.total_bytes == got.total_bytes + 3 * scratch


def _spec_env(monkeypatch, memory_bytes):
    monkeypatch.setenv(tcost.DEVICE_SPEC_ENV, json.dumps(
        {"name": "tiny", "memory_bytes": memory_bytes}))


@pytest.mark.parametrize("memory", [None, 50_000, 400_000, 10**9],
                         ids=["unknown", "tight", "slabs", "roomy"])
@pytest.mark.parametrize("streaming", [False, True], ids=["monolithic", "streaming"])
def test_memory_plan_matches_jax(monkeypatch, memory, streaming):
    """Under a device-spec override (and without one: capacity unknown on
    the CPU), the eager rung's memory plan is JAX's: breakdown, verdict,
    slab length, and the same HBMPreflightError message."""
    if memory is not None:
        _spec_env(monkeypatch, memory)
    ref, got = _plans((64, 8, 16), streaming=streaming, save_bonds=True,
                      max_resident_epochs=16 if streaming else None)
    if isinstance(ref, jcost.HBMPreflightError):
        assert isinstance(got, tcost.HBMPreflightError), got
        assert str(got) == str(ref)
        assert "max_resident_epochs<=" in str(got)
        assert got.verdict.to_json() == ref.verdict.to_json()
        return
    assert not isinstance(got, ValueError), got
    assert got.memory.to_json() == ref.memory.to_json()
    assert got.engine == "eager" and ref.engine == "xla"


def test_preflight_off_and_verdicts(monkeypatch):
    _spec_env(monkeypatch, 1000)
    est = tcost.estimate_hbm_bytes(8, 16, resident_epochs=64)
    jest = jcost.estimate_hbm_bytes(8, 16, resident_epochs=64)
    for kw in ({}, {"fraction": 0.5}):
        got = tcost.preflight_hbm("x", est, raise_on_reject=False, **kw)
        ref = jcost.preflight_hbm("x", jest, raise_on_reject=False, **kw)
        assert got.to_json() == ref.to_json()
    monkeypatch.setenv(tcost.PREFLIGHT_ENV, "0")
    assert not tcost.preflight_enabled()
    assert tcost.preflight_hbm("x", est).fits is None
    plan = tp.plan_dispatch("t", (64, 8, 16), "Yuma 1 (paper)", YumaConfig(), torch.float32,
                            streaming=True, device=CPU)
    assert plan.memory.chunk_epochs is None


def test_device_spec_resolution(monkeypatch):
    """The CPU has no capacity; a card of unknown name keeps its memory;
    the override wins; every resolution is cached per device."""
    monkeypatch.delenv(tcost.DEVICE_SPEC_ENV, raising=False)
    assert tcost.resolve_device_spec(device="cpu") == tcost.DeviceSpec("cpu")
    override = tcost.DeviceSpec("x", memory_bytes=5)
    assert tcost.resolve_device_spec(override) is override
    _spec_env(monkeypatch, 123)
    spec = tcost.resolve_device_spec(device="cpu")
    assert (spec.name, spec.memory_bytes) == ("tiny", 123)
    assert tcost.resolve_device_spec(device="cpu") is spec
    assert tcost.DEVICE_SPECS["h100"].hbm_bandwidth == 3.35e12


def test_scaled_and_montecarlo_resolutions_match_jax():
    cfg, jcfg = YumaConfig(), JConfig()
    mode = None
    for shape, E in (((8, 16), 4), ((2, 8, 16), 4), ((8, 16), 0)):
        ref = jp.resolve_scaled_engine(shape, mode, jcfg, jnp.float32, E)
        got = tp.resolve_scaled_engine(shape, mode, cfg, torch.float32, E, device=CPU)
        assert got == _tname(ref)
    for impl in ("auto", "hoisted", "xla"):
        for varying in (False, True):
            try:
                ref = jp.resolve_montecarlo_engine(impl, varying)
            except ValueError:
                with pytest.raises(ValueError):
                    tp.resolve_montecarlo_engine(impl, varying)
                continue
            assert tp.resolve_montecarlo_engine(impl, varying) == _tname(ref)


def test_ladder_and_flags_match_jax():
    for rung in jp.ENGINE_LADDER + ("fused", "hoisted"):
        assert tp.ladder_from(_tname(rung)) == tuple(_tname(r) for r in jp.ladder_from(rung))
    for rung in jp.FUSED_CASE_RUNGS:
        assert tp.rung_flags(rung) == jp.rung_flags(rung)
    assert tp.FUSED_CASE_RUNGS == jp.FUSED_CASE_RUNGS
    assert (tp.STREAM_BUFFERS, tp.SUBLANE_TILE, tp.LANE_TILE) == (
        jp.STREAM_BUFFERS, jp.SUBLANE_TILE, jp.LANE_TILE)
    for V, M in ((3, 2), (8, 128), (9, 129), (256, 4096)):
        assert tp.bucket_shape(V, M, epochs=5, batch=2) == tp.ShapeBucket(
            **jp.bucket_shape(V, M, epochs=5, batch=2).to_json())
    # A V past the limb split's reach drops the _mxu rungs below the engine.
    big = tp.plan_dispatch("t", (4, 2**14 + 1, 8), "Yuma 1 (paper)",
                           YumaConfig(simulation=SimulationHyperparameters()),
                           torch.float32, epoch_impl="fused_varying_mxu",
                           check_memory=False, device=CPU)
    assert big.ladder == ("fused_varying_mxu", "fused_varying", "fused_scan", "eager")
    np.testing.assert_equal(
        big.ladder, tuple(_tname(r) for r in jp.plan_dispatch(
            "t", (4, 2**14 + 1, 8), "Yuma 1 (paper)", JConfig(), jnp.float32,
            epoch_impl="fused_varying_mxu", check_memory=False).ladder))

"""The port's resilience tier — `resilience/{errors,faults,guards,retry,
watchdog}.py`, the quarantine guard on the eager rung, the ladder and the
watchdog through `simulate`, `simulate_streamed`, `simulate_batch` and
`sweep_hyperparams`, and the elastic sharded batch — against the JAX
package on the CPU.

JAX's own fault hooks never fire on this toolchain (its `_tracing_now`
probes `jax.core.trace_state_clean`, which jax 0.9 no longer has, and so
reads every host call as traced), so no test here drives a JAX fault.
Instead: a recovered result is held bitwise against JAX run directly on
the rung where the port's ladder landed (its XLA rung for "eager"), and a
quarantine against JAX's `quarantine=True` on data that really contains a
NaN. On the CPU the fused rungs run the kernels' plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yuma_simulation_tpu.models.config import SimulationHyperparameters as JSim
from yuma_simulation_tpu.models.config import YumaConfig as JConfig
from yuma_simulation_tpu.models.variants import variant_for_version as j_variant
from yuma_simulation_tpu.resilience import errors as jerrors
from yuma_simulation_tpu.resilience.guards import build_quarantine_report as j_report
from yuma_simulation_tpu.scenarios import create_case as j_create_case
from yuma_simulation_tpu.simulation import sweep as j_sweep
from yuma_simulation_tpu.simulation.engine import simulate as j_simulate
from yuma_simulation_tpu_torch.models.config import YumaConfig
from yuma_simulation_tpu_torch.models.variants import variant_for_version
from yuma_simulation_tpu_torch.parallel import MeshDegradation, make_mesh, simulate_batch_sharded
from yuma_simulation_tpu_torch.parallel import sharded as tsharded
from yuma_simulation_tpu_torch.resilience import (
    Deadline,
    DemotionRecord,
    DeviceLossError,
    DeviceLossFault,
    EngineLadderExhausted,
    EngineStall,
    FaultPlan,
    NaNFault,
    RetryPolicy,
    StallFault,
    build_quarantine_report,
    classify_failure,
    default_retry_policy,
    inject_faults,
    run_ladder,
)
from yuma_simulation_tpu_torch.resilience import errors as terrors
from yuma_simulation_tpu_torch.scenarios import create_case
from yuma_simulation_tpu_torch.scenarios.base import Scenario
from yuma_simulation_tpu_torch.simulation.engine import simulate, simulate_streamed
from yuma_simulation_tpu_torch.simulation.sweep import (
    config_grid,
    simulate_batch,
    stack_scenarios,
    sweep_hyperparams,
)
from yuma_simulation_tpu_torch.telemetry.metrics import get_registry

#: No backoff sleep: the tests drive the ladder, not its jitter.
FAST = RetryPolicy(max_attempts_per_rung=1, backoff_base=0.0, seed=0)
FAST2 = RetryPolicy(max_attempts_per_rung=2, backoff_base=0.0, seed=0)
CASE = "Case 3"
VERSION = "Yuma 1 (paper)"


def _count(name):
    return get_registry().counter(name).value


# ---------------------------------------------------------------------------
# classify_failure


#: Every marker of the JAX package's taxonomy, one message each.
JAX_MARKERS = (
    [(m, "EngineResourceExhausted") for m in jerrors._RESOURCE_MARKERS]
    + [(m, "HostLossError") for m in jerrors._HOST_LOSS_MARKERS]
    + [(m, "EngineStall") for m in jerrors._STALL_MARKERS if m not in jerrors._HOST_LOSS_MARKERS]
    + [(m, "EngineCompileError") for m in jerrors._COMPILE_MARKERS]
)


@pytest.mark.parametrize("marker,kind", JAX_MARKERS, ids=[m for m, _ in JAX_MARKERS])
def test_classify_jax_markers_as_jax_does(marker, kind):
    """Every JAX marker classifies to the same type in both packages."""
    exc = RuntimeError(f"INTERNAL: something {marker.upper()} happened")
    want = jerrors.classify_failure(exc)
    got = classify_failure(exc)
    assert type(want).__name__ == type(got).__name__ == kind
    assert got.__cause__ is exc and str(got) == str(want)


#: The CUDA messages and what they classify as.
CUDA_MESSAGES = [
    ("CUDA out of memory. Tried to allocate 1024.00 GiB", "EngineResourceExhausted"),
    ("CUDA error: out of memory", "EngineResourceExhausted"),
    ("nvcc case_scan.cu failed (exit 1):\nerror: identifier undefined", "EngineCompileError"),
    ("nvcc not found (searched PATH, $CUDA_HOME and /usr/local/cuda)", "EngineCompileError"),
    ("ptxas error   : Entry function uses too much shared data", "EngineCompileError"),
    ("build/consensus-1.so: undefined symbol: k_bisect", "EngineCompileError"),
    ("CUDA error: no kernel image is available for execution on the device",
     "EngineCompileError"),
    ("[Rank 0] Watchdog caught collective operation timeout: WorkNCCL(SeqNum=1)",
     "EngineStall"),
    ("Timed out waiting 1800000ms for recv operation to complete", "EngineStall"),
    ("[../third_party/gloo/gloo/transport/tcp/pair.cc:534] Connection closed by peer",
     "HostLossError"),
    ("NCCL error: remote process exited or there was a network error, "
     "NCCL version 2.21.5 ncclRemoteError", "HostLossError"),
    ("CUDA error: an illegal memory access was encountered", "DeviceLossError"),
    ("CUDA error: unspecified launch failure", "DeviceLossError"),
    ("CUDA error: device-side assert triggered", "DeviceLossError"),
]


@pytest.mark.parametrize("message,kind", CUDA_MESSAGES, ids=[k for _, k in CUDA_MESSAGES])
def test_classify_cuda_messages(message, kind):
    """The CUDA messages: out of memory, a kernel build or load that fails,
    NCCL / gloo timeouts and peer deaths, and the sticky context errors,
    which carry `context_lost` and say that nothing retries on the card."""
    typed = classify_failure(RuntimeError(message))
    assert type(typed).__name__ == kind
    sticky = kind == "DeviceLossError"
    assert getattr(typed, "context_lost", False) is sticky
    if sticky:
        assert "no retry or demotion" in str(typed)


def test_classify_typed_oom_and_non_engine_errors():
    oom = classify_failure(torch.OutOfMemoryError("allocation on device 0"))
    assert isinstance(oom, terrors.EngineResourceExhausted)
    for exc in (ValueError("out of memory"), TypeError("x"), KeyboardInterrupt(),
                OSError("connection reset by peer"), RuntimeError("boom")):
        assert classify_failure(exc) is None and jerrors.classify_failure(exc) is None
    # A typed non-engine error is never re-matched against the markers.
    assert classify_failure(terrors.DistributedInitError("connection refused")) is None
    assert jerrors.classify_failure(jerrors.DistributedInitError("connection refused")) is None
    stall = EngineStall("x", budget_seconds=1.0)
    assert classify_failure(stall) is stall


def test_sticky_error_is_never_retried_or_demoted():
    """A sticky CUDA error propagates at once: no second attempt, no
    demotion, even with rungs and attempts left."""
    calls = []

    def dispatch(rung):
        calls.append(rung)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(DeviceLossError, match="no retry or demotion") as info:
        run_ladder(dispatch, "fused_varying", FAST2)
    assert calls == ["fused_varying"] and info.value.context_lost


# ---------------------------------------------------------------------------
# the ladder


def _jax_xla(case, version, **kw):
    return j_simulate(j_create_case(case), version, save_bonds=True, save_incentives=True,
                      epoch_impl="xla", **kw)


def test_ladder_demotes_one_rung_bitwise_the_landed_rung():
    """One injected fused fault under a one-attempt policy: one demotion,
    fused_varying -> fused_scan_mxu, recorded in the result, the log and
    the counter; the result bitwise a direct run on fused_scan_mxu and
    bitwise JAX's XLA rung (the plain scans round as it does on the
    built-in cases)."""
    before = _count("engine_demotions")
    with inject_faults(FaultPlan(fused_oom_dispatches=1)) as state:
        got = simulate(create_case(CASE), VERSION, epoch_impl="fused_varying",
                       retry_policy=FAST, save_bonds=True, save_incentives=True,
                       device="cpu", x64=True)
    assert state.fused_dispatches_failed == 1
    assert got.engine == "fused_scan_mxu"
    assert got.demotions == (DemotionRecord(
        from_engine="fused_varying", to_engine="fused_scan_mxu", attempts=1,
        error_type="EngineResourceExhausted",
        message="injected fault: simulated RESOURCE_EXHAUSTED on fused dispatch 1/1"),)
    assert _count("engine_demotions") == before + 1
    direct = simulate(create_case(CASE), VERSION, epoch_impl="fused_scan_mxu", save_bonds=True,
                      save_incentives=True, device="cpu", x64=True)
    ref = _jax_xla(CASE, VERSION)
    for key in ("dividends", "bonds", "incentives"):
        np.testing.assert_array_equal(getattr(got, key), getattr(direct, key), err_msg=key)
        np.testing.assert_array_equal(getattr(got, key), np.asarray(getattr(ref, key)),
                                      err_msg=key)


@pytest.mark.parametrize("version", ["Yuma 0 (subtensor)", "Yuma 2 (Adrian-Fish)",
                                     "Yuma 4 (Rhef+relative bonds) - liquid alpha on"])
def test_ladder_walks_to_eager_bitwise_jax_xla(version):
    """Every fused rung failing: the ladder walks to the eager rung (on the
    same device), and the result is bitwise JAX's XLA rung; a retry
    absorbed on a rung adds to `engine_retries` and demotes nothing."""
    retries = _count("engine_retries")
    with inject_faults(FaultPlan(fused_oom_dispatches=99)):
        got = simulate(create_case("Case 5"), version, epoch_impl="fused_varying",
                       retry_policy=FAST2, save_bonds=True, save_incentives=True,
                       device="cpu", x64=True)
    assert got.engine == "eager"
    assert [d.to_engine for d in got.demotions] == ["fused_scan_mxu", "fused_scan", "eager"]
    assert _count("engine_retries") == retries + 3  # one same-rung retry per fused rung
    ref = _jax_xla("Case 5", version)
    for key in ("dividends", "bonds", "incentives"):
        np.testing.assert_array_equal(getattr(got, key), np.asarray(getattr(ref, key)),
                                      err_msg=f"{version} {key}")
    with inject_faults(FaultPlan(fused_oom_dispatches=1)):
        again = simulate(create_case("Case 5"), version, epoch_impl="fused_varying",
                         retry_policy=FAST2, device="cpu", x64=True)
    assert again.engine == "fused_varying" and again.demotions is None


def test_ladder_exhausted_and_caller_errors():
    with inject_faults(FaultPlan(fused_oom_dispatches=99)):
        with pytest.raises(EngineLadderExhausted) as info:
            run_ladder(lambda rung: simulate(create_case(CASE), VERSION, epoch_impl=rung,
                                             device="cpu"),
                       "fused_scan", FAST, rungs=("fused_scan",))
    assert info.value.records == ()
    calls = []

    def bad(rung):
        calls.append(rung)
        raise ValueError("caller error")

    with pytest.raises(ValueError):
        run_ladder(bad, "fused_varying", FAST2)
    assert calls == ["fused_varying"]
    assert default_retry_policy() == RetryPolicy()


def test_batch_ladder_and_quarantine_plan():
    """`simulate_batch(retry_policy=)` demotes like `simulate`; under
    `quarantine=True` "auto" plans the eager rung and a fused rung raises
    (the JAX package's messages)."""
    W, S, ri, re_ = stack_scenarios([create_case(CASE), create_case("Case 4")], device="cpu")
    spec = variant_for_version(VERSION)
    with inject_faults(FaultPlan(fused_oom_dispatches=1)):
        got = simulate_batch(W, S, ri, re_, YumaConfig(), spec, epoch_impl="fused_scan",
                             retry_policy=FAST)
    ref = simulate_batch(W, S, ri, re_, YumaConfig(), spec, epoch_impl="eager")
    np.testing.assert_array_equal(got["dividends"].numpy(), ref["dividends"].numpy())
    with pytest.raises(ValueError, match="quarantine rides the XLA scan carry"):
        simulate_batch(W, S, ri, re_, YumaConfig(), spec, epoch_impl="fused_varying",
                       quarantine=True)
    from yuma_simulation_tpu_torch.simulation.planner import plan_dispatch

    plan = plan_dispatch("q", W.shape, spec, YumaConfig(), torch.float32, quarantine=True,
                         check_memory=False, device="cuda")
    assert plan.engine == "eager"
    assert plan.reasons == ("auto->eager: quarantine guard rides the XLA carry",)


def _card_plan(epoch_impl="auto", shape=(2, 16, 8, 16)):
    from yuma_simulation_tpu_torch.simulation.planner import plan_dispatch

    return plan_dispatch("t", shape, variant_for_version(VERSION), YumaConfig(),
                         torch.float32, epoch_impl=epoch_impl, check_memory=False,
                         device="cuda")


@pytest.mark.parametrize("rung", ["auto", "fused_varying_mxu", "fused_varying",
                                  "fused_scan_mxu", "fused_scan"])
def test_card_ladder_stops_at_the_last_kernel_rung(rung):
    """Planned for the card, a fused dispatch's ladder ends at fused_scan (the
    last hand-written rung), also once re-anchored lower; planned for the
    CPU the same request keeps JAX's ladder down to the eager rung."""
    from yuma_simulation_tpu_torch.simulation.planner import ladder_from, plan_dispatch

    plan = _card_plan(rung)
    assert plan.on_card and plan.engine != "eager"
    assert plan.ladder == ladder_from(plan.engine)[:-1] and plan.ladder[-1] == "fused_scan"
    assert plan.demoted("fused_scan").ladder == ("fused_scan",)
    cpu = plan_dispatch("t", (2, 16, 8, 16), variant_for_version(VERSION), YumaConfig(),
                        torch.float32, epoch_impl=rung, check_memory=False, device="cpu")
    assert not cpu.on_card and cpu.ladder == ladder_from(cpu.engine)
    # The eager rung runs on the card only when the plan picks it.
    picked = _card_plan("eager")
    assert picked.on_card and picked.ladder == ("eager",)


@pytest.mark.parametrize("message", [
    "nvcc case_scan.cu failed (exit 1):\nerror: identifier undefined",
    "CUDA error: no kernel image is available for execution on the device",
    "build/case_scan-1.so: undefined symbol: run_scan",
])
def test_card_build_failure_raises_instead_of_demoting(message):
    """A kernel that will not build or launch, on a plan for the card:
    `EngineCompileError` at once, one attempt, no demotion and never the
    eager rung. The same failure on a CPU plan walks JAX's ladder down to
    the eager rung."""
    from yuma_simulation_tpu_torch.resilience.retry import supervise

    calls = []

    def dispatch(rung):
        calls.append(rung)
        if rung == "eager":
            return {"rung": rung}
        raise RuntimeError(message)

    before = _count("engine_demotions")
    with pytest.raises(terrors.EngineCompileError):
        supervise(dispatch, _card_plan(), default_retry_policy(), label="card")
    assert calls == ["fused_varying"] and _count("engine_demotions") == before
    from yuma_simulation_tpu_torch.simulation.planner import plan_dispatch

    calls.clear()
    cpu = plan_dispatch("t", (2, 16, 8, 16), variant_for_version(VERSION), YumaConfig(),
                        torch.float32, epoch_impl="fused_varying", check_memory=False,
                        device="cpu")
    out, engine, records = supervise(dispatch, cpu, FAST, label="cpu")
    assert engine == "eager" and out == {"rung": "eager"} and len(records) == 3
    assert calls == ["fused_varying", "fused_scan_mxu", "fused_scan", "eager"]


def test_card_batch_build_failure_never_lands_on_eager(monkeypatch):
    """`simulate_batch(retry_policy=)` with a plan for the card whose kernel
    fails to build (mocked): it raises; the eager rung never runs."""
    from yuma_simulation_tpu_torch.simulation import sweep as tsweep

    real_plan = tsweep.plan_dispatch
    monkeypatch.setattr(tsweep, "plan_dispatch",
                        lambda *a, **kw: real_plan(*a, **{**kw, "device": "cuda"}))
    rungs = []

    def broken(plan, *a, **kw):
        rungs.append(plan.engine)
        raise RuntimeError("nvcc case_scan.cu failed (exit 1)")

    monkeypatch.setattr(tsweep, "_dispatch_case", broken)
    W, S, ri, re_ = stack_scenarios([create_case(CASE), create_case("Case 4")], device="cpu")
    with pytest.raises(terrors.EngineCompileError, match="nvcc"):
        simulate_batch(W, S, ri, re_, YumaConfig(), variant_for_version(VERSION),
                       retry_policy=FAST2)
    assert len(rungs) == 1 and rungs[0] != "eager"


def test_card_oom_demotes_between_kernel_rungs_only():
    """Out of memory on a plan for the card retries and demotes between the
    kernel rungs and, when every one fails, exhausts the ladder there: the
    eager rung is never tried."""
    from yuma_simulation_tpu_torch.resilience.retry import supervise

    calls = []

    def dispatch(rung):
        calls.append(rung)
        if rung == "fused_scan_mxu" and calls.count(rung) == 2:
            return {"rung": rung}
        raise torch.OutOfMemoryError("CUDA out of memory")

    out, engine, records = supervise(dispatch, _card_plan(), FAST2)
    assert engine == "fused_scan_mxu" and [r.to_engine for r in records] == ["fused_scan_mxu"]
    calls.clear()

    def always_oom(rung):
        calls.append(rung)
        raise torch.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(EngineLadderExhausted) as info:
        supervise(always_oom, _card_plan(), FAST)
    assert calls == ["fused_varying", "fused_scan_mxu", "fused_scan"]
    assert [r.to_engine for r in info.value.records] == ["fused_scan_mxu", "fused_scan"]


# ---------------------------------------------------------------------------
# the watchdog


def test_stall_killed_then_retried():
    """A `StallFault` past the deadline: one `EngineStall` (the worker
    abandoned, `stalls_killed` + 1), then the same rung's retry, with the
    retry grace, returns the plain result; without a ladder the stall
    raises to the caller."""
    plain = simulate(create_case(CASE), VERSION, device="cpu")
    killed = _count("stalls_killed")
    deadline = Deadline(budget_seconds=0.05, grace_seconds=30.0)
    with inject_faults(FaultPlan(stall=StallFault(seconds=0.3, dispatches=1))) as state:
        got = simulate(create_case(CASE), VERSION, retry_policy=FAST2, deadline=deadline,
                       device="cpu")
    assert state.stall_dispatches_fired == 1
    assert _count("stalls_killed") == killed + 1
    assert got.engine == "eager" and got.demotions is None
    np.testing.assert_array_equal(got.dividends, plain.dividends)
    with inject_faults(FaultPlan(stall=StallFault(seconds=0.3, dispatches=1))):
        with pytest.raises(EngineStall, match="exceeded its 0.050s deadline") as info:
            simulate(create_case(CASE), VERSION, deadline=Deadline(0.05), device="cpu")
    assert info.value.budget_seconds == pytest.approx(0.05)


def test_run_simulation_supervised_matches_jax():
    """`run_simulation(supervised=True)` (the default ladder and deadline)
    returns JAX's supervised driver's dividends, bonds and incentives."""
    from yuma_simulation_tpu.simulation.engine import run_simulation as j_run
    from yuma_simulation_tpu_torch.simulation.engine import run_simulation

    got = run_simulation(create_case("Case 4"), VERSION, supervised=True, device="cpu")
    want = j_run(j_create_case("Case 4"), VERSION, supervised=True)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.stack(a), np.stack(b))


def test_deadline_worker_raises_and_validates():
    from yuma_simulation_tpu_torch.resilience import run_with_deadline

    with pytest.raises(ZeroDivisionError):
        run_with_deadline(lambda: 1 / 0, Deadline(5.0))
    assert run_with_deadline(lambda: 7, Deadline(5.0)) == 7
    for bad in (dict(budget_seconds=0), dict(budget_seconds=1, grace_seconds=-1)):
        with pytest.raises(ValueError):
            Deadline(**bad)
    assert Deadline(1.0, 2.0).budget_for_attempt(1) == 3.0


# ---------------------------------------------------------------------------
# the quarantine


def _nan_batch(B=4, E=8, V=3, M=5, seed=0):
    """A random batch whose lane 1 has NaN weights from epoch 3 on."""
    rng = np.random.default_rng(seed)
    W = rng.random((B, E, V, M)).astype(np.float32)
    S = (rng.random((B, E, V)) + 0.1).astype(np.float32)
    W[1, 3:, 0, 2] = np.nan
    ri = np.array([-1, 2, 0, -1], np.int32)[:B]
    re_ = np.array([-1, 4, 5, -1], np.int32)[:B]
    return W, S, ri, re_


def _qstate(q):
    return {k: np.asarray(v) for k, v in q.items()}


@pytest.mark.parametrize("version", ["Yuma 2 (Adrian-Fish)", "Yuma 4 (Rhef+relative bonds)",
                                     "Yuma 3.1 (Rhef+reset)"])
def test_quarantine_batch_bitwise_jax(version):
    """Real NaN weights in lane 1 from epoch 3: `bad`, `first_bad_epoch`,
    the tensor code and every output (healthy lanes, and the masked lane's
    zeros) bitwise JAX's `simulate_batch(quarantine=True)`; the state is a
    device tensor the report reads once."""
    W, S, ri, re_ = _nan_batch()
    jys = j_sweep.simulate_batch(*(jnp.asarray(x) for x in (W, S, ri, re_)), JConfig(),
                                 j_variant(version), save_bonds=True, save_incentives=True,
                                 quarantine=True)
    ys = simulate_batch(*(torch.tensor(x) for x in (W, S, ri, re_)), YumaConfig(),
                        variant_for_version(version), save_bonds=True,
                        save_incentives=True, quarantine=True, x64=True)
    assert isinstance(ys["quarantine"]["bad"], torch.Tensor)
    got, want = _qstate(ys["quarantine"]), _qstate(jys["quarantine"])
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    report = build_quarantine_report(ys["quarantine"])
    assert dataclasses.asdict(report) == dataclasses.asdict(j_report(jys["quarantine"]))
    assert report.quarantined_cases == (1,) and report.entries[0].epoch == 3
    for key in ("dividends", "bonds", "incentives"):
        np.testing.assert_array_equal(ys[key].numpy(), np.asarray(jys[key]), err_msg=key)
    plain = simulate_batch(*(torch.tensor(x) for x in (W, S, ri, re_)), YumaConfig(),
                           variant_for_version(version), x64=True)
    healthy = report.healthy_mask()
    np.testing.assert_array_equal(ys["dividends"].numpy()[healthy],
                                  plain["dividends"].numpy()[healthy])


def test_quarantine_grid_bitwise_jax():
    """`sweep_hyperparams(quarantine=True)` with a NaN grid point: the bad
    lane's provenance and the grid's outputs bitwise JAX's; with
    `initial_state` it raises, as JAX's does."""
    points = dict(bond_alpha=[0.1, float("nan"), 0.05])
    cfg, _ = config_grid(**points)
    jcfg, _ = j_sweep.config_grid(**points)
    ys = sweep_hyperparams(create_case(CASE), VERSION, cfg, save_bonds=True,
                           quarantine=True, device="cpu", x64=True)
    jys = j_sweep.sweep_hyperparams(j_create_case(CASE), VERSION, jcfg, save_bonds=True,
                                    quarantine=True)
    got, want = _qstate(ys["quarantine"]), _qstate(jys["quarantine"])
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert build_quarantine_report(ys["quarantine"]).quarantined_cases == (1,)
    for key in ("dividends", "bonds"):
        np.testing.assert_array_equal(ys[key].numpy(), np.asarray(jys[key]), err_msg=key)
    with pytest.raises(ValueError, match="does not compose with quarantine"):
        sweep_hyperparams(create_case(CASE), VERSION, cfg, quarantine=True, device="cpu",
                          initial_state={"bonds": np.zeros((3, 2)),
                                         "consensus": np.zeros(2)})


def test_nan_fault_quarantines_its_lane_only():
    """The NaN fault's site: lane 0's dividends poisoned at epoch 2 inside
    the eager rung; the guard latches it there, and the other lanes are
    bitwise JAX's unfaulted quarantined run."""
    W, S, ri, re_ = (x.copy() for x in _nan_batch())
    W[1] = 0.5  # no real NaN: only the injected one
    version = "Yuma 2 (Adrian-Fish)"
    with inject_faults(FaultPlan(nan=NaNFault(epoch=2, case=0))):
        ys = simulate_batch(*(torch.tensor(x) for x in (W, S, ri, re_)), YumaConfig(),
                            variant_for_version(version), quarantine=True)
    report = build_quarantine_report(ys["quarantine"])
    assert [(e.case, e.epoch, e.tensor) for e in report.entries] == [(0, 2, "dividends")]
    jys = j_sweep.simulate_batch(*(jnp.asarray(x) for x in (W, S, ri, re_)), JConfig(),
                                 j_variant(version), quarantine=True)
    np.testing.assert_array_equal(ys["dividends"].numpy()[1:], np.asarray(jys["dividends"])[1:])
    assert not ys["dividends"][0, 2:].any()


# ---------------------------------------------------------------------------
# the elastic sharded batch


def _suite():
    return [create_case(c) for c in ("Case 1", "Case 2", "Case 3", "Case 4", "Case 5")]


def test_elastic_walk_drops_lost_device_bitwise_unsharded():
    """Four CPU `MeshDevice`s, device 2 lost: one shrink 4 -> 3 (the
    `mesh_degraded` record and the `mesh_shrinks` counter), every lane
    bitwise the unsharded batch; a quarantine report rides along."""
    cases = _suite()
    mesh = make_mesh(devices=["cpu"] * 4)
    shrinks = _count("mesh_shrinks")
    with inject_faults(FaultPlan(device_loss=DeviceLossFault(device_id=2))):
        out = simulate_batch_sharded(cases, VERSION, mesh=mesh, elastic=True,
                                     quarantine=True, x64=True)
    assert out["mesh_degradations"] == (MeshDegradation(4, 3, (2,), "DeviceLossError"),)
    assert _count("mesh_shrinks") == shrinks + 1
    assert not out["quarantine"] and out["quarantine"].num_cases == 5
    W, S, ri, re_ = stack_scenarios(cases, device="cpu")
    ref = simulate_batch(W, S, ri, re_, YumaConfig(), variant_for_version(VERSION), x64=True)
    np.testing.assert_array_equal(out["dividends"], ref["dividends"].numpy())
    # The totals: the same host sum over the same bits.
    np.testing.assert_array_equal(out["dividends"].sum(1), ref["dividends"].numpy().sum(1))
    with inject_faults(FaultPlan(device_loss=DeviceLossFault(device_id=2))):
        with pytest.raises(DeviceLossError):
            simulate_batch_sharded(cases, VERSION, mesh=mesh)  # not elastic


def test_elastic_walk_attributes_sticky_error_to_its_shard(monkeypatch):
    """A sticky CUDA error raised by one shard's dispatch is attributed to
    that shard's device: the mesh shrinks without it down to one device,
    and the lanes stay bitwise."""
    cases = _suite()[:3]
    real = tsharded.simulate_batch
    calls = []

    def flaky(W, *args, **kw):
        calls.append(len(calls))
        if len(calls) == 2:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real(W, *args, **kw)

    monkeypatch.setattr(tsharded, "simulate_batch", flaky)
    out = simulate_batch_sharded(cases, VERSION, mesh=make_mesh(devices=["cpu"] * 2),
                                 elastic=True)
    (shrink,) = out["mesh_degradations"]
    assert (shrink.from_devices, shrink.to_devices, shrink.lost_device_ids) == (2, 1, (1,))
    W, S, ri, re_ = stack_scenarios(cases, device="cpu")
    ref = real(W, S, ri, re_, YumaConfig(), variant_for_version(VERSION))
    np.testing.assert_array_equal(out["dividends"], ref["dividends"].numpy())


# ---------------------------------------------------------------------------
# the stream's ladder


def _long(E=12, V=3, M=5, seed=3):
    rng = np.random.default_rng(seed)
    W = rng.random((E, V, M)).astype(np.float32)
    S = (rng.random((E, V)) + 0.1).astype(np.float32)
    return Scenario(name="long", validators=[f"v{i}" for i in range(V)], base_validator="v0",
                    weights=W, stakes=S, num_epochs=E, reset_bonds_index=1,
                    reset_bonds_epoch=6)


def test_stream_ladder_restarts_a_reiterable_source():
    """`simulate(max_resident_epochs=)` hands the stream a re-iterable
    source: a fault on the second slab demotes, the stream restarts from
    chunk 0 on the eager rung, and the result is bitwise a direct eager
    run and JAX's XLA rung."""
    scen = _long()
    with inject_faults(FaultPlan(fused_oom_dispatches=1, fused_oom_skip=1)) as state:
        got = simulate(scen, VERSION, epoch_impl="fused_scan", max_resident_epochs=4,
                       retry_policy=FAST, save_bonds=True, device="cpu")
    assert state.fused_dispatches_seen == 2
    assert got.engine == "eager" and len(got.demotions) == 1
    direct = simulate(scen, VERSION, epoch_impl="eager", save_bonds=True, device="cpu")
    np.testing.assert_array_equal(got.dividends, direct.dividends)
    np.testing.assert_array_equal(got.bonds, direct.bonds)
    from yuma_simulation_tpu.scenarios.base import Scenario as JScenario

    jscen = JScenario(**{f.name: getattr(scen, f.name) for f in dataclasses.fields(JScenario)})
    ref = j_simulate(jscen, VERSION, JConfig(simulation=JSim()), epoch_impl="xla")
    np.testing.assert_array_equal(got.dividends, np.asarray(ref.dividends))


def test_stream_ladder_one_shot_generator():
    """A one-shot generator replays while the two chunks in hand are all it
    gave; past that, the demotion explains what to pass instead."""
    scen = _long()
    chunks = [(scen.weights[i:i + 4], scen.stakes[i:i + 4]) for i in range(0, 12, 4)]
    kw = dict(reset_bonds_index=1, reset_bonds_epoch=6, epoch_impl="fused_scan",
              retry_policy=FAST, device="cpu")
    with inject_faults(FaultPlan(fused_oom_dispatches=1)):
        got = simulate_streamed(iter(chunks), VERSION, **kw)
    direct = simulate_streamed(chunks, VERSION, **dict(kw, epoch_impl="eager"))
    assert got.engine == "eager"
    np.testing.assert_array_equal(got.dividends, direct.dividends)
    with inject_faults(FaultPlan(fused_oom_dispatches=1, fused_oom_skip=2)):
        with pytest.raises(ValueError, match="re-iterable sequence"):
            simulate_streamed(iter(chunks), VERSION, **kw)

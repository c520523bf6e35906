"""Long runs in the port — `simulate(max_resident_epochs=)`,
`simulate_streamed`, `simulate_generated` — and
`scenarios/synthetic.py::random_subnet_scenario`, against the port's own
monolithic runs and the JAX package, on the CPU.

Contracts (the JAX package's tests/unit/test_streamed.py and
test_suffix_resume.py): a streamed run is bitwise the monolithic run of
the same stack on the same rung, for all nine versions, on the eager rung
and the plain versions of K2 and K3, with ragged slabs, a reset in a later
slab, the previous-weights carry, and slabs cut to the memory plan's
length; bitwise JAX's streamed `simulate` on built-in cases (where the
eager rung is bitwise JAX's XLA rung) and JAX's `simulate_generated`; a
JAX `final_state` resumes the port's run bitwise; the random subnet is
JAX's array for array.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yuma_simulation_tpu.models.config import YumaConfig as JConfig
from yuma_simulation_tpu.models.variants import canonical_versions as j_versions
from yuma_simulation_tpu.scenarios import create_case as j_create_case
from yuma_simulation_tpu.scenarios.synthetic import random_subnet_scenario as j_random_subnet
from yuma_simulation_tpu.simulation.engine import simulate as j_simulate
from yuma_simulation_tpu.simulation.engine import simulate_generated as j_simulate_generated
from yuma_simulation_tpu.telemetry.cost import HBMPreflightError as JHBMPreflightError
from yuma_simulation_tpu_torch.models.config import YumaConfig
from yuma_simulation_tpu_torch.models.variants import canonical_versions, variant_for_version
from yuma_simulation_tpu_torch.scenarios import create_case
from yuma_simulation_tpu_torch.scenarios.base import Scenario
from yuma_simulation_tpu_torch.scenarios.synthetic import random_subnet_scenario
from yuma_simulation_tpu_torch.simulation.engine import (
    simulate,
    simulate_generated,
    simulate_streamed,
    zero_carry,
)
from yuma_simulation_tpu_torch.telemetry.cost import DEVICE_SPEC_ENV, HBMPreflightError

IDS = [v for v, _ in canonical_versions()]
KEYS = ("dividends", "bonds", "incentives", "consensus")


def _random(E=12, V=5, M=8, seed=11, reset=(2, 7)):
    """A random scenario (numpy arrays) with a reset at epoch 7."""
    rng = np.random.default_rng(seed)
    W = rng.random((E, V, M)).astype(np.float32)
    W[W < 0.3] = 0.0
    S = (rng.random((E, V)) + 0.01).astype(np.float32)
    return Scenario(name="random", validators=[f"v{i}" for i in range(V)], base_validator="v0",
                    weights=W, stakes=S, num_epochs=E, reset_bonds_index=reset[0],
                    reset_bonds_epoch=reset[1])


def _equal(got, ref, what):
    for key in KEYS:
        a, b = getattr(got, key), getattr(ref, key)
        assert (a is None) == (b is None), (what, key)
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {key}")
    for key in ref.final_state or {}:
        np.testing.assert_array_equal(got.final_state[key], ref.final_state[key],
                                      err_msg=f"{what} final_state {key}")


@pytest.mark.parametrize("index", range(9), ids=IDS)
def test_streamed_bitwise_monolithic(index):
    """All nine versions on the eager rung and the plain K2 / K3: slabs of
    5 (ragged: 5, 5, 2; the reset at epoch 7 in the second), and of 1 on K3
    (tiles of one epoch), through `max_resident_epochs`, and hand-cut slabs
    [3, 6, 3] through
    `simulate_streamed`, each bitwise the monolithic run, final carry
    included."""
    version, params = canonical_versions()[index]
    cfg = YumaConfig(yuma_params=params)
    scen = _random()
    kw = dict(save_consensus=True, return_state=True, device="cpu")
    for impl in ("eager", "fused_scan", "fused_varying"):
        mono = simulate(scen, version, cfg, epoch_impl=impl, **kw)
        for cap in (5, 1) if impl == "fused_varying" else (5,):
            streamed = simulate(scen, version, cfg, epoch_impl=impl, max_resident_epochs=cap, **kw)
            assert streamed.engine == mono.engine == impl
            _equal(streamed, mono, f"{impl} max_resident_epochs={cap}")
        chunks = [(scen.weights[lo:hi], scen.stakes[lo:hi]) for lo, hi in ((0, 3), (3, 9), (9, 12))]
        hand = simulate_streamed(
            chunks, version, cfg, reset_bonds_index=2, reset_bonds_epoch=7, save_bonds=True,
            save_incentives=True, save_consensus=True, epoch_impl=impl, return_state=True,
            device="cpu",
        )
        _equal(hand, mono, f"{impl} chunks [3, 6, 3]")


def test_streamed_suffix_resume_and_tensor_chunks():
    """A stream resumed from a head run's `final_state` at its epoch offset
    continues the full run bitwise; chunks may be CPU tensors."""
    version = "Yuma 2 (Adrian-Fish)"
    scen = _random()
    full = simulate(scen, version, device="cpu")
    head = simulate(dataclasses.replace(scen, weights=scen.weights[:4], stakes=scen.stakes[:4],
                                        num_epochs=4), version, device="cpu", return_state=True)
    chunks = [(torch.tensor(scen.weights[lo:lo + 4]), torch.tensor(scen.stakes[lo:lo + 4]))
              for lo in (4, 8)]
    tail = simulate_streamed(chunks, version, reset_bonds_index=2, reset_bonds_epoch=7,
                             save_bonds=True, initial_state=head.final_state, epoch_offset=4,
                             device="cpu")
    np.testing.assert_array_equal(tail.dividends, full.dividends[4:])
    np.testing.assert_array_equal(tail.bonds, full.bonds[4:])


def test_slabs_cut_to_the_memory_plan(monkeypatch):
    """Under a device-spec override small enough that the plan caps slabs
    at 3 epochs, one 12-epoch chunk is cut to 3-epoch slabs and the run
    stays bitwise the monolithic one."""
    monkeypatch.setenv(DEVICE_SPEC_ENV, json.dumps({"name": "tiny", "memory_bytes": 2600}))
    from yuma_simulation_tpu_torch.simulation.planner import plan_dispatch

    plan = plan_dispatch("t", (12, 5, 8), "Yuma 1 (paper)", YumaConfig(), torch.float32,
                         streaming=True, device="cpu")
    assert plan.memory.chunk_epochs == 3
    scen = _random()
    with pytest.raises(HBMPreflightError, match=r"max_resident_epochs<=\d"):
        simulate(scen, "Yuma 1 (paper)", device="cpu")
    monkeypatch.delenv(DEVICE_SPEC_ENV)
    mono = simulate(scen, "Yuma 3.1 (Rhef+reset)", save_bonds=False, device="cpu")
    monkeypatch.setenv(DEVICE_SPEC_ENV, json.dumps({"name": "tiny", "memory_bytes": 2600}))
    cut = simulate_streamed([(scen.weights, scen.stakes)], "Yuma 3.1 (Rhef+reset)",
                            reset_bonds_index=2, reset_bonds_epoch=7, device="cpu")
    np.testing.assert_array_equal(cut.dividends, mono.dividends)


def test_preflight_error_matches_jax(monkeypatch):
    """An unfittable monolithic stack: the port's `simulate` raises JAX's
    HBMPreflightError message, before it builds a tensor."""
    monkeypatch.setenv(DEVICE_SPEC_ENV, json.dumps({"name": "tiny", "memory_bytes": 2000}))
    with pytest.raises(JHBMPreflightError) as ref:
        j_simulate(j_create_case("Case 3"), "Yuma 1 (paper)")
    with pytest.raises(HBMPreflightError) as got:
        simulate(create_case("Case 3"), "Yuma 1 (paper)", device="cpu")
    assert str(got.value) == str(ref.value)
    assert "max_resident_epochs<=" in str(got.value)


@pytest.fixture(scope="module")
def jax_streamed():
    """JAX's `simulate(max_resident_epochs=16, return_state=True)` of Cases
    3 and 10 for every version (its streamed XLA rung)."""
    out = {}
    for case in ("Case 3", "Case 10"):
        for version, params in j_versions():
            out[case, version] = j_simulate(j_create_case(case), version,
                                            JConfig(yuma_params=params),
                                            max_resident_epochs=16, return_state=True)
    return out


@pytest.mark.parametrize("case", ["Case 3", "Case 10"])
def test_max_resident_epochs_bitwise_jax(jax_streamed, case):
    """The port's streamed eager rung bitwise JAX's streamed XLA rung on
    built-in cases, all nine versions (slabs 16, 16, 8), and JAX's
    `final_state` of a head run resumes the port's run bitwise."""
    for version, params in canonical_versions():
        ref = jax_streamed[case, version]
        got = simulate(create_case(case), version, YumaConfig(yuma_params=params),
                       max_resident_epochs=16, return_state=True, device="cpu", x64=True)
        for key in ("dividends", "bonds", "incentives"):
            np.testing.assert_array_equal(getattr(got, key), np.asarray(getattr(ref, key)),
                                          err_msg=f"{case} {version} {key}")
        for key, value in ref.final_state.items():
            np.testing.assert_array_equal(got.final_state[key], np.asarray(value))
    version = "Yuma 2 (Adrian-Fish)"
    jcase = j_create_case(case)
    head = j_simulate(dataclasses.replace(jcase, weights=jcase.weights[:24],
                                          stakes=jcase.stakes[:24], num_epochs=24),
                      version, return_state=True)
    port_case = create_case(case)
    tail = simulate(dataclasses.replace(port_case, weights=port_case.weights[24:],
                                        stakes=port_case.stakes[24:], num_epochs=16),
                    version, initial_state={k: np.asarray(v) for k, v in head.final_state.items()},
                    epoch_offset=24, max_resident_epochs=5, device="cpu", x64=True)
    full = simulate(port_case, version, device="cpu", x64=True)
    np.testing.assert_array_equal(tail.dividends, full.dividends[24:])
    np.testing.assert_array_equal(tail.bonds, full.bonds[24:])


@pytest.mark.parametrize("version", ["Yuma 1 (paper) - liquid alpha on",
                                     "Yuma 2 (Adrian-Fish)", "Yuma 3 (Rhef)"])
def test_simulate_generated_bitwise_jax(version):
    """`simulate_generated` over three 4-epoch chunks of a random [5, 8]
    stack: bitwise JAX's `simulate_generated` (its XLA rung, the chunks
    sliced in the program), and bitwise the port's monolithic run."""
    scen = _random(reset=(None, None))
    Wj, Sj = jnp.asarray(scen.weights), jnp.asarray(scen.stakes)
    j_versions_map = dict(j_versions())
    ref_d, ref_b = j_simulate_generated(
        lambda i: (jax.lax.dynamic_slice_in_dim(Wj, i * 4, 4),
                   jax.lax.dynamic_slice_in_dim(Sj, i * 4, 4)),
        3, version, JConfig(yuma_params=j_versions_map[version]))
    Wt, St = torch.tensor(scen.weights), torch.tensor(scen.stakes)
    cfg = YumaConfig(yuma_params=dict(canonical_versions())[version])
    d, b = simulate_generated(lambda i: (Wt[i * 4:(i + 1) * 4], St[i * 4:(i + 1) * 4]), 3,
                              version, cfg, x64=True)
    np.testing.assert_array_equal(d, np.asarray(ref_d))
    np.testing.assert_array_equal(b, np.asarray(ref_b))
    mono = simulate(scen, version, cfg, device="cpu", x64=True, return_state=True)
    np.testing.assert_array_equal(d, mono.dividends)
    np.testing.assert_array_equal(b, mono.final_state["bonds"])


def test_random_subnet_scenario_bitwise_jax():
    for kw in (dict(seed=3, num_validators=3, num_miners=7, num_epochs=20),
               dict(seed=9, stake_concentration=0.5, name="x")):
        got, ref = random_subnet_scenario(**kw), j_random_subnet(**kw)
        for f in dataclasses.fields(Scenario):
            a, b = getattr(got, f.name), getattr(ref, f.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f.name


def test_refusals():
    scen = _random()
    version = "Yuma 1 (paper)"
    with pytest.raises(ValueError, match="must be True or False"):
        simulate_streamed([(scen.weights, scen.stakes)], version, save_bonds="auto",
                          device="cpu")
    with pytest.raises(ValueError, match="no chunks"):
        simulate_streamed([], version, device="cpu")
    with pytest.raises(ValueError, match=r"\[E_chunk, V, M\]"):
        simulate_streamed([(scen.weights[0], scen.stakes[0])], version, device="cpu")
    # The resilience arguments (slice 7) no longer raise: the ladder over a
    # stream and the watchdog around `simulate` return the plain run's bits.
    from yuma_simulation_tpu_torch.resilience import Deadline, RetryPolicy

    plain = simulate(scen, version, device="cpu")
    laddered = simulate_streamed([(scen.weights, scen.stakes)], version,
                                 retry_policy=RetryPolicy(), device="cpu")
    np.testing.assert_array_equal(laddered.dividends, plain.dividends)
    assert laddered.engine == "eager" and laddered.demotions is None
    watched = simulate(scen, version, deadline=Deadline(60.0), device="cpu")
    np.testing.assert_array_equal(watched.dividends, plain.dividends)
    # A miner-sharding mesh runs (tests/test_torch_mesh_miners.py), but not
    # streamed.
    from yuma_simulation_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="cannot be combined with a miner-sharding mesh"):
        simulate(scen, version, mesh=make_mesh(devices=["cpu"]), max_resident_epochs=1)
    with pytest.raises(ValueError, match="num_chunks"):
        simulate_generated(lambda i: None, 0, version)
    if not torch.cuda.is_available():
        # zero_carry defaults to the card, like every entry point.
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            zero_carry(variant_for_version(version), 3, 5)


class _At:
    """A stand-in for a CUDA event recorded at `ms` on the card's clock."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_stream_timeline_summary():
    """`StreamTimeline.summary` on a hand-made timeline: the copy time that
    ran while a scan ran is the intervals' intersection (copy 1 overlaps
    scan 0 for 2 ms), busy time their union, and a slab counts as hidden
    behind staging only where the host saw its scan end."""
    from yuma_simulation_tpu_torch.simulation.engine import StreamTimeline

    tl = StreamTimeline(fill_s=0.5, wait_s=0.25)
    assert tl.summary() == {}
    ev = {t: _At(t) for t in (10, 14, 15, 21, 19, 22, 25, 30)}
    tl.copies = [(ev[10], ev[14]), (ev[19], ev[22])]
    tl.scans = [(ev[15], ev[21]), (ev[25], ev[30])]
    tl.hidden = [True]
    got = tl.summary()
    assert got == dict(slabs=2, fill_s=0.5, wait_s=0.25, copy_ms=7, scan_ms=11,
                       copy_scan_overlap_ms=2, busy_ms=16, span_ms=20, hidden_slabs=1,
                       hidden_behind_staging_ms=10)

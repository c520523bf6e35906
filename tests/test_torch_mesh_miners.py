"""Miner-axis sharding of the port (`models/miner_shards.py`,
`simulate(mesh=)`, `simulate_constant(mesh=)`,
`parallel.shard_epoch_over_miners`, `plan_dispatch(mesh=)`) on CPU meshes,
against the port unsharded and against the JAX package's miner-sharded runs
over its 8-device CPU mesh, x64 as the other port tests.

Contracts: a sharded run is bitwise the port's unsharded eager run at 2, 4
and 8 shards (JAX's own "same program, same answer, any mesh"); against
JAX's sharded runs, within the reduction-order class of its XLA rung (atol
2e-6) at these shapes (M = 32 and 16 are past `xla_chains`, so they are
not among ROADMAP §C's bitwise shapes; the consensus on its u16 grid is
held bitwise, as the support and the quantize run on exact integers). The
refusals are JAX's: a model width not dividing 8, more than one shard over
`M % 8 != 0` or `M < 16`, streaming with a mesh, an explicit fused rung
with a mesh; the preflight counts the shards that share a device.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yuma_simulation_tpu.models.config import YumaConfig as JConfig
from yuma_simulation_tpu.models.config import YumaParams as JParams
from yuma_simulation_tpu.models.epoch import BondsMode as JBondsMode
from yuma_simulation_tpu.models.variants import variant_for_version as j_variant
from yuma_simulation_tpu.parallel import make_mesh as j_make_mesh
from yuma_simulation_tpu.parallel import shard_epoch_over_miners as j_shard_epoch
from yuma_simulation_tpu.scenarios.synthetic import random_subnet_scenario as j_random
from yuma_simulation_tpu.simulation.engine import simulate as j_simulate
from yuma_simulation_tpu.simulation.engine import simulate_constant as j_simulate_constant
from yuma_simulation_tpu_torch.models.config import YumaConfig, YumaParams
from yuma_simulation_tpu_torch.models.epoch import BondsMode, yuma_epoch
from yuma_simulation_tpu_torch.models.miner_shards import MinerLayout, MinerSharded
from yuma_simulation_tpu_torch.models.variants import variant_for_version
from yuma_simulation_tpu_torch.parallel import MeshDevice, make_mesh, shard_epoch_over_miners
from yuma_simulation_tpu_torch.scenarios.synthetic import random_subnet_scenario
from yuma_simulation_tpu_torch.simulation import plan_dispatch
from yuma_simulation_tpu_torch.simulation.engine import simulate, simulate_constant
from yuma_simulation_tpu_torch.telemetry.cost import DEVICE_SPEC_ENV, HBMPreflightError

ATOL = 2e-6  # the JAX package's reduction-order class against its XLA rung
STREAMS = ("dividends", "bonds", "incentives", "consensus")
#: test_multichip.py's four versions: liquid alpha exercises the
#: cross-shard quantile; Yuma 3 a reset.
VERSIONS = [
    ("Yuma 1 (paper) - liquid alpha on", dict(liquid_alpha=True)),
    ("Yuma 2 (Adrian-Fish)", {}),
    ("Yuma 3 (Rhef)", {}),
    ("Yuma 4 (Rhef+relative bonds) - liquid alpha on",
     dict(liquid_alpha=True, bond_alpha=0.025, alpha_high=0.99, alpha_low=0.9)),
]
IDS = ["yuma1-liquid", "yuma2", "yuma3", "yuma4-liquid"]


def _cpu_mesh(n: int):
    return make_mesh(data=1, model=n, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def scen():
    return random_subnet_scenario(11, num_validators=4, num_miners=32, num_epochs=40)


@pytest.mark.parametrize("version,params", VERSIONS, ids=IDS)
def test_sharded_simulate_bitwise_unsharded_and_jax(scen, version, params):
    cfg = YumaConfig(yuma_params=YumaParams(**params))
    ref = simulate(scen, version, cfg, save_consensus=True, device="cpu", x64=True)
    assert ref.engine == "eager"
    for shards in (2, 4, 8):
        got = simulate(scen, version, cfg, save_consensus=True, mesh=_cpu_mesh(shards), x64=True)
        assert got.engine == "eager"
        for name in STREAMS:
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                          err_msg=f"{version} x{shards}: {name}")
    jscen = j_random(11, num_validators=4, num_miners=32, num_epochs=40)
    np.testing.assert_array_equal(np.asarray(jscen.weights, np.float32),
                                  np.asarray(scen.weights, np.float32))
    jref = j_simulate(jscen, version, JConfig(yuma_params=JParams(**params)),
                      save_consensus=True, mesh=j_make_mesh(data=1, model=8))
    np.testing.assert_array_equal(got.consensus, np.asarray(jref.consensus))
    for name in ("dividends", "bonds", "incentives"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(jref, name)),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_sharded_run_carries_state_and_numerics(scen):
    """A sharded run's final state and numerics are the unsharded run's,
    and its state resumes a sharded suffix bitwise."""
    version = "Yuma 3 (Rhef)"
    ref = simulate(scen, version, device="cpu", return_state=True)
    got = simulate(scen, version, mesh=_cpu_mesh(4), return_state=True)
    for key, value in ref.final_state.items():
        np.testing.assert_array_equal(got.final_state[key], value, err_msg=key)
    for stream, sketch in ref.numerics.items():
        for field, value in vars(sketch).items():
            np.testing.assert_array_equal(getattr(got.numerics[stream], field), value)
    head = dataclasses.replace(scen, weights=scen.weights[:25], stakes=scen.stakes[:25],
                               num_epochs=25)
    tail = dataclasses.replace(scen, weights=scen.weights[25:], stakes=scen.stakes[25:],
                               num_epochs=15)
    first = simulate(head, version, mesh=_cpu_mesh(2), return_state=True)
    rest = simulate(tail, version, mesh=_cpu_mesh(8), initial_state=first.final_state,
                    epoch_offset=25)
    np.testing.assert_array_equal(rest.dividends, ref.dividends[25:])


@pytest.mark.parametrize("mode", ["EMA", "CAPACITY", "RELATIVE"])
def test_shard_epoch_over_miners_matches_jax(mode):
    rng = np.random.default_rng(5)
    W = rng.random((4, 16)).astype(np.float32)
    S = np.asarray([0.4, 0.3, 0.2, 0.1], np.float32)
    B = (rng.random((4, 16)) * (1e18 if mode == "CAPACITY" else 0.5)).astype(np.float32)
    out = shard_epoch_over_miners(W, S, B, YumaConfig(), mesh=_cpu_mesh(8),
                                  bonds_mode=BondsMode[mode])
    assert isinstance(out["server_consensus_weight"], MinerSharded)
    assert [tuple(s.shape) for s in out["weight"].shards] == [(4, 2)] * 8
    ref = yuma_epoch(torch.as_tensor(W), torch.as_tensor(S), torch.as_tensor(B),
                     YumaConfig(), bonds_mode=BondsMode[mode])
    jout = j_shard_epoch(W, S, B, JConfig(), mesh=j_make_mesh(data=1, model=8),
                         bonds_mode=JBondsMode[mode])
    for key, value in ref.items():
        got = out[key]
        got = got.numpy() if isinstance(got, MinerSharded) else got.numpy()
        np.testing.assert_array_equal(got, value.numpy(), err_msg=key)
    np.testing.assert_array_equal(out["server_consensus_weight"].numpy(),
                                  np.asarray(jout["server_consensus_weight"]))
    np.testing.assert_allclose(out["server_incentive"].numpy(),
                               np.asarray(jout["server_incentive"]), atol=ATOL, rtol=0)
    # Yuma 3's capacity bonds reach 1e18: its rewards are held relatively.
    np.testing.assert_allclose(out["validator_reward"].numpy(),
                               np.asarray(jout["validator_reward"]), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("hoist", [False, True], ids=["full", "hoisted"])
def test_sharded_simulate_constant(hoist):
    rng = np.random.default_rng(3)
    W = rng.random((4, 32)).astype(np.float32)
    S = np.asarray([0.5, 0.25, 0.15, 0.1], np.float32)
    for version in ("Yuma 1 (paper)", "Yuma 2 (Adrian-Fish)", "Yuma 3 (Rhef)",
                    "Yuma 4 (Rhef+relative bonds)"):
        spec = variant_for_version(version)
        total_ref, B_ref = simulate_constant(torch.as_tensor(W), torch.as_tensor(S), 40,
                                             YumaConfig(), spec, hoist_invariant=hoist)
        for shards in (2, 8):
            total, B = simulate_constant(torch.as_tensor(W), torch.as_tensor(S), 40,
                                         YumaConfig(), spec, hoist_invariant=hoist,
                                         mesh=_cpu_mesh(shards))
            np.testing.assert_array_equal(total.numpy(), total_ref.numpy(), err_msg=version)
            np.testing.assert_array_equal(B.numpy(), B_ref.numpy(), err_msg=version)
    jtotal, jB = j_simulate_constant(jnp.asarray(W), jnp.asarray(S), 40, JConfig(),
                                     j_variant("Yuma 4 (Rhef+relative bonds)"),
                                     hoist_invariant=hoist, mesh=j_make_mesh(data=1, model=8))
    np.testing.assert_allclose(total.numpy(), np.asarray(jtotal), atol=ATOL * 40, rtol=0)
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), atol=ATOL, rtol=0)


def test_refusals(scen):
    with pytest.raises(ValueError, match="mesh sizes dividing 8"):
        simulate(scen, "Yuma 1 (paper)", mesh=_cpu_mesh(3))
    with pytest.raises(ValueError, match="multiple of 8 and at least 16"):
        MinerLayout.build(["cpu"] * 2, 20)
    with pytest.raises(ValueError, match="multiple of 8 and at least 16"):
        MinerLayout.build(["cpu"] * 2, 8)
    assert MinerLayout.build(["cpu"], 20).width == 20  # one shard: any width
    small = random_subnet_scenario(2, num_validators=3, num_miners=8, num_epochs=4)
    with pytest.raises(ValueError, match="multiple of 8 and at least 16"):
        simulate(small, "Yuma 1 (paper)", mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="cannot be combined with a miner-sharding mesh"):
        simulate(scen, "Yuma 1 (paper)", mesh=_cpu_mesh(2), max_resident_epochs=8)
    with pytest.raises(ValueError, match="miner-axis sharding requires epoch_impl='eager'"):
        simulate(scen, "Yuma 1 (paper)", mesh=_cpu_mesh(2), epoch_impl="fused_varying")
    with pytest.raises(ValueError, match="mesh sizes dividing 8"):
        simulate_constant(torch.ones(4, 32), torch.ones(4), 2, mesh=_cpu_mesh(3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            simulate(scen, "Yuma 1 (paper)",
                     mesh=make_mesh(devices=[MeshDevice(i, torch.device("cuda", 0))
                                             for i in range(2)], model=2))


def test_plan_dispatch_with_mesh():
    plan = plan_dispatch("m", (16, 8, 64), "Yuma 1 (paper)", YumaConfig(), torch.float32,
                         mesh=_cpu_mesh(4), device="cuda")
    assert plan.engine == "eager" and plan.miner_shards == 4
    assert "auto->eager: miner-sharding mesh" in plan.reasons
    assert "miner axis sharded over 4 devices" in plan.reasons
    with pytest.raises(ValueError, match="single-device kernels"):
        plan_dispatch("m", (16, 8, 64), "Yuma 1 (paper)", YumaConfig(), torch.float32,
                      mesh=_cpu_mesh(4), epoch_impl="fused_scan", device="cuda")


def test_preflight_per_physical_device(monkeypatch):
    """Four shards on one device are held to that device's memory; the same
    four on four devices each hold a quarter. Nothing is allocated."""
    from yuma_simulation_tpu_torch.telemetry.cost import WORKING_SET_VM_BUFFERS

    V, M = 64, 4096
    shard_bytes = WORKING_SET_VM_BUFFERS * V * (M // 4) * 4
    # Capacity between one shard's working set and four shards'.
    monkeypatch.setenv(DEVICE_SPEC_ENV, f'{{"name": "tiny", "memory_bytes": {shard_bytes * 2}}}')
    W = torch.zeros(1, 1).expand(V, M)  # a view: no [V, M] buffer
    one = make_mesh(data=1, model=4,
                    devices=[MeshDevice(i, torch.device("cpu")) for i in range(4)])
    with pytest.raises(HBMPreflightError, match="simulate_constant"):
        simulate_constant(W, torch.ones(V), 2, mesh=one)
    layout = MinerLayout.build([torch.device("cpu")] * 4, M)
    assert layout.shards_per_device() == {torch.device("cpu"): 4}
    plan = plan_dispatch("m", (2, V, M), "Yuma 1 (paper)", YumaConfig(), torch.float32,
                         mesh=one, device="cpu", check_memory=False)
    assert plan.engine == "eager"
    with pytest.raises(HBMPreflightError):
        plan_dispatch("m", (2, V, M), "Yuma 1 (paper)", YumaConfig(), torch.float32,
                      mesh=one, device="cpu")
    # Unsharded, the whole working set is past the capacity too.
    with pytest.raises(HBMPreflightError, match="simulate_constant"):
        simulate_constant(W, torch.ones(V), 2)
    monkeypatch.setenv(DEVICE_SPEC_ENV, f'{{"name": "tiny", "memory_bytes": {shard_bytes * 8}}}')
    total, _ = simulate_constant(torch.rand(V, M), torch.ones(V), 1, mesh=one)
    assert total.shape == (V,)

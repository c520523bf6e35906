"""The port's grid sweeps and batched configs — `config_grid`,
`build_config_batch`, `sweepable_config_fields`, `sweep_hyperparams`,
`sweep_scaled_fused`, `total_dividends_batch` and the engine's
`zero_carry` / `config_is_batched` / `config_vmap_axes` — against the JAX
package on the CPU.

Contracts: every lane of a grid run bitwise the same point run alone with
a scalar config, on the eager rung and on the plain versions of K2, K3 and
K5 (the JAX package's tests/unit/test_sweep.py contract); grid results
within the JAX package's reduction-order class of its XLA rung (atol
2e-6, rtol 1e-5; CHANGES.md PR 15).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yuma_simulation_tpu.models.variants import variant_for_version as j_variant
from yuma_simulation_tpu.scenarios import create_case as j_create_case
from yuma_simulation_tpu.simulation import engine as j_engine
from yuma_simulation_tpu.simulation import sweep as j_sweep
from yuma_simulation_tpu_torch.models.config import (
    SimulationHyperparameters,
    YumaConfig,
    YumaParams,
)
from yuma_simulation_tpu_torch.models.variants import variant_for_version
from yuma_simulation_tpu_torch.scenarios import create_case, get_cases
from yuma_simulation_tpu_torch.simulation.engine import (
    config_is_batched,
    config_vmap_axes,
    simulate,
    simulate_scaled_batch,
    zero_carry,
)
from yuma_simulation_tpu_torch.simulation.sweep import (
    build_config_batch,
    config_grid,
    simulate_batch,
    stack_scenarios,
    sweep_hyperparams,
    sweep_scaled_fused,
    sweepable_config_fields,
    total_dividends_batch,
)

ATOL, RTOL = 2e-6, 1e-5
AXES = dict(bond_alpha=[0.025, 0.1], kappa=[0.5, 0.6], bond_penalty=[0.5, 1.0])


def _point_config(point, params=None):
    sim = {k: v for k, v in point.items() if k in ("kappa", "bond_penalty")}
    par = dict(params or {}, **{k: v for k, v in point.items() if k == "bond_alpha"})
    return YumaConfig(simulation=SimulationHyperparameters(**sim),
                      yuma_params=YumaParams(**par))


def test_config_grid_matches_jax():
    cfg, points = config_grid(**AXES)
    jcfg, jpoints = j_sweep.config_grid(**AXES)
    assert points == jpoints and len(points) == 8
    for part, jpart in ((cfg.simulation, jcfg.simulation), (cfg.yuma_params, jcfg.yuma_params)):
        for f in dataclasses.fields(part):
            value = getattr(part, f.name)
            if np.ndim(value):
                assert value.dtype == torch.float32 and value.shape == (8,)
                np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(jpart, f.name)))
    assert config_is_batched(cfg) and not config_is_batched(YumaConfig())
    axes = config_vmap_axes(cfg)
    assert axes.kappa == 0 and axes.liquid_alpha is None and axes.consensus_precision is None


def test_sweepable_fields_and_refusals_match_jax():
    args = (SimulationHyperparameters(), YumaParams())
    from yuma_simulation_tpu.models.config import SimulationHyperparameters as JSim
    from yuma_simulation_tpu.models.config import YumaParams as JParams

    assert sweepable_config_fields(*args) == j_sweep.sweepable_config_fields(JSim(), JParams())
    for name in ("liquid_alpha", "consensus_precision", "override_consensus_low", "nope"):
        with pytest.raises(ValueError, match="cannot sweep"):
            build_config_batch([{name: 1.0}])
    with pytest.raises(ValueError, match="at least one point"):
        build_config_batch([])


def test_zero_carry_matches_jax():
    for version in ("Yuma 1 (paper)", "Yuma 2 (Adrian-Fish)"):
        got = zero_carry(variant_for_version(version), 3, 5, device="cpu")
        ref = j_engine.zero_carry(j_variant(version), 3, 5, jnp.float32)
        assert set(got) == set(ref)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


GRID_VERSIONS = [
    ("Yuma 0 (subtensor)", {}),
    ("Yuma 1 (paper) - liquid alpha on", dict(liquid_alpha=True)),
    ("Yuma 3.1 (Rhef+reset)", {}),
    ("Yuma 4 (Rhef+relative bonds)", {}),
]


@pytest.mark.parametrize("epoch_impl", ["eager", "fused_scan", "fused_varying"])
@pytest.mark.parametrize("version,params", GRID_VERSIONS, ids=[v for v, _ in GRID_VERSIONS])
def test_grid_lanes_bitwise_solo(version, params, epoch_impl):
    """sweep_hyperparams: each lane bitwise simulate_batch of the same
    scenario alone with the point's scalar config (Case 4: a reset fires)."""
    case = create_case("Case 4")
    cfgs, points = config_grid(None, YumaParams(**params), **AXES)
    grid = sweep_hyperparams(case, version, cfgs, save_bonds=True, device="cpu",
                             epoch_impl=epoch_impl)
    W, S, ri, re_ = stack_scenarios([case], device="cpu")
    for i, point in enumerate(points):
        solo = simulate_batch(W, S, ri, re_, _point_config(point, params),
                              variant_for_version(version), save_bonds=True,
                              epoch_impl=epoch_impl)
        for key in ("dividends", "bonds"):
            assert torch.equal(grid[key][i], solo[key][0]), (i, key)


def _scaled_inputs(V=6, M=18, E=8):
    rng = np.random.default_rng(3)
    W = rng.random((V, M)).astype(np.float32)
    W[W < 0.3] = 0.0
    S = (rng.random(V) + 0.01).astype(np.float32)
    scales = (1.0 + 1e-4 * rng.random(E)).astype(np.float32)
    return W, S, scales


@pytest.mark.parametrize("epoch_impl", ["eager", "fused_scan"])
@pytest.mark.parametrize(
    "version,params",
    [("Yuma 1 (paper) - liquid alpha on", dict(liquid_alpha=True)),
     ("Yuma 2 (Adrian-Fish)", {}), ("Yuma 3 (Rhef)", {})],
    ids=["yuma1-liquid", "yuma2", "yuma3"],
)
def test_scaled_grid_lanes_bitwise_solo(version, params, epoch_impl):
    """sweep_scaled_fused: each lane bitwise simulate_scaled_batch of the
    scenario alone with the point's scalar config."""
    W, S, scales = (torch.tensor(x) for x in _scaled_inputs())
    cfgs, points = config_grid(None, YumaParams(**params), **AXES)
    spec = variant_for_version(version)
    tot, bonds = sweep_scaled_fused(W, S, scales, cfgs, version, epoch_impl=epoch_impl)
    for i, point in enumerate(points):
        t1, b1 = simulate_scaled_batch(W[None], S[None], scales, _point_config(point, params),
                                       spec, epoch_impl=epoch_impl)
        assert torch.equal(tot[i], t1[0]) and torch.equal(bonds[i], b1[0]), i


@pytest.mark.parametrize("epoch_impl", ["eager", "fused_varying"])
def test_sweep_hyperparams_matches_jax(epoch_impl):
    version = "Yuma 3.1 (Rhef+reset)"
    cfgs, _ = config_grid(**AXES)
    jcfgs, _ = j_sweep.config_grid(**AXES)
    ref = j_sweep.sweep_hyperparams(j_create_case("Case 4"), version, jcfgs, save_bonds=True)
    got = sweep_hyperparams(create_case("Case 4"), version, cfgs, save_bonds=True,
                            device="cpu", epoch_impl=epoch_impl, x64=True)
    for key in ("dividends", "bonds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=ATOL, rtol=RTOL,
                                   err_msg=key)


def test_sweep_scaled_fused_matches_jax():
    W, S, scales = _scaled_inputs()
    cfgs, _ = config_grid(**AXES)
    jcfgs, _ = j_sweep.config_grid(**AXES)
    ref = j_sweep.sweep_scaled_fused(jnp.asarray(W), jnp.asarray(S), jnp.asarray(scales), jcfgs,
                                     "Yuma 1 (paper)", epoch_impl="xla")
    for epoch_impl in ("eager", "fused_scan"):
        got = sweep_scaled_fused(torch.tensor(W), torch.tensor(S), torch.tensor(scales), cfgs,
                                 "Yuma 1 (paper)", epoch_impl=epoch_impl)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL,
                                       err_msg=epoch_impl)


def test_total_dividends_batch_matches_jax():
    cfgs, _ = config_grid(bond_penalty=[0.0, 0.5, 0.99, 1.0] * 3 + [0.5, 1.0])
    jcfgs, _ = j_sweep.config_grid(bond_penalty=[0.0, 0.5, 0.99, 1.0] * 3 + [0.5, 1.0])
    version = "Yuma 2 (Adrian-Fish)"
    for cfg, jcfg in ((None, None), (cfgs, jcfgs)):
        got = total_dividends_batch(get_cases(), version, cfg, device="cpu", x64=True)
        from yuma_simulation_tpu.scenarios import get_cases as j_get_cases

        ref = j_sweep.total_dividends_batch(j_get_cases(), version, jcfg)
        np.testing.assert_allclose(got, ref, atol=ATOL * 40, rtol=RTOL)
    # A suite of mixed shapes, donor-packed (pack_scenarios) onto one
    # masked batch on the eager rung: within the padded-suite tolerance of
    # JAX's (tests/unit/test_api_v1.py), rows as wide as the packed V.
    mixed = [create_case("Case 1"), create_case("Case 1")]
    mixed[1] = dataclasses.replace(mixed[1], weights=mixed[1].weights[:20],
                                   stakes=mixed[1].stakes[:20], num_epochs=20)
    j_mixed = [j_create_case("Case 1"), j_create_case("Case 1")]
    j_mixed[1] = dataclasses.replace(j_mixed[1], weights=j_mixed[1].weights[:20],
                                     stakes=j_mixed[1].stakes[:20], num_epochs=20)
    got = total_dividends_batch(mixed, version, device="cpu", x64=True)
    ref = j_sweep.total_dividends_batch(j_mixed, version)
    assert got.shape == np.shape(ref) == (2, 8)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)


def test_sweep_hyperparams_resumes_from_a_shared_carry():
    """A one-point grid resumed from a run's final_state at epoch 20
    continues that run bitwise."""
    case = create_case("Case 6")
    cfgs, points = config_grid(kappa=[0.55])
    cfg = _point_config(points[0])
    version = "Yuma 2 (Adrian-Fish)"
    full = simulate(case, version, cfg, device="cpu")
    head_case = dataclasses.replace(case, weights=case.weights[:20], stakes=case.stakes[:20],
                                    num_epochs=20)
    tail_case = dataclasses.replace(case, weights=case.weights[20:], stakes=case.stakes[20:],
                                    num_epochs=case.num_epochs - 20)
    head = simulate(head_case, version, cfg, device="cpu", return_state=True)
    tail = sweep_hyperparams(tail_case, version, cfgs, device="cpu",
                             initial_state=head.final_state, epoch_offset=20)
    np.testing.assert_array_equal(tail["dividends"][0].numpy(), full.dividends[20:])

"""K2 and K3 — the port's case scan and varying scan — against the JAX
package's Pallas `fused_case_scan` / `fused_varying_scan` (interpret mode
on the CPU), on identical numpy inputs. On CPU tensors the port's wrappers
run the kernels' plain PyTorch versions, which these tests pin.

Tolerances: quantized consensus EXACTLY equal; dividends, bonds and
incentives within atol 2e-6 and rtol 1e-5 (the JAX package's fused-vs-XLA
tolerance, tests/unit/test_fused_case_scan.py). The port's varying scan is
additionally held to its own case scan under the JAX package's varying
contract: consensus and incentives bitwise, dividends and bonds within
atol 1e-6. The JAX session runs with x64 on, so JAX's Yuma 0 quantizes in
double-single on the fused rungs and float64 on its XLA rung; the port's
`x64=True` (native float64) is held against both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yuma_simulation_tpu.models.config import YumaConfig as JConfig
from yuma_simulation_tpu.models.config import YumaParams as JParams
from yuma_simulation_tpu.models.variants import variant_for_version as j_variant
from yuma_simulation_tpu.ops.pallas_epoch import (
    fused_case_scan as j_case_scan,
    fused_varying_scan as j_varying_scan,
)
from yuma_simulation_tpu.scenarios.base import Scenario as JScenario
from yuma_simulation_tpu.simulation.engine import _simulate_scan as j_simulate_scan
from yuma_simulation_tpu.simulation.engine import simulate as j_simulate
from yuma_simulation_tpu_torch.convert import config_from_numpy, state_from_numpy
from yuma_simulation_tpu_torch.models.variants import variant_for_version
from yuma_simulation_tpu_torch.ops.cuda_epoch import fused_case_scan, fused_varying_scan
from yuma_simulation_tpu_torch.simulation.engine import _simulate_case_fused

ATOL, RTOL = 2e-6, 1e-5

VERSIONS = [
    ("Yuma 0 (subtensor)", {}),
    ("Yuma 1 (paper)", {}),
    ("Yuma 1 (paper) - liquid alpha on", dict(liquid_alpha=True)),
    ("Yuma 2 (Adrian-Fish)", {}),
    ("Yuma 3 (Rhef)", {}),
    ("Yuma 3.1 (Rhef+reset)", {}),
    ("Yuma 3.2 (Rhef+conditional)", {}),
    ("Yuma 4 (Rhef+relative bonds)", {}),
    (
        "Yuma 4 (Rhef+relative bonds) - liquid alpha on",
        dict(liquid_alpha=True, bond_alpha=0.025, alpha_high=0.99, alpha_low=0.9),
    ),
]
IDS = [v for v, _ in VERSIONS]

# Scenario 1's miner 3 builds bonds, then loses all weight from epoch 3:
# its consensus is exactly 0 before its reset epoch 5, so the CONDITIONAL
# rule fires there; scenario 0 resets (ALWAYS) at epoch 4; scenario 2 never.
RESET_INDEX = np.array([2, 3, -1], np.int32)
RESET_EPOCH = np.array([4, 5, -1], np.int32)


def _suite(seed=0, B=3, E=10, V=6, M=18):
    rng = np.random.default_rng(seed)
    W = rng.random((B, E, V, M)).astype(np.float32)
    W[1, 3:, :, 3] = 0.0
    S = (rng.random((B, E, V)) + 0.01).astype(np.float32)
    return W, S


def _kwargs(version, params):
    spec = variant_for_version(version)
    kw = dict(
        reset_mode=spec.reset_mode, mode=spec.bonds_mode,
        save_bonds=True, save_incentives=True, save_consensus=True,
    )
    jspec = j_variant(version)
    jkw = dict(kw, reset_mode=jspec.reset_mode, mode=jspec.bonds_mode)
    return dict(kw, **params), dict(jkw, **params)


def _assert_scan_match(got: dict, ref: dict, label: str, atol=ATOL, rtol=RTOL):
    for key in ref:
        g, r = got[key].numpy(), np.asarray(ref[key])
        assert g.shape == r.shape, (label, key, g.shape, r.shape)
        if key == "consensus":
            np.testing.assert_array_equal(g, r, err_msg=f"{label}: {key}")
        else:
            np.testing.assert_allclose(g, r, atol=atol, rtol=rtol, err_msg=f"{label}: {key}")


@pytest.mark.parametrize("version,params", VERSIONS, ids=IDS)
def test_case_scan_matches_jax(version, params):
    """The batched [3, ...] suite with firing resets, every version: the
    port's case scan against JAX's, and the port's varying scan at tiles
    2 and 5 against the same reference."""
    W, S = _suite()
    kw, jkw = _kwargs(version, params)
    ref = j_case_scan(
        jnp.asarray(W, jnp.float32), jnp.asarray(S, jnp.float32),
        reset_index=jnp.asarray(RESET_INDEX, jnp.int32),
        reset_epoch=jnp.asarray(RESET_EPOCH, jnp.int32),
        interpret=True, **jkw,
    )
    ri, re_ = torch.tensor(RESET_INDEX), torch.tensor(RESET_EPOCH)
    got = fused_case_scan(torch.tensor(W), torch.tensor(S), reset_index=ri,
                          reset_epoch=re_, x64=True, **kw)
    assert set(got) == set(ref)
    _assert_scan_match(got, ref, f"{version} case scan")
    for tile in (2, 5):
        var = fused_varying_scan(torch.tensor(W), torch.tensor(S), reset_index=ri,
                                 reset_epoch=re_, epoch_tile=tile, x64=True, **kw)
        _assert_scan_match(var, ref, f"{version} varying tile {tile}")
        for key in ("consensus", "incentives"):
            torch.testing.assert_close(var[key], got[key], rtol=0, atol=0)
        for key in ("dividends_normalized", "bonds", "final_bonds"):
            torch.testing.assert_close(var[key], got[key], rtol=0, atol=1e-6)


@pytest.mark.parametrize("tile", [2, 5])
@pytest.mark.parametrize(
    "version,params",
    [VERSIONS[2], VERSIONS[3], VERSIONS[6]],
    ids=[IDS[2], IDS[3], IDS[6]],
)
def test_varying_scan_matches_jax(version, params, tile):
    W, S = _suite(seed=1)
    kw, jkw = _kwargs(version, params)
    ref = j_varying_scan(
        jnp.asarray(W, jnp.float32), jnp.asarray(S, jnp.float32),
        reset_index=jnp.asarray(RESET_INDEX, jnp.int32),
        reset_epoch=jnp.asarray(RESET_EPOCH, jnp.int32),
        epoch_tile=tile, interpret=True, **jkw,
    )
    got = fused_varying_scan(
        torch.tensor(W), torch.tensor(S), reset_index=torch.tensor(RESET_INDEX),
        reset_epoch=torch.tensor(RESET_EPOCH), epoch_tile=tile, x64=True, **kw,
    )
    _assert_scan_match(got, ref, f"{version} tile {tile}")


@pytest.mark.parametrize(
    "version", ["Yuma 3.1 (Rhef+reset)", "Yuma 3.2 (Rhef+conditional)",
                "Yuma 4 (Rhef+relative bonds)"]
)
def test_reset_fires(version):
    """Scenario 1's reset genuinely zeroes its column at the reset epoch."""
    W, S = _suite()
    kw, _ = _kwargs(version, {})
    fired = fused_case_scan(torch.tensor(W), torch.tensor(S),
                            reset_index=torch.tensor(RESET_INDEX),
                            reset_epoch=torch.tensor(RESET_EPOCH), **kw)
    none = fused_case_scan(torch.tensor(W), torch.tensor(S), **kw)
    assert not torch.allclose(fired["bonds"][1, 5], none["bonds"][1, 5])
    torch.testing.assert_close(fired["bonds"][2], none["bonds"][2], rtol=0, atol=0)


@pytest.mark.parametrize("varying", [False, True], ids=["case", "varying"])
def test_yuma0_x64_matches_xla_float64_rung(varying):
    """Yuma 0 under x64: the port's native float64 quantize against JAX's
    XLA rung (float64), through the engine's fused call."""
    W, S = _suite(seed=2)
    version = "Yuma 0 (subtensor)"
    jys = j_simulate_scan(
        jnp.asarray(W[0], jnp.float32), jnp.asarray(S[0], jnp.float32),
        jnp.asarray(-1, jnp.int32), jnp.asarray(-1, jnp.int32),
        JConfig(), j_variant(version), save_consensus=True,
    )
    from yuma_simulation_tpu_torch.models.config import YumaConfig

    ys = _simulate_case_fused(
        torch.tensor(W[0]), torch.tensor(S[0]), -1, -1, YumaConfig(),
        variant_for_version(version), save_consensus=True, varying=varying, x64=True,
    )
    assert set(ys) == set(jys)
    _assert_scan_match(ys, jys, version)


@pytest.mark.parametrize("version", ["Yuma 2 (Adrian-Fish)", "Yuma 3.2 (Rhef+conditional)",
                                     "Yuma 1 (paper) - liquid alpha on"])
def test_carry_from_jax_state_continues_jax_run(version):
    """convert.state_from_numpy: JAX runs the first 6 epochs (XLA rung,
    return_state=True); the port's case scan continues from that carry at
    epoch_offset=6 and matches JAX's uninterrupted run over the rest."""
    rng = np.random.default_rng(4)
    E, V, M = 12, 6, 18
    W = rng.random((E, V, M)).astype(np.float32)
    W[4:, :, 3] = 0.0
    S = (rng.random((E, V)) + 0.01).astype(np.float32)
    params = dict(liquid_alpha=True) if "liquid" in version else {}
    jcfg = JConfig(yuma_params=JParams(**params))

    def scenario(lo, hi):
        return JScenario(
            name="carry", validators=[f"v{i}" for i in range(V)], base_validator="v0",
            weights=W[lo:hi], stakes=S[lo:hi], num_epochs=hi - lo,
            reset_bonds_index=3, reset_bonds_epoch=8,
        )

    full = j_simulate(scenario(0, E), version, jcfg, epoch_impl="xla", save_consensus=True)
    head = j_simulate(scenario(0, 6), version, jcfg, epoch_impl="xla", return_state=True)
    import dataclasses

    cfg = config_from_numpy(
        dataclasses.asdict(jcfg)["simulation"], dataclasses.asdict(jcfg)["yuma_params"]
    )
    carry = state_from_numpy(head.final_state, device="cpu")
    spec = variant_for_version(version)
    tail = fused_case_scan(
        torch.tensor(W[6:]), torch.tensor(S[6:]), reset_index=3, reset_epoch=8,
        reset_mode=spec.reset_mode, mode=spec.bonds_mode, save_consensus=True,
        carry=carry, epoch_offset=6, x64=True, kappa=cfg.kappa,
        bond_penalty=cfg.bond_penalty, bond_alpha=cfg.bond_alpha,
        capacity_alpha=cfg.capacity_alpha, decay_rate=cfg.decay_rate,
        liquid_alpha=cfg.liquid_alpha, alpha_low=cfg.alpha_low, alpha_high=cfg.alpha_high,
    )
    np.testing.assert_array_equal(tail["consensus"].numpy(), full.consensus[6:])
    np.testing.assert_allclose(tail["bonds"].numpy(), full.bonds[6:], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        tail["incentives"].numpy(), full.incentives[6:], atol=ATOL, rtol=RTOL
    )


def test_liquid_degenerate_spread_matches_jax():
    """Only 4 of 18 miners ever get weight: the 0.25 and 0.75 consensus
    quantiles coincide (both 0) and the fit falls back to the 0.99
    quantile. The scans test the spread on integer order statistics, the
    eager rung on the interpolated floats, each as its JAX counterpart."""
    rng = np.random.default_rng(6)
    E, V, M = 6, 6, 18
    W = np.zeros((E, V, M), np.float32)
    W[:, :, 14:] = rng.random((E, V, 4)).astype(np.float32)
    S = (rng.random((E, V)) + 0.01).astype(np.float32)
    version = "Yuma 1 (paper) - liquid alpha on"
    jspec, spec = j_variant(version), variant_for_version(version)
    ref = j_case_scan(jnp.asarray(W, jnp.float32), jnp.asarray(S, jnp.float32),
                      mode=jspec.bonds_mode, liquid_alpha=True, save_consensus=True,
                      interpret=True)
    got = fused_case_scan(torch.tensor(W), torch.tensor(S), mode=spec.bonds_mode,
                          liquid_alpha=True, save_consensus=True)
    assert (got["consensus"] > 0).sum(-1).max() <= 4
    _assert_scan_match(got, ref, "degenerate liquid, case scan")
    jys = j_simulate_scan(
        jnp.asarray(W, jnp.float32), jnp.asarray(S, jnp.float32),
        jnp.asarray(-1, jnp.int32), jnp.asarray(-1, jnp.int32),
        JConfig(yuma_params=JParams(liquid_alpha=True)), jspec, save_consensus=True,
    )
    from yuma_simulation_tpu_torch.models.config import YumaConfig, YumaParams
    from yuma_simulation_tpu_torch.simulation.engine import _simulate_scan

    ys = _simulate_scan(torch.tensor(W), torch.tensor(S), torch.tensor(-1), torch.tensor(-1),
                        YumaConfig(yuma_params=YumaParams(liquid_alpha=True)), spec,
                        save_consensus=True)
    _assert_scan_match(ys, jys, "degenerate liquid, eager rung")


def test_quantize_fallback_beyond_int32_grid_matches_jax():
    """Past the dyadic grid's int32 bound (M * 2^iters >= 2^31; here M=32
    at precision 2^26) the quantize denominator is a plain float sum: the
    port's scans hold to JAX's fused scan and the port's eager rung (its
    blocked miner_sum) to JAX's XLA rung, consensus bitwise on each side.
    Between the two sides of that fallback lies the one accepted drift
    (planner.py EXPECTED_DRIFT_U16_FALLBACK), so they are not compared."""
    W, S = _suite(seed=3, B=2, E=4, M=32)
    W, S = W[0], S[0]
    precision = 2**26
    version = "Yuma 1 (paper)"
    jspec, spec = j_variant(version), variant_for_version(version)
    ref = j_case_scan(jnp.asarray(W, jnp.float32), jnp.asarray(S, jnp.float32),
                      mode=jspec.bonds_mode, precision=precision, save_consensus=True,
                      interpret=True)
    got = fused_case_scan(torch.tensor(W), torch.tensor(S), mode=spec.bonds_mode,
                          precision=precision, save_consensus=True)
    _assert_scan_match(got, ref, "fallback, case scan")
    from yuma_simulation_tpu.models.config import SimulationHyperparameters as JSim
    from yuma_simulation_tpu_torch.models.config import SimulationHyperparameters, YumaConfig
    from yuma_simulation_tpu_torch.simulation.engine import _simulate_scan

    jys = j_simulate_scan(
        jnp.asarray(W, jnp.float32), jnp.asarray(S, jnp.float32),
        jnp.asarray(-1, jnp.int32), jnp.asarray(-1, jnp.int32),
        JConfig(simulation=JSim(consensus_precision=precision)), jspec, save_consensus=True,
    )
    ys = _simulate_scan(
        torch.tensor(W), torch.tensor(S), torch.tensor(-1), torch.tensor(-1),
        YumaConfig(simulation=SimulationHyperparameters(consensus_precision=precision)),
        spec, save_consensus=True,
    )
    _assert_scan_match(ys, jys, "fallback, eager rung")


@pytest.mark.parametrize("varying", [False, True], ids=["case", "varying"])
@pytest.mark.parametrize(
    "version,params", [VERSIONS[0], VERSIONS[2], VERSIONS[6], VERSIONS[8]],
    ids=[IDS[0], IDS[2], IDS[6], IDS[8]],
)
def test_mxu_scans_match_jax_mxu(version, params, varying):
    """K2 / K3 with the support on the tensor cores (K4's plain version
    here) against JAX's `mxu=True` scans: consensus bitwise, the rest
    within tolerance; and bitwise the port's own VPU scans."""
    W, S = _suite(seed=5)
    kw, jkw = _kwargs(version, params)
    jscan, scan = (j_varying_scan, fused_varying_scan) if varying else (j_case_scan, fused_case_scan)
    tile = dict(epoch_tile=5) if varying else {}
    ref = jscan(
        jnp.asarray(W, jnp.float32), jnp.asarray(S, jnp.float32),
        reset_index=jnp.asarray(RESET_INDEX, jnp.int32),
        reset_epoch=jnp.asarray(RESET_EPOCH, jnp.int32),
        mxu=True, interpret=True, **tile, **jkw,
    )
    ri, re_ = torch.tensor(RESET_INDEX), torch.tensor(RESET_EPOCH)
    got = scan(torch.tensor(W), torch.tensor(S), reset_index=ri, reset_epoch=re_,
               mxu=True, x64=True, **tile, **kw)
    _assert_scan_match(got, ref, f"{version} mxu")
    vpu = scan(torch.tensor(W), torch.tensor(S), reset_index=ri, reset_epoch=re_,
               x64=True, **tile, **kw)
    for key in got:
        torch.testing.assert_close(got[key], vpu[key], rtol=0, atol=0)


def test_simulate_mxu_rungs_bitwise_vpu_rungs():
    """`simulate(epoch_impl="fused_scan_mxu" | "fused_varying_mxu")` runs
    and is bitwise its VPU rung."""
    from yuma_simulation_tpu_torch.scenarios import create_case
    from yuma_simulation_tpu_torch.simulation.engine import simulate

    case = create_case("Case 4")
    for rung in ("fused_scan", "fused_varying"):
        vpu = simulate(case, "Yuma 2 (Adrian-Fish)", epoch_impl=rung, save_consensus=True,
                       device="cpu")
        mxu = simulate(case, "Yuma 2 (Adrian-Fish)", epoch_impl=rung + "_mxu",
                       save_consensus=True, device="cpu")
        assert mxu.engine == rung + "_mxu"
        for key in ("dividends", "bonds", "incentives", "consensus"):
            np.testing.assert_array_equal(getattr(mxu, key), getattr(vpu, key))


def test_scan_input_contract():
    W, S = _suite()
    with pytest.raises(ValueError, match="stakes must be"):
        fused_case_scan(torch.tensor(W), torch.tensor(S[:, :5]))
    with pytest.raises(ValueError, match="epoch_tile"):
        fused_varying_scan(torch.tensor(W), torch.tensor(S), epoch_tile=3)
    with pytest.raises(ValueError, match="carry must have exactly keys"):
        fused_case_scan(torch.tensor(W), torch.tensor(S), carry={"bonds": W[:, 0]})
    with pytest.raises(ValueError, match="float32"):
        fused_case_scan(torch.tensor(W).double(), torch.tensor(S).double())
    with pytest.raises(ValueError, match="V <= 2\\^14"):
        fused_case_scan(torch.zeros(1, 2**14 + 1, 2), torch.ones(1, 2**14 + 1), mxu=True)

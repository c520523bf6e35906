"""Padded suites of mixed shapes in the port — `pad_scenarios`, the miner
mask through `quantize_u16`, the liquid-alpha quantiles, the eager rung and
`simulate_batch(miner_mask=)`, and the chart suite's `_simulate_suite` —
against the JAX package on the CPU; and the chart CLI
(`cli/charts_table_generator.py`), which renders a one-case suite here so
that the chart tests' rendering is shared by two test workers.

Contracts: the padded tensors and the mask bitwise JAX's; the masked u16
quantize and the masked quantile bitwise JAX's jitted functions (XLA's CPU
backend contracts the quantile's interpolation into one FMA, which the port
spells with `ops/fma.py`); a padded suite un-padded per case within rtol
2e-5 / atol 2e-6 of JAX's and of the port's own per-case runs (the
tolerance of tests/unit/test_api_v1.py); a masked suite never reaches a
kernel; the CLI writes `simulation_results_b{beta}.html` with 4 chart rows
x 9 versions of images a case, and refuses before it simulates when
matplotlib or CUDA is missing.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yuma_simulation_tpu.models.config import (
    SimulationHyperparameters as JSim,
    YumaParams as JParams,
)
from yuma_simulation_tpu.ops import consensus as jc
from yuma_simulation_tpu.ops import liquid as jl
from yuma_simulation_tpu.scenarios import create_case as j_create_case
from yuma_simulation_tpu.scenarios.synthetic import random_subnet_scenario
from yuma_simulation_tpu.simulation.sweep import pack_scenarios as j_pack_scenarios
from yuma_simulation_tpu.simulation.sweep import pad_scenarios as j_pad_scenarios
from yuma_simulation_tpu.v1.api import _simulate_suite as j_simulate_suite
from tests.test_torch_charts import _images
from yuma_simulation_tpu_torch.cli.charts_table_generator import main
from yuma_simulation_tpu_torch.models.config import (
    SimulationHyperparameters,
    YumaConfig,
    YumaParams,
)
from yuma_simulation_tpu_torch.models.variants import variant_for_version
from yuma_simulation_tpu_torch.ops import consensus as tc
from yuma_simulation_tpu_torch.ops import liquid as tl
from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
from yuma_simulation_tpu_torch.scenarios.base import Scenario
from yuma_simulation_tpu_torch.simulation.engine import run_simulation
from yuma_simulation_tpu_torch.simulation.planner import plan_dispatch
from yuma_simulation_tpu_torch.simulation.sweep import (
    pack_scenarios,
    pad_scenarios,
    simulate_batch,
)
from yuma_simulation_tpu_torch.v1.api import _simulate_suite

#: tests/unit/test_api_v1.py's tolerance for a padded suite against per-case runs.
SUITE_RTOL, SUITE_ATOL = 2e-5, 2e-6
#: The liquid rate's float outputs: test_torch_ops.py's tolerance (see
#: test_masked_liquid_alpha_rate_matches_jax).
ATOL, RTOL = 2e-6, 1e-5
VERSIONS = ["Yuma 1 (paper)", "Yuma 3 (Rhef)", "Yuma 1 (paper) - liquid alpha on"]


def _port(scenario) -> Scenario:
    """The port's Scenario from a JAX package Scenario (the same fields)."""
    return Scenario(**{f.name: getattr(scenario, f.name) for f in dataclasses.fields(Scenario)})


def _mixed_suite():
    """Case 1 ([40, 3, 2]) and a [30, 5, 4] random subnet, as the JAX
    package's test_api_v1.py pads them, then Case 10 and a [20, 3, 7] one:
    every axis padded in some lane, and a lane with a reset."""
    return [
        j_create_case("Case 1"),
        random_subnet_scenario(7, num_validators=5, num_miners=4, num_epochs=30),
        j_create_case("Case 10"),
        random_subnet_scenario(3, num_validators=3, num_miners=7, num_epochs=20),
    ]


def test_pad_scenarios_bitwise_jax():
    suite = _mixed_suite()
    ours = pad_scenarios([_port(s) for s in suite], device="cpu")
    theirs = j_pad_scenarios(suite)
    assert [tuple(t.shape) for t in ours] == [(4, 40, 5, 7), (4, 40, 5), (4,), (4,), (4, 7)]
    for got, ref in zip(ours, theirs):
        assert got.dtype == (torch.int32 if got.ndim == 1 else torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # Donor packing: the suite on the planner's (8, 128) bucket, the JAX
    # package's pack_scenarios tensor for tensor.
    packed = pack_scenarios([_port(s) for s in suite], device="cpu")
    assert [tuple(t.shape) for t in packed] == [(4, 40, 8, 128), (4, 40, 8), (4,), (4,), (4, 128)]
    for got, ref in zip(packed, j_pack_scenarios(suite)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(pad_scenarios([_port(s) for s in suite], pack_tiles=True,
                                     device="cpu")[0], packed[0])


def _masked_rows(seed, B=4, M=37):
    """Quantized-consensus-like rows `[B, M]` on the u16 grid, with 5-20
    padded columns per row (holding values the mask must hide)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**17, (B, M))
    k[rng.random((B, M)) < 0.3] = 0
    C = (k * 2.0**-17).astype(np.float32)
    mask = np.ones((B, M), np.float32)
    for i, pad in enumerate(rng.integers(5, 21, B)):
        mask[i, M - pad:] = 0.0
    return C, mask


@pytest.mark.parametrize("seed", range(4))
def test_masked_quantize_bitwise_jax(seed):
    """`quantize_u16(miner_mask=)` bitwise JAX's jitted quantize (the u16
    divide as XLA compiles it), the padded columns zero, and each row's
    real columns bitwise the quantize of those columns alone: the mask
    keeps the padding out of the normalizing sum."""
    C, mask = _masked_rows(seed)
    got = tc.quantize_u16(torch.tensor(C), miner_mask=torch.tensor(mask), grid_bits=17)
    ref = jax.jit(lambda c, m: jc.quantize_u16(c, miner_mask=m, grid_bits=17))(
        jnp.asarray(C), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for i in range(len(C)):
        m = int(mask[i].sum())
        alone = tc.quantize_u16(torch.tensor(C[i, :m]), grid_bits=17)
        assert torch.equal(got[i, :m], alone)
        assert not got[i, m:].any()


def test_masked_quantile_bitwise_jax():
    """The masked quantile bitwise JAX's jitted `_masked_quantile` at q =
    0.25, 0.75 and 0.99 over 32 seeds of [4, 37] rows; the interpolation
    rounded twice (JAX run op by op) is off in some rows, so the FMA
    spelling is what makes it bitwise."""
    twice_differs = 0
    for seed in range(32):
        C, mask = _masked_rows(seed)
        for q in (0.25, 0.75, 0.99):
            got = tl._masked_quantile(torch.tensor(C), q, torch.tensor(mask)).numpy()
            ref = np.asarray(jax.jit(lambda c, m: jl._masked_quantile(c, q, m))(
                jnp.asarray(C), jnp.asarray(mask)))
            twice = np.asarray(jl._masked_quantile(jnp.asarray(C), q, jnp.asarray(mask)))
            np.testing.assert_array_equal(got, ref, err_msg=f"seed {seed} q {q}")
            twice_differs += int((twice != ref).sum())
    assert twice_differs > 0


@pytest.mark.parametrize("bounds", ["python", "tensor"])
@pytest.mark.parametrize("seed", range(4))
def test_masked_liquid_alpha_rate_matches_jax(seed, bounds):
    """`liquid_alpha_rate(miner_mask=)` against JAX's jitted function: the
    slope `a` (the masked quantiles' spread) and the intercept `b` (one
    FMA, ROADMAP §C, C2) bitwise; the rate within atol 2e-6 / rtol 1e-5.
    The reason for the tolerance: the port spells the exponent as XLA:CPU
    compiles it inside the jitted scan (`fma(k, -a * U16_INV, b)`, pinned
    bitwise on random suites by
    test_torch_simulate.py::test_random_epochs_bitwise_jax_xla_rung), and
    the function jitted alone lands in another fusion, which contracts it
    otherwise; its unmasked counterpart in test_torch_ops.py has the same
    tolerance. The quantiles themselves are bitwise
    (test_masked_quantile_bitwise_jax)."""
    C, mask = _masked_rows(seed)
    Q = tc.quantize_u16(torch.tensor(C), miner_mask=torch.tensor(mask), grid_bits=17)
    if bounds == "python":
        args_j, args_t = (0.7, 0.9), (0.7, 0.9)
    else:
        args_j = (jnp.float32(0.7), jnp.float32(0.9))
        args_t = (torch.tensor(0.7), torch.tensor(0.9))
    ref = jax.jit(lambda c, m: jl.liquid_alpha_rate(c, *args_j, miner_mask=m))(
        jnp.asarray(Q.numpy()), jnp.asarray(mask))
    got = tl.liquid_alpha_rate(Q, *args_t, miner_mask=torch.tensor(mask))
    rate, a, b = (x.numpy() for x in got)
    np.testing.assert_array_equal(a, np.asarray(ref[1]))
    np.testing.assert_array_equal(b, np.asarray(ref[2]))
    np.testing.assert_allclose(rate, np.asarray(ref[0]), atol=ATOL, rtol=RTOL)
    # The padded columns move nothing: each row alone, unmasked and cut to
    # its real miners, fits the same logistic within the same tolerance.
    for i in range(len(C)):
        m = int(mask[i].sum())
        alone, a_i, _ = tl.liquid_alpha_rate(Q[i, :m], *args_t)
        np.testing.assert_allclose(rate[i, :m], alone.numpy(), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(a[i], a_i.numpy(), atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def mixed_suites():
    """The JAX package's and the port's `_simulate_suite` of Case 1 plus a
    [30, 5, 4] random subnet at bond_penalty 0.99."""
    jax_suite = [
        j_create_case("Case 1"),
        random_subnet_scenario(7, num_validators=5, num_miners=4, num_epochs=30),
    ]
    ours = [_port(s) for s in jax_suite]
    hp = SimulationHyperparameters(bond_penalty=0.99)
    params = {v: YumaParams(liquid_alpha="liquid" in v) for v in VERSIONS}
    j_params = {v: JParams(liquid_alpha="liquid" in v) for v in VERSIONS}
    got = _simulate_suite(ours, [(v, params[v]) for v in VERSIONS], hp, device="cpu")
    ref = j_simulate_suite(jax_suite, [(v, j_params[v]) for v in VERSIONS],
                           JSim(bond_penalty=0.99))
    return ours, hp, params, got, ref


def _assert_outputs_close(got, ref, label):
    div, bonds, inc = got
    r_div, r_bonds, r_inc = ref
    assert list(div) == list(r_div), label
    for val in div:
        np.testing.assert_allclose(div[val], r_div[val], rtol=SUITE_RTOL, atol=SUITE_ATOL,
                                   err_msg=f"{label} {val}")
    assert len(bonds) == len(r_bonds) and len(inc) == len(r_inc), label
    np.testing.assert_allclose(np.asarray(bonds), np.asarray(r_bonds), rtol=SUITE_RTOL,
                               atol=SUITE_ATOL, err_msg=label)
    np.testing.assert_allclose(np.asarray(inc), np.asarray(r_inc), rtol=SUITE_RTOL,
                               atol=SUITE_ATOL, err_msg=label)


@pytest.mark.parametrize("version", VERSIONS)
def test_mixed_suite_matches_jax_and_per_case_runs(mixed_suites, version):
    """The padded suite, un-padded per case, against the JAX package's
    `_simulate_suite` and against the port's own per-case `run_simulation`
    (no padding), for Yuma 1, Yuma 3 and Yuma 1 with liquid alpha (the
    masked quantiles)."""
    ours, hp, params, got, ref = mixed_suites
    assert set(got) == set(ref) == {(i, v) for i in range(len(ours)) for v in VERSIONS}
    for i, case in enumerate(ours):
        E, V, M = case.weights.shape
        config, outputs = got[(i, version)]
        assert config == YumaConfig(simulation=hp, yuma_params=params[version])
        div, bonds, inc = outputs
        assert all(len(d) == E for d in div.values())
        assert bonds[0].shape == (V, M) and inc[0].shape == (M,)
        _assert_outputs_close(outputs, ref[(i, version)][1], f"{version} case {i} vs JAX")
        solo = run_simulation(case, version, config, device="cpu")
        _assert_outputs_close(outputs, solo, f"{version} case {i} vs per-case run")


@pytest.mark.parametrize("epoch_impl", ["fused_scan", "fused_varying", "fused_scan_mxu",
                                        "fused_varying_mxu"])
def test_miner_mask_refuses_the_fused_rungs(epoch_impl):
    W, S, ri, re_, mask = pad_scenarios([_port(s) for s in _mixed_suite()[:2]], device="cpu")
    with pytest.raises(ValueError, match="no per-scenario miner masks"):
        simulate_batch(W, S, ri, re_, YumaConfig(), variant_for_version("Yuma 1 (paper)"),
                       miner_mask=mask, epoch_impl=epoch_impl)


def test_miner_mask_runs_the_eager_rung():
    """"auto" with a mask is the eager rung, on CPU tensors and on the
    card alike (planned before any query of the device), with no kernel
    launched; the masked eager run is the same call with `epoch_impl=
    "eager"`, bitwise."""
    shape = (2, 40, 5, 4)
    for device in ("cpu", "cuda"):
        plan = plan_dispatch("padded", shape, "Yuma 1 (paper)", YumaConfig(), torch.float32,
                             has_miner_mask=True, check_memory=False, device=device)
        assert plan.engine == "eager"
        assert plan.reasons == ("auto->eager: per-scenario miner mask",)
    W, S, ri, re_, mask = pad_scenarios([_port(s) for s in _mixed_suite()[:2]], device="cpu")
    spec = variant_for_version("Yuma 1 (paper)")
    reset_launch_counts()
    auto = simulate_batch(W, S, ri, re_, YumaConfig(), spec, miner_mask=mask, save_bonds=True)
    assert not any(launch_counts().values()), launch_counts()
    eager = simulate_batch(W, S, ri, re_, YumaConfig(), spec, miner_mask=mask,
                           save_bonds=True, epoch_impl="eager")
    for key in ("dividends", "bonds"):
        assert torch.equal(auto[key].nan_to_num(), eager[key].nan_to_num()), key


def test_cli_writes_the_tables(tmp_path):
    """`--device cpu --bond-penalty 0.5 --cases "Case 1"` writes
    `simulation_results_b0.5.html` with 36 images (4 chart rows x 9
    versions), the drag-to-scroll table by default, and returns its wall
    seconds."""
    seconds = main(["--device", "cpu", "--bond-penalty", "0.5", "--cases", "Case 1",
                    "--out-dir", str(tmp_path)])
    assert list(seconds) == ["0.5"] and seconds["0.5"] > 0
    assert [p.name for p in tmp_path.iterdir()] == ["simulation_results_b0.5.html"]
    html = (tmp_path / "simulation_results_b0.5.html").read_bytes().decode("utf-8")
    srcs = _images(html)
    assert len(srcs) == 36
    assert all(s.startswith("data:image/png;base64,") for s in srcs)
    assert "document.addEventListener" in html


def test_cli_refuses_before_simulating(tmp_path, monkeypatch):
    """Without matplotlib the CLI raises a clear ImportError before it
    simulates or writes anything; without CUDA it asks for --device cpu."""
    import torch

    import yuma_simulation_tpu_torch.cli.charts_table_generator as cli

    def not_called(*args, **kwargs):
        raise AssertionError("simulated")

    monkeypatch.setattr(cli, "generate_chart_table", not_called)
    with monkeypatch.context() as patch:
        patch.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(ImportError, match="renders its charts with matplotlib"):
            main(["--device", "cpu", "--out-dir", str(tmp_path / "out")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--out-dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()

"""The port's whole slice — `simulate`, `run_simulation`, `simulate_batch`
— against the JAX package and the reference's golden CSV, on the CPU; and
the port's isolation from JAX.

Tolerances: quantized consensus EXACTLY equal to JAX's; dividends, bonds
and incentives within atol 2e-6 and rtol 1e-5 (the JAX package's
fused-vs-XLA tolerance); the golden CSV totals within 1.5e-6, the
reference CSV's own 6-decimal precision (tests/unit/test_fused_case_scan.py).
"""

import ast
import csv
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import GOLDEN_DIR
from yuma_simulation_tpu.models.config import YumaConfig as JConfig
from yuma_simulation_tpu.models.config import YumaParams as JParams
from yuma_simulation_tpu.scenarios import create_case as j_create_case
from yuma_simulation_tpu.scenarios.base import Scenario as JScenario
from yuma_simulation_tpu.simulation.engine import run_simulation as j_run_simulation
from yuma_simulation_tpu.simulation.engine import simulate as j_simulate
from yuma_simulation_tpu_torch.convert import config_from_numpy, state_from_numpy
from yuma_simulation_tpu_torch.models.config import (
    SimulationHyperparameters,
    YumaConfig,
    YumaParams,
)
from yuma_simulation_tpu_torch.models.variants import canonical_versions, variant_for_version
from yuma_simulation_tpu_torch.scenarios import create_case, get_cases
from yuma_simulation_tpu_torch.scenarios.base import Scenario
from yuma_simulation_tpu_torch.simulation.engine import plan_engine, run_simulation, simulate
from yuma_simulation_tpu_torch.simulation.sweep import simulate_batch, stack_scenarios

ATOL, RTOL = 2e-6, 1e-5
REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "yuma_simulation_tpu_torch"


def _random_scenarios(seed=7, E=12, V=6, M=18):
    rng = np.random.default_rng(seed)
    W = rng.random((E, V, M)).astype(np.float32)
    W[W < 0.25] = 0.0
    W[4:, :, 3] = 0.0
    S = (rng.random((E, V)) + 0.01).astype(np.float32)
    kw = dict(
        name="random", validators=[f"v{i}" for i in range(V)], base_validator="v0",
        weights=W, stakes=S, num_epochs=E, reset_bonds_index=3, reset_bonds_epoch=8,
    )
    return Scenario(**kw), JScenario(**kw)


@pytest.mark.parametrize(
    "epoch_impl", ["eager", "fused_scan", "fused_varying", "fused_scan_mxu", "fused_varying_mxu"]
)
@pytest.mark.parametrize(
    "version,params",
    [
        ("Yuma 0 (subtensor)", {}),
        ("Yuma 2 (Adrian-Fish)", {}),
        ("Yuma 3.2 (Rhef+conditional)", {}),
        ("Yuma 4 (Rhef+relative bonds) - liquid alpha on",
         dict(liquid_alpha=True, bond_alpha=0.025, alpha_high=0.99, alpha_low=0.9)),
    ],
    ids=["yuma0", "yuma2", "yuma32", "yuma4-liquid"],
)
def test_simulate_matches_jax(version, params, epoch_impl):
    scen, jscen = _random_scenarios()
    ref = j_simulate(jscen, version, JConfig(yuma_params=JParams(**params)),
                     save_consensus=True)
    got = simulate(scen, version, YumaConfig(yuma_params=YumaParams(**params)),
                   save_consensus=True, epoch_impl=epoch_impl, device="cpu", x64=True)
    assert got.engine == epoch_impl
    np.testing.assert_array_equal(got.consensus, ref.consensus)
    for key in ("dividends", "bonds", "incentives"):
        np.testing.assert_allclose(
            getattr(got, key), getattr(ref, key), atol=ATOL, rtol=RTOL,
            err_msg=f"{version} {epoch_impl}: {key}",
        )


def test_simulate_resume_continues_run():
    """return_state / initial_state / epoch_offset on each rung: a run
    resumed at epoch 6 matches the uninterrupted run."""
    scen, _ = _random_scenarios(seed=8)
    version = "Yuma 2 (Adrian-Fish)"

    def part(lo, hi):
        return Scenario(
            name="part", validators=scen.validators, base_validator="v0",
            weights=scen.weights[lo:hi], stakes=scen.stakes[lo:hi], num_epochs=hi - lo,
            reset_bonds_index=3, reset_bonds_epoch=8,
        )

    for impl in ("eager", "fused_scan", "fused_varying"):
        full = simulate(scen, version, epoch_impl=impl, device="cpu")
        head = simulate(part(0, 6), version, epoch_impl=impl, device="cpu", return_state=True)
        tail = simulate(part(6, 12), version, epoch_impl=impl, device="cpu",
                        initial_state=head.final_state, epoch_offset=6)
        np.testing.assert_allclose(tail.dividends, full.dividends[6:], atol=1e-7, rtol=0)
        np.testing.assert_allclose(tail.bonds, full.bonds[6:], atol=1e-7, rtol=0)


def test_run_simulation_matches_jax():
    for version in ("Yuma 1 (paper)", "Yuma 3.1 (Rhef+reset)"):
        jdiv, jbonds, jinc = j_run_simulation(j_create_case("Case 5"), version)
        div, bonds, inc = run_simulation(create_case("Case 5"), version, device="cpu", x64=True)
        assert list(div) == list(jdiv)
        for k in div:
            np.testing.assert_allclose(div[k], jdiv[k], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(np.stack(bonds), np.stack(jbonds), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(np.stack(inc), np.stack(jinc), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("epoch_impl", ["auto", "fused_varying"])
def test_simulate_batch_golden_surface_beta1(epoch_impl):
    """The reference CSV surface: 14 built-in cases x 9 versions at
    beta=1.0, each version one batched call, on the CPU rung `auto` picks
    (eager) and on the varying scan's plain version."""
    with open(os.path.join(GOLDEN_DIR, "total_dividends_b1.0_full.csv")) as f:
        golden = list(csv.DictReader(f))
    cases = get_cases()
    W, S, ri, re_ = stack_scenarios(cases, device="cpu")
    worst = 0.0
    for version, params in canonical_versions():
        cfg = YumaConfig(simulation=SimulationHyperparameters(bond_penalty=1.0),
                         yuma_params=params)
        ys = simulate_batch(W, S, ri, re_, cfg, variant_for_version(version),
                            epoch_impl=epoch_impl, x64=True)
        totals = ys["dividends"].double().sum(dim=1).numpy()
        for i in range(len(cases)):
            for j, std in enumerate(["Validator A", "Validator B", "Validator C"]):
                worst = max(worst, abs(totals[i, j] - float(golden[i][f"{std} - {version}"])))
    assert worst < 1.5e-6, worst


def test_plan_engine():
    cpu, f32 = torch.device("cpu"), torch.float32
    assert plan_engine("auto", "bisect", (40, 3, 2), f32, cpu) == "eager"
    assert plan_engine("fused_scan", "auto", (40, 3, 2), f32, cpu) == "fused_scan"
    assert plan_engine("fused_varying_mxu", "bisect", (40, 3, 2), f32, cpu) == (
        "fused_varying_mxu"
    )
    assert plan_engine("fused_scan_mxu", "bisect", (40, 3, 2), f32, cpu) == "fused_scan_mxu"
    # Past the dyadic grid's int32 bound (M * 2^17 >= 2^31) auto keeps to the
    # eager rung on the card too, as JAX's auto keeps to XLA; the gate comes
    # before any query of the device, so no GPU is needed here.
    cuda = torch.device("cuda")
    assert plan_engine("auto", "bisect", (4, 8, 16384), f32, cuda) == "eager"
    assert plan_engine("auto", "bisect", (4, 8, 64), f32, cuda, precision=2**26) == "eager"
    with pytest.raises(ValueError, match="bisect"):
        plan_engine("fused_scan_mxu", "sorted", (40, 3, 2), f32, cpu)
    with pytest.raises(ValueError, match="epoch_impl"):
        plan_engine("nope", "bisect", (40, 3, 2), f32, cpu)
    with pytest.raises(ValueError, match="bisect"):
        plan_engine("fused_scan", "sorted", (40, 3, 2), f32, cpu)
    with pytest.raises(ValueError, match="unknown consensus_impl"):
        plan_engine("auto", "atuo", (40, 3, 2), f32, cpu)


def test_config_from_numpy_round_trips_jax_config():
    jcfg = JConfig(yuma_params=JParams(liquid_alpha=True, override_consensus_low=0.01))
    d = dataclasses.asdict(jcfg)
    cfg = config_from_numpy(d["simulation"], d["yuma_params"])
    assert dataclasses.asdict(cfg) == d
    with pytest.raises(ValueError, match="bonds, consensus"):
        state_from_numpy({"bonds": np.zeros((2, 3))}, device="cpu")


def test_entry_points_refuse_to_fall_back_to_cpu():
    """Without device="cpu" the entry points need CUDA: on a box without
    it they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the refusal is what a CPU-only box shows")
    case = create_case("Case 1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulate(case, "Yuma 1 (paper)")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_simulation(case, "Yuma 1 (paper)")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stack_scenarios([case])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state_from_numpy({"bonds": np.zeros((3, 2)), "consensus": np.zeros(2)})


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax():
    """Every port module imports with `jax` made unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'yuma_simulation_tpu' or k.startswith('yuma_simulation_tpu.')"
        " for k in sys.modules)\n"
        "print('PORT_IMPORTS_OK')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "PORT_IMPORTS_OK" in out.stdout


def test_port_and_chip_smoke_import_no_jax_package():
    """A scan of every import statement in the port and chip_smoke.py:
    nothing of `jax` or of the JAX package `yuma_simulation_tpu`."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "yuma_simulation_tpu"), (path, name)

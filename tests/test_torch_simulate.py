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
from yuma_simulation_tpu_torch.simulation.engine import run_simulation, simulate
from yuma_simulation_tpu_torch.simulation.planner import plan_dispatch
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
    """The rung resolution, now the planner's (`plan_dispatch(...).engine`):
    the cases of the engine's former `plan_engine`, one for one."""
    cpu, f32 = torch.device("cpu"), torch.float32

    def engine(impl, consensus, shape, dev, precision=100_000):
        cfg = YumaConfig(simulation=SimulationHyperparameters(consensus_precision=precision))
        return plan_dispatch("t", shape, "Yuma 1 (paper)", cfg, f32, epoch_impl=impl,
                             consensus_impl=consensus, check_memory=False,
                             device=dev).engine

    assert engine("auto", "bisect", (40, 3, 2), cpu) == "eager"
    assert engine("fused_scan", "auto", (40, 3, 2), cpu) == "fused_scan"
    assert engine("fused_varying_mxu", "bisect", (40, 3, 2), cpu) == "fused_varying_mxu"
    assert engine("fused_scan_mxu", "bisect", (40, 3, 2), cpu) == "fused_scan_mxu"
    # Past the dyadic grid's int32 bound (M * 2^17 >= 2^31) auto keeps to the
    # eager rung on the card too, as JAX's auto keeps to XLA; planning is
    # host arithmetic, so no GPU is needed here.
    cuda = torch.device("cuda")
    assert engine("auto", "bisect", (4, 8, 16384), cuda) == "eager"
    assert engine("auto", "bisect", (4, 8, 64), cuda, precision=2**26) == "eager"
    with pytest.raises(ValueError, match="bisect"):
        engine("fused_scan_mxu", "sorted", (40, 3, 2), cpu)
    with pytest.raises(ValueError, match="epoch_impl"):
        engine("nope", "bisect", (40, 3, 2), cpu)
    with pytest.raises(ValueError, match="bisect"):
        engine("fused_scan", "sorted", (40, 3, 2), cpu)
    with pytest.raises(ValueError, match="unknown consensus_impl"):
        engine("auto", "atuo", (40, 3, 2), cpu)


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


# ---------------------------------------------------------------------------
# C1: the multiply-adds XLA's CPU backend fuses, and the port's exact FMA.


def _exact_f32(value):
    """A `fractions.Fraction` rounded once to the nearest float32 (ties to
    even), from the float32 neighbours of its float64 rounding."""
    from fractions import Fraction

    f = np.float32(float(value))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(
        cands,
        key=lambda c: (abs(Fraction(float(c)) - value), int(np.float32(c).view(np.int32)) & 1),
    )


def test_fma_rounds_once():
    """ops/fma.py::fma against exact rational arithmetic rounded once:
    random float32 triples over wide exponents, triples whose a*b + c
    lies next to a float32 halfway point (there a float64 sum rounded
    again to float32 goes the wrong way, which the test also checks
    happens), and triples whose a*b + c is a float32 subnormal.
    fma_chain is a left-to-right chain of them."""
    from fractions import Fraction

    from yuma_simulation_tpu_torch.ops.fma import fma, fma_chain

    rng = np.random.default_rng(0)
    n = 3000
    i = rng.integers(1, 1 << 10, n)
    sign = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    cases = {
        "random": (
            rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n),
            rng.standard_normal(n),
            rng.standard_normal(n) * 2.0 ** rng.integers(-40, 30, n),
        ),
        "halfway": (
            sign * (1.0 + i * 2.0**-23),
            2.0**-24 * (1.0 - i * 2.0**-23),
            sign * (1.0 + rng.integers(0, 1 << 23, n) * 2.0**-23),
        ),
        "subnormal": (
            rng.standard_normal(n) * 2.0**-70,
            rng.standard_normal(n) * 2.0**-60,
            rng.standard_normal(n) * 2.0**-131,
        ),
    }
    for name, arrays in cases.items():
        a, b, c = (x.astype(np.float32) for x in arrays)
        got = fma(torch.tensor(a), torch.tensor(b), torch.tensor(c)).numpy()
        want = np.array(
            [_exact_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
             for x, y, z in zip(a, b, c)],
            np.float32,
        )
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=name)
        if name == "halfway":
            twice = (a.astype(np.float64) * b + c).astype(np.float32)
            assert (twice.view(np.int32) != want.view(np.int32)).sum() > n // 10
    x, y = (rng.random((4, 7)).astype(np.float32) for _ in range(2))
    acc = torch.zeros(4)
    for k in range(7):
        acc = fma(torch.tensor(x[:, k]), torch.tensor(y[:, k]), acc)
    np.testing.assert_array_equal(fma_chain(torch.tensor(x), torch.tensor(y)).numpy(), acc.numpy())


@pytest.fixture(scope="module")
def xla_epochs():
    """JAX's XLA rung (what `simulate_batch(epoch_impl="auto")` runs on the
    CPU, the program that rendered the pinned CSVs) over the 14 built-in
    cases at bond_penalty 0.5: per-epoch dividends, bonds and incentives
    of each of the 9 versions."""
    from yuma_simulation_tpu.models.config import SimulationHyperparameters as JSim
    from yuma_simulation_tpu.models.variants import canonical_versions as j_versions
    from yuma_simulation_tpu.models.variants import variant_for_version as j_variant
    from yuma_simulation_tpu.scenarios import get_cases as j_get_cases
    from yuma_simulation_tpu.simulation.planner import plan_dispatch
    from yuma_simulation_tpu.simulation.sweep import simulate_batch as j_simulate_batch
    from yuma_simulation_tpu.simulation.sweep import stack_scenarios as j_stack

    import jax.numpy as jnp

    W, S, ri, re_ = j_stack(j_get_cases())
    out = []
    for version, params in j_versions():
        cfg = JConfig(simulation=JSim(bond_penalty=0.5), yuma_params=params)
        spec = j_variant(version)
        plan = plan_dispatch("check", W.shape, spec, cfg, jnp.float32, epoch_impl="auto",
                             check_memory=False)
        assert plan.engine == "xla", plan.engine
        ys = j_simulate_batch(W, S, ri, re_, cfg, spec, save_bonds=True,
                              save_incentives=True, epoch_impl="auto")
        out.append({k: np.asarray(ys[k]) for k in ("dividends", "bonds", "incentives")})
    return out


@pytest.mark.parametrize("epoch_impl", ["auto", "fused_varying"])
@pytest.mark.parametrize("index", range(9), ids=[v for v, _ in canonical_versions()])
def test_epochs_bitwise_jax_xla_rung(xla_epochs, index, epoch_impl):
    """Fault C1 closed: on the 14 built-in cases, per-epoch dividends,
    bonds and incentives of the eager rung (auto on the CPU) and of the
    varying scan's plain version are bitwise JAX's XLA rung, every
    version, with the multiply-adds XLA fuses spelled as exact FMAs."""
    version, params = canonical_versions()[index]
    cfg = YumaConfig(simulation=SimulationHyperparameters(bond_penalty=0.5),
                     yuma_params=params)
    W, S, ri, re_ = stack_scenarios(get_cases(), device="cpu")
    ys = simulate_batch(W, S, ri, re_, cfg, variant_for_version(version), save_bonds=True,
                        save_incentives=True, epoch_impl=epoch_impl, x64=True)
    for key, ref in xla_epochs[index].items():
        np.testing.assert_array_equal(ys[key].numpy(), ref, err_msg=f"{version} {key}")


def _random_batch(B=3, E=6, V=5, M=8, seed=5008):
    """A random `[B, E, V, M]` suite with resets, as numpy arrays."""
    rng = np.random.default_rng(seed)
    W = rng.random((B, E, V, M)).astype(np.float32)
    W[W < 0.3] = 0.0
    S = (rng.random((B, E, V)) + 0.01).astype(np.float32)
    return W, S, np.array([0, 1, 2], np.int32), np.array([3, 5, 100], np.int32)


def _xla_random(**shape):
    """JAX's XLA rung on `_random_batch(**shape)` at bond_penalty 0.5:
    per-epoch dividends, bonds and incentives of each of the 9 versions."""
    from yuma_simulation_tpu.models.config import SimulationHyperparameters as JSim
    from yuma_simulation_tpu.models.variants import canonical_versions as j_versions
    from yuma_simulation_tpu.models.variants import variant_for_version as j_variant
    from yuma_simulation_tpu.simulation.sweep import simulate_batch as j_simulate_batch

    import jax.numpy as jnp

    arrays = [jnp.asarray(x) for x in _random_batch(**shape)]
    out = []
    for version, params in j_versions():
        ys = j_simulate_batch(
            *arrays, JConfig(simulation=JSim(bond_penalty=0.5), yuma_params=params),
            j_variant(version), save_bonds=True, save_incentives=True, epoch_impl="auto",
        )
        out.append({k: np.asarray(ys[k]) for k in ("dividends", "bonds", "incentives")})
    return out


@pytest.fixture(scope="module")
def xla_random_epochs():
    """JAX's XLA rung on `_random_batch()` (odd V = 5, M = 8: inside
    ops/normalize.py::xla_chains)."""
    return _xla_random()


@pytest.fixture(scope="module", params=[(6, 5), (7, 2), (4, 8), (8, 2), (8, 5), (9, 2), (12, 2),
                                        (2, 5), (2, 8)],
                ids=["v6m5", "v7m2", "v4m8", "v8m2", "v8m5", "v9m2", "v12m2", "v2m5", "v2m8"])
def xla_random_epochs_shaped(request):
    """`(shape, JAX's XLA rung on _random_batch(V, M))` at more shapes of
    ROADMAP §C, C2: an even V (the plain scans' incentive sum); M = 2,
    where XLA's batched dot for the rank sums the first miner column's
    first 8 products plainly (ops/normalize.py::rank_sum), up to V = 8 and
    past it; V = 4 and 8, where XLA sums the dividends in one vector
    register (ops/normalize.py::fold_sum); and V = 8 with M = 5, where the
    EMA with a scalar rate fuses `rate * B_target` in the columns XLA's
    vector code takes four at a time (ops/normalize.py::ema_blend); and V
    = 2, where XLA sums the EMA modes' dividends as `D[0] + D[1]`
    (ops/normalize.py::EMA_FOLD_VALIDATORS) and the capacity modes' as the
    chain."""
    V, M = request.param
    return request.param, _xla_random(V=V, M=M)


@pytest.mark.parametrize("index", range(9), ids=[v for v, _ in canonical_versions()])
def test_dividend_chains_bitwise_jax_xla_rung(xla_random_epochs, index):
    """The dividend chains past the built-in cases: from the bonds and
    incentives JAX's XLA rung saves on a random [5, 8] suite, the port's
    `dividends` (each product fused into its miner chain, the total one
    chain over every (validator, miner) product, Yuma 4's a chain of
    S_n * D) gives that rung's per-epoch dividends bitwise."""
    from yuma_simulation_tpu_torch.models.epoch import dividends
    from yuma_simulation_tpu_torch.ops.normalize import normalize_stake
    from yuma_simulation_tpu_torch.simulation.engine import _dividends_per_1k

    ref = xla_random_epochs[index]
    version = canonical_versions()[index][0]
    St = torch.tensor(_random_batch()[1])
    rel = variant_for_version(version).bonds_mode.value == "relative"
    D, D_tot = dividends(torch.tensor(ref["bonds"]), torch.tensor(ref["incentives"]),
                         normalize_stake(St) if rel else None)
    cfg = YumaConfig(simulation=SimulationHyperparameters(bond_penalty=0.5))
    got = _dividends_per_1k(D / (D_tot + 1e-6), St, cfg)
    np.testing.assert_array_equal(got.numpy(), ref["dividends"], err_msg=version)


@pytest.mark.parametrize("index", range(9), ids=[v for v, _ in canonical_versions()])
def test_random_epochs_bitwise_jax_xla_rung(xla_random_epochs, index):
    """Inside ops/normalize.py::xla_chains on random data: the per-epoch
    dividends, bonds and incentives of the eager rung and of the varying
    scan's plain version on a random [5, 8] suite with resets are bitwise
    JAX's XLA rung (its reduces of products
    spelled as XLA's FMA chains, the rank's column sum among them), all
    nine versions: the two with liquid alpha through the fit as XLA:CPU
    compiles it (the quantile in float64 with one FMA, the intercept one
    FMA, the exponent on the u16 grid integers; ROADMAP §C, C2)."""
    version, params = canonical_versions()[index]
    cfg = YumaConfig(simulation=SimulationHyperparameters(bond_penalty=0.5),
                     yuma_params=params)
    for impl in ("eager", "fused_varying"):
        ys = simulate_batch(*(torch.tensor(x) for x in _random_batch()), cfg,
                            variant_for_version(version), save_bonds=True,
                            save_incentives=True, epoch_impl=impl, x64=True)
        for key, ref in xla_random_epochs[index].items():
            np.testing.assert_array_equal(ys[key].numpy(), ref,
                                          err_msg=f"{version} {impl} {key}")


@pytest.mark.parametrize("index", range(9), ids=[v for v, _ in canonical_versions()])
def test_random_epochs_shapes_bitwise_jax_xla_rung(xla_random_epochs_shaped, index):
    """C2's second half (ROADMAP §C), as far as it is closed: on random
    [6, 5], [7, 2], [4, 8], [8, 2], [8, 5], [9, 2], [12, 2], [2, 5] and
    [2, 8] suites with resets, the eager rung's and the varying scan's
    plain version's per-epoch outputs are bitwise JAX's XLA rung, all nine
    versions. (At V = 16 and V = 8 past M = 8, not yet.)"""
    (V, M), refs = xla_random_epochs_shaped
    version, params = canonical_versions()[index]
    cfg = YumaConfig(simulation=SimulationHyperparameters(bond_penalty=0.5),
                     yuma_params=params)
    for impl in ("eager", "fused_varying"):
        ys = simulate_batch(*(torch.tensor(x) for x in _random_batch(V=V, M=M)), cfg,
                            variant_for_version(version), save_bonds=True,
                            save_incentives=True, epoch_impl=impl, x64=True)
        for key, ref in refs[index].items():
            np.testing.assert_array_equal(ys[key].numpy(), ref,
                                          err_msg=f"[{V}, {M}] {version} {impl} {key}")

"""Monte-Carlo bridge: parameter distributions -> batched suites.

The port of the JAX package's `foundry/montecarlo.py`. It maps
**distributions over DSL/generator parameters** onto the carriers that
take suites:

- :func:`sample_params` draws seeded parameter dicts from declarative
  distributions (:class:`Uniform` / :class:`LogUniform` /
  :class:`IntRange` / :class:`Choice`), the JAX package's draws bitwise;
- :func:`montecarlo_suite` feeds each draw (plus a per-draw derived
  seed) to any spec/scenario builder — a DSL `ScenarioSpec` factory or
  an adversarial family — and compiles the resulting population;
- :func:`run_montecarlo` dispatches a suite down one carrier on `device`
  (the card unless told otherwise): the batched engine (`simulate_batch`,
  "auto": K3 on the card), the supervised tier (`SweepSupervisor.run_batch`,
  by default the eager rung under its quarantine guard) or the data-axis
  sharded path (`simulate_batch_sharded`). The fleet carrier waits for the
  fleet fabric (ROADMAP queue A, 9. Fleet fabric). Each route's per-lane
  dividends are bitwise the lane's solo run on the route's own rung; the
  routes agree bitwise where they land on one rung (every route on the
  CPU), and within the engines' atol 2e-6 where they do not (on the card,
  K3 against the eager rung; ROADMAP §C);
- :func:`montecarlo_config_batch` is the hyperparameter twin: a seeded
  sample over `YumaConfig` float fields as one batched config (+ its
  points list), the payload `SweepSupervisor.run_grid` takes.

Determinism contract: every draw derives from one integer seed via
`np.random.default_rng`; hosts coordinate by exchanging the SEED (and
the distribution spec), never the sample.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from yuma_simulation_tpu_torch.foundry.dsl import ScenarioSpec, compile_spec
from yuma_simulation_tpu_torch.scenarios.base import Scenario

# ------------------------------------------------------------ distributions


@dataclass(frozen=True)
class Uniform:
    lo: float
    hi: float

    def sample(self, rng: np.random.Generator):
        return float(rng.uniform(self.lo, self.hi))


@dataclass(frozen=True)
class LogUniform:
    lo: float
    hi: float

    def sample(self, rng: np.random.Generator):
        return float(
            np.exp(rng.uniform(np.log(self.lo), np.log(self.hi)))
        )


@dataclass(frozen=True)
class IntRange:
    lo: int
    hi: int  # inclusive

    def sample(self, rng: np.random.Generator):
        return int(rng.integers(self.lo, self.hi + 1))


@dataclass(frozen=True)
class Choice:
    values: tuple

    def sample(self, rng: np.random.Generator):
        return self.values[int(rng.integers(0, len(self.values)))]


def sample_params(
    distributions: dict, num_samples: int, seed: int
) -> list[dict]:
    """`num_samples` seeded draws from `{param: distribution}` (a plain
    value is treated as a constant). Deterministic in (distributions,
    num_samples, seed); draw i of a longer run equals draw i of a
    shorter one (one child RNG per draw, spawned in order)."""
    out = []
    for i in range(num_samples):
        rng = np.random.default_rng((seed, i))
        point = {}
        for name in sorted(distributions):
            dist = distributions[name]
            point[name] = (
                dist.sample(rng) if hasattr(dist, "sample") else dist
            )
        out.append(point)
    return out


def derived_seed(seed: int, index: int) -> int:
    """The per-draw integer seed handed to scenario builders — stable,
    collision-resistant (SeedSequence-hashed), exchangeable between
    hosts as plain ints."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


# ------------------------------------------------------------ suite builders


def montecarlo_specs(
    builder: Callable[..., ScenarioSpec],
    distributions: dict,
    num_samples: int,
    seed: int,
) -> tuple[list[ScenarioSpec], list[dict]]:
    """Sample `builder(seed=<derived>, **params)` spec draws. The
    builder is any callable returning a :class:`ScenarioSpec`."""
    points = sample_params(distributions, num_samples, seed)
    specs = [
        builder(seed=derived_seed(seed, i), **point)
        for i, point in enumerate(points)
    ]
    return specs, points


def montecarlo_suite(
    builder: Callable,
    distributions: dict,
    num_samples: int,
    seed: int,
) -> tuple[list[Scenario], list[dict]]:
    """Sample and MATERIALIZE a scenario population. `builder` may
    return a `ScenarioSpec` (compiled here), a `Scenario`, or an
    :class:`~.adversarial.AdversarialScenario` (unwrapped)."""
    points = sample_params(distributions, num_samples, seed)
    scenarios: list[Scenario] = []
    for i, point in enumerate(points):
        built = builder(seed=derived_seed(seed, i), **point)
        if isinstance(built, ScenarioSpec):
            scenarios.append(compile_spec(built))
        elif isinstance(built, Scenario):
            scenarios.append(built.validate())
        elif hasattr(built, "scenario"):
            scenarios.append(built.scenario)
        else:
            raise TypeError(
                "montecarlo builder must return a ScenarioSpec, "
                f"Scenario, or AdversarialScenario, got {type(built)!r}"
            )
    return scenarios, points


def montecarlo_config_batch(
    distributions: dict, num_samples: int, seed: int, **base
):
    """A seeded Monte-Carlo sample over `YumaConfig` FLOAT fields as one
    batched config + its points list — the `SweepSupervisor.run_grid`
    payload (config_grid's cartesian twin, with distributions for axes).
    Static fields (`liquid_alpha`, overrides) cannot be sampled — they
    select different compiled programs; set them via `base`
    (`simulation=` / `yuma_params=`)."""
    from yuma_simulation_tpu_torch.simulation.sweep import build_config_batch

    base_simulation = base.pop("simulation", None)
    base_params = base.pop("yuma_params", None)
    if base:
        raise ValueError(f"unknown base config fields: {sorted(base)}")
    points = sample_params(distributions, num_samples, seed)
    # build_config_batch owns the static-field exclusion and the f32
    # leaf stacking — one source of truth with config_grid.
    return build_config_batch(points, base_simulation, base_params), points


# ------------------------------------------------------------------ carriers


def run_montecarlo(
    scenarios: Sequence[Scenario],
    yuma_version: str,
    config=None,
    *,
    route: str = "batch",
    mesh=None,
    fleet=None,
    supervisor=None,
    pack: bool = False,
    device="cuda",
) -> dict:
    """Dispatch a generated suite down one carrier.

    `route`:
      - ``"batch"`` — one batched engine dispatch on `device`
        (`simulate_batch`; same-shaped suites stack, heterogeneous suites,
        or `pack=True`, donor-pack onto the eager rung);
      - ``"supervised"`` — the single-host resilience tier
        (:meth:`..resilience.supervisor.SweepSupervisor.run_batch`) on
        `device`;
      - ``"sharded"`` — the data-axis sharded path
        (:func:`..parallel.sharded.simulate_batch_sharded`; needs `mesh`,
        whose devices it runs on);
      - ``"fleet"`` — this process's share of a fleet sweep over the
        store `fleet` (:func:`..fabric.scheduler.run_fleet_batch`): each
        unit through `supervisor` (default: a fresh
        :class:`..resilience.supervisor.SweepSupervisor`, whose quarantine
        default lands it on the eager rung) on `device`.

    Returns the carrier's own dict with `"dividends"` (a numpy `[B, E, V]`)
    always present. Each lane is bitwise its solo run on the rung its
    route lands on."""
    scenarios = list(scenarios)
    if route == "batch":
        from yuma_simulation_tpu_torch.models.config import YumaConfig
        from yuma_simulation_tpu_torch.models.variants import variant_for_version
        from yuma_simulation_tpu_torch.simulation.sweep import (
            pack_scenarios,
            simulate_batch,
            stack_scenarios,
        )

        config = config if config is not None else YumaConfig()
        spec = variant_for_version(yuma_version)
        same_shape = len({s.weights.shape for s in scenarios}) == 1
        if same_shape and not pack:
            W, S, ri, re = stack_scenarios(scenarios, device=device)
            ys = simulate_batch(W, S, ri, re, config, spec)
        else:
            W, S, ri, re, mask = pack_scenarios(scenarios, device=device)
            ys = simulate_batch(W, S, ri, re, config, spec, miner_mask=mask)
        return {"dividends": ys["dividends"].cpu().numpy()}
    if route == "supervised":
        from yuma_simulation_tpu_torch.resilience.supervisor import SweepSupervisor

        sup = supervisor if supervisor is not None else SweepSupervisor(directory=None)
        return sup.run_batch(scenarios, yuma_version, config, pack=pack, device=device)
    if route == "sharded":
        if mesh is None:
            raise ValueError("route='sharded' needs mesh=")
        from yuma_simulation_tpu_torch.parallel.sharded import simulate_batch_sharded

        return simulate_batch_sharded(scenarios, yuma_version, config, mesh=mesh)
    if route == "fleet":
        if fleet is None:
            raise ValueError("route='fleet' needs fleet= (a store dir)")
        from yuma_simulation_tpu_torch.fabric.scheduler import run_fleet_batch

        return run_fleet_batch(
            scenarios, yuma_version, fleet, config=config,
            supervisor=supervisor, device=device,
        )
    raise ValueError(
        f"unknown route {route!r} "
        "(want batch | supervised | sharded | fleet)"
    )

"""The scenario foundry: generated workloads, as dense Scenarios.

The port of the JAX package's `foundry/`. Everything compiles down to the
one dense `Scenario` representation (`weights[E, V, M]` / `stakes[E, V]`)
the planner and every engine rung take:

- :mod:`.dsl` — the declarative scenario DSL: frozen, serializable
  primitives (stake trajectories, weight schedules, epoch events)
  combined by `sequence`/`overlay`/`at_epochs` into a `ScenarioSpec`,
  compiled deterministically by `compile_spec`;
- :mod:`.metagraph` — Bittensor metagraph snapshot ingestion (JSON/npz)
  and deterministic synthetic snapshots at the real-subnet shape
  V=256 x M=4096;
- :mod:`.adversarial` — weight-copying, collusion cartels, stake-churn
  shocks and validator takeover as parameterized generated families,
  each paired with a property helper on dividend outcomes;
- :mod:`.montecarlo` — distributions over generator parameters as
  batched suites on `simulate_batch`, `SweepSupervisor` and
  `simulate_batch_sharded`.

The generators are numpy, bitwise the JAX package's on the same seeds
(tests/test_torch_foundry.py); whatever simulates runs on the card unless
given ``device="cpu"``.

``python -m yuma_simulation_tpu_torch.foundry --drill --bundle-dir DIR``
runs a seeded generated-suite supervisor drill into a flight bundle.
"""

from yuma_simulation_tpu_torch.foundry.adversarial import (  # noqa: F401
    CARTEL_INCENTIVE_FLOOR_PER_EPOCH,
    LIQUID_ALPHA_VERSIONS,
    AdversarialScenario,
    cartel_miner_incentive,
    cartel_scenario,
    copier_dividend_gap,
    liquid_config,
    stake_churn_scenario,
    takeover_scenario,
    total_dividends,
    weight_copier_scenario,
)
from yuma_simulation_tpu_torch.foundry.dsl import (  # noqa: F401
    BondReset,
    Clause,
    CopyWithLag,
    NoisyConsensusFollower,
    OneHot,
    Rows,
    ScenarioSpec,
    SpecError,
    StakeDrift,
    Stakes,
    Takeover,
    at_epochs,
    builtin_case_specs,
    compile_spec,
    overlay,
    sequence,
    spec_from_dict,
    spec_from_json,
    spec_key,
    spec_to_dict,
    spec_to_json,
)
from yuma_simulation_tpu_torch.foundry.metagraph import (  # noqa: F401
    MetagraphSnapshot,
    SnapshotError,
    load_metagraph_snapshot,
    save_metagraph_snapshot,
    scenario_from_snapshot,
    synthetic_snapshot,
)
from yuma_simulation_tpu_torch.foundry.montecarlo import (  # noqa: F401
    Choice,
    IntRange,
    LogUniform,
    Uniform,
    derived_seed,
    montecarlo_config_batch,
    montecarlo_specs,
    montecarlo_suite,
    run_montecarlo,
    sample_params,
)

"""The epoch-loop engines and the reference-compatible driver API."""

from yuma_simulation_tpu_torch.simulation.engine import (  # noqa: F401
    SimulationResult,
    config_is_batched,
    config_vmap_axes,
    run_simulation,
    simulate,
    simulate_constant,
    simulate_scaled,
    simulate_generated,
    simulate_scaled_batch,
    simulate_streamed,
    zero_carry,
)
from yuma_simulation_tpu_torch.simulation.sweep import (  # noqa: F401
    build_config_batch,
    config_grid,
    pack_scenarios,
    pad_scenarios,
    simulate_batch,
    stack_scenarios,
    sweep_hyperparams,
    sweep_scaled_fused,
    sweepable_config_fields,
    total_dividends_batch,
)
from yuma_simulation_tpu_torch.simulation.planner import (  # noqa: F401
    DispatchPlan,
    plan_dispatch,
)

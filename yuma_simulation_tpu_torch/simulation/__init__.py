"""The epoch-loop engines and the reference-compatible driver API."""

from yuma_simulation_tpu_torch.simulation.engine import (  # noqa: F401
    SimulationResult,
    run_simulation,
    simulate,
    simulate_constant,
    simulate_scaled,
    simulate_scaled_batch,
)
from yuma_simulation_tpu_torch.simulation.sweep import (  # noqa: F401
    simulate_batch,
    stack_scenarios,
)

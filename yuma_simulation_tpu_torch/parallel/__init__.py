"""Scale-out: device meshes, scenario-batch sharding and the Monte-Carlo
drivers (the JAX package's `parallel/`).

The scenario batch ("data" axis) is embarrassingly parallel: each data
shard runs its lanes on its own device with no collective, and the
outputs are gathered on the host (:func:`simulate_batch_sharded`,
:func:`montecarlo_total_dividends`). The miner axis ("model") splits the
`[V, M]` state of one scenario into column shards
(:func:`shard_epoch_over_miners`, ``simulate(mesh=)``,
``simulate_constant(mesh=)``; :mod:`..models.miner_shards`).
"""

from yuma_simulation_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    DistributedInitError,
    Mesh,
    MeshDegradation,
    MeshDevice,
    initialize_distributed,
    make_hybrid_mesh,
    make_mesh,
    surviving_members,
    surviving_mesh,
)
from yuma_simulation_tpu_torch.parallel.sharded import (  # noqa: F401
    montecarlo_per_epoch_batched,
    montecarlo_total_dividends,
    shard_epoch_over_miners,
    simulate_batch_sharded,
)

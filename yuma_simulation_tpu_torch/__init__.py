"""yuma_simulation_tpu_torch — the PyTorch/CUDA port of yuma_simulation_tpu.

The same Yuma-consensus simulator, for one NVIDIA H100: plain tensor code
in PyTorch, and the JAX package's Pallas kernels rewritten by hand in CUDA
C++ for `sm_90a` (:mod:`.ops.cuda_consensus`, :mod:`.ops.cuda_epoch`,
sources under `csrc/`), with one kernel of its own, the Monte-Carlo
weight slab (:mod:`.ops.cuda_random`). The entry points are in
:mod:`.simulation` (`simulate`, `simulate_streamed`, `simulate_generated`,
`simulate_batch`, `simulate_scaled`, `simulate_scaled_batch`,
`simulate_constant`, `run_simulation`), each planned by
:func:`.simulation.plan_dispatch`, and in :mod:`.parallel`
(`simulate_batch_sharded`, `montecarlo_per_epoch_batched`,
`montecarlo_total_dividends`, whose draws are JAX's threefry,
:mod:`.random`). They run on the card unless the caller passes
`device="cpu"` (or, for the tensor entry points, CPU tensors); on CPU
tensors every kernel wrapper runs its plain PyTorch version instead.
Each case-scan result carries per-epoch numerics sketches, bitwise the JAX
package's (:mod:`.telemetry.numerics`), and the JAX package's telemetry
core (spans, records, metrics, profiler ranges) is in :mod:`.telemetry`
and :mod:`.utils`.
"""

__version__ = "0.1.0"

from yuma_simulation_tpu_torch.models.config import (  # noqa: F401
    SimulationHyperparameters,
    YumaConfig,
    YumaParams,
    YumaSimulationNames,
)

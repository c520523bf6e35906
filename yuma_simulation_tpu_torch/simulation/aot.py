"""The kernel-library cache under the JAX package's AOT names.

The counterpart of the JAX package's `simulation/aot.py`. There, each
planner rung is a program exported per shape bucket and cached on disk, so
that a second process skips the XLA compile. Here a rung is a set of CUDA
libraries built by `nvcc` (`ops/_build.py`), and a library is
shape-generic: one build serves every shape. So the cache is `_build.py`'s
content-addressed build directory, keyed by program and environment, and
this module is its surface under JAX's names: :data:`EXECUTABLE_CACHE_ENV`
(the existing ``YUMA_TORCH_BUILD_DIR``), :func:`environment_descriptor`,
:class:`AotStats`, :class:`ExecutableCache` (typed absent / torn / corrupt /
stale lookups), :func:`configure_executable_cache`,
:func:`deactivate_executable_cache`, :func:`active_cache` and
:func:`process_stats`, plus the plan-level :func:`executable_for_plan` and
:func:`preload_shapes`.

There is no per-dispatch seam (JAX's ``dispatch_via_cache``): the first
launch of a rung in a process loads its libraries through the cache, and
every later launch is a dictionary lookup.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from yuma_simulation_tpu_torch.ops import _build
from yuma_simulation_tpu_torch.ops._build import (  # noqa: F401  (the surface)
    EXECUTABLE_CACHE_ENV,
    STATS_FILENAME,
    AotStats,
    ExecutableCache,
    active_cache,
    configure_executable_cache,
    deactivate_executable_cache,
    environment_descriptor,
    process_stats,
)

#: The library the fused case-scan rungs launch (K2, K3, and K4 under the
#: `_mxu` twins; the headers are part of its digest).
CASE_SCAN_SOURCE = "case_scan.cu"


@dataclasses.dataclass
class AotExecutable:
    """One rung resolved on the card: ``call(W, S, reset_index,
    reset_epoch, config)`` runs it. ``fingerprint`` is the digest of the
    library it launches; ``source`` is "built" when resolving it compiled
    a library in this process, else "cache"."""

    call: Callable
    fingerprint: str
    source: str
    label: str

    def describe(self) -> dict:
        return {"fingerprint": self.fingerprint, "source": self.source, "label": self.label}


def executable_for_plan(
    plan,
    yuma_version: str = "Yuma 1 (paper)",
    *,
    cache: Optional[ExecutableCache] = None,
    save_bonds: bool = False,
    save_incentives: bool = False,
) -> Optional[AotExecutable]:
    """Resolve the libraries of `plan`'s rung through `cache` (default:
    the active one), building what is missing, and return the rung as an
    :class:`AotExecutable`. None for a plan that launches no library: the
    eager rung, or a plan for the CPU. A failed build raises."""
    from yuma_simulation_tpu_torch.models.variants import variant_for_version
    from yuma_simulation_tpu_torch.simulation.engine import _simulate_case_fused
    from yuma_simulation_tpu_torch.simulation.planner import FUSED_CASE_RUNGS, rung_flags
    from yuma_simulation_tpu_torch.telemetry.numerics import numerics_enabled

    if plan.engine not in FUSED_CASE_RUNGS or not plan.on_card:
        return None
    target = cache if cache is not None else active_cache()
    builds = target.stats.builds
    _build.resolve(target)
    built = target.stats.builds > builds

    def call(W, S, reset_index, reset_epoch, config):
        return _simulate_case_fused(
            W, S, reset_index, reset_epoch, config, variant_for_version(yuma_version),
            save_bonds=save_bonds, save_incentives=save_incentives,
            capture_numerics=numerics_enabled(), **rung_flags(plan.engine),
        )

    return AotExecutable(
        call=call,
        fingerprint=_build.library_digest(CASE_SCAN_SOURCE),
        source="built" if built else "cache",
        label=plan.label,
    )


def preload_shapes(
    shapes: Sequence[tuple],
    *,
    yuma_version: str = "Yuma 1 (paper)",
    batch: int = 1,
    quarantine: bool = False,
    config=None,
    dtype=torch.float32,
    batched: Optional[bool] = None,
    label: str = "preload",
    device="cuda",
) -> int:
    """Build and load the libraries for a set of ``(epochs, V, M)`` shape
    buckets, then launch each bucket's rung once on the card (zero
    weights, unit stakes), so that a first real dispatch pays neither a
    build nor a first launch. Returns the number of buckets launched;
    buckets whose plan runs no kernel (the eager rung, the CPU) are
    skipped.

    Unlike the JAX package's, which logs a failed preload and goes on,
    this raises: a kernel that will not build or launch on the card is
    the failure the port must not hide."""
    from yuma_simulation_tpu_torch.models.config import YumaConfig
    from yuma_simulation_tpu_torch.simulation.engine import resolve_device
    from yuma_simulation_tpu_torch.simulation.planner import plan_dispatch

    config = config if config is not None else YumaConfig()
    batched = (batch > 1) if batched is None else batched
    dev = resolve_device(device)
    launched = 0
    for shape in shapes:
        E, V, M = (int(d) for d in shape)
        lanes = (batch,) if batched else ()
        plan = plan_dispatch(
            f"{label}:{E}x{V}x{M}", lanes + (E, V, M), yuma_version, config, dtype,
            quarantine=quarantine, check_memory=False, device=dev,
        )
        exe = executable_for_plan(plan, yuma_version)
        if exe is None:
            continue
        reset = torch.full(lanes, -1, dtype=torch.int32, device=dev) if batched else -1
        exe.call(
            torch.zeros(lanes + (E, V, M), dtype=dtype, device=dev),
            torch.ones(lanes + (E, V), dtype=dtype, device=dev),
            reset, reset, config,
        )
        torch.cuda.synchronize(dev)
        launched += 1
    return launched

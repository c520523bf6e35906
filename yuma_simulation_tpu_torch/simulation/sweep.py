"""Batched sweeps: a scenario suite stacked on a leading axis, one call.

`simulate_batch` runs a `[B, E, V, M]` suite on one rung: the fused scans
take the scenario batch as a grid dimension with per-scenario reset
vectors; the eager rung runs the batch through :func:`yuma_epoch`'s
leading batch dimension.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from yuma_simulation_tpu_torch.models.config import YumaConfig
from yuma_simulation_tpu_torch.models.variants import VariantSpec
from yuma_simulation_tpu_torch.ops.consensus import resolve_consensus_impl
from yuma_simulation_tpu_torch.scenarios.base import Scenario
from yuma_simulation_tpu_torch.simulation.engine import (
    FUSED_RUNGS,
    MXU_RUNGS,
    _simulate_case_fused,
    _simulate_scan,
    plan_engine,
    resolve_device,
)


def _reset_metadata(scenarios: Sequence[Scenario], device):
    """`([B] reset_index, [B] reset_epoch)` int32, -1 for None."""
    r_idx = torch.tensor(
        [-1 if s.reset_bonds_index is None else s.reset_bonds_index for s in scenarios],
        dtype=torch.int32,
    )
    r_epoch = torch.tensor(
        [-1 if s.reset_bonds_epoch is None else s.reset_bonds_epoch for s in scenarios],
        dtype=torch.int32,
    )
    return r_idx.to(device), r_epoch.to(device)


def stack_scenarios(
    scenarios: Sequence[Scenario], dtype: torch.dtype = torch.float32, device="cuda"
):
    """Stack same-shaped scenarios into `[B, E, V, M]` / `[B, E, V]`
    tensors on `device` plus the reset metadata vectors."""
    dev = resolve_device(device)
    shapes = {s.weights.shape for s in scenarios}
    if len(shapes) != 1:
        raise ValueError(f"scenarios must share one [E,V,M] shape, got {shapes}")
    W = torch.as_tensor(np.stack([s.weights for s in scenarios]), dtype=dtype).to(dev)
    S = torch.as_tensor(np.stack([s.stakes for s in scenarios]), dtype=dtype).to(dev)
    r_idx, r_epoch = _reset_metadata(scenarios, dev)
    return W, S, r_idx, r_epoch


def simulate_batch(
    weights: torch.Tensor,  # [B, E, V, M]
    stakes: torch.Tensor,  # [B, E, V]
    reset_index: torch.Tensor,  # [B] int32
    reset_epoch: torch.Tensor,  # [B] int32
    config: YumaConfig,
    spec: VariantSpec,
    save_bonds: bool = False,
    save_incentives: bool = False,
    consensus_impl: str = "bisect",
    epoch_impl: str = "auto",
    x64: bool = False,
) -> dict:
    """A scenario suite in one call, on the device the tensors live on.
    Returns `{"dividends": [B, E, V], ...}` tensors. `epoch_impl` as in
    :func:`..engine.simulate` ("auto" is the varying or case scan on CUDA
    tensors, the eager rung on CPU tensors)."""
    if weights.ndim != 4:
        raise ValueError(f"weights must be [B, E, V, M], got {tuple(weights.shape)}")
    dev = resolve_device(weights.device)
    engine = plan_engine(
        epoch_impl, consensus_impl, weights.shape, weights.dtype, dev,
        config.consensus_precision,
    )
    common = dict(
        save_bonds=save_bonds,
        save_incentives=save_incentives,
        save_consensus=False,
        x64=x64,
    )
    if engine in FUSED_RUNGS:
        return _simulate_case_fused(
            weights, stakes, reset_index, reset_epoch, config, spec,
            varying=engine.startswith("fused_varying"),
            mxu=engine in MXU_RUNGS, **common,
        )
    V, M = weights.shape[-2:]
    return _simulate_scan(
        weights, stakes, reset_index, reset_epoch, config, spec,
        consensus_impl=resolve_consensus_impl(consensus_impl, V, M), **common,
    )

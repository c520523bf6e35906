"""Carry what the JAX package holds across to the port.

The simulator has no learned weights; what carries across is its
configuration and its carried consensus state:

- :func:`config_from_numpy` builds the port's :class:`YumaConfig` from the
  field dicts of a JAX config (`dataclasses.asdict(config)["simulation"]`
  and `["yuma_params"]`);
- :func:`state_from_numpy` turns a JAX `SimulationResult.final_state` or
  a fused scan's carry dict (`bonds [(B,) V, M]`, `consensus [(B,) M]`,
  `w_prev`) into the port's carry, so a run started by the JAX package
  continues in the port (`simulate(initial_state=...)`, or the scans'
  `carry=`).
"""

from __future__ import annotations

import numpy as np
import torch

from yuma_simulation_tpu_torch.models.config import (
    SimulationHyperparameters,
    YumaConfig,
    YumaParams,
)
from yuma_simulation_tpu_torch.simulation.engine import resolve_device

_CARRY_KEYS = ("bonds", "consensus", "w_prev")


def config_from_numpy(simulation: dict, yuma_params: dict) -> YumaConfig:
    """A :class:`YumaConfig` from plain field dicts (numbers may be numpy
    scalars or 0-d arrays); unknown field names raise TypeError."""

    def plain(v):
        if v is None or isinstance(v, (bool, int, float)):
            return v
        arr = np.asarray(v)
        if arr.ndim:
            raise ValueError(f"config fields must be scalars, got shape {arr.shape}")
        return arr.item()

    return YumaConfig(
        simulation=SimulationHyperparameters(
            **{k: plain(v) for k, v in simulation.items()}
        ),
        yuma_params=YumaParams(**{k: plain(v) for k, v in yuma_params.items()}),
    )


def state_from_numpy(state: dict, device="cuda") -> dict:
    """The port's carry dict (float32 tensors on `device`) from a JAX
    carry: keys `bonds`, `consensus` and optionally `w_prev`, with
    `bonds [..., V, M]` and `consensus [..., M]` sharing their lead."""
    unknown = set(state) - set(_CARRY_KEYS)
    if unknown or not {"bonds", "consensus"} <= set(state):
        raise ValueError(
            f"state must hold bonds, consensus and optionally w_prev; got {sorted(state)}"
        )
    dev = resolve_device(device)
    out = {
        k: torch.tensor(np.asarray(v, np.float32)).to(dev)
        for k, v in state.items()
    }
    bonds, consensus = out["bonds"], out["consensus"]
    if bonds.ndim < 2 or tuple(consensus.shape) != tuple(bonds.shape[:-2]) + (
        bonds.shape[-1],
    ):
        raise ValueError(
            f"bonds {tuple(bonds.shape)} and consensus {tuple(consensus.shape)} "
            "do not describe one [..., V, M] / [..., M] carry"
        )
    if "w_prev" in out and out["w_prev"].shape != bonds.shape:
        raise ValueError(
            f"w_prev {tuple(out['w_prev'].shape)} must match bonds {tuple(bonds.shape)}"
        )
    return out

"""Synthetic scenarios: random subnets and Monte-Carlo perturbations.

The counterpart of the JAX package's `scenarios/synthetic.py`, with the
same draws, so a seed gives both packages the same scenario: numpy's for
the random subnet, JAX's threefry (:mod:`..random`) for the perturbations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from yuma_simulation_tpu_torch import random as jrandom
from yuma_simulation_tpu_torch.scenarios.base import Scenario


def random_subnet_scenario(
    seed: int,
    num_validators: int = 16,
    num_miners: int = 256,
    num_epochs: int = 40,
    stake_concentration: float = 1.0,
    name: Optional[str] = None,
) -> Scenario:
    """A random subnet: Gamma-drawn stakes normalized to one, constant over
    the epochs, and uniform random weight rows."""
    rng = np.random.default_rng(seed)
    stakes = rng.gamma(stake_concentration, size=num_validators).astype(np.float32)
    stakes /= stakes.sum()
    W = rng.random((num_epochs, num_validators, num_miners), dtype=np.float32)
    validators = [f"vali {i} ({stakes[i]:.3f})" for i in range(num_validators)]
    return Scenario(
        name=name or f"random subnet (seed={seed})",
        validators=validators,
        base_validator=validators[0],
        weights=W,
        stakes=np.tile(stakes, (num_epochs, 1)),
        num_epochs=num_epochs,
        servers=[f"Server {i + 1}" for i in range(num_miners)],
    )


def weight_perturbation_batch(
    key,
    base_weights: torch.Tensor,
    num_scenarios: int,
    sigma: float = 0.05,
) -> torch.Tensor:
    """`[B, V, M]` multiplicative log-normal perturbations of one weight
    matrix, `base * exp(sigma * normal(key, (B, V, M)))`, on the device
    `base_weights` lives on; bitwise the JAX package's (its `exp` is
    XLA:CPU's, :func:`..random.xla_exp`)."""
    base = torch.as_tensor(base_weights, dtype=torch.float32)
    noise = jrandom.normal(jrandom.as_key(key, base.device),
                           (int(num_scenarios),) + tuple(base.shape))
    return base * jrandom.xla_exp(np.float32(sigma) * noise)

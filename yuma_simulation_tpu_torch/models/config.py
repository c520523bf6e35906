"""Hyperparameter configuration as frozen dataclasses.

The same shape as the JAX package's config: two plain dataclasses combined
into :class:`YumaConfig` with flattened read access through properties.
Float fields are Python floats or 0-d tensors; the structural fields
(`liquid_alpha`, `consensus_precision`, the quantile overrides) are plain
Python values that select code paths.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class SimulationHyperparameters:
    """Global sweep-level knobs (reference yumas.py:7-14)."""

    kappa: float = 0.5
    bond_penalty: float = 1.0
    total_epoch_emission: float = 100.0
    validator_emission_ratio: float = 0.41
    total_subnet_stake: float = 1_000_000.0
    consensus_precision: int = 100_000


@dataclass(frozen=True)
class YumaParams:
    """Per-version knobs (reference yumas.py:17-27)."""

    bond_alpha: float = 0.1
    alpha_high: float = 0.9
    alpha_low: float = 0.7
    decay_rate: float = 0.1
    capacity_alpha: float = 0.1
    liquid_alpha: bool = False
    override_consensus_high: Optional[float] = None
    override_consensus_low: Optional[float] = None


@dataclass(frozen=True)
class YumaConfig:
    """Combined config with flattened read access (reference yumas.py:29-45)."""

    simulation: SimulationHyperparameters = field(
        default_factory=SimulationHyperparameters
    )
    yuma_params: YumaParams = field(default_factory=YumaParams)

    # --- flattened simulation fields ---
    @property
    def kappa(self):
        return self.simulation.kappa

    @property
    def bond_penalty(self):
        return self.simulation.bond_penalty

    @property
    def total_epoch_emission(self):
        return self.simulation.total_epoch_emission

    @property
    def validator_emission_ratio(self):
        return self.simulation.validator_emission_ratio

    @property
    def total_subnet_stake(self):
        return self.simulation.total_subnet_stake

    @property
    def consensus_precision(self):
        return self.simulation.consensus_precision

    # --- flattened yuma-params fields ---
    @property
    def bond_alpha(self):
        return self.yuma_params.bond_alpha

    @property
    def liquid_alpha(self):
        return self.yuma_params.liquid_alpha

    @property
    def alpha_high(self):
        return self.yuma_params.alpha_high

    @property
    def alpha_low(self):
        return self.yuma_params.alpha_low

    @property
    def decay_rate(self):
        return self.yuma_params.decay_rate

    @property
    def capacity_alpha(self):
        return self.yuma_params.capacity_alpha

    @property
    def override_consensus_high(self):
        return self.yuma_params.override_consensus_high

    @property
    def override_consensus_low(self):
        return self.yuma_params.override_consensus_low


@dataclass(frozen=True)
class YumaSimulationNames:
    """Canonical display names of the 9 built-in versions (yumas.py:48-58)."""

    YUMA_RUST: str = "Yuma 0 (subtensor)"
    YUMA: str = "Yuma 1 (paper)"
    YUMA_LIQUID: str = "Yuma 1 (paper) - liquid alpha on"
    YUMA2: str = "Yuma 2 (Adrian-Fish)"
    YUMA3: str = "Yuma 3 (Rhef)"
    YUMA31: str = "Yuma 3.1 (Rhef+reset)"
    YUMA32: str = "Yuma 3.2 (Rhef+conditional)"
    YUMA4: str = "Yuma 4 (Rhef+relative bonds)"
    YUMA4_LIQUID: str = "Yuma 4 (Rhef+relative bonds) - liquid alpha on"

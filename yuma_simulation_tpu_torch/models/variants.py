"""The nine named Yuma versions: dispatch specs + reference-style wrappers.

`run_simulation` in the reference dispatches on the version display string
(reference simulation_utils.py:52-93), carrying a variant-specific bond
state and reset rule. :class:`VariantSpec` captures that table as static
data; the module also exposes `YumaRust` / `Yuma` / `Yuma2` / `Yuma3` /
`Yuma4` with the reference call signatures (yumas.py:61,175,285,399,494).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Optional

import torch

from yuma_simulation_tpu_torch.models.config import (
    YumaConfig,
    YumaParams,
    YumaSimulationNames,
)
from yuma_simulation_tpu_torch.models.epoch import BondsMode, yuma_epoch


class ResetMode(enum.Enum):
    """Bond-reset injection rule (reference simulation_utils.py:62-88)."""

    NONE = "none"
    ALWAYS = "always"  # Yuma 3.1: reset at the case's reset epoch
    CONDITIONAL = "conditional"  # Yuma 3.2 / 4: only if the miner's previous
    # epoch consensus weight was exactly zero


@dataclass(frozen=True)
class VariantSpec:
    """Static description of one named version for the epoch loop."""

    name: str
    bonds_mode: BondsMode
    reset_mode: ResetMode = ResetMode.NONE
    # Which epoch output is carried as the bond state across epochs.
    bond_state_key: str = "validator_ema_bond"
    # Whether the normalized weights are carried for next epoch's clipping.
    carries_prev_weights: bool = False


_NAMES = YumaSimulationNames()

YUMA_VERSIONS: dict[str, VariantSpec] = {
    _NAMES.YUMA_RUST: VariantSpec(_NAMES.YUMA_RUST, BondsMode.EMA_RUST),
    _NAMES.YUMA: VariantSpec(_NAMES.YUMA, BondsMode.EMA),
    _NAMES.YUMA_LIQUID: VariantSpec(_NAMES.YUMA_LIQUID, BondsMode.EMA),
    _NAMES.YUMA2: VariantSpec(
        _NAMES.YUMA2, BondsMode.EMA_PREV, carries_prev_weights=True
    ),
    _NAMES.YUMA3: VariantSpec(
        _NAMES.YUMA3, BondsMode.CAPACITY, bond_state_key="validator_bonds"
    ),
    _NAMES.YUMA31: VariantSpec(
        _NAMES.YUMA31,
        BondsMode.CAPACITY,
        ResetMode.ALWAYS,
        bond_state_key="validator_bonds",
    ),
    _NAMES.YUMA32: VariantSpec(
        _NAMES.YUMA32,
        BondsMode.CAPACITY,
        ResetMode.CONDITIONAL,
        bond_state_key="validator_bonds",
    ),
    _NAMES.YUMA4: VariantSpec(
        _NAMES.YUMA4,
        BondsMode.RELATIVE,
        ResetMode.CONDITIONAL,
        bond_state_key="validator_bonds",
    ),
    _NAMES.YUMA4_LIQUID: VariantSpec(
        _NAMES.YUMA4_LIQUID,
        BondsMode.RELATIVE,
        ResetMode.CONDITIONAL,
        bond_state_key="validator_bonds",
    ),
}


def canonical_versions(
    yuma4_bond_alpha: float = 0.025,
    yuma4_alpha_high: float = 0.99,
    yuma4_alpha_low: float = 0.9,
) -> list[tuple[str, YumaParams]]:
    """The canonical 9-version sweep list with per-version params, as the
    reference's entry-point scripts build it (reference
    scripts/charts_table_generator.py:26-48): Yuma 4 runs with base params;
    the bond_alpha=0.025 / [0.9, 0.99] tuning applies only to its
    liquid-alpha variant."""
    base = YumaParams()
    liquid = YumaParams(liquid_alpha=True)
    y4_liquid = replace(
        YumaParams(
            bond_alpha=yuma4_bond_alpha,
            alpha_high=yuma4_alpha_high,
            alpha_low=yuma4_alpha_low,
        ),
        liquid_alpha=True,
    )
    return [
        (_NAMES.YUMA_RUST, base),
        (_NAMES.YUMA, base),
        (_NAMES.YUMA_LIQUID, liquid),
        (_NAMES.YUMA2, base),
        (_NAMES.YUMA3, base),
        (_NAMES.YUMA31, base),
        (_NAMES.YUMA32, base),
        (_NAMES.YUMA4, base),
        (_NAMES.YUMA4_LIQUID, y4_liquid),
    ]


def variant_for_version(yuma_version: str) -> VariantSpec:
    """Resolve a display-string version name to its static spec."""
    try:
        return YUMA_VERSIONS[yuma_version]
    except KeyError:
        raise ValueError("Invalid Yuma function.") from None


# --- Reference-signature wrappers (drop-in for yumas.py kernels) ---


def YumaRust(W, S, B_old=None, config: Optional[YumaConfig] = None) -> dict:
    """Yuma 0 (subtensor) epoch — reference yumas.py:61-172."""
    return yuma_epoch(torch.as_tensor(W), S, B_old, config, bonds_mode=BondsMode.EMA_RUST)


def Yuma(W, S, B_old=None, config: Optional[YumaConfig] = None) -> dict:
    """Yuma 1 (paper) epoch — reference yumas.py:175-282."""
    return yuma_epoch(torch.as_tensor(W), S, B_old, config, bonds_mode=BondsMode.EMA)


def Yuma2(W, W_prev, S, B_old=None, config: Optional[YumaConfig] = None) -> dict:
    """Yuma 2 (Adrian-Fish) epoch — reference yumas.py:285-396."""
    return yuma_epoch(
        torch.as_tensor(W),
        S,
        B_old,
        config,
        bonds_mode=BondsMode.EMA_PREV,
        W_prev=None if W_prev is None else torch.as_tensor(W_prev),
    )


def Yuma3(W, S, B_old=None, config: Optional[YumaConfig] = None) -> dict:
    """Yuma 3 (Rhef) epoch — reference yumas.py:399-491."""
    return yuma_epoch(torch.as_tensor(W), S, B_old, config, bonds_mode=BondsMode.CAPACITY)


def Yuma4(W, S, B_old=None, config: Optional[YumaConfig] = None) -> dict:
    """Yuma 4 (relative bonds) epoch — reference yumas.py:494-606."""
    return yuma_epoch(torch.as_tensor(W), S, B_old, config, bonds_mode=BondsMode.RELATIVE)

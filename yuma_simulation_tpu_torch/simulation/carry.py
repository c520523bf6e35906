"""The carries of the throughput loops, and the numerics sketch, as small
dataclasses of tensors.

Each names the legs one loop carries from epoch to epoch, so a loop body
reads `carry.bonds` rather than a tuple position (the JAX package's
`simulation/carry.py`, where they are registered pytrees for `lax.scan`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass
class TotalsCarry:
    """The epoch-constant scan (:func:`.engine.simulate_constant`): the
    full epoch state plus the running dividend total."""

    bonds: torch.Tensor  # [V, M]
    w_prev: torch.Tensor  # [V, M]
    consensus: torch.Tensor  # [M]
    acc: torch.Tensor  # [V]


@dataclass
class ScaledCarry:
    """The epoch-varying scaled scan (:func:`.engine.simulate_scaled`);
    `w_prev` is None for variants that do not carry previous weights."""

    bonds: torch.Tensor  # [(B,) V, M]
    w_prev: Optional[torch.Tensor]  # [(B,) V, M] or None
    acc: torch.Tensor  # [(B,) V]


@dataclass
class HoistedCarry:
    """The hoisted constant-weights scan: the bond recurrence and the
    dividend total; everything else is computed once."""

    bonds: torch.Tensor  # [V, M]
    acc: torch.Tensor  # [V]


@dataclass
class ScanCarry:
    """The eager rung's scan carry (:func:`.engine._simulate_scan`): the
    state one epoch hands the next. `w_prev` is None for variants that do
    not carry previous weights. `quarantine` is the per-lane non-finite
    guard's state (:mod:`..resilience.guards`: `bad`, `first_bad_epoch`,
    `tensor_code`, each `[(B,)]` on the device) when the guard is armed,
    else None."""

    bonds: torch.Tensor  # [(B,) V, M]
    w_prev: Optional[torch.Tensor]  # [(B,) V, M] or None
    consensus: torch.Tensor  # [(B,) M]
    quarantine: Optional[dict] = None

    def to_dict(self) -> dict:
        """The carry dict the entry points take and return
        (``initial_state`` / ``final_state``)."""
        out = {"bonds": self.bonds, "consensus": self.consensus}
        if self.w_prev is not None:
            out["w_prev"] = self.w_prev
        return out


@dataclass
class NumericsSketch:
    """The per-epoch numerics observable of one tensor stream
    (:mod:`..telemetry.numerics`). Each field holds one value per epoch
    (`[E]`, or `[B, E]` for a batch): tensors where the run computed them,
    numpy arrays on the host. Every reduction is exact and
    order-independent (integer counts, wrapping u32 bit sums, min / max), so
    a sketch is bitwise invariant to streaming the epochs in slabs: merging
    slab captures is concatenation along the epoch axis."""

    finite_frac: Any  # exact finite count / size, in the stream's dtype
    lo: Any  # min over the finite values (+inf when there are none)
    hi: Any  # max over the finite values (-inf when there are none)
    absmax: Any  # max |x| over the finite values (0 when there are none)
    fingerprint: Any  # wrapping u32 sum of the raw bits (ops.fingerprint)

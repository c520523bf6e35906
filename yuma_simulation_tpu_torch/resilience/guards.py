"""Numerical quarantine: lane-local non-finite containment for batches (the
JAX package's `resilience/guards.py`, on torch tensors).

A NaN born in one scenario/config lane of a batch contaminates nothing
else *numerically* (lanes are independent), but it contaminates
everything else *operationally*: batch reducers sum over the lanes,
streamed accumulators carry it forward, and the operator learns only that
"the sweep produced NaN" with no idea which lane — or which epoch — went
bad.

The quarantine is an opt-in health check folded into the eager rung's
carry (:class:`..simulation.carry.ScanCarry.quarantine`): each epoch, the
step's outputs are `isfinite`-checked per lane; the first failure latches a
per-lane `(first_bad_epoch, tensor_code)` provenance record into the
carry, and from that epoch on the lane's carry and per-epoch outputs are
masked to zero — the lane is *quarantined*, the rest of the batch is
bit-for-bit what a clean run produces (for healthy lanes every guard op is
`where(False, 0, x)`, i.e. the identity on the same values).

The per-lane state (`bad [B]`, `first_bad_epoch [B]`, `tensor_code [B]`)
stays on the device the batch runs on: nothing reads it on the host per
epoch. Batched drivers return it after the scan, and
:func:`build_quarantine_report` reads it once and turns it into a
host-side report of `(case, epoch, tensor)` entries.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from yuma_simulation_tpu_torch.resilience.errors import NonFiniteOutputError

#: Tensor names in `tensor_code` order — the priority order the per-epoch
#: check walks (a NaN usually poisons several tensors at once; the code
#: records the first in this order so reports are deterministic).
QUARANTINE_TENSORS = ("dividends", "bonds", "consensus", "w_prev", "incentives")


def quarantine_init(lead: Sequence[int] = (), device="cpu") -> dict:
    """The per-lane quarantine carry at epoch 0 (healthy, no provenance),
    one entry per lane of the `lead` batch shape, on `device`."""
    lead = tuple(lead)
    return {
        "bad": torch.zeros(lead, dtype=torch.bool, device=device),
        "first_bad_epoch": torch.full(lead, -1, dtype=torch.int32, device=device),
        "tensor_code": torch.full(lead, -1, dtype=torch.int32, device=device),
    }


def _lane_finite(t: torch.Tensor, lead: tuple) -> torch.Tensor:
    """Per lane of the leading `lead` dims: are all of `t`'s values finite."""
    return torch.isfinite(t).reshape(lead + (-1,)).all(dim=-1)


def quarantine_step(qstate: dict, epoch: int, tensors: Sequence[tuple]):
    """Fold one epoch's health check into the quarantine carry.

    `tensors` is a sequence of `(code, tensor)` with `code` indexing
    :data:`QUARANTINE_TENSORS`; each tensor's leading dims are the lanes of
    `qstate`. Returns `(new_qstate, mask)` where `mask(x)` zeroes the lanes
    of `x` that are (now) quarantined — the identity, bitwise, for healthy
    lanes. All on the device: no host read."""
    bad = qstate["bad"]
    lead = tuple(bad.shape)
    finite = [_lane_finite(t, lead) for _, t in tensors]
    bad_now = ~torch.stack(finite).all(dim=0)
    code = torch.full(lead, -1, dtype=torch.int32, device=bad.device)
    for (c, _), ok in reversed(list(zip(tensors, finite))):
        code = torch.where(ok, code, torch.full_like(code, c))
    newly = bad_now & ~bad
    new_bad = bad | bad_now
    new_qstate = {
        "bad": new_bad,
        "first_bad_epoch": torch.where(
            newly, torch.full_like(qstate["first_bad_epoch"], int(epoch)),
            qstate["first_bad_epoch"],
        ),
        "tensor_code": torch.where(newly, code, qstate["tensor_code"]),
    }

    def mask(x: torch.Tensor) -> torch.Tensor:
        lane = new_bad.reshape(lead + (1,) * (x.ndim - len(lead)))
        return torch.where(lane, torch.zeros_like(x), x)

    return new_qstate, mask


@dataclasses.dataclass(frozen=True)
class QuarantineEntry:
    """One quarantined lane: which case, from which epoch, and the first
    tensor observed non-finite."""

    case: int
    epoch: int
    tensor: str


@dataclasses.dataclass(frozen=True)
class QuarantineReport:
    """Host-side view of a batch's quarantine state.

    `entries` lists quarantined lanes only; `num_cases` is the full
    batch width so `healthy_mask()` can be used to select the valid
    rows of the partial results."""

    entries: tuple
    num_cases: int

    @property
    def quarantined_cases(self) -> tuple:
        return tuple(e.case for e in self.entries)

    def healthy_mask(self) -> np.ndarray:
        mask = np.ones(self.num_cases, bool)
        for e in self.entries:
            mask[e.case] = False
        return mask

    def __bool__(self) -> bool:  # truthy iff anything was quarantined
        return bool(self.entries)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.atleast_1d(np.asarray(x))


def build_quarantine_report(qstate) -> QuarantineReport:
    """Convert the per-lane quarantine state (the `"quarantine"` entry of a
    guarded batch's outputs — `[B]` tensors on the device, or host arrays)
    into a :class:`QuarantineReport`: the one host read of the state."""
    bad = _host(qstate["bad"])
    first = _host(qstate["first_bad_epoch"])
    codes = _host(qstate["tensor_code"])
    entries = tuple(
        QuarantineEntry(
            case=int(i),
            epoch=int(first[i]),
            tensor=(
                QUARANTINE_TENSORS[int(codes[i])]
                if 0 <= int(codes[i]) < len(QUARANTINE_TENSORS)
                else "unknown"
            ),
        )
        for i in np.flatnonzero(bad)
    )
    return QuarantineReport(entries=entries, num_cases=int(bad.shape[0]))


def _leaves(tree, path: str = ""):
    """`(path, leaf)` pairs of a nested dict / list / tuple / dataclass, the
    path spelled as `jax.tree_util.keystr` spells it (`['dividends']`)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif tree is not None:
        yield path, tree


def assert_all_finite(tree, context: str = "") -> None:
    """Host-side strict check: raise :class:`NonFiniteOutputError` naming
    the first non-finite leaf. For callers who want abort-on-NaN rather
    than quarantine (single-scenario runs, golden pipelines)."""
    for where, leaf in _leaves(tree):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            raise NonFiniteOutputError(
                f"non-finite values in {where}"
                + (f" ({context})" if context else "")
            )

"""The HBM preflight: device specs and the analytic footprint check.

The counterpart of the HBM half of the JAX package's `telemetry/cost.py`.
:func:`preflight_hbm` is the check the dispatch planner runs before every
dispatch: :func:`estimate_hbm_bytes` predicts the peak resident bytes from
shapes alone, and a shape that cannot fit the card is refused with a typed
:class:`HBMPreflightError` (a ``ValueError``) and one
``event=preflight_rejected`` record, before anything is copied to the card.
It is on the hot path, so it stays host arithmetic on shapes: the device's
name and total memory are read once per device and cached, and the card is
never asked for its free memory.

The estimate is JAX's term for term (the epoch stack, the saved output
streams, :data:`WORKING_SET_VM_BUFFERS` `[V, M]` buffers), plus, on a
fused rung, the scratch of the port's scans (`ops/cuda_epoch.py::
_scratch_layout`): at 256 x 4096 a 16-epoch tile's normalized weights alone
are 67 MB, more than JAX's six `[V, M]` buffers (25 MB).

The same override variables as the JAX package: ``YUMA_TPU_DEVICE_SPEC``
(a JSON device spec) and ``YUMA_TPU_PREFLIGHT=0`` (preflight off). The AOT
cost capture and the roofline model are not ported yet (ROADMAP queue A,
slice 5).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional

import torch

from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

#: Env var naming a JSON DeviceSpec override, e.g.
#: ``{"name": "lab-h100", "memory_bytes": 85520809984}``.
DEVICE_SPEC_ENV = "YUMA_TPU_DEVICE_SPEC"

#: Env var disabling the HBM preflight ("0"/"off"/"false").
PREFLIGHT_ENV = "YUMA_TPU_PREFLIGHT"

#: `[V, M]`-sized buffers the engines keep resident beyond the epoch stack
#: itself (the bonds and previous-weights carries, the normalized and
#: clipped weights, temporaries): a round upper bound, as in JAX.
WORKING_SET_VM_BUFFERS = 6

#: Fraction of device memory the predicted footprint may claim before the
#: preflight rejects: the caching allocator and the CUDA context take the rest.
DEFAULT_MEMORY_FRACTION = 0.92


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """What one device can do: peak FLOP/s (dense, bf16 on the tensor
    cores), memory bandwidth (bytes/s) and usable memory (bytes). ``None``
    means unknown: every consumer then degrades to an unknown verdict (the
    CPU spec is all None by design)."""

    name: str
    peak_flops: Optional[float] = None
    hbm_bandwidth: Optional[float] = None
    memory_bytes: Optional[int] = None


#: Device-name substring (lowercase) -> spec, the longest key winning. The
#: rates are NVIDIA's data-sheet figures for the H100 SXM part (dense bf16,
#: HBM3); the memory is read from the card itself
#: (`torch.cuda.get_device_properties(dev).total_memory`).
DEVICE_SPECS: dict[str, DeviceSpec] = {
    "h100": DeviceSpec("NVIDIA H100", 989e12, 3.35e12),
    "cpu": DeviceSpec("cpu"),
}

#: Resolved specs keyed on (env override, device): one probe per device.
_RESOLVED_SPECS: dict[tuple, DeviceSpec] = {}


def resolve_device_spec(
    override: Optional[DeviceSpec] = None, device=None
) -> DeviceSpec:
    """The spec of `device` (a torch device; None: the current CUDA device
    if there is one, else the CPU): an explicit `override` wins, then the
    :data:`DEVICE_SPEC_ENV` JSON override, then :data:`DEVICE_SPECS` keyed
    on the card's name with its total memory, then a memory-only spec, then
    all None. Cached per device and override."""
    if override is not None:
        return override
    env = os.environ.get(DEVICE_SPEC_ENV) or ""
    dev = _spec_device(device)
    key = (env, str(dev))
    cached = _RESOLVED_SPECS.get(key)
    if cached is None:
        cached = _RESOLVED_SPECS[key] = _resolve_uncached(env, dev)
    return cached


def _spec_device(device) -> torch.device:
    if device is not None:
        dev = torch.device(device)
    else:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _resolve_uncached(env: str, dev: torch.device) -> DeviceSpec:
    if env:
        try:
            fields = json.loads(env)
            return DeviceSpec(
                name=str(fields.get("name", "env-override")),
                peak_flops=fields.get("peak_flops"),
                hbm_bandwidth=fields.get("hbm_bandwidth"),
                memory_bytes=fields.get("memory_bytes"),
            )
        except (ValueError, TypeError, AttributeError):
            logger.warning("undecodable %s=%r ignored", DEVICE_SPEC_ENV, env)
    if dev.type != "cuda":
        return DEVICE_SPECS["cpu"]
    try:
        props = torch.cuda.get_device_properties(dev)
    except (RuntimeError, AssertionError, AttributeError):
        return DeviceSpec(name="unknown")
    lowered = props.name.lower()
    for key in sorted(DEVICE_SPECS, key=len, reverse=True):
        if key in lowered:
            return dataclasses.replace(
                DEVICE_SPECS[key], name=props.name, memory_bytes=int(props.total_memory)
            )
    return DeviceSpec(name=props.name, memory_bytes=int(props.total_memory))


class HBMPreflightError(ValueError):
    """The predicted peak device footprint exceeds the card's capacity:
    the dispatch was refused before anything was copied or allocated. A
    ``ValueError``: a caller error, not worth a retry; the message says
    which slab length (``max_resident_epochs``) would fit."""

    def __init__(self, message: str, verdict: Optional["PreflightVerdict"] = None):
        super().__init__(message)
        self.verdict = verdict


@dataclasses.dataclass
class FootprintEstimate:
    """Predicted peak resident bytes for one dispatch, per device, with
    the per-term breakdown (bytes)."""

    total_bytes: int
    breakdown: dict
    V: int
    M: int
    resident_epochs: int
    miner_shards: int
    batch_lanes: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def estimate_hbm_bytes(
    V: int,
    M: int,
    *,
    resident_epochs: int = 0,
    itemsize: int = 4,
    save_bonds: bool = False,
    save_incentives: bool = False,
    save_consensus: bool = False,
    miner_shards: int = 1,
    batch_lanes: int = 1,
    scratch_bytes: int = 0,
) -> FootprintEstimate:
    """One dispatch's peak resident bytes per device from shapes alone:
    the JAX package's terms (`resident_epochs` of the epoch stack, the
    saved output streams, the `[V, M]` working set; `miner_shards` divides
    every miner-axis buffer, `batch_lanes` multiplies everything), plus
    `scratch_bytes` per lane, the scratch of a fused rung's scan (a
    ``scan_scratch`` term, present only when non-zero, so the eager rung's
    breakdown is JAX's). An upper bound: it exists to refuse what cannot
    fit, not to certify what barely might."""
    ms = max(1, int(miner_shards))
    lanes = max(1, int(batch_lanes))
    m_local = -(-int(M) // ms)
    vm = int(V) * m_local * itemsize
    breakdown = {
        "weights_stack": resident_epochs * vm,
        "stakes_stack": resident_epochs * int(V) * itemsize,
        "working_set": WORKING_SET_VM_BUFFERS * vm,
        "dividends_out": resident_epochs * int(V) * itemsize,
        "bonds_out": resident_epochs * vm if save_bonds else 0,
        "incentives_out": resident_epochs * m_local * itemsize if save_incentives else 0,
        "consensus_out": resident_epochs * m_local * itemsize if save_consensus else 0,
    }
    if scratch_bytes:
        breakdown["scan_scratch"] = int(scratch_bytes)
    breakdown = {k: int(v) * lanes for k, v in breakdown.items()}
    return FootprintEstimate(
        total_bytes=sum(breakdown.values()),
        breakdown=breakdown,
        V=int(V),
        M=int(M),
        resident_epochs=int(resident_epochs),
        miner_shards=ms,
        batch_lanes=lanes,
    )


@dataclasses.dataclass
class PreflightVerdict:
    """One preflight decision. ``fits`` is None when the device capacity
    is unknown (the CPU without an override): the preflight passes open."""

    label: str
    fits: Optional[bool]
    predicted_bytes: int
    capacity_bytes: Optional[int]
    fraction: float
    device: str
    suggestion: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def preflight_enabled() -> bool:
    return os.environ.get(PREFLIGHT_ENV, "1").lower() not in ("0", "off", "false")


def preflight_hbm(
    label: str,
    estimate: FootprintEstimate,
    *,
    spec: Optional[DeviceSpec] = None,
    fraction: float = DEFAULT_MEMORY_FRACTION,
    raise_on_reject: bool = True,
    device=None,
) -> PreflightVerdict:
    """Predicted peak bytes against the usable memory of `device` (or
    `spec`). A shape that fits, or a device of unknown capacity, returns
    its verdict; one that cannot fit logs one ``event=preflight_rejected``
    record and raises :class:`HBMPreflightError` (``raise_on_reject=False``
    returns the verdict instead). Off with ``YUMA_TPU_PREFLIGHT=0``."""
    spec = resolve_device_spec(spec, device)

    def verdict(fits, suggestion=None):
        return PreflightVerdict(
            label=label, fits=fits, predicted_bytes=estimate.total_bytes,
            capacity_bytes=spec.memory_bytes, fraction=fraction, device=spec.name,
            suggestion=suggestion,
        )

    if not preflight_enabled() or not spec.memory_bytes:
        return verdict(None)
    budget = int(spec.memory_bytes * fraction)
    if estimate.total_bytes <= budget:
        return verdict(True)
    rejected = verdict(False, _suggest(estimate, budget))
    log_event(
        logger, "preflight_rejected", label=label, V=estimate.V, M=estimate.M,
        resident_epochs=estimate.resident_epochs, miner_shards=estimate.miner_shards,
        batch_lanes=estimate.batch_lanes,
        predicted_gib=round(estimate.total_bytes / 2**30, 2),
        capacity_gib=round(spec.memory_bytes / 2**30, 2), device=spec.name,
        suggestion=rejected.suggestion or "",
    )
    if raise_on_reject:
        raise HBMPreflightError(
            f"{label}: predicted peak HBM "
            f"{estimate.total_bytes / 2**30:.2f} GiB exceeds "
            f"{fraction:.0%} of {spec.name} capacity "
            f"({spec.memory_bytes / 2**30:.2f} GiB) for shape "
            f"V={estimate.V} M={estimate.M} "
            f"resident_epochs={estimate.resident_epochs}. "
            f"{rejected.suggestion or ''}".rstrip(),
            rejected,
        )
    return rejected


def _suggest(estimate: FootprintEstimate, budget: int) -> Optional[str]:
    """A way out: the `max_resident_epochs` slab length that would fit
    (when the epoch stack dominates), else the miner-shard count that
    would (when the working set does)."""
    per_epoch = sum(
        v // max(1, estimate.resident_epochs)
        for k, v in estimate.breakdown.items()
        if k.endswith("_stack") or k.endswith("_out")
    ) if estimate.resident_epochs else 0
    fixed = estimate.breakdown["working_set"] + estimate.breakdown.get("scan_scratch", 0)
    if per_epoch and fixed < budget:
        chunk = (budget - fixed) // per_epoch
        if chunk >= 1:
            return f"stream with max_resident_epochs<={chunk} or shard the miner axis"
    if fixed > budget:
        shards = -(-fixed * estimate.miner_shards // budget)
        return f"shard the miner axis over >= {shards} devices (or reduce V x M)"
    return "shard the miner axis or reduce the resident epoch stack"

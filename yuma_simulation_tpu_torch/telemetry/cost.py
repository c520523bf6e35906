"""Cost models: the rungs' work and rooflines, and the HBM preflight.

The counterpart of the JAX package's `telemetry/cost.py`, in two halves.

The cost half: :func:`capture_engine_cost` / :func:`capture_engine_costs`
give a :class:`CostRecord` per engine rung at an `[epochs, V, M]` shape,
and :func:`roofline` places a record against a :class:`DeviceSpec` and a
measured rate. JAX fills a record from XLA's compile-time
``cost_analysis``, which the port has no counterpart of. The port counts
the rung's *work* from the shape instead: the bytes a run must move (each
input read once, each output written once) and the operations of an epoch
(:data:`BISECT_OPS` + :data:`ELEMENTWISE_OPS` per `[V, M]` cell), over
every epoch, where XLA counts a scan body once. The work is the same for
every rung at a shape, so a roofline reads the same work whatever
implements it; ``hlo_fingerprint`` is the build digest of the library a
fused rung launches (`ops/_build.py`), and the memory fields are
:func:`estimate_hbm_bytes`'s. The H100's peaks (:data:`PEAK_BYTES_PER_S`
and the rest) and :func:`bound_ms` are the model `chip_smoke.py` bounds
every kernel with.

The preflight half: :func:`preflight_hbm` is the check the dispatch planner
runs before every dispatch: :func:`estimate_hbm_bytes` predicts the peak
resident bytes from shapes alone, and a shape that cannot fit the card is
refused with a typed :class:`HBMPreflightError` (a ``ValueError``) and one
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
(a JSON device spec) and ``YUMA_TPU_PREFLIGHT=0`` (preflight off).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional, Sequence

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


#: H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth, and the
#: non-tensor-core float32 rate, against which the bisection's int32
#: compare-adds are counted (the data sheet gives no int32 vector rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
#: Dense int8 tensor-core rate (K4's contraction).
PEAK_INT8_OPS_PER_S = 1979e12
#: Elementwise operations per [V, M] cell per epoch outside the bisection
#: (Yuma 1): the row normalization (scale, add, divide), the clip (min),
#: the rank (multiply, add), the bond target (min, two multiplies, add,
#: multiply), its column sum and divide, the EMA (two multiplies, add),
#: and the dividend (multiply, add).
ELEMENTWISE_OPS = 18
#: The bisection: 17 halvings of a compare and an add per cell.
BISECT_OPS = 17 * 2


def bound_ms(nbytes: float, ops: float, int8_ops: float = 0.0):
    """max(bytes / HBM rate, operations / their peak rate) in ms, and which
    of the two binds; `ops` at the float32 vector rate, `int8_ops` at the
    int8 tensor-core rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S + int8_ops / PEAK_INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """What one device can do: peak operations/s of the arithmetic the
    rungs do, memory bandwidth (bytes/s) and usable memory (bytes).
    ``None`` means unknown: every consumer then degrades to an unknown
    verdict (the CPU spec is all None by design)."""

    name: str
    peak_flops: Optional[float] = None
    hbm_bandwidth: Optional[float] = None
    memory_bytes: Optional[int] = None


#: Device-name substring (lowercase) -> spec, the longest key winning. The
#: rates are NVIDIA's data-sheet figures for the H100 SXM part: the float32
#: rate outside the tensor cores (the rungs' work is float32 and int32
#: vector arithmetic, :func:`capture_engine_cost`) and HBM3's bandwidth;
#: the memory is read from the card itself
#: (`torch.cuda.get_device_properties(dev).total_memory`).
DEVICE_SPECS: dict[str, DeviceSpec] = {
    "h100": DeviceSpec("NVIDIA H100", PEAK_OPS_PER_S, PEAK_BYTES_PER_S),
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


# ---------------------------------------------------------------------------
# the rungs' work and rooflines

#: The case-scan rungs, best first: `simulation/planner.py::ENGINE_LADDER`,
#: kept literal here (the planner imports this module).
ENGINE_RUNGS = (
    "fused_varying_mxu",
    "fused_varying",
    "fused_scan_mxu",
    "fused_scan",
    "eager",
)


@dataclasses.dataclass
class CostRecord:
    """One engine rung's work at one shape, with JAX's fields. A null field
    carries a non-null ``reason``. ``flops`` counts the operations of
    every epoch (float32 and int32 vector operations; on the `_mxu` rungs
    the support sum runs on the tensor cores, counted the same);
    ``bytes_accessed`` each input read once and each output written once;
    ``peak_bytes`` is :func:`estimate_hbm_bytes`'s total (source
    "estimate_hbm_bytes")."""

    engine: str
    backend: Optional[str]
    V: int
    M: int
    epochs: int
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    transcendentals: Optional[float] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    peak_bytes: Optional[int] = None
    peak_bytes_source: Optional[str] = None
    generated_code_bytes: Optional[int] = None
    hlo_fingerprint: Optional[str] = None
    reason: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def flops_per_epoch(self) -> Optional[float]:
        if self.flops is None or self.epochs <= 0:
            return None
        return self.flops / self.epochs

    @property
    def bytes_per_epoch(self) -> Optional[float]:
        if self.bytes_accessed is None or self.epochs <= 0:
            return None
        return self.bytes_accessed / self.epochs


def capture_engine_cost(
    engine: str,
    V: int,
    M: int,
    epochs: int,
    *,
    yuma_version: str = "Yuma 1 (paper)",
    config=None,
    dtype: torch.dtype = torch.float32,
    save_bonds: bool = False,
    save_incentives: bool = False,
) -> CostRecord:
    """The work of one engine rung over `[epochs, V, M]`, from the shape
    (nothing is built, allocated or run): per epoch, :data:`BISECT_OPS` +
    :data:`ELEMENTWISE_OPS` operations a cell and, with liquid alpha, one
    exponential a cell; the weights and stakes read once; the dividends,
    the final bonds and the saved streams written once. "xla", the JAX
    package's name of the bottom rung, is taken as "eager"."""
    from yuma_simulation_tpu_torch.models.config import YumaConfig
    from yuma_simulation_tpu_torch.models.variants import variant_for_version

    engine = "eager" if engine == "xla" else engine
    if engine not in ENGINE_RUNGS:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINE_RUNGS}")
    variant_for_version(yuma_version)  # an unknown version is a caller error
    config = config if config is not None else YumaConfig()
    itemsize = torch.empty((), dtype=dtype).element_size()
    E, V, M = int(epochs), int(V), int(M)
    cells = E * V * M
    fused = engine != "eager"
    if fused:
        from yuma_simulation_tpu_torch.ops._build import library_digest
        from yuma_simulation_tpu_torch.simulation.planner import scan_scratch_bytes

        scratch = scan_scratch_bytes(engine, V, M)
    else:
        scratch = 0
    est = estimate_hbm_bytes(
        V, M, resident_epochs=E, itemsize=itemsize, save_bonds=save_bonds,
        save_incentives=save_incentives, scratch_bytes=scratch,
    )
    parts = est.breakdown
    return CostRecord(
        engine=engine,
        backend="gpu" if torch.cuda.is_available() else "cpu",
        V=V, M=M, epochs=E,
        flops=float(cells * (BISECT_OPS + ELEMENTWISE_OPS)),
        bytes_accessed=float(itemsize * (
            cells + 2 * E * V + V * M
            + (cells if save_bonds else 0) + (E * M if save_incentives else 0)
        )),
        transcendentals=float(cells if config.liquid_alpha else 0),
        argument_bytes=parts["weights_stack"] + parts["stakes_stack"],
        output_bytes=sum(parts[k] for k in parts if k.endswith("_out")),
        temp_bytes=parts["working_set"] + parts.get("scan_scratch", 0),
        peak_bytes=est.total_bytes,
        peak_bytes_source="estimate_hbm_bytes",
        hlo_fingerprint=library_digest("case_scan.cu") if fused else None,
        reason=(
            "work counted from the shape over every epoch; generated_code_bytes "
            "not reported (one library serves every shape)" if fused
            else "eager rung: plain PyTorch, no library to fingerprint; work "
            "counted from the shape over every epoch"
        ),
    )


def capture_engine_costs(
    V: int,
    M: int,
    epochs: int,
    *,
    engines: Sequence[str] = ENGINE_RUNGS,
    yuma_version: str = "Yuma 1 (paper)",
    config=None,
    dtype: torch.dtype = torch.float32,
    save_bonds: bool = False,
    save_incentives: bool = False,
) -> dict[str, CostRecord]:
    """One :class:`CostRecord` per engine rung: the cost report's payload."""
    return {
        engine: capture_engine_cost(
            engine, V, M, epochs, yuma_version=yuma_version, config=config,
            dtype=dtype, save_bonds=save_bonds, save_incentives=save_incentives,
        )
        for engine in engines
    }


@dataclasses.dataclass
class Roofline:
    """A rung's position against the device roofline (the JAX package's
    fields). ``None`` fields mean the spec or the record lacked the inputs."""

    engine: str
    device: str
    arithmetic_intensity: Optional[float] = None  # operations / byte
    ridge_intensity: Optional[float] = None  # peak operations / bandwidth
    bound: Optional[str] = None  # "compute" | "memory"
    predicted_seconds: Optional[float] = None
    predicted_epochs_per_sec: Optional[float] = None
    measured_epochs_per_sec: Optional[float] = None
    #: measured / predicted: the fraction of the roofline attained.
    attained_fraction: Optional[float] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def roofline(
    record: CostRecord,
    spec: Optional[DeviceSpec] = None,
    *,
    measured_epochs_per_sec: Optional[float] = None,
) -> Roofline:
    """Classify `record` compute- or memory-bound under `spec` and predict
    the epochs/s ceiling, ``t = max(flops / peak_flops, bytes / bandwidth)``,
    epochs/s = epochs / t; with a measured rate, the attained fraction of
    the prediction. The JAX package's arithmetic, operation for operation.
    The port's records count every epoch, so the prediction is the rung's
    bound, not JAX's optimistic scan-body ceiling."""
    spec = resolve_device_spec(spec)
    out = Roofline(
        engine=record.engine, device=spec.name,
        measured_epochs_per_sec=measured_epochs_per_sec,
    )
    if record.flops is not None and record.bytes_accessed:
        out.arithmetic_intensity = record.flops / record.bytes_accessed
    if spec.peak_flops and spec.hbm_bandwidth:
        out.ridge_intensity = spec.peak_flops / spec.hbm_bandwidth
    if out.arithmetic_intensity is not None and out.ridge_intensity is not None:
        out.bound = "compute" if out.arithmetic_intensity >= out.ridge_intensity else "memory"
    t_compute = (
        record.flops / spec.peak_flops
        if record.flops is not None and spec.peak_flops else None
    )
    t_memory = (
        record.bytes_accessed / spec.hbm_bandwidth
        if record.bytes_accessed is not None and spec.hbm_bandwidth else None
    )
    candidates = [t for t in (t_compute, t_memory) if t is not None]
    if candidates:
        out.predicted_seconds = max(candidates)
        if out.predicted_seconds > 0 and record.epochs > 0:
            out.predicted_epochs_per_sec = record.epochs / out.predicted_seconds
    if measured_epochs_per_sec is not None and out.predicted_epochs_per_sec:
        out.attained_fraction = measured_epochs_per_sec / out.predicted_epochs_per_sec
    return out


# ---------------------------------------------------------------------------
# HBM preflight


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
    #: Miner shards that share the one physical device this estimate is
    #: for (in the JSON only when more than one: the JAX package's keys).
    shards_per_device: int = 1

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        if self.shards_per_device == 1:
            del out["shards_per_device"]
        return out


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
    shards_per_device: int = 1,
) -> FootprintEstimate:
    """One dispatch's peak resident bytes per device from shapes alone:
    the JAX package's terms (`resident_epochs` of the epoch stack, the
    saved output streams, the `[V, M]` working set; `miner_shards` divides
    every miner-axis buffer, `batch_lanes` multiplies everything), plus
    `scratch_bytes` per lane, the scratch of a fused rung's scan (a
    ``scan_scratch`` term, present only when non-zero, so the eager rung's
    breakdown is JAX's). `shards_per_device` multiplies everything too:
    the miner shards that share one physical device hold their buffers
    there side by side. An upper bound: it exists to refuse what cannot
    fit, not to certify what barely might."""
    ms = max(1, int(miner_shards))
    lanes = max(1, int(batch_lanes)) * max(1, int(shards_per_device))
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
        batch_lanes=max(1, int(batch_lanes)),
        shards_per_device=max(1, int(shards_per_device)),
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

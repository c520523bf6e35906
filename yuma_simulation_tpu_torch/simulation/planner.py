"""DispatchPlan: the one dispatch-planning decision of every engine path.

The counterpart of the JAX package's `simulation/planner.py`. Every case-scan
entry point (`simulate`, `simulate_streamed`, `simulate_generated`,
`simulate_batch` and the sweeps over it) asks :func:`plan_dispatch` once and
gets a frozen :class:`DispatchPlan`:

    shape bucket -> engine rung -> memory plan

- **shape bucket** (:class:`ShapeBucket`): the `[Vp, Mp]` target the
  donor-packing path (:func:`..sweep.pack_scenarios`) pads a mixed suite
  to. The port keeps JAX's (8, 128) tile, so a packed suite is the JAX
  package's tensor for tensor. No kernel of the port takes a miner mask, so
  a packed suite runs on the eager rung, as JAX's runs on its XLA rung.
- **engine rung**: the one "auto" resolution, every admission rule in one
  place. The TPU's VMEM model (`_fits_vmem`, `fused_*_eligible`,
  `exact_mxu_support_covers`) does not carry over: on Hopper the scans keep
  their state in device memory, and the rule is a CUDA device, float32,
  bisection consensus, no miner mask and the int32 bound of the dyadic
  quantize grid; then the varying scan (K3) where an epoch tile of at least
  2 divides E, else the case scan (K2). The tile is taken without asking
  the card for free memory (the scans fall back on their own when their
  scratch does not fit). "auto" takes the VPU support sum where JAX takes
  the `_mxu` twin: bitwise the same, and the tensor-core support measured
  slower on the card (PERF.md, B5).
- **ladder**: the rungs at and below the chosen one (:func:`ladder_from`).
- **memory plan** (:class:`MemoryPlan`): the analytic preflight of
  :mod:`..telemetry.cost` (host arithmetic on shapes: no allocation, no
  query of the card's free memory) and the slab length the double-buffered
  streamed path caps its slabs at, sized so :data:`STREAM_BUFFERS` slabs
  fit the card together.

The bottom rung is the port's "eager" loop; "xla", the JAX package's name
for it, is accepted and resolves to "eager". Plans are frozen and
deterministic: equal inputs give an equal plan. :meth:`DispatchPlan.record`
logs one ``event=dispatch_planned`` record and stamps the plan on the open
telemetry span. :meth:`DispatchPlan.attach_cost` attaches the rung's work
(:func:`..telemetry.cost.capture_engine_cost`) and
:meth:`DispatchPlan.attach_executable` its libraries, resolved through the
kernel cache (:func:`..aot.executable_for_plan`). A miner-sharding mesh
plans the eager rung (:mod:`..models.miner_shards`), with the memory of
one shard times the shards on each physical device.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

import torch

from yuma_simulation_tpu_torch.models.variants import VariantSpec, variant_for_version
from yuma_simulation_tpu_torch.ops.consensus import (
    bisection_iterations,
    dyadic_grid_fits_int32,
    exact_mxu_support_covers,
    resolve_consensus_impl,
)
from yuma_simulation_tpu_torch.ops.cuda_epoch import (
    VARYING_EPOCH_TILE_MAX,
    _scratch_layout,
    varying_scan_epoch_tile,
)
from yuma_simulation_tpu_torch.telemetry.cost import (
    DEFAULT_MEMORY_FRACTION,
    estimate_hbm_bytes,
    preflight_enabled,
    preflight_hbm,
    resolve_device_spec,
)
from yuma_simulation_tpu_torch.telemetry.runctx import _tracing_now, current_span
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

#: The case-scan ladder, most to least demanding. An explicitly requested
#: rung may only walk down from itself.
ENGINE_LADDER = (
    "fused_varying_mxu",
    "fused_varying",
    "fused_scan_mxu",
    "fused_scan",
    "eager",
)

#: Every fused rung of the case-scan entry points (K2 / K3, with K4 under
#: the `_mxu` twins).
FUSED_CASE_RUNGS = ENGINE_LADDER[:-1]

#: The JAX package's name of the bottom rung, accepted as "eager".
JAX_BOTTOM_RUNG = "xla"


def rung_flags(engine: str) -> dict:
    """The kernel-selection flags a fused rung name encodes."""
    return {"mxu": engine.endswith("_mxu"), "varying": engine.startswith("fused_varying")}


#: The one accepted drift class (JAX's wording): an explicit fused rung
#: beyond the int32 dyadic bound pairs the kernels' plain-sum quantize
#: fallback against the eager rung's blocked `miner_sum` one.
EXPECTED_DRIFT_U16_FALLBACK = (
    "u16-quantize fallback pairing: explicit fused opt-in beyond the "
    "int32 dyadic bound may differ from the XLA rung by one ulp "
    "(ADVICE r5; auto never pairs these)"
)

#: JAX's (8, 128) float32 tile: the donor-packing bucket.
SUBLANE_TILE = 8
LANE_TILE = 128

#: Epoch slabs the double-buffered streamed path keeps on the card at
#: once: the slab being scanned and the slab being copied.
STREAM_BUFFERS = 2


def ladder_from(engine: str) -> tuple:
    """The rungs at and below `engine`, in demotion order; any other
    engine gets a ladder of itself."""
    if engine in ENGINE_LADDER:
        return ENGINE_LADDER[ENGINE_LADDER.index(engine):]
    return (engine,)


@dataclasses.dataclass(frozen=True)
class ShapeBucket:
    """The shape target of one dispatch: `V` / `M` the workload's axes,
    `padded_V` / `padded_M` the tile-aligned bucket the donor-packing path
    pads to, `batch` the scenario lanes (1 = unbatched)."""

    batch: int
    epochs: int
    V: int
    M: int
    padded_V: int
    padded_M: int

    @property
    def key(self) -> str:
        return f"b{self.batch}e{self.epochs}v{self.padded_V}m{self.padded_M}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _round_up(n: int, mult: int) -> int:
    return max(mult, -(-int(n) // mult) * mult)


def bucket_shape(V: int, M: int, *, epochs: int = 0, batch: int = 1) -> ShapeBucket:
    """`[V, M]` rounded up to the (8, 128) tile: the donor-packing target.
    Padding is inert by the mechanism :func:`..sweep.pad_scenarios` proves
    (zero stakes for padded validators, a miner mask for padded miners)."""
    return ShapeBucket(
        batch=int(batch), epochs=int(epochs), V=int(V), M=int(M),
        padded_V=_round_up(V, SUBLANE_TILE), padded_M=_round_up(M, LANE_TILE),
    )


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """The memory decision of one dispatch: the preflight verdict and the
    streaming slab length. ``fits`` is None when the device capacity is
    unknown (the CPU without an override); ``chunk_epochs`` is the slab
    length the streamed path caps its slabs at (None when the whole
    stack fits, or the capacity is unknown)."""

    predicted_bytes: int
    capacity_bytes: Optional[int]
    fits: Optional[bool]
    resident_epochs: int
    chunk_epochs: Optional[int]
    double_buffered: bool
    suggestion: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """One dispatch, decided. Frozen and deterministic."""

    label: str
    engine: str
    #: The consensus impl for the chosen rung ("bisect" on the fused
    #: rungs: they bisect in-kernel).
    consensus_impl: str
    #: The consensus impl a demotion onto the eager rung uses.
    fallback_consensus: str
    ladder: tuple
    bucket: ShapeBucket
    miner_shards: int
    batch_lanes: int
    memory: MemoryPlan
    #: Why each decision fell as it did, in decision order.
    reasons: tuple
    #: The dispatch runs on a CUDA device: its ladder stops at the last
    #: hand-written rung, and a kernel that will not build or launch
    #: raises instead of demoting (:func:`..resilience.retry.run_ladder`).
    on_card: bool = False
    #: The rung's cost record (a `telemetry.cost.CostRecord` dict), set only
    #: by :meth:`attach_cost`.
    cost: Optional[dict] = None
    #: The rung resolved on the card (a `simulation.aot.AotExecutable`), set
    #: only by :meth:`attach_executable`. Left out of equality: a plan with
    #: a loaded executable is the same plan.
    executable: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)

    def to_json(self) -> dict:
        out = dataclasses.asdict(dataclasses.replace(self, executable=None))
        out["ladder"] = list(self.ladder)
        out["reasons"] = list(self.reasons)
        out["executable"] = self.executable.describe() if self.executable is not None else None
        return out

    def span_attr(self) -> dict:
        """The compact, flat summary of the plan."""
        attr = {
            "engine": self.engine,
            "consensus": self.consensus_impl,
            "bucket": self.bucket.key,
            "shards": self.miner_shards,
            "lanes": self.batch_lanes,
            "why": "; ".join(self.reasons),
        }
        if self.memory.predicted_bytes:
            attr["hbm_gib"] = round(self.memory.predicted_bytes / 2**30, 3)
            attr["fits"] = self.memory.fits
            attr["chunk_epochs"] = self.memory.chunk_epochs
        return attr

    def record(self) -> None:
        """Emit one ``event=dispatch_planned`` record (DEBUG) and stamp the
        plan summary on the open telemetry span (``attrs["plan"]``)."""
        if _tracing_now():
            return
        attr = self.span_attr()
        s = current_span()
        if s is not None:
            s.attrs["plan"] = attr
        log_event(
            logger, "dispatch_planned", level=logging.DEBUG, label=self.label,
            **{k: v for k, v in attr.items() if v is not None},
        )

    def demoted(self, rung: str) -> "DispatchPlan":
        """This plan re-anchored at a lower rung of its ladder (never an
        upper one); the eager rung takes the pre-resolved fallback
        consensus."""
        if rung == JAX_BOTTOM_RUNG:
            rung = "eager"
        if rung == self.engine:
            return self
        if rung not in self.ladder:
            raise ValueError(
                f"cannot re-anchor plan at {rung!r}: not in ladder "
                f"{self.ladder} (demotion only walks DOWN)"
            )
        return dataclasses.replace(
            self,
            engine=rung,
            consensus_impl=self.fallback_consensus if rung == "eager" else self.consensus_impl,
            ladder=self.ladder[self.ladder.index(rung):],
            reasons=self.reasons + (f"circuit breaker re-anchored dispatch at {rung!r}",),
            # An attached executable is the old rung's.
            executable=None,
        )

    def attach_cost(self, yuma_version: str = "Yuma 1 (paper)") -> "DispatchPlan":
        """A copy of this plan with its rung's cost record at its bucket's
        shape attached (host arithmetic: nothing is built or run)."""
        from yuma_simulation_tpu_torch.telemetry.cost import capture_engine_cost

        rec = capture_engine_cost(
            self.engine, self.bucket.V, self.bucket.M, max(1, self.bucket.epochs),
            yuma_version=yuma_version,
        )
        return dataclasses.replace(self, cost=rec.to_json())

    def attach_executable(
        self, yuma_version: str = "Yuma 1 (paper)", *, cache=None, **kwargs
    ) -> "DispatchPlan":
        """A copy of this plan with its rung's libraries loaded through the
        kernel cache (:func:`..aot.executable_for_plan`; a miss builds, so
        this is for warm-up, not the hot path). An eager or CPU plan is
        returned unchanged: it launches no library."""
        from yuma_simulation_tpu_torch.simulation.aot import executable_for_plan

        exe = executable_for_plan(self, yuma_version, cache=cache, **kwargs)
        if exe is None:
            return self
        return dataclasses.replace(self, executable=exe)


def _resolve_spec(spec_or_version) -> VariantSpec:
    if isinstance(spec_or_version, VariantSpec):
        return spec_or_version
    return variant_for_version(spec_or_version)


def _plan_engine(
    epoch_impl: str,
    consensus_impl: str,
    shape: Sequence[int],
    config,
    dtype,
    device: torch.device,
    streaming: bool,
    has_miner_mask: bool,
    reasons: list,
    quarantine: bool = False,
    mesh=None,
) -> tuple[str, str]:
    """The one engine / consensus resolution of the case-scan entry
    points. Returns `(engine, consensus_impl)` resolved. A streaming plan
    is made on the first slab, and the slabs' lengths are the caller's:
    "auto" then takes the varying scan, which runs each slab at its own
    tile, whatever the first slab's length."""
    if consensus_impl not in ("auto", "sorted", "bisect", "kernel"):
        raise ValueError(
            f"unknown consensus_impl {consensus_impl!r}; "
            "expected 'auto', 'sorted', 'bisect' or 'kernel'"
        )
    epochs, M = shape[-3], shape[-1]
    grid_fits = dyadic_grid_fits_int32(M, bisection_iterations(config.consensus_precision))
    fusable = consensus_impl in ("auto", "bisect") and dtype == torch.float32
    if epoch_impl == JAX_BOTTOM_RUNG:
        epoch_impl = "eager"
        reasons.append("'xla' is the JAX package's name of the bottom rung: 'eager'")
    if epoch_impl == "auto":
        why = (
            "miner-sharding mesh" if mesh is not None
            else "quarantine guard rides the XLA carry" if quarantine
            else "per-scenario miner mask" if has_miner_mask
            else f"consensus_impl={consensus_impl!r}" if consensus_impl not in ("auto", "bisect")
            else "zero epochs" if epochs < 1
            else f"dtype {dtype}" if dtype != torch.float32
            else f"{device.type} device" if device.type != "cuda"
            else "dyadic quantize grid past int32" if not grid_fits
            else None
        )
        if why is not None:
            epoch_impl = "eager"
            reasons.append(f"auto->eager: {why}")
        else:
            tile = varying_scan_epoch_tile(tuple(shape))
            epoch_impl = "fused_varying" if tile >= 2 or streaming else "fused_scan"
            reasons.append(
                f"auto->{epoch_impl}: "
                + ("streaming: the varying scan takes each slab at its own tile" if streaming
                   else f"epoch-tiled varying scan (tile={tile})" if tile >= 2
                   else "no epoch tile >= 2 divides E: the case scan")
                + ("; the VPU support sum where JAX takes the _mxu twin: bitwise the "
                   "same and faster on the card (PERF.md, B5)"
                   if exact_mxu_support_covers(shape[-2]) else "")
            )
    if epoch_impl in FUSED_CASE_RUNGS:
        if mesh is not None:
            raise ValueError(
                "the fused case/varying scans are single-device kernels; "
                "miner-axis sharding requires epoch_impl='eager'"
            )
        if quarantine:
            raise ValueError(
                "quarantine rides the XLA scan carry; the fused case scan "
                "cannot host it — use epoch_impl='eager' (or 'auto', which "
                "resolves to 'eager' under quarantine)"
            )
        if has_miner_mask:
            raise ValueError(
                "the batched fused case scan has no per-scenario miner "
                "masks; heterogeneous suites use epoch_impl='eager'"
            )
        if consensus_impl == "sorted":
            raise ValueError(
                "the fused case scan computes consensus by bisection; "
                "consensus_impl='sorted' requires epoch_impl='eager'"
            )
        if not fusable:
            raise ValueError(
                f"epoch_impl={epoch_impl!r} bisects in-kernel on float32: it needs "
                "consensus_impl 'auto' or 'bisect' and dtype torch.float32"
            )
        if not grid_fits:
            reasons.append(EXPECTED_DRIFT_U16_FALLBACK)
        return epoch_impl, consensus_impl
    if epoch_impl != "eager":
        raise ValueError(
            f"unknown epoch_impl {epoch_impl!r}; expected 'auto', 'eager' ('xla'), "
            "'fused_scan', 'fused_scan_mxu', 'fused_varying' or 'fused_varying_mxu'"
        )
    return "eager", resolve_consensus_impl(consensus_impl, *shape[-2:])


def scan_scratch_bytes(engine: str, V: int, M: int) -> int:
    """One lane's scratch of a fused rung's scan at its largest tile, 16
    epochs (`ops/cuda_epoch.py::_scratch_layout`); 0 on the eager rung."""
    if engine not in FUSED_CASE_RUNGS:
        return 0
    return _scratch_layout(VARYING_EPOCH_TILE_MAX, 1, int(V), int(M))[0]


def _plan_memory(
    label: str,
    engine: str,
    V: int,
    M: int,
    epochs: int,
    itemsize: int,
    *,
    save_bonds: bool,
    save_incentives: bool,
    save_consensus: bool,
    batch_lanes: int,
    max_resident_epochs: Optional[int],
    streaming: bool,
    device: torch.device,
    layout=None,
    raise_on_reject: bool = True,
) -> MemoryPlan:
    """The preflight of the resident footprint and the streaming slab
    length: host arithmetic on shapes. A fused rung's scratch is taken at
    the largest tile (16 epochs), a fixed term of the estimate. With a
    miner layout (:class:`..models.miner_shards.MinerLayout`) the
    footprint is one shard's times the shards on the busiest physical
    device, held to that device's memory."""
    resident = min(epochs, max_resident_epochs) if max_resident_epochs is not None else epochs
    kwargs = dict(
        itemsize=itemsize, save_bonds=save_bonds, save_incentives=save_incentives,
        save_consensus=save_consensus, batch_lanes=batch_lanes,
        scratch_bytes=scan_scratch_bytes(engine, V, M),
    )
    if layout is not None:
        counts = layout.shards_per_device()
        device = max(counts, key=counts.get)
        kwargs.update(miner_shards=layout.shards, shards_per_device=counts[device])
    estimate = estimate_hbm_bytes(V, M, resident_epochs=resident, **kwargs)
    verdict = preflight_hbm(
        label, estimate, raise_on_reject=raise_on_reject and not streaming, device=device
    )
    chunk_epochs: Optional[int] = None
    spec = resolve_device_spec(device=device)
    if spec.memory_bytes and preflight_enabled():
        budget = int(spec.memory_bytes * DEFAULT_MEMORY_FRACTION)
        one = estimate_hbm_bytes(V, M, resident_epochs=1, **kwargs)
        zero = estimate_hbm_bytes(V, M, resident_epochs=0, **kwargs)
        per_epoch = max(1, one.total_bytes - zero.total_bytes)
        fixed = zero.total_bytes
        if budget > fixed:
            chunk_epochs = max(1, (budget - fixed) // (STREAM_BUFFERS * per_epoch))
            if engine.startswith("fused_varying") and chunk_epochs >= VARYING_EPOCH_TILE_MAX:
                # K3 runs a slab at the largest tile <= 16 that divides its
                # length: a slab of a prime length would run untiled.
                chunk_epochs -= chunk_epochs % VARYING_EPOCH_TILE_MAX
        elif streaming:
            # The fixed working set alone is past the budget: no slab
            # length fixes that, so a stream is refused as a monolith is.
            preflight_hbm(label, zero, raise_on_reject=raise_on_reject, device=device)
            chunk_epochs = 1
        if not streaming and verdict.fits is not False:
            chunk_epochs = None
    return MemoryPlan(
        predicted_bytes=estimate.total_bytes,
        capacity_bytes=verdict.capacity_bytes,
        fits=verdict.fits,
        resident_epochs=resident,
        chunk_epochs=chunk_epochs,
        double_buffered=streaming,
        suggestion=verdict.suggestion,
    )


def plan_dispatch(
    label: str,
    shape: Sequence[int],
    spec_or_version,
    config,
    dtype,
    *,
    epoch_impl: str = "auto",
    consensus_impl: str = "bisect",
    save_bonds: bool = False,
    save_incentives: bool = False,
    save_consensus: bool = False,
    mesh=None,
    streaming: bool = False,
    quarantine: bool = False,
    has_miner_mask: bool = False,
    max_resident_epochs: Optional[int] = None,
    check_memory: bool = True,
    device="cuda",
    raise_on_reject: bool = True,
) -> DispatchPlan:
    """Plan one case-scan dispatch of `shape` (`[E, V, M]` or `[B, E, V,
    M]`) on `device` (planning needs no card: it is host arithmetic).
    Raises the errors of a bad request (impl names, fused-rung
    preconditions) and :class:`..telemetry.cost.HBMPreflightError` for a
    monolithic shape that cannot fit; a streaming plan sizes
    `memory.chunk_epochs` instead. `check_memory=False` skips the memory
    plan (the batched entry points: the arrays are already placed).
    `quarantine=True` (the per-lane non-finite guard, which only the eager
    rung's carry hosts) resolves "auto" to "eager", as the JAX package's
    resolves it to its XLA rung, and makes an explicit fused rung raise.
    So does a miner-sharding `mesh`: "auto" plans the eager rung, an
    explicit fused rung raises, and the memory plan holds one shard's
    footprint times the shards on each physical device (the devices of
    the mesh's first row) to that device's memory. `raise_on_reject=False`
    returns a plan whose `memory.fits` is False instead of raising (the
    serving tier's admission pricer)."""
    shape = tuple(int(d) for d in shape)
    if len(shape) == 3:
        batch, (E, V, M) = 1, shape
    elif len(shape) == 4:
        batch, E, V, M = shape
    else:
        raise ValueError(f"plan_dispatch expects [E, V, M] or [B, E, V, M], got {shape}")
    dev = torch.device(device)
    _resolve_spec(spec_or_version)  # an unknown version is a caller error here too
    reasons: list = []
    if epoch_impl != "auto":
        reasons.append(f"engine {epoch_impl!r} requested explicitly")
    layout = None
    if mesh is not None:
        from yuma_simulation_tpu_torch.models.miner_shards import MinerLayout

        layout = MinerLayout.build([d.device for d in mesh.grid[0]], M)
    engine, resolved_consensus = _plan_engine(
        epoch_impl, consensus_impl, shape, config, dtype, dev, streaming,
        has_miner_mask, reasons, quarantine=quarantine, mesh=mesh,
    )
    miner_shards = 1 if layout is None else layout.shards
    if miner_shards > 1:
        reasons.append(f"miner axis sharded over {miner_shards} devices")
    fallback_consensus = (
        resolved_consensus if engine == "eager" else resolve_consensus_impl(consensus_impl, V, M)
    )
    if check_memory:
        memory = _plan_memory(
            label, engine, V, M, E, torch.empty((), dtype=dtype).element_size(),
            save_bonds=save_bonds, save_incentives=save_incentives,
            save_consensus=save_consensus, batch_lanes=batch,
            max_resident_epochs=max_resident_epochs, streaming=streaming, device=dev,
            layout=layout, raise_on_reject=raise_on_reject,
        )
        if streaming and memory.chunk_epochs is not None:
            reasons.append(
                f"streaming slabs capped at {memory.chunk_epochs} epochs "
                f"({STREAM_BUFFERS} buffers resident)"
            )
    else:
        memory = MemoryPlan(
            predicted_bytes=0, capacity_bytes=None, fits=None, resident_epochs=E,
            chunk_epochs=None, double_buffered=streaming,
        )
    if max_resident_epochs is not None and streaming is False and E > max_resident_epochs:
        reasons.append(f"caller caps residency at {max_resident_epochs} epochs")
    ladder = ladder_from(engine)
    if not exact_mxu_support_covers(V):
        ladder = tuple(r for r in ladder if r == engine or not r.endswith("_mxu"))
    on_card = dev.type == "cuda"
    if on_card and engine != "eager" and "eager" in ladder:
        # On the card every fused rung is a hand-written kernel and the
        # eager rung is plain PyTorch: demotion may trade one kernel for
        # another, never a kernel for its plain version.
        ladder = ladder[:-1]
        reasons.append("on the card the ladder stops at the last kernel rung")
    return DispatchPlan(
        label=label,
        engine=engine,
        consensus_impl=resolved_consensus,
        fallback_consensus=fallback_consensus,
        ladder=ladder,
        bucket=bucket_shape(V, M, epochs=E, batch=batch),
        miner_shards=miner_shards,
        batch_lanes=batch,
        memory=memory,
        reasons=tuple(reasons),
        on_card=on_card,
    )


# ---------------------------------------------------------------------------
# the throughput paths

#: The scaled path's rungs; the batch takes the scans and the eager rung.
SCALED_IMPLS = ("auto", "eager", "fused", "fused_mxu", "fused_scan", "fused_scan_mxu")
SCALED_BATCH_IMPLS = ("auto", "eager", "fused_scan", "fused_scan_mxu")


def resolve_scaled_engine(
    shape: Sequence[int],
    mode,
    config,
    dtype,
    num_epochs: int,
    *,
    device="cuda",
    epoch_impl: str = "auto",
    consensus_impl: str = "bisect",
    batched: bool = False,
) -> str:
    """The rung of `simulate_scaled` (`shape [V, M]`) or
    `simulate_scaled_batch` (`[B, V, M]`, `batched=True`). "auto" is the
    scaled scan (K5) with the VPU support ("fused_scan") on float32 CUDA
    tensors with at least one epoch while the dyadic quantize grid fits
    int32, else "eager". Its tensor-core twin is bitwise the same and was
    not measurably faster at 256 x 4096 on an NVIDIA H100 80GB HBM3 at
    700 W (PERF.md, B5). JAX's VMEM admission and its x64 Yuma 0 gate (a
    double-single emulation) do not carry over; `mode` is accepted for
    JAX's signature (K5 runs all five bond models). An explicit
    `epoch_impl` is checked against the entry point's rungs and returned
    ("xla", JAX's name, as "eager"); `consensus_impl` is checked on every
    rung (the fused ones bisect in-kernel and do not read it)."""
    del mode
    resolve_consensus_impl(consensus_impl, *shape[-2:])
    if epoch_impl == JAX_BOTTOM_RUNG:
        epoch_impl = "eager"
    impls = SCALED_BATCH_IMPLS if batched else SCALED_IMPLS
    if epoch_impl not in impls:
        name = "simulate_scaled_batch" if batched else "simulate_scaled"
        raise ValueError(f"unknown epoch_impl {epoch_impl!r} for {name}; expected one of {impls}")
    if epoch_impl != "auto":
        return epoch_impl
    if (
        torch.device(device).type != "cuda"
        or dtype != torch.float32
        or num_epochs < 1
        or not dyadic_grid_fits_int32(shape[-1], bisection_iterations(config.consensus_precision))
    ):
        return "eager"
    return "fused_scan"


def resolve_montecarlo_engine(epoch_impl: str, varying: bool) -> str:
    """The Monte-Carlo `epoch_impl="auto"` resolution: "hoisted" for
    epoch-constant weights (consensus once), "eager" for per-epoch weights
    (nothing is hoistable); "xla" is accepted as "eager"."""
    if epoch_impl == JAX_BOTTOM_RUNG:
        epoch_impl = "eager"
    if epoch_impl == "auto":
        return "eager" if varying else "hoisted"
    if epoch_impl not in ("hoisted", "eager"):
        raise ValueError(
            f"unknown epoch_impl {epoch_impl!r}; expected 'auto', 'hoisted' or 'eager' ('xla')"
        )
    if varying and epoch_impl == "hoisted":
        raise ValueError(
            "weights_mode='per_epoch' re-perturbs the weights every "
            "epoch; nothing is hoistable; use epoch_impl='eager'/'auto'"
        )
    return epoch_impl

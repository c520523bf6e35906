"""Admission control: validate and PRICE every request before any launch.

The serving tier's first robustness gate. A hostile or mistaken request
must be rejected while it is still cheap — after JSON parsing, before
any kernel launch or device allocation — with a typed
:class:`..resilience.errors.AdmissionRejected` that tells the client
*why* and, when the analytic HBM preflight produced one, *what would
fit* (its shard-count / ``max_resident_epochs`` suggestion). The
machinery is exactly the planner's
(:func:`..simulation.planner.plan_dispatch` with
``raise_on_reject=False``), run for the service's device so that the
preflight on the card reads the card's memory: pure host arithmetic,
zero launches, so admission costs microseconds even under a burst.

The output is an :class:`AdmissionTicket`: the parsed request plus its
frozen :class:`..simulation.planner.DispatchPlan` and the coalescing key
(shape bucket + version + config fingerprint) the dispatcher groups
same-bucket tenants by.

Engine names are the port's planner's: the bottom rung is ``"eager"``,
and the JAX package's name of it, ``"xla"``, is accepted here and
normalized, so that every later comparison reads one name.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import replace
from typing import NoReturn, Optional, Sequence

import numpy as np

from yuma_simulation_tpu_torch.resilience.errors import AdmissionRejected

#: Engines a request may name; "auto" resolves through the planner, and
#: "xla" (the JAX package's name of the eager rung) means "eager".
_ENGINES = (
    "auto",
    "eager",
    "xla",
    "fused_scan",
    "fused_scan_mxu",
    "fused_varying",
    "fused_varying_mxu",
)

#: Hard per-request shape ceilings — a parse-time sanity bound so a
#: hostile payload cannot make the server materialize absurd host
#: arrays before the preflight even runs. Generous: the bench flagship
#: (256 x 4096 x 10k epochs) fits with room.
MAX_EPOCHS = 1 << 20
MAX_VALIDATORS = 1 << 14
MAX_MINERS = 1 << 18

#: Hard cap on a sweep's grid cardinality: the cartesian product of the
#: axes is materialized host-side at dispatch, so an unbounded `axes`
#: payload would be exactly the host-memory DoS the array ceilings above
#: exist to stop.
MAX_SWEEP_POINTS = 4096


@dataclasses.dataclass(frozen=True)
class AdmissionTicket:
    """One admitted request, fully decided: what to run, on which plan,
    under which deadline — everything the dispatcher needs without
    re-touching the raw payload."""

    request_id: str
    tenant: str
    kind: str  # "simulate" | "sweep" | "table" | "whatif"
    version: str
    scenario: Optional[object]  # Scenario for simulate/sweep
    config: object  # YumaConfig
    config_key: tuple  # hashable fingerprint of the config overrides
    axes: Optional[dict]  # sweep hyperparameter grid
    versions: Optional[tuple]  # table versions
    plan: object  # DispatchPlan
    engine: str
    quarantine: bool
    deadline_seconds: float
    admitted_t: float  # time.monotonic() at admission
    #: Coalescing group key: requests sharing it ride one batched
    #: dispatch (donor-packed on the eager rung, stacked on a kernel
    #: rung). None = never coalesced (sweep/table/what-if requests).
    coalesce_key: Optional[tuple] = None
    #: Degradation priority: while an SLO fast-burn has the service
    #: shedding, requests below the configured floor are dropped first
    #: (0 = normal traffic; negotiated tenants send higher).
    priority: int = 0
    #: The parsed :class:`..replay.whatif.WhatIfSpec` for
    #: ``kind="whatif"`` requests (None otherwise). The plan above is
    #: SUFFIX-sized for these: admission prices the epochs the dispatch
    #: will actually re-simulate from the cached checkpoint, not the
    #: full baseline length.
    whatif: Optional[object] = None

    def remaining_seconds(self) -> float:
        return self.deadline_seconds - (time.monotonic() - self.admitted_t)


def _reject(
    message: str, *, reason: str = "invalid_request", **kw
) -> NoReturn:
    raise AdmissionRejected(message, reason=reason, **kw)


def _require(payload: dict, field: str):
    if field not in payload:
        _reject(f"request is missing required field {field!r}")
    return payload[field]


def _as_float_array(value, field: str, ndim: int) -> np.ndarray:
    try:
        arr = np.asarray(value, dtype=np.float32)
    except (TypeError, ValueError):
        _reject(f"field {field!r} is not a numeric array")
    if arr.ndim != ndim:
        _reject(
            f"field {field!r} must be {ndim}-dimensional, got shape "
            f"{arr.shape}"
        )
    return arr


def _build_config(overrides: Optional[dict]):
    """A `YumaConfig` from a flat float-field override dict — the same
    field universe `config_grid` sweeps (static/compiled fields are not
    request-settable: they select different compiled programs, which a
    warm-engine service must not let a payload do)."""
    from yuma_simulation_tpu_torch.models.config import (
        SimulationHyperparameters,
        YumaConfig,
        YumaParams,
    )

    sim = SimulationHyperparameters()
    par = YumaParams()
    if not overrides:
        return YumaConfig(simulation=sim, yuma_params=par), ()
    if not isinstance(overrides, dict):
        _reject("field 'config' must be an object of float fields")
    sim_fields = {f for f in vars(sim) if f != "consensus_precision"}
    par_fields = {
        f
        for f in vars(par)
        if f
        not in (
            "liquid_alpha",
            "override_consensus_high",
            "override_consensus_low",
        )
    }
    key = []
    for name, value in sorted(overrides.items()):
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            _reject(f"config field {name!r} must be a number")
        if name in sim_fields:
            sim = replace(sim, **{name: float(value)})
        elif name in par_fields:
            par = replace(par, **{name: float(value)})
        else:
            _reject(
                f"config field {name!r} is not request-settable "
                "(unknown or compile-static)"
            )
        key.append((name, float(value)))
    return YumaConfig(simulation=sim, yuma_params=par), tuple(key)


def _build_scenario(payload: dict, request_id: str):
    """The request's Scenario: a registered case by name, or explicit
    `[E, V, M]` weights + `[E, V]` stakes arrays."""
    from yuma_simulation_tpu_torch.scenarios.base import Scenario, create_case

    case_name = payload.get("case")
    if case_name is not None:
        try:
            return create_case(str(case_name))
        except ValueError as exc:
            _reject(str(exc))
    weights = _as_float_array(_require(payload, "weights"), "weights", 3)
    stakes = _as_float_array(_require(payload, "stakes"), "stakes", 2)
    E, V, M = weights.shape
    if not (1 <= E <= MAX_EPOCHS):
        _reject(f"epochs {E} outside [1, {MAX_EPOCHS}]")
    if not (1 <= V <= MAX_VALIDATORS):
        _reject(f"validators {V} outside [1, {MAX_VALIDATORS}]")
    if not (1 <= M <= MAX_MINERS):
        _reject(f"miners {M} outside [1, {MAX_MINERS}]")
    if stakes.shape != (E, V):
        _reject(
            f"stakes shape {stakes.shape} does not match weights "
            f"[E={E}, V={V}]"
        )
    reset_index = payload.get("reset_bonds_index")
    reset_epoch = payload.get("reset_bonds_epoch")
    for name, val in (
        ("reset_bonds_index", reset_index),
        ("reset_bonds_epoch", reset_epoch),
    ):
        if val is not None and not isinstance(val, int):
            _reject(f"field {name!r} must be an integer epoch/index")
    validators = [f"v{i}" for i in range(V)]
    return Scenario(
        name=f"request:{request_id}",
        validators=validators,
        base_validator=validators[0],
        weights=weights,
        stakes=stakes,
        num_epochs=E,
        reset_bonds_index=reset_index,
        reset_bonds_epoch=reset_epoch,
    )


def _plan_or_reject(
    label: str,
    shape: Sequence[int],
    version: str,
    config,
    *,
    engine: str,
    quarantine: bool,
    device,
):
    """Run the planner as the admission pricer on `device`: planner
    `ValueError`s (bad impl combinations) become typed rejections, and a
    preflight verdict of "cannot fit" rejects WITH the planner's
    suggestion — before anything launched."""
    import torch

    from yuma_simulation_tpu_torch.simulation.planner import plan_dispatch

    try:
        plan = plan_dispatch(
            label,
            shape,
            version,
            config,
            torch.float32,
            epoch_impl=engine,
            quarantine=quarantine,
            raise_on_reject=False,
            device=device,
        )
    except (ValueError, KeyError) as exc:
        _reject(str(exc))
    if plan.memory.fits is False:
        _reject(
            f"predicted HBM footprint "
            f"{plan.memory.predicted_bytes / 2**30:.2f} GiB exceeds "
            "device capacity"
            + (
                f" ({plan.memory.capacity_bytes / 2**30:.2f} GiB)"
                if plan.memory.capacity_bytes
                else ""
            ),
            reason="preflight_rejected",
            suggestion=plan.memory.suggestion,
        )
    return plan


def admit(
    payload: dict,
    *,
    request_id: str,
    kind: str,
    default_deadline_seconds: float,
    max_unit_lanes: int = 64,
    tenant_priority: Optional[dict] = None,
    replay=None,
    device="cuda",
) -> AdmissionTicket:
    """Validate and price one request for `device` (the service's);
    returns the ticket or raises a typed :class:`AdmissionRejected`.
    Zero launches by construction.

    `replay` (a :class:`..replay.ReplayService`, None when the
    deployment mounts no replay tier) admits ``kind="whatif"``: the
    spec parses/validates from the payload's ``whatif`` object, the
    subnet resolves against the archive index, and the plan prices the
    SUFFIX the dispatch will actually simulate — ``describe()`` is
    index/meta reads plus the planner's host arithmetic, so a what-if
    admission stays as launch-free as every other kind."""
    from yuma_simulation_tpu_torch.models.variants import variant_for_version

    if not isinstance(payload, dict):
        _reject("request body must be a JSON object")
    tenant = payload.get("tenant", "anonymous")
    if not isinstance(tenant, str) or not tenant:
        _reject("field 'tenant' must be a non-empty string")
    version = payload.get("version", "Yuma 1 (paper)")
    if kind == "whatif" and "whatif" in payload:
        raw_spec = payload["whatif"]
        if isinstance(raw_spec, dict) and "version" in raw_spec:
            # The what-if's variant rides the spec, not the envelope.
            version = raw_spec["version"]
    try:
        variant_for_version(version)
    except (ValueError, KeyError, TypeError) as exc:
        _reject(f"unknown version {version!r}: {exc}")
    engine = payload.get("engine", "auto")
    if engine not in _ENGINES:
        _reject(f"unknown engine {engine!r}; expected one of {_ENGINES}")
    if engine == "xla":
        engine = "eager"
    deadline = payload.get("deadline_seconds", default_deadline_seconds)
    if not isinstance(deadline, (int, float)) or deadline <= 0:
        _reject("field 'deadline_seconds' must be a positive number")
    priority = payload.get("priority", 0)
    if not isinstance(priority, int) or isinstance(priority, bool):
        _reject("field 'priority' must be an integer")
    if tenant_priority is not None:
        # The payload field is untrusted: with a negotiated ceiling
        # table installed, a tenant rides at most its entry (absent
        # tenants at 0), so degradation cannot be opted out of by
        # simply claiming priority in the request body.
        priority = min(priority, int(tenant_priority.get(tenant, 0)))
    config, config_key = _build_config(payload.get("config"))
    quarantine = bool(
        payload.get("quarantine", engine in ("auto", "eager"))
    )
    from yuma_simulation_tpu_torch.simulation.planner import FUSED_CASE_RUNGS

    if quarantine and engine in FUSED_CASE_RUNGS:
        _reject(
            "quarantine rides the eager rung's scan carry; a fused-engine "
            "request must pass quarantine=false"
        )

    scenario = None
    axes = None
    versions = None
    coalesce_key = None
    whatif_spec = None
    if kind == "whatif":
        if replay is None:
            _reject(
                "this deployment mounts no replay tier (configure "
                "replay_archive_dir/replay_cache_dir to serve what-ifs)",
                reason="replay_unconfigured",
            )
        from yuma_simulation_tpu_torch.replay import ArchiveError, WhatIfError
        from yuma_simulation_tpu_torch.replay.whatif import WhatIfSpec

        try:
            whatif_spec = WhatIfSpec.from_json(_require(payload, "whatif"))
        except WhatIfError as exc:
            _reject(str(exc))
        try:
            desc = replay.describe(whatif_spec)
        except ArchiveError as exc:
            _reject(str(exc), reason="unknown_subnet")
        except WhatIfError as exc:
            _reject(str(exc))
        # Suffix-sized pricing: the dispatch re-simulates only
        # [resume_epoch, E) from the cached checkpoint; that is the
        # footprint admission charges (and the preflight bounds).
        plan = _plan_or_reject(
            f"serve:whatif:{request_id}",
            (
                max(1, desc["suffix_epochs"]),
                desc["validators"],
                desc["miners"],
            ),
            whatif_spec.version,
            config,
            engine="auto",
            quarantine=False,
            device=device,
        )
    elif kind == "simulate":
        scenario = _build_scenario(payload, request_id)
        E, V, M = scenario.weights.shape
        plan = _plan_or_reject(
            f"serve:simulate:{request_id}",
            (E, V, M),
            version,
            config,
            engine=engine,
            quarantine=quarantine,
            device=device,
        )
        if plan.engine == "eager":
            # Donor-packing group: same tile bucket + same epochs +
            # same version/config/quarantine rides ONE batched dispatch
            # (the planner's bucket policy — epochs are data, never
            # bucketed).
            coalesce_key = (
                "simulate",
                version,
                config_key,
                quarantine,
                plan.bucket.epochs,
                plan.bucket.padded_V,
                plan.bucket.padded_M,
            )
        elif plan.engine in FUSED_CASE_RUNGS:
            # A kernel rung takes no per-lane miner mask: only requests
            # of the exact same [E, V, M] shape (and rung) stack into one
            # batched launch.
            coalesce_key = (
                "simulate",
                version,
                config_key,
                quarantine,
                plan.engine,
                E,
                V,
                M,
            )
    elif kind == "sweep":
        scenario = _build_scenario(payload, request_id)
        raw_axes = _require(payload, "axes")
        if not isinstance(raw_axes, dict) or not raw_axes:
            _reject("field 'axes' must be a non-empty object of lists")
        axes = {}
        points = 1
        for name, values in sorted(raw_axes.items()):
            if not isinstance(values, (list, tuple)) or not values:
                _reject(f"axis {name!r} must be a non-empty list")
            if not all(
                isinstance(v, (int, float)) and not isinstance(v, bool)
                for v in values
            ):
                _reject(f"axis {name!r} values must be numbers")
            axes[name] = [float(v) for v in values]
            points *= len(values)
            if points > MAX_SWEEP_POINTS:
                _reject(
                    f"sweep grid exceeds {MAX_SWEEP_POINTS} points; "
                    "split the axes across requests (or run it through "
                    "the fleet fabric's run_fleet_grid)"
                )
        # Validate the axis names the same way config_grid will.
        from yuma_simulation_tpu_torch.simulation.sweep import config_grid

        try:
            config_grid(**{k: v[:1] for k, v in axes.items()})
        except ValueError as exc:
            _reject(str(exc))
        E, V, M = scenario.weights.shape
        # Price the batch the dispatcher will actually place: the grid
        # partitions into units of at most `max_unit_lanes` lanes, so a
        # large-but-unit-partitioned sweep must not be rejected on a
        # monolithic footprint it never dispatches.
        plan = _plan_or_reject(
            f"serve:sweep:{request_id}",
            (min(points, max_unit_lanes), E, V, M),
            version,
            config,
            engine="eager",
            quarantine=quarantine,
            device=device,
        )
    elif kind == "table":
        from yuma_simulation_tpu_torch.models.config import YumaSimulationNames

        names = vars(YumaSimulationNames()).values()
        raw_versions = payload.get("versions")
        if raw_versions is None:
            versions = (version,)
        else:
            if not isinstance(raw_versions, (list, tuple)) or not raw_versions:
                _reject("field 'versions' must be a non-empty list")
            for v in raw_versions:
                if v not in names:
                    _reject(f"unknown version {v!r} in 'versions'")
            versions = tuple(raw_versions)
        from yuma_simulation_tpu_torch.scenarios.base import get_cases

        suite = get_cases()
        E, V, M = suite[0].weights.shape
        plan = _plan_or_reject(
            f"serve:table:{request_id}",
            (len(suite), E, V, M),
            versions[0],
            config,
            engine="auto",
            quarantine=False,
            device=device,
        )
    else:
        _reject(f"unknown request kind {kind!r}")

    return AdmissionTicket(
        request_id=request_id,
        tenant=tenant,
        kind=kind,
        version=version,
        scenario=scenario,
        config=config,
        config_key=config_key,
        axes=axes,
        versions=versions,
        plan=plan,
        engine=engine,
        quarantine=quarantine,
        deadline_seconds=float(deadline),
        admitted_t=time.monotonic(),
        coalesce_key=coalesce_key,
        priority=priority,
        whatif=whatif_spec,
    )

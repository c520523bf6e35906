"""Sweep supervisor: idempotent units under deadline + retry + quarantine
(the JAX package's `resilience/supervisor.py`).

The top of the resilience stack. The lower tiers each contain ONE
failure class — the ladder contains engine failures, the watchdog
contains hangs, the elastic mesh contains device loss, the quarantine
contains NaN lanes, `CheckpointedSweep` contains torn chunks — but a
pod-scale Monte-Carlo sweep meets all of them in one run, and something
has to compose the tiers, keep the bookkeeping, and tell the operator
what actually happened. That is the :class:`SweepSupervisor`:

- the sweep is partitioned into **idempotent units** (contiguous slices
  of the scenario batch or hyperparameter grid — pure functions of their
  inputs, so re-executing a unit is always safe);
- each unit dispatches under the deadline watchdog, the engine-retry
  ladder, the per-lane quarantine, and (sharded) elastic mesh
  degradation, on the device its tensors live on (the card unless the
  caller passes `device="cpu"`);
- every per-unit outcome is appended to a crash-safe JSONL
  :class:`FailureLedger` (atomic fsync+rename publish via
  :func:`..utils.checkpoint.publish_atomic` — a crash mid-append leaves
  the previous ledger, never a torn line);
- with a `directory`, unit results snapshot through
  :class:`..utils.checkpoint.CheckpointedSweep`, so a killed sweep
  resumes from its completed units and a corrupt chunk requeues its
  unit — the ledger and the chunk store live side by side in the same
  directory;
- the return value carries a :class:`SweepHealthReport`: engines used,
  demotions walked, stalls killed, lanes quarantined, units
  retried/requeued — the operator's one-glance answer to "what degraded
  while I wasn't looking", cross-checkable against the `event=` log
  records and the ledger line by line.

Deadline placement (one watchdog per dispatch, never nested): unsharded
units thread the deadline INTO the engine ladder — each rung attempt
gets its own budget, a stall classifies and retries/demotes like any
engine failure. Sharded units thread it into the elastic dispatch the
same way — one watchdog per MESH ATTEMPT, with the shrink logic on the
caller side of the heartbeat, so each rung of a degradation walk (cold
compile included) gets a fresh budget. An outer budget wrapping an
inner recovery loop would kill the loop mid-recovery — exactly the
false positive a watchdog must not produce.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from yuma_simulation_tpu_torch.resilience.errors import (
    EngineStall,
    classify_failure,
)
from yuma_simulation_tpu_torch.resilience.guards import (
    QuarantineEntry,
    QuarantineReport,
)
from yuma_simulation_tpu_torch.resilience.retry import (
    RetryPolicy,
    default_retry_policy,
)
from yuma_simulation_tpu_torch.resilience.watchdog import Deadline
from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

#: Production default dispatch budget: generous enough for a cold build of
#: every kernel (nvcc) and the largest supported shapes, small enough that
#: a genuinely hung dispatch is killed well inside a sweep's lifetime.
#: Retries get the same again on top (`grace_seconds`) since a retry may
#: rebuild from scratch.
DEFAULT_UNIT_BUDGET_SECONDS = 900.0


def canary_stride(fraction: float) -> int:
    """The deterministic unit-index stride a canary fraction selects
    (unit idx % stride == 0 is canaried; no RNG, so a re-run of the
    same sweep canaries the same units). ONE spelling shared with the
    fleet scheduler's fleet-scope selection — a forked rounding rule
    would canary different units per scope. Quantization note: stride
    sampling rounds to the nearest 1/N, so e.g. 0.4 selects every 2nd
    unit (50%) and anything above ~2/3 selects every unit."""
    return max(1, int(round(1.0 / fraction)))


def default_deadline() -> Deadline:
    """The production default unit deadline (15 min + 15 min retry grace)."""
    return Deadline(
        budget_seconds=DEFAULT_UNIT_BUDGET_SECONDS,
        grace_seconds=DEFAULT_UNIT_BUDGET_SECONDS,
    )


class FailureLedger:
    """Crash-safe JSONL of per-unit sweep outcomes.

    Each appended record is one JSON object per line. The whole file is
    re-published atomically per append (temp + fsync + rename — the
    checkpoint layer's primitive), so at every instant the on-disk
    ledger is a complete, parseable prefix of the sweep's history; a
    torn trailing line cannot exist by construction, but a load
    tolerates one anyway (a ledger written by a pre-atomic tool must
    not brick the directory — the torn tail is dropped with a warning).
    Records are small (a few hundred bytes) and units are coarse, so
    rewrite-per-append stays trivial I/O even for thousand-unit sweeps.

    `path=None` keeps the ledger in memory only — same API, no
    durability — for supervised sweeps without a checkpoint directory.
    """

    def __init__(self, path: Optional[str | pathlib.Path] = None):
        self.path = pathlib.Path(path) if path is not None else None
        self._entries: list[dict] = []
        if self.path is not None and self.path.exists():
            for lineno, line in enumerate(self.path.read_text().splitlines()):
                if not line.strip():
                    continue
                try:
                    self._entries.append(json.loads(line))
                except json.JSONDecodeError:
                    # Skip, don't stop: a corrupt MIDDLE line (bit rot,
                    # a non-atomic external writer) must not discard the
                    # valid records after it — the next append would
                    # republish the truncated history and erase them.
                    logger.warning(
                        "dropping undecodable ledger line %d in %s "
                        "(torn write from a non-atomic writer?)",
                        lineno,
                        self.path,
                    )
                    continue

    def append(self, event: str, **fields) -> dict:
        """Append one outcome record and (if durable) publish the
        updated ledger atomically. Returns the record.

        Records are stamped with a wall-clock ``t`` and — when a
        telemetry :class:`..telemetry.runctx.RunContext` is active —
        ``run_id``/``span_id``/``parent_id``, the join key against the
        flight recorder's span tree and the `event=` log stream.
        Purely ADDITIVE keys: pre-telemetry ledger readers still parse
        every record (caller-passed fields of the same name win)."""
        record = {"event": event, **fields}
        record.setdefault("t", round(time.time(), 6))
        try:
            from yuma_simulation_tpu_torch.telemetry.runctx import current_fields

            for key, value in current_fields().items():
                record.setdefault(key, value)
        except Exception:
            pass
        self._entries.append(record)
        if self.path is not None:
            payload = "".join(
                json.dumps(e, sort_keys=True) + "\n" for e in self._entries
            )
            publish_atomic(self.path, payload.encode())
        return record

    def entries(self, event: Optional[str] = None) -> tuple:
        """All records, oldest first; `event` filters by record type."""
        if event is None:
            return tuple(self._entries)
        return tuple(e for e in self._entries if e.get("event") == event)

    def __len__(self) -> int:
        return len(self._entries)


@dataclasses.dataclass(frozen=True)
class SweepHealthReport:
    """What a supervised sweep survived — the operator-facing summary,
    cross-checkable record-for-record against the :class:`FailureLedger`
    and the `event=` log stream. Action counts (stalls, demotions,
    shrinks, retries) cover the units EXECUTED in this run —
    fully-resumed units' history lives in the durable ledger — but
    `lanes_quarantined` covers the RETURNED output, resumed units
    included: their chunks still carry the zero-masked lanes."""

    units_total: int
    units_completed: int
    #: units satisfied from a prior run's checkpoint chunks (resume).
    units_resumed: int
    #: units that needed more than one supervised attempt this run.
    units_retried: int
    #: units re-executed by checkpoint verification (torn/corrupt chunk).
    units_requeued: int
    #: supervised dispatches killed by the deadline watchdog.
    stalls_killed: int
    #: engine-ladder demotions across all units.
    engine_demotions: int
    #: elastic mesh shrinks across all units.
    mesh_shrinks: int
    #: scenario/grid lanes masked by the non-finite quarantine.
    lanes_quarantined: int
    #: engine rungs/paths that produced accepted unit results, sorted.
    engines_used: tuple
    ledger_path: Optional[str] = None
    #: numerics-canary re-executions run (telemetry.numerics): units
    #: re-dispatched on the demoted rung and compared fingerprint-by-
    #: fingerprint against the primary's per-epoch capture.
    canaries_run: int = 0
    #: canary comparisons that CONFIRMED drift — one per (unit, stream)
    #: whose per-epoch fingerprints diverged (typed `engine_drift`
    #: ledger records carry the first divergent epoch + ulp distance).
    drift_events: int = 0

    @property
    def clean(self) -> bool:
        """True iff nothing degraded: no retries, requeues, stalls,
        demotions, shrinks, quarantined lanes or confirmed drift
        (canaries that reproduced the primary's bits are healthy)."""
        return not (
            self.units_retried
            or self.units_requeued
            or self.stalls_killed
            or self.engine_demotions
            or self.mesh_shrinks
            or self.lanes_quarantined
            or self.drift_events
        )


class _UnitOutcome:
    """Mutable accumulator for one unit's recovery actions. Owns the
    unit's ledger bookkeeping for stalls so a kill is recorded whether
    the in-unit ladder absorbs it or it escapes to the unit retry."""

    def __init__(
        self, idx: int = 0, ledger: Optional[FailureLedger] = None
    ) -> None:
        self.idx = idx
        self.ledger = ledger
        self.attempts = 0
        self.stalls = 0
        self.demotions = 0
        self.mesh_shrinks = 0
        self.engine = "eager"
        self.quarantine_entries: tuple = ()
        #: numerics-canary bookkeeping (0.14.0): re-executions run on
        #: this unit and (unit, stream) comparisons that confirmed drift.
        self.canaries = 0
        self.drifts = 0

    def record_stall(
        self, *, attempt: int, rung: str = "", budget_s=None
    ) -> None:
        self.stalls += 1
        if self.ledger is not None:
            self.ledger.append(
                "unit_stalled",
                unit=self.idx,
                attempt=attempt,
                **({"rung": rung} if rung else {}),
                **({"budget_s": budget_s} if budget_s is not None else {}),
            )


@dataclasses.dataclass
class SweepSupervisor:
    """Run partitioned sweeps under full supervision.

    `unit_size` scenarios (or grid points) per idempotent unit;
    `deadline` bounds each supervised dispatch (None disables the
    watchdog — not recommended for unattended sweeps); `retry_policy`
    drives both the in-unit engine ladder and the unit-level retry count
    (`max_attempts_per_rung` supervised attempts per unit, so a ladder
    path gets rungs x attempts^2 total tries in the worst case);
    `quarantine=True` arms the per-lane non-finite guard (forces the eager
    rung — the fused scans cannot host the guard); `elastic=True` arms
    shrink-and-continue on device loss for sharded units; `engine` is
    the starting ladder rung for unsharded units (must be "eager", or
    JAX's name of it, "xla", under quarantine). `directory` makes the
    sweep durable: unit results snapshot through :class:`..utils.checkpoint.CheckpointedSweep`
    (chunk files + checksums) and the ledger publishes to `ledger.jsonl`
    alongside them, so a killed run resumes from its completed units and
    a torn chunk requeues exactly one unit.
    """

    directory: Optional[str | pathlib.Path] = None
    unit_size: int = 64
    deadline: Optional[Deadline] = dataclasses.field(
        default_factory=default_deadline
    )
    retry_policy: RetryPolicy = dataclasses.field(
        default_factory=default_retry_policy
    )
    quarantine: bool = True
    elastic: bool = True
    engine: str = "eager"
    #: Opt-in cost capture (``telemetry.cost``): after the run, the
    #: :class:`..telemetry.cost.CostRecord` of every rung at the sweep's
    #: first shape goes to the bundle's ``costs.jsonl`` (needs
    #: `directory`). Host arithmetic on the shape; a capture failure is
    #: logged, never reported as the bundle failing.
    capture_costs: bool = False
    #: Cross-engine numerics-canary fraction (``telemetry.numerics``):
    #: re-execute this fraction of units on the DEMOTED rung (deterministic
    #: stride over unit indices, unit 0 always canaried when > 0) inside
    #: :func:`..faults.canary_scope`, compare per-epoch fingerprints
    #: lane by lane, and ledger a typed ``engine_drift`` record per
    #: diverging (unit, stream) — first divergent epoch + ulp distance
    #: included. 0 disables (the production default is an operator
    #: choice: a canary re-pays the unit's compute on another rung).
    canary_fraction: float = 0.0
    #: Pin the canary's rung; None = one rung below the unit's executed
    #: engine on the demotion ladder (same rung when already at the
    #: bottom — a pure determinism canary, still meaningful: a demoted
    #: RETRY must reproduce the primary's bits).
    canary_engine: Optional[str] = None
    #: On-demand profiling cadence: every Nth unit (unit 0 included)
    #: dispatches under a ``torch.profiler`` trace written to
    #: ``DIRECTORY/profiles/unitNNNN`` and registered in the bundle's
    #: ``profiles.jsonl``, so a long sweep leaves periodic device evidence
    #: without an operator attaching by hand. The trace holds the process's
    #: profiler latch (:func:`..utils.profiling.profile_trace`, the one
    #: :class:`..telemetry.ops.ProfileSession` takes), so it raises
    #: :class:`..telemetry.ops.ProfileBusyError` rather than open a second
    #: profiler under an open window. Requires a `directory`; 0 disables
    #: (the default: a trace costs time).
    profile_every: int = 0

    def __post_init__(self) -> None:
        if self.unit_size < 1:
            raise ValueError("unit_size must be >= 1")
        if self.profile_every < 0:
            raise ValueError(
                f"profile_every must be >= 0, got {self.profile_every}"
            )
        if self.engine == "xla":
            self.engine = "eager"
        if not (0.0 <= self.canary_fraction <= 1.0):
            raise ValueError(
                "canary_fraction must be in [0, 1], got "
                f"{self.canary_fraction}"
            )
        if self.quarantine and self.engine != "eager":
            raise ValueError(
                "quarantine rides the eager rung's scan carry; a supervised "
                f"sweep cannot start on engine {self.engine!r} with "
                "quarantine=True (pass quarantine=False to drill fused "
                "rungs)"
            )

    # -- public drivers -------------------------------------------------

    def run_batch(
        self,
        scenarios: Sequence,
        yuma_version: str,
        config=None,
        *,
        mesh=None,
        dtype=torch.float32,
        tag: str = "",
        pack: bool = False,
        device="cuda",
    ) -> dict:
        """Supervised :func:`..simulation.sweep.simulate_batch` /
        :func:`..parallel.sharded.simulate_batch_sharded` over a
        scenario suite.

        Returns `{"dividends": [B, E, V], "quarantine":
        QuarantineReport, "report": SweepHealthReport}`. With `mesh`,
        units dispatch sharded (elastic if armed) under one watchdog
        each; without, down the engine ladder starting at `self.engine`
        with per-attempt deadlines. Healthy lanes are bitwise what an
        unfaulted run produces — every recovery action either
        re-executes a pure unit or masks a lane, never perturbs a
        healthy one. Units run on `device` (the card by default; with
        `mesh`, on the mesh's devices).

        `pack=True` DONOR-PACKS the suite first
        (:func:`..simulation.sweep.pack_scenarios`): heterogeneous
        scenarios pad to one tile-aligned shape bucket with per-lane
        miner masks, so the whole suite rides one compiled batched
        shape — the serving tier's coalescing path. The returned
        dividends then carry the bucket's padded validator axis (slice
        `[:, :E_i, :V_i]` per lane to recover each scenario's own view;
        padded entries are exact zeros by the padding contract). Eager
        rung only (the fused scan has no per-scenario miner masks)
        and single-host only (the sharded path accounts memory
        per-shard, not per-bucket).
        """
        from yuma_simulation_tpu_torch.models.config import YumaConfig
        from yuma_simulation_tpu_torch.models.variants import variant_for_version
        from yuma_simulation_tpu_torch.simulation.engine import (
            backend_name,
            resolve_device,
        )
        from yuma_simulation_tpu_torch.simulation.sweep import (
            pack_scenarios,
            stack_scenarios,
        )

        dev = resolve_device(device)
        config = config if config is not None else YumaConfig()
        spec = variant_for_version(yuma_version)
        scenarios = list(scenarios)
        units = self._partition(len(scenarios))
        packed = None
        if pack:
            if mesh is not None:
                raise ValueError(
                    "pack=True donor-packs with per-lane miner masks, "
                    "which the sharded dispatch does not thread; use "
                    "mesh=None (or pre-shard the suite)"
                )
            if self.engine != "eager":
                raise ValueError(
                    "pack=True requires engine='eager': the fused case "
                    "scan has no per-scenario miner masks"
                )
            if scenarios:
                packed = pack_scenarios(scenarios, dtype, device=dev)

        # The sweep-level dispatch plan (simulation.planner), recorded
        # on the sweep span so the flight bundle shows WHY the rung ran
        # before any unit dispatches; each unit's engine-rung span gets
        # its own per-dispatch plan from simulate_batch. Planning is
        # pure host arithmetic — zero compiles (the recompilation pins
        # cover this path).
        plan = None
        canary_expected = None
        if scenarios:
            from yuma_simulation_tpu_torch.simulation.planner import (
                plan_dispatch,
            )

            if packed is not None:
                _, E0, V0, M0 = packed[0].shape
            else:
                E0, V0, M0 = np.shape(scenarios[0].weights)
            lanes0 = min(self.unit_size, len(scenarios))
            from yuma_simulation_tpu_torch.ops.consensus import (
                bisection_iterations,
                dyadic_grid_fits_int32,
            )
            from yuma_simulation_tpu_torch.simulation.planner import (
                EXPECTED_DRIFT_U16_FALLBACK,
            )

            if not dyadic_grid_fits_int32(
                int(M0), bisection_iterations(config.consensus_precision)
            ):
                # Beyond the int32 dyadic bound a fused-vs-eager canary
                # pairing crosses the DOCUMENTED one-ulp u16-quantize
                # fallback class (planner.EXPECTED_DRIFT_U16_FALLBACK):
                # stamp it expected instead of paging on it. Auto plans
                # never run fused here (the eligibility gates), so this
                # only fires for explicit fused opt-ins.
                canary_expected = EXPECTED_DRIFT_U16_FALLBACK
            plan = plan_dispatch(
                f"supervised_batch:{yuma_version}",
                (lanes0, E0, V0, M0),
                spec,
                config,
                dtype,
                epoch_impl=self.engine if mesh is None else "auto",
                quarantine=self.quarantine,
                has_miner_mask=packed is not None,
                check_memory=mesh is None,
                device=dev,
            )

        def dispatch_unit(
            idx: int, lo: int, hi: int, attempt: int, outcome: _UnitOutcome
        ) -> dict:
            unit = scenarios[lo:hi]
            label = f"{tag or 'batch'}:unit{idx}"
            if mesh is not None:
                from yuma_simulation_tpu_torch.parallel.sharded import (
                    simulate_batch_sharded,
                )

                # The deadline goes INTO the elastic dispatch (one
                # watchdog per mesh attempt, shrinks on the caller side
                # of the heartbeat — see the module docstring). On a
                # unit retry the budget is pre-extended by the grace:
                # the sharded walk restarts its shrink count at 0 and
                # would otherwise retry on the cold-start budget.
                dl = self.deadline
                if dl is not None and attempt > 0:
                    dl = Deadline(
                        budget_seconds=dl.budget_for_attempt(attempt),
                        grace_seconds=dl.grace_seconds,
                    )
                ys = simulate_batch_sharded(
                    unit,
                    yuma_version,
                    config,
                    mesh=mesh,
                    quarantine=self.quarantine,
                    dtype=dtype,
                    elastic=self.elastic,
                    deadline=dl,
                )
                out = dict(ys)
                shrinks = out.get("mesh_degradations", ())
                out["_engine_used"] = (
                    "single_device"
                    if shrinks and shrinks[-1].to_devices == 1
                    else "sharded"
                )
                return out
            if packed is not None:
                Wp, Sp, rip, rep, maskp = packed
                return self._ladder_dispatch(
                    lambda rung: _batch_on_rung(
                        Wp[lo:hi],
                        Sp[lo:hi],
                        rip[lo:hi],
                        rep[lo:hi],
                        config,
                        spec,
                        rung,
                        self.quarantine,
                        miner_mask=maskp[lo:hi],
                    ),
                    label=label,
                    outcome=outcome,
                    plan=plan,
                )
            W, S, ri, re = stack_scenarios(unit, dtype, device=dev)
            return self._ladder_dispatch(
                lambda rung: _batch_on_rung(
                    W, S, ri, re, config, spec, rung, self.quarantine
                ),
                label=label,
                outcome=outcome,
                plan=plan,
            )

        def canary_dispatch(idx: int, lo: int, hi: int, rung: str) -> dict:
            # The cross-engine canary re-dispatch: the SAME unit, pinned
            # to the demoted rung (for sharded primaries: the unsharded
            # eager rung — a cross-topology canary). Guard state matches
            # the primary so the dispatch differs ONLY in the rung under
            # comparison.
            if packed is not None:
                Wp, Sp, rip, rep, maskp = packed
                return _batch_on_rung(
                    Wp[lo:hi], Sp[lo:hi], rip[lo:hi], rep[lo:hi],
                    config, spec, rung, self.quarantine,
                    miner_mask=maskp[lo:hi],
                )
            W, S, ri, re = stack_scenarios(scenarios[lo:hi], dtype, device=dev)
            return _batch_on_rung(
                W, S, ri, re, config, spec, rung, self.quarantine
            )

        return self._run_units(
            units,
            dispatch_unit,
            num_lanes=len(scenarios),
            backend=backend_name(dev),
            tag=tag or f"batch:{yuma_version}",
            canary_dispatch=canary_dispatch,
            canary_expected=canary_expected,
            plan=plan,
            config_fingerprint={
                "driver": "run_batch",
                "version": yuma_version,
                "num_scenarios": len(scenarios),
                "unit_size": self.unit_size,
            },
            cost_request=(
                dict(zip(("epochs", "V", "M"), np.shape(scenarios[0].weights)),
                     yuma_version=yuma_version)
                if scenarios else None
            ),
        )

    def run_grid(
        self,
        scenario,
        yuma_version: str,
        configs,
        *,
        tag: str = "",
        initial_state: Optional[dict] = None,
        epoch_offset: int = 0,
        device="cuda",
    ) -> dict:
        """Supervised :func:`..simulation.sweep.sweep_hyperparams` over
        a batched config grid (built with `config_grid`): the grid's
        lanes partition into units exactly like scenarios do, each unit
        re-slicing the batched config pytree (static leaves shared).
        Returns the same `{"dividends", "quarantine", "report"}` shape
        as :meth:`run_batch`, with lanes = grid points.

        `initial_state` / `epoch_offset` thread the suffix-resume
        contract through every unit AND its canary re-execution (the
        replay controller's incremental windows); requires a supervisor
        built with ``quarantine=False`` (the guard rides a monolithic
        carry) and is stamped into the checkpoint fingerprint so a
        resumed directory can never silently mix a suffix sweep with a
        from-zero one. Grid units run on the eager rung, as the JAX
        package's run on its XLA rung, on `device`."""
        from yuma_simulation_tpu_torch.models.config import YumaConfig
        from yuma_simulation_tpu_torch.simulation.engine import (
            backend_name,
            config_lanes,
            resolve_device,
        )
        from yuma_simulation_tpu_torch.simulation.planner import plan_dispatch

        dev = resolve_device(device)
        num_points = config_lanes(configs)
        units = self._partition(num_points)

        # Each unit runs up to unit_size grid lanes over ONE scenario,
        # so the plan's lane count (and its memory footprint) is the
        # unit's, not a single lane's.
        lanes0 = min(self.unit_size, num_points)
        plan = plan_dispatch(
            f"supervised_grid:{yuma_version}",
            (lanes0,) + tuple(np.shape(scenario.weights)),
            yuma_version,
            YumaConfig(),  # grid points vary floats; plan on defaults
            torch.float32,
            epoch_impl="eager",
            quarantine=self.quarantine,
            device=dev,
        )

        def dispatch_unit(
            idx: int, lo: int, hi: int, attempt: int, outcome: _UnitOutcome
        ) -> dict:
            return self._ladder_dispatch(
                lambda rung: _grid_on_eager(
                    scenario, yuma_version, _config_slice(configs, lo, hi),
                    self.quarantine, initial_state=initial_state,
                    epoch_offset=epoch_offset, device=dev,
                ),
                label=f"{tag or 'grid'}:unit{idx}",
                outcome=outcome,
                plan=plan,
            )

        def canary_dispatch(idx: int, lo: int, hi: int, rung: str) -> dict:
            # Grid sweeps have a single-rung ladder: the canary is a
            # pure determinism re-execution on the same eager rung (a
            # demoted RETRY must reproduce the primary's bits).
            del rung
            return _grid_on_eager(
                scenario, yuma_version, _config_slice(configs, lo, hi),
                self.quarantine, initial_state=initial_state,
                epoch_offset=epoch_offset, device=dev,
            )

        return self._run_units(
            units,
            dispatch_unit,
            num_lanes=num_points,
            backend=backend_name(dev),
            tag=tag or f"grid:{yuma_version}",
            canary_dispatch=canary_dispatch,
            plan=plan,
            config_fingerprint={
                "driver": "run_grid",
                "version": yuma_version,
                "num_points": num_points,
                "unit_size": self.unit_size,
                # Additive suffix-resume identity (None/0 for classic
                # from-zero grids, so existing fingerprints are stable):
                # a resumed checkpoint directory must never satisfy a
                # suffix sweep's units with a from-zero run's results.
                **(
                    {
                        "epoch_offset": int(epoch_offset),
                        "initial_state": _state_digest(initial_state),
                    }
                    if initial_state is not None or epoch_offset
                    else {}
                ),
            },
            cost_request=dict(
                zip(("epochs", "V", "M"), np.shape(scenario.weights)),
                yuma_version=yuma_version,
            ),
        )

    # -- internals ------------------------------------------------------

    def _partition(self, n: int) -> list:
        """Contiguous `(lo, hi)` unit bounds covering `range(n)`."""
        if n < 1:
            raise ValueError("cannot supervise an empty sweep")
        return [
            (lo, min(lo + self.unit_size, n))
            for lo in range(0, n, self.unit_size)
        ]

    def _ladder_dispatch(
        self,
        dispatch: Callable,
        *,
        label: str,
        outcome: _UnitOutcome,
        plan,
    ) -> dict:
        """One unit attempt down `plan`'s ladder. The deadline is threaded
        INTO the ladder (per rung attempt), and `on_failure` feeds every
        classified failure — including same-rung-absorbed stalls — into
        the unit's books."""
        from yuma_simulation_tpu_torch.resilience.retry import supervise

        def on_failure(typed, rung, attempt):
            if isinstance(typed, EngineStall):
                outcome.record_stall(
                    attempt=attempt + 1,
                    rung=rung,
                    budget_s=typed.budget_seconds,
                )

        ys, engine_used, records = supervise(
            dispatch, plan, self.retry_policy, self.deadline,
            label=label, on_failure=on_failure,
        )
        out = dict(ys)
        out["_engine_used"] = engine_used
        out["_demotions"] = tuple(records)
        return out

    def _run_units(
        self,
        units: list,
        dispatch_unit: Callable,
        *,
        num_lanes: int,
        tag: str,
        config_fingerprint: dict,
        backend: str = "gpu",
        plan=None,
        canary_dispatch: Optional[Callable] = None,
        canary_expected: Optional[str] = None,
        cost_request: Optional[dict] = None,
    ) -> dict:
        from yuma_simulation_tpu_torch.telemetry import (
            FlightRecorder,
            ensure_run,
            get_registry,
            record_device_telemetry,
            record_epoch_rate,
            span,
        )

        directory = (
            pathlib.Path(self.directory) if self.directory is not None else None
        )
        if directory is not None:
            directory.mkdir(parents=True, exist_ok=True)
        ledger = FailureLedger(
            directory / "ledger.jsonl" if directory is not None else None
        )
        # One _UnitOutcome PER EXECUTION (a requeued unit appends a
        # second): the report must account for every recovery action
        # taken, including ones on an execution whose chunk was later
        # torn and redone — last-write-wins would silently drop them.
        outcomes: dict[int, list] = {}
        executions: dict[int, int] = {}
        #: Units whose prior-run snapshot failed verification at resume
        #: (requeued before execution — distinct from within-run
        #: re-entries, which `executions` counts).
        resume_requeued: set[int] = set()
        #: Serialized per-epoch numerics records (telemetry.numerics),
        #: primary + canary roles — published to the bundle's
        #: numerics.jsonl and returned to callers (the fleet scheduler
        #: re-stamps them with fleet-global unit indices).
        numerics_records: list = []

        def unit_fn(idx: int) -> dict:
            if (
                self.profile_every <= 0
                or directory is None
                or idx % self.profile_every != 0
            ):
                return _unit_body(idx)
            # Periodic device evidence: this unit dispatches under a
            # profiler trace, registered into the bundle whether the unit
            # succeeds or not (a failing unit's trace is the one that
            # explains the failure).
            from yuma_simulation_tpu_torch.utils.profiling import profile_trace

            pdir = directory / "profiles" / f"unit{idx:04d}"
            log_event(logger, "profile_started", mode="unit", unit=idx, artifact=str(pdir))
            try:
                with profile_trace(str(pdir)):
                    return _unit_body(idx)
            finally:
                try:
                    FlightRecorder(directory).record_profile(
                        {"event": "profile_published", "mode": "unit", "unit": idx,
                         "artifact": str(pdir)}
                    )
                    log_event(logger, "profile_published", mode="unit", unit=idx,
                              artifact=str(pdir))
                except Exception:  # noqa: BLE001 — contained observation
                    logger.warning("unit profile registration failed", exc_info=True)

        def _unit_body(idx: int) -> dict:
            from yuma_simulation_tpu_torch.telemetry.slo import observe_duration

            lo, hi = units[idx]
            unit_t0 = time.perf_counter()
            with span(f"unit{idx}", lanes=[lo, hi]):
                executions[idx] = executions.get(idx, 0) + 1
                if executions[idx] > 1:
                    # Re-entry within one run = the checkpoint layer
                    # requeued this unit (torn/corrupt chunk detected).
                    ledger.append(
                        "unit_requeued", unit=idx, executions=executions[idx]
                    )
                outcome = _UnitOutcome(idx, ledger)
                outcomes.setdefault(idx, []).append(outcome)
                last = None
                for attempt in range(self.retry_policy.max_attempts_per_rung):
                    outcome.attempts = attempt + 1
                    try:
                        with span(f"attempt{attempt + 1}"):
                            ys = dispatch_unit(idx, lo, hi, attempt, outcome)
                            # Numerics capture + cross-engine canary
                            # BEFORE acceptance, so the unit_ok record
                            # carries this execution's canary/drift
                            # counts. Contained: a capture or canary
                            # failure must never fail the unit it
                            # observes.
                            self._capture_unit_numerics(
                                idx, lo, hi, ys, outcome, ledger,
                                canary_dispatch, numerics_records, tag,
                                canary_expected,
                            )
                            accepted = self._accept_unit(
                                idx, lo, hi, ys, outcome, ledger
                            )
                            # The unit-duration SLO signal: wall time of
                            # the accepted execution, retries included
                            # (what the caller actually waited).
                            unit_seconds = time.perf_counter() - unit_t0
                            observe_duration("unit_seconds", unit_seconds)
                            # The dispatch timing sketch: keyed by the
                            # rung that actually ran (post-demotion),
                            # the plan's shape bucket, and the backend.
                            # Never raises.
                            from yuma_simulation_tpu_torch.telemetry.slo import (
                                observe_dispatch,
                            )

                            dshape = np.shape(accepted.get("dividends"))
                            observe_dispatch(
                                engine=outcome.engine or self.engine,
                                bucket=(
                                    plan.bucket.key
                                    if plan is not None
                                    else tag
                                ),
                                backend=backend,
                                seconds=unit_seconds,
                                epochs=(
                                    int(dshape[0] * dshape[1])
                                    if len(dshape) >= 2
                                    else 0
                                ),
                            )
                            return accepted
                    except BaseException as exc:  # noqa: BLE001 — classified
                        typed = classify_failure(exc)
                        if typed is None:
                            ledger.append(
                                "unit_failed",
                                unit=idx,
                                error=type(exc).__name__,
                                message=str(exc)[:500],
                            )
                            raise
                        last = typed
                        if isinstance(typed, EngineStall):
                            outcome.record_stall(
                                attempt=attempt + 1,
                                budget_s=typed.budget_seconds,
                            )
                        else:
                            ledger.append(
                                "unit_retry",
                                unit=idx,
                                attempt=attempt + 1,
                                error=type(typed).__name__,
                            )
                ledger.append(
                    "unit_failed",
                    unit=idx,
                    error=type(last).__name__,
                    message=str(last)[:500],
                )
                assert last is not None
                raise last

        registry = get_registry()
        with ensure_run() as run:
            report = None
            t0 = time.perf_counter()
            try:
                # The span chain under one run: sweep -> unit -> attempt
                # -> engine rung (the rung span lives in run_ladder).
                # Every ledger append above happens under one of these,
                # so obsreport resolves each record to a span.
                with span(
                    f"sweep:{tag}", units=len(units), lanes=num_lanes
                ) as sweep_span:
                    if sweep_span is not None and plan is not None:
                        # The typed dispatch-plan attribute: flight
                        # bundles show WHY this sweep's rung ran
                        # (obsreport renders a "dispatch plans" section
                        # from these).
                        sweep_span.attrs["plan"] = plan.span_attr()
                    if directory is not None:
                        from yuma_simulation_tpu_torch.utils.checkpoint import (
                            CheckpointedSweep,
                        )

                        sweep = CheckpointedSweep(
                            directory,
                            num_chunks=len(units),
                            tag=tag,
                            config=config_fingerprint,
                        )
                        # A chunk torn BETWEEN runs (storage rot, a
                        # crash mid-publish) requeues at resume: ledger
                        # it under the same `unit_requeued` contract as
                        # a within-run tear, so the bundle cross-check
                        # (flight.ledger_counts) and the numerics-stream
                        # replace-not-duplicate rule see one story.
                        for i in sweep.corrupt_chunks():
                            if 0 <= i < len(units):
                                resume_requeued.add(i)
                                ledger.append(
                                    "unit_requeued",
                                    unit=i,
                                    reason="resume_verification_failed",
                                )
                        dividends = sweep.run(
                            lambda i: unit_fn(i)["dividends"]
                        )
                    else:
                        dividends = np.concatenate(
                            [
                                unit_fn(i)["dividends"]
                                for i in range(len(units))
                            ],
                            axis=0,
                        )
                    resumed = sum(
                        1 for i in range(len(units)) if i not in executions
                    )

                    # Quarantine provenance comes from each unit's LAST
                    # execution — the one whose result stands in the
                    # output. Units satisfied from a prior run's chunks
                    # did not execute here, but their chunks still carry
                    # any zero-masked lanes: recover their provenance
                    # from the ledger's unit_ok records, or the caller
                    # would treat masked zeros as genuine dividends.
                    entries: list = []
                    for idx in range(len(units)):
                        if idx in outcomes:
                            entries.extend(
                                outcomes[idx][-1].quarantine_entries
                            )
                        else:
                            entries.extend(
                                _ledger_quarantine_entries(ledger, idx)
                            )
                    quarantine = QuarantineReport(
                        entries=tuple(entries), num_cases=num_lanes
                    )
                    report = self._build_report(
                        units, outcomes, executions, resumed, len(entries),
                        directory, resume_requeued,
                    )
                    # Metrics the supervisor owns (the per-action
                    # counters — stalls, demotions, shrinks, retries —
                    # are incremented at their sources in the watchdog/
                    # ladder/elastic layers, exactly once each).
                    if entries:
                        registry.counter(
                            "quarantined_lanes",
                            help="non-finite lanes masked by the guard",
                        ).inc(len(entries))
                    shape = np.shape(dividends)
                    epochs = (
                        int(shape[0] * shape[1]) if len(shape) >= 2 else None
                    )
                    record_epoch_rate(
                        tag,
                        epochs=epochs,
                        seconds=time.perf_counter() - t0,
                        registry=registry,
                        logger_=logger,
                    )
                    # Device sample at the sweep boundary — host-level,
                    # after every dispatch completed.
                    record_device_telemetry(registry)
                    log_event(
                        logger,
                        "sweep_supervised",
                        level=logging.INFO,
                        tag=tag,
                        units=report.units_total,
                        resumed=report.units_resumed,
                        retried=report.units_retried,
                        requeued=report.units_requeued,
                        stalls=report.stalls_killed,
                        demotions=report.engine_demotions,
                        mesh_shrinks=report.mesh_shrinks,
                        quarantined=report.lanes_quarantined,
                    )
            finally:
                # The flight bundle publishes on failure too: a crashed
                # sweep's spans are exactly the ones worth keeping, and
                # every ledger record written so far must stay
                # resolvable for obsreport --check.
                if directory is not None:
                    try:
                        recorder = FlightRecorder(directory)
                        recorder.record(
                            run, registry=registry, report=report
                        )
                    except Exception:
                        logger.warning(
                            "flight-recorder bundle publish failed for %s",
                            directory,
                            exc_info=True,
                        )
                    else:
                        try:
                            # The numerics stream rides the same
                            # crash-safe bundle (merged by unit/role, so
                            # it survives a failed/resumed sweep exactly
                            # like costs.jsonl — resumed units keep the
                            # prior run's records).
                            recorder.record_numerics(
                                numerics_records, run_id=run.run_id
                            )
                        except Exception:
                            logger.warning(
                                "numerics stream publish failed for %s "
                                "(the flight bundle itself published)",
                                directory,
                                exc_info=True,
                            )
                        if self.capture_costs and cost_request is not None:
                            # After the sweep, on the same crash-safe
                            # bundle; its own guard: by here the bundle
                            # published, and a capture failure must not
                            # read as the bundle failing.
                            try:
                                from yuma_simulation_tpu_torch.telemetry.cost import (
                                    capture_engine_costs,
                                )

                                recorder.record_costs(
                                    capture_engine_costs(
                                        cost_request["V"], cost_request["M"],
                                        cost_request["epochs"],
                                        yuma_version=cost_request["yuma_version"],
                                    ),
                                    run_id=run.run_id,
                                )
                            except Exception:
                                logger.warning(
                                    "cost capture failed for %s (the flight "
                                    "bundle itself published)",
                                    directory,
                                    exc_info=True,
                                )
        return {
            "dividends": dividends,
            "quarantine": quarantine,
            "report": report,
            "numerics_records": numerics_records,
        }

    # -- numerics canary ------------------------------------------------

    def _canary_selected(self, idx: int) -> bool:
        """Deterministic stride selection over unit indices (no RNG —
        a re-run of the same sweep canaries the same units, so resumed
        and fresh runs account identically)."""
        if self.canary_fraction <= 0.0:
            return False
        return idx % canary_stride(self.canary_fraction) == 0

    def _canary_rung(self, primary_engine: str) -> str:
        """The rung the canary re-executes on: pinned, or one below the
        primary on the demotion ladder (same rung at the bottom — a
        determinism canary). Sharded/single-device paths canary on the
        unsharded eager rung (the sharded == unsharded contract is the
        observable under test there)."""
        if self.canary_engine is not None:
            return self.canary_engine
        from yuma_simulation_tpu_torch.simulation.planner import (
            ENGINE_LADDER,
            ladder_from,
        )

        if primary_engine not in ENGINE_LADDER:
            return "eager"
        if primary_engine in ("fused_varying_mxu", "fused_varying"):
            # The epoch-tiled rungs' bitwise-comparable partner is the
            # VPU twin (a tensor-core primary) or the rung itself (a
            # determinism canary, like the eager bottom rung): the next
            # ladder rung below is the CASE-scan family, which the JAX
            # package's varying kernel matches only to reduction-order
            # rounding — pairing them would make every canary a false
            # drift incident. (Whether K3 and K2 are bitwise on the card
            # is measured by chip_smoke.py's resilience phase; PERF.md.)
            return "fused_varying"
        ladder = ladder_from(primary_engine)
        return ladder[1] if len(ladder) > 1 else ladder[0]

    def _capture_unit_numerics(
        self,
        idx: int,
        lo: int,
        hi: int,
        ys: dict,
        outcome: _UnitOutcome,
        ledger: FailureLedger,
        canary_dispatch: Optional[Callable],
        records: list,
        tag: str,
        canary_expected: Optional[str] = None,
    ) -> None:
        """Fetch the unit's in-scan numerics sketches, serialize the
        primary record, and (on selected units) run the cross-engine
        canary. Wholly contained: observability must never fail the
        sweep it observes."""
        sketches = ys.get("numerics")
        if sketches is None:
            return
        try:
            from yuma_simulation_tpu_torch.telemetry.numerics import (
                sketch_records,
                to_host,
            )

            engine = ys.get("_engine_used", self.engine)
            primary = to_host(sketches)
            records.extend(
                sketch_records(
                    primary, unit=idx, lanes=(lo, hi), engine=engine,
                    role="primary", label=tag,
                )
            )
        except Exception:
            logger.warning(
                "numerics capture failed for unit %d", idx, exc_info=True
            )
            return
        if canary_dispatch is None or not self._canary_selected(idx):
            return
        self._run_canary(
            idx, lo, hi, primary, engine, outcome, ledger,
            canary_dispatch, records, tag, canary_expected,
        )

    def _run_canary(
        self,
        idx: int,
        lo: int,
        hi: int,
        primary: dict,
        primary_engine: str,
        outcome: _UnitOutcome,
        ledger: FailureLedger,
        canary_dispatch: Callable,
        records: list,
        tag: str,
        canary_expected: Optional[str] = None,
    ) -> None:
        """Re-execute one accepted unit on the demoted rung inside
        :func:`..faults.canary_scope` and compare per-epoch fingerprints
        lane by lane. Confirmed drift is a typed ``engine_drift`` ledger
        record per diverging (unit, stream) — global lane index, first
        divergent epoch, summed ulp distance — plus a bad
        ``engine_drift_ok`` SLO event and an ``engine_drift_total``
        counter tick; a clean canary feeds the same SLO stream good.

        `canary_expected` names the documented accepted-drift class
        this sweep's shape sits in (today: the u16-quantize fallback
        pairing of an explicit fused opt-in beyond the int32 dyadic
        bound). A divergence on a fused-vs-eager pairing
        under that flag is recorded and rendered but NOT treated as an
        incident: the canary record carries ``expected``, the ledger
        record too, the SLO stream stays good, and ``driftreport
        --check`` passes."""
        from yuma_simulation_tpu_torch.resilience import faults
        from yuma_simulation_tpu_torch.telemetry import get_registry, span
        from yuma_simulation_tpu_torch.telemetry.numerics import (
            compare_sketches,
            sketch_records,
            to_host,
        )
        from yuma_simulation_tpu_torch.telemetry.slo import observe_event

        rung = self._canary_rung(primary_engine)
        registry = get_registry()
        try:
            with span(f"canary{idx}", lanes=[lo, hi], rung=rung):
                with faults.canary_scope():
                    ys_c = canary_dispatch(idx, lo, hi, rung)
                sketches_c = (
                    ys_c.get("numerics") if isinstance(ys_c, dict) else None
                )
                if sketches_c is None:
                    ledger.append(
                        "canary_failed",
                        unit=idx,
                        reason="no numerics capture on canary rung",
                    )
                    return
                from yuma_simulation_tpu_torch.simulation.planner import (
                    FUSED_CASE_RUNGS as fused,
                )
                expected = (
                    canary_expected
                    if (primary_engine in fused) != (rung in fused)
                    else None
                )
                canary = to_host(sketches_c)
                canary_records = sketch_records(
                    canary, unit=idx, lanes=(lo, hi), engine=rung,
                    role="canary", label=tag,
                )
                if expected:
                    for rec in canary_records:
                        rec["expected"] = expected
                records.extend(canary_records)
                divergences = compare_sketches(primary, canary)
                outcome.canaries += 1
                registry.counter(
                    "numerics_canaries",
                    help="cross-engine numerics canary re-executions",
                ).inc()
                ledger.append(
                    "unit_canary",
                    unit=idx,
                    engine=rung,
                    primary_engine=primary_engine,
                    drift_streams=len(divergences),
                )
                if not divergences:
                    observe_event("engine_drift_ok", True)
                    return
                if expected:
                    # The codified accepted-drift class: visible in the
                    # ledger and the numerics stream, but NOT an
                    # incident — no drift count, no bad SLO event, no
                    # degraded report.
                    registry.counter(
                        "engine_drift_expected",
                        help="canary divergences inside a documented "
                        "accepted-drift class",
                    ).inc(len(divergences))
                    observe_event("engine_drift_ok", True)
                    for stream, lanes in sorted(divergences.items()):
                        ledger.append(
                            "engine_drift",
                            unit=idx,
                            stream=stream,
                            primary_engine=primary_engine,
                            canary_engine=rung,
                            expected=expected,
                            lanes=[
                                [
                                    lo + d["lane"],
                                    d["first_divergent_epoch"],
                                    d["ulp_distance"],
                                ]
                                for d in lanes
                            ],
                        )
                    return
                outcome.drifts += len(divergences)
                registry.counter(
                    "engine_drift_total",
                    help="canary comparisons that confirmed numerics drift",
                ).inc(len(divergences))
                observe_event("engine_drift_ok", False)
                for stream, lanes in sorted(divergences.items()):
                    first = lanes[0]
                    ledger.append(
                        "engine_drift",
                        unit=idx,
                        stream=stream,
                        primary_engine=primary_engine,
                        canary_engine=rung,
                        # [global lane, first divergent epoch, ulp
                        # distance] per diverging lane — what
                        # driftreport localizes.
                        lanes=[
                            [
                                lo + d["lane"],
                                d["first_divergent_epoch"],
                                d["ulp_distance"],
                            ]
                            for d in lanes
                        ],
                    )
                    log_event(
                        logger,
                        "engine_drift",
                        level=logging.ERROR,
                        unit=idx,
                        stream=stream,
                        primary=primary_engine,
                        canary=rung,
                        lane=lo + first["lane"],
                        epoch=first["first_divergent_epoch"],
                        ulp=first["ulp_distance"],
                    )
        except Exception:
            logger.warning(
                "numerics canary failed for unit %d", idx, exc_info=True
            )
            try:
                ledger.append("canary_failed", unit=idx, reason="exception")
            except Exception:
                pass

    def _accept_unit(
        self,
        idx: int,
        lo: int,
        hi: int,
        ys: dict,
        outcome: _UnitOutcome,
        ledger: FailureLedger,
    ) -> dict:
        """Fold one successful unit dispatch into the books; returns the
        ys dict (its "dividends" is what the chunk store snapshots)."""
        ys = dict(ys)
        ys.pop("numerics", None)  # fetched by _capture_unit_numerics
        outcome.engine = ys.pop("_engine_used", "eager")
        demotions = ys.pop("_demotions", ())
        outcome.demotions = len(demotions)
        shrinks = ys.pop("mesh_degradations", ())
        outcome.mesh_shrinks = len(shrinks)
        q = ys.get("quarantine")
        if q is not None:
            if not isinstance(q, QuarantineReport):
                from yuma_simulation_tpu_torch.resilience.guards import (
                    build_quarantine_report,
                )

                q = build_quarantine_report(q)
            outcome.quarantine_entries = tuple(
                QuarantineEntry(case=lo + e.case, epoch=e.epoch, tensor=e.tensor)
                for e in q.entries
            )
        ledger.append(
            "unit_ok",
            unit=idx,
            lanes=[lo, hi],
            attempts=outcome.attempts,
            engine=outcome.engine,
            stalls=outcome.stalls,
            demotions=outcome.demotions,
            mesh_shrinks=outcome.mesh_shrinks,
            canaries=outcome.canaries,
            drifts=outcome.drifts,
            # Full provenance, not just lane indices: a later RESUMED
            # run reconstructs its QuarantineReport from these records
            # (the resumed chunks still carry the zero-masked lanes).
            quarantined=[
                [e.case, e.epoch, e.tensor]
                for e in outcome.quarantine_entries
            ],
        )
        ys["dividends"] = _host(ys["dividends"])
        return ys

    def _build_report(
        self, units, outcomes, executions, resumed, lanes_quarantined,
        directory, resume_requeued=frozenset(),
    ) -> SweepHealthReport:
        runs = [o for per_unit in outcomes.values() for o in per_unit]
        final = [per_unit[-1] for per_unit in outcomes.values()]
        return SweepHealthReport(
            units_total=len(units),
            units_completed=len(units),
            units_resumed=resumed,
            units_retried=sum(
                1
                for per_unit in outcomes.values()
                if any(o.attempts > 1 for o in per_unit)
            ),
            # Distinct requeued units, whichever way the tear was
            # detected: within-run re-entry or resume-time verification
            # failure (matches ledger_counts' distinct-unit rule).
            units_requeued=len(
                {i for i, c in executions.items() if c > 1}
                | set(resume_requeued)
            ),
            stalls_killed=sum(o.stalls for o in runs),
            engine_demotions=sum(o.demotions for o in runs),
            mesh_shrinks=sum(o.mesh_shrinks for o in runs),
            lanes_quarantined=lanes_quarantined,
            engines_used=tuple(sorted({o.engine for o in final}))
            or ("resumed",),
            ledger_path=(
                str(directory / "ledger.jsonl") if directory is not None else None
            ),
            canaries_run=sum(o.canaries for o in runs),
            drift_events=sum(o.drifts for o in runs),
        )


def _ledger_quarantine_entries(
    ledger: FailureLedger, idx: int
) -> tuple:
    """Quarantine provenance for a RESUMED unit, from its last
    `unit_ok` ledger record. Tolerates the legacy record shape (bare
    lane indices) by returning unknown-provenance entries."""
    last = None
    for record in ledger.entries("unit_ok"):
        if record.get("unit") == idx:
            last = record
    if last is None:
        return ()
    entries = []
    for item in last.get("quarantined", ()):
        if isinstance(item, (list, tuple)) and len(item) == 3:
            entries.append(
                QuarantineEntry(
                    case=int(item[0]), epoch=int(item[1]), tensor=str(item[2])
                )
            )
        else:
            entries.append(
                QuarantineEntry(case=int(item), epoch=-1, tensor="unknown")
            )
    return tuple(entries)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _config_slice(configs, lo: int, hi: int):
    """Lanes `[lo, hi)` of a batched config (a :func:`..sweep.config_grid`
    grid): each `[G]` field sliced, scalar fields shared."""
    from yuma_simulation_tpu_torch.simulation.engine import _map_config

    return _map_config(configs, lambda _, v: v[lo:hi] if np.ndim(v) else v)


def _batch_on_rung(
    W, S, ri, re, config, spec, rung, quarantine, miner_mask=None
) -> dict:
    """One `simulate_batch` dispatch pinned to ladder rung `rung`.
    `miner_mask` is the donor-packed suites' per-lane mask
    (`run_batch(pack=True)`); eager rung only."""
    from yuma_simulation_tpu_torch.simulation.sweep import simulate_batch
    from yuma_simulation_tpu_torch.telemetry.runctx import dispatch_annotation

    with dispatch_annotation(f"supervised_batch:{rung}"):
        return simulate_batch(
            W, S, ri, re, config, spec, epoch_impl=rung,
            quarantine=quarantine, miner_mask=miner_mask,
        )


def _state_digest(initial_state) -> Optional[str]:
    """Content address of a suffix-resume carry (sorted-key canonical npz
    bytes, the JAX package's `replay.statecache.serialize_state`), for
    checkpoint fingerprints: a resumed directory must agree on the EXACT
    carry, not just its shape."""
    if initial_state is None:
        return None
    import hashlib
    import io

    buf = io.BytesIO()
    np.savez(buf, **{k: _host(v) for k, v in sorted(initial_state.items())})
    return hashlib.sha256(buf.getvalue()).hexdigest()


def _grid_on_eager(
    scenario,
    yuma_version,
    configs,
    quarantine,
    *,
    initial_state=None,
    epoch_offset: int = 0,
    device="cuda",
) -> dict:
    """One `sweep_hyperparams` dispatch on the eager rung (grid sweeps have
    a single-rung ladder, as the JAX package's run on its XLA rung)."""
    from yuma_simulation_tpu_torch.simulation.sweep import sweep_hyperparams
    from yuma_simulation_tpu_torch.telemetry.runctx import dispatch_annotation

    with dispatch_annotation("supervised_grid:eager"):
        return sweep_hyperparams(
            scenario,
            yuma_version,
            configs,
            quarantine=quarantine,
            initial_state=initial_state,
            epoch_offset=epoch_offset,
            epoch_impl="eager",
            device=device,
        )

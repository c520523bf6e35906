"""The declarative scenario DSL: composable primitives -> dense arrays.

A numpy-only copy of the JAX package's `foundry/dsl.py`, so the port
imports nothing of that package. Small frozen *primitives* (stake
trajectories, weight schedules, epoch events) are combined by a tiny
combinator algebra (:func:`sequence`, :func:`overlay`, :func:`at_epochs`)
into a frozen, serializable :class:`ScenarioSpec`, and :func:`compile_spec`
materializes the spec deterministically into the dense `Scenario` arrays
(`weights[E, V, M]` / `stakes[E, V]`, `scenarios/base.py`) every engine rung
and the planner take. The arrays, the JSON form (:func:`spec_to_json`) and
:func:`spec_key` are the JAX package's byte for byte
(tests/test_torch_foundry.py).

Compilation order is part of the contract: stake clauses first (in
clause order, later writes win on overlap), then weight clauses (a
:class:`CopyWithLag` or :class:`NoisyConsensusFollower` clause reads the
rows earlier clauses already painted), then events
(:class:`Takeover` rescales stakes; :class:`BondReset` becomes scenario
metadata). Everything is host-side numpy with explicit integer seeds —
two compiles of one spec are bitwise identical on any machine.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from yuma_simulation_tpu_torch.scenarios.base import Scenario
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)


class SpecError(ValueError):
    """A spec that cannot compile (bad indices, shape mismatches)."""


def _check_validator(num_validators: int, index: int, label: str) -> None:
    """Typed bounds check for validator indices carried by primitives:
    a negative index would silently numpy-wrap onto another validator's
    row, an oversized one would escape as a raw IndexError — both must
    be the DSL's own SpecError (this is a serializable public surface)."""
    if not 0 <= int(index) < num_validators:
        raise SpecError(
            f"{label}={index} out of range for {num_validators} validators"
        )


def record_scenario_generated() -> None:
    """The ONE increment site wrapper for the `scenarios_generated`
    counter — every foundry generator (DSL compiles, snapshot
    ingestion) counts through here, and the help text is read from the
    registry's declaration rather than re-typed."""
    from yuma_simulation_tpu_torch.telemetry.metrics import get_registry
    from yuma_simulation_tpu_torch.telemetry.registry import METRICS

    get_registry().counter(
        "scenarios_generated", METRICS["scenarios_generated"].summary
    ).inc()


# --------------------------------------------------------------- primitives
#
# Each primitive is a frozen dataclass whose fields are plain JSON-able
# scalars/tuples (the serialization contract), with one `paint` method
# mutating the dense array slice `[lo:hi]` it is clause-scoped to.


@dataclass(frozen=True)
class OneHot:
    """One-hot weight assignment: validator v puts full weight on miner
    `assignments[v]` — the `assignment_weights` schedule rule."""

    assignments: tuple

    def paint(self, W: np.ndarray, S: np.ndarray, lo: int, hi: int) -> None:
        if len(self.assignments) != W.shape[1]:
            raise SpecError(
                f"OneHot names {len(self.assignments)} validators, "
                f"spec has {W.shape[1]}"
            )
        W[lo:hi] = 0.0
        for v, m in enumerate(self.assignments):
            if not 0 <= int(m) < W.shape[2]:
                raise SpecError(
                    f"OneHot assigns validator {v} to miner {m}, spec has "
                    f"{W.shape[2]} miners"
                )
            W[lo:hi, v, int(m)] = 1.0


@dataclass(frozen=True)
class Rows:
    """Explicit per-validator weight rows — the `row_weights` rule."""

    rows: tuple  # tuple[tuple[float, ...], ...] of shape [V, M]

    def paint(self, W: np.ndarray, S: np.ndarray, lo: int, hi: int) -> None:
        mat = np.asarray(self.rows, np.float32)
        if mat.shape != W.shape[1:]:
            raise SpecError(
                f"Rows shape {mat.shape} != spec's (V, M) {W.shape[1:]}"
            )
        W[lo:hi] = mat


@dataclass(frozen=True)
class CopyWithLag:
    """Weight copying: validator `dst` reproduces validator `src`'s row
    from `lag` epochs earlier (clamped at the scenario start) — the
    canonical weight-copier adversary. Reads the rows earlier clauses
    already painted, so sequence it AFTER the honest schedule."""

    dst: int
    src: int
    lag: int = 1

    def paint(self, W: np.ndarray, S: np.ndarray, lo: int, hi: int) -> None:
        if self.lag < 0:
            raise SpecError(f"CopyWithLag lag must be >= 0, got {self.lag}")
        _check_validator(W.shape[1], self.dst, "CopyWithLag.dst")
        _check_validator(W.shape[1], self.src, "CopyWithLag.src")
        for e in range(lo, hi):
            W[e, self.dst] = W[max(e - self.lag, 0), self.src]


@dataclass(frozen=True)
class NoisyConsensusFollower:
    """Validator `validator` follows the stake-weighted mean of every
    OTHER validator's current row, perturbed by multiplicative
    log-normal noise (sigma) and re-normalized. Deterministic: the RNG
    is seeded per (seed, epoch), never from global state."""

    validator: int
    sigma: float = 0.05
    seed: int = 0

    def paint(self, W: np.ndarray, S: np.ndarray, lo: int, hi: int) -> None:
        v = self.validator
        _check_validator(W.shape[1], v, "NoisyConsensusFollower.validator")
        others = [i for i in range(W.shape[1]) if i != v]
        if not others:
            raise SpecError("NoisyConsensusFollower needs >= 2 validators")
        for e in range(lo, hi):
            stakes = S[e, others]
            total = stakes.sum()
            share = (
                stakes / total
                if total > 0
                else np.full(len(others), 1.0 / len(others), np.float32)
            )
            consensus = (share[:, None] * W[e, others]).sum(axis=0)
            rng = np.random.default_rng((self.seed, e))
            noisy = consensus * np.exp(
                self.sigma * rng.standard_normal(consensus.shape)
            ).astype(np.float32)
            row_sum = noisy.sum()
            W[e, v] = (noisy / row_sum if row_sum > 0 else noisy).astype(
                np.float32
            )


@dataclass(frozen=True)
class Stakes:
    """Constant stakes over the clause's epoch range. With
    :func:`at_epochs` this is also the churn-shock / join / leave
    trajectory: a later clause stepping to new values (zeros = left)."""

    values: tuple

    def paint(self, W: np.ndarray, S: np.ndarray, lo: int, hi: int) -> None:
        vals = np.asarray(self.values, np.float32)
        if vals.shape != (S.shape[1],):
            raise SpecError(
                f"Stakes names {vals.shape[0]} validators, spec has "
                f"{S.shape[1]}"
            )
        S[lo:hi] = vals


@dataclass(frozen=True)
class StakeDrift:
    """Linear per-validator stake drift from `start_values` to
    `end_values` across the clause's epoch range (endpoints inclusive)."""

    start_values: tuple
    end_values: tuple

    def paint(self, W: np.ndarray, S: np.ndarray, lo: int, hi: int) -> None:
        a = np.asarray(self.start_values, np.float32)
        b = np.asarray(self.end_values, np.float32)
        if a.shape != (S.shape[1],) or b.shape != (S.shape[1],):
            raise SpecError("StakeDrift endpoint length != num validators")
        span = max(hi - lo - 1, 1)
        for e in range(lo, hi):
            t = np.float32((e - lo) / span)
            S[e] = a + t * (b - a)


@dataclass(frozen=True)
class BondReset:
    """Epoch event: the case's bond-reset metadata (reference cases with
    `reset_bonds`): validator `index` resets at `epoch`."""

    index: int
    epoch: int


@dataclass(frozen=True)
class Takeover:
    """Epoch event: validator `validator` seizes `stake_fraction` of the
    subnet stake from `epoch` on; every other validator's stake is
    scaled down proportionally so the per-epoch total is preserved."""

    validator: int
    epoch: int
    stake_fraction: float = 0.6

    def paint(self, W: np.ndarray, S: np.ndarray, lo: int, hi: int) -> None:
        del lo, hi
        v = self.validator
        _check_validator(S.shape[1], v, "Takeover.validator")
        if not 0.0 < self.stake_fraction < 1.0:
            raise SpecError(
                f"Takeover stake_fraction must be in (0, 1), got "
                f"{self.stake_fraction}"
            )
        if not 0 <= self.epoch < S.shape[0]:
            raise SpecError(
                f"Takeover.epoch={self.epoch} out of range for "
                f"{S.shape[0]} epochs"
            )
        for e in range(self.epoch, S.shape[0]):
            total = S[e].sum()
            others = total - S[e, v]
            if total <= 0:
                continue
            if others <= 0:
                # v already holds ALL stake: there is nobody to seize
                # from, and rescaling would shrink the per-epoch total
                # the docstring promises to preserve — leave the epoch
                # untouched.
                continue
            scale = (1.0 - self.stake_fraction) * total / others
            S[e] *= np.float32(scale)
            S[e, v] = np.float32(self.stake_fraction) * total


#: The serialization registry: type tag -> primitive class. Every
#: primitive above must be listed or `spec_from_dict` cannot round-trip.
PRIMITIVES = {
    cls.__name__: cls
    for cls in (
        OneHot,
        Rows,
        CopyWithLag,
        NoisyConsensusFollower,
        Stakes,
        StakeDrift,
        BondReset,
        Takeover,
    )
}

WeightPrim = Union[OneHot, Rows, CopyWithLag, NoisyConsensusFollower]
StakePrim = Union[Stakes, StakeDrift]
EventPrim = Union[BondReset, Takeover]


# ------------------------------------------------------------- combinators


@dataclass(frozen=True)
class Clause:
    """One primitive scoped to the epoch range `[start, stop)`;
    `stop=None` means "to the end of the scenario"."""

    prim: object
    start: int = 0
    stop: Optional[int] = None

    def bounds(self, num_epochs: int) -> tuple[int, int]:
        stop = num_epochs if self.stop is None else min(self.stop, num_epochs)
        lo = max(int(self.start), 0)
        return lo, max(stop, lo)


def at_epochs(prim, start: int, stop: Optional[int] = None) -> Clause:
    """Scope a primitive to `[start, stop)` epochs (later clauses win on
    overlap, exactly like the builtin schedules' range rules)."""
    if isinstance(prim, Clause):
        raise SpecError("at_epochs takes a primitive, not a Clause")
    return Clause(prim, start, stop)


def sequence(*items) -> tuple:
    """Normalize primitives/clauses into an ordered clause tuple; bare
    primitives cover the whole scenario. Order is application order —
    the last writer of an epoch wins."""
    out = []
    for item in items:
        out.append(item if isinstance(item, Clause) else Clause(item))
    return tuple(out)


def overlay(*programs) -> tuple:
    """Concatenate clause programs; the later program paints on top of
    (and may read the state left by) the earlier one."""
    out: list = []
    for prog in programs:
        if isinstance(prog, (Clause,)) or not isinstance(prog, (tuple, list)):
            out.extend(sequence(prog))
        else:
            out.extend(sequence(*prog))
    return tuple(out)


# ---------------------------------------------------------------- the spec


@dataclass(frozen=True)
class ScenarioSpec:
    """A frozen, serializable scenario program.

    `weights` / `stakes` are clause tuples (see :func:`sequence`);
    `events` holds :class:`BondReset` / :class:`Takeover` primitives
    (unscoped — each carries its own epoch). `servers=None` derives the
    reference's "Server i" naming from `num_miners`."""

    name: str
    validators: tuple
    base_validator: str
    num_miners: int
    num_epochs: int = 40
    weights: tuple = ()
    stakes: tuple = ()
    events: tuple = ()
    servers: Optional[tuple] = None
    plot_incentives: bool = False

    def __post_init__(self):
        if self.base_validator not in self.validators:
            raise SpecError(
                f"base_validator {self.base_validator!r} not among "
                f"validators {self.validators!r}"
            )
        if self.num_miners < 1 or self.num_epochs < 1:
            raise SpecError("num_miners and num_epochs must be >= 1")


def compile_spec(spec: ScenarioSpec, *, validate: bool = True) -> Scenario:
    """Materialize a :class:`ScenarioSpec` into dense `Scenario` arrays.

    Deterministic (two compiles are bitwise identical) and validated on
    the way out (:meth:`..scenarios.base.Scenario.validate` — a spec
    whose program paints NaN/negative weights fails here, not three
    layers down in an engine reduction). Every downstream consumer —
    `plan_dispatch`, donor packing, the engine rungs, the supervisor —
    takes the result unchanged."""
    V = len(spec.validators)
    E, M = spec.num_epochs, spec.num_miners
    W = np.zeros((E, V, M), np.float32)
    S = np.zeros((E, V), np.float32)

    for clause in sequence(*spec.stakes):
        lo, hi = clause.bounds(E)
        clause.prim.paint(W, S, lo, hi)
    for clause in sequence(*spec.weights):
        lo, hi = clause.bounds(E)
        clause.prim.paint(W, S, lo, hi)

    reset_index = reset_epoch = None
    for event in spec.events:
        if isinstance(event, BondReset):
            if reset_index is not None:
                # Scenario carries exactly one reset; accepting two and
                # keeping the last would silently simulate a different
                # spec than the one serialized.
                raise SpecError(
                    f"spec {spec.name!r} declares more than one "
                    "BondReset; Scenario supports at most one"
                )
            _check_validator(V, event.index, "BondReset.index")
            if not 0 <= int(event.epoch) < E:
                raise SpecError(
                    f"BondReset.epoch={event.epoch} out of range for "
                    f"{E} epochs"
                )
            reset_index, reset_epoch = int(event.index), int(event.epoch)
        elif isinstance(event, Takeover):
            event.paint(W, S, 0, E)
        else:
            raise SpecError(f"unknown event primitive {event!r}")

    scenario = Scenario(
        name=spec.name,
        validators=list(spec.validators),
        base_validator=spec.base_validator,
        weights=W,
        stakes=S,
        num_epochs=E,
        reset_bonds=reset_index is not None,
        reset_bonds_index=reset_index,
        reset_bonds_epoch=reset_epoch,
        servers=(
            list(spec.servers)
            if spec.servers is not None
            else [f"Server {i + 1}" for i in range(M)]
        ),
        plot_incentives=spec.plot_incentives,
    )
    if validate:
        # DSL rows are normalized by construction (one-hot assignments,
        # normalized Rows, renormalized followers) — enforce it, so a
        # mis-entered Rows matrix fails at compile with provenance.
        scenario.validate(normalized=True)
    record_scenario_generated()
    log_event(
        logger,
        "scenario_compiled",
        level=logging.DEBUG,
        name=spec.name,
        epochs=E,
        validators=V,
        miners=M,
        clauses=len(spec.weights) + len(spec.stakes) + len(spec.events),
    )
    return scenario


# ------------------------------------------------------------ serialization


def _prim_to_dict(prim) -> dict:
    return {"type": type(prim).__name__, **dataclasses.asdict(prim)}


def _prim_from_dict(payload: dict):
    kind = payload.get("type")
    cls = PRIMITIVES.get(kind)
    if cls is None:
        raise SpecError(f"unknown primitive type {kind!r}")
    kwargs = {k: v for k, v in payload.items() if k != "type"}
    for field in dataclasses.fields(cls):
        if field.name in kwargs and isinstance(kwargs[field.name], list):
            kwargs[field.name] = _tupleize(kwargs[field.name])
    return cls(**kwargs)


def _tupleize(value):
    if isinstance(value, list):
        return tuple(_tupleize(v) for v in value)
    return value


def _clause_to_dict(clause: Clause) -> dict:
    return {
        "prim": _prim_to_dict(clause.prim),
        "start": clause.start,
        "stop": clause.stop,
    }


def spec_to_dict(spec: ScenarioSpec) -> dict:
    """The JSON-able form of a spec — the wire/disk format of the
    foundry (suite manifests, request keys, test artifacts); the JAX
    package's byte for byte."""
    return {
        "format": "yuma-scenario-spec-v1",
        "name": spec.name,
        "validators": list(spec.validators),
        "base_validator": spec.base_validator,
        "num_miners": spec.num_miners,
        "num_epochs": spec.num_epochs,
        "weights": [_clause_to_dict(c) for c in sequence(*spec.weights)],
        "stakes": [_clause_to_dict(c) for c in sequence(*spec.stakes)],
        "events": [_prim_to_dict(e) for e in spec.events],
        "servers": None if spec.servers is None else list(spec.servers),
        "plot_incentives": spec.plot_incentives,
    }


def spec_from_dict(payload: dict) -> ScenarioSpec:
    """Inverse of :func:`spec_to_dict`; compiles bitwise-identically.
    Malformed payloads (missing keys included) raise the DSL's typed
    :class:`SpecError`, never a bare KeyError — this is the wire
    format's parse boundary."""
    if payload.get("format") != "yuma-scenario-spec-v1":
        raise SpecError(
            f"not a scenario-spec payload (format={payload.get('format')!r})"
        )
    try:
        return ScenarioSpec(
            name=payload["name"],
            validators=tuple(payload["validators"]),
            base_validator=payload["base_validator"],
            num_miners=int(payload["num_miners"]),
            num_epochs=int(payload["num_epochs"]),
            weights=tuple(
                Clause(_prim_from_dict(c["prim"]), c["start"], c["stop"])
                for c in payload.get("weights", ())
            ),
            stakes=tuple(
                Clause(_prim_from_dict(c["prim"]), c["start"], c["stop"])
                for c in payload.get("stakes", ())
            ),
            events=tuple(
                _prim_from_dict(e) for e in payload.get("events", ())
            ),
            servers=(
                None
                if payload.get("servers") is None
                else tuple(payload["servers"])
            ),
            plot_incentives=bool(payload.get("plot_incentives", False)),
        )
    except (KeyError, TypeError) as exc:
        raise SpecError(
            f"malformed scenario-spec payload: {type(exc).__name__}: {exc}"
        ) from None


def spec_to_json(spec: ScenarioSpec) -> str:
    return json.dumps(spec_to_dict(spec), sort_keys=True)


def spec_from_json(text: str) -> ScenarioSpec:
    return spec_from_dict(json.loads(text))


def spec_key(spec: ScenarioSpec) -> str:
    """A short deterministic content key for a spec (suite manifests,
    request keys): sha256 of the canonical JSON form."""
    import hashlib

    return hashlib.sha256(spec_to_json(spec).encode("utf-8")).hexdigest()[:16]


# ------------------------------------- built-in cases, re-expressed (pin)

_DEFAULT_STAKES = (0.8, 0.1, 0.1)


def builtin_case_specs() -> dict:
    """Six of the 14 built-in cases re-expressed in the DSL.

    tests/test_torch_foundry.py pins each compile BITWISE against the
    hand-built arrays in `scenarios/builtin.py` — the proof that the DSL
    reaches the exact representation the rest of the platform is pinned
    on (goldens, donor packing, drift canaries), not an approximation."""
    specs = {}
    specs["Case 1"] = ScenarioSpec(
        name="Case 1 - kappa moves first",
        validators=(
            "Big vali. (0.8)",
            "Small lazy vali. (0.1)",
            "Small lazier vali. (0.1)",
        ),
        base_validator="Big vali. (0.8)",
        num_miners=2,
        stakes=sequence(Stakes(_DEFAULT_STAKES)),
        weights=sequence(
            at_epochs(OneHot((0, 0, 0)), 0, 1),
            at_epochs(OneHot((1, 0, 0)), 1, 2),
            at_epochs(OneHot((1, 1, 0)), 2, 3),
            at_epochs(OneHot((1, 1, 1)), 3),
        ),
    )
    specs["Case 2"] = ScenarioSpec(
        name="Case 2 - kappa moves second",
        validators=(
            "Big vali. (0.8)",
            "Small eager vali. (0.1)",
            "Small lazy vali. (0.1)",
        ),
        base_validator="Small eager vali. (0.1)",
        num_miners=2,
        stakes=sequence(Stakes(_DEFAULT_STAKES)),
        weights=sequence(
            at_epochs(OneHot((0, 0, 0)), 0, 1),
            at_epochs(OneHot((0, 1, 0)), 1, 2),
            at_epochs(OneHot((1, 1, 0)), 2, 3),
            at_epochs(OneHot((1, 1, 1)), 3),
        ),
    )
    specs["Case 3"] = ScenarioSpec(
        name="Case 3 - kappa moves third",
        validators=(
            "Big vali. (0.8)",
            "Small eager vali. (0.1)",
            "Small lazy vali. (0.1)",
        ),
        base_validator="Small eager vali. (0.1)",
        num_miners=2,
        stakes=sequence(Stakes(_DEFAULT_STAKES)),
        weights=sequence(
            at_epochs(OneHot((0, 0, 0)), 0, 1),
            at_epochs(OneHot((0, 1, 0)), 1, 2),
            at_epochs(OneHot((0, 1, 1)), 2, 3),
            at_epochs(OneHot((1, 1, 1)), 3),
        ),
    )
    specs["Case 4"] = ScenarioSpec(
        name="Case 4 - all validators switch",
        validators=(
            "Big vali. (0.8)",
            "Small vali. (0.1)",
            "Small vali 2. (0.1)",
        ),
        base_validator="Big vali. (0.8)",
        num_miners=2,
        stakes=sequence(Stakes(_DEFAULT_STAKES)),
        weights=sequence(
            at_epochs(OneHot((0, 0, 0)), 0, 1),
            at_epochs(OneHot((1, 1, 1)), 1),
        ),
    )
    specs["Case 9"] = ScenarioSpec(
        name="Case 9 - small validators merged in e5",
        validators=(
            "Big vali. (0.8)",
            "Small vali. (0.1/0.2)",
            "Small vali 2. (0.1/0.0)",
        ),
        base_validator="Big vali. (0.8)",
        num_miners=2,
        stakes=sequence(
            Stakes(_DEFAULT_STAKES),
            at_epochs(Stakes((0.8, 0.2, 0.0)), 6),
        ),
        weights=sequence(OneHot((1, 1, 1))),
    )
    specs["Case 14"] = ScenarioSpec(
        name=(
            "Case 14 - All validators support Server 1, one of them "
            "switches to Server 2 for one epoch"
        ),
        validators=("Vali. 1 (0.33)", "Vali. 2 (0.33)", "Vali. 3 (0.34)"),
        base_validator="Vali. 1 (0.33)",
        num_miners=2,
        stakes=sequence(Stakes((0.33, 0.33, 0.34))),
        weights=sequence(
            at_epochs(OneHot((0, 0, 0)), 0, 20),
            at_epochs(OneHot((0, 0, 1)), 20, 21),
            at_epochs(OneHot((0, 0, 0)), 21),
        ),
    )
    return specs

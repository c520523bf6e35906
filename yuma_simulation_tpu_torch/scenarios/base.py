"""Scenario spec + registry.

The reference expresses each scenario as a dataclass whose
`weights_epochs` / `stakes_epochs` *properties* rebuild a list of per-epoch
tensors on every access (reference cases.py:16-48, an O(E^2) pathology in
the epoch loop). Here a scenario is plain data: dense arrays
`weights[E, V, M]` / `stakes[E, V]` built exactly once, which is also what
the epoch loop wants as its stacked inputs and what a batched suite
stacks. A numpy-only copy of the JAX package's module of the same path, so
the port imports nothing of that package. The registry (`register_case` / `create_case` / `class_registry`)
mirrors the reference's string-keyed factory API (cases.py:6-48).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np

# name -> builder callable (mirrors reference cases.py:6)
class_registry: dict[str, Callable[..., "Scenario"]] = {}


def register_case(name: str):
    """Register a scenario builder under a case name (cases.py:9-14)."""

    def decorator(builder):
        class_registry[name] = builder
        return builder

    return decorator


def create_case(case_name: str, **kwargs) -> "Scenario":
    """Instantiate a registered case by name (cases.py:44-48)."""
    if case_name not in class_registry:
        raise ValueError(f"Case '{case_name}' is not registered.")
    return class_registry[case_name](**kwargs)


#: Materialized builtin-case cache keyed by the registry's
#: (name, builder) pairs: re-registering a name under a NEW builder (or
#: registering a new case) invalidates it, a plain repeat call reuses
#: the built arrays. `get_cases` COPIES on return.
_CASES_CACHE: dict = {}


def get_cases() -> list["Scenario"]:
    """All registered cases, in registration order (cases.py:601).

    Before 0.16.0 every call re-invoked every registered builder — an
    O(cases) array-construction bill per call that callers paid dozens
    of times per process (the chart suite, every drill, every test
    module importing `scenarios.cases`). The materialized suite is now
    memoized per registry state, and each call returns equal-but-
    INDEPENDENT scenarios (fresh array copies), so a caller mutating
    its suite — padding in place, fault injection — cannot poison the
    cache for the next caller."""
    key = tuple(class_registry.items())
    if key not in _CASES_CACHE:
        _CASES_CACHE.clear()
        _CASES_CACHE[key] = [
            builder() for builder in class_registry.values()
        ]
    return [
        replace(
            s,
            weights=s.weights.copy(),
            stakes=s.stakes.copy(),
            validators=list(s.validators),
            servers=list(s.servers),
        )
        for s in _CASES_CACHE[key]
    ]


class ScenarioValidationError(ValueError):
    """A scenario whose arrays violate the foundry's input contract."""


@dataclass
class Scenario:
    """A fully materialized scenario: dense arrays + display metadata."""

    name: str
    validators: list[str]
    base_validator: str
    weights: np.ndarray  # [E, V, M] float32
    stakes: np.ndarray  # [E, V] float32
    num_epochs: int = 40
    reset_bonds: bool = False
    reset_bonds_index: Optional[int] = None
    reset_bonds_epoch: Optional[int] = None
    servers: list[str] = field(default_factory=lambda: ["Server 1", "Server 2"])
    #: Whether chart tables add the server-incentives row for this case.
    #: The reference keys this off positional indices 9/10 of the full
    #: suite (reference v1/api.py:42-45) — i.e. Cases 10 and 11; carrying
    #: it on the scenario makes it survive case subsets/reordering.
    plot_incentives: bool = False

    def __post_init__(self):
        if self.base_validator not in self.validators:
            raise ValueError(
                f"base_validator '{self.base_validator}' must be in validators list."
            )
        self.weights = np.asarray(self.weights, np.float32)
        self.stakes = np.asarray(self.stakes, np.float32)
        E, V, M = self.weights.shape
        if E != self.num_epochs or self.stakes.shape != (E, V):
            raise ValueError(
                f"inconsistent scenario arrays: weights {self.weights.shape}, "
                f"stakes {self.stakes.shape}, num_epochs {self.num_epochs}"
            )

    @property
    def num_validators(self) -> int:
        return self.weights.shape[1]

    @property
    def num_miners(self) -> int:
        return self.weights.shape[2]

    def validate(
        self,
        *,
        normalized: bool = False,
        normalization_tol: float = 1e-3,
    ) -> "Scenario":
        """The foundry input contract: every generated scenario passes
        through here before it can reach an engine (compile_spec,
        snapshot ingestion, the adversarial builders), so a generator
        bug surfaces as a typed :class:`ScenarioValidationError` with
        provenance instead of a NaN-poisoned batch reduction three
        layers down.

        Checks: weights finite and non-negative; stakes finite and
        non-negative; at least one epoch with positive total stake.
        `normalized=True` additionally requires every non-zero weight
        row to sum to 1 within `normalization_tol` (DSL outputs are
        row-normalized by construction; raw chain snapshots normalize
        during ingestion). Returns self for fluent use."""
        W, S = self.weights, self.stakes
        if not np.isfinite(W).all():
            bad = np.argwhere(~np.isfinite(W))[0]
            raise ScenarioValidationError(
                f"scenario {self.name!r}: non-finite weight at "
                f"(epoch, validator, miner)={tuple(int(i) for i in bad)}"
            )
        if (W < 0).any():
            bad = np.argwhere(W < 0)[0]
            raise ScenarioValidationError(
                f"scenario {self.name!r}: negative weight at "
                f"(epoch, validator, miner)={tuple(int(i) for i in bad)}"
            )
        if not np.isfinite(S).all():
            bad = np.argwhere(~np.isfinite(S))[0]
            raise ScenarioValidationError(
                f"scenario {self.name!r}: non-finite stake at "
                f"(epoch, validator)={tuple(int(i) for i in bad)}"
            )
        if (S < 0).any():
            bad = np.argwhere(S < 0)[0]
            raise ScenarioValidationError(
                f"scenario {self.name!r}: negative stake at "
                f"(epoch, validator)={tuple(int(i) for i in bad)}"
            )
        if not (S.sum(axis=1) > 0).any():
            raise ScenarioValidationError(
                f"scenario {self.name!r}: zero total stake in every epoch"
            )
        if normalized:
            row_sums = W.sum(axis=2)
            off = np.abs(row_sums - 1.0) > normalization_tol
            bad_rows = off & (row_sums != 0.0)
            if bad_rows.any():
                e, v = (int(i) for i in np.argwhere(bad_rows)[0])
                raise ScenarioValidationError(
                    f"scenario {self.name!r}: weight row (epoch {e}, "
                    f"validator {v}) sums to {float(row_sums[e, v]):.6g}, "
                    f"not 1 within {normalization_tol}"
                )
        return self

    # --- reference-compatible list-of-tensors views (cases.py:27-35) ---
    @property
    def weights_epochs(self) -> list[np.ndarray]:
        return list(self.weights)

    @property
    def stakes_epochs(self) -> list[np.ndarray]:
        return list(self.stakes)


#: Back-compat alias: the reference's scenario base class name.
BaseCase = Scenario


def assignment_weights(
    num_epochs: int,
    num_validators: int,
    num_miners: int,
    schedule: list[tuple[range, list[int]]],
) -> np.ndarray:
    """Build `[E, V, M]` one-hot weights from (epoch-range -> server index
    per validator) rules; later rules win on overlap."""
    W = np.zeros((num_epochs, num_validators, num_miners), np.float32)
    for epochs, servers in schedule:
        for e in epochs:
            if 0 <= e < num_epochs:
                W[e] = 0.0
                for v, m in enumerate(servers):
                    W[e, v, m] = 1.0
    return W


def row_weights(
    num_epochs: int,
    schedule: list[tuple[range, list[list[float]]]],
) -> np.ndarray:
    """Build `[E, V, M]` weights from explicit per-epoch row matrices."""
    first = np.asarray(schedule[0][1], np.float32)
    W = np.zeros((num_epochs,) + first.shape, np.float32)
    for epochs, rows in schedule:
        mat = np.asarray(rows, np.float32)
        for e in epochs:
            if 0 <= e < num_epochs:
                W[e] = mat
    return W


def constant_stakes(num_epochs: int, stakes: list[float]) -> np.ndarray:
    return np.tile(np.asarray(stakes, np.float32), (num_epochs, 1))

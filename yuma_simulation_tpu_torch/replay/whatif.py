"""What-if specs and their suffix-resumed execution.

A :class:`WhatIfSpec` is a frozen, JSON-round-trippable perturbation of
one subnet's baseline trajectory under one Yuma variant: a
hyperparameter delta, validator weight-row overrides, and/or stake
shocks, all taking effect at ``from_epoch`` — the epoch the perturbed
world diverges from the archived baseline. Because nothing before
``from_epoch`` changes, the prefix of the perturbed trajectory is
bitwise the baseline's (scan causality: epoch ``e`` depends only on
inputs ``[0..e]``), so :func:`run_whatif` resumes from the nearest
cached checkpoint ``c <= from_epoch`` and re-simulates only epochs
``[c, E)`` — the :mod:`.statecache` hit path — while producing the
exact bits an uncached end-to-end run of the same perturbed world
yields (``use_cache=False`` computes that reference; the property
suite pins the two equal on every engine rung).

Hyperparameter deltas change the *config* from ``from_epoch`` onward (a
chain governance change taking effect at a block), so their execution
is piecewise: baseline config up to ``from_epoch``, perturbed config
after — two engine dispatches at most, both riding the suffix-resume
carry contract.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import replace

import numpy as np

from yuma_simulation_tpu_torch.replay.statecache import BaselineMeta, StateCache


class WhatIfError(ValueError):
    """A what-if spec that violates the contract (unknown fields, out
    of range indices/epochs, non-settable hyperparameters)."""


#: Config fields a what-if may override — the same request-settable
#: float universe the serve tier's admission accepts (compile-static
#: fields select different programs, which a warm-engine service must
#: not let a payload do).
def _settable_fields() -> tuple[set, set]:
    from yuma_simulation_tpu_torch.models.config import (
        SimulationHyperparameters,
        YumaParams,
    )

    sim = SimulationHyperparameters()
    par = YumaParams()
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
    return sim_fields, par_fields


@dataclasses.dataclass(frozen=True)
class WhatIfSpec:
    """One frozen perturbation (module docstring). All collection
    fields are tuples so the spec is hashable and its JSON form is
    canonical."""

    netuid: int
    version: str
    #: the epoch the perturbed world diverges from the baseline —
    #: nothing before it may change (validated).
    from_epoch: int = 0
    #: ``((field, new_value), ...)`` config overrides effective from
    #: ``from_epoch`` (request-settable float fields only).
    hparams: tuple = ()
    #: ``((validator_index, (w_0 .. w_{M-1})), ...)`` replacement weight
    #: rows (re-normalized on application), effective from ``from_epoch``.
    weight_rows: tuple = ()
    #: ``((validator_index, factor), ...)`` stake multipliers effective
    #: from ``from_epoch`` (a stake shock).
    stake_scale: tuple = ()

    def __post_init__(self):
        if self.from_epoch < 0:
            raise WhatIfError(
                f"from_epoch must be >= 0, got {self.from_epoch}"
            )
        if not (self.hparams or self.weight_rows or self.stake_scale):
            raise WhatIfError(
                "a what-if must perturb something: hparams, weight_rows "
                "or stake_scale"
            )
        sim_fields, par_fields = _settable_fields()
        for name, value in self.hparams:
            if name not in sim_fields | par_fields:
                raise WhatIfError(
                    f"hyperparameter {name!r} is not what-if-settable "
                    "(unknown or compile-static)"
                )
            if not isinstance(value, (int, float)) or isinstance(
                value, bool
            ):
                raise WhatIfError(f"hyperparameter {name!r} must be a number")
        for idx, factor in self.stake_scale:
            if not isinstance(idx, int) or idx < 0:
                raise WhatIfError(
                    f"stake_scale validator index must be >= 0, got {idx!r}"
                )
            if (
                not isinstance(factor, (int, float))
                or isinstance(factor, bool)
                or factor < 0
                or not np.isfinite(factor)
            ):
                raise WhatIfError(
                    f"stake_scale factor must be a finite number >= 0, "
                    f"got {factor!r}"
                )
        for idx, row in self.weight_rows:
            if not isinstance(idx, int) or idx < 0:
                raise WhatIfError(
                    f"weight_rows validator index must be >= 0, got {idx!r}"
                )
            arr = np.asarray(row, dtype=np.float64)
            if arr.ndim != 1:
                raise WhatIfError(
                    f"weight row for validator {idx} must be 1-D"
                )
            if not np.isfinite(arr).all() or (arr < 0).any():
                raise WhatIfError(
                    f"weight row for validator {idx} must be finite and "
                    "non-negative"
                )

    # -- serialization ---------------------------------------------------

    def to_json(self) -> dict:
        return {
            "netuid": self.netuid,
            "version": self.version,
            "from_epoch": self.from_epoch,
            "hparams": [[n, float(v)] for n, v in self.hparams],
            "weight_rows": [
                [i, [float(w) for w in row]] for i, row in self.weight_rows
            ],
            "stake_scale": [[i, float(f)] for i, f in self.stake_scale],
        }

    @classmethod
    def from_json(cls, payload: dict) -> "WhatIfSpec":
        if not isinstance(payload, dict):
            raise WhatIfError("what-if spec must be a JSON object")
        known = {
            "netuid",
            "version",
            "from_epoch",
            "hparams",
            "weight_rows",
            "stake_scale",
        }
        extra = set(payload) - known
        if extra:
            raise WhatIfError(
                f"unknown what-if fields {sorted(extra)} (expected a "
                f"subset of {sorted(known)})"
            )
        if "netuid" not in payload or "version" not in payload:
            raise WhatIfError("what-if spec needs 'netuid' and 'version'")
        try:
            netuid = int(payload["netuid"])
            from_epoch = int(payload.get("from_epoch", 0))
        except (TypeError, ValueError) as exc:
            raise WhatIfError(str(exc)) from None

        def pairs(name, cast):
            raw = payload.get(name, [])
            if not isinstance(raw, (list, tuple)):
                raise WhatIfError(f"{name} must be a list of pairs")
            out = []
            for item in raw:
                if not isinstance(item, (list, tuple)) or len(item) != 2:
                    raise WhatIfError(f"{name} entries must be pairs")
                try:
                    out.append(cast(item))
                except (TypeError, ValueError) as exc:
                    # The cast's own failure must stay a TYPED spec
                    # error: admission only converts WhatIfError into a
                    # 400, so a bare ValueError here would surface as a
                    # 503 and burn the serve error-rate SLO on a
                    # payload mistake.
                    raise WhatIfError(
                        f"{name} entry {item!r}: {exc}"
                    ) from None
            return tuple(out)

        return cls(
            netuid=netuid,
            version=str(payload["version"]),
            from_epoch=from_epoch,
            hparams=pairs("hparams", lambda it: (str(it[0]), float(it[1]))),
            weight_rows=pairs(
                "weight_rows",
                lambda it: (int(it[0]), tuple(float(w) for w in it[1])),
            ),
            stake_scale=pairs(
                "stake_scale", lambda it: (int(it[0]), float(it[1]))
            ),
        )

    def spec_key(self) -> str:
        """Content address of the spec (canonical JSON sha256)."""
        return hashlib.sha256(
            json.dumps(self.to_json(), sort_keys=True).encode()
        ).hexdigest()


@dataclasses.dataclass
class WhatIfResult:
    """One executed what-if: the perturbed trajectory, its deltas vs
    the baseline, and the suffix-resume accounting (the epoch-count
    telemetry the acceptance criteria gate on)."""

    spec: WhatIfSpec
    dividends: np.ndarray  # [E, V] perturbed trajectory
    incentives: np.ndarray  # [E, M]
    dividend_delta: np.ndarray  # [E, V] perturbed - baseline
    incentive_delta: np.ndarray  # [E, M]
    cache_hit: bool
    resume_epoch: int
    epochs_simulated: int
    epochs_saved: int
    baseline_key: str

    @property
    def total_dividend_delta(self) -> np.ndarray:  # [V]
        return self.dividend_delta.sum(axis=0)

    @property
    def total_incentive_delta(self) -> np.ndarray:  # [M]
        return self.incentive_delta.sum(axis=0)


def apply_config(config, spec: WhatIfSpec):
    """The perturbed config (hyperparameter overrides applied; the
    caller decides WHEN it takes effect — see :func:`run_whatif`)."""
    if not spec.hparams:
        return config
    sim_fields, par_fields = _settable_fields()
    sim, par = config.simulation, config.yuma_params
    for name, value in spec.hparams:
        if name in sim_fields:
            sim = replace(sim, **{name: float(value)})
        else:
            par = replace(par, **{name: float(value)})
    return replace(config, simulation=sim, yuma_params=par)


def apply_arrays(
    weights: np.ndarray, stakes: np.ndarray, spec: WhatIfSpec
) -> tuple[np.ndarray, np.ndarray]:
    """The perturbed epoch stacks: weight-row overrides (re-normalized)
    and stake shocks applied to every epoch ``>= from_epoch`` of COPIES
    of the inputs. Index bounds are validated against the actual shape
    here (the spec's own validation cannot know V/M)."""
    E, V, M = weights.shape
    if spec.from_epoch >= E:
        raise WhatIfError(
            f"from_epoch {spec.from_epoch} is beyond the baseline's "
            f"{E} epochs"
        )
    W = np.array(weights, copy=True)
    S = np.array(stakes, copy=True)
    k = spec.from_epoch
    for idx, row in spec.weight_rows:
        if idx >= V:
            raise WhatIfError(
                f"weight_rows validator {idx} out of range [0, {V})"
            )
        arr = np.asarray(row, np.float32)
        if arr.shape != (M,):
            raise WhatIfError(
                f"weight row for validator {idx} has {arr.shape[0]} "
                f"miners, the subnet has {M}"
            )
        total = float(arr.sum())
        if total > 0:
            arr = arr / total
        W[k:, idx, :] = arr
    for idx, factor in spec.stake_scale:
        if idx >= V:
            raise WhatIfError(
                f"stake_scale validator {idx} out of range [0, {V})"
            )
        S[k:, idx] *= np.float32(factor)
    return W, S


def run_whatif(
    cache: StateCache,
    meta: BaselineMeta,
    scenario,
    config,
    spec: WhatIfSpec,
    *,
    use_cache: bool = True,
    record: bool = False,
    device="cuda",
) -> WhatIfResult:
    """Execute one what-if against a cached baseline (module
    docstring). ``use_cache=False`` computes the uncached reference —
    the same piecewise-defined perturbed world simulated end-to-end
    from the zero state — which the cached path must match bitwise.
    ``record=True`` emits the hit/miss telemetry (the caller that owns
    the request — :class:`..replay.ReplayService` — sets it; direct
    library use and reference runs stay telemetry-silent by default so
    bench/test loops don't skew the cache counters). Every segment runs
    on `device` (the card by default), on the baseline's pinned rung."""
    import dataclasses as dc

    from yuma_simulation_tpu_torch.models.config import YumaConfig
    from yuma_simulation_tpu_torch.replay.statecache import torch_dtype
    from yuma_simulation_tpu_torch.simulation.engine import (
        resolve_device,
        simulate,
    )

    dev = resolve_device(device)

    config = config if config is not None else YumaConfig()
    E, V, M = np.shape(scenario.weights)
    if (meta.epochs, meta.validators, meta.miners) != (E, V, M):
        raise WhatIfError(
            f"baseline {meta.key[:16]} is [{meta.epochs}, "
            f"{meta.validators}, {meta.miners}], the scenario is "
            f"[{E}, {V}, {M}]"
        )
    if spec.version != meta.version:
        raise WhatIfError(
            f"spec targets version {spec.version!r}, the baseline is "
            f"{meta.version!r}"
        )
    W2, S2 = apply_arrays(scenario.weights, scenario.stakes, spec)
    config2 = apply_config(config, spec)
    k = spec.from_epoch

    resume = cache.resume_epoch(meta.key, k) if use_cache else 0
    state = None
    if resume > 0:
        try:
            state = cache.load_state(meta.key, resume)
        except Exception:
            # A torn/corrupt state artifact degrades to the full run —
            # a cache can slow a what-if down, never wrong or crash it.
            resume, state = 0, None
    cache_hit = state is not None

    def segment(lo: int, hi: int, cfg, carry, want_state: bool):
        seg = dc.replace(
            scenario,
            weights=W2[lo:hi],
            stakes=S2[lo:hi],
            num_epochs=hi - lo,
        )
        return simulate(
            seg,
            meta.version,
            cfg,
            save_bonds=False,
            save_incentives=True,
            epoch_impl=meta.engine,
            dtype=torch_dtype(meta.dtype),
            initial_state=carry,
            epoch_offset=lo,
            return_state=want_state,
            device=dev,
        )

    parts_div, parts_inc = [], []
    if spec.hparams and k > resume:
        # Piecewise config: baseline config over [resume, k), the
        # perturbed config from k on (arrays before k are untouched by
        # construction, so this mid-segment re-simulates baseline bits).
        mid = segment(resume, k, config, state, True)
        parts_div.append(mid.dividends)
        parts_inc.append(mid.incentives)
        tail = segment(k, E, config2, mid.final_state, False)
        parts_div.append(tail.dividends)
        parts_inc.append(tail.incentives)
    else:
        tail = segment(resume, E, config2, state, False)
        parts_div.append(tail.dividends)
        parts_inc.append(tail.incentives)
    baseline = cache.load_baseline(meta.key)
    dividends = np.concatenate(
        [baseline["dividends"][:resume]] + parts_div
    )
    incentives = np.concatenate(
        [baseline["incentives"][:resume]] + parts_inc
    )

    if record and use_cache:
        if cache_hit:
            cache.record_hit(meta.key, resume_epoch=resume, total_epochs=E)
        else:
            cache.record_miss(
                meta.key,
                total_epochs=E,
                reason=(
                    "no_checkpoint_at_or_before_perturb_epoch"
                    if k < meta.stride
                    else "state_unavailable"
                ),
            )
    return WhatIfResult(
        spec=spec,
        dividends=dividends,
        incentives=incentives,
        dividend_delta=dividends - baseline["dividends"],
        incentive_delta=incentives - baseline["incentives"],
        cache_hit=cache_hit,
        resume_epoch=resume,
        epochs_simulated=E - resume,
        epochs_saved=resume,
        baseline_key=meta.key,
    )

"""Adversarial scenario families with property-gated dividends.

Four parameterized generators — weight copying, collusion cartels,
stake-churn shocks, validator takeover — each built ON the DSL
(:mod:`.dsl` primitives, so every adversary is a serializable
:class:`~.dsl.ScenarioSpec` first and dense arrays second) and each
paired with a property assertion about dividend outcomes:

- a **lag-k weight copier** earns strictly less than the validator it
  copies under liquid alpha (the mechanism the liquid-alpha family
  exists to enforce — PAPER.md);
- a **cartel** whose stake fraction sits below the consensus majority
  (kappa) earns its self-dealt miner no consensus weight beyond the u16
  quantization floor, so the cartel miner's incentive is bounded at
  grid-step level (vs ~1.0/epoch once the cartel holds the majority);
- a **takeover** validator's dividend share rises only after the
  takeover epoch;
- a **churn shock** never breaks the per-epoch dividend normalization.

The assertion helpers (:func:`total_dividends`,
:func:`copier_dividend_gap`, :func:`cartel_miner_incentive`) are plain
functions so the property tests and operator notebooks share one
implementation; they simulate on the card unless given ``device="cpu"``.
All randomness flows from explicit integer seeds through
`np.random.default_rng` — a failing property reproduces from its seed
alone. The port of the JAX package's `foundry/adversarial.py`: the
generators are its numpy code, bitwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from yuma_simulation_tpu_torch.foundry.dsl import (
    BondReset,
    CopyWithLag,
    OneHot,
    Rows,
    ScenarioSpec,
    Stakes,
    Takeover,
    at_epochs,
    compile_spec,
    sequence,
)
from yuma_simulation_tpu_torch.models.config import YumaConfig, YumaParams
from yuma_simulation_tpu_torch.models.variants import YUMA_VERSIONS
from yuma_simulation_tpu_torch.scenarios.base import Scenario

#: Versions where `liquid_alpha=True` changes the bond recurrence (the
#: EMA families and relative bonds; the capacity family ignores it —
#: models/epoch.py gates on `bonds_mode is not CAPACITY`). The copier
#: property quantifies over exactly this set.
LIQUID_ALPHA_VERSIONS = tuple(
    name
    for name, spec in YUMA_VERSIONS.items()
    if spec.bonds_mode.value not in ("capacity",)
)

#: The sub-majority cartel bound: a clipped column can still carry up to
#: a couple of u16 consensus grid steps (1/65535 each — quantization
#: floor, not economics), so "the cartel earns nothing" is asserted as
#: per-epoch incentive <= this. Majority capture sits ~5 orders of
#: magnitude above it (~1.0/epoch).
CARTEL_INCENTIVE_FLOOR_PER_EPOCH = 2.0 / 65535.0


@dataclass(frozen=True)
class AdversarialScenario:
    """One generated adversary: the compiled scenario, its spec, and
    the role indices the property assertions quantify over."""

    scenario: Scenario
    spec: ScenarioSpec
    roles: dict  # role name -> validator (or miner) index


def _segments(rng: np.random.Generator, num_epochs: int, num_segments: int):
    """Random honest-schedule segmentation: `num_segments` epoch spans
    covering [0, num_epochs), each >= 3 epochs so bonds have time to
    move inside every segment."""
    candidates = np.arange(3, num_epochs - 2, 3)
    if num_segments < 1 or len(candidates) < num_segments - 1:
        # Surface the real constraint instead of numpy's opaque
        # "Cannot take a larger sample" — this is a public-surface
        # builder fed by Monte-Carlo draws.
        from yuma_simulation_tpu_torch.foundry.dsl import SpecError

        raise SpecError(
            f"num_epochs={num_epochs} is too short for "
            f"{num_segments} schedule segments (needs num_epochs >= "
            f"{3 * num_segments})"
        )
    cuts = sorted(
        rng.choice(
            candidates, size=num_segments - 1, replace=False
        ).tolist()
    )
    bounds = [0, *cuts, num_epochs]
    return list(zip(bounds[:-1], bounds[1:]))


def weight_copier_scenario(
    seed: int = 0,
    *,
    num_miners: int = 4,
    num_epochs: int = 36,
    lag: int = 1,
    num_segments: int = 4,
    copied_stake: Optional[float] = None,
) -> AdversarialScenario:
    """A lag-`lag` weight copier against an honest shifting consensus.

    Three validators: an honest anchor holding the consensus majority,
    an honest *copied* validator, and a copier reproducing the copied
    validator's rows `lag` epochs late (:class:`~.dsl.CopyWithLag`).
    The copied validator and the copier carry EQUAL stake — any
    dividend gap is pure information lag, not stake weight. The honest
    schedule shifts its one-hot target at `num_segments - 1` random
    epochs (seeded), because a copier only loses when there is
    something to be late about."""
    rng = np.random.default_rng(seed)
    s = (
        float(copied_stake)
        if copied_stake is not None
        else float(rng.uniform(0.15, 0.3))
    )
    anchor = 1.0 - 2.0 * s
    miners = rng.integers(0, num_miners, size=num_segments)
    # Guarantee at least one real shift even if the draw repeats itself.
    for i in range(1, len(miners)):
        if miners[i] == miners[i - 1]:
            miners[i] = (miners[i] + 1) % num_miners
    honest_clauses = [
        at_epochs(
            OneHot((int(m), int(m), int(m))), lo, hi
        )
        for (lo, hi), m in zip(
            _segments(rng, num_epochs, num_segments), miners
        )
    ]
    spec = ScenarioSpec(
        name=f"lag-{lag} weight copier (seed={seed})",
        validators=(
            f"Honest anchor ({anchor:.2f})",
            f"Honest copied ({s:.2f})",
            f"Copier lag-{lag} ({s:.2f})",
        ),
        base_validator=f"Honest copied ({s:.2f})",
        num_miners=num_miners,
        num_epochs=num_epochs,
        stakes=sequence(Stakes((anchor, s, s))),
        weights=sequence(
            *honest_clauses,
            CopyWithLag(dst=2, src=1, lag=lag),
        ),
    )
    return AdversarialScenario(
        scenario=compile_spec(spec),
        spec=spec,
        roles={"anchor": 0, "copied": 1, "copier": 2},
    )


def cartel_scenario(
    seed: int = 0,
    *,
    num_honest: int = 3,
    cartel_size: int = 1,
    cartel_stake_fraction: float = 0.2,
    num_miners: int = 4,
    num_epochs: int = 24,
) -> AdversarialScenario:
    """A collusion cartel self-dealing to its own miner.

    `cartel_size` validators put their entire weight on one cartel
    miner (the last column); honest validators spread seeded-random
    normalized rows over the honest miners only. While the cartel's
    combined stake fraction stays below the consensus majority
    (`kappa`), the stake-weighted median clips the cartel column to
    (at most) the u16 consensus grid floor — the cartel miner's
    per-epoch incentive is bounded by
    :data:`CARTEL_INCENTIVE_FLOOR_PER_EPOCH`, the bound the property
    suite asserts. Push `cartel_stake_fraction` past kappa and the
    same generator produces the majority-capture counterexample
    (~1.0/epoch: the cartel miner takes the whole incentive pool)."""
    rng = np.random.default_rng(seed)
    V = num_honest + cartel_size
    cartel_miner = num_miners - 1
    honest_share = (1.0 - cartel_stake_fraction) / num_honest
    cartel_share = cartel_stake_fraction / cartel_size
    rows = []
    for v in range(num_honest):
        row = rng.random(num_miners - 1) + 0.1
        row = row / row.sum()
        rows.append(tuple(float(x) for x in row) + (0.0,))
    for _ in range(cartel_size):
        rows.append((0.0,) * (num_miners - 1) + (1.0,))
    stakes = (honest_share,) * num_honest + (cartel_share,) * cartel_size
    spec = ScenarioSpec(
        name=(
            f"cartel f={cartel_stake_fraction:.2f} size={cartel_size} "
            f"(seed={seed})"
        ),
        validators=tuple(
            [f"Honest {v} ({honest_share:.2f})" for v in range(num_honest)]
            + [f"Cartel {c} ({cartel_share:.2f})" for c in range(cartel_size)]
        ),
        base_validator=f"Honest 0 ({honest_share:.2f})",
        num_miners=num_miners,
        num_epochs=num_epochs,
        stakes=sequence(Stakes(stakes)),
        weights=sequence(Rows(tuple(rows))),
    )
    return AdversarialScenario(
        scenario=compile_spec(spec),
        spec=spec,
        roles={
            "cartel_validators": tuple(range(num_honest, V)),
            "cartel_miner": cartel_miner,
        },
    )


def stake_churn_scenario(
    seed: int = 0,
    *,
    num_validators: int = 4,
    num_miners: int = 4,
    num_epochs: int = 30,
    shock_epoch: Optional[int] = None,
) -> AdversarialScenario:
    """A stake-churn shock: one validator leaves (stake to zero) and a
    previously-absent one joins at the shock epoch, total stake
    conserved — the join/leave trajectory of the DSL as an adversary
    (churn is how stake-grinding attacks enter). The joiner is the last
    validator; the leaver is seeded-random among the incumbents."""
    rng = np.random.default_rng(seed)
    shock = (
        int(shock_epoch)
        if shock_epoch is not None
        else int(rng.integers(num_epochs // 3, 2 * num_epochs // 3))
    )
    incumbent = rng.random(num_validators - 1) + 0.2
    incumbent = incumbent / incumbent.sum()
    before = tuple(float(x) for x in incumbent) + (0.0,)
    leaver = int(rng.integers(0, num_validators - 1))
    after = list(before)
    after[-1] = after[leaver]  # the joiner inherits the leaver's stake
    after[leaver] = 0.0
    target = tuple(int(m) for m in rng.integers(0, num_miners, num_validators))
    spec = ScenarioSpec(
        name=f"stake churn at e{shock} (seed={seed})",
        validators=tuple(
            f"Vali {v} ({before[v]:.2f}->{after[v]:.2f})"
            for v in range(num_validators)
        ),
        base_validator=f"Vali 0 ({before[0]:.2f}->{after[0]:.2f})",
        num_miners=num_miners,
        num_epochs=num_epochs,
        stakes=sequence(
            Stakes(before),
            at_epochs(Stakes(tuple(after)), shock),
        ),
        weights=sequence(OneHot(target)),
    )
    return AdversarialScenario(
        scenario=compile_spec(spec),
        spec=spec,
        roles={"leaver": leaver, "joiner": num_validators - 1,
               "shock_epoch": shock},
    )


def takeover_scenario(
    seed: int = 0,
    *,
    num_miners: int = 4,
    num_epochs: int = 30,
    takeover_epoch: Optional[int] = None,
    attacker_fraction: float = 0.6,
) -> AdversarialScenario:
    """A validator takeover at epoch k: the attacker runs as a minority
    honest-looking validator, then seizes `attacker_fraction` of the
    subnet stake (:class:`~.dsl.Takeover`) and redirects its weight to
    its own miner. Paired with a bond reset at the takeover epoch (the
    reference's reset machinery exercised from the DSL)."""
    rng = np.random.default_rng(seed)
    k = (
        int(takeover_epoch)
        if takeover_epoch is not None
        else int(rng.integers(num_epochs // 3, 2 * num_epochs // 3))
    )
    honest_miner = int(rng.integers(0, num_miners - 1))
    attacker_miner = num_miners - 1
    spec = ScenarioSpec(
        name=f"takeover at e{k} (seed={seed})",
        validators=("Honest 0 (0.45)", "Honest 1 (0.45)", "Attacker (0.10)"),
        base_validator="Honest 0 (0.45)",
        num_miners=num_miners,
        num_epochs=num_epochs,
        stakes=sequence(Stakes((0.45, 0.45, 0.1))),
        weights=sequence(
            OneHot((honest_miner, honest_miner, honest_miner)),
            at_epochs(
                OneHot((honest_miner, honest_miner, attacker_miner)), k
            ),
        ),
        events=(
            Takeover(validator=2, epoch=k, stake_fraction=attacker_fraction),
            BondReset(index=2, epoch=k),
        ),
    )
    return AdversarialScenario(
        scenario=compile_spec(spec),
        spec=spec,
        roles={
            "attacker": 2,
            "attacker_miner": attacker_miner,
            "takeover_epoch": k,
        },
    )


# ------------------------------------------------------- property helpers


def liquid_config(**overrides) -> YumaConfig:
    """The property suite's config: liquid alpha ON (the mechanism the
    copier property quantifies over), reference defaults otherwise."""
    return YumaConfig(
        yuma_params=YumaParams(liquid_alpha=True, **overrides)
    )


def total_dividends(
    scenario: Scenario,
    yuma_version: str,
    config: Optional[YumaConfig] = None,
    *,
    device="cuda",
) -> np.ndarray:
    """`[V]` summed per-epoch dividends for one scenario/version — the
    quantity every dividend property compares — simulated on `device`."""
    from yuma_simulation_tpu_torch.simulation.engine import simulate

    result = simulate(
        scenario,
        yuma_version,
        config,
        save_bonds=False,
        save_incentives=False,
        device=device,
    )
    return np.asarray(result.dividends).sum(axis=0)


def copier_dividend_gap(
    adversary: AdversarialScenario,
    yuma_version: str,
    config: Optional[YumaConfig] = None,
    *,
    device="cuda",
) -> float:
    """copied_total - copier_total; the copier property is `> 0`."""
    totals = total_dividends(
        adversary.scenario,
        yuma_version,
        config if config is not None else liquid_config(),
        device=device,
    )
    return float(
        totals[adversary.roles["copied"]] - totals[adversary.roles["copier"]]
    )


def cartel_miner_incentive(
    adversary: AdversarialScenario,
    yuma_version: str,
    config: Optional[YumaConfig] = None,
    *,
    device="cuda",
) -> float:
    """Total incentive landing on the cartel's self-dealt miner; the
    sub-majority cartel property is `<= num_epochs *
    CARTEL_INCENTIVE_FLOOR_PER_EPOCH` (the consensus median clips the
    column to at most the u16 grid floor)."""
    from yuma_simulation_tpu_torch.simulation.engine import simulate

    result = simulate(
        adversary.scenario,
        yuma_version,
        config,
        save_bonds=False,
        save_incentives=True,
        device=device,
    )
    incentives = np.asarray(result.incentives)
    return float(incentives[:, adversary.roles["cartel_miner"]].sum())

"""The 14 built-in scenario cases, as data generators.

Behavior-parity ports of the hand-written weight schedules in reference
cases.py:51-597 (each case's docstring cites its source lines). Every case
is 3 validators x 2 miners x 40 epochs unless overridden; the epoch
schedules are expressed as range rules instead of per-epoch if-chains, and
materialize once into dense arrays.
"""

from __future__ import annotations

from yuma_simulation_tpu_torch.scenarios.base import (
    Scenario,
    assignment_weights,
    constant_stakes,
    register_case,
    row_weights,
)

_DEFAULT_STAKES = [0.8, 0.1, 0.1]
_END = 10_000  # open-ended range sentinel, clipped to num_epochs


@register_case("Case 1")
def case_1(num_epochs: int = 40, **kw) -> Scenario:
    """Kappa moves first (reference cases.py:51-84)."""
    return Scenario(
        name="Case 1 - kappa moves first",
        validators=[
            "Big vali. (0.8)",
            "Small lazy vali. (0.1)",
            "Small lazier vali. (0.1)",
        ],
        base_validator="Big vali. (0.8)",
        num_epochs=num_epochs,
        weights=assignment_weights(
            num_epochs,
            3,
            2,
            [
                (range(0, 1), [0, 0, 0]),
                (range(1, 2), [1, 0, 0]),
                (range(2, 3), [1, 1, 0]),
                (range(3, _END), [1, 1, 1]),
            ],
        ),
        stakes=constant_stakes(num_epochs, _DEFAULT_STAKES),
        **kw,
    )


@register_case("Case 2")
def case_2(num_epochs: int = 40, **kw) -> Scenario:
    """Kappa moves second (reference cases.py:87-120)."""
    return Scenario(
        name="Case 2 - kappa moves second",
        validators=[
            "Big vali. (0.8)",
            "Small eager vali. (0.1)",
            "Small lazy vali. (0.1)",
        ],
        base_validator="Small eager vali. (0.1)",
        num_epochs=num_epochs,
        weights=assignment_weights(
            num_epochs,
            3,
            2,
            [
                (range(0, 1), [0, 0, 0]),
                (range(1, 2), [0, 1, 0]),
                (range(2, 3), [1, 1, 0]),
                (range(3, _END), [1, 1, 1]),
            ],
        ),
        stakes=constant_stakes(num_epochs, _DEFAULT_STAKES),
        **kw,
    )


@register_case("Case 3")
def case_3(num_epochs: int = 40, **kw) -> Scenario:
    """Kappa moves third (reference cases.py:123-156)."""
    return Scenario(
        name="Case 3 - kappa moves third",
        validators=[
            "Big vali. (0.8)",
            "Small eager vali. (0.1)",
            "Small lazy vali. (0.1)",
        ],
        base_validator="Small eager vali. (0.1)",
        num_epochs=num_epochs,
        weights=assignment_weights(
            num_epochs,
            3,
            2,
            [
                (range(0, 1), [0, 0, 0]),
                (range(1, 2), [0, 1, 0]),
                (range(2, 3), [0, 1, 1]),
                (range(3, _END), [1, 1, 1]),
            ],
        ),
        stakes=constant_stakes(num_epochs, _DEFAULT_STAKES),
        **kw,
    )


@register_case("Case 4")
def case_4(num_epochs: int = 40, **kw) -> Scenario:
    """All validators switch (reference cases.py:159-188)."""
    return Scenario(
        name="Case 4 - all validators switch",
        validators=[
            "Big vali. (0.8)",
            "Small vali. (0.1)",
            "Small vali 2. (0.1)",
        ],
        base_validator="Big vali. (0.8)",
        num_epochs=num_epochs,
        weights=assignment_weights(
            num_epochs,
            3,
            2,
            [
                (range(0, 1), [0, 0, 0]),
                (range(1, _END), [1, 1, 1]),
            ],
        ),
        stakes=constant_stakes(num_epochs, _DEFAULT_STAKES),
        **kw,
    )


@register_case("Case 5")
def case_5(num_epochs: int = 40, **kw) -> Scenario:
    """Kappa moves second, then third (reference cases.py:191-238)."""
    return Scenario(
        name="Case 5 - kappa moves second, then third",
        validators=[
            "Big vali. (0.8)",
            "Small eager-eager vali. (0.1)",
            "Small eager-lazy vali. (0.1)",
        ],
        base_validator="Small eager-eager vali. (0.1)",
        num_epochs=num_epochs,
        reset_bonds=True,
        reset_bonds_index=1,
        reset_bonds_epoch=20,
        weights=assignment_weights(
            num_epochs,
            3,
            2,
            [
                (range(0, 1), [0, 0, 0]),
                (range(1, 2), [0, 1, 1]),
                (range(2, 21), [1, 1, 1]),
                (range(21, 22), [1, 0, 1]),
                (range(22, 23), [1, 0, 0]),
                (range(23, _END), [0, 0, 0]),
            ],
        ),
        stakes=constant_stakes(num_epochs, _DEFAULT_STAKES),
        **kw,
    )


@register_case("Case 6")
def case_6(num_epochs: int = 40, **kw) -> Scenario:
    """Kappa moves second, then all switch back (reference cases.py:241-281)."""
    return Scenario(
        name="Case 6 - kappa moves second, then all validators switch",
        validators=[
            "Big vali. (0.8)",
            "Small eager vali. (0.1)",
            "Small lazy vali. (0.1)",
        ],
        base_validator="Small eager vali. (0.1)",
        num_epochs=num_epochs,
        reset_bonds=True,
        reset_bonds_index=0,
        reset_bonds_epoch=21,
        weights=assignment_weights(
            num_epochs,
            3,
            2,
            [
                (range(0, 1), [0, 0, 0]),
                (range(1, 2), [0, 1, 0]),
                (range(2, 3), [1, 1, 0]),
                (range(3, 21), [1, 1, 1]),
                (range(21, _END), [0, 0, 0]),
            ],
        ),
        stakes=constant_stakes(num_epochs, _DEFAULT_STAKES),
        **kw,
    )


@register_case("Case 7")
def case_7(num_epochs: int = 40, **kw) -> Scenario:
    """Big vali moves late, then all but one small vali move late
    (reference cases.py:284-327; note epoch 21 follows the code, not its
    comments: A->S2, B->S2, C->S1)."""
    return Scenario(
        name="Case 7 - big vali moves late, then all but one small vali moves late",
        validators=[
            "Big vali. (0.8)",
            "Small eager-lazy vali. (0.1)",
            "Small eager-eager vali. (0.1)",
        ],
        base_validator="Small eager-eager vali. (0.1)",
        num_epochs=num_epochs,
        reset_bonds=True,
        reset_bonds_index=0,
        reset_bonds_epoch=21,
        weights=assignment_weights(
            num_epochs,
            3,
            2,
            [
                (range(0, 1), [0, 0, 0]),
                (range(1, 2), [0, 1, 1]),
                (range(2, 21), [1, 1, 1]),
                (range(21, 22), [1, 1, 0]),
                (range(22, _END), [0, 0, 0]),
            ],
        ),
        stakes=constant_stakes(num_epochs, _DEFAULT_STAKES),
        **kw,
    )


@register_case("Case 8")
def case_8(num_epochs: int = 40, **kw) -> Scenario:
    """Big vali moves late, then late again (reference cases.py:329-370)."""
    return Scenario(
        name="Case 8 - big vali moves late, then late",
        validators=[
            "Big dishonest lazy vali. (0.8)",
            "Small eager-eager vali. (0.1)",
            "Small eager-eager vali 2. (0.1)",
        ],
        base_validator="Small eager-eager vali. (0.1)",
        num_epochs=num_epochs,
        reset_bonds=True,
        reset_bonds_index=1,
        reset_bonds_epoch=20,
        weights=assignment_weights(
            num_epochs,
            3,
            2,
            [
                (range(0, 1), [0, 0, 0]),
                (range(1, 2), [0, 1, 1]),
                (range(2, 21), [1, 1, 1]),
                (range(21, 22), [1, 0, 0]),
                (range(22, _END), [0, 0, 0]),
            ],
        ),
        stakes=constant_stakes(num_epochs, _DEFAULT_STAKES),
        **kw,
    )


@register_case("Case 9")
def case_9(num_epochs: int = 40, **kw) -> Scenario:
    """Small validators merge at epoch 6 (reference cases.py:372-403)."""
    stakes = constant_stakes(num_epochs, _DEFAULT_STAKES)
    stakes[6:] = [0.8, 0.2, 0.0]
    return Scenario(
        name="Case 9 - small validators merged in e5",
        validators=[
            "Big vali. (0.8)",
            "Small vali. (0.1/0.2)",
            "Small vali 2. (0.1/0.0)",
        ],
        base_validator="Big vali. (0.8)",
        num_epochs=num_epochs,
        weights=assignment_weights(
            num_epochs, 3, 2, [(range(0, _END), [1, 1, 1])]
        ),
        stakes=stakes,
        **kw,
    )


@register_case("Case 10")
def case_10(num_epochs: int = 40, **kw) -> Scenario:
    """Kappa delayed (reference cases.py:406-439)."""
    return Scenario(
        name="Case 10 - kappa delayed",
        validators=[
            "Big delayed vali. (0.8)",
            "Small eager vali. (0.1)",
            "Small lazy vali. (0.1)",
        ],
        base_validator="Small eager vali. (0.1)",
        num_epochs=num_epochs,
        weights=assignment_weights(
            num_epochs,
            3,
            2,
            [
                (range(0, 1), [0, 0, 0]),
                (range(1, 10), [0, 1, 0]),
                (range(10, 11), [1, 1, 0]),
                (range(11, _END), [1, 1, 1]),
            ],
        ),
        stakes=constant_stakes(num_epochs, _DEFAULT_STAKES),
        plot_incentives=True,
        **kw,
    )


@register_case("Case 11")
def case_11(num_epochs: int = 40, **kw) -> Scenario:
    """Clipping demo with two equal big validators (reference cases.py:442-486)."""
    return Scenario(
        name="Case 11 - clipping demo",
        validators=[
            "Big vali. 1 (0.49)",
            "Big vali. 2 (0.49)",
            "Small vali. (0.02)",
        ],
        base_validator="Big vali. 1 (0.49)",
        num_epochs=num_epochs,
        reset_bonds=True,
        reset_bonds_index=1,
        reset_bonds_epoch=20,
        weights=row_weights(
            num_epochs,
            [
                (range(0, 20), [[0.3, 0.7], [0.6, 0.4], [0.61, 0.39]]),
                (range(20, _END), [[0.3, 0.7], [0.6, 0.4], [0.3, 0.61]]),
            ],
        ),
        stakes=constant_stakes(num_epochs, [0.49, 0.49, 0.02]),
        plot_incentives=True,
        **kw,
    )


@register_case("Case 12")
def case_12(num_epochs: int = 40, **kw) -> Scenario:
    """All switch; a small dishonest vali keeps minimal alt weight
    (reference cases.py:489-530)."""
    return Scenario(
        name=(
            "Case 12 - all validators switch, but small validator/s support "
            "alt miner with minimal weight"
        ),
        validators=[
            "Big vali. (0.8)",
            "Small dishonest vali. (0.1)",
            "Small vali. (0.1)",
        ],
        base_validator="Big vali. (0.8)",
        num_epochs=num_epochs,
        reset_bonds=True,
        reset_bonds_index=1,
        reset_bonds_epoch=20,
        weights=row_weights(
            num_epochs,
            [
                (range(0, 1), [[1.0, 0.0], [0.999, 0.001], [1.0, 0.0]]),
                (range(1, 21), [[0.0, 1.0], [0.001, 0.999], [0.0, 1.0]]),
                (range(21, _END), [[1.0, 0.0], [0.999, 0.001], [1.0, 0.0]]),
            ],
        ),
        stakes=constant_stakes(num_epochs, _DEFAULT_STAKES),
        **kw,
    )


@register_case("Case 13")
def case_13(num_epochs: int = 40, **kw) -> Scenario:
    """Big vali on server 2, small vali(s) split to server 1
    (reference cases.py:533-565)."""
    return Scenario(
        name="Case 13 - Big vali supports server 2, small validator/s support server 1",
        validators=[
            "Big vali. (0.8)",
            "Small vali. (0.1)",
            "Small vali 2. (0.1)",
        ],
        base_validator="Big vali. (0.8)",
        num_epochs=num_epochs,
        reset_bonds=True,
        reset_bonds_index=0,
        reset_bonds_epoch=20,
        weights=row_weights(
            num_epochs,
            [
                (range(0, 21), [[0.0, 1.0], [0.5, 0.5], [0.0, 1.0]]),
                (range(21, _END), [[0.0, 1.0], [0.5, 0.5], [0.5, 0.5]]),
            ],
        ),
        stakes=constant_stakes(num_epochs, _DEFAULT_STAKES),
        **kw,
    )


@register_case("Case 14")
def case_14(num_epochs: int = 40, **kw) -> Scenario:
    """One validator defects to server 2 for a single epoch
    (reference cases.py:568-597)."""
    return Scenario(
        name=(
            "Case 14 - All validators support Server 1, one of them switches "
            "to Server 2 for one epoch"
        ),
        validators=["Vali. 1 (0.33)", "Vali. 2 (0.33)", "Vali. 3 (0.34)"],
        base_validator="Vali. 1 (0.33)",
        num_epochs=num_epochs,
        weights=assignment_weights(
            num_epochs,
            3,
            2,
            [
                (range(0, 20), [0, 0, 0]),
                (range(20, 21), [0, 0, 1]),
                (range(21, _END), [0, 0, 0]),
            ],
        ),
        stakes=constant_stakes(num_epochs, [0.33, 0.33, 0.34]),
        **kw,
    )

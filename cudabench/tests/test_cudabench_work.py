"""Each roofline metric's bytes and operations, against a count by hand
at the cells' shapes."""

import math

from cudabench.core import cost, registry
from cudabench.reference import bonds, yuma

MC = {"scenarios": 256, "epochs": 64, "validators": 256, "miners": 4096}
HORIZON = {"scenarios": 1, "epochs": 10_000, "validators": 256, "miners": 4096}
VM = 256 * 4096


def test_epoch_operations_per_cell():
    # normalize 2, bisection 17 x 2, clip 1, rank 2, dividend 2
    assert yuma.EPOCH_OPS_PER_CELL == 41
    # Yuma 1: blend 3, stake product 1, column sum 1, divide 1; EMA 3
    assert bonds.model("ema").OPS_PER_CELL == 9
    # Yuma 4: decay, 1 - B, clamp, purchase multiply and min, add, clamp
    assert bonds.model("relative").OPS_PER_CELL == 7


def test_k3_work():
    k3 = registry.metric("k3_roofline_pct")
    nbytes, ops = k3.work(MC, "ema")
    weights = 256 * 64 * VM * 4
    stakes_and_dividends = 2 * 256 * 64 * 256 * 4
    carries = 2 * (256 * VM + 256 * 4096) * 4
    assert nbytes == weights + stakes_and_dividends + carries == 70_908_903_424
    assert ops == 256 * 64 * VM * 50
    least, by = cost.bound_s(nbytes, ops)
    assert by == "bytes" and math.isclose(least, 70_908_903_424 / 3.35e12)


def test_k7_work():
    k7 = registry.metric("k7_roofline_pct")
    nbytes, ops = k7.work(MC)
    assert nbytes == 256 * 64 * VM * 4 + VM * 4 + 256 * 8
    p = math.sqrt(math.sqrt(2) - 1)  # P(u^2 < sqrt(2) - 1), u uniform on (-1, 1)
    assert math.isclose(p, 0.6435942529055827)
    assert math.isclose(ops, 256 * 64 * VM * (99 + 19 * p + 31 * (1 - p)))
    assert cost.bound_s(nbytes, ops)[1] == "operations"


def test_k5_work():
    k5 = registry.metric("k5_roofline_pct")
    nbytes, ops = k5.work(HORIZON, "ema")
    assert nbytes == (VM + 256 + 10_000) * 4 + (VM + 256) * 4 == 8_430_656
    assert ops == 10_000 * VM * 51
    least, by = cost.bound_s(nbytes, ops)
    assert by == "operations" and math.isclose(least * 1e6 / 10_000, 0.7981697910447762)

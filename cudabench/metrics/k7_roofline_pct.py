"""`k7_roofline_pct`: K7, the Monte-Carlo weight kernel (`csrc/mc_weights.cu`,
`k_mc_weights`), as a share of its roofline: the least time the chip needs
for the traced calls' draws, over K7's device time.

The work of one call's draws, `B * E * V * M` weights: each written once
(float32), the base `[V, M]` read once; each element costs the threefry
block, the uniform, the normal's `erf_inv` and the weight (99 operations,
as counted in `chip_smoke.py` at commit b289c29), plus `log1p`'s branch:
19 operations where `u * u < sqrt(2) - 1`, 31 elsewhere. `u` is uniform on
(-1, 1), so the first branch is taken with probability
`sqrt(sqrt(2) - 1)`: the expected count is used.
"""

import math

from cudabench.core import cost

K7 = "k_mc_weights"
OPS_COMMON, OPS_LOG1P_SMALL, OPS_LOG1P_LARGE = 99, 19, 31
P_SMALL = math.sqrt(math.sqrt(2.0) - 1.0)
OPS_PER_WEIGHT = OPS_COMMON + P_SMALL * OPS_LOG1P_SMALL + (1 - P_SMALL) * OPS_LOG1P_LARGE


def work(shape: dict):
    """`(bytes, operations)` of one call's draws."""
    B, E, V, M = (shape[k] for k in ("scenarios", "epochs", "validators", "miners"))
    weights = B * E * V * M
    return 4 * weights + 4 * V * M + 8 * B, weights * OPS_PER_WEIGHT


def read(window):
    trace = window.trace
    device_s = trace.device_s({K7}) if trace is not None else 0.0
    if device_s <= 0:
        return None
    least, _ = cost.bound_s(*work(window.shape))
    return 100.0 * least * trace.calls / device_s

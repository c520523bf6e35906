"""`k5_roofline_pct`: K5, the scaled scan (`csrc/ema_scan.cu` over the phase
kernels of `csrc/scan_phases.cuh`), as a share of its roofline: the least
time the chip needs for the traced calls' scans, over the device time of
every `k_*` kernel.

The work of one call's scan of `E` epochs of `W * scale[e]` at `[V, M]`,
whatever implements it: it reads the weights `[V, M]`, stakes `[V]` and
scales `[E]` once and writes the final bonds `[V, M]` and the total
dividends `[V]`, all float32; each `[V, M]` cell of each epoch costs the
scale's multiply, the epoch's shared operations
(`reference/yuma.py::EPOCH_OPS_PER_CELL`) and its bonds model's
(`reference/bonds/<model>.py::OPS_PER_CELL`).
"""

from cudabench.core import cost
from cudabench.reference import bonds, yuma


def work(shape: dict, bonds_model: str):
    """`(bytes, operations)` of one call's scan."""
    B, E, V, M = (shape[k] for k in ("scenarios", "epochs", "validators", "miners"))
    nbytes = 4 * B * (2 * V * M + 2 * V + E)
    per_cell = 1 + yuma.EPOCH_OPS_PER_CELL + bonds.model(bonds_model).OPS_PER_CELL
    return nbytes, B * E * V * M * per_cell


def read(window):
    trace = window.trace
    if trace is None:
        return None
    device_s = trace.device_s({op.short_name for op in trace.kernels()
                               if op.short_name.startswith("k_")})
    if device_s <= 0:
        return None
    least, _ = cost.bound_s(*work(window.shape, window.config["bonds_model"]))
    return 100.0 * least * trace.calls / device_s

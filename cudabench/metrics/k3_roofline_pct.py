"""`k3_roofline_pct`: K3, the varying scan (`csrc/case_scan.cu` over the
phase kernels of `csrc/scan_phases.cuh`), as a share of its roofline: the
least time the chip needs for the traced calls' scans, over the device
time of every `k_*` kernel but K7's `k_mc_weights`.

The work of one call's scan of `B` scenarios over `E` epochs at `[V, M]`,
whatever implements it: it reads the weights `[B, E, V, M]` and stakes
`[B, E, V]` once, reads and writes the bond `[B, V, M]` and consensus
`[B, M]` carries once, and writes the dividends `[B, E, V]`, all float32;
each `[V, M]` cell of each epoch costs the epoch's shared operations
(`reference/yuma.py::EPOCH_OPS_PER_CELL`) and its bonds model's
(`reference/bonds/<model>.py::OPS_PER_CELL`).
"""

from cudabench.core import cost
from cudabench.reference import bonds, yuma

#: K7's kernel: every other phase kernel of a Monte-Carlo call is K3's.
K7 = "k_mc_weights"


def work(shape: dict, bonds_model: str):
    """`(bytes, operations)` of one call's scan."""
    B, E, V, M = (shape[k] for k in ("scenarios", "epochs", "validators", "miners"))
    nbytes = 4 * (B * E * V * M + 2 * B * E * V + 2 * B * V * M + 2 * B * M)
    per_cell = yuma.EPOCH_OPS_PER_CELL + bonds.model(bonds_model).OPS_PER_CELL
    return nbytes, B * E * V * M * per_cell


def read(window):
    trace = window.trace
    if trace is None:
        return None
    names = {op.short_name for op in trace.kernels() if op.short_name.startswith("k_")} - {K7}
    device_s = trace.device_s(names)
    if device_s <= 0:
        return None
    least, _ = cost.bound_s(*work(window.shape, window.config["bonds_model"]))
    return 100.0 * least * trace.calls / device_s

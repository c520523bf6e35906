"""The chip's published peaks and the roofline bound.

Copied from `yuma_simulation_tpu_torch/telemetry/cost.py` at commit
b289c29 (`PEAK_*`, `bound_ms`), in seconds here. The peaks are NVIDIA's
data sheet for the H100 SXM part at 700 W: HBM3 bandwidth, the float32
rate outside the tensor cores (against which the int32 vector operations
are counted too: the data sheet gives no int32 rate), and the dense int8
tensor-core rate. Each per-layer metric keeps its own work formula, from
the cell's shapes, in its own file.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_INT8_OPS_PER_S = 1979e12


def bound_s(nbytes: float, ops: float, int8_ops: float = 0.0) -> tuple[float, str]:
    """The least time the chip needs: max(bytes / HBM rate, operations /
    their peak rate), in seconds, and which of the two binds."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S + int8_ops / PEAK_INT8_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

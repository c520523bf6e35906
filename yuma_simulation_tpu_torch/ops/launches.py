"""Launch counts of the CUDA kernels.

Each kernel wrapper adds one to its counter where it launches its kernel,
and nowhere else (the plain PyTorch versions never count), so a run can
show which kernels its path went through: zero the counts, run, read them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class LaunchCounter:
    """The number of times one kernel wrapper launched its kernel."""

    name: str
    count: int = 0

    def add(self, n: int = 1) -> None:
        self.count += n


#: One counter per kernel, by name.
COUNTERS: dict[str, LaunchCounter] = {
    name: LaunchCounter(name)
    for name in (
        "consensus_bisect", "case_scan", "varying_scan", "support_mma", "ema_scan",
        "ema_epoch", "mc_weights",
    )
}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.count = 0


def launch_counts() -> dict[str, int]:
    return {name: c.count for name, c in COUNTERS.items()}

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


#: The file a serving process leaves in its flight bundle's directory at a
#: graceful close: its pid and its launch counts then, so the counts of a
#: worker process can be read after it exits.
LAUNCHES_NAME = "launches.json"


def publish_launch_counts(directory) -> None:
    """Write this process's pid and launch counts to `directory`'s
    :data:`LAUNCHES_NAME` (atomically)."""
    import json
    import os
    import pathlib

    from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

    path = pathlib.Path(directory)
    path.mkdir(parents=True, exist_ok=True)
    record = {"pid": os.getpid(), "launches": launch_counts()}
    publish_atomic(path / LAUNCHES_NAME, json.dumps(record, sort_keys=True).encode())


def read_launch_counts(directory):
    """The record :func:`publish_launch_counts` left in `directory`, or
    None when there is none."""
    import json
    import pathlib

    path = pathlib.Path(directory) / LAUNCHES_NAME
    if not path.exists():
        return None
    return json.loads(path.read_text())

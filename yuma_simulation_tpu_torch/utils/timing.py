"""The one benchmark-timing discipline (the JAX package's `utils/timing.py`).

`time_best` warms (builds and runs) once, grows the work count `n`
iteratively until a single timed run lasts at least `target_seconds`
(per-epoch cost drops as `n` grows, so one extrapolation is not enough),
then takes the best of `reps` timed runs. A CUDA launch returns before the
card finishes, so every timed run ends in `torch.cuda.synchronize()` (where
the JAX package forces a host fetch with `np.asarray`).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

DEFAULT_TARGET_SECONDS = 2.0
DEFAULT_REPS = 4


def _finish(out) -> None:
    """Wait for everything `run` queued: the card's work, or nothing on the
    CPU (PyTorch's CPU operations are synchronous)."""
    del out
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_best(
    run: Callable[[int], object],
    n: int,
    *,
    max_n: int = 1 << 20,
    granularity: int = 1,
    target_seconds: float = DEFAULT_TARGET_SECONDS,
    reps: int = DEFAULT_REPS,
) -> tuple[float, int, list[float], float]:
    """Time `run(n)` and return `(rate, n_timed, times_s, cv)`:
    `rate = n / best`, and `cv` the coefficient of variation (population
    standard deviation / mean) across the timed repeats (0.0 when
    `reps == 1`).

    `granularity` rounds grown counts down to a multiple the runner can
    execute (whole passes of a fixed-length inner loop, a shard count), so
    `n / best` never over-counts."""
    if max_n < granularity:
        raise ValueError(
            f"max_n={max_n} < granularity={granularity}: no timeable "
            "work count satisfies both the divisibility contract and "
            "the cap"
        )

    def on_grid(x: int) -> int:
        # The largest grid multiple <= max_n caps the count.
        cap = (max_n // granularity) * granularity
        return min(cap, max(granularity, x // granularity * granularity))

    def once() -> float:
        t0 = time.perf_counter()
        _finish(run(n))
        return time.perf_counter() - t0

    n = on_grid(n)
    _finish(run(n))  # build + warm up
    dt = max(once(), 1e-9)  # coarse timers can report 0.0
    while dt < target_seconds:
        grown = on_grid(min(max_n, int(n * max(2.0, 1.25 * target_seconds / dt))))
        if grown <= n:
            # max_n (or its granularity floor) reached: accept the shorter run.
            break
        n = grown
        _finish(run(n))  # warm up at the timed length
        dt = max(once(), 1e-9)
    times = [once() for _ in range(reps)]
    mean = sum(times) / len(times)
    cv = float(np.std(times) / mean) if len(times) > 1 and mean > 0 else 0.0
    return n / min(times), n, [round(t, 3) for t in times], round(cv, 4)

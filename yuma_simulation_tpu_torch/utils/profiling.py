"""Profiling hooks: `torch.profiler` traces and the epoch-rate timer.

The counterpart of the JAX package's `utils/profiling.py`: :class:`timed`
and :func:`profile_trace`, with :func:`trace_range_windows` to read a
named range and the kernels inside it back from the trace. The
recompilation sentinel and the compilation cache wait for the
kernel-build cache (ROADMAP queue A, slice 5).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

import torch

logger = logging.getLogger(__name__)

#: The Chrome trace :func:`profile_trace` writes into its directory.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """Wrap a region in a `torch.profiler` trace of the host and, where
    CUDA is present, the card; on exit the Chrome trace is written to
    ``<log_dir>/trace.json`` (open it in Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` / ``events()`` can be
    read after the block. A no-op yielding None when `log_dir` is None, so
    a CLI flag can be threaded straight through.

    The "trace written" line is logged in a ``finally``: the trace of a
    failing region is the one that explains the failure."""
    if log_dir is None:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(log_dir, TRACE_FILE)
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
        prof.export_chrome_trace(path)
    finally:
        logger.info("profiler trace written to %s", path)


def trace_range_windows(trace_path: str, range_name: str,
                        kernel_pattern: str = r"\bk_[a-z_]+") -> dict:
    """From a Chrome trace of :func:`profile_trace`: the windows
    ``(start, end)`` in microseconds of the `range_name` ranges on the card
    (``"gpu"``, kineto's ``gpu_user_annotation``) and on the host
    (``"cpu"``), and under ``"kernels"`` each kernel whose name matches
    `kernel_pattern` as ``(name, window on the card, window of its launch
    on the host or None)``, joined by correlation id."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    gpu, cpu, kernels, launches = [], [], [], {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        window = (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)))
        corr = (ev.get("args") or {}).get("correlation")
        if name == range_name:
            (gpu if cat == "gpu_user_annotation" else cpu).append(window)
        elif cat == "kernel" and re.search(kernel_pattern, name):
            kernels.append((name, window, corr))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = window
    return dict(gpu=gpu, cpu=cpu, kernels=[
        (name, window, launches.get(corr)) for name, window, corr in kernels
    ])


def within(window, windows, slack_us: float = 1.0) -> bool:
    """True when `window` lies inside one of `windows`, give or take
    `slack_us` (the trace's timestamps are rounded)."""
    return window is not None and any(
        a - slack_us <= window[0] and window[1] <= b + slack_us for a, b in windows
    )


@dataclass
class timed:
    """Context manager timing a block; with `epochs` it is the epoch-rate
    reporting path: on clean exit the measurement goes through
    :func:`..telemetry.metrics.record_epoch_rate` (the ``epochs_total``
    counter and the ``epochs_per_sec`` gauge) and emits exactly one
    ``event=epoch_rate`` record, run/span-stamped like every structured
    record. Without `epochs` it is a plain labelled timer.

    >>> with timed("scan", epochs=10_000) as t:
    ...     run()
    >>> t.seconds, t.epochs_per_sec
    """

    label: str = "block"
    epochs: Optional[int] = None
    seconds: float = field(default=0.0, init=False)

    def __enter__(self) -> "timed":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        if exc[0] is not None:
            return  # a failing block reports its failure, not a rate
        if self.epochs is not None and self.seconds > 0:
            # Imported here: the metrics module imports this package.
            from yuma_simulation_tpu_torch.telemetry.metrics import record_epoch_rate

            record_epoch_rate(self.label, epochs=self.epochs, seconds=self.seconds, logger_=logger)
        else:
            logger.info("%s: %.3fs", self.label, self.seconds)

    @property
    def epochs_per_sec(self) -> Optional[float]:
        if self.epochs is None or self.seconds == 0:
            return None
        return self.epochs / self.seconds

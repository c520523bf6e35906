"""Profiling hooks: `torch.profiler` traces and the epoch-rate timer.

The counterpart of the JAX package's `utils/profiling.py`: :class:`timed`
and :func:`profile_trace`, with :func:`trace_range_windows` to read a
named range and the kernels inside it back from the trace;
:class:`RecompilationSentinel`, which budgets the `nvcc` builds of a region
(the port's compiles: its kernels are built once per program and
environment, never per shape); and :func:`enable_compilation_cache`,
which points the build directory.
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
    failing region is the one that explains the failure.

    The region holds the process's profiler latch
    (:func:`..telemetry.ops.hold_profiler`): it raises
    :class:`..telemetry.ops.ProfileBusyError` while an ops-plane
    :class:`..telemetry.ops.ProfileSession` window is open, and such a
    window cannot open while the region runs."""
    if log_dir is None:
        yield None
        return
    from yuma_simulation_tpu_torch.telemetry.ops import hold_profiler

    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(log_dir, TRACE_FILE)
    with hold_profiler({"mode": "profile_trace", "artifact": log_dir}):
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


def enable_compilation_cache(cache_dir: Optional[str] = None) -> str:
    """Point the kernels' build directory (the library cache,
    `ops/_build.py`) at `cache_dir`, created if absent; None keeps the
    current one. Returns the directory in use. The JAX package's persistent
    XLA cache has no counterpart: the libraries are the cache."""
    from yuma_simulation_tpu_torch.ops import _build

    if cache_dir is None:
        return str(_build.build_dir())
    return str(_build.configure_executable_cache(cache_dir).root)


class RecompilationBudgetExceeded(RuntimeError):
    """A :class:`RecompilationSentinel` region built more kernel libraries
    than its declared budget allows."""


class RecompilationSentinel:
    """Fail loudly when a region compiles beyond a declared budget.

    The port compiles only when a kernel library is missing from the cache
    (`ops/_build.py`): an `nvcc` build, counted by the process's cache
    statistics. A region's builds count against `budget` (0: the region
    must not compile); libraries loaded from the cache cost nothing and
    are reported on ``aot_hits``, as the JAX package reports its
    executable-cache loads. Unlike the JAX package's, it tracks no jitted
    functions: nothing of the port is traced.

    Usage::

        with RecompilationSentinel(budget=0):
            simulate(...)   # a build here raises on exit

    The check runs on a clean exit only: an exception inside the region
    propagates untouched."""

    def __init__(self, *, budget: int = 0, label: str = "region"):
        self.budget = budget
        self.label = label
        self.new_entries: Optional[int] = None
        self.aot_hits: int = 0
        self.aot_builds: int = 0

    @staticmethod
    def _snapshot() -> tuple[int, int]:
        from yuma_simulation_tpu_torch.ops._build import process_stats

        stats = process_stats()
        return stats.hits, stats.builds

    def __enter__(self) -> "RecompilationSentinel":
        self._before = self._snapshot()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            return  # don't mask the region's own failure
        wall_seconds = time.perf_counter() - self._t0
        hits, builds = self._snapshot()
        self.aot_hits = max(0, hits - self._before[0])
        self.aot_builds = max(0, builds - self._before[1])
        self.new_entries = self.aot_builds
        if self.new_entries:
            # Every build a region observes lands on the `recompiles`
            # counter (over-budget ones too) and its wall time on the
            # `compile_seconds` histogram and SLO sketch: an upper bound on
            # the compile cost, since the region may also have run.
            from yuma_simulation_tpu_torch.telemetry.metrics import get_registry
            from yuma_simulation_tpu_torch.telemetry.slo import observe_duration

            registry = get_registry()
            registry.counter("recompiles", help="new jit-cache entries observed").inc(
                self.new_entries
            )
            registry.histogram(
                "compile_seconds",
                help="wall seconds of sentinel regions that added jit-cache entries "
                "(compile-time upper bound)",
            ).observe(wall_seconds)
            observe_duration("compile_seconds", wall_seconds)
        if self.new_entries > self.budget:
            raise RecompilationBudgetExceeded(
                f"{self.label}: {self.new_entries} kernel librar"
                f"{'y' if self.new_entries == 1 else 'ies'} built, over the "
                f"compile budget of {self.budget} (cache hits: {self.aot_hits}). "
                "A build in this region means a library was missing from the "
                "cache or stale under this toolkit, runtime or card."
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

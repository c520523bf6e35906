"""Device telemetry: the card's memory, sampled between dispatches.

The counterpart of the JAX package's `telemetry/device.py`:
:func:`sample_device_telemetry` reads the caching allocator's statistics
(`torch.cuda.memory_stats`) of every visible card, and
:func:`record_device_telemetry` folds the sample into the metrics registry.
Without CUDA the sample is the JAX package's CPU one: no memory figures
(None), and the gauges are left untouched. :class:`CompileTracker` counts
the kernel builds (`ops/_build.py`) onto the ``recompiles`` counter.
"""

from __future__ import annotations

from typing import Optional

import torch

from yuma_simulation_tpu_torch.telemetry.metrics import MetricsRegistry, get_registry


def sample_device_telemetry() -> dict:
    """One host-side snapshot of the devices' memory. A flat dict:
    ``backend`` ("gpu" with CUDA, else "cpu": the JAX package's platform
    names), ``num_devices``, ``device_peak_bytes`` (the largest
    `peak_bytes_in_use`-style figure over the cards: the allocator's
    ``allocated_bytes.all.peak``), ``device_bytes_in_use`` (the sum of
    ``allocated_bytes.all.current``) and ``live_buffers`` (the sum of
    ``active.all.current``, the live allocations); the three memory
    figures are None on the CPU."""
    if not torch.cuda.is_available():
        return {
            "backend": "cpu",
            "num_devices": 1,
            "device_peak_bytes": None,
            "device_bytes_in_use": None,
            "live_buffers": None,
        }
    n = torch.cuda.device_count()
    stats = [torch.cuda.memory_stats(i) for i in range(n)]
    return {
        "backend": "gpu",
        "num_devices": n,
        "device_peak_bytes": max(int(s.get("allocated_bytes.all.peak", 0)) for s in stats),
        "device_bytes_in_use": sum(int(s.get("allocated_bytes.all.current", 0)) for s in stats),
        "live_buffers": sum(int(s.get("active.all.current", 0)) for s in stats),
    }


def record_device_telemetry(registry: Optional[MetricsRegistry] = None) -> dict:
    """Sample and fold into the registry: the ``device_peak_bytes`` /
    ``device_bytes_in_use`` / ``live_buffers`` gauges (a None figure leaves
    its gauge untouched rather than zeroing a real prior reading). Returns
    the sample."""
    reg = registry if registry is not None else get_registry()
    sample = sample_device_telemetry()
    if sample["device_peak_bytes"] is not None:
        reg.gauge("device_peak_bytes", help="max per-device peak_bytes_in_use").set(
            sample["device_peak_bytes"]
        )
    if sample["device_bytes_in_use"] is not None:
        reg.gauge("device_bytes_in_use", help="sum of per-device bytes_in_use").set(
            sample["device_bytes_in_use"]
        )
    if sample["live_buffers"] is not None:
        reg.gauge("live_buffers", help="live device allocations at last sample").set(
            sample["live_buffers"]
        )
    return sample


class CompileTracker:
    """Build observer: the counting sibling of
    :class:`..utils.profiling.RecompilationSentinel` (which enforces a
    budget). Call :meth:`record` at span boundaries: every kernel library
    built since the previous call (or construction) lands on the
    ``recompiles`` counter. The JAX package's tracks the jit caches of the
    functions it is given; the port's compiles are its `nvcc` builds, so
    it tracks those and takes no functions."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = registry
        self._baseline = self._builds()

    @staticmethod
    def _builds() -> int:
        from yuma_simulation_tpu_torch.ops._build import process_stats

        return process_stats().builds

    def record(self) -> int:
        """Builds since the last call; increments ``recompiles`` by them."""
        current = self._builds()
        new = max(0, current - self._baseline)
        self._baseline = current
        if new:
            reg = self._registry if self._registry is not None else get_registry()
            reg.counter("recompiles", help="new jit-cache entries observed").inc(new)
        return new

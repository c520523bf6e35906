"""The traced window: torch.profiler (CUPTI) over whole calls, reduced to
what the per-layer metrics read.

The reduction follows `chip_smoke.py::mc_profile` at commit b289c29 (the
device events of one call, busy time as the union of their intervals),
applied here to every call of the traced window: each call runs inside a
`record_function` range named :data:`CALL_RANGE`, and the window is the
span from the first call's start to the last call's end.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

#: The range the harness opens around each traced call.
CALL_RANGE = "cudabench.call"
#: Device operations and idle gaps listed in the result's `breakdown`.
BREAKDOWN_ENTRIES = 10

_KERNEL_NAME = re.compile(r"\bk_[a-z_0-9]+")


@dataclass
class DeviceOp:
    name: str
    start_us: float
    end_us: float

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(("Memcpy", "Memset"))

    @property
    def short_name(self) -> str:
        """A phase kernel by its `k_*` name (template arguments dropped),
        anything else by its first 64 characters."""
        found = _KERNEL_NAME.search(self.name)
        return found.group(0) if found else self.name[:64]


@dataclass
class Trace:
    """The traced window: its device operations, its length, the device's
    busy time in it, and the idle gaps by what the host was doing."""

    calls: int
    window_s: float
    ops: list = field(default_factory=list)
    busy_s: float = 0.0
    idle_by_host: dict = field(default_factory=dict)

    def device_s(self, names) -> float:
        """Seconds of device time of the operations whose short name is in `names`."""
        return sum(op.end_us - op.start_us for op in self.ops if op.short_name in names) / 1e6

    def kernels(self) -> list:
        return [op for op in self.ops if op.is_kernel]

    def breakdown(self) -> dict:
        by_name: dict = {}
        for op in self.ops:
            seconds = (op.end_us - op.start_us) / 1e6
            by_name[op.short_name] = by_name.get(op.short_name, 0.0) + seconds
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def busy_intervals(spans) -> list:
    """The union of `(start, end)` intervals, as sorted disjoint intervals."""
    merged: list = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _host_labels(gaps, host_events) -> list:
    """For each idle gap, the innermost host event running at its middle
    (the host's events on one thread nest, so a stack of open events
    answers each gap in one sweep), or "host outside any recorded op"."""
    events = sorted(host_events, key=lambda e: (e[0], -e[1]))
    mids = sorted((0.5 * (s + e), i) for i, (s, e) in enumerate(gaps))
    labels = [""] * len(gaps)
    stack: list = []
    j = 0
    for mid, i in mids:
        while j < len(events) and events[j][0] <= mid:
            while stack and stack[-1][1] < events[j][0]:
                stack.pop()
            stack.append(events[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        labels[i] = stack[-1][2] if stack else "host outside any recorded op"
    return labels


def reduce_events(events, calls: int) -> Trace:
    """A :class:`Trace` from a profiler's `events()`: the window spans the
    :data:`CALL_RANGE` ranges; device operations are clipped to it."""
    from torch.autograd import DeviceType

    ranges = [e for e in events if e.name == CALL_RANGE and e.device_type == DeviceType.CPU]
    if not ranges:
        return Trace(calls=calls, window_s=0.0)
    lo = min(e.time_range.start for e in ranges)
    hi = max(e.time_range.end for e in ranges)
    thread = ranges[0].thread
    ops, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # A range opened on the host shows on the device's timeline as
            # an annotation over its kernels: not an operation of its own.
            annotation = getattr(e, "is_user_annotation", False) or e.name == CALL_RANGE
            if not annotation and end > lo and start < hi:
                ops.append(DeviceOp(e.name, max(start, lo), min(end, hi)))
        elif e.thread == thread and end > lo and start < hi:
            host.append((start, end, e.name))
    merged = busy_intervals((op.start_us, op.end_us) for op in ops)
    trace = Trace(calls=calls, window_s=(hi - lo) / 1e6, ops=ops,
                  busy_s=sum(e - s for s, e in merged) / 1e6)
    edges = [lo] + [x for s, e in merged for x in (s, e)] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    for (s, e), label in zip(gaps, _host_labels(gaps, host)):
        trace.idle_by_host[label] = trace.idle_by_host.get(label, 0.0) + (e - s) / 1e6
    return trace


def traced_calls(torch, call, first: int, count: int):
    """Run `call(i)` for `i` in `[first, first + count)` under the profiler,
    each inside a :data:`CALL_RANGE` range; returns `(outputs, Trace)`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    outputs = []
    with profile(activities=activities) as prof:
        for i in range(first, first + count):
            with record_function(CALL_RANGE):
                outputs.append(call(i))
    return outputs, reduce_events(prof.events(), count)


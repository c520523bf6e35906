"""Process-local metrics registry: counters, gauges, histograms.

The counterpart of the JAX package's `telemetry/metrics.py`, with the same
snapshot and exposition formats:

- :class:`Counter` / :class:`Gauge` / :class:`Histogram`, mutated under
  locks;
- :class:`MetricsRegistry`: get-or-create by name, a point-in-time
  :meth:`~MetricsRegistry.snapshot`, crash-safe JSONL snapshot sinks
  (:meth:`~MetricsRegistry.publish_snapshot` through
  :func:`..utils.checkpoint.publish_atomic`,
  :meth:`~MetricsRegistry.append_snapshot` through
  :func:`..utils.checkpoint.append_durable`) and Prometheus text
  (:meth:`~MetricsRegistry.prometheus_text`);
- the process registry, :func:`get_registry`, and
  :func:`record_epoch_rate`, the one epoch-rate reporting path
  (`simulate` through :class:`..utils.profiling.timed`).

Every series name is declared in :mod:`.registry`. Host-side only.
"""

from __future__ import annotations

import json
import logging
import math
import pathlib
import re
import threading
import time
from typing import Optional, Sequence, Union

from yuma_simulation_tpu_torch.utils.checkpoint import (
    append_durable,
    publish_atomic,
    read_jsonl_tolerant,
)
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

#: Default histogram boundaries: wall-clock seconds from 1 ms to ~15 min,
#: the span of a unit dispatch (compile included) on any supported
#: backend.
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.025, 0.1, 0.5, 2.0, 10.0, 60.0, 300.0, 900.0,
)


_SEQ_LOCK = threading.Lock()
_SEQ = 0


def _next_seq() -> int:
    """Monotone per-process sequence number stamped into every snapshot
    record: cumulative snapshots carry no ordering of their own once sinks
    from several processes merge, and wall clocks can collide; ``(source,
    seq)`` is an exact dedupe identity (the JAX package's format)."""
    global _SEQ
    with _SEQ_LOCK:
        _SEQ += 1
        return _SEQ


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} is not Prometheus-compatible "
            "([a-zA-Z_:][a-zA-Z0-9_:]*)"
        )
    return name


class Counter:
    """Monotonic counter. `inc` is thread-safe; negative increments are
    rejected (a counter that can go down is a gauge)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: Union[int, float] = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value; `set`/`inc` thread-safe."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: Union[int, float]) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: Union[int, float] = 1) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-boundary histogram with Prometheus cumulative-bucket
    semantics (`le` upper bounds, implicit ``+Inf``)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        self.name = _check_name(name)
        self.help = help
        # Finite bounds only: the cumulative +Inf bucket is ALWAYS
        # emitted from the total count (exposition conformance), so a
        # caller-passed inf/nan bound would only shadow it with a
        # malformed `le` label.
        bounds = tuple(
            sorted(
                {float(b) for b in buckets if math.isfinite(float(b))}
            )
        )
        if not bounds:
            raise ValueError(
                "histogram needs at least one finite bucket bound"
            )
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value: Union[int, float]) -> None:
        v = float(value)
        idx = len(self.bounds)
        for i, b in enumerate(self.bounds):
            if v <= b:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        """`{"count", "sum", "buckets": {le_str: cumulative_count}}`."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cumulative: dict[str, int] = {}
        acc = 0
        for b, c in zip(self.bounds, counts):
            acc += c
            cumulative[repr(b)] = acc
        cumulative["+Inf"] = total
        return {"count": total, "sum": s, "buckets": cumulative}


class MetricsRegistry:
    """Name -> metric, get-or-create, with snapshot/exposition sinks.

    Not a singleton by construction — tests build throwaway registries —
    but production code shares the process registry via
    :func:`get_registry`.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Union[Counter, Gauge, Histogram]] = {}

    # -- get-or-create --------------------------------------------------

    def _get_or_create(self, cls, name: str, **kwargs):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = cls(name, **kwargs)
                self._metrics[name] = metric
                return metric
        if not isinstance(metric, cls):
            raise TypeError(
                f"metric {name!r} already registered as {metric.kind}, "
                f"not {cls.kind}"
            )
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help=help)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help=help, buckets=buckets)

    def reset(self) -> None:
        """Drop every registered metric (tests; never production)."""
        with self._lock:
            self._metrics.clear()

    # -- sinks -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Point-in-time `{"counters": {...}, "gauges": {...},
        "histograms": {...}}` of every registered series."""
        with self._lock:
            metrics = dict(self._metrics)
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(metrics.items()):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.snapshot()
        return out

    def publish_snapshot(
        self, path: Union[str, pathlib.Path], **meta
    ) -> dict:
        """Append one snapshot line to the JSONL sink at `path` under the
        crash-safety contract (whole-file atomic republish via
        :func:`..utils.checkpoint.publish_atomic`): at every instant the sink is a complete parseable
        prefix. Undecodable lines from a pre-atomic writer are dropped
        with a warning (the shared
        :func:`..utils.checkpoint.read_jsonl_tolerant` reader). `meta`
        (e.g. ``run_id=...``) rides the line. Returns the appended
        record."""
        path = pathlib.Path(path)
        record = {
            "t": round(time.time(), 6),
            "seq": _next_seq(),
            **meta,
            **self.snapshot(),
        }
        records = read_jsonl_tolerant(path)
        records.append(record)
        payload = "".join(
            json.dumps(r, sort_keys=True) + "\n" for r in records
        )
        publish_atomic(path, payload.encode())
        return record

    def append_snapshot(
        self, path: Union[str, pathlib.Path], **meta
    ) -> dict:
        """Append one snapshot line to the JSONL sink at `path` WITHOUT
        re-reading/republishing the whole file — O(one line) however
        large the sink has grown, via
        :func:`..utils.checkpoint.append_durable`: a crash can tear only
        the appended tail line (readers are torn-tail tolerant), and
        snapshots are cumulative, so a lost tail costs one sample, not
        history. `meta` rides the line; returns the appended record."""
        record = {
            "t": round(time.time(), 6),
            "seq": _next_seq(),
            **meta,
            **self.snapshot(),
        }
        append_durable(
            pathlib.Path(path),
            (json.dumps(record, sort_keys=True) + "\n").encode(),
        )
        return record

    def prometheus_text(self) -> str:
        """The registry in Prometheus text exposition format (0.0.4) —
        serve or dump this for scraping; no client library needed.

        Conformance contract (held to the JAX package's text by
        tests/test_torch_telemetry.py): every histogram emits its
        buckets in ascending ``le`` order ending with a cumulative
        ``+Inf`` bucket equal to ``_count``; bucket counts are monotone
        non-decreasing (cumulative by construction, the ``+Inf`` total
        included); HELP text is escaped per the format (backslash and
        newline)."""
        with self._lock:
            metrics = dict(self._metrics)
        out: list[str] = []
        for name, m in sorted(metrics.items()):
            if m.help:
                out.append(f"# HELP {name} {_escape_help(m.help)}")
            out.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, (Counter, Gauge)):
                out.append(f"{name} {_fmt_value(m.value)}")
            else:
                snap = m.snapshot()
                # snapshot() yields bounds in ascending order with the
                # "+Inf" total last; emit in exactly that order.
                for le, c in snap["buckets"].items():
                    out.append(f'{name}_bucket{{le="{le}"}} {c}')
                out.append(f"{name}_sum {_fmt_value(snap['sum'])}")
                out.append(f"{name}_count {snap['count']}")
        return "\n".join(out) + ("\n" if out else "")


def _fmt_value(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(v)


def _escape_help(text: str) -> str:
    """HELP-line escaping per the exposition format: backslash first,
    then newline — a help string must never break line framing."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-local registry every production producer feeds."""
    return _REGISTRY


def record_epoch_rate(
    label: str,
    *,
    epochs: Optional[int] = None,
    seconds: Optional[float] = None,
    epochs_per_sec: Optional[float] = None,
    cv: Optional[float] = None,
    registry: Optional[MetricsRegistry] = None,
    logger_: Optional[logging.Logger] = None,
) -> Optional[float]:
    """The one epoch-rate reporting path (`simulate`, through
    :class:`..utils.profiling.timed`): feeds ``epochs_total`` /
    ``epochs_per_sec`` in the registry and emits exactly one
    ``event=epoch_rate`` record. Pass either a precomputed
    `epochs_per_sec` or `epochs` + `seconds`. `cv` (the timing dispersion
    across repeats, from :func:`..utils.timing.time_best`) rides the record
    and the ``epochs_per_sec_cv`` gauge. Returns the rate (None when it
    cannot be derived)."""
    reg = registry if registry is not None else get_registry()
    if epochs_per_sec is None and epochs is not None and seconds:
        epochs_per_sec = epochs / seconds
    if epochs:
        reg.counter(
            "epochs_total", help="simulated epochs (lanes x E)"
        ).inc(epochs)
    if epochs_per_sec is not None:
        reg.gauge(
            "epochs_per_sec", help="last observed simulated epochs/sec"
        ).set(epochs_per_sec)
    if cv is not None:
        reg.gauge(
            "epochs_per_sec_cv",
            help="timing dispersion (CV across repeats) of the last rate",
        ).set(cv)
    log_event(
        logger_ if logger_ is not None else logger,
        "epoch_rate",
        level=logging.INFO,
        label=label,
        epochs="" if epochs is None else epochs,
        seconds="" if seconds is None else f"{seconds:.3f}",
        epochs_per_sec=(
            "" if epochs_per_sec is None else f"{epochs_per_sec:.1f}"
        ),
        cv="" if cv is None else f"{cv:.4f}",
    )
    return epochs_per_sec

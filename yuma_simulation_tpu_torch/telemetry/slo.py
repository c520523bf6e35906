"""SLOs over mergeable sketches: objectives, burn rates, dispatch stats.

The counterpart of the JAX package's `telemetry/slo.py`, with the same
state formats (the ``slo.json`` and ``dispatch_sketches`` payloads that
`tools/sloreport.py` and `tools/perfattrib.py` read):

- :class:`LatencySketch`: a log-bucketed quantile sketch (DDSketch
  family) with a declared relative-error bound; ``merge`` is exact count
  addition, so sketches merge across threads and processes;
- :class:`SLOSpec`: one declarative objective (the fraction of events that
  must be good: a duration under its threshold, or an explicit good/bad
  event) with fast/slow burn-rate windows;
- :class:`SLOEngine`: the evaluator on an injectable clock; it walks each
  SLO through ``ok -> slow_burn -> fast_burn`` and back, each transition
  one ``event=slo_alert`` / ``slo_recovered`` record plus the
  ``slo_alerts_total`` / ``slo_fast_burn_active`` / ``slo_slow_burn_active``
  metrics;
- :class:`DispatchStats` and :func:`observe_dispatch`: the always-on
  per-(rung x shape bucket x backend) dispatch timing that `simulate` feeds
  once a dispatch; `backend` is the JAX package's platform name (``"gpu"``
  for CUDA, ``"cpu"``), so the keys read the same.

Host-side only, all state under locks. Unlike the JAX package, the
observation hooks do not swallow their own failures: a broken hook fails
the call it measures rather than hiding.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from typing import Callable, Optional, Sequence

from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

#: Default quantile relative-error bound: 1% — tight enough that a p99
#: read off a sketch is the p99, loose enough that a sweep's worth of
#: durations fits in tens of buckets.
DEFAULT_RELATIVE_ACCURACY = 0.01


class LatencySketch:
    """Log-bucketed quantile sketch with a declared relative-error
    bound (see the module docstring). Values are wall-clock seconds
    (any positive magnitude works); non-positive values land in a
    dedicated zero bucket so a clock hiccup cannot crash the math."""

    def __init__(
        self, relative_accuracy: float = DEFAULT_RELATIVE_ACCURACY
    ):
        if not (0.0 < relative_accuracy < 1.0):
            raise ValueError(
                "relative_accuracy must be in (0, 1), got "
                f"{relative_accuracy}"
            )
        self.relative_accuracy = float(relative_accuracy)
        self._gamma = (1.0 + self.relative_accuracy) / (
            1.0 - self.relative_accuracy
        )
        self._log_gamma = math.log(self._gamma)
        self._lock = threading.Lock()
        self._counts: dict[int, int] = {}
        self._zero = 0
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- ingest ---------------------------------------------------------

    def _index(self, value: float) -> int:
        return int(math.ceil(math.log(value) / self._log_gamma))

    def _representative(self, index: int) -> float:
        # Midpoint of (gamma^(i-1), gamma^i] in the relative metric:
        # |rep - v| / v <= relative_accuracy for every v in the bucket.
        return 2.0 * self._gamma**index / (self._gamma + 1.0)

    def observe(self, value) -> None:
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if v <= 0.0:
                self._zero += 1
                return
            idx = self._index(v)
            self._counts[idx] = self._counts.get(idx, 0) + 1

    # -- algebra --------------------------------------------------------

    def merge(self, other: "LatencySketch") -> "LatencySketch":
        """Fold `other` into this sketch (count addition — exact,
        associative, commutative). The accuracy parameters must match:
        merging mismatched bucket bases would silently void the error
        bound."""
        if not isinstance(other, LatencySketch):
            raise TypeError(f"cannot merge {type(other).__name__}")
        if not math.isclose(self._gamma, other._gamma):
            raise ValueError(
                "cannot merge sketches with different relative accuracy "
                f"({self.relative_accuracy} vs {other.relative_accuracy})"
            )
        # Snapshot the donor first: taking both locks in caller order
        # could deadlock two concurrent a.merge(b) / b.merge(a).
        with other._lock:
            counts = dict(other._counts)
            zero, count = other._zero, other._count
            s, lo, hi = other._sum, other._min, other._max
        with self._lock:
            for idx, c in counts.items():
                self._counts[idx] = self._counts.get(idx, 0) + c
            self._zero += zero
            self._count += count
            self._sum += s
            self._min = min(self._min, lo)
            self._max = max(self._max, hi)
        return self

    # -- read -----------------------------------------------------------

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """The q-quantile (0 <= q <= 1) of everything observed, within
        the declared relative error; None on an empty sketch."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return None
            counts = sorted(self._counts.items())
            zero, total = self._zero, self._count
        rank = max(0, min(total - 1, int(math.ceil(q * total)) - 1))
        if rank < zero:
            return 0.0
        acc = zero
        for idx, c in counts:
            acc += c
            if rank < acc:
                return self._representative(idx)
        return self._representative(counts[-1][0]) if counts else 0.0

    def to_json(self) -> dict:
        with self._lock:
            return {
                "relative_accuracy": self.relative_accuracy,
                "counts": {str(k): v for k, v in sorted(self._counts.items())},
                "zero": self._zero,
                "count": self._count,
                "sum": self._sum,
                "min": None if self._count == 0 else self._min,
                "max": None if self._count == 0 else self._max,
            }

    @classmethod
    def from_json(cls, rec: dict) -> "LatencySketch":
        sketch = cls(rec.get("relative_accuracy", DEFAULT_RELATIVE_ACCURACY))
        sketch._counts = {int(k): int(v) for k, v in rec.get("counts", {}).items()}
        sketch._zero = int(rec.get("zero", 0))
        sketch._count = int(rec.get("count", 0))
        sketch._sum = float(rec.get("sum", 0.0))
        if sketch._count:
            sketch._min = float(rec.get("min", 0.0))
            sketch._max = float(rec.get("max", 0.0))
        return sketch


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective (module docstring). Exactly one signal
    source: `sketch` + `threshold_seconds` (a duration stream — good iff
    the value is under the threshold) or `event` (an explicit good/bad
    stream fed via :meth:`SLOEngine.event`)."""

    name: str
    objective: float
    description: str = ""
    #: duration metric this SLO watches (also feeds the named sketch).
    sketch: Optional[str] = None
    threshold_seconds: Optional[float] = None
    #: good/bad event stream name (error-rate / shed-rate SLOs).
    event: Optional[str] = None
    fast_window_seconds: float = 300.0
    fast_burn_threshold: float = 14.4
    slow_window_seconds: float = 3600.0
    slow_burn_threshold: float = 6.0
    #: below this many events in a window the burn rate reads 0 — a
    #: single bad request at dawn must not page anyone.
    min_events: int = 1
    #: a fast burn of this SLO drives admission degradation (the serve
    #: tier sheds lowest-priority work). Shed-rate SLOs set False:
    #: shedding to cure a shed-rate burn is a feedback loop.
    degrade: bool = True

    def __post_init__(self) -> None:
        if not (0.0 < self.objective < 1.0):
            raise ValueError(
                f"SLO {self.name!r}: objective must be in (0, 1), got "
                f"{self.objective}"
            )
        if (self.sketch is None) == (self.event is None):
            raise ValueError(
                f"SLO {self.name!r}: exactly one of sketch= or event= "
                "must be set"
            )
        if self.sketch is not None and self.threshold_seconds is None:
            raise ValueError(
                f"SLO {self.name!r}: a sketch-based SLO needs "
                "threshold_seconds"
            )
        if self.fast_window_seconds <= 0 or self.slow_window_seconds <= 0:
            raise ValueError(f"SLO {self.name!r}: windows must be > 0")
        if self.min_events < 1:
            raise ValueError(f"SLO {self.name!r}: min_events must be >= 1")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class _SpecState:
    """One SLO's live accounting: per-second (clock-bucketed) good/bad
    counts bounded by the slow window, plus the current alert state."""

    __slots__ = ("spec", "buckets", "state")

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self.buckets: list = []  # [sec, good, bad], append-ordered
        self.state = "ok"

    def record(self, now: float, good: bool) -> None:
        sec = int(now)
        if self.buckets and self.buckets[-1][0] == sec:
            b = self.buckets[-1]
        else:
            self.buckets.append([sec, 0, 0])
            b = self.buckets[-1]
        b[1 if good else 2] += 1
        self._trim(now)

    def _trim(self, now: float) -> None:
        horizon = int(now) - int(
            max(self.spec.slow_window_seconds, self.spec.fast_window_seconds)
        ) - 1
        while self.buckets and self.buckets[0][0] < horizon:
            self.buckets.pop(0)

    def window_counts(self, now: float, window_seconds: float) -> tuple:
        lo = now - window_seconds
        good = bad = 0
        for sec, g, b in self.buckets:
            if sec >= lo:
                good += g
                bad += b
        return good, bad

    def burn_rate(self, now: float, window_seconds: float) -> float:
        good, bad = self.window_counts(now, window_seconds)
        total = good + bad
        if total < self.spec.min_events or total == 0:
            return 0.0
        return (bad / total) / self.spec.error_budget


class SLOEngine:
    """The burn-rate evaluator (module docstring). Thread-safe; the
    clock is injectable so burn-rate arithmetic pins against
    hand-computed windows in tests. `on_transition` (when given) is
    called with each alert record OUTSIDE the engine lock — the serving
    tier appends them to its crash-safe request ledger."""

    #: alert history bound (oldest dropped): post-mortems need the
    #: recent story, not an unbounded list on a year-old process.
    MAX_ALERTS = 1000

    def __init__(
        self,
        specs: Sequence[SLOSpec] = (),
        *,
        clock: Callable[[], float] = time.monotonic,
        registry=None,
        on_transition: Optional[Callable[[dict], None]] = None,
    ):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names in {names}")
        self.specs = tuple(specs)
        self._clock = clock
        self._lock = threading.Lock()
        self._states = {s.name: _SpecState(s) for s in specs}
        self._sketches: dict[str, LatencySketch] = {}
        self._alerts: list[dict] = []
        self.on_transition = on_transition
        if registry is None:
            from yuma_simulation_tpu_torch.telemetry.metrics import get_registry

            registry = get_registry()
        self._alerts_total = registry.counter(
            "slo_alerts_total", help="SLO burn-rate alert transitions"
        )
        self._fast_gauge = registry.gauge(
            "slo_fast_burn_active", help="SLOs currently fast-burning"
        )
        self._slow_gauge = registry.gauge(
            "slo_slow_burn_active", help="SLOs currently slow-burning"
        )

    # -- ingest ---------------------------------------------------------

    def sketch(self, metric: str) -> LatencySketch:
        with self._lock:
            sk = self._sketches.get(metric)
            if sk is None:
                sk = self._sketches[metric] = LatencySketch()
            return sk

    def observe(self, metric: str, seconds: float) -> None:
        """One duration observation: feeds the named sketch, and every
        sketch-based SLO watching `metric` scores it good/bad against
        its threshold."""
        self.sketch(metric).observe(seconds)
        now = self._clock()
        transitions = []
        with self._lock:
            for st in self._states.values():
                if st.spec.sketch != metric:
                    continue
                st.record(now, float(seconds) <= st.spec.threshold_seconds)
                transitions.extend(self._evaluate_locked(st, now))
        self._emit(transitions)

    def event(self, metric: str, ok: bool) -> None:
        """One good/bad event for every event-based SLO on `metric`."""
        now = self._clock()
        transitions = []
        with self._lock:
            for st in self._states.values():
                if st.spec.event != metric:
                    continue
                st.record(now, bool(ok))
                transitions.extend(self._evaluate_locked(st, now))
        self._emit(transitions)

    # -- evaluation -----------------------------------------------------

    def _evaluate_locked(self, st: _SpecState, now: float) -> list[dict]:
        st._trim(now)
        fast = st.burn_rate(now, st.spec.fast_window_seconds)
        slow = st.burn_rate(now, st.spec.slow_window_seconds)
        if fast >= st.spec.fast_burn_threshold:
            new = "fast_burn"
            burn = fast
        elif slow >= st.spec.slow_burn_threshold:
            new = "slow_burn"
            burn = slow
        else:
            new = "ok"
            burn = max(fast, slow)
        if new == st.state:
            return []
        old, st.state = st.state, new
        record = {
            "t": round(time.time(), 6),
            "slo": st.spec.name,
            "from": old,
            "to": new,
            "burn_rate": round(burn, 4),
            "fast_burn_rate": round(fast, 4),
            "slow_burn_rate": round(slow, 4),
            "objective": st.spec.objective,
        }
        self._alerts.append(record)
        del self._alerts[: -self.MAX_ALERTS]
        self._fast_gauge.set(
            sum(1 for s in self._states.values() if s.state == "fast_burn")
        )
        self._slow_gauge.set(
            sum(1 for s in self._states.values() if s.state == "slow_burn")
        )
        self._alerts_total.inc()
        return [record]

    def _emit(self, transitions: list[dict]) -> None:
        for rec in transitions:
            log_event(
                logger,
                "slo_alert" if rec["to"] != "ok" else "slo_recovered",
                level=(
                    logging.WARNING if rec["to"] != "ok" else logging.INFO
                ),
                slo=rec["slo"],
                state=rec["to"],
                was=rec["from"],
                burn=f"{rec['burn_rate']:.2f}",
                objective=rec["objective"],
            )
            if self.on_transition is not None:
                self.on_transition(rec)

    def evaluate(self) -> dict:
        """Re-evaluate every SLO at the current clock (pure time passage
        un-flips a recovered burn) and return per-SLO status dicts."""
        now = self._clock()
        transitions = []
        out: dict[str, dict] = {}
        with self._lock:
            for name, st in sorted(self._states.items()):
                transitions.extend(self._evaluate_locked(st, now))
                fast_g, fast_b = st.window_counts(
                    now, st.spec.fast_window_seconds
                )
                slow_g, slow_b = st.window_counts(
                    now, st.spec.slow_window_seconds
                )
                out[name] = {
                    "state": st.state,
                    "objective": st.spec.objective,
                    "fast_burn_rate": round(
                        st.burn_rate(now, st.spec.fast_window_seconds), 4
                    ),
                    "slow_burn_rate": round(
                        st.burn_rate(now, st.spec.slow_window_seconds), 4
                    ),
                    "fast_window": {"good": fast_g, "bad": fast_b},
                    "slow_window": {"good": slow_g, "bad": slow_b},
                    "degrade": st.spec.degrade,
                }
        self._emit(transitions)
        return out

    def state(self, name: str) -> str:
        self.evaluate()
        with self._lock:
            return self._states[name].state

    def fast_burning(self) -> tuple:
        """Names of SLOs currently fast-burning (evaluated now)."""
        status = self.evaluate()
        return tuple(
            name for name, s in status.items() if s["state"] == "fast_burn"
        )

    def degraded(self) -> tuple:
        """Fast-burning SLOs that drive admission degradation — the
        serving tier sheds lowest-priority work while this is
        non-empty."""
        status = self.evaluate()
        return tuple(
            name
            for name, s in status.items()
            if s["state"] == "fast_burn" and s["degrade"]
        )

    def alerts(self) -> list[dict]:
        with self._lock:
            return list(self._alerts)

    def snapshot(self) -> dict:
        """The full engine state for ``slo.json``/`/healthz`: specs,
        per-SLO status, sketches (serialized + headline quantiles),
        alert history."""
        status = self.evaluate()
        with self._lock:
            sketches = dict(self._sketches)
            alerts = list(self._alerts)
        sketch_out = {}
        for metric, sk in sorted(sketches.items()):
            rec = sk.to_json()
            rec["quantiles"] = {
                q: sk.quantile(float(q))
                for q in ("0.5", "0.9", "0.99")
            }
            sketch_out[metric] = rec
        return {
            "specs": [s.to_json() for s in self.specs],
            "states": status,
            "sketches": sketch_out,
            "alerts": alerts,
        }


# ------------------------------------------------------------ process state

#: The default objectives every process carries, the JAX package's
#: (serving, sweep-unit, cold-start, numerics-drift and replay-freshness
#: objectives; generous, so test and smoke runs never trip them). A
#: deployment replaces them via :func:`set_slo_engine`.
DEFAULT_SLO_SPECS = (
    SLOSpec(
        "serve_latency",
        objective=0.99,
        description="p99 serve request wall time under 30s",
        sketch="serve_request_seconds",
        threshold_seconds=30.0,
        fast_window_seconds=60.0,
        slow_window_seconds=600.0,
        min_events=20,
    ),
    SLOSpec(
        "serve_errors",
        objective=0.995,
        description="serve requests answered without a 5xx",
        event="serve_request_ok",
        fast_window_seconds=60.0,
        slow_window_seconds=600.0,
        min_events=20,
    ),
    SLOSpec(
        "serve_shed",
        objective=0.9,
        description="serve requests admitted (not 429-shed)",
        event="serve_admitted",
        fast_window_seconds=60.0,
        slow_window_seconds=600.0,
        min_events=20,
        degrade=False,
    ),
    SLOSpec(
        "unit_duration",
        objective=0.95,
        description="supervised sweep units under 300s wall",
        sketch="unit_seconds",
        threshold_seconds=300.0,
        fast_window_seconds=120.0,
        slow_window_seconds=1800.0,
        min_events=10,
        degrade=False,
    ),
    SLOSpec(
        "cold_start",
        objective=0.9,
        description="compile regions under 120s (cold-start cost)",
        sketch="compile_seconds",
        threshold_seconds=120.0,
        fast_window_seconds=300.0,
        slow_window_seconds=3600.0,
        min_events=10,
        degrade=False,
    ),
    SLOSpec(
        "engine_drift",
        objective=0.999,
        description="cross-engine numerics canaries reproducing the "
        "primary's bits (telemetry.numerics)",
        event="engine_drift_ok",
        fast_window_seconds=60.0,
        slow_window_seconds=600.0,
        min_events=1,
        degrade=True,
    ),
    SLOSpec(
        "replay_freshness",
        objective=0.95,
        description="live subnets whose unswept archive suffix is "
        "younger than the controller's freshness budget",
        event="replay_fresh",
        fast_window_seconds=60.0,
        fast_burn_threshold=10.0,
        slow_window_seconds=600.0,
        slow_burn_threshold=4.0,
        min_events=5,
        degrade=True,
    ),
)

_ENGINE: Optional[SLOEngine] = None
_ENGINE_LOCK = threading.Lock()


def get_slo_engine() -> SLOEngine:
    """The process SLO engine (lazily built over
    :data:`DEFAULT_SLO_SPECS`), fed without plumbing."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = SLOEngine(DEFAULT_SLO_SPECS)
        return _ENGINE


def peek_slo_engine() -> Optional[SLOEngine]:
    """The process engine if one exists, without creating it (a process
    that never observed an SLO signal has no SLO state to publish)."""
    with _ENGINE_LOCK:
        return _ENGINE


def set_slo_engine(engine: Optional[SLOEngine]) -> Optional[SLOEngine]:
    """Swap the process engine (deployments with custom specs, tests
    with fake clocks); returns the previous one. ``None`` resets to
    lazy-default."""
    global _ENGINE
    with _ENGINE_LOCK:
        previous, _ENGINE = _ENGINE, engine
        return previous


def observe_duration(metric: str, seconds: float) -> None:
    """Feed one duration into the process engine (creating it on first
    use)."""
    get_slo_engine().observe(metric, seconds)


def observe_event(metric: str, ok: bool) -> None:
    """Feed one good/bad event into the process engine (a numerics
    comparison's ``engine_drift_ok`` stream: a confirmed drift is the bad
    event)."""
    get_slo_engine().event(metric, ok)


# --------------------------------------------- dispatch timing sketches

#: Hard cardinality bound on (engine x bucket x backend) keys: far past
#: any real mix of shapes, tight enough that a caller sending a new shape
#: every call cannot grow process memory.
MAX_DISPATCH_KEYS = 64

#: The fold-in key once the bound is hit — measured time is never
#: dropped, it just loses per-shape attribution past the bound.
DISPATCH_OVERFLOW_KEY = "overflow"


class _DispatchEntry:
    __slots__ = ("engine", "bucket", "backend", "sketch", "dispatches",
                 "epochs_total", "seconds_total")

    def __init__(self, engine: str, bucket: str, backend: str):
        self.engine = engine
        self.bucket = bucket
        self.backend = backend
        self.sketch = LatencySketch()
        self.dispatches = 0
        self.epochs_total = 0
        self.seconds_total = 0.0


class DispatchStats:
    """Always-on per-(engine rung x shape bucket x backend) dispatch
    timing: a :class:`LatencySketch` of wall seconds plus epoch/second
    totals per key, bounded at ``max_keys`` (the overflow key absorbs
    the tail). Fed host-side at the dispatch seam (one observe per
    dispatched region, O(1), no device sync of its own); its snapshot is
    the ``dispatch_sketches`` field of the JAX package's metrics lines,
    which ``tools/perfattrib.py`` reads."""

    def __init__(self, max_keys: int = MAX_DISPATCH_KEYS):
        self.max_keys = int(max_keys)
        self._lock = threading.Lock()
        self._entries: dict[str, _DispatchEntry] = {}

    @staticmethod
    def key_for(engine: str, bucket: str, backend: str) -> str:
        return f"{engine}|{bucket}|{backend}"

    def observe(
        self,
        *,
        engine: str,
        bucket: str,
        backend: str,
        seconds: float,
        epochs: int = 0,
    ) -> None:
        key = self.key_for(engine, bucket, backend)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                if len(self._entries) >= self.max_keys:
                    key = DISPATCH_OVERFLOW_KEY
                    entry = self._entries.get(key)
                    if entry is None:
                        entry = self._entries[key] = _DispatchEntry(
                            DISPATCH_OVERFLOW_KEY, "", ""
                        )
                else:
                    entry = self._entries[key] = _DispatchEntry(
                        engine, bucket, backend
                    )
            entry.dispatches += 1
            entry.epochs_total += int(epochs)
            entry.seconds_total += float(seconds)
        entry.sketch.observe(seconds)

    def snapshot(self) -> dict:
        """``{key: {engine, bucket, backend, dispatches, epochs_total,
        seconds_total, sketch}}`` — sketches serialized
        (:meth:`LatencySketch.to_json`), so snapshots merge exactly
        after the fact. Cumulative over process life: a consumer
        reading a snapshot stream keeps the highest-count line per
        key."""
        with self._lock:
            entries = dict(self._entries)
        out = {}
        for key, e in sorted(entries.items()):
            out[key] = {
                "engine": e.engine,
                "bucket": e.bucket,
                "backend": e.backend,
                "dispatches": e.dispatches,
                "epochs_total": e.epochs_total,
                "seconds_total": round(e.seconds_total, 6),
                "sketch": e.sketch.to_json(),
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


_DISPATCH_STATS = DispatchStats()

#: Process-wide switch of the dispatch-timing seam, for measuring the
#: seam's own cost (the same dispatch path timed with it on and off).
#: Production code never flips it.
_OBSERVE_ENABLED = True


def set_dispatch_observation(enabled: bool) -> bool:
    """Enable/disable :func:`observe_dispatch` process-wide; returns
    the previous setting so callers can restore it."""
    global _OBSERVE_ENABLED
    prev = _OBSERVE_ENABLED
    _OBSERVE_ENABLED = bool(enabled)
    return prev


def get_dispatch_stats() -> DispatchStats:
    """The process-wide dispatch timing table (see
    :class:`DispatchStats`)."""
    return _DISPATCH_STATS


def observe_dispatch(
    *,
    engine: str,
    bucket: str,
    backend: str,
    seconds: float,
    epochs: int = 0,
) -> None:
    """Feed one dispatched region's wall time into the process table.
    Host-side only: one lock, one dict lookup, one sketch bucket."""
    if not _OBSERVE_ENABLED:
        return
    _DISPATCH_STATS.observe(
        engine=engine,
        bucket=bucket,
        backend=backend,
        seconds=seconds,
        epochs=epochs,
    )


def dispatch_snapshot() -> dict:
    """The process dispatch table, serialized ({} when nothing has
    dispatched) — what flight-bundle metrics lines carry as
    ``dispatch_sketches``."""
    return _DISPATCH_STATS.snapshot()

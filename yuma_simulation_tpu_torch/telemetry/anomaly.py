"""Robust anomaly detectors over :mod:`.timeseries` series.

Design rule: every detector declares its window and a minimum sample
count and stays SILENT until both are met, so a clean run is provably
quiet (zero firings on unfaulted traffic). Detectors are stateful scanners — each
remembers how far into a series it has read and whether it is latched
inside an excursion, so a sustained level shift fires ONCE and the
baseline reseeds after recovery instead of alarming every sample.

The four families:

- :class:`MadDetector` — rolling median/MAD deviation: a sample firing
  means ``|v - median| > threshold * max(MAD, mad_floor)`` against the
  trailing window. Median/MAD (not mean/stddev) so a single prior
  outlier cannot inflate the baseline and mask the next one.
- :class:`RateOfChangeDetector` — per-second slope between adjacent
  samples beyond a declared ceiling.
- :class:`CounterStallDetector` — a cumulative counter frozen for a
  declared wall-clock horizon while a companion activity counter keeps
  advancing (progress stopped, process alive).
- :class:`SaturationDetector` — a gauge pinned at/above a fraction of
  its declared capacity for ``min_samples`` consecutive samples.

Detectors return typed :class:`Anomaly` values; the runtime engine
(:mod:`.incident`) ledgers them as ``anomaly_detected`` records. All
host-side, zero compiles.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Optional

from yuma_simulation_tpu_torch.telemetry.timeseries import TimeSeriesStore


def _fresh_samples(
    store: TimeSeriesStore, key: str, last: Optional[tuple]
) -> tuple:
    """``(samples, cursor)``: the samples of `key` strictly after the
    ``(t, order)`` identity `last`, and the advanced cursor. Cursoring
    is by sample IDENTITY, never by index into the series — the store's
    rings evict once full, so an index cursor pins at ``len(series)``
    forever and the detector goes silently blind in exactly the
    long-running regime it exists for."""
    samples = store.samples(key)
    if last is not None:
        samples = tuple(s for s in samples if (s[0], s[1]) > last)
    if not samples:
        return (), last
    return samples, (samples[-1][0], samples[-1][1])


@dataclasses.dataclass(frozen=True)
class Anomaly:
    """One detector firing on one series sample."""

    kind: str  #: detector family: mad / rate_of_change / counter_stall / saturation
    series: str  #: the time-series key scanned
    t: float  #: wall clock of the offending sample
    value: float  #: the offending sample's value
    baseline: float  #: what the detector expected (median, prior, cap)
    threshold: float  #: the declared bound the sample exceeded
    window: int  #: declared window (samples or seconds, per kind)
    detail: str = ""  #: one human line of context

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class MadDetector:
    """Rolling median/MAD excursion detector with a one-shot latch.

    ``mad_floor`` is the robustness escape hatch for near-constant
    series: a series that sat at exactly 0.0 for the whole window has
    MAD 0, and without a floor ANY change would fire — the floor is the
    smallest deviation worth calling anomalous at all."""

    kind = "mad"

    def __init__(
        self,
        series: str,
        *,
        window: int = 32,
        min_samples: int = 12,
        threshold: float = 8.0,
        mad_floor: float = 1.0,
    ):
        if min_samples < 4 or window < min_samples:
            raise ValueError(
                f"need window >= min_samples >= 4, got "
                f"window={window} min_samples={min_samples}"
            )
        self.series = series
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.threshold = float(threshold)
        self.mad_floor = float(mad_floor)
        self._baseline: list[float] = []
        self._last: Optional[tuple] = None
        self._latched = False

    def observe(self, t: float, value: float) -> Optional[Anomaly]:
        """Feed one sample (in series order); an :class:`Anomaly` back
        iff this sample opens a NEW excursion."""
        if len(self._baseline) < self.min_samples:
            self._baseline.append(value)
            return None
        med = statistics.median(self._baseline)
        mad = statistics.median(abs(v - med) for v in self._baseline)
        bound = self.threshold * max(mad, self.mad_floor)
        excursion = abs(value - med) > bound
        if not excursion:
            # Recovered (or never deviated): the sample joins the
            # baseline and any latch releases — the NEXT excursion is a
            # new incident, judged against a reseeded window.
            self._baseline.append(value)
            if len(self._baseline) > self.window:
                del self._baseline[: len(self._baseline) - self.window]
            self._latched = False
            return None
        # Excursion sample: deliberately NOT folded into the baseline —
        # a sustained shift must not normalize itself into silence
        # before a recovery was ever seen.
        if self._latched:
            return None
        self._latched = True
        return Anomaly(
            kind=self.kind,
            series=self.series,
            t=t,
            value=value,
            baseline=med,
            threshold=bound,
            window=self.window,
            detail=f"|{value:.6g} - median {med:.6g}| > {bound:.6g} "
            f"({self.threshold:g} x MAD)",
        )

    def scan(self, store: TimeSeriesStore) -> list[Anomaly]:
        out = []
        fresh, self._last = _fresh_samples(store, self.series, self._last)
        for t, _order, v in fresh:
            a = self.observe(t, v)
            if a is not None:
                out.append(a)
        return out


class RateOfChangeDetector:
    """Adjacent-sample slope beyond ``max_per_second``, latched per
    excursion like :class:`MadDetector`."""

    kind = "rate_of_change"

    def __init__(
        self,
        series: str,
        *,
        max_per_second: float,
        min_samples: int = 4,
    ):
        if max_per_second <= 0:
            raise ValueError("max_per_second must be positive")
        self.series = series
        self.max_per_second = float(max_per_second)
        self.min_samples = int(min_samples)
        self._last: Optional[tuple] = None
        self._prev: Optional[tuple] = None
        self._seen = 0
        self._latched = False

    def observe(self, t: float, value: float) -> Optional[Anomaly]:
        prev, self._prev = self._prev, (t, value)
        self._seen += 1
        if prev is None or self._seen <= self.min_samples:
            return None
        dt = t - prev[0]
        if dt <= 0:
            return None
        rate = abs(value - prev[1]) / dt
        if rate <= self.max_per_second:
            self._latched = False
            return None
        if self._latched:
            return None
        self._latched = True
        return Anomaly(
            kind=self.kind,
            series=self.series,
            t=t,
            value=value,
            baseline=prev[1],
            threshold=self.max_per_second,
            window=self.min_samples,
            detail=f"rate {rate:.6g}/s > {self.max_per_second:g}/s",
        )

    def scan(self, store: TimeSeriesStore) -> list[Anomaly]:
        out = []
        fresh, self._last = _fresh_samples(store, self.series, self._last)
        for t, _order, v in fresh:
            a = self.observe(t, v)
            if a is not None:
                out.append(a)
        return out


class CounterStallDetector:
    """A cumulative counter frozen for ``horizon_seconds`` of samples
    while the activity counter advanced by at least ``min_activity`` —
    distinguishes "progress stopped" from "nothing was asked". Fires
    once per freeze; reseeds when the target advances again.

    NOT wired by default anywhere: a stall pair is an explicit claim
    about two specific counters, so callers opt series pairs in."""

    kind = "counter_stall"

    def __init__(
        self,
        series: str,
        activity_series: str,
        *,
        horizon_seconds: float = 30.0,
        min_activity: float = 1.0,
    ):
        self.series = series
        self.activity_series = activity_series
        self.horizon_seconds = float(horizon_seconds)
        self.min_activity = float(min_activity)
        self._latched = False

    def scan(self, store: TimeSeriesStore) -> list[Anomaly]:
        target = store.series(self.series)
        activity = store.series(self.activity_series)
        if not target or not activity:
            return []
        t_now, v_now = target[-1]
        frozen_since = t_now
        for t, v in reversed(target):
            if v != v_now:
                break
            frozen_since = t
        frozen_for = t_now - frozen_since
        moved = self._activity_delta(activity, frozen_since)
        stalled = (
            frozen_for >= self.horizon_seconds
            and moved >= self.min_activity
        )
        if not stalled:
            self._latched = False
            return []
        if self._latched:
            return []
        self._latched = True
        return [
            Anomaly(
                kind=self.kind,
                series=self.series,
                t=t_now,
                value=v_now,
                baseline=v_now,
                threshold=self.horizon_seconds,
                window=int(self.horizon_seconds),
                detail=f"frozen {frozen_for:.1f}s at {v_now:.6g} while "
                f"{self.activity_series} advanced {moved:.6g}",
            )
        ]

    def _activity_delta(self, activity, since_t: float) -> float:
        baseline = None
        for t, v in activity:
            if t <= since_t:
                baseline = v
        if baseline is None:
            baseline = activity[0][1]
        return activity[-1][1] - baseline


class SaturationDetector:
    """Gauge pinned at/above ``high_fraction * capacity`` for
    ``min_samples`` consecutive samples; fires once per saturation."""

    kind = "saturation"

    def __init__(
        self,
        series: str,
        *,
        capacity: float,
        high_fraction: float = 0.95,
        min_samples: int = 3,
    ):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.series = series
        self.capacity = float(capacity)
        self.high_fraction = float(high_fraction)
        self.min_samples = int(min_samples)
        self._last: Optional[tuple] = None
        self._run = 0
        self._latched = False

    def scan(self, store: TimeSeriesStore) -> list[Anomaly]:
        out = []
        bound = self.high_fraction * self.capacity
        fresh, self._last = _fresh_samples(store, self.series, self._last)
        for t, _order, v in fresh:
            if v >= bound:
                self._run += 1
                if self._run >= self.min_samples and not self._latched:
                    self._latched = True
                    out.append(
                        Anomaly(
                            kind=self.kind,
                            series=self.series,
                            t=t,
                            value=v,
                            baseline=self.capacity,
                            threshold=bound,
                            window=self.min_samples,
                            detail=f"{v:.6g} >= {bound:.6g} "
                            f"({self.high_fraction:.0%} of capacity "
                            f"{self.capacity:g}) for {self._run} samples",
                        )
                    )
            else:
                self._run = 0
                self._latched = False
        return out


class AnomalyEngine:
    """A set of detectors scanned together against one store. Purely a
    container — the incident engine (:mod:`.incident`) owns ledgering
    what this returns."""

    def __init__(self, detectors=()):
        self.detectors = list(detectors)

    def add(self, detector) -> "AnomalyEngine":
        self.detectors.append(detector)
        return self

    def scan(self, store: TimeSeriesStore) -> list[Anomaly]:
        out: list[Anomaly] = []
        for d in self.detectors:
            out.extend(d.scan(store))
        out.sort(key=lambda a: a.t)
        return out


def default_replay_engine() -> AnomalyEngine:
    """The controller's default wiring: deliberately conservative — one
    MAD detector on the freshness gauge (the SIGKILL/stall symptom
    surface). Everything else is opt-in per deployment; a default that
    fires on healthy soak traffic would poison the clean-run bound."""
    return AnomalyEngine(
        [
            MadDetector(
                "gauge:replay_staleness_seconds",
                window=64,
                min_samples=12,
                threshold=8.0,
                mad_floor=2.0,
            ),
        ]
    )

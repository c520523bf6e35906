"""Bounded time-series store over the metric snapshot stream.

The flight bundle already persists everything a time series needs: each
``metrics.jsonl`` line is one cumulative registry snapshot (counters /
gauges / histograms + the ``dispatch_sketches`` meta), stamped with a
wall clock ``t`` and a monotone per-process ``seq``.
This module is the READ side: fold those lines into bounded per-key
rings of ``(t, seq, value)`` samples that the anomaly detectors
(:mod:`.anomaly`) scan. There is deliberately no new on-disk sink —
the snapshot stream IS the persistence, so the store rebuilds
identically from a live registry feed, a monolithic bundle, or any
merge of rotated segments.

Order independence: samples are deduplicated by ``(source, seq)`` (the
snapshot's producing process x its monotone counter) and read back
sorted by ``(t, seq)``, so ingesting router/worker/controller bundles
in any interleaving yields the same series. Records without ``seq``
fall back to identity by ``(source, t)`` — cumulative snapshots
make a dropped duplicate harmless.

Series keys are namespaced by signal family:

- ``counter:<name>`` / ``gauge:<name>`` — registry scalars
  (epoch rates, queue depth, shed/reroute counters,
  ``replay_staleness_seconds``, ...);
- ``sketch:<key>:p50`` / ``sketch:<key>:p99`` — headline quantiles of
  each dispatch :class:`..slo.LatencySketch` entry riding the
  snapshot's ``dispatch_sketches`` meta.

Everything here is host-side plain Python: zero compiles, no reads
from traced code.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Iterable, Optional

#: Default per-key ring capacity. Soak-scale runs snapshot once per
#: controller cycle (~1/s), so 512 samples is minutes of history —
#: far beyond any detector window — at a few KiB per key.
DEFAULT_CAPACITY = 512

def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) and \
        math.isfinite(float(v))


class TimeSeriesStore:
    """Bounded per-key rings of ``(t, seq, value)`` samples folded from
    metric snapshot records (live or bundle-loaded)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.capacity = int(capacity)
        self._series: dict[str, deque] = {}
        self._seen: set[tuple] = set()
        #: bounds the dedupe set alongside the rings.
        self._seen_order: deque = deque()

    # -- ingest ----------------------------------------------------------

    def ingest_snapshot(self, record: dict, *, source: str = "") -> bool:
        """Fold one ``metrics.jsonl``-shaped snapshot record into the
        rings. Returns False (a no-op) when the ``(source, seq)``
        identity was already ingested — merge-replay safe."""
        if not isinstance(record, dict):
            return False
        t = record.get("t")
        if not _is_number(t):
            return False
        seq = record.get("seq")
        src = source or str(record.get("source") or record.get("run_id") or "")
        ident = (src, int(seq)) if _is_number(seq) else (src, float(t))
        if ident in self._seen:
            return False
        self._seen.add(ident)
        self._seen_order.append(ident)
        # Bound the identity set: capacity samples per seen key is the
        # most the rings retain, so remembering ~8x that many identities
        # keeps replay-dedupe exact for everything still in a ring.
        max_seen = self.capacity * 8
        while len(self._seen_order) > max_seen:
            self._seen.discard(self._seen_order.popleft())
        order = float(seq) if _is_number(seq) else float(t)
        for family in ("counters", "gauges"):
            block = record.get(family)
            if not isinstance(block, dict):
                continue
            prefix = "counter:" if family == "counters" else "gauge:"
            for name, value in block.items():
                if _is_number(value):
                    self._push(prefix + str(name), float(t), order,
                               float(value))
        sketches = record.get("dispatch_sketches")
        if isinstance(sketches, dict):
            self._ingest_sketches(sketches, float(t), order)
        return True

    def _ingest_sketches(self, sketches: dict, t: float, order: float) -> None:
        from yuma_simulation_tpu_torch.telemetry.slo import LatencySketch

        for key, entry in sketches.items():
            if not isinstance(entry, dict):
                continue
            rec = entry.get("sketch")
            if not isinstance(rec, dict):
                continue
            try:
                sk = LatencySketch.from_json(rec)
                p50 = sk.quantile(0.5)
                p99 = sk.quantile(0.99)
            except Exception:
                continue
            if p50 is not None:
                self._push(f"sketch:{key}:p50", t, order, float(p50))
            if p99 is not None:
                self._push(f"sketch:{key}:p99", t, order, float(p99))

    def _push(self, key: str, t: float, order: float, value: float) -> None:
        ring = self._series.get(key)
        if ring is None:
            ring = deque(maxlen=self.capacity)
            self._series[key] = ring
        ring.append((t, order, value))

    def ingest_many(self, records: Iterable[dict], *,
                    source: str = "") -> int:
        """Fold a batch of snapshot records; returns how many were new."""
        return sum(
            1 for r in records if self.ingest_snapshot(r, source=source)
        )

    # -- read ------------------------------------------------------------

    def keys(self) -> tuple:
        return tuple(sorted(self._series))

    def series(self, key: str) -> tuple:
        """``((t, value), ...)`` for `key`, sorted by ``(t, seq)`` —
        the order-independent read surface."""
        return tuple((t, v) for t, _order, v in self.samples(key))

    def samples(self, key: str) -> tuple:
        """``((t, order, value), ...)`` for `key`, sorted by
        ``(t, order)``. The read surface for stateful scanners: a ring
        EVICTS once full, so an index into :meth:`series` stops
        advancing the moment old samples fall off — ``(t, order)`` is a
        per-sample identity a cursor can compare against instead."""
        ring = self._series.get(key)
        if not ring:
            return ()
        return tuple(sorted(ring, key=lambda s: (s[0], s[1])))

    def latest(self, key: str) -> Optional[tuple]:
        s = self.series(key)
        return s[-1] if s else None

    def __len__(self) -> int:
        return len(self._series)


def store_from_metrics(
    records: Iterable[dict],
    *,
    capacity: int = DEFAULT_CAPACITY,
    source: str = "",
) -> TimeSeriesStore:
    """Rebuild a store from bundle ``metrics`` records (the offline
    twin of the live feed): ``store_from_metrics(load_bundle(d).metrics)``."""
    store = TimeSeriesStore(capacity=capacity)
    store.ingest_many(records, source=source)
    return store

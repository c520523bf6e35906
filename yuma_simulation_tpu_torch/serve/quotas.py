"""Per-tenant token buckets + the global bounded run queue.

The backpressure half of the serving tier's robustness spine: a burst of
hostile (or merely enthusiastic) traffic must shed load with a typed
:class:`..resilience.errors.QueueOverflow` — surfaced as ``429`` +
``Retry-After`` — instead of growing an unbounded backlog that takes the
whole process down. Two bounds, checked in order:

- **tenant quota** (:class:`TenantQuotas`): a token bucket per tenant
  (`burst` capacity, `rate` tokens/second refill), so one tenant's
  flood cannot starve the others — the rejected tenant's
  ``retry_after`` is exactly the time until its next token;
- **global run queue** (:class:`BoundedRunQueue`): a hard bound on
  admitted-but-undispatched work; at the bound, new requests shed with
  a ``retry_after`` scaled to the queue's current drain estimate.

Both feed the metrics registry (``serve_queue_depth`` gauge,
``serve_requests_shed`` counter) so overload is visible on `/metrics`
while it is happening, not after. Clocks are injectable for
deterministic tests; everything is thread-safe (handlers run on the
HTTP server's per-connection threads).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Optional

from yuma_simulation_tpu_torch.resilience.errors import QueueOverflow


class TokenBucket:
    """A classic token bucket: `burst` capacity, `rate` tokens/second.

    :meth:`try_acquire` returns 0.0 when a token was taken, else the
    seconds until one becomes available (the client's ``Retry-After``).
    `rate=0` makes the bucket non-refilling — `burst` requests total,
    then permanent shed (drill configurations)."""

    def __init__(
        self,
        rate: float,
        burst: int,
        clock: Callable[[], float] = time.monotonic,
    ):
        if burst < 1:
            raise ValueError("TokenBucket burst must be >= 1")
        if rate < 0:
            raise ValueError("TokenBucket rate must be >= 0")
        self.rate = float(rate)
        self.burst = int(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._stamp = clock()
        self._lock = threading.Lock()

    def try_acquire(self) -> float:
        with self._lock:
            now = self._clock()
            if self.rate > 0:
                self._tokens = min(
                    float(self.burst),
                    self._tokens + (now - self._stamp) * self.rate,
                )
            self._stamp = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return 0.0
            if self.rate <= 0:
                # Non-refilling bucket: "try again much later" rather
                # than a divide-by-zero or a lying small number.
                return 60.0
            return (1.0 - self._tokens) / self.rate


class TenantQuotas:
    """Get-or-create a :class:`TokenBucket` per tenant and admit through
    it. `overrides` maps tenant -> (rate, burst) for tenants with
    negotiated quotas; everyone else shares the default shape (each
    tenant still gets its OWN bucket — the default is a shape, not a
    shared pool).

    The bucket table is BOUNDED (`max_tenants`, LRU eviction of
    non-override tenants): tenant is a free-form request field, and a
    hostile client minting a fresh tenant per request must not grow the
    long-lived service's memory without bound. Evicting an idle bucket
    merely resets that tenant to a full burst — a small quota give-away
    under active eviction pressure, never a shed of legitimate work."""

    def __init__(
        self,
        rate: float = 20.0,
        burst: int = 10,
        overrides: Optional[dict] = None,
        clock: Callable[[], float] = time.monotonic,
        max_tenants: int = 10_000,
    ):
        if max_tenants < 1:
            raise ValueError("max_tenants must be >= 1")
        self.rate = rate
        self.burst = burst
        self.overrides = dict(overrides or {})
        self.max_tenants = max_tenants
        self._clock = clock
        self._buckets: collections.OrderedDict[str, TokenBucket] = (
            collections.OrderedDict()
        )
        self._lock = threading.Lock()

    def bucket(self, tenant: str) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                rate, burst = self.overrides.get(
                    tenant, (self.rate, self.burst)
                )
                b = TokenBucket(rate, burst, clock=self._clock)
                self._buckets[tenant] = b
                while len(self._buckets) > self.max_tenants:
                    # Oldest-used first; negotiated-override tenants are
                    # pinned (their quota state must survive a flood).
                    for victim in self._buckets:
                        if victim not in self.overrides:
                            del self._buckets[victim]
                            break
                    else:
                        break
            else:
                self._buckets.move_to_end(tenant)
            return b

    def admit(self, tenant: str) -> None:
        """Take one token for `tenant` or raise a typed
        :class:`QueueOverflow` carrying the exact refill wait."""
        wait = self.bucket(tenant).try_acquire()
        if wait > 0:
            raise QueueOverflow(
                f"tenant {tenant!r} exceeded its request quota; "
                f"retry in {wait:.2f}s",
                retry_after=wait,
            )


class BoundedRunQueue:
    """The global admitted-work queue, bounded hard.

    A plain deque + condition (not `queue.Queue`) so the dispatcher can
    take items selectively (the coalescer peeks for bucket-mates) and
    the depth gauge updates under the same lock as the mutation.
    `put()` never blocks: at the bound it raises a typed
    :class:`QueueOverflow` whose ``retry_after`` is the current depth
    times `drain_estimate_seconds` (a deliberately simple model — the
    point is a monotone, honest signal, not a scheduler)."""

    def __init__(
        self,
        limit: int,
        *,
        drain_estimate_seconds: float = 0.25,
        registry=None,
    ):
        if limit < 1:
            raise ValueError("BoundedRunQueue limit must be >= 1")
        self.limit = int(limit)
        self.drain_estimate_seconds = drain_estimate_seconds
        self._items: Deque = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        if registry is None:
            from yuma_simulation_tpu_torch.telemetry.metrics import get_registry

            registry = get_registry()
        self._depth_gauge = registry.gauge(
            "serve_queue_depth", help="serving run-queue occupancy"
        )
        self._shed_counter = registry.counter(
            "serve_requests_shed",
            help="requests shed with 429 (tenant quota or queue bound)",
        )

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def record_shed(self) -> None:
        """Count a shed that happened upstream of the queue (tenant
        quota, overload drill) on the same ``serve_requests_shed``
        series — one counter for every 429, wherever it was decided."""
        self._shed_counter.inc()

    def put(self, item) -> None:
        with self._lock:
            if len(self._items) >= self.limit:
                depth = len(self._items)
                self._shed_counter.inc()
                raise QueueOverflow(
                    f"run queue at its bound ({depth}/{self.limit}); "
                    "shedding",
                    retry_after=max(
                        self.drain_estimate_seconds,
                        depth * self.drain_estimate_seconds,
                    ),
                    queue_depth=depth,
                )
            self._items.append(item)
            self._depth_gauge.set(len(self._items))
            self._not_empty.notify()

    def get(self, timeout: Optional[float] = None):
        """Pop the oldest item, waiting up to `timeout`; None on
        timeout (the dispatcher's idle tick)."""
        with self._lock:
            if not self._items:
                self._not_empty.wait(timeout)
            if not self._items:
                return None
            item = self._items.popleft()
            self._depth_gauge.set(len(self._items))
            return item

    def take_matching(self, predicate, limit: Optional[int] = None) -> list:
        """Remove and return up to `limit` queued items satisfying
        `predicate` (queue order preserved; items beyond the limit stay
        queued) — the coalescer's bucket-mate sweep."""
        with self._lock:
            taken = []
            for i in self._items:
                if limit is not None and len(taken) >= limit:
                    break
                if predicate(i):
                    taken.append(i)
            if taken:
                for i in taken:
                    self._items.remove(i)
                self._depth_gauge.set(len(self._items))
            return taken

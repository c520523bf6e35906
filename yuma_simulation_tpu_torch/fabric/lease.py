"""Lease-based work-unit claiming over a shared filesystem store.

The fleet scheduler (:mod:`.scheduler`) coordinates hosts through files
only — no coordinator process, no RPC: any filesystem every host can
see (NFS/GCS-fuse on a pod, a plain tmpdir under multiprocess CI) is
the whole control plane. The primitives:

- **Claim** — one lease file per work unit (``leases/unit_NNNNN.lease``).
  Claiming hard-links a fully-written, fsync'd temp file onto the lease
  name: `os.link` fails with ``EEXIST`` if any other host holds the
  name, so exactly one host wins and a reader never observes a partial
  claim (the link publishes complete bytes atomically — the same
  all-or-nothing contract as :func:`..utils.checkpoint.publish_atomic`,
  which the store uses for every other sidecar).
- **Heartbeat** — the holder renews by bumping the lease file's mtime
  (`os.utime`) after verifying it still owns the file (inode identity).
  Liveness is therefore a property of the FILE, not of any connection:
  a SIGKILLed host simply stops renewing.
- **Expiry & steal** — a lease whose mtime is older than the TTL (or
  whose content is torn/unparseable — shared-store corruption must not
  gate work forever) is *stealable*. The stealer atomically renames the
  dead claim to a tombstone (``stale_unit_NNNNN.<nonce>``): rename is
  atomic and the name exists once, so exactly one stealer retires it;
  the loser sees ``ENOENT`` and backs off. The tombstones double as the
  unit's durable steal history — the claim *generation* is their count.
- **Abandon** — a holder whose renewal finds a different inode (or no
  file) under its lease name raises the typed
  :class:`..resilience.errors.LeaseExpired`; the unit now belongs to a
  stealer and the polite (and pointless-to-race, results being
  content-addressed and deterministic) move is to walk away without
  publishing.

Clock note: expiry compares the reader's `time.time()` against the
lease's mtime as stamped by the writer's kernel. On one machine (the
CI drills) these are the same clock; on a real shared store, keep the
TTL an order of magnitude above plausible host clock skew.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pathlib
import time
import uuid
from typing import Callable, Optional

from yuma_simulation_tpu_torch.resilience.errors import LeaseExpired
from yuma_simulation_tpu_torch.utils.checkpoint import _fsync_dir, _fsync_write
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

#: Default lease TTL: long enough that a healthy host's heartbeat (TTL/3)
#: never lapses under GC pauses or a slow shared store, short enough
#: that a dead host's units requeue within one unit's compute time.
DEFAULT_TTL_SECONDS = 15.0


@dataclasses.dataclass(frozen=True)
class LeaseInfo:
    """One observed lease file (a scan-time snapshot, not a handle)."""

    unit: int
    host: str
    mtime: float
    #: content was unparseable (truncated/corrupt claim record).
    torn: bool
    #: the observed file's inode — the claim's identity. A steal only
    #: retires the claim it OBSERVED expired (re-checked immediately
    #: before the tombstone rename), so a stale scan snapshot cannot
    #: tombstone a rival stealer's fresh claim.
    inode: int = 0


@dataclasses.dataclass(frozen=True)
class ClaimedLease:
    """A lease THIS store instance holds: the identity the renewal and
    release paths verify (`inode`), plus the claim's steal generation
    (0 = first claim of the unit) and, for stolen units, the host whose
    expired/torn claim was retired."""

    unit: int
    inode: int
    generation: int
    stolen_from: str = ""


class LeaseStore:
    """Per-host view of the shared lease directory. One instance per
    (host, fleet run); holds the inode identities of its own claims.

    `_pause` is a test-only interleaving hook: called with a stage name
    (``"read"``, ``"steal"``, ``"link"``) between the protocol's atomic
    steps so the race-property tests can schedule adversarial
    interleavings deterministically. A no-op in production.
    """

    def __init__(
        self,
        directory: str | pathlib.Path,
        host_id: str,
        *,
        ttl_seconds: float = DEFAULT_TTL_SECONDS,
    ):
        if ttl_seconds <= 0:
            raise ValueError("ttl_seconds must be > 0")
        self.directory = pathlib.Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.host_id = host_id
        self.ttl_seconds = float(ttl_seconds)
        self._held: dict[int, ClaimedLease] = {}
        self._pause: Callable[[str], None] = lambda stage: None

    # -- paths ----------------------------------------------------------

    def lease_path(self, unit: int) -> pathlib.Path:
        return self.directory / f"unit_{unit:05d}.lease"

    def _tombstones(self, unit: int) -> list[pathlib.Path]:
        return sorted(self.directory.glob(f"stale_unit_{unit:05d}.*"))

    def generation(self, unit: int) -> int:
        """The unit's steal generation so far (= tombstone count): 0
        means the unit has never been stolen."""
        return len(self._tombstones(unit))

    # -- observation ----------------------------------------------------

    def read(self, unit: int) -> Optional[LeaseInfo]:
        """The unit's current lease as observed on disk, or None when
        unclaimed. A torn claim record (truncated JSON — shared-store
        corruption, or a `LeaseTearFault` drill) loads as
        ``torn=True`` rather than raising: scanners must treat it as
        stealable, never as a crash."""
        path = self.lease_path(unit)
        try:
            st = os.stat(path)
        except FileNotFoundError:
            return None
        host, torn = "", True
        try:
            data = json.loads(path.read_text())
            if isinstance(data, dict):
                host, torn = str(data.get("host", "")), False
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, OSError, UnicodeDecodeError):
            pass
        return LeaseInfo(
            unit=unit,
            host=host,
            mtime=st.st_mtime,
            torn=torn,
            inode=st.st_ino,
        )

    def is_stealable(self, info: LeaseInfo, now: Optional[float] = None) -> bool:
        """Whether `info`'s claim no longer protects its unit: the
        holder stopped heartbeating past the TTL, or the claim record
        itself is torn (an unparseable claim cannot be trusted to gate
        work, whatever its mtime says)."""
        if info.torn:
            return True
        now = time.time() if now is None else now
        return (now - info.mtime) > self.ttl_seconds

    # -- the claim protocol ---------------------------------------------

    def try_claim(self, unit: int) -> Optional[ClaimedLease]:
        """Attempt to claim `unit`. Returns the held lease, or None when
        another host holds a live claim (or won the race). Expired/torn
        claims are stolen: retired to a tombstone first (atomic rename —
        exactly one stealer succeeds), then claimed fresh."""
        path = self.lease_path(unit)
        self._pause("read")
        info = self.read(unit)
        stolen_from = ""
        if info is not None:
            if not self.is_stealable(info):
                return None
            tomb = self.directory / (
                f"stale_unit_{unit:05d}.{uuid.uuid4().hex[:8]}"
            )
            self._pause("steal")
            try:
                # Retire only the claim we OBSERVED expired: if the
                # inode under the lease name changed since our read, a
                # rival stealer already retired it and claimed fresh —
                # renaming now would tombstone a LIVE claim.
                if os.stat(path).st_ino != info.inode:
                    return None
                os.rename(path, tomb)
            except FileNotFoundError:
                # Another stealer retired this claim first; its fresh
                # lease is (or is about to be) live — back off.
                return None
            _fsync_dir(self.directory)
            stolen_from = info.host
            log_event(
                logger,
                "lease_stolen",
                unit=unit,
                prior_host=stolen_from or ("<torn>" if info.torn else "?"),
                torn=info.torn,
                by=self.host_id,
            )
        record = {
            "unit": unit,
            "host": self.host_id,
            "claimed_at": round(time.time(), 6),
        }
        # The claim carries the claimer's trace identity (additive —
        # old readers only look at "host"): a lease on disk names not
        # just WHO holds the unit but which distributed trace the work
        # lands in, so a stuck claim is greppable back to its sweep.
        try:
            from yuma_simulation_tpu_torch.telemetry.propagation import (
                current_trace_context,
            )

            ctx = current_trace_context()
            if ctx is not None:
                record["trace"] = ctx.to_traceparent()
        except Exception:
            pass  # propagation must never break claiming
        payload = json.dumps(record, sort_keys=True).encode()
        tmp = self.directory / (
            f".claim.{self.host_id}.{uuid.uuid4().hex[:8]}.tmp"
        )
        _fsync_write(tmp, lambda f: f.write(payload))
        self._pause("link")
        try:
            os.link(tmp, path)
            inode = os.stat(tmp).st_ino
        except FileExistsError:
            return None
        finally:
            tmp.unlink(missing_ok=True)
        _fsync_dir(self.directory)
        # Generation is counted AFTER the link: any tombstone that
        # exists by now was retired before our claim could succeed, so
        # the count is exact even when a rival stealer did the retiring.
        claim = ClaimedLease(
            unit=unit,
            inode=inode,
            generation=self.generation(unit),
            stolen_from=stolen_from,
        )
        self._held[unit] = claim
        return claim

    def renew(self, unit: int) -> None:
        """Heartbeat: refresh the held lease's mtime. Raises the typed
        :class:`LeaseExpired` when the lease name no longer carries OUR
        claim (stolen after expiry or tear) — the holder must abandon
        the unit without publishing."""
        held = self._held.get(unit)
        if held is None:
            raise LeaseExpired(
                f"host {self.host_id} holds no lease for unit {unit}",
                unit=unit,
            )
        path = self.lease_path(unit)
        try:
            st = os.stat(path)
            if st.st_ino != held.inode:
                raise FileNotFoundError
            os.utime(path)
        except FileNotFoundError:
            self._held.pop(unit, None)
            usurper = self.read(unit)
            raise LeaseExpired(
                f"unit {unit} lease lost by {self.host_id} (stolen by "
                f"{usurper.host if usurper else '<nobody yet>'})",
                unit=unit,
                holder=usurper.host if usurper else None,
            ) from None
        # Deterministic drill hook: tear our OWN live lease after N
        # renewals (shared-store corruption simulation).
        from yuma_simulation_tpu_torch.resilience import faults

        faults.maybe_tear_lease(path, unit)

    def still_owner(self, unit: int) -> bool:
        """Whether this host still holds `unit`'s lease (a renew that
        swallows the typed failure — the pre-publish ownership check)."""
        try:
            self.renew(unit)
        except LeaseExpired:
            return False
        return True

    def release(self, unit: int) -> None:
        """Drop the held lease after its result is published. Only
        removes the file while it still carries OUR claim (inode
        check); a stolen lease belongs to the stealer and stays. The
        annotation sidecar (if any) goes with it — an advertisement
        must never outlive the claim it describes."""
        held = self._held.pop(unit, None)
        if held is None:
            return
        path = self.lease_path(unit)
        try:
            if os.stat(path).st_ino == held.inode:
                path.unlink(missing_ok=True)
                self.annotation_path(unit).unlink(missing_ok=True)
        except FileNotFoundError:
            pass

    # -- heartbeat annotations -------------------------------------------

    def annotation_path(self, unit: int) -> pathlib.Path:
        return self.directory / f"unit_{unit:05d}.ad.json"

    def annotate(self, unit: int, payload: dict) -> None:
        """Publish a heartbeat ADVERTISEMENT beside the held lease: an
        arbitrary JSON payload (atomic tmp+rename, torn-read safe) a
        scanner can pair with the lease's liveness (the JAX package's
        serve tier advertises each worker's warm state here, scored only
        while :meth:`read` + :meth:`is_stealable` say the slot lease is
        live, so a dead worker's stale ad never wins). Raises the typed
        :class:`LeaseExpired` when the lease is no longer ours:
        advertising for a stolen slot would point the router at a
        usurped identity."""
        held = self._held.get(unit)
        if held is None:
            raise LeaseExpired(
                f"host {self.host_id} holds no lease for unit {unit}",
                unit=unit,
            )
        record = dict(payload)
        record.setdefault("host", self.host_id)
        record.setdefault("unit", unit)
        tmp = self.directory / (
            f".ad.{self.host_id}.{uuid.uuid4().hex[:8]}.tmp"
        )
        data = json.dumps(record, sort_keys=True).encode()
        _fsync_write(tmp, lambda f: f.write(data))
        os.replace(tmp, self.annotation_path(unit))

    def read_annotation(self, unit: int) -> Optional[dict]:
        """The unit's last advertisement, or None when absent/torn (a
        torn ad reads as None, never a crash — exactly like a torn
        lease record, shared-store writes can always be caught
        mid-rename)."""
        try:
            data = json.loads(self.annotation_path(unit).read_text())
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, OSError, UnicodeDecodeError):
            return None
        return data if isinstance(data, dict) else None

"""Per-subnet snapshot timelines: the chain-replay service's archive.

A timeline is an append-only sequence of metagraph snapshots of ONE
subnet at strictly increasing block heights — what an operator's
exporter publishes once per sampling interval and the replay tier
re-simulates forever. The on-disk layout under one archive root::

    <root>/
      subnet_<netuid>/
        timeline.json              # the ordered index (atomic publish)
        objects/<key>.npz          # content-addressed snapshot blobs

Every write rides :func:`..utils.checkpoint.publish_atomic` (temp +
fsync + rename + dir fsync), so a crash at any instant leaves either
the previous timeline or the new one — never a half-written index, and
never an index entry whose blob is missing (the blob publishes FIRST).
Blobs are content-addressed by the sha256 of their serialized bytes:
appending the same snapshot twice is an idempotent no-op, while a
different snapshot claiming an existing block height is a typed
:class:`ArchiveError` (chain history does not rewrite).

:func:`synthetic_timeline` seeds a deterministic timeline from the
foundry's :func:`..foundry.metagraph.synthetic_snapshot` generator —
what the CI replay drill and the tests run on, no network and no
fixture blobs. :func:`SnapshotArchive.window_scenario` compiles the
trailing window of a timeline into the epoch-varying dense
:class:`..scenarios.base.Scenario` every engine rung, ``plan_dispatch``
and the fleet/serve tiers consume unchanged — closing the seam
:mod:`..foundry.metagraph` left open ("replaying a snapshot SEQUENCE
is the chain-replay service's job").
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import logging
import os
import pathlib
from typing import Optional, Sequence, Union

import numpy as np

from yuma_simulation_tpu_torch.foundry.metagraph import (
    MetagraphSnapshot,
    SnapshotError,
    _check_snapshot,
    synthetic_snapshot,
)
from yuma_simulation_tpu_torch.scenarios.base import Scenario
from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

logger = logging.getLogger(__name__)

TIMELINE_FORMAT = "yuma-replay-timeline-v1"


class ArchiveError(ValueError):
    """A timeline operation that violates the archive contract
    (non-monotone block, shape drift mid-timeline, rewritten history,
    unknown subnet, corrupt index)."""


@dataclasses.dataclass(frozen=True)
class TimelineEntry:
    """One indexed snapshot: where it is and what shape it carries —
    enough for admission pricing without touching the blob."""

    block: int
    key: str  # sha256 of the serialized blob (content address)
    validators: int
    miners: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, payload: dict) -> "TimelineEntry":
        try:
            return cls(
                block=int(payload["block"]),
                key=str(payload["key"]),
                validators=int(payload["validators"]),
                miners=int(payload["miners"]),
            )
        except (KeyError, TypeError, ValueError) as exc:
            raise ArchiveError(f"corrupt timeline entry: {exc}") from None


def _serialize_snapshot(snap: MetagraphSnapshot) -> bytes:
    """Canonical npz bytes of one snapshot (dense — the blobs are the
    replay tier's working format, not the operator exchange format;
    sparse exports ingest through the foundry loader first)."""
    buf = io.BytesIO()
    np.savez(
        buf,
        netuid=np.int64(snap.netuid),
        block=np.int64(snap.block),
        stakes=snap.stakes,
        weights=snap.weights,
    )
    return buf.getvalue()


def _deserialize_snapshot(blob: bytes) -> MetagraphSnapshot:
    with np.load(io.BytesIO(blob)) as data:
        return MetagraphSnapshot(
            netuid=int(data["netuid"]),
            block=int(data["block"]),
            stakes=np.asarray(data["stakes"], np.float32),
            weights=np.asarray(data["weights"], np.float32),
        )


class SnapshotArchive:
    """The append-only per-subnet timeline store (module docstring)."""

    def __init__(self, root: Union[str, pathlib.Path]):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # -- layout ---------------------------------------------------------

    def _subnet_dir(self, netuid: int) -> pathlib.Path:
        return self.root / f"subnet_{int(netuid)}"

    def _timeline_path(self, netuid: int) -> pathlib.Path:
        return self._subnet_dir(netuid) / "timeline.json"

    def _blob_path(self, netuid: int, key: str) -> pathlib.Path:
        return self._subnet_dir(netuid) / "objects" / f"{key}.npz"

    # -- reads ----------------------------------------------------------

    def subnets(self) -> list[int]:
        """Netuids with a published timeline, ascending."""
        out = []
        for p in self.root.glob("subnet_*"):
            tail = p.name.split("_", 1)[1]
            if tail.isdigit() and (p / "timeline.json").exists():
                out.append(int(tail))
        return sorted(out)

    def timeline(self, netuid: int) -> list[TimelineEntry]:
        """The ordered index of one subnet (oldest first). Unknown
        subnet -> typed :class:`ArchiveError`."""
        path = self._timeline_path(netuid)
        if not path.exists():
            raise ArchiveError(
                f"no timeline for subnet {netuid} in {self.root}"
            )
        try:
            payload = json.loads(path.read_text(encoding="utf-8"))
        except json.JSONDecodeError as exc:
            raise ArchiveError(
                f"corrupt timeline index for subnet {netuid}: {exc}"
            ) from None
        if payload.get("format") != TIMELINE_FORMAT:
            raise ArchiveError(
                f"subnet {netuid}: timeline format "
                f"{payload.get('format')!r}, want {TIMELINE_FORMAT!r}"
            )
        return [TimelineEntry.from_json(e) for e in payload.get("entries", [])]

    def load(self, netuid: int, block: int) -> MetagraphSnapshot:
        """One archived snapshot by block height, digest-verified: a
        blob whose bytes no longer hash to its content address is
        corruption, surfaced as a typed error rather than NaNs in a
        consensus reduction."""
        entry = next(
            (e for e in self.timeline(netuid) if e.block == int(block)), None
        )
        if entry is None:
            raise ArchiveError(
                f"subnet {netuid} has no snapshot at block {block}"
            )
        path = self._blob_path(netuid, entry.key)
        try:
            blob = path.read_bytes()
        except OSError as exc:
            raise ArchiveError(
                f"subnet {netuid} block {block}: blob missing ({exc})"
            ) from None
        if hashlib.sha256(blob).hexdigest() != entry.key:
            raise ArchiveError(
                f"subnet {netuid} block {block}: blob bytes do not match "
                f"content address {entry.key[:16]} (corruption)"
            )
        return _check_snapshot(_deserialize_snapshot(blob))

    def latest(self, netuid: int) -> MetagraphSnapshot:
        entries = self.timeline(netuid)
        if not entries:
            raise ArchiveError(f"subnet {netuid} timeline is empty")
        return self.load(netuid, entries[-1].block)

    # -- append ---------------------------------------------------------

    @contextlib.contextmanager
    def _append_lock(self, netuid: int):
        """Serialize the append read-modify-write ACROSS PROCESSES: two
        racing appenders of different blocks would otherwise both read
        the same index and the second rename would silently drop the
        first's entry (lost update). One advisory `flock` per subnet —
        writers of different subnets never contend, readers never take
        it (the blob-before-index publish order already guarantees a
        reader mid-publish sees either the old index or a new entry
        whose blob exists). Held across the blob AND index publishes so
        the idempotent-re-append / history-rewrite checks race-free."""
        import fcntl

        subnet_dir = self._subnet_dir(netuid)
        subnet_dir.mkdir(parents=True, exist_ok=True)
        fd = os.open(
            subnet_dir / ".append.lock", os.O_CREAT | os.O_RDWR, 0o644
        )
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            # Closing the fd releases the flock.
            os.close(fd)

    def append(self, snap: MetagraphSnapshot) -> TimelineEntry:
        """Append one snapshot to its subnet's timeline under the
        archive contract: strictly monotone block heights, stable
        [V, M] shape, blob-before-index publish order, one appender at
        a time per subnet (cross-process advisory lock — racing
        appenders serialize instead of losing updates). Re-appending an
        identical (block, bytes) snapshot is an idempotent no-op."""
        try:
            _check_snapshot(snap)
        except SnapshotError as exc:
            raise ArchiveError(str(exc)) from None
        with self._append_lock(snap.netuid):
            return self._append_locked(snap)

    def _append_locked(self, snap: MetagraphSnapshot) -> TimelineEntry:
        entries = []
        if self._timeline_path(snap.netuid).exists():
            entries = self.timeline(snap.netuid)
        blob = _serialize_snapshot(snap)
        key = hashlib.sha256(blob).hexdigest()
        entry = TimelineEntry(
            block=int(snap.block),
            key=key,
            validators=snap.num_validators,
            miners=snap.num_miners,
        )
        if entries:
            existing = next(
                (e for e in entries if e.block == entry.block), None
            )
            if existing is not None:
                if existing.key == entry.key:
                    return existing  # idempotent re-publish
                raise ArchiveError(
                    f"subnet {snap.netuid}: block {entry.block} is already "
                    f"archived with different contents ({existing.key[:16]} "
                    f"vs {entry.key[:16]}; archived chain history does not "
                    "rewrite)"
                )
            last = entries[-1]
            if entry.block <= last.block:
                raise ArchiveError(
                    f"subnet {snap.netuid}: block {entry.block} does not "
                    f"extend the timeline (last block {last.block}; "
                    "archived chain history is append-only)"
                )
            if (entry.validators, entry.miners) != (
                last.validators,
                last.miners,
            ):
                raise ArchiveError(
                    f"subnet {snap.netuid}: snapshot shape "
                    f"[{entry.validators}, {entry.miners}] drifts from the "
                    f"timeline's [{last.validators}, {last.miners}] — a "
                    "re-shaped subnet starts a new archive root"
                )
        blob_path = self._blob_path(snap.netuid, key)
        blob_path.parent.mkdir(parents=True, exist_ok=True)
        # Blob first, index second: a crash between the two leaves an
        # unreferenced blob (harmless garbage), never an index entry
        # pointing at nothing.
        publish_atomic(blob_path, blob)
        payload = {
            "format": TIMELINE_FORMAT,
            "netuid": int(snap.netuid),
            "entries": [e.to_json() for e in entries + [entry]],
        }
        publish_atomic(
            self._timeline_path(snap.netuid),
            json.dumps(payload, sort_keys=True).encode(),
        )
        logger.info(
            "archived subnet %d block %d (%dx%d, %d entries)",
            snap.netuid,
            snap.block,
            entry.validators,
            entry.miners,
            len(entries) + 1,
        )
        return entry

    # -- replay compilation ---------------------------------------------

    def window_entries(
        self, netuid: int, *, window: Optional[int] = None
    ) -> list[TimelineEntry]:
        entries = self.timeline(netuid)
        if not entries:
            raise ArchiveError(f"subnet {netuid} timeline is empty")
        if window is not None:
            if window < 1:
                raise ArchiveError(f"window must be >= 1, got {window}")
            entries = entries[-window:]
        return entries

    def entries_after(self, netuid: int, block: int) -> list[TimelineEntry]:
        """Timeline entries strictly past ``block`` (oldest first) —
        the continuous-replay controller's suffix query: everything a
        durable watermark has not swept yet. Empty list when the
        timeline has nothing newer (a subnet being fully drained is the
        steady state, not an error)."""
        return [e for e in self.timeline(netuid) if e.block > int(block)]

    def scenario_for_blocks(
        self,
        netuid: int,
        blocks: Sequence[int],
        *,
        epochs_per_snapshot: int = 4,
    ) -> Scenario:
        """Compile an EXPLICIT ascending block list into the
        epoch-varying scenario (same normalization and epoch layout as
        :meth:`window_scenario`, which delegates here) — how the
        controller compiles a watermark-to-head suffix window, and how
        a joining fleet host reconstructs the identical scenario from a
        published window spec. The list may skip quarantined blocks:
        the compiled scenario covers exactly the blocks given, in
        order."""
        if epochs_per_snapshot < 1:
            raise ArchiveError(
                f"epochs_per_snapshot must be >= 1, got {epochs_per_snapshot}"
            )
        blocks = [int(b) for b in blocks]
        if not blocks:
            raise ArchiveError(
                f"subnet {netuid}: cannot compile an empty block list"
            )
        if blocks != sorted(set(blocks)):
            raise ArchiveError(
                f"subnet {netuid}: block list must be strictly ascending, "
                f"got {blocks}"
            )
        W_parts, S_parts = [], []
        for block in blocks:
            snap = self.load(netuid, block)
            row_sums = snap.weights.sum(axis=1, keepdims=True)
            W_n = np.divide(
                snap.weights,
                row_sums,
                out=np.zeros_like(snap.weights),
                where=row_sums > 0,
            ).astype(np.float32)
            S_n = (snap.stakes / snap.stakes.sum()).astype(np.float32)
            W_parts.append(np.tile(W_n[None], (epochs_per_snapshot, 1, 1)))
            S_parts.append(np.tile(S_n[None], (epochs_per_snapshot, 1)))
        return self._dense_scenario(
            netuid,
            blocks,
            np.concatenate(W_parts),
            np.concatenate(S_parts),
            epochs_per_snapshot,
        )

    def window_scenario(
        self,
        netuid: int,
        *,
        window: Optional[int] = None,
        epochs_per_snapshot: int = 4,
    ) -> Scenario:
        """Compile the trailing ``window`` snapshots into ONE
        epoch-varying scenario: snapshot ``i``'s normalized weights and
        stakes hold for epochs ``[i*K, (i+1)*K)`` — the replay tier's
        model of a chain whose metagraph re-samples every K epochs.
        The result is a plain dense Scenario, so plans, donor packing,
        numerics capture, and the suffix-resume engine contract apply
        unchanged."""
        entries = self.window_entries(netuid, window=window)
        return self.scenario_for_blocks(
            netuid,
            [e.block for e in entries],
            epochs_per_snapshot=epochs_per_snapshot,
        )

    def _dense_scenario(
        self,
        netuid: int,
        blocks: Sequence[int],
        weights: np.ndarray,
        stakes: np.ndarray,
        epochs_per_snapshot: int,
    ) -> Scenario:
        E, V, M = weights.shape
        validators = [f"uid {v}" for v in range(V)]
        scenario = Scenario(
            name=(
                f"replay netuid={netuid} blocks "
                f"{blocks[0]}..{blocks[-1]} "
                f"({len(blocks)} snapshots x {epochs_per_snapshot} epochs)"
            ),
            validators=validators,
            base_validator=validators[
                int(np.argmax(stakes.sum(axis=0)))
            ],
            weights=weights,
            stakes=stakes,
            num_epochs=E,
            servers=[f"Server {m + 1}" for m in range(M)],
        )
        scenario.validate(normalized=True)
        from yuma_simulation_tpu_torch.foundry.dsl import record_scenario_generated

        record_scenario_generated()
        return scenario

    def timeline_fingerprint(
        self, netuid: int, *, window: Optional[int] = None
    ) -> str:
        """Content address of one subnet's trailing window — what the
        state cache keys baselines on, so a timeline that grew a new
        snapshot (or a different window) can never serve a stale
        baseline."""
        entries = self.window_entries(netuid, window=window)
        return entries_fingerprint(entries)


def entries_fingerprint(entries: Sequence[TimelineEntry]) -> str:
    """Content address of an explicit entry list — the same hash
    :meth:`SnapshotArchive.timeline_fingerprint` computes over a
    trailing window, exposed for the controller's quarantine-filtered
    and watermark-bounded windows (the state cache keys baselines on
    exactly the entries a window COMPILED, not the timeline's raw
    contents)."""
    h = hashlib.sha256()
    for e in entries:
        h.update(f"{e.block}:{e.key}\n".encode())
    return h.hexdigest()


def synthetic_timeline(
    archive: SnapshotArchive,
    netuid: int,
    *,
    snapshots: int = 3,
    seed: int = 0,
    num_validators: int = 256,
    num_miners: int = 4096,
    base_block: int = 1000,
    blocks_per_snapshot: int = 100,
) -> list[TimelineEntry]:
    """Seed a deterministic synthetic timeline (CI / tests / the replay
    drill): ``snapshots`` foundry-generated snapshots at blocks
    ``base_block + i * blocks_per_snapshot``, each drawn from a seed
    derived as ``seed + i`` so consecutive snapshots are correlated the
    way consecutive chain samples are distinct. Same arguments ->
    bitwise-identical timeline on any host (the generator is pure
    numpy on explicit rngs). Idempotent: re-seeding an archive that
    already holds the identical prefix extends or no-ops."""
    entries = []
    for i in range(snapshots):
        snap = synthetic_snapshot(
            seed + i,
            num_validators=num_validators,
            num_miners=num_miners,
            netuid=netuid,
            block=base_block + i * blocks_per_snapshot,
        )
        entries.append(archive.append(snap))
    return entries

"""The shared fleet store: manifest + content-addressed unit results.

One directory (any filesystem every host can see) holds a fleet sweep's
entire coordination state:

```
store/
  manifest.json            # write-once: unit map + config fingerprint
  leases/                  # one claim file per unit (.lease / stale_*)
  results/
    unit_00003.npz         # one published result per unit
    unit_00003.sha256      # its integrity sidecar
  hosts/<host_id>/         # each host's flight bundle (ledger.jsonl,
                           # spans.jsonl, metrics.jsonl)
  fleet_report.json        # the merged FleetHealthReport (finalize)
```

Multi-writer discipline: every mutable file has exactly ONE writer —
leases are per-unit (and claim-arbitrated, :mod:`.lease`), results are
per-unit (and lease-gated), host bundles are per-host, and the manifest
is write-once-validate-after (the `CheckpointedSweep` rule). There is
deliberately no shared checksums.json: per-unit sidecars mean two hosts
never contend on one JSON file.

At-most-once publish: :meth:`FleetStore.publish_result` refuses to
overwrite a result that verifies. Unit results are pure functions of the
manifest's config fingerprint and the unit's lane bounds — deterministic
and bitwise-reproducible (the `DispatchPlan` contract) — so duplicate
EXECUTION (a stolen unit whose original holder was mid-compute) is
harmless by construction, and duplicate PUBLISH is suppressed here: the
second publisher sees a verified result and records a duplicate instead.
A result that exists but FAILS verification (torn write, bit rot) is
overwritten — corruption requeues, exactly as checkpoint chunks do.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import pathlib
import uuid
from typing import Optional

import numpy as np

from yuma_simulation_tpu_torch.utils.checkpoint import (
    _fsync_dir,
    _fsync_write,
    publish_atomic,
)

logger = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
LEASES_DIR = "leases"
RESULTS_DIR = "results"
HOSTS_DIR = "hosts"
FLEET_REPORT_NAME = "fleet_report.json"


def is_fleet_store(directory: str | pathlib.Path) -> bool:
    """Whether `directory` is a fleet store (vs a plain supervised-sweep
    checkpoint directory): its manifest carries the fleet unit map."""
    manifest = pathlib.Path(directory) / MANIFEST_NAME
    if not manifest.exists():
        return False
    try:
        data = json.loads(manifest.read_text())
    except (json.JSONDecodeError, OSError):
        return False
    return isinstance(data, dict) and "unit_lanes" in data


def _file_sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class FleetStore:
    """Handle on one fleet store directory (see the module docstring)."""

    def __init__(self, directory: str | pathlib.Path):
        self.directory = pathlib.Path(directory)
        self.results_dir = self.directory / RESULTS_DIR
        self.leases_dir = self.directory / LEASES_DIR
        self.hosts_dir = self.directory / HOSTS_DIR
        for d in (self.directory, self.results_dir, self.leases_dir,
                  self.hosts_dir):
            d.mkdir(parents=True, exist_ok=True)

    # -- manifest -------------------------------------------------------

    def ensure_manifest(
        self,
        *,
        num_units: Optional[int] = None,
        unit_lanes=None,
        tag: str = "",
        config=None,
        trace: Optional[dict] = None,
    ) -> dict:
        """Write the manifest once, validate it ever after (the
        `CheckpointedSweep` rule: a store directory must never silently
        mix sweeps). Every host of a fleet calls this with identical
        arguments; the first to arrive writes, the rest verify. Two
        hosts racing the first write publish byte-identical content, so
        the race is harmless.

        `trace` (a :meth:`..telemetry.propagation.TraceContext
        .to_manifest` dict) rides the manifest so every joining host
        continues the SWEEP-LEVEL trace instead of minting an orphan
        run. It is deliberately EXCLUDED from the identity check: the
        trace names who drove the sweep, not what the sweep is — the
        first writer's trace wins, and hosts arriving with a different
        (or no) ambient trace still join."""
        path = self.directory / MANIFEST_NAME
        meta = None
        if num_units is not None:
            try:
                fingerprint = json.dumps(config, sort_keys=True)
            except TypeError as e:
                raise TypeError(
                    "fleet config must be JSON-serializable "
                    f"(got {type(config).__name__}): {e}"
                ) from e
            meta = {
                "fleet": tag or "fleet",
                "num_units": int(num_units),
                "unit_lanes": [
                    [int(lo), int(hi)] for lo, hi in (unit_lanes or ())
                ],
                "config_fingerprint": hashlib.sha256(
                    fingerprint.encode()
                ).hexdigest(),
            }
            if len(meta["unit_lanes"]) != meta["num_units"]:
                raise ValueError(
                    "unit_lanes must carry one [lo, hi] pair per unit"
                )
            if trace:
                meta["trace"] = dict(trace)
        def _verify(found: dict) -> dict:
            if meta is not None:
                mismatched = {
                    k: (found.get(k), v)
                    for k, v in meta.items()
                    if k != "trace" and found.get(k) != v
                }
                if mismatched:
                    raise ValueError(
                        f"fleet store {self.directory} holds a different "
                        f"sweep: {mismatched}"
                    )
            return found

        if path.exists():
            return _verify(json.loads(path.read_text()))
        if meta is None:
            raise FileNotFoundError(
                f"fleet store {self.directory} has no manifest and none "
                "was provided (num_units/unit_lanes)"
            )
        # Exactly-one-winner first write (the lease-claim idiom): two
        # hosts racing here may carry DIFFERENT traces, so last-rename-
        # wins would let the loser proceed on a trace the manifest does
        # not record. The hard link makes the first writer's manifest
        # authoritative; the loser verifies and joins it.
        staged = path.with_name(f".{MANIFEST_NAME}.{uuid.uuid4().hex}.stage")
        publish_atomic(staged, json.dumps(meta, sort_keys=True).encode())
        try:
            os.link(staged, path)
        except FileExistsError:
            return _verify(json.loads(path.read_text()))
        finally:
            staged.unlink(missing_ok=True)
        _fsync_dir(path.parent)
        return meta

    def manifest(self) -> dict:
        return self.ensure_manifest()

    # -- results --------------------------------------------------------

    def result_path(self, unit: int) -> pathlib.Path:
        return self.results_dir / f"unit_{unit:05d}.npz"

    def _sidecar_path(self, unit: int) -> pathlib.Path:
        return self.results_dir / f"unit_{unit:05d}.sha256"

    def verify_result(self, unit: int) -> bool:
        """Published and intact: sha256 against the per-unit sidecar
        (no sidecar -> decode probe, the legacy-chunk rule)."""
        path = self.result_path(unit)
        if not path.exists():
            return False
        sidecar = self._sidecar_path(unit)
        if sidecar.exists():
            try:
                recorded = json.loads(sidecar.read_text())["sha256"]
            except (json.JSONDecodeError, OSError, KeyError):
                recorded = None
            if recorded is not None:
                return _file_sha256(path) == recorded
        try:
            with np.load(path, allow_pickle=False) as z:
                list(z.keys())
            return True
        except Exception:
            return False

    def publish_result(self, unit: int, arrays: dict) -> bool:
        """Publish `unit`'s result atomically (npz + sha256 sidecar,
        both fsync'd, parent directory fsync'd). Returns False — and
        writes nothing — when a verified result already exists (the
        at-most-once publish gate); an unverifiable existing result is
        overwritten (corruption requeues)."""
        if self.verify_result(unit):
            return False
        payload = {k: np.asarray(v) for k, v in arrays.items()}
        # Writer-unique temp: in the (deterministic-content) race where
        # two executions publish the same unit, neither may truncate the
        # other's in-flight bytes — each rename lands whole.
        tmp = self.results_dir / (
            f".partial_{unit:05d}.{uuid.uuid4().hex[:8]}.tmp"
        )
        buf = io.BytesIO()
        np.savez(buf, **payload)
        data = buf.getvalue()
        _fsync_write(tmp, lambda f: f.write(data))
        digest = _file_sha256(tmp)
        tmp.replace(self.result_path(unit))
        _fsync_dir(self.results_dir)
        publish_atomic(
            self._sidecar_path(unit),
            json.dumps({"sha256": digest}, sort_keys=True).encode(),
        )
        return True

    def load_result(self, unit: int) -> Optional[dict]:
        """Decode `unit`'s published arrays, or None when missing or
        undecodable (the caller requeues)."""
        try:
            with np.load(self.result_path(unit), allow_pickle=False) as z:
                return {k: np.asarray(z[k]) for k in z.keys()}
        except Exception:
            return None

    def published_units(self) -> list[int]:
        done = []
        for p in self.results_dir.glob("unit_*.npz"):
            tail = p.stem.split("_", 1)[1]
            if tail.isdigit():
                done.append(int(tail))
        return sorted(done)

    def pending_units(self, *, deep: bool = True) -> list[int]:
        """Units without a VERIFIED result (a published-but-corrupt
        result counts as pending: corruption requeues). `deep=False` is
        the scheduler's hot-loop variant: existence of the result and
        its sidecar only — no hashing, so an idle host polling a large
        store costs stats, not a re-read of every published byte. The
        scheduler re-runs the deep scan as its completion barrier (and
        fully verifies at claim and collect time), so a corrupt result
        is still caught and requeued."""
        n = self.manifest()["num_units"]
        if deep:
            return [u for u in range(n) if not self.verify_result(u)]
        return [
            u
            for u in range(n)
            if not (
                self.result_path(u).exists()
                and self._sidecar_path(u).exists()
            )
        ]

    def collect(self, key: str = "dividends") -> np.ndarray:
        """Concatenate every unit's `key` array in unit order. Raises
        when any unit is missing or fails verification — a fleet result
        is complete or it is not a result."""
        n = self.manifest()["num_units"]
        parts = []
        for unit in range(n):
            if not self.verify_result(unit):
                raise FileNotFoundError(
                    f"fleet store {self.directory} has no verified result "
                    f"for unit {unit}"
                )
            loaded = self.load_result(unit)
            if loaded is None or key not in loaded:
                raise KeyError(
                    f"unit {unit} result in {self.directory} carries no "
                    f"{key!r} array"
                )
            parts.append(loaded[key])
        return np.concatenate(parts, axis=0)

    # -- host bundles ---------------------------------------------------

    def host_dir(self, host_id: str) -> pathlib.Path:
        d = self.hosts_dir / host_id
        d.mkdir(parents=True, exist_ok=True)
        return d

    def host_ids(self) -> list[str]:
        return sorted(
            p.name for p in self.hosts_dir.iterdir() if p.is_dir()
        )

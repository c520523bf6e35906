"""Chain-replay service: snapshot timelines, epoch-state caching, what-ifs.

The port's counterpart of the JAX package's `replay/`: four pillars
compiled down to carriers every other tier already consumes, on the
device the caller names (the card by default):

- :mod:`.archive` — append-only per-subnet snapshot timelines
  (content-addressed blobs, atomic publish, typed :class:`ArchiveError`,
  deterministic synthetic generator for CI);
- :mod:`.statecache` — incremental epoch-state prefix caching over the
  engine's suffix-resume contract (``simulate(initial_state=...)``),
  LRU-bounded and content-addressed, bitwise against full runs;
- :mod:`.whatif` — frozen serializable perturbation specs compiled onto
  a cached baseline, returning per-validator/per-miner dividend deltas
  while re-simulating only the suffix;
- :mod:`.sweeper` — the trailing-window scheduled sweep: every variant
  x every subnet timeline as lease-claimed, canaried fleet units with
  driftreport-gated bundles;
- :mod:`.controller` — the continuous controller: durable per-(subnet x
  variant) watermarks, incremental suffix windows resumed from cached
  carries, exactly-once publication, quarantine, stall demotion and
  backpressure, plus the helper fleet host (:func:`run_host`);
- :mod:`.soak` — the multi-process chaos soak (writer, controller and
  host as real processes, SIGKILLs mid-sweep).

:class:`ReplayService` is the glue the serve tier (``POST /v1/whatif``,
``GET /v1/replay/...``) mounts. ``python -m yuma_simulation_tpu_torch.replay
{--drill,--controller,--host,--writer,--soak}`` runs each mode; every
mode takes ``--device`` (the card by default) and passes it to every
process it starts.
"""

from __future__ import annotations

import logging
import pathlib
import threading
from typing import Optional, Union

from yuma_simulation_tpu_torch.replay.archive import (  # noqa: F401
    ArchiveError,
    SnapshotArchive,
    TimelineEntry,
    synthetic_timeline,
)
from yuma_simulation_tpu_torch.replay.controller import (  # noqa: F401
    ControllerConfig,
    ControllerError,
    CycleReport,
    ReplayController,
    WatermarkStore,
    WindowSpec,
    run_host,
)
from yuma_simulation_tpu_torch.replay.statecache import (  # noqa: F401
    BaselineMeta,
    StateCache,
    StateCacheError,
    baseline_key,
)
from yuma_simulation_tpu_torch.replay.sweeper import (  # noqa: F401
    sweep_trailing_window,
    version_slug,
)
from yuma_simulation_tpu_torch.replay.whatif import (  # noqa: F401
    WhatIfError,
    WhatIfResult,
    WhatIfSpec,
    run_whatif,
)

logger = logging.getLogger(__name__)

__all__ = [
    "ArchiveError",
    "BaselineMeta",
    "ControllerConfig",
    "ControllerError",
    "CycleReport",
    "ReplayController",
    "ReplayService",
    "SnapshotArchive",
    "StateCache",
    "StateCacheError",
    "TimelineEntry",
    "WatermarkStore",
    "WhatIfError",
    "WhatIfResult",
    "WhatIfSpec",
    "WindowSpec",
    "baseline_key",
    "run_host",
    "run_whatif",
    "sweep_trailing_window",
    "synthetic_timeline",
    "version_slug",
]


class ReplayService:
    """Archive + state cache behind one object: what the serve tier
    mounts (``ServeConfig.replay_archive_dir`` /
    ``replay_cache_dir``) and the drill drives directly.

    `describe(spec)` is the admission-time half: pure index/meta reads
    — subnet shape, epoch count, and the checkpoint a what-if would
    resume from — so the serve tier can price the request
    SUFFIX-SIZED through ``plan_dispatch`` without materializing a
    single scenario array. `whatif(spec)` is the dispatch-time half."""

    def __init__(
        self,
        archive_dir: Union[str, pathlib.Path],
        cache_dir: Union[str, pathlib.Path],
        *,
        window: Optional[int] = None,
        epochs_per_snapshot: int = 4,
        stride: int = 8,
        max_baselines: int = 64,
        config=None,
        device="cuda",
    ):
        from yuma_simulation_tpu_torch.models.config import YumaConfig
        from yuma_simulation_tpu_torch.simulation.engine import resolve_device

        # No fallback: raises here when CUDA is absent and the CPU was
        # not asked for.
        self.device = resolve_device(device)
        self.archive = SnapshotArchive(archive_dir)
        self.cache = StateCache(cache_dir, max_baselines=max_baselines)
        self.window = window
        self.epochs_per_snapshot = int(epochs_per_snapshot)
        self.stride = int(stride)
        self.config = config if config is not None else YumaConfig()
        # Compiled-window memo (fingerprint -> Scenario): a what-if
        # burst against one subnet must not re-tile the [E, V, M] stack
        # per request. Bounded; guarded by the lock.
        self._lock = threading.Lock()
        self._scenarios: dict = {}

    # -- index reads (GET /v1/replay/...) --------------------------------

    def index(self) -> dict:
        subnets = []
        for netuid in self.archive.subnets():
            entries = self.archive.timeline(netuid)
            subnets.append(
                {
                    "netuid": netuid,
                    "snapshots": len(entries),
                    "first_block": entries[0].block if entries else None,
                    "last_block": entries[-1].block if entries else None,
                    "validators": entries[-1].validators if entries else None,
                    "miners": entries[-1].miners if entries else None,
                }
            )
        return {
            "subnets": subnets,
            "window": self.window,
            "epochs_per_snapshot": self.epochs_per_snapshot,
            "cached_baselines": len(self.cache.keys()),
        }

    def timeline_info(self, netuid: int) -> dict:
        entries = self.archive.timeline(netuid)
        window = self.archive.window_entries(netuid, window=self.window)
        fingerprint = self.archive.timeline_fingerprint(
            netuid, window=self.window
        )
        baselines = []
        for key in self.cache.keys():
            meta = self.cache.meta(key)
            if meta is not None and meta.scenario_fingerprint == fingerprint:
                baselines.append(
                    {
                        "key": meta.key,
                        "version": meta.version,
                        "engine": meta.engine,
                        "epochs": meta.epochs,
                        "stride": meta.stride,
                        "checkpoints": list(meta.checkpoints),
                    }
                )
        return {
            "netuid": netuid,
            "entries": [e.to_json() for e in entries],
            "window_blocks": [e.block for e in window],
            "epochs": len(window) * self.epochs_per_snapshot,
            "baselines": baselines,
        }

    # -- what-if resolution ----------------------------------------------

    def _resolve_key(self, spec: WhatIfSpec) -> tuple:
        """(fingerprint, engine, key, (E, V, M)) — all host arithmetic
        and index reads, zero launches, zero array builds. The engine and
        key come from :meth:`.StateCache.resolve`, as the build's do, so
        the key names the rung that actually runs."""
        entries = self.archive.window_entries(
            spec.netuid, window=self.window
        )
        V, M = entries[-1].validators, entries[-1].miners
        E = len(entries) * self.epochs_per_snapshot
        fingerprint = self.archive.timeline_fingerprint(
            spec.netuid, window=self.window
        )
        _config, _dtype, engine, key = self.cache.resolve(
            fingerprint,
            spec.version,
            self.config,
            None,
            (E, V, M),
            self.stride,
            self.device,
        )
        return fingerprint, engine, key, (E, V, M)

    def describe(self, spec: WhatIfSpec) -> dict:
        """Admission-time pricing facts for one what-if: the full and
        SUFFIX shapes (the suffix is what the dispatch actually costs),
        and whether a baseline is already cached."""
        fingerprint, engine, key, (E, V, M) = self._resolve_key(spec)
        if spec.from_epoch >= E:
            raise WhatIfError(
                f"from_epoch {spec.from_epoch} is beyond the window's "
                f"{E} epochs"
            )
        meta = self.cache.meta(key)
        resume = (
            self.cache.resume_epoch(key, spec.from_epoch)
            if meta is not None
            else 0
        )
        return {
            "key": key,
            "fingerprint": fingerprint,
            "engine": engine,
            "epochs": E,
            "validators": V,
            "miners": M,
            "cached": meta is not None,
            "resume_epoch": resume,
            "suffix_epochs": E - resume,
        }

    def _window_scenario(self, netuid: int, fingerprint: str):
        with self._lock:
            hit = self._scenarios.get(fingerprint)
        if hit is not None:
            return hit
        scenario = self.archive.window_scenario(
            netuid,
            window=self.window,
            epochs_per_snapshot=self.epochs_per_snapshot,
        )
        with self._lock:
            if len(self._scenarios) >= 8:
                self._scenarios.pop(next(iter(self._scenarios)))
            self._scenarios[fingerprint] = scenario
        return scenario

    def whatif(self, spec: WhatIfSpec) -> WhatIfResult:
        """Execute one what-if: resume from the cached baseline when a
        usable checkpoint exists; otherwise record the typed miss,
        build (and checkpoint) the baseline, then run the perturbed
        suffix from the checkpoint the build just published — the miss
        pays the baseline build (all E epochs), never a THIRD
        end-to-end pass, and the next what-if on this baseline is a
        suffix-sized hit.

        The build runs OUTSIDE the service lock: `build_baseline` is
        idempotent (content-addressed key, atomic publishes, concurrent
        builds race safely), so a racing miss on the same key at
        worst duplicates work — it never blocks hits on OTHER baselines
        behind a multi-second build."""
        fingerprint, engine, key, (E, _V, _M) = self._resolve_key(spec)
        scenario = self._window_scenario(spec.netuid, fingerprint)
        meta = self.cache.meta(key)
        if meta is None:
            self.cache.record_miss(
                key, total_epochs=E, reason="baseline_not_built"
            )
            meta = self.cache.build_baseline(
                scenario,
                spec.version,
                self.config,
                scenario_fingerprint=fingerprint,
                stride=self.stride,
                engine=engine,
                device=self.device,
            )
            result = run_whatif(
                self.cache,
                meta,
                scenario,
                self.config,
                spec,
                use_cache=True,  # the checkpoints the build just wrote
                device=self.device,
            )
            # Honest miss accounting: the request paid for the full
            # baseline build, so it reports as a miss simulating all E
            # epochs regardless of how the perturbed half dispatched.
            result.cache_hit = False
            result.resume_epoch = 0
            result.epochs_saved = 0
            result.epochs_simulated = E
            return result
        return run_whatif(
            self.cache,
            meta,
            scenario,
            self.config,
            spec,
            use_cache=True,
            record=True,
            device=self.device,
        )

"""Incremental epoch-state prefix caching for what-if suffix resume.

The consensus state at epoch ``k`` is a small pytree (``bonds [V, M]``,
``consensus [M]``, sometimes ``w_prev [V, M]``) — a few MB even at the
real-subnet flagship shape, against the ``[E, V, M]`` epoch stack a
full re-simulation re-pays. This module checkpoints a baseline
trajectory's carry every ``stride`` epochs through the engine's
suffix-resume contract (``simulate(..., initial_state=, epoch_offset=,
return_state=True)`` — :mod:`..simulation.engine`), so a what-if that
perturbs epoch ``k`` re-simulates only epochs ``[k', E)`` from the
nearest checkpoint ``k' <= k`` — turning a 40-epoch request into a
~5-epoch one, **bitwise identical** to the uncached run (the segment
boundaries ride the same carry-threading contract chunked streaming is
pinned on).

On-disk layout under one cache root (every write
:func:`..utils.checkpoint.publish_atomic` — crash leaves old or new,
never torn)::

    <root>/
      lru.json                     # access sequence per baseline key
      <baseline-key>/              # sha256 of what determines the bits
        meta.json                  # shape/version/engine/stride/checkpoints
        baseline.npz               # dividends [E, V] (+ incentives [E, M])
        state_<epoch>.npz          # serialized carry at each checkpoint

The baseline key is content-addressed over everything that determines
the trajectory's bits — the timeline/scenario fingerprint, version,
config, dtype, epoch count, checkpoint stride, and the PINNED engine
rung (baseline and suffix must run the same rung, or "bitwise" would
silently mean "to reduction-order rounding"). The store is LRU-bounded:
`max_baselines` trajectories, least-recently-used evicted whole.

Telemetry: every resolve is a typed ``state_cache_hit`` /
``state_cache_miss`` event plus the matching counter, and every hit
adds the epochs it skipped to ``replay_suffix_epochs_saved`` — the
series ``tools/obsreport.py``'s replay section renders.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import logging
import pathlib
import threading
from typing import Optional, Union

import numpy as np

from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)


class StateCacheError(ValueError):
    """A cache operation that violates the store contract (unknown
    baseline, corrupt artifact, inconsistent meta)."""


def config_fingerprint(config) -> str:
    """Canonical content address of a YumaConfig: every float/bool leaf
    in sorted field order. Two configs with equal leaves fingerprint
    equal regardless of construction path."""
    flat = {}

    def walk(prefix: str, obj) -> None:
        if dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(f"{prefix}{f.name}.", getattr(obj, f.name))
        elif obj is None or isinstance(obj, (bool, int, float, str)):
            flat[prefix.rstrip(".")] = obj
        else:
            flat[prefix.rstrip(".")] = repr(obj)

    walk("", config)
    payload = json.dumps(flat, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()


def baseline_key(
    *,
    scenario_fingerprint: str,
    version: str,
    config,
    dtype: str,
    epochs: int,
    stride: int,
    engine: str,
) -> str:
    """The content address one cached baseline lives under (module
    docstring: everything that determines the trajectory's bits)."""
    payload = json.dumps(
        {
            "scenario": scenario_fingerprint,
            "version": version,
            "config": config_fingerprint(config),
            "dtype": str(dtype),
            "epochs": int(epochs),
            "stride": int(stride),
            "engine": engine,
        },
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()


def dtype_name(dtype) -> str:
    """numpy's name of a float dtype (``"float32"``), whether it is given
    as a torch dtype, a numpy dtype or a name: the spelling the JAX
    package's keys use (``jnp.dtype(dtype).name``), so that equal fields
    give JAX's key."""
    import torch

    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def torch_dtype(name: str):
    """The torch dtype of a numpy dtype name (the inverse of
    :func:`dtype_name`)."""
    import torch

    return getattr(torch, np.dtype(name).name)


def pinned_engine(engine: str) -> str:
    """The rung a cached baseline runs on, given the rung the planner
    picked. The epoch-tiled varying rungs map onto their per-epoch
    case-scan twins (K3 -> K2, and their tensor-core spellings): the
    cache composes stride segments, suffixes and full runs of DIFFERENT
    epoch counts, and the cached/uncached bitwise contract needs every
    one of them to give an epoch the same bits whatever its run's
    length. Every other rung is kept."""
    if engine == "fused_varying_mxu":
        return "fused_scan_mxu"
    if engine == "fused_varying":
        return "fused_scan"
    return engine


def serialize_state(state: dict) -> bytes:
    """One consensus carry as canonical npz bytes (the same dict
    :attr:`..simulation.engine.SimulationResult.final_state` holds)."""
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in sorted(state.items())})
    return buf.getvalue()


def deserialize_state(blob: bytes) -> dict:
    with np.load(io.BytesIO(blob)) as data:
        return {k: np.asarray(data[k]) for k in data.files}


@dataclasses.dataclass(frozen=True)
class BaselineMeta:
    """What a cached baseline is: enough to admit, price, and resume a
    what-if without touching the arrays."""

    key: str
    epochs: int
    validators: int
    miners: int
    version: str
    engine: str  # the PINNED rung every segment and suffix runs on
    stride: int
    dtype: str
    checkpoints: tuple  # ascending checkpoint epochs (stride, 2*stride, ..)
    scenario_fingerprint: str
    scenario_name: str = ""

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["checkpoints"] = list(self.checkpoints)
        return d

    @classmethod
    def from_json(cls, payload: dict) -> "BaselineMeta":
        try:
            return cls(
                **{
                    **payload,
                    "checkpoints": tuple(
                        int(c) for c in payload["checkpoints"]
                    ),
                }
            )
        except (KeyError, TypeError) as exc:
            raise StateCacheError(f"corrupt baseline meta: {exc}") from None


class StateCache:
    """The LRU-bounded, content-addressed baseline/carry store."""

    def __init__(
        self,
        root: Union[str, pathlib.Path],
        *,
        max_baselines: int = 64,
    ):
        if max_baselines < 1:
            raise ValueError(
                f"max_baselines must be >= 1, got {max_baselines}"
            )
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_baselines = max_baselines
        # Serializes LRU read-modify-write and eviction against
        # concurrent store/touch from handler threads (the guarded state
        # is only ever touched under the lock).
        self._lock = threading.Lock()
        from yuma_simulation_tpu_torch.telemetry.metrics import get_registry

        registry = get_registry()
        self._hits = registry.counter(
            "state_cache_hits",
            help="what-if suffix resumes served from a cached epoch state",
        )
        self._misses = registry.counter(
            "state_cache_misses",
            help="what-if requests with no usable cached epoch state",
        )
        self._epochs_saved = registry.counter(
            "replay_suffix_epochs_saved",
            help="epochs a cached carry let what-ifs skip re-simulating",
        )

    # -- layout ---------------------------------------------------------

    def _dir(self, key: str) -> pathlib.Path:
        return self.root / key

    def _meta_path(self, key: str) -> pathlib.Path:
        return self._dir(key) / "meta.json"

    def _state_path(self, key: str, epoch: int) -> pathlib.Path:
        return self._dir(key) / f"state_{int(epoch):06d}.npz"

    def _baseline_path(self, key: str) -> pathlib.Path:
        return self._dir(key) / "baseline.npz"

    # -- LRU ------------------------------------------------------------

    def _touch_locked(self, key: str) -> None:
        path = self.root / "lru.json"
        try:
            lru = json.loads(path.read_text()) if path.exists() else {}
        except json.JSONDecodeError:
            lru = {}
        lru[key] = max((int(v) for v in lru.values()), default=0) + 1
        publish_atomic(path, json.dumps(lru, sort_keys=True).encode())

    def _evict_locked(self) -> None:
        import shutil

        path = self.root / "lru.json"
        try:
            lru = json.loads(path.read_text()) if path.exists() else {}
        except json.JSONDecodeError:
            lru = {}
        keys = [
            p.name for p in self.root.iterdir()
            if p.is_dir() and (p / "meta.json").exists()
        ]
        if len(keys) <= self.max_baselines:
            return
        keys.sort(key=lambda k: int(lru.get(k, 0)))
        for stale in keys[: len(keys) - self.max_baselines]:
            shutil.rmtree(self._dir(stale), ignore_errors=True)
            lru.pop(stale, None)
            logger.info("state cache evicted baseline %s", stale[:16])
        publish_atomic(path, json.dumps(lru, sort_keys=True).encode())

    # -- reads ----------------------------------------------------------

    def keys(self) -> list[str]:
        return sorted(
            p.name for p in self.root.iterdir()
            if p.is_dir() and (p / "meta.json").exists()
        )

    def meta(self, key: str) -> Optional[BaselineMeta]:
        path = self._meta_path(key)
        if not path.exists():
            return None
        try:
            return BaselineMeta.from_json(json.loads(path.read_text()))
        except (json.JSONDecodeError, StateCacheError):
            logger.warning("dropping corrupt baseline meta %s", key[:16])
            return None

    def held_prefixes(self) -> list[dict]:
        """Everything this cache can resume FROM, as an advertisement:
        one record per held baseline — the content-addressed key, the
        largest checkpoint epoch whose state file is actually readable
        on disk (the suffix-savings currency), and the identity fields
        a router needs to match a what-if to the baseline WITHOUT
        recomputing the key (scenario fingerprint/name, version,
        engine, total epochs). The serve scale-out tier publishes this
        in each worker's heartbeat so state-cache-affinity routing can
        score claims by suffix-epochs-saved (serve/router.py)."""
        ads = []
        for key in self.keys():
            meta = self.meta(key)
            if meta is None:
                continue
            held = [
                c
                for c in meta.checkpoints
                if self._state_path(key, c).exists()
            ]
            if not held:
                continue
            ads.append(
                {
                    "key": key,
                    "max_checkpoint": max(held),
                    "checkpoints": sorted(int(c) for c in held),
                    "epochs": meta.epochs,
                    "version": meta.version,
                    "engine": meta.engine,
                    "scenario_fingerprint": meta.scenario_fingerprint,
                    "scenario_name": meta.scenario_name,
                }
            )
        return ads

    def resume_epoch(self, key: str, perturb_epoch: int) -> int:
        """The largest stored checkpoint epoch ``<= perturb_epoch`` —
        0 when none qualifies (resume from the zero state)."""
        meta = self.meta(key)
        if meta is None:
            return 0
        usable = [
            c
            for c in meta.checkpoints
            if c <= perturb_epoch and self._state_path(key, c).exists()
        ]
        return max(usable, default=0)

    def load_state(self, key: str, epoch: int) -> dict:
        path = self._state_path(key, epoch)
        try:
            return deserialize_state(path.read_bytes())
        except (OSError, ValueError, KeyError) as exc:
            raise StateCacheError(
                f"baseline {key[:16]}: state at epoch {epoch} unreadable "
                f"({exc})"
            ) from None

    def load_baseline(self, key: str) -> dict:
        """The baseline trajectory's outputs:
        ``{"dividends" [E, V], "incentives" [E, M]}``."""
        path = self._baseline_path(key)
        try:
            with np.load(path) as data:
                return {k: np.asarray(data[k]) for k in data.files}
        except (OSError, ValueError, KeyError) as exc:
            raise StateCacheError(
                f"baseline {key[:16]}: trajectory unreadable ({exc})"
            ) from None

    # -- telemetry ------------------------------------------------------

    def record_hit(
        self, key: str, *, resume_epoch: int, total_epochs: int
    ) -> None:
        self._hits.inc()
        self._epochs_saved.inc(resume_epoch)
        log_event(
            logger,
            "state_cache_hit",
            level=logging.INFO,
            baseline=key[:16],
            resume_epoch=resume_epoch,
            suffix_epochs=total_epochs - resume_epoch,
            epochs_saved=resume_epoch,
        )

    def record_miss(self, key: str, *, total_epochs: int, reason: str) -> None:
        self._misses.inc()
        log_event(
            logger,
            "state_cache_miss",
            level=logging.INFO,
            baseline=key[:16],
            full_epochs=total_epochs,
            reason=reason,
        )

    # -- build ----------------------------------------------------------

    def resolve(
        self,
        scenario_fingerprint: str,
        version: str,
        config,
        dtype,
        shape: tuple,
        stride: int,
        device,
        *,
        engine: str = "auto",
    ) -> tuple:
        """``(config, dtype, engine, key)`` of the baseline these fields
        name: the defaults filled in (``YumaConfig()``, float32), the rung
        pinned ONCE for the baseline's whole lifetime (every segment and
        every later suffix must run the same engine, or bitwise equality
        degrades to reduction-order rounding; :func:`pinned_engine` of
        the planner's rung on `device` when `engine` is "auto"), and its
        content-addressed key. Host arithmetic only: no launch, no array
        built. The one place a baseline's rung and key are decided, for
        the build and for admission alike."""
        import torch

        from yuma_simulation_tpu_torch.models.config import YumaConfig
        from yuma_simulation_tpu_torch.simulation.planner import plan_dispatch

        config = config if config is not None else YumaConfig()
        dtype = torch_dtype(dtype_name(dtype)) if dtype is not None else torch.float32
        E, V, M = shape
        if engine == "auto":
            engine = pinned_engine(
                plan_dispatch(
                    f"replay:baseline:{version}",
                    (E, V, M),
                    version,
                    config,
                    dtype,
                    device=device,
                ).engine
            )
        key = baseline_key(
            scenario_fingerprint=scenario_fingerprint,
            version=version,
            config=config,
            dtype=dtype_name(dtype),
            epochs=E,
            stride=stride,
            engine=engine,
        )
        return config, dtype, engine, key

    def build_baseline(
        self,
        scenario,
        version: str,
        config=None,
        *,
        scenario_fingerprint: str,
        stride: int = 8,
        engine: str = "auto",
        dtype=None,
        device="cuda",
    ) -> BaselineMeta:
        """Simulate one baseline trajectory in ``stride``-epoch segments
        through the suffix-resume engine contract, checkpointing the
        carry at every segment boundary, and publish trajectory +
        states + meta under the content-addressed key. Segment runs are
        bitwise the monolithic trajectory (the carry-threading
        contract), so any suffix resumed from any checkpoint continues
        the exact bits a full run would have produced.

        An already-published identical baseline is reused (the key IS
        the content), making rebuilds idempotent and cheap. Every segment
        runs on `device` (the card by default)."""
        import dataclasses as dc

        from yuma_simulation_tpu_torch.simulation.engine import (
            resolve_device,
            simulate,
        )

        dev = resolve_device(device)
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        E, V, M = np.shape(scenario.weights)
        config, dtype, engine, key = self.resolve(
            scenario_fingerprint,
            version,
            config,
            dtype,
            (E, V, M),
            stride,
            dev,
            engine=engine,
        )
        existing = self.meta(key)
        if existing is not None:
            with self._lock:
                self._touch_locked(key)
            return existing

        carry = None
        dividends, incentives = [], []
        states: dict[int, dict] = {}
        for lo in range(0, E, stride):
            hi = min(lo + stride, E)
            segment = dc.replace(
                scenario,
                weights=scenario.weights[lo:hi],
                stakes=scenario.stakes[lo:hi],
                num_epochs=hi - lo,
            )
            result = simulate(
                segment,
                version,
                config,
                save_bonds=False,
                save_incentives=True,
                epoch_impl=engine,
                dtype=dtype,
                initial_state=carry,
                epoch_offset=lo,
                return_state=True,
                device=dev,
            )
            dividends.append(result.dividends)
            incentives.append(result.incentives)
            carry = result.final_state
            # Interior boundaries feed what-if suffix resume (meta
            # .checkpoints); the FINAL carry at E additionally publishes
            # as a state file so the continuous-replay controller can
            # extend this baseline incrementally (`extend_baseline`)
            # without re-simulating the prefix. It is deliberately NOT
            # listed in meta.checkpoints — a what-if never resumes past
            # its perturbation epoch, and existing consumers pin the
            # interior-only tuple.
            states[hi] = carry
        target = self._dir(key)
        target.mkdir(parents=True, exist_ok=True)
        for epoch, state in states.items():
            publish_atomic(
                self._state_path(key, epoch), serialize_state(state)
            )
        buf = io.BytesIO()
        np.savez(
            buf,
            dividends=np.concatenate(dividends),
            incentives=np.concatenate(incentives),
        )
        publish_atomic(self._baseline_path(key), buf.getvalue())
        meta = BaselineMeta(
            key=key,
            epochs=E,
            validators=V,
            miners=M,
            version=version,
            engine=engine,
            stride=stride,
            dtype=dtype_name(dtype),
            checkpoints=tuple(sorted(c for c in states if c < E)),
            scenario_fingerprint=scenario_fingerprint,
            scenario_name=scenario.name,
        )
        # Meta LAST: its presence is what marks the baseline published
        # (readers treat a directory without meta.json as absent).
        publish_atomic(
            self._meta_path(key),
            json.dumps(meta.to_json(), sort_keys=True).encode(),
        )
        with self._lock:
            self._touch_locked(key)
            self._evict_locked()
        return meta

    def final_state(self, key: str) -> dict:
        """The carry AFTER a baseline's last epoch (the extension
        point `extend_baseline` resumes from). Typed
        :class:`StateCacheError` when the baseline or its final state
        file is absent — the caller's fallback is a full rebuild."""
        meta = self.meta(key)
        if meta is None:
            raise StateCacheError(f"no baseline {key[:16]} to extend")
        return self.load_state(key, meta.epochs)

    def extend_baseline(
        self,
        prior_key: str,
        suffix_scenario,
        *,
        scenario_fingerprint: str,
        config=None,
        device="cuda",
    ) -> BaselineMeta:
        """Extend a published baseline by `suffix_scenario`'s epochs
        through the suffix-resume contract: resume from the prior
        baseline's final carry, simulate ONLY the new epochs (stride
        segments aligned to the prior baseline's global checkpoint
        grid), and publish the concatenated trajectory under the NEW
        content-addressed key — the continuous-replay controller's
        incremental refresh, bitwise identical to a from-scratch
        :meth:`build_baseline` of the full extended window (same
        engine, same stride, same carry-threading contract), at the
        cost of the suffix alone.

        Idempotent exactly like :meth:`build_baseline` (the key IS the
        content). Typed :class:`StateCacheError` when the prior
        baseline, its final state, or its trajectory is unreadable —
        the caller's fallback is a full rebuild. The segments run on
        `device`."""
        import dataclasses as dc

        from yuma_simulation_tpu_torch.models.config import YumaConfig
        from yuma_simulation_tpu_torch.simulation.engine import (
            resolve_device,
            simulate,
        )

        dev = resolve_device(device)

        prior = self.meta(prior_key)
        if prior is None:
            raise StateCacheError(f"no baseline {prior_key[:16]} to extend")
        config = config if config is not None else YumaConfig()
        E0 = prior.epochs
        E_suffix, V, M = np.shape(suffix_scenario.weights)
        if (V, M) != (prior.validators, prior.miners):
            raise StateCacheError(
                f"baseline {prior_key[:16]} is [{prior.validators}, "
                f"{prior.miners}] but the suffix is [{V}, {M}] — a "
                "re-shaped subnet starts a new baseline"
            )
        E1 = E0 + E_suffix
        stride = prior.stride
        key = baseline_key(
            scenario_fingerprint=scenario_fingerprint,
            version=prior.version,
            config=config,
            dtype=prior.dtype,
            epochs=E1,
            stride=stride,
            engine=prior.engine,
        )
        existing = self.meta(key)
        if existing is not None:
            with self._lock:
                self._touch_locked(key)
            return existing

        carry = self.final_state(prior_key)
        trajectory = self.load_baseline(prior_key)
        # Segment bounds continue the GLOBAL stride grid (0, stride,
        # 2*stride, ...), so the extended baseline's checkpoint set is
        # exactly what a from-scratch build would have published.
        bounds = [E0]
        nxt = (E0 // stride + 1) * stride
        while nxt < E1:
            bounds.append(nxt)
            nxt += stride
        bounds.append(E1)
        dividends = [trajectory["dividends"]]
        incentives = [trajectory["incentives"]]
        states: dict[int, dict] = {}
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            segment = dc.replace(
                suffix_scenario,
                weights=suffix_scenario.weights[lo - E0 : hi - E0],
                stakes=suffix_scenario.stakes[lo - E0 : hi - E0],
                num_epochs=hi - lo,
            )
            result = simulate(
                segment,
                prior.version,
                config,
                save_bonds=False,
                save_incentives=True,
                epoch_impl=prior.engine,
                dtype=torch_dtype(prior.dtype),
                initial_state=carry,
                epoch_offset=lo,
                return_state=True,
                device=dev,
            )
            dividends.append(result.dividends)
            incentives.append(result.incentives)
            carry = result.final_state
            states[hi] = carry
        target = self._dir(key)
        target.mkdir(parents=True, exist_ok=True)
        # The prior baseline's checkpoints carry over (byte copy — the
        # carries are the same trajectory's), plus the prior FINAL
        # state when it lands on the stride grid.
        inherited = [c for c in prior.checkpoints]
        if E0 % stride == 0:
            inherited.append(E0)
        for epoch in inherited:
            try:
                blob = self._state_path(prior_key, epoch).read_bytes()
            except OSError:
                continue  # a missing inherited checkpoint narrows resume
            publish_atomic(self._state_path(key, epoch), blob)
        for epoch, state in states.items():
            publish_atomic(
                self._state_path(key, epoch), serialize_state(state)
            )
        buf = io.BytesIO()
        np.savez(
            buf,
            dividends=np.concatenate(dividends),
            incentives=np.concatenate(incentives),
        )
        publish_atomic(self._baseline_path(key), buf.getvalue())
        checkpoints = sorted(
            set(c for c in inherited if c < E1)
            | set(c for c in states if c < E1)
        )
        meta = BaselineMeta(
            key=key,
            epochs=E1,
            validators=V,
            miners=M,
            version=prior.version,
            engine=prior.engine,
            stride=stride,
            dtype=prior.dtype,
            checkpoints=tuple(checkpoints),
            scenario_fingerprint=scenario_fingerprint,
            scenario_name=suffix_scenario.name,
        )
        publish_atomic(
            self._meta_path(key),
            json.dumps(meta.to_json(), sort_keys=True).encode(),
        )
        with self._lock:
            self._touch_locked(key)
            self._evict_locked()
        return meta

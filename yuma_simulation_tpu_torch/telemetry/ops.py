"""Live operations plane for standing hosts.

Every long-lived process of the port (a fleet host,
:class:`..fabric.scheduler.FleetHost`) already has the observability
substrate (metrics registry, SLO engine, flight
recorder, dispatch sketches). This module is the seam that looks at it
**while the process is alive**, transport-free so any host can mount the
same surfaces:

- :meth:`OpsPlane.debug_vars`: one JSON snapshot of the process: metrics
  registry, SLO evaluation and burn states, the bounded dispatch-sketch
  table, the recent structured events ring, profiler status, and the
  flight-segment summary when rotation is on. Pure reads under short
  locks; never blocks a dispatch.
- :meth:`OpsPlane.debug_spans`: one run's span tree, stitched from the
  sealed bundle on disk *plus* the live in-memory
  :class:`.runctx.RunContext` (spans the recorder has not flushed yet),
  rendered through the same :func:`.flight.build_timeline` the bundle
  report uses.
- :meth:`OpsPlane.debug_profile`: guarded on-demand profiling with
  ``torch.profiler``: a single-flight latch (the profiler is a process
  singleton; two overlapping traces corrupt both, and the latch is the
  one :func:`..utils.profiling.profile_trace` holds too), an auto-stop
  deadline so an operator who walks away cannot leave the profiler
  running, and publication of the finished trace directory into the
  flight bundle (:meth:`.flight.FlightRecorder.record_profile`). A second
  request while one is in flight raises the typed
  :class:`ProfileBusyError`.

The **events ring**: :func:`..utils.logging.log_event`, the single funnel
for every structured record of the package, also appends each record here
(bounded deque, process-global), so :meth:`OpsPlane.debug_vars` shows the
last ~256 events without any host plumbing a logger handler.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import pathlib
import pickle
import threading
import time
from typing import Iterator, Optional, Union

logger = logging.getLogger(__name__)

#: Bound on the recent-events ring: big enough to cover a burst of
#: recovery records, small enough that /debug/vars stays one screenful.
EVENTS_RING_SIZE = 256

#: Hard ceiling on one profile window: the auto-stop deadline clamps
#: here even if the caller asks for more (a trace this long is an
#: operator error, not a use case).
MAX_PROFILE_SECONDS = 300.0

#: Profiling modes accepted by :meth:`ProfileSession.start`.
PROFILE_MODES = ("trace", "memory")

#: The Chrome trace a window writes into its directory (the name
#: :func:`..utils.profiling.profile_trace` writes too).
TRACE_FILE = "trace.json"


# -- recent-events ring ------------------------------------------------


class _EventsRing:
    """Process-global bounded ring of structured log records. A record's
    non-scalar values are rendered with ``str`` when the ring is read, not
    when the record is noted: noting formats nothing, so a record costs
    :func:`..utils.logging.log_event` exactly the formatting it does
    itself."""

    def __init__(self, maxlen: int = EVENTS_RING_SIZE):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=maxlen)

    def note(self, event: str, fields: dict) -> None:
        item = (str(event), round(time.time(), 6), dict(fields))
        with self._lock:
            self._ring.append(item)

    @staticmethod
    def _render(item) -> dict:
        event, t, fields = item
        rec = {"event": event, "t": t}
        for key, value in fields.items():
            if key not in rec:
                rec[key] = value if isinstance(value, (int, float, bool)) else str(value)
        return rec

    def recent(self, limit: int = 64) -> list:
        with self._lock:
            items = list(self._ring)
        if limit > 0:
            items = items[-int(limit):]
        return [self._render(item) for item in items]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


_EVENTS = _EventsRing()


def note_event(event: str, fields: dict) -> None:
    """Append one structured record to the process ring (called by
    :func:`..utils.logging.log_event` under its containment wrapper —
    this function must stay cheap and non-raising under the GIL)."""
    _EVENTS.note(event, fields)


def recent_events(limit: int = 64) -> list:
    """The newest ``limit`` structured records, oldest first."""
    return _EVENTS.recent(limit)


def clear_events() -> None:
    """Test hook: empty the ring (process-global state)."""
    _EVENTS.clear()


# -- on-demand device profiling ---------------------------------------


class ProfileBusyError(RuntimeError):
    """A profile window is already in flight (the profiler is a process
    singleton; overlapping traces corrupt both). Carries the live holder's
    status."""

    def __init__(self, status: dict):
        super().__init__(
            "a profile window is already active "
            f"(mode={status.get('mode')!r}, "
            f"deadline_t={status.get('deadline_t')})"
        )
        self.status = dict(status)


class _ProfilerLatch:
    """The process's one ``torch.profiler``: whoever holds the latch owns it
    (a :class:`ProfileSession` window, :func:`..utils.profiling.profile_trace`,
    or a caller's own profiled region through :func:`hold_profiler`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._holder: Optional[dict] = None

    def acquire(self, status: dict) -> None:
        with self._lock:
            if self._holder is not None:
                raise ProfileBusyError(self._holder)
            self._holder = dict(status)

    def release(self) -> None:
        with self._lock:
            self._holder = None



_LATCH = _ProfilerLatch()


@contextlib.contextmanager
def hold_profiler(status: dict) -> Iterator[None]:
    """Hold the process's profiler latch for a block that runs
    ``torch.profiler`` itself: raises :class:`ProfileBusyError` when another
    window holds it, and makes a :class:`ProfileSession` raise while the
    block runs."""
    _LATCH.acquire(status)
    try:
        yield
    finally:
        _LATCH.release()


def _profiler_config() -> dict:
    """``torch.profiler.profile`` arguments for a window owned by one thread
    that must record the ops of every thread (the profiler is started and
    stopped on its owner thread: stopping it from another crashes the
    process), and the card's kernels where CUDA is present."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    kwargs = dict(activities=activities)
    try:
        kwargs["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True
        )
    except (AttributeError, TypeError):
        # An older torch records only the owner thread's ops on the host;
        # the card's records (CUPTI) are process-wide either way.
        pass
    return kwargs


class _TraceWindow(threading.Thread):
    """One trace window: starts ``torch.profiler`` on this thread, waits
    for a stop request or the deadline, stops it on this same thread and
    writes ``trace.json`` into the window's directory."""

    def __init__(self, trace_dir: pathlib.Path, seconds: float, on_done):
        super().__init__(name="profile-window", daemon=True)
        self.trace_dir = trace_dir
        self.seconds = seconds
        self.on_done = on_done
        self.started = threading.Event()
        self.stop_requested = threading.Event()
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        from torch.profiler import profile

        try:
            prof = profile(**_profiler_config())
            prof.start()
        except BaseException as e:  # noqa: BLE001 — reported to start()
            self.error = e
            self.started.set()
            return
        self.started.set()
        self.stop_requested.wait(self.seconds)
        try:
            prof.stop()
            self.trace_dir.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(self.trace_dir / TRACE_FILE))
        except Exception:  # noqa: BLE001 — a torn trace still gets a record
            logger.warning("torch.profiler stop failed", exc_info=True)
        self.on_done()


class ProfileSession:
    """Single-flight guard around ``torch.profiler`` with an auto-stop
    deadline and bundle registration.

    ``mode="trace"`` takes the process's profiler latch and opens one trace
    window into a fresh ``profiles/trace_NNN_<ts>`` directory under the
    bundle: the window's own thread starts the profiler, waits `seconds`
    (or a :meth:`stop`, whichever comes first) and writes
    ``trace.json`` there (a Chrome trace: the host's ranges and, on the
    card, every kernel launched in the window by any thread); then a
    ``profile_published`` record goes to the bundle's ``profiles.jsonl``
    and the latch is released. ``mode="memory"`` is synchronous: one
    snapshot of the CUDA caching allocator
    (``torch.cuda.memory._snapshot()``, pickled to
    ``profiles/memory_NNN_<ts>.pickle``), published at once; it needs
    CUDA, and on a process without it raises :class:`ValueError` and
    writes nothing."""

    def __init__(self, bundle_dir: Optional[Union[str, pathlib.Path]]):
        self.bundle_dir = (
            pathlib.Path(bundle_dir) if bundle_dir is not None else None
        )
        self._lock = threading.Lock()
        self._active: Optional[dict] = None
        self._window: Optional[_TraceWindow] = None
        self._serial = 0
        self._published = 0

    # -- introspection -------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            active = dict(self._active) if self._active else None
        out = {
            "active": active is not None,
            "profiles_published": self._published,
        }
        if active:
            out.update(active)
        return out

    # -- lifecycle -----------------------------------------------------

    def _profiles_root(self) -> pathlib.Path:
        if self.bundle_dir is None:
            raise ValueError(
                "on-demand profiling requires a bundle directory "
                "(the trace artifact must register somewhere)"
            )
        root = self.bundle_dir / "profiles"
        root.mkdir(parents=True, exist_ok=True)
        return root

    def start(self, seconds: float, mode: str = "trace") -> dict:
        """Begin one profile window. Raises :class:`ProfileBusyError` when a
        window (this session's, another session's, or a
        :func:`..utils.profiling.profile_trace` region's) holds the
        profiler, :class:`ValueError` on an unknown mode, a non-positive
        duration, a host with no bundle directory, or a memory snapshot
        without CUDA."""
        import torch

        if mode not in PROFILE_MODES:
            raise ValueError(
                f"unknown profile mode {mode!r} "
                f"(expected one of {PROFILE_MODES})"
            )
        seconds = float(seconds)
        if not seconds > 0:
            raise ValueError(f"profile seconds must be > 0, got {seconds}")
        seconds = min(seconds, MAX_PROFILE_SECONDS)
        if mode == "memory" and not torch.cuda.is_available():
            raise ValueError(
                "mode='memory' snapshots the CUDA caching allocator; this "
                "process has no CUDA device, so no snapshot is written"
            )
        root = self._profiles_root()
        with self._lock:
            if self._active is not None:
                raise ProfileBusyError(dict(self._active))
            serial = self._serial + 1
            stamp = int(time.time())
            if mode == "memory":
                # Synchronous one-shot: holds the latch only while it writes.
                path = root / f"memory_{serial:03d}_{stamp}.pickle"
                with hold_profiler({"mode": "memory", "artifact": str(path)}):
                    snapshot = torch.cuda.memory._snapshot()
                    with open(path, "wb") as f:
                        pickle.dump(snapshot, f)
                self._serial = serial
                return self._publish(
                    {"mode": "memory", "serial": serial, "artifact": str(path),
                     "seconds": 0.0}
                )
            trace_dir = root / f"trace_{serial:03d}_{stamp}"
            active = {
                "mode": "trace",
                "serial": serial,
                "artifact": str(trace_dir),
                "seconds": seconds,
                "t_started": round(time.time(), 6),
                "deadline_t": round(time.time() + seconds, 6),
            }
            _LATCH.acquire(active)
            window = _TraceWindow(trace_dir, seconds, self._window_done)
            window.start()
            window.started.wait()
            if window.error is not None:
                _LATCH.release()
                raise window.error
            self._serial = serial
            self._active = active
            self._window = window
            started = dict(active)
        from yuma_simulation_tpu_torch.utils.logging import log_event

        log_event(
            logger,
            "profile_started",
            mode=started["mode"],
            seconds=started["seconds"],
            artifact=started["artifact"],
        )
        return started

    def _window_done(self) -> None:
        """The window's thread, after the profiler stopped (operator or
        deadline): publish and release the latch."""
        with self._lock:
            active, self._active = self._active, None
            self._window = None
        _LATCH.release()
        if active is not None:
            self._publish(active)

    def stop(self) -> Optional[dict]:
        """Close the active trace window and wait for its trace to be
        written (idempotent: returns ``None`` when no window is open; the
        deadline and an operator stop racing is the normal case, not an
        error)."""
        with self._lock:
            window, active = self._window, self._active
        if window is None or active is None:
            return None
        window.stop_requested.set()
        window.join(timeout=MAX_PROFILE_SECONDS)
        return {
            "event": "profile_published",
            "mode": active["mode"],
            "serial": active["serial"],
            "artifact": active["artifact"],
            "seconds": active["seconds"],
        }

    def _publish(self, rec: dict) -> dict:
        record = {
            "event": "profile_published",
            "mode": rec["mode"],
            "serial": rec["serial"],
            "artifact": rec["artifact"],
            "seconds": rec["seconds"],
        }
        try:
            from yuma_simulation_tpu_torch.telemetry.flight import FlightRecorder

            FlightRecorder(self.bundle_dir).record_profile(record)
        except Exception:  # noqa: BLE001 — publication must not kill stop()
            logger.warning("profile registration failed", exc_info=True)
        self._published += 1
        from yuma_simulation_tpu_torch.utils.logging import log_event

        log_event(
            logger,
            "profile_published",
            mode=record["mode"],
            artifact=record["artifact"],
        )
        return record

    def close(self) -> None:
        """Host shutdown: stop any window so the trace is published
        rather than torn."""
        self.stop()


# -- the ops plane -----------------------------------------------------


class OpsPlane:
    """Transport-free debug surface shared by every standing host.

    A standing host (the fleet host) constructs one with whatever
    substrate it has: every argument beyond ``bundle_dir`` is optional,
    and a missing piece leaves its section out of :meth:`debug_vars`
    rather than failing the whole snapshot."""

    def __init__(
        self,
        bundle_dir: Optional[Union[str, pathlib.Path]] = None,
        *,
        registry=None,
        slo_engine=None,
        run=None,
    ):
        self.bundle_dir = (
            pathlib.Path(bundle_dir) if bundle_dir is not None else None
        )
        self.registry = registry
        self.slo_engine = slo_engine
        self.run = run
        self.profile = ProfileSession(self.bundle_dir)

    # -- /debug/vars ---------------------------------------------------

    def _segments_summary(self) -> dict:
        from yuma_simulation_tpu_torch.telemetry import flight

        if self.bundle_dir is None:
            return {"rotation": False}
        root = self.bundle_dir / flight.SEGMENTS_DIR
        if not root.is_dir():
            return {"rotation": False}
        rec = flight.FlightRecorder(self.bundle_dir)
        segs = rec._segment_dirs()
        sealed = [s for s in segs if rec._segment_sealed(s)]
        out = {
            "rotation": True,
            "segments_total": len(segs),
            "segments_sealed": len(sealed),
            "bytes_retained": sum(
                rec._segment_bytes(s) for s in sealed
            ),
            "open_runs": rec.open_run_ids(),
        }
        tomb = self.bundle_dir / flight.COMPACTED_NAME
        if tomb.exists():
            try:
                import json

                out["compacted"] = json.loads(tomb.read_text())
            except (OSError, ValueError):
                pass
        return out

    def debug_vars(self) -> dict:
        """One non-blocking snapshot of the live process. Every section
        is independently contained: a wedged subsystem hides its own
        section instead of taking the endpoint down."""
        out: dict = {"t": round(time.time(), 6)}
        if self.registry is not None:
            try:
                out["metrics"] = self.registry.snapshot()
            except Exception:  # noqa: BLE001
                logger.warning("debug_vars metrics failed", exc_info=True)
        if self.slo_engine is not None:
            try:
                out["slo"] = self.slo_engine.evaluate()
            except Exception:  # noqa: BLE001
                logger.warning("debug_vars slo failed", exc_info=True)
        try:
            from yuma_simulation_tpu_torch.telemetry.slo import dispatch_snapshot

            sketches = dispatch_snapshot()
            if sketches:
                out["dispatch_sketches"] = sketches
        except Exception:  # noqa: BLE001
            logger.warning("debug_vars sketches failed", exc_info=True)
        out["events"] = recent_events()
        out["profile"] = self.profile.status()
        try:
            out["segments"] = self._segments_summary()
        except Exception:  # noqa: BLE001
            logger.warning("debug_vars segments failed", exc_info=True)
        return out

    # -- /debug/spans --------------------------------------------------

    def debug_spans(self, run_id: Optional[str] = None) -> dict:
        """One run's span tree, stitched from the sealed bundle plus
        the live (unflushed) run context. Defaults to the host's own
        run when no ``run_id`` is given."""
        from yuma_simulation_tpu_torch.telemetry.flight import (
            build_timeline,
            load_bundle,
        )

        if not run_id and self.run is not None:
            run_id = self.run.run_id
        if not run_id:
            raise ValueError("no run_id given and the host has no run")
        if self.bundle_dir is None:
            raise ValueError(
                "span inspection requires a bundle directory"
            )
        bundle = load_bundle(self.bundle_dir)
        if self.run is not None and self.run.run_id == run_id:
            # Stitch in live (unflushed) spans: the bundle's copy of a
            # span wins (it is the sealed truth), the live ring only
            # fills in what the recorder hasn't published yet.
            seen = {
                (s.get("run_id"), s.get("span_id")) for s in bundle.spans
            }
            for s in self.run.span_records():
                if (s.get("run_id"), s.get("span_id")) not in seen:
                    bundle.spans.append(s)
        return build_timeline(bundle, run_id)

    # -- /debug/incidents ----------------------------------------------

    def debug_incidents(self) -> dict:
        """Current incident state from the bundle's durable
        ``incidents.jsonl`` (last record per incident id). A host with
        no bundle — or a clean one that never opened an incident —
        reports an empty list, which is the control-arm contract."""
        from yuma_simulation_tpu_torch.telemetry.incident import load_incidents

        incidents = (
            load_incidents(self.bundle_dir)
            if self.bundle_dir is not None
            else []
        )
        return {
            "incidents": incidents,
            "open": sum(
                1 for r in incidents if r.get("state") == "open"
            ),
        }

    # -- /debug/profile ------------------------------------------------

    def debug_profile(self, seconds: float, mode: str = "trace") -> dict:
        """Kick one guarded profile window; see :class:`ProfileSession`."""
        return self.profile.start(seconds, mode=mode)

    def close(self) -> None:
        self.profile.close()

"""Run-scoped tracing: one `RunContext` per run, nested `span` timers.

The counterpart of the JAX package's `telemetry/runctx.py`, with the same
records:

- :class:`RunContext` mints a process-unique ``run_id`` and collects the
  run's closed spans; it is installed in a :mod:`contextvars` variable, so
  nested code needs no plumbing to find it;
- :func:`span` opens one named, timed span under the innermost open span;
  span records carry ``span_id`` / ``parent_id`` and land on the owning
  run at close;
- :func:`current_fields` returns the ``{run_id, span_id, parent_id}``
  mapping that :func:`..utils.logging.log_event` stamps into every record;
- :func:`dispatch_annotation` wraps one host-level dispatch in
  ``torch.profiler.record_function(name)`` with a process-monotonic step
  number (appended to the open span's ``steps``), so a profiler trace's
  ranges line up with the span tree.

Host-level only: wall clocks and dict bookkeeping on the Python side of a
dispatch. `contextvars` do not flow into a bare `threading.Thread`; a
thread that should stamp a run's identity enters :meth:`RunContext.activate`.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Iterator, Optional

import torch

_CURRENT_RUN: contextvars.ContextVar[Optional["RunContext"]] = contextvars.ContextVar(
    "yuma_telemetry_run", default=None
)
_CURRENT_SPAN: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "yuma_telemetry_span", default=None
)

#: Process-monotonic dispatch step counter for :func:`dispatch_annotation`
#: (itertools.count is atomic in CPython).
_DISPATCH_STEP = itertools.count()


def new_run_id() -> str:
    """A process-unique, greppable run identifier."""
    return "run-" + uuid.uuid4().hex[:12]


def _tracing_now() -> bool:
    """Whether `torch.compile` is tracing this host code, where a profiler
    range and the step counter would be baked into nothing useful."""
    return torch.compiler.is_compiling()


@dataclass
class Span:
    """One closed-interval timer in a run's span tree. ``parent_id`` is
    empty for a root span. Times are wall-clock (`time.time()`)."""

    span_id: str
    parent_id: str
    name: str
    t_start: float
    t_end: Optional[float] = None
    status: str = "ok"
    #: host-side annotations (the profiler step numbers of the dispatches
    #: issued under this span, the dispatch plan) — flat JSON-able values.
    attrs: dict = field(default_factory=dict)
    #: ``parent_id`` lives in another process (a continued trace,
    #: :mod:`.propagation`).
    remote: bool = False

    def to_record(self, run_id: str) -> dict:
        rec = {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "run_id": run_id,
            "t_start": round(self.t_start, 6),
            "t_end": None if self.t_end is None else round(self.t_end, 6),
            "status": self.status,
        }
        if self.remote:
            rec["remote_parent"] = True
        if self.attrs:
            rec["attrs"] = dict(self.attrs)
        return rec


class RunContext:
    """The identity scope of one run (a sweep, a CLI invocation). Enter it
    as a context manager; everything executed inside stamps this
    ``run_id`` on its records. Span ids are minted per run (`s0001`,
    `s0002`, ...) under a lock.

    A child process joining an upstream trace passes the caller's
    ``run_id``, a process-unique ``span_prefix`` (ids become
    ``<prefix>.s0001``) and the caller's span as ``remote_parent``: spans
    with no local parent root under it."""

    def __init__(
        self,
        run_id: Optional[str] = None,
        *,
        span_prefix: str = "",
        remote_parent: str = "",
    ):
        self.run_id = run_id if run_id else new_run_id()
        if span_prefix and ("-" in span_prefix or " " in span_prefix):
            # Span ids must survive the traceparent header's dash framing.
            raise ValueError(f"span_prefix {span_prefix!r} must not contain '-' or spaces")
        self.span_prefix = span_prefix
        self.remote_parent = remote_parent
        self.t_start = time.time()
        self._lock = threading.Lock()
        self._next = itertools.count(1)
        self._closed: list[Span] = []
        self._open: dict[str, Span] = {}
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> "RunContext":
        if self._token is not None:
            raise RuntimeError(f"RunContext {self.run_id} already entered")
        self._token = _CURRENT_RUN.set(self)
        return self

    def __exit__(self, *exc) -> None:
        if self._token is None:
            raise RuntimeError(f"RunContext {self.run_id} was not entered")
        _CURRENT_RUN.reset(self._token)
        self._token = None

    @contextlib.contextmanager
    def activate(self) -> Iterator["RunContext"]:
        """Join this run from any thread, concurrently (each thread gets its
        own contextvar binding; span bookkeeping is locked)."""
        token = _CURRENT_RUN.set(self)
        try:
            yield self
        finally:
            _CURRENT_RUN.reset(token)

    def _mint_span_id(self) -> str:
        sid = f"s{next(self._next):04d}"
        return f"{self.span_prefix}.{sid}" if self.span_prefix else sid

    def _open_span(self, name: str, parent: Optional[Span]) -> Span:
        if parent is not None:
            parent_id, remote = parent.span_id, False
        else:
            parent_id, remote = self.remote_parent, bool(self.remote_parent)
        s = Span(span_id="", parent_id=parent_id, name=name, t_start=time.time(), remote=remote)
        with self._lock:
            s.span_id = self._mint_span_id()
            self._open[s.span_id] = s
        return s

    def record_span(
        self,
        name: str,
        t_start: float,
        t_end: float,
        *,
        parent_id: str = "",
        status: str = "ok",
        **attrs,
    ) -> Span:
        """Append one already-closed span with explicit wall-clock bounds.
        ``parent_id`` defaults to a root (or the run's remote parent)."""
        if not parent_id and self.remote_parent:
            parent_id, remote = self.remote_parent, True
        else:
            remote = False
        s = Span(
            span_id="", parent_id=parent_id, name=name, t_start=float(t_start),
            t_end=float(t_end), status=status, remote=remote,
        )
        if attrs:
            s.attrs.update(attrs)
        with self._lock:
            s.span_id = self._mint_span_id()
            self._closed.append(s)
        return s

    def _close_span(self, s: Span) -> None:
        s.t_end = time.time()
        with self._lock:
            self._open.pop(s.span_id, None)
            self._closed.append(s)

    def span_records(self) -> list[dict]:
        """All spans of this run as flat dicts: closed spans in close order,
        then any still-open ones (``status="open"``, no ``t_end``)."""
        with self._lock:
            records = [s.to_record(self.run_id) for s in self._closed]
            open_spans = sorted(self._open.values(), key=lambda s: s.t_start)
        for s in open_spans:
            rec = s.to_record(self.run_id)
            if rec["status"] == "ok":
                rec["status"] = "open"
            records.append(rec)
        return records


def current_run() -> Optional[RunContext]:
    """The innermost active :class:`RunContext`, or None."""
    return _CURRENT_RUN.get()


def current_span() -> Optional[Span]:
    """The innermost open span, or None."""
    return _CURRENT_SPAN.get()


def current_fields() -> dict:
    """``{"run_id": ...}`` plus ``span_id`` / ``parent_id`` when a span is
    open; empty when no run is active (one ContextVar read)."""
    run = _CURRENT_RUN.get()
    if run is None:
        return {}
    out = {"run_id": run.run_id}
    s = _CURRENT_SPAN.get()
    if s is not None:
        out["span_id"] = s.span_id
        if s.parent_id:
            out["parent_id"] = s.parent_id
    return out


@contextlib.contextmanager
def span(name: str, *, root: bool = False, **attrs) -> Iterator[Optional[Span]]:
    """Open one named span under the innermost open span of the active run.
    No active run: a no-op yielding None. An exception inside marks the
    span ``status="error"`` and propagates; the span always closes.
    ``root=True`` opens directly under the run's root (or remote parent)."""
    run = _CURRENT_RUN.get()
    if run is None:
        yield None
        return
    s = run._open_span(name, None if root else _CURRENT_SPAN.get())
    if attrs:
        s.attrs.update(attrs)
    token = _CURRENT_SPAN.set(s)
    try:
        yield s
    except BaseException:
        s.status = "error"
        raise
    finally:
        _CURRENT_SPAN.reset(token)
        run._close_span(s)


@contextlib.contextmanager
def ensure_run(run_id: Optional[str] = None) -> Iterator[RunContext]:
    """The active run, or a fresh one entered for the duration of the block."""
    run = _CURRENT_RUN.get()
    if run is not None:
        yield run
        return
    with RunContext(run_id) as run:
        yield run


@contextlib.contextmanager
def dispatch_annotation(name: str) -> Iterator[None]:
    """Wrap one host-level dispatch in ``torch.profiler.record_function(
    name)`` with a process-monotonic step number (appended to the open
    span's ``steps`` attr), so a profiler trace's ranges join against the
    span tree. Inert while `torch.compile` traces. Outside a profiler the
    range costs one small host-side record."""
    if _tracing_now():
        yield
        return
    step = next(_DISPATCH_STEP)
    s = _CURRENT_SPAN.get()
    if s is not None:
        s.attrs.setdefault("steps", []).append(step)
    with torch.profiler.record_function(name):
        yield

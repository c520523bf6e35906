"""Cross-process trace propagation: one trace across processes.

The counterpart of the JAX package's `telemetry/propagation.py`, with the
same wire forms, so a trace continues between the two packages' processes:

- :class:`TraceContext`: the serializable ``(run_id, span_id, baggage)``
  triple, W3C-traceparent-style on the wire (``00-<run_id>-<span_id>-01``
  plus a ``baggage`` ``k=v,k=v`` companion), as HTTP headers, in a fleet
  manifest, or through the environment (``YUMA_TRACEPARENT`` /
  ``YUMA_BAGGAGE``);
- :func:`current_trace_context`: the active run and innermost span as a
  context to hand downstream;
- :func:`child_run` / :func:`continue_trace`: the receiving side, a
  :class:`..runctx.RunContext` that continues the caller's run (same
  ``run_id``, spans parented under the caller's span, ids minted under a
  process-unique prefix) instead of minting an orphan root.

Host-side string and dict bookkeeping only; malformed headers and
environment values parse to ``None`` (a fresh local trace).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import uuid
from typing import Iterator, Mapping, Optional

from yuma_simulation_tpu_torch.telemetry.runctx import (
    RunContext,
    current_run,
    current_span,
)

#: Wire names (HTTP headers, lowercase per RFC 9110 field-name rules).
TRACEPARENT_HEADER = "traceparent"
BAGGAGE_HEADER = "baggage"
#: Environment names for subprocess propagation (simulated fleet hosts).
TRACEPARENT_ENV = "YUMA_TRACEPARENT"
BAGGAGE_ENV = "YUMA_BAGGAGE"

_VERSION = "00"
_FLAGS = "01"


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One point in a distributed trace: the run to continue and the
    span to parent under, plus free-form string baggage (tenant,
    request ids — identity only, never payload)."""

    run_id: str
    span_id: str = ""
    baggage: tuple = ()

    # -- wire form ------------------------------------------------------

    def to_traceparent(self) -> str:
        """``00-<run_id>-<span_id>-01``. The ``run_id`` may contain
        dashes (``run-ab12...``); the parser re-joins the middle fields,
        which is why span ids must never contain one (enforced at
        minting, :class:`..runctx.RunContext`)."""
        return "-".join(
            (_VERSION, self.run_id, self.span_id or "root", _FLAGS)
        )

    def to_baggage(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.baggage)

    @classmethod
    def from_traceparent(
        cls,
        header: Optional[str],
        baggage: Optional[str] = None,
    ) -> Optional["TraceContext"]:
        """Parse the wire form; ``None`` for anything malformed (an
        unparseable header downgrades to a fresh local trace, never an
        error a client can trigger)."""
        if not header or not isinstance(header, str):
            return None
        parts = header.strip().split("-")
        if len(parts) < 4 or parts[0] != _VERSION:
            return None
        span_id = parts[-2]
        run_id = "-".join(parts[1:-2])
        if not run_id or not span_id:
            return None
        bags: list[tuple] = []
        if baggage:
            for item in baggage.split(","):
                if "=" not in item:
                    continue
                k, v = item.split("=", 1)
                k, v = k.strip(), v.strip()
                if k:
                    bags.append((k, v))
        return cls(
            run_id=run_id,
            span_id="" if span_id == "root" else span_id,
            baggage=tuple(bags),
        )

    # -- env form (subprocess hosts) ------------------------------------

    def to_env(self) -> dict:
        env = {TRACEPARENT_ENV: self.to_traceparent()}
        if self.baggage:
            env[BAGGAGE_ENV] = self.to_baggage()
        return env

    @classmethod
    def from_env(
        cls, environ: Optional[Mapping[str, str]] = None
    ) -> Optional["TraceContext"]:
        environ = os.environ if environ is None else environ
        return cls.from_traceparent(
            environ.get(TRACEPARENT_ENV), environ.get(BAGGAGE_ENV)
        )

    # -- manifest form (fleet stores) -----------------------------------

    def to_manifest(self) -> dict:
        """The fleet-manifest field, carried under ``"trace"``
        (:meth:`..fabric.store.FleetStore.ensure_manifest`)."""
        rec = {"traceparent": self.to_traceparent()}
        if self.baggage:
            rec["baggage"] = self.to_baggage()
        return rec

    @classmethod
    def from_manifest(cls, manifest: Mapping) -> Optional["TraceContext"]:
        trace = manifest.get("trace") if isinstance(manifest, Mapping) else None
        if not isinstance(trace, Mapping):
            return None
        return cls.from_traceparent(
            trace.get("traceparent"), trace.get("baggage")
        )

    def with_baggage(self, **items: str) -> "TraceContext":
        merged = dict(self.baggage)
        merged.update({k: str(v) for k, v in items.items()})
        return dataclasses.replace(
            self, baggage=tuple(sorted(merged.items()))
        )


def current_trace_context(**baggage: str) -> Optional[TraceContext]:
    """The active run + innermost open span as a :class:`TraceContext`
    to hand downstream, or ``None`` outside any run. `baggage` items
    ride along (stringified)."""
    run = current_run()
    if run is None:
        return None
    s = current_span()
    ctx = TraceContext(run_id=run.run_id, span_id=s.span_id if s else "")
    return ctx.with_baggage(**baggage) if baggage else ctx


def span_prefix_for(name: str = "") -> str:
    """A process-unique span-id prefix for a continued run: stable hash
    of `name` (host ids are already process-unique) or a random nonce.
    Dash-free by construction — traceparent framing depends on it."""
    if name:
        return hashlib.sha256(name.encode()).hexdigest()[:8]
    return uuid.uuid4().hex[:8]


def child_run(ctx: TraceContext, *, prefix: str = "") -> RunContext:
    """A :class:`RunContext` continuing `ctx`'s trace in THIS process:
    same ``run_id``, span ids minted under a unique prefix, root spans
    parented under ``ctx.span_id`` (flagged ``remote_parent`` for the
    bundle checks). The caller enters/activates it as usual."""
    return RunContext(
        run_id=ctx.run_id,
        span_prefix=prefix or span_prefix_for(),
        remote_parent=ctx.span_id,
    )


@contextlib.contextmanager
def continue_trace(
    ctx: Optional[TraceContext], *, prefix: str = ""
) -> Iterator[RunContext]:
    """The receiving side's one entry point: join the already-active
    run when there is one (in-process callers keep their natural span
    nesting), continue `ctx` in a child run when given one, and fall
    back to a fresh run otherwise — :func:`..runctx.ensure_run` with a
    cross-process option."""
    run = current_run()
    if run is not None:
        yield run
        return
    if ctx is None:
        with RunContext() as run:
            yield run
        return
    with child_run(ctx, prefix=prefix) as run:
        yield run

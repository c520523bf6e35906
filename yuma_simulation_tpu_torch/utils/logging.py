"""Structured logging: one greppable ``event=<name> key=value ...`` line a
record, the JAX package's `utils/logging.py` format."""

from __future__ import annotations

import logging
import sys
from typing import Optional


def log_event(
    logger: logging.Logger,
    event: str,
    *,
    level: int = logging.WARNING,
    **fields,
) -> None:
    """Emit one machine-greppable `event=<name> key=value ...` record.

    Values are flat scalars on one line; values containing whitespace,
    `=` or quotes are double-quoted with inner quotes and backslashes
    escaped, so a key=value tokenizer (:func:`parse_event_line`) still
    parses the record. Empty-string fields are dropped.

    Inside a :class:`..telemetry.runctx.RunContext` the record is stamped
    with ``run_id`` (and ``span_id`` / ``parent_id`` under an open span):
    the join key between the log stream and the span tree. Fields the
    caller passes under those names win. A record below the logger's
    level is dropped before anything is formatted; every other record is
    also appended to the ops plane's recent-events ring
    (:func:`..telemetry.ops.note_event`)."""
    if not logger.isEnabledFor(level):
        return
    # Imported here: the telemetry modules import this one.
    from yuma_simulation_tpu_torch.telemetry.runctx import current_fields

    for key, value in current_fields().items():
        fields.setdefault(key, value)
    try:
        # The live-ops recent-events ring (telemetry.ops): every structured
        # record is also visible in a standing host's debug_vars(). Logging
        # must never fail on it.
        from yuma_simulation_tpu_torch.telemetry.ops import note_event

        note_event(event, fields)
    except Exception:  # noqa: BLE001
        pass

    def fmt(v) -> str:
        s = str(v)
        if any(c in s for c in (" ", "\t", "=", '"')):
            return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
        return s

    payload = " ".join(f"{k}={fmt(v)}" for k, v in fields.items() if v != "")
    logger.log(level, "event=%s%s", event, f" {payload}" if payload else "")


def parse_event_line(line: str) -> Optional[dict]:
    """Parse one `event=<name> key=value ...` record back into a dict, the
    inverse of :func:`log_event`'s quoting. Anything before the first
    ``event=`` token (formatter prefixes) is skipped; lines carrying no
    record give None. Values come back as the strings :func:`log_event`
    wrote (quoted values unescaped); the event name is under ``"event"``."""
    idx = line.find("event=")
    if idx > 0 and line[idx - 1] not in (" ", "\t"):
        # `event=` inside another token (a quoted message): no record boundary.
        idx = -1
    if idx == -1:
        return None
    s = line[idx:].rstrip("\n")
    fields: dict = {}
    i, n = 0, len(s)
    while i < n:
        while i < n and s[i] in (" ", "\t"):
            i += 1
        if i >= n:
            break
        eq = s.find("=", i)
        if eq == -1:
            break
        key = s[i:eq]
        if not key or any(c in key for c in (" ", "\t", '"')):
            break
        i = eq + 1
        if i < n and s[i] == '"':
            i += 1
            buf = []
            closed = False
            while i < n:
                c = s[i]
                if c == "\\" and i + 1 < n:
                    buf.append(s[i + 1])
                    i += 2
                    continue
                if c == '"':
                    i += 1
                    closed = True
                    break
                buf.append(c)
                i += 1
            if not closed:
                # A torn record: drop the dangling field, keep the rest.
                break
            fields[key] = "".join(buf)
        else:
            j = i
            while j < n and s[j] not in (" ", "\t"):
                j += 1
            fields[key] = s[i:j]
            i = j
    if "event" not in fields:
        return None
    return fields


def setup_logging(level: int = logging.INFO) -> None:
    """Configure the package's logging once, idempotently: one stderr
    handler on the ``yuma_simulation_tpu_torch`` logger. In a
    `torch.distributed` run, processes other than rank 0 log at WARNING, so
    a multi-process run emits one progress stream."""
    root = logging.getLogger("yuma_simulation_tpu_torch")
    if root.handlers:
        return
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        level = max(level, logging.WARNING)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s", datefmt="%H:%M:%S")
    )
    root.addHandler(handler)
    root.setLevel(level)

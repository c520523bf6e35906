"""The durable-file helpers of the JAX package's `utils/checkpoint.py`.

Every file is published under one crash-safety contract: written to a temp
name, fsync'd, renamed over the target, and the parent directory fsync'd,
so a crash at any instant leaves either the old file or the new one, never
a torn one (:func:`publish_atomic`). JSONL sinks that grow line by line
append with an fsync (:func:`append_durable`), which can tear only the
tail line, and are read back by :func:`read_jsonl_tolerant`, which drops
torn or undecodable lines. The metrics registry's snapshot sinks
(:mod:`..telemetry.metrics`) write through these. `CheckpointedSweep`, the
resumable sweep, waits for the resilience slice (ROADMAP queue A, slice 7).
"""

from __future__ import annotations

import errno
import json
import logging
import os
import pathlib
import shutil
import uuid

logger = logging.getLogger(__name__)


def _fsync_write(path: pathlib.Path, write_fn) -> None:
    """Write via `write_fn(file)` to `path`, flushed and fsync'd before
    close, so the rename that follows publishes durable bytes."""
    with open(path, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(directory: pathlib.Path) -> None:
    """fsync a directory (POSIX), so a rename into it survives power loss.
    Some filesystems refuse a read-only directory fsync; the publish has
    already happened then, and only its durability is at stake, so such a
    refusal is ignored."""
    if os.name != "posix":
        return
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _publish(tmp: pathlib.Path, final: pathlib.Path) -> None:
    """Atomically move `tmp` over `final` and fsync the parent directory. A
    temp file on another filesystem (EXDEV) is copied into the target
    directory first and renamed there."""
    try:
        tmp.replace(final)
    except OSError as e:
        if e.errno != errno.EXDEV:
            raise
        local_tmp = final.with_name(f".{final.name}.{uuid.uuid4().hex[:8]}.xdev.tmp")
        with open(tmp, "rb") as src:
            _fsync_write(local_tmp, lambda f: shutil.copyfileobj(src, f))
        local_tmp.replace(final)
        tmp.unlink(missing_ok=True)
    _fsync_dir(final.parent)


def publish_atomic(path: pathlib.Path, data: bytes, *, tmp_dir=None) -> None:
    """Publish `data` at `path`: written to a writer-unique temp name (pid
    and a nonce, so concurrent writers never truncate each other's temp),
    fsync'd, renamed, the parent directory fsync'd. `tmp_dir` stages the
    temp file elsewhere; across filesystems the publish copies it into the
    target directory and renames there, still atomic at the target."""
    path = pathlib.Path(path)
    nonce = f"{os.getpid()}.{uuid.uuid4().hex[:8]}"
    tmp_parent = pathlib.Path(tmp_dir) if tmp_dir is not None else path.parent
    tmp = tmp_parent / f".{path.name}.{nonce}.tmp"
    _fsync_write(tmp, lambda f: f.write(data))
    _publish(tmp, path)


def append_durable(path: pathlib.Path, data: bytes) -> None:
    """Append `data` to `path`, flushed and fsync'd before returning;
    parent directories are created on demand, and the directory is fsync'd
    when the append creates the file. A tail torn by an earlier crash (no
    final newline) is terminated first, so the damage stays confined to
    that one line, which :func:`read_jsonl_tolerant` drops."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    created = not path.exists()
    heal = b""
    if not created:
        with open(path, "rb") as r:
            r.seek(0, os.SEEK_END)
            if r.tell() > 0:
                r.seek(-1, os.SEEK_END)
                if r.read(1) != b"\n":
                    heal = b"\n"
    with open(path, "ab") as f:
        f.write(heal + data)
        f.flush()
        os.fsync(f.fileno())
    if created:
        _fsync_dir(path.parent)


def read_jsonl_tolerant(path: pathlib.Path) -> list[dict]:
    """Decode a JSONL sink: torn, undecodable and non-dict lines are dropped
    with a warning, never fatal; a missing file reads as empty."""
    path = pathlib.Path(path)
    if not path.exists():
        return []
    out: list[dict] = []
    for lineno, line in enumerate(path.read_text().splitlines()):
        if not line.strip():
            continue
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            logger.warning("dropping undecodable line %d in %s", lineno, path)
            continue
        if isinstance(record, dict):
            out.append(record)
    return out

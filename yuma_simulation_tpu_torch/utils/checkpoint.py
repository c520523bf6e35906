"""The durable-file helpers of the JAX package's `utils/checkpoint.py`.

Every file is published under one crash-safety contract: written to a temp
name, fsync'd, renamed over the target, and the parent directory fsync'd,
so a crash at any instant leaves either the old file or the new one, never
a torn one (:func:`publish_atomic`). JSONL sinks that grow line by line
append with an fsync (:func:`append_durable`), which can tear only the
tail line, and are read back by :func:`read_jsonl_tolerant`, which drops
torn or undecodable lines. The metrics registry's snapshot sinks
(:mod:`..telemetry.metrics`) write through these.

:class:`CheckpointedSweep` is the resumable, corruption-detecting sweep
driver over them. Its directory layout is the JAX package's, file for
file (`manifest.json` with the config fingerprint, `checksums.json` with
each chunk's sha256, `chunk_NNNNN.npz` holding one `result` array), so a
directory written by either package resumes in the other:

- every file is *published atomically* (temp name the completed-chunk glob
  cannot match, fsync, rename);
- every published chunk's sha256 is recorded in `checksums.json`, so
  corruption after the publish is detected rather than silently loaded;
- on resume, chunks that fail verification are *requeued*: the corrupt
  file is removed, one `event=checkpoint_chunk_requeued` record is logged,
  and the chunk is re-executed — the resumed sweep's output is bitwise an
  uninterrupted run's (the chunk functions are pure);
- at final load, a chunk that fails verification is re-executed once; a
  second failure raises
  :class:`..resilience.errors.CheckpointCorruptionError`.
"""

from __future__ import annotations

import dataclasses
import errno
import hashlib
import json
import logging
import os
import pathlib
import shutil
import uuid
from typing import Callable, Optional

import numpy as np

from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

_CHECKSUMS_NAME = "checksums.json"


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


def _file_sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


@dataclasses.dataclass
class CheckpointedSweep:
    """Chunked, resumable, corruption-detecting sweep driver.

    `fn(chunk_index) -> np.ndarray` computes one chunk (typically one unit
    of a supervised sweep, or a Monte-Carlo batch). `run()` executes all chunks not yet
    on disk (requeueing any whose snapshot fails verification), snapshots
    each atomically with a sha256 recorded in `checksums.json`, and
    returns the concatenated `[total, ...]` result. Metadata
    (`num_chunks`, user `tag`, and a `config` fingerprint) is pinned in
    `manifest.json` and validated on resume so a stale directory cannot
    silently mix configurations.

    `config` should capture everything that determines a chunk's value —
    version name, shapes, seed, hyperparameters. Any JSON-serializable
    pytree works; it is canonicalized (sorted keys) and fingerprinted, so
    resuming with a different config in the same directory fails loudly
    instead of reusing stale `chunk_*.npz` results.
    """

    directory: str | pathlib.Path
    num_chunks: int
    tag: str = ""
    config: object = None

    def __post_init__(self) -> None:
        self.directory = pathlib.Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        # In-memory view of checksums.json (this instance is the only
        # writer): loaded once, mutated alongside each publish — without
        # it a thousand-chunk sweep re-parses the growing sidecar per
        # chunk and resume becomes O(n^2) in JSON I/O.
        self._checksums: Optional[dict] = None
        manifest = self.directory / "manifest.json"
        try:
            # No `default=` fallback: a non-JSON value would fingerprint
            # as its repr (memory address) and never match on resume.
            fingerprint = json.dumps(self.config, sort_keys=True)
        except TypeError as e:
            raise TypeError(
                "CheckpointedSweep config must be JSON-serializable "
                f"(got {type(self.config).__name__}): {e}"
            ) from e
        meta = {
            "num_chunks": self.num_chunks,
            "tag": self.tag,
            "config_fingerprint": hashlib.sha256(
                fingerprint.encode()
            ).hexdigest(),
        }
        if manifest.exists():
            found = json.loads(manifest.read_text())
            # Key-by-key so a manifest written before `config_fingerprint`
            # existed (legacy layout) stays resumable; the missing key is
            # backfilled below rather than rejected.
            mismatched = {
                k: (found.get(k), v)
                for k, v in meta.items()
                if k in found and found[k] != v
            }
            if mismatched:
                raise ValueError(
                    f"checkpoint dir {self.directory} holds a different "
                    f"sweep: {mismatched}"
                )
            missing = set(meta) - set(found)
            if missing:
                if "config_fingerprint" in missing and self.completed_chunks():
                    # The legacy manifest never recorded what produced the
                    # existing chunks; stamping the current fingerprint is
                    # an assumption, not a verification.
                    logger.warning(
                        "legacy manifest in %s has no config_fingerprint; "
                        "existing chunks are assumed (not verified) to match "
                        "the current config",
                        self.directory,
                    )
                # Backfill only what's absent; keys written by a newer
                # version (present only in the old manifest) survive.
                self._write_json(manifest, found | {k: meta[k] for k in missing})
        else:
            self._write_json(manifest, meta)

    # -- atomic JSON sidecars ------------------------------------------

    def _write_json(self, path: pathlib.Path, obj) -> None:
        publish_atomic(path, json.dumps(obj).encode())

    def _load_checksums(self) -> dict:
        if self._checksums is not None:
            return self._checksums
        path = self.directory / _CHECKSUMS_NAME
        if not path.exists():
            self._checksums = {}
            return self._checksums
        try:
            self._checksums = json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            # A corrupt sidecar must not brick the directory: fall back
            # to probe-based verification for every chunk.
            logger.warning(
                "unreadable %s in %s; falling back to decode-probe "
                "verification", _CHECKSUMS_NAME, self.directory,
            )
            self._checksums = {}
        return self._checksums

    def _record_checksum(self, i: int, digest: str) -> None:
        sums = self._load_checksums()
        sums[f"{i:05d}"] = digest
        self._write_json(self.directory / _CHECKSUMS_NAME, sums)

    def _drop_checksum(self, i: int) -> None:
        sums = self._load_checksums()
        if sums.pop(f"{i:05d}", None) is not None:
            self._write_json(self.directory / _CHECKSUMS_NAME, sums)

    # -- chunk inventory -----------------------------------------------

    def _chunk_path(self, i: int) -> pathlib.Path:
        return self.directory / f"chunk_{i:05d}.npz"

    def completed_chunks(self) -> list[int]:
        """Chunk indices with a PUBLISHED snapshot (name-level only; use
        :meth:`verify_chunk` / `run()` for integrity)."""
        done = []
        for p in self.directory.glob("chunk_*.npz"):
            # A crash can leave partial files behind; only fully published
            # chunks (exact chunk_NNNNN.npz names) count.
            tail = p.stem.split("_", 1)[1]
            if tail.isdigit():
                done.append(int(tail))
        return sorted(done)

    def verify_chunk(self, i: int) -> bool:
        """Whether chunk `i`'s snapshot is present and intact: sha256
        against the checksum sidecar when recorded, else (legacy chunks)
        a full decode probe."""
        path = self._chunk_path(i)
        if not path.exists():
            return False
        recorded = self._load_checksums().get(f"{i:05d}")
        if recorded is not None:
            return _file_sha256(path) == recorded
        try:
            with np.load(path, allow_pickle=False) as z:
                z["result"]
            return True
        except Exception:
            return False

    def _try_load(self, i: int):
        """Decode chunk `i`'s payload, or None if the file is missing or
        undecodable (the caller requeues)."""
        try:
            return np.load(self._chunk_path(i), allow_pickle=False)["result"]
        except Exception:
            return None

    def corrupt_chunks(self) -> list[int]:
        """Published chunks that fail verification (truncated, bit-rotted,
        or undecodable) — what `run()` will requeue."""
        return [i for i in self.completed_chunks() if not self.verify_chunk(i)]

    # -- execution ------------------------------------------------------

    def _execute_chunk(self, fn, i: int) -> None:
        """Run chunk `i`, publish its snapshot atomically, record its
        checksum. The temp name is one the completed-chunk glob cannot
        match, so a crash mid-write is invisible to resume."""
        result = np.asarray(fn(i))
        tmp = self.directory / f"partial_{i:05d}.tmp"
        # savez gets an open handle so it cannot append its own .npz
        # suffix to the temp name; fsync before the rename so the
        # published name always refers to durable bytes.
        _fsync_write(tmp, lambda f: np.savez(f, result=result))
        digest = _file_sha256(tmp)
        published_bytes = tmp.stat().st_size
        _publish(tmp, self._chunk_path(i))
        self._record_checksum(i, digest)
        try:
            from yuma_simulation_tpu_torch.telemetry.metrics import get_registry

            get_registry().counter(
                "checkpoint_bytes",
                help="bytes of published checkpoint chunk snapshots",
            ).inc(published_bytes)
        except Exception:
            pass
        # Test-only hook: deterministic post-publish corruption
        # (resilience fault injection) to exercise detect-and-requeue.
        from yuma_simulation_tpu_torch.resilience import faults

        faults.mangle_chunk_file(self._chunk_path(i), i)

    def run(
        self,
        fn: Callable[[int], np.ndarray],
        *,
        progress: Optional[Callable[[int, int], None]] = None,
    ) -> np.ndarray:
        """Execute missing chunks (requeueing corrupt ones), snapshot
        each, return all results concatenated along axis 0 in chunk
        order."""
        from yuma_simulation_tpu_torch.resilience.errors import (
            CheckpointCorruptionError,
        )

        published = self.completed_chunks()
        done = set()
        recorded = self._load_checksums()
        for i in published:
            if self.verify_chunk(i):
                done.add(i)
                if f"{i:05d}" not in recorded:
                    # Legacy chunk that passed the decode probe: stamp
                    # its current digest so corruption from here on is
                    # checksum-detectable (the probe only proves the npz
                    # decodes today, not that it stays intact).
                    self._record_checksum(i, _file_sha256(self._chunk_path(i)))
            else:
                # Detect-and-requeue: remove the corrupt snapshot so the
                # chunk re-executes below; one structured record per
                # requeue so an operator can audit what was recomputed.
                log_event(
                    logger,
                    "checkpoint_chunk_requeued",
                    directory=str(self.directory),
                    chunk=i,
                    reason="verification_failed",
                )
                self._chunk_path(i).unlink(missing_ok=True)
                self._drop_checksum(i)
        if done:
            logger.info(
                "resuming sweep in %s: %d/%d chunks already done",
                self.directory,
                len(done),
                self.num_chunks,
            )
        executed = set()
        for i in range(self.num_chunks):
            if i in done:
                continue
            self._execute_chunk(fn, i)
            executed.add(i)
            if progress is not None:
                progress(i, self.num_chunks)
        parts = []
        for i in range(self.num_chunks):
            # Chunks already sha256-verified in the resume pre-pass are
            # not re-hashed (that would double every resume's I/O), but
            # every chunk must still DECODE — corruption racing a long
            # run surfaces as a load failure and requeues below. Chunks
            # executed THIS run are checksum-verified here, which is
            # where injected post-publish corruption (and any real torn
            # write) gets caught.
            part = None
            if i not in executed or self.verify_chunk(i):
                part = self._try_load(i)
            if part is None:
                # Re-execute once, then give up loudly rather than
                # concatenate poisoned bytes.
                log_event(
                    logger,
                    "checkpoint_chunk_requeued",
                    directory=str(self.directory),
                    chunk=i,
                    reason="post_run_verification_failed",
                )
                self._chunk_path(i).unlink(missing_ok=True)
                self._drop_checksum(i)
                self._execute_chunk(fn, i)
                part = self._try_load(i) if self.verify_chunk(i) else None
                if part is None:
                    raise CheckpointCorruptionError(
                        f"chunk {i} in {self.directory} failed "
                        "verification immediately after re-execution; "
                        "the storage under this directory is unreliable"
                    )
            parts.append(part)
        return np.concatenate(parts, axis=0)

"""Build the CUDA sources under `csrc/` into shared libraries, cache them on
disk, and load them.

Each `csrc/*.cu` compiles with `nvcc` into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded
with `ctypes`. Every source that must be built is compiled by its own
`nvcc` process, all started together.

The libraries live in a content-addressed cache, the port's counterpart of
the JAX package's AOT executable cache (`simulation/aot.py` there and
here), rooted at the build directory: `build/yuma_simulation_tpu_torch/`
beside the package, `$YUMA_TORCH_BUILD_DIR`, or the directory
:func:`configure_executable_cache` names. A library is keyed twice:

- by its **program**: a sha256 of the sources, the headers and the flags
  (:func:`library_digest`), the entry directory `<stem>-<digest>/`;
- by its **environment** (:func:`environment_descriptor`): the `nvcc`
  release line, the CUDA runtime torch was built with, and the card's
  name and compute capability, hashed into the file names
  `<envkey>.json` (metadata) and `<envkey>-<sha>.so` (the library, named by
  its own sha256, so a published library is never rewritten).

The metadata is published last and records the library's sha256, which is
checked before `ctypes.CDLL` sees the file. Builds into one cache
root are serialized across processes by an exclusive `fcntl` lock on
`<root>/.build.lock` (:func:`_build_lock`): a process that waited on it
looks its missing libraries up again, so processes cold-started together
on one empty cache build each library once between them. Every lookup is
one typed
outcome (``event=executable_cache_hit`` / ``_miss`` with a ``reason``:
absent, torn_metadata, blob_missing, corrupt, unloadable / ``_stale``: the
program was built only under another environment) on the registry's
``executable_cache_*`` counters, and a miss or a stale entry is rebuilt. A
failed build raises; nothing falls back to a plain version.

Flags: `sm_90a` (Hopper), IEEE division and square root (nvcc's default),
and `--fmad=false` so that no multiply-add is contracted into an FMA: the
kernels then round every operation as the plain PyTorch versions do. The
compiler's `-Xptxas -v` report (registers, shared memory, spills) is kept
beside each library as `<envkey>.ptxas.txt`.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import fcntl
import hashlib
import json
import logging
import os
import shutil
import subprocess
import threading
import uuid
from pathlib import Path
from typing import Optional

from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("consensus.cu", "case_scan.cu", "ema_scan.cu", "mc_weights.cu")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

#: The environment variable naming the build directory, which is the
#: library cache's root (the JAX package's ``EXECUTABLE_CACHE_ENV``).
EXECUTABLE_CACHE_ENV = "YUMA_TORCH_BUILD_DIR"

#: The cache's statistics file (:meth:`ExecutableCache.write_stats`).
STATS_FILENAME = "cache_stats.json"

#: Guards the memo, the active cache and every build and load.
_lock = threading.RLock()
#: Loaded libraries by (program digest, environment key): a library is
#: loaded once per process, whatever root it was found under.
_libs: dict[tuple[str, str], ctypes.CDLL] = {}
_DIGESTS: dict[str, str] = {}
_ENVS: dict[int, tuple[dict, str]] = {}
_NVCC_RELEASE: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME and /usr/local/cuda): "
        "the CUDA kernels are built on first use and need the CUDA toolkit"
    )


def library_digest(source: str) -> str:
    """The program key of `csrc/<source>`: a sha256 of every header, the
    source and the flags (16 hex digits). Read once per process."""
    digest = _DIGESTS.get(source)
    if digest is None:
        h = hashlib.sha256()
        for path in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
            h.update(path.name.encode())
            h.update(path.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        digest = _DIGESTS[source] = h.hexdigest()[:16]
    return digest


def nvcc_release() -> str:
    """The release line of ``nvcc --version`` (e.g. "Cuda compilation
    tools, release 12.8, V12.8.93"), asked once per process."""
    nvcc = _nvcc()
    line = _NVCC_RELEASE.get(nvcc)
    if line is None:
        out = subprocess.run(
            [nvcc, "--version"], capture_output=True, text=True, check=True, timeout=120
        ).stdout
        lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
        line = _NVCC_RELEASE[nvcc] = lines[-1] if lines else out.strip().splitlines()[-1]
    return line


def environment_descriptor() -> dict:
    """What a library is valid under: the `nvcc` release, the CUDA runtime
    torch was built with, and the current card's name and compute
    capability. Composed into every cache key, so a toolkit, runtime or
    card change turns a cached library into a typed stale miss instead of
    a library loaded under the wrong toolchain. Needs CUDA and `nvcc`;
    read once per process and card."""
    return _environment()[0]


def environment_key(env: dict) -> str:
    return hashlib.sha256(json.dumps(env, sort_keys=True).encode()).hexdigest()[:16]


def _environment() -> tuple[dict, str]:
    import torch

    index = torch.cuda.current_device()
    found = _ENVS.get(index)
    if found is None:
        major, minor = torch.cuda.get_device_capability(index)
        env = {
            "nvcc": nvcc_release(),
            "torch_cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(index),
            "capability": f"{major}.{minor}",
        }
        found = _ENVS[index] = (env, environment_key(env))
    return found


def memo_key(source: str) -> tuple[str, str]:
    """The in-process key of `source`'s library: its program digest and
    the environment key of the current card."""
    return library_digest(source), _environment()[1]


@dataclasses.dataclass
class AotStats:
    """Process-lifetime cache counters (the JAX package's fields).
    ``hits`` counts libraries loaded from disk (one per library per
    process: later launches ride the in-process memo); ``builds`` counts
    true `nvcc` compiles; ``errors`` counts failed builds and loads."""

    hits: int = 0
    misses: int = 0
    stale: int = 0
    builds: int = 0
    errors: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class ExecutableCache:
    """The libraries under `root` (see the module docstring for the
    layout). `env` defaults to :func:`environment_descriptor`, read at the
    first lookup (it needs the card). ``miss_reasons`` counts the misses
    by reason."""

    def __init__(self, root, env: Optional[dict] = None):
        self.root = Path(root)
        self._env = env
        self.stats = AotStats()
        self.miss_reasons: collections.Counter = collections.Counter()
        try:
            from yuma_simulation_tpu_torch.telemetry.metrics import get_registry

            registry = get_registry()
            self._counters = {
                "hits": registry.counter("executable_cache_hits"),
                "misses": registry.counter("executable_cache_misses"),
                "stale": registry.counter("executable_cache_stale"),
                "builds": registry.counter("executable_cache_builds"),
            }
        except Exception:  # metrics must never break a build
            self._counters = {}

    @property
    def env(self) -> dict:
        if self._env is None:
            self._env = environment_descriptor()
        return self._env

    @property
    def env_key(self) -> str:
        return environment_key(self.env)

    def entry_dir(self, source: str) -> Path:
        return self.root / f"{Path(source).stem}-{library_digest(source)}"

    def meta_path(self, source: str) -> Path:
        return self.entry_dir(source) / f"{self.env_key}.json"

    def _count(self, key: str, n: int = 1) -> None:
        setattr(self.stats, key, getattr(self.stats, key) + n)
        counter = self._counters.get(key)
        if counter is not None:
            counter.inc(n)

    def _miss(self, source: str, reason: str) -> None:
        self._count("misses")
        self.miss_reasons[reason.split(":")[0]] += 1
        log_event(
            logger, "executable_cache_miss",
            level=logging.DEBUG if reason == "absent" else logging.INFO,
            source=source, digest=library_digest(source), reason=reason,
        )

    def lookup(self, source: str, *, record: bool = True) -> Optional[Path]:
        """The path of `source`'s library under this environment, its
        bytes checked against the metadata, or None with exactly one typed
        event saying why (none when `record` is false: a second look of
        one resolve). Never raises for a bad entry."""

        def refuse(reason: str, foreign: int = 0) -> None:
            if record and reason == "stale":
                self._stale(source, foreign)
            elif record:
                self._miss(source, reason)
            return None

        meta_path = self.meta_path(source)
        if not meta_path.exists():
            try:
                foreign = [p for p in meta_path.parent.glob("*.json") if p != meta_path]
            except OSError:
                foreign = []
            return refuse("stale", len(foreign)) if foreign else refuse("absent")
        try:
            meta = json.loads(meta_path.read_text())
            blob_path = meta_path.parent / meta["blob"]
            want = meta["blob_sha256"]
        except (OSError, ValueError, KeyError, TypeError):
            return refuse("torn_metadata")
        try:
            blob = blob_path.read_bytes()
        except OSError:
            return refuse("blob_missing")
        if hashlib.sha256(blob).hexdigest() != want:
            return refuse("corrupt")
        if meta.get("environment") != self.env:
            # The key names the file, so only a collision or a hand-copied
            # entry reaches here: refuse it rather than load it.
            return refuse("stale", 1)
        return blob_path

    def _stale(self, source: str, foreign: int) -> None:
        self._count("stale")
        log_event(
            logger, "executable_cache_stale", level=logging.INFO, source=source,
            digest=library_digest(source), foreign_artifacts=foreign, env_key=self.env_key,
        )

    def hit(self, source: str, path: Path) -> None:
        self._count("hits")
        log_event(
            logger, "executable_cache_hit", level=logging.INFO, source=source,
            digest=library_digest(source), bytes=path.stat().st_size,
        )

    def publish(self, source: str, built: Path, log: str) -> Path:
        """Move a freshly built library into the cache under its own
        sha256, then the compiler's report, then the metadata, last, so a
        reader that sees the metadata sees a whole library. Concurrent
        builders of one library each publish whole files; the last
        metadata wins and names a library that exists."""
        from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

        entry = self.entry_dir(source)
        entry.mkdir(parents=True, exist_ok=True)
        sha = hashlib.sha256(built.read_bytes()).hexdigest()
        blob = entry / f"{self.env_key}-{sha[:16]}.so"
        os.replace(built, blob)
        publish_atomic(entry / f"{self.env_key}.ptxas.txt", log.encode())
        meta = {
            "source": source,
            "digest": library_digest(source),
            "environment": self.env,
            "blob": blob.name,
            "blob_sha256": sha,
            "blob_bytes": blob.stat().st_size,
            "flags": list(NVCC_FLAGS),
        }
        publish_atomic(self.meta_path(source), json.dumps(meta, sort_keys=True).encode())
        return blob

    def entries_on_disk(self) -> int:
        try:
            return sum(1 for _ in self.root.glob("*-*/*.json"))
        except OSError:
            return 0

    def stats_payload(self) -> dict:
        return {
            **self.stats.to_json(),
            "miss_reasons": dict(self.miss_reasons),
            "environment": self._env,
            "env_key": environment_key(self._env) if self._env is not None else None,
            "entries_on_disk": self.entries_on_disk(),
            "root": str(self.root),
        }

    def write_stats(self, path=None) -> dict:
        """Publish this cache's statistics (``cache_stats.json`` under the
        root by default) and return them."""
        from yuma_simulation_tpu_torch.utils.checkpoint import publish_atomic

        payload = self.stats_payload()
        target = Path(path) if path is not None else self.root / STATS_FILENAME
        target.parent.mkdir(parents=True, exist_ok=True)
        publish_atomic(target, json.dumps(payload, indent=2, sort_keys=True).encode())
        return payload


# ---------------------------------------------------------------------------
# the active cache

_ACTIVE: Optional[ExecutableCache] = None
_EXPLICIT = False
#: The counters of every cache this process has retired, so
#: :func:`process_stats` never goes backwards when the root changes.
_RETIRED = AotStats()


def _default_root() -> Path:
    env = os.environ.get(EXECUTABLE_CACHE_ENV)
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "yuma_simulation_tpu_torch"


def _retire(cache: ExecutableCache) -> None:
    for field in dataclasses.fields(AotStats):
        setattr(_RETIRED, field.name,
                getattr(_RETIRED, field.name) + getattr(cache.stats, field.name))


def configure_executable_cache(root) -> ExecutableCache:
    """Make `root` the build directory of this process (created if
    absent) and return its cache. Libraries already loaded stay loaded:
    they are keyed by program and environment, not by root."""
    global _ACTIVE, _EXPLICIT
    cache = ExecutableCache(root)
    cache.root.mkdir(parents=True, exist_ok=True)
    with _lock:
        if _ACTIVE is not None:
            _retire(_ACTIVE)
        _ACTIVE, _EXPLICIT = cache, True
    return cache


def deactivate_executable_cache() -> None:
    """Return to the default build directory and forget the loaded
    libraries (their handles stay open; the next launch looks them up on
    disk again)."""
    global _ACTIVE, _EXPLICIT
    with _lock:
        if _ACTIVE is not None:
            _retire(_ACTIVE)
        _ACTIVE, _EXPLICIT = None, False
        _libs.clear()


def active_cache() -> ExecutableCache:
    """The cache the next build or load goes through: the configured one,
    else one at `$YUMA_TORCH_BUILD_DIR`, else at the default build
    directory. Unlike the JAX package's, it always exists: the kernels
    cannot run without their libraries."""
    global _ACTIVE
    with _lock:
        if _ACTIVE is None or (not _EXPLICIT and _ACTIVE.root != _default_root()):
            if _ACTIVE is not None:
                _retire(_ACTIVE)
            _ACTIVE = ExecutableCache(_default_root())
        return _ACTIVE


def build_dir() -> Path:
    return active_cache().root


def process_stats() -> AotStats:
    """The process's cumulative counters: every retired cache's and the
    active one's (what the recompilation sentinel differences)."""
    with _lock:
        total = dataclasses.replace(_RETIRED)
        if _ACTIVE is not None:
            for field in dataclasses.fields(AotStats):
                setattr(total, field.name,
                        getattr(total, field.name) + getattr(_ACTIVE.stats, field.name))
        return total


# ---------------------------------------------------------------------------
# build and load


def _compile_all(jobs: dict[str, Path]) -> dict[str, tuple[int, str]]:
    """Compile each source of `jobs` to its output path, one `nvcc` per
    source, all started together. Returns `{source: (exit code, log)}`."""
    nvcc = _nvcc()
    procs = {
        src: subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, out in jobs.items()
    }
    results = {}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        results[src] = (proc.returncode, log)
    return results


def _dlopen(path: Path):
    return ctypes.CDLL(str(path))


#: The cross-process build lock's file name, under the cache's root.
BUILD_LOCK = ".build.lock"


@contextlib.contextmanager
def _build_lock(root: Path):
    """Hold the cache root's exclusive build lock (`fcntl.flock`, released
    when the process dies, so a killed builder never wedges the others)."""
    root.mkdir(parents=True, exist_ok=True)
    with open(root / BUILD_LOCK, "a+") as f:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)


def _resolve(cache: ExecutableCache, sources) -> None:
    """Load every library of `sources` not yet in the memo: the cached
    ones whose bytes check out, and the rest after one parallel build."""
    found = {}

    def load(srcs, record: bool = True) -> list:
        """Load what the cache holds of `srcs`; return the rest."""
        missing = []
        for src in srcs:
            path = cache.lookup(src, record=record)
            if path is None:
                missing.append(src)
                continue
            try:
                found[src] = _dlopen(path)
            except OSError as exc:
                if record:
                    cache._miss(src, f"unloadable:{type(exc).__name__}")
                missing.append(src)
                continue
            cache.hit(src, path)
        return missing

    build = load([src for src in sources if memo_key(src) not in _libs])
    if build:
        with _build_lock(cache.root):
            # Another process may have published while this one waited.
            # Each library's miss was counted by the first look.
            build = load(build, record=False)
            if build:
                _build_missing(cache, build, found)
    for src, lib in found.items():
        _libs[memo_key(src)] = lib


def _build_missing(cache: "ExecutableCache", build: list, found: dict) -> None:
    """Build every source of `build` (one `nvcc` each, all together),
    publish each library and load it into `found`."""
    nonce = f"{os.getpid()}.{uuid.uuid4().hex[:8]}"
    jobs = {src: cache.root / f".{Path(src).stem}.{nonce}.so.tmp" for src in build}
    failures = []
    try:
        for src, (code, log) in _compile_all(jobs).items():
            if code != 0:
                failures.append(f"nvcc {src} failed (exit {code}):\n{log}")
                continue
            cache._count("builds")
            found[src] = _dlopen(cache.publish(src, jobs[src], log))
    except Exception:  # counted, then raised as it came
        cache._count("errors")
        raise
    finally:
        for tmp in jobs.values():
            tmp.unlink(missing_ok=True)
    if failures:
        cache._count("errors", len(failures))
        raise RuntimeError("\n".join(failures))


def resolve(cache: Optional[ExecutableCache] = None) -> None:
    """Load every library not yet loaded in this process through `cache`
    (default: the active one), building the missing ones."""
    with _lock:
        _resolve(cache if cache is not None else active_cache(), SOURCES)


def load(source: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<source>`. Its first call in a
    process resolves every source through the active cache, building the
    missing ones; later calls are a dictionary lookup."""
    key = memo_key(source)
    lib = _libs.get(key)
    if lib is None:
        resolve()
        lib = _libs[key]
    return lib

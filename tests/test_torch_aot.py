"""The kernel-library cache (`ops/_build.py`) and its AOT surface
(`simulation/aot.py`, `utils/profiling.py::RecompilationSentinel`,
`telemetry/device.py::CompileTracker`), on the CPU.

There is no `nvcc` and no card here, so the tests drive the cache with a
stand-in compiler (`_build._compile_all`: writes a small file for each
source and returns its "ptxas" log), a stand-in loader (`_build._dlopen`:
reads the file back, refuses one that starts with b"bad") and a fixed
environment descriptor. Everything else is the code the card runs: the
layout, the digests, the typed lookups (absent, torn_metadata,
blob_missing, corrupt, unloadable, stale), the publication order, the
memo, the counters and events, fresh processes and two concurrent
builders. The card tests (`test_torch_cuda.py`) build and load the real
libraries.
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from yuma_simulation_tpu.simulation import aot as jaot
from yuma_simulation_tpu_torch.models.config import YumaConfig
from yuma_simulation_tpu_torch.ops import _build
from yuma_simulation_tpu_torch.simulation import aot
from yuma_simulation_tpu_torch.simulation.planner import plan_dispatch
from yuma_simulation_tpu_torch.telemetry.device import CompileTracker
from yuma_simulation_tpu_torch.telemetry.metrics import get_registry
from yuma_simulation_tpu_torch.utils.profiling import (
    RecompilationBudgetExceeded,
    RecompilationSentinel,
    enable_compilation_cache,
)

REPO = Path(__file__).resolve().parent.parent
ENV = {"nvcc": "Cuda compilation tools, release 12.8, V12.8.93", "torch_cuda": "12.8",
       "device": "NVIDIA H100 80GB HBM3", "capability": "9.0"}
NSRC = len(_build.SOURCES)

#: The stand-ins, also run in fresh processes (see `_child`).
FAKES = textwrap.dedent('''
    import time
    from yuma_simulation_tpu_torch.ops import _build

    ENV = %r
    CALLS = []

    class FakeLib:
        def __init__(self, path):
            self.path = path
            self.data = path.read_bytes()
            if self.data.startswith(b"bad"):
                raise OSError(f"{path}: invalid ELF header")

    def compile_all(jobs, delay=0.0, fail=(), bad=()):
        CALLS.append(sorted(jobs))
        time.sleep(delay)
        out = {}
        for src, path in jobs.items():
            if src in fail:
                out[src] = (1, f"ptxas fatal : {src}")
                continue
            body = b"bad" if src in bad else b"lib"
            path.write_bytes(body + f" {src} {_build.library_digest(src)}".encode() * 64)
            out[src] = (0, f"ptxas info : {src}")
        return out

    def install(monkeypatch=None, **kw):
        env = (ENV, _build.environment_key(ENV))
        set_ = monkeypatch.setattr if monkeypatch else (lambda o, n, v: setattr(o, n, v))
        set_(_build, "_environment", lambda: env)
        set_(_build, "_compile_all", lambda jobs: compile_all(jobs, **kw))
        set_(_build, "_dlopen", FakeLib)
''') % (ENV,)
_fakes: dict = {}
exec(FAKES, _fakes)


@pytest.fixture
def fake(monkeypatch, tmp_path):
    """The stand-ins installed, the cache rooted at a fresh directory, and
    the process's cache state restored afterwards."""
    _build.deactivate_executable_cache()
    _fakes["CALLS"].clear()
    _fakes["install"](monkeypatch)
    cache = aot.configure_executable_cache(tmp_path / "cache")
    yield cache
    _build.deactivate_executable_cache()


def _reopen(root):
    """The next process's view: the memo dropped, the same root."""
    _build.deactivate_executable_cache()
    return aot.configure_executable_cache(root)


def test_surface_equals_jax():
    assert [f.name for f in dataclasses.fields(aot.AotStats)] == [
        f.name for f in dataclasses.fields(jaot.AotStats)]
    assert [f.name for f in dataclasses.fields(aot.AotExecutable)] == [
        f.name for f in dataclasses.fields(jaot.AotExecutable)]
    assert aot.EXECUTABLE_CACHE_ENV == "YUMA_TORCH_BUILD_DIR"
    assert aot.STATS_FILENAME == jaot.STATS_FILENAME
    for name in ("configure_executable_cache", "deactivate_executable_cache", "active_cache",
                 "process_stats", "executable_for_plan", "preload_shapes",
                 "environment_descriptor", "ExecutableCache"):
        assert callable(getattr(aot, name)) and callable(getattr(jaot, name)), name
    assert not hasattr(aot, "dispatch_via_cache")


def test_cold_then_warm(fake, caplog):
    caplog.set_level(logging.DEBUG, logger="yuma_simulation_tpu_torch.ops._build")
    lib = _build.load("case_scan.cu")
    assert fake.stats.to_json() == dict(hits=0, misses=NSRC, stale=0, builds=NSRC, errors=0)
    assert fake.miss_reasons == {"absent": NSRC} and len(_fakes["CALLS"]) == 1
    key = _build.environment_key(ENV)
    for src in _build.SOURCES:
        entry = fake.entry_dir(src)
        assert entry.name == f"{Path(src).stem}-{_build.library_digest(src)}"
        meta = json.loads((entry / f"{key}.json").read_text())
        blob = entry / meta["blob"]
        assert meta["environment"] == ENV and meta["digest"] == _build.library_digest(src)
        assert blob.name.startswith(key) and blob.stat().st_size == meta["blob_bytes"]
        assert (entry / f"{key}.ptxas.txt").read_text() == f"ptxas info : {src}"
    assert lib.path == fake.entry_dir("case_scan.cu") / json.loads(
        fake.meta_path("case_scan.cu").read_text())["blob"]
    assert _build.load("case_scan.cu") is lib  # the memo: no lookup, no build
    assert fake.stats.builds == NSRC and not list(fake.root.glob(".*tmp"))
    events = [r.getMessage() for r in caplog.records]
    assert sum("event=executable_cache_miss" in e and "reason=absent" in e
               for e in events) == NSRC

    warm = _reopen(fake.root)
    caplog.clear()
    assert _build.load("consensus.cu").data == _build._libs[_build.memo_key("consensus.cu")].data
    assert warm.stats.to_json() == dict(hits=NSRC, misses=0, stale=0, builds=0, errors=0)
    assert len(_fakes["CALLS"]) == 1
    assert sum("event=executable_cache_hit" in r.getMessage() for r in caplog.records) == NSRC
    stats = warm.write_stats()
    assert json.loads((fake.root / "cache_stats.json").read_text()) == stats
    assert stats["entries_on_disk"] == NSRC and stats["environment"] == ENV


def _damage(cache, src, how):
    meta_path = cache.meta_path(src)
    blob = meta_path.parent / json.loads(meta_path.read_text())["blob"]
    if how == "corrupt":
        blob.write_bytes(blob.read_bytes()[:40])
    elif how == "torn_metadata":
        meta_path.write_text('{"blob": ')
    elif how == "blob_missing":
        blob.unlink()
    elif how == "stale":
        meta_path.rename(meta_path.with_name("0123456789abcdef.json"))


@pytest.mark.parametrize("how", ["corrupt", "torn_metadata", "blob_missing", "stale"])
def test_damaged_library_is_a_typed_miss_and_rebuilt(fake, how):
    _build.load("case_scan.cu")
    _damage(fake, "ema_scan.cu", how)
    again = _reopen(fake.root)
    lib = _build.load("ema_scan.cu")
    want = dict(hits=NSRC - 1, misses=0 if how == "stale" else 1, stale=int(how == "stale"),
                builds=1, errors=0)
    assert again.stats.to_json() == want
    assert again.miss_reasons == ({} if how == "stale" else {how: 1})
    assert _fakes["CALLS"][-1] == ["ema_scan.cu"]
    meta = json.loads(again.meta_path("ema_scan.cu").read_text())
    assert lib.path.name == meta["blob"] and not lib.data.startswith(b"bad")
    _reopen(fake.root)
    _build.load("ema_scan.cu")
    assert _build.active_cache().stats.hits == NSRC


def test_another_environment_is_stale(fake, monkeypatch):
    _build.load("case_scan.cu")
    other = dict(ENV, nvcc="Cuda compilation tools, release 12.9, V12.9.41")
    again = _reopen(fake.root)
    monkeypatch.setattr(_build, "_environment", lambda: (other, _build.environment_key(other)))
    _build.load("case_scan.cu")
    assert again.stats.to_json() == dict(hits=0, misses=0, stale=NSRC, builds=NSRC, errors=0)
    for src in _build.SOURCES:
        assert len(list(again.entry_dir(src).glob("*.json"))) == 2
    # A metadata file under this key whose recorded environment differs.
    _damage(again, "consensus.cu", "corrupt")
    meta_path = again.meta_path("consensus.cu")
    meta = json.loads(meta_path.read_text())
    blob = meta_path.parent / meta["blob"]
    blob.write_bytes(b"lib")
    import hashlib

    meta.update(blob_sha256=hashlib.sha256(b"lib").hexdigest(), environment=ENV)
    meta_path.write_text(json.dumps(meta))
    third = _reopen(fake.root)
    _build.load("consensus.cu")
    assert (third.stats.stale, third.stats.builds, third.stats.hits) == (1, 1, NSRC - 1)


def test_unloadable_library_is_rebuilt_and_a_failed_build_raises(fake, monkeypatch):
    _fakes["install"](monkeypatch, bad=("mc_weights.cu",))
    with pytest.raises(OSError, match="invalid ELF header"):
        _build.load("case_scan.cu")
    assert fake.stats.errors == 1
    _fakes["install"](monkeypatch)
    again = _reopen(fake.root)
    _build.load("mc_weights.cu")
    assert again.miss_reasons == {"unloadable": 1} and again.stats.builds == 1

    _fakes["install"](monkeypatch, fail=("case_scan.cu",))
    _build.deactivate_executable_cache()
    fresh = aot.configure_executable_cache(fake.root.parent / "fresh")
    with pytest.raises(RuntimeError, match=r"nvcc case_scan.cu failed \(exit 1\)"):
        _build.load("case_scan.cu")
    assert fresh.stats.errors == 1 and fresh.stats.builds == NSRC - 1
    assert not fresh.meta_path("case_scan.cu").exists()


def test_reconfigured_root_neither_reloads_nor_mixes(fake, tmp_path):
    lib = _build.load("case_scan.cu")
    before = _build.process_stats()
    other = aot.configure_executable_cache(tmp_path / "other")
    assert _build.load("case_scan.cu") is lib  # same program, same environment
    assert other.stats.to_json() == aot.AotStats().to_json()
    assert not list(other.root.iterdir())
    _build.deactivate_executable_cache()
    other = aot.configure_executable_cache(tmp_path / "other")
    assert _build.load("case_scan.cu") is not lib
    assert other.stats.builds == NSRC
    after = _build.process_stats()
    assert after.builds == before.builds + NSRC and after.misses == before.misses + NSRC


def test_build_dir_follows_the_environment_variable(monkeypatch, tmp_path):
    _build.deactivate_executable_cache()
    monkeypatch.delenv(aot.EXECUTABLE_CACHE_ENV, raising=False)
    assert _build.build_dir() == REPO / "build" / "yuma_simulation_tpu_torch"
    monkeypatch.setenv(aot.EXECUTABLE_CACHE_ENV, str(tmp_path / "env"))
    assert aot.active_cache().root == tmp_path / "env" == _build.build_dir()
    assert enable_compilation_cache(None) == str(tmp_path / "env")
    assert enable_compilation_cache(str(tmp_path / "x")) == str(tmp_path / "x")
    assert (tmp_path / "x").is_dir() and _build.build_dir() == tmp_path / "x"
    monkeypatch.setenv(aot.EXECUTABLE_CACHE_ENV, str(tmp_path / "ignored"))
    assert _build.build_dir() == tmp_path / "x"  # an explicit root wins
    _build.deactivate_executable_cache()


def test_sentinel_and_tracker(fake):
    tracker = CompileTracker()
    recompiles = get_registry().counter("recompiles")
    before = recompiles.value
    with pytest.raises(RecompilationBudgetExceeded, match=f"{NSRC} kernel libraries built"):
        with RecompilationSentinel(budget=0, label="cold"):
            _build.load("case_scan.cu")
    assert recompiles.value == before + NSRC and tracker.record() == NSRC
    assert tracker.record() == 0
    _reopen(fake.root)
    with RecompilationSentinel(budget=0, label="warm") as warm:
        _build.load("case_scan.cu")
    assert (warm.aot_hits, warm.aot_builds, warm.new_entries) == (NSRC, 0, 0)
    _build.deactivate_executable_cache()
    aot.configure_executable_cache(fake.root.parent / "second")
    with RecompilationSentinel(budget=NSRC) as cold:
        _build.load("case_scan.cu")
    assert cold.aot_builds == NSRC and tracker.record() == NSRC
    with pytest.raises(ValueError, match="boom"):
        with RecompilationSentinel(budget=0):
            raise ValueError("boom")


def test_environment_descriptor_asks_nvcc_once(monkeypatch, tmp_path):
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\necho x >> %s\necho 'nvcc: NVIDIA (R) Cuda compiler driver'\n"
        "echo 'Cuda compilation tools, release 12.8, V12.8.93'\necho 'Build cuda_12.8'\n" % calls)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_NVCC_RELEASE", {})
    monkeypatch.setattr(_build, "_ENVS", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i: (9, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    assert _build.environment_descriptor() == ENV
    assert _build.environment_descriptor() == ENV and aot.environment_descriptor() == ENV
    assert calls.read_text().count("x") == 1
    key = _build.environment_key(ENV)
    assert len(key) == 16 and key != _build.environment_key(dict(ENV, capability="9.0a"))


def test_executable_for_plan_and_preload(fake):
    cpu = plan_dispatch("p", (16, 8, 128), "Yuma 1 (paper)", YumaConfig(), torch.float32,
                        device="cpu")
    assert aot.executable_for_plan(cpu) is None and cpu.attach_executable() is cpu
    assert aot.preload_shapes([(16, 8, 128), (40, 3, 2)], device="cpu") == 0
    assert fake.stats.builds == 0  # nothing of the CPU path builds
    card = plan_dispatch("p", (16, 8, 128), "Yuma 1 (paper)", YumaConfig(), torch.float32,
                         device="cuda", check_memory=False)
    eager = plan_dispatch("p", (16, 8, 128), "Yuma 1 (paper)", YumaConfig(), torch.float32,
                          device="cuda", check_memory=False, epoch_impl="eager")
    assert aot.executable_for_plan(eager) is None
    attached = card.attach_executable()
    exe = attached.executable
    assert (exe.source, exe.fingerprint) == ("built", _build.library_digest("case_scan.cu"))
    assert attached == card and attached.to_json()["executable"] == exe.describe()
    assert aot.executable_for_plan(card).source == "cache"
    assert fake.stats.builds == NSRC


def _child(root: Path, script: str, **kw) -> subprocess.Popen:
    code = FAKES + textwrap.dedent(f'''
        install(**{kw!r})
        import json, pathlib
        cache = _build.configure_executable_cache(pathlib.Path({str(root)!r}))
        {script}
        print(json.dumps(cache.stats_payload()))
    ''')
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(REPO)})


def _stats(proc) -> dict:
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1])


def test_fresh_processes_and_concurrent_builders(tmp_path):
    """Two builders started together into one empty root both finish and
    build each library once between them: both miss every library, one
    builds and publishes all of them under the root's build lock, and the
    other, having waited on the lock, loads what it published. A third
    process then loads all of them without building, each library's bytes
    checked against the metadata."""
    root = tmp_path / "shared"
    load_all = "[_build.load(s) for s in _build.SOURCES]"
    # Both builders start their first look together (however long each
    # takes to start), so the other is still building when either looks.
    ready, go = tmp_path / "ready", tmp_path / "go"
    ready.mkdir()
    start_together = (
        f"import os, time; pathlib.Path({str(ready)!r}, str(os.getpid())).touch(); "
        f"[time.sleep(0.01) for _ in iter(lambda: pathlib.Path({str(go)!r}).exists(), True)]; "
    )
    a, b = (_child(root, start_together + load_all, delay=1.0) for _ in range(2))
    deadline = time.monotonic() + 120
    while len(list(ready.iterdir())) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    go.touch()
    pair = [_stats(a), _stats(b)]
    both = sorted(((s["builds"], s["hits"]) for s in pair), reverse=True)
    assert both == [(NSRC, 0), (0, NSRC)], both
    for stats in pair:
        assert (stats["misses"], stats["errors"]) == (NSRC, 0)
        assert stats["miss_reasons"] == {"absent": NSRC}
    warm = _stats(_child(root, load_all + "; assert not CALLS"))
    assert (warm["hits"], warm["builds"], warm["misses"], warm["stale"]) == (NSRC, 0, 0, 0)
    assert warm["entries_on_disk"] == NSRC


def test_cli_executable_cache_flag(tmp_path, capsys):
    """`--executable-cache DIR` makes DIR the build directory and prints and
    publishes its statistics (on the CPU nothing is built or loaded)."""
    from yuma_simulation_tpu_torch.cli import total_dividends_sheet_generator as cli

    _build.deactivate_executable_cache()
    try:
        cli.main(["--device", "cpu", "--bond-penalty", "0", "--out-dir", str(tmp_path / "out"),
                  "--executable-cache", str(tmp_path / "kc")])
        assert _build.build_dir() == tmp_path / "kc"
    finally:
        _build.deactivate_executable_cache()
    line = [ln for ln in capsys.readouterr().out.splitlines() if "executable_cache" in ln][-1]
    stats = json.loads(line)["executable_cache"]
    assert stats == json.loads((tmp_path / "kc" / "cache_stats.json").read_text())
    assert stats["builds"] == stats["hits"] == 0 and stats["root"] == str(tmp_path / "kc")
    assert (tmp_path / "out" / "total_dividends_b0.csv").exists()

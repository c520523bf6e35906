"""Build the CUDA sources under `csrc/` into shared libraries and load them.

Each `csrc/*.cu` compiles with `nvcc` into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded
with `ctypes`. Every source is compiled by its own `nvcc` process, all
started together. Libraries are cached by a hash of the sources, headers
and flags under `build/yuma_simulation_tpu_torch/` beside the package (or
`$YUMA_TORCH_BUILD_DIR`), so a rebuild happens only when a source changes.

Flags: `sm_90a` (Hopper), IEEE division and square root (nvcc's default),
and `--fmad=false` so that no multiply-add is contracted into an FMA: the
kernels then round every operation as the plain PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

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

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("YUMA_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "yuma_simulation_tpu_torch"


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


def _digest(source: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build_all() -> dict[str, Path]:
    """Compile every stale source, one `nvcc` per source, in parallel.
    Returns the library path of each source. The compiler's
    `-Xptxas -v` report (registers, shared memory, spills) is kept beside
    each library as `<name>.ptxas.txt`."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {
        src: out / f"{Path(src).stem}-{_digest(src)}.so" for src in SOURCES
    }
    procs = {}
    for src, lib in paths.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs[src] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    failures = []
    for src, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (out / f"{Path(src).stem}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc {src} failed (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[src])
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(source: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<source>`, building every
    source first if any is stale."""
    with _lock:
        if source not in _libs:
            for src, path in _build_all().items():
                _libs.setdefault(src, ctypes.CDLL(str(path)))
        return _libs[source]

"""The argument structs the CUDA scans take, as `csrc/scan_phases.cuh`
declares them, against the `ctypes` mirrors that `ops/cuda_epoch.py`
passes: the same fields in the same order with the same widths; and the
bisection entry's parameters against its wrapper's argtypes. A mismatch
passes every CPU test (the CPU never calls the kernels) and hands the
kernels shifted arguments on the card, so it is checked here, by parsing
the header."""

import ctypes
import re
from pathlib import Path

import pytest

from yuma_simulation_tpu_torch.ops import cuda_consensus, cuda_epoch

HEADER = Path(cuda_epoch.__file__).resolve().parent.parent / "csrc" / "scan_phases.cuh"

_SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float, "double": ctypes.c_double}
_STRUCTS = {"LiquidSpec": cuda_epoch._LiquidSpec}


def _c_fields(struct: str) -> list:
    """`[(name, ctypes type), ...]` of `struct <struct> { ... };` in the
    header: pointers as `c_void_p`, `int` / `float` / `double` scalars and arrays,
    nested structs as their mirrors."""
    text = re.sub(r"//[^\n]*", "", HEADER.read_text())
    body = re.search(r"struct\s+%s\s*\{(.*?)\};" % struct, text, re.S)
    assert body, f"struct {struct} not found in {HEADER.name}"
    fields = []
    for decl in body.group(1).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        m = re.fullmatch(r"(?:const )?(\w+)\s*(\*?)\s*(.+)", decl)
        assert m, decl
        base, ptr, names = m.groups()
        for name in names.split(","):
            name = name.strip()
            if ptr or name.startswith("*"):
                fields.append((name.lstrip("*").strip(), ctypes.c_void_p))
                continue
            arr = re.fullmatch(r"(\w+)\[(\d+)\]", name)
            ctype = _SCALARS.get(base) or _STRUCTS[base]
            if arr:
                fields.append((arr.group(1), ctype * int(arr.group(2))))
            else:
                fields.append((name, ctype))
    return fields


@pytest.mark.parametrize(
    "struct,mirror",
    [("LiquidSpec", cuda_epoch._LiquidSpec), ("ScanArgs", cuda_epoch._ScanArgs)],
    ids=["LiquidSpec", "ScanArgs"],
)
def test_ctypes_mirror_matches_header(struct, mirror):
    want = _c_fields(struct)
    got = list(mirror._fields_)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert ctypes.sizeof(g) == ctypes.sizeof(w), name
        assert ctypes.alignment(g) == ctypes.alignment(w), name
        assert getattr(g, "_type_", g) == getattr(w, "_type_", w), name
    assert ctypes.sizeof(mirror) == ctypes.sizeof(
        type("C" + struct, (ctypes.Structure,), {"_fields_": want})
    )


def test_bond_tile_matches_header():
    """The dividend-partial scratch is sized with the kernel's miner tile."""
    m = re.search(r"constexpr int kBondTM = (\d+);", HEADER.read_text())
    assert m and int(m.group(1)) == cuda_epoch.BOND_TILE


def test_dividend_group_matches_header():
    """The group sums of the dividend partials and the tickets are sized
    with the kernel's group of tiles."""
    m = re.search(r"constexpr int kDnormGroup = (\d+);", HEADER.read_text())
    assert m and int(m.group(1)) == cuda_epoch.DIVIDEND_GROUP


def test_bisect_argtypes_match_source():
    """`yuma_bisect`'s C parameters (csrc/consensus.cu) against the
    `ctypes` argtypes its wrapper sets: a float passed as an int, or a
    dropped pointer, would shift every argument after it on the card."""
    source = HEADER.with_name("consensus.cu").read_text()
    m = re.search(r'extern "C" int yuma_bisect\((.*?)\)', source, re.S)
    assert m, "yuma_bisect not found in consensus.cu"
    want = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if "*" in param:
            want.append(ctypes.c_void_p)
        else:
            want.append(_SCALARS[param.split()[-2]])
    assert cuda_consensus.BISECT_ARGTYPES == want


def test_mc_weights_argtypes_match_source():
    """`yuma_mc_weights`'s C parameters (csrc/mc_weights.cu) against the
    argtypes K7's wrapper sets (ops/cuda_random.py): the epoch as a
    32-bit unsigned int, the element count as 64 bits, the scale as a
    float."""
    from yuma_simulation_tpu_torch.ops import cuda_random

    types = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong,
             "unsigned int": ctypes.c_uint}
    source = HEADER.with_name("mc_weights.cu").read_text()
    m = re.search(r'extern "C" int yuma_mc_weights\((.*?)\)', source, re.S)
    assert m, "yuma_mc_weights not found in mc_weights.cu"
    want = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        want.append(ctypes.c_void_p if "*" in param else types[param.rsplit(" ", 1)[0]])
    assert cuda_random.MC_WEIGHTS_ARGTYPES == want


def test_new_modules_import_without_jax():
    """The Monte-Carlo slice's modules (random, K7's wrapper, the meshes and
    the sharded drivers, the synthetic perturbations) and the telemetry
    slice's (the fingerprint, the numerics sketches, spans, logging, the
    registry, metrics, SLOs, propagation, timing, profiling, the device
    sample, and the packages that re-export them) and the resilience
    slice's (the taxonomy, faults, the guard, the ladder, the watchdog, the
    supervisor, the flight recorder) and the cost and foundry slice's (the
    kernel-library cache and its AOT surface, the foundry and its drill)
    and the mesh, ops-plane and fleet slice's (the miner shards, the ops
    and incident plane, the fabric and its simulated host) and the serving
    and replay slice's (every module of `serve/` and `replay/`, and the v1
    API that promotes their names) and the multi-process tier's (the
    worker, router, autoscaler and scale-out drill, the continuous
    controller, the soak and the replay CLI) import with `jax` and the
    repo's JAX-based `tools` made unimportable and pull in nothing of the
    JAX package."""
    import subprocess
    import sys

    # The numerics module first: it imports simulation.carry, whose package
    # imports the engines, which import it back.
    mods = ["yuma_simulation_tpu_torch.telemetry.numerics",
            "yuma_simulation_tpu_torch.random", "yuma_simulation_tpu_torch.ops.cuda_random",
            "yuma_simulation_tpu_torch.parallel", "yuma_simulation_tpu_torch.parallel.mesh",
            "yuma_simulation_tpu_torch.parallel.sharded",
            "yuma_simulation_tpu_torch.scenarios.synthetic",
            "yuma_simulation_tpu_torch.ops.fingerprint",
            "yuma_simulation_tpu_torch.simulation.carry",
            "yuma_simulation_tpu_torch.telemetry",
            "yuma_simulation_tpu_torch.telemetry.runctx",
            "yuma_simulation_tpu_torch.telemetry.registry",
            "yuma_simulation_tpu_torch.telemetry.metrics",
            "yuma_simulation_tpu_torch.telemetry.slo",
            "yuma_simulation_tpu_torch.telemetry.propagation",
            "yuma_simulation_tpu_torch.telemetry.device",
            "yuma_simulation_tpu_torch.utils",
            "yuma_simulation_tpu_torch.utils.logging",
            "yuma_simulation_tpu_torch.utils.checkpoint",
            "yuma_simulation_tpu_torch.utils.timing",
            "yuma_simulation_tpu_torch.utils.profiling",
            "yuma_simulation_tpu_torch.resilience",
            "yuma_simulation_tpu_torch.resilience.errors",
            "yuma_simulation_tpu_torch.resilience.faults",
            "yuma_simulation_tpu_torch.resilience.guards",
            "yuma_simulation_tpu_torch.resilience.retry",
            "yuma_simulation_tpu_torch.resilience.supervisor",
            "yuma_simulation_tpu_torch.resilience.watchdog",
            "yuma_simulation_tpu_torch.telemetry.flight",
            "yuma_simulation_tpu_torch.ops._build",
            "yuma_simulation_tpu_torch.simulation.aot",
            "yuma_simulation_tpu_torch.foundry",
            "yuma_simulation_tpu_torch.foundry.dsl",
            "yuma_simulation_tpu_torch.foundry.metagraph",
            "yuma_simulation_tpu_torch.foundry.adversarial",
            "yuma_simulation_tpu_torch.foundry.montecarlo",
            "yuma_simulation_tpu_torch.foundry.__main__",
            "yuma_simulation_tpu_torch.models.miner_shards",
            "yuma_simulation_tpu_torch.telemetry.ops",
            "yuma_simulation_tpu_torch.telemetry.timeseries",
            "yuma_simulation_tpu_torch.telemetry.anomaly",
            "yuma_simulation_tpu_torch.telemetry.incident",
            "yuma_simulation_tpu_torch.fabric",
            "yuma_simulation_tpu_torch.fabric.simhost",
            *(f"yuma_simulation_tpu_torch.serve.{m}" for m in (
                "quotas", "coalescer", "admission", "lifecycle", "apikeys", "service",
                "server", "__main__", "worker", "router", "autoscaler", "drill")),
            "yuma_simulation_tpu_torch.serve",
            *(f"yuma_simulation_tpu_torch.replay.{m}" for m in (
                "archive", "statecache", "whatif", "sweeper", "controller", "soak",
                "__main__")),
            "yuma_simulation_tpu_torch.replay",
            "yuma_simulation_tpu_torch.v1.api"]
    code = (
        "import sys\nsys.modules['jax'] = None\nsys.modules['tools'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('yuma_simulation_tpu', 'tools')\n"
        "               and sys.modules[k] is not None for k in sys.modules)\n"
        "print('OK')\n"
    )
    repo = HEADER.parents[2]
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-3000:]

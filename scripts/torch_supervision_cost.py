#!/usr/bin/env python3
"""What supervision costs the port's entry points, on one NVIDIA GPU.

    python3 scripts/torch_supervision_cost.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout of this repository (for example the
parent commit unpacked with `git archive` into a gitignored directory, and
`.`); list them in the order to run, e.g. `parent . . parent`, so that
drift on the card cancels. Each runs in a fresh process that imports that
tree's `yuma_simulation_tpu_torch` and `chip_smoke.py` (its workload) and
builds that tree's kernels into its own `build/`. Per tree:

- `chart_suite_s`: host seconds of `v1.api._simulate_suite` over the 14
  built-in cases x the 9 versions (beta 0.5), as the chart table runs it
  (in a tree with the resilience tier every version rides the ladder), the
  median and every one of SUITE_RUNS calls after one warm-up; in such a
  tree also with `supervised=True` (the deadline watchdog on top), the two
  alternating call by call.

In a tree with the resilience tier, also, on chip_smoke.py's 256 x 4096 x
64 scenario (Yuma 1, `simulate` with default arguments):

- `simulate_s`: host seconds of SIMULATE_PAIRS pairs of one unsupervised
  call and one with `default_retry_policy()` + `default_deadline()`, the
  order within a pair alternating pair by pair;
- `host_profile`: the functions with the most cumulative host time over
  PROFILED_CALLS calls of each setting under cProfile, per call;
- `device_profile`: one call of each setting under torch.profiler: the
  device ms of the kernels and of each copy direction, the call's host ms,
  and the host operations with the most self time.

Prints one JSON line per run and writes them all to FILE (default
build/supervision_cost.json). Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import cProfile
import importlib.util
import json
import os
import subprocess
import sys
import time

#: Timed chart-suite calls a setting.
SUITE_RUNS = 9
#: Alternating unsupervised / supervised `simulate` pairs.
SIMULATE_PAIRS = 20
#: `simulate` calls of each setting under cProfile.
PROFILED_CALLS = 5


def _median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2]


def top_functions(prof, calls: int, n: int = 12) -> list:
    """The `n` functions of a cProfile run with the most cumulative time:
    `[name, calls a run, own ms a run, cumulative ms a run]`."""
    import pstats

    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: kv[1][3], reverse=True)[:n]
    return [[f"{os.path.basename(fn)}:{line}({name})", nc / calls, tt / calls * 1e3,
             ct / calls * 1e3] for (fn, line, name), (_, nc, tt, ct, _) in rows]


def device_profile(torch, fn) -> dict:
    """One call of `fn` under torch.profiler: device ms of the kernels and of
    each copy direction (sums of the device intervals), the call's host ms,
    and the 8 host operations with the most self time (ms, calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    dev = {"kernels": 0.0, "HtoD": 0.0, "DtoH": 0.0, "other_copies": 0.0}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = (evt.time_range.end - evt.time_range.start) / 1e3
        if "Memcpy" in evt.name or "Memset" in evt.name:
            key = next((k for k in ("HtoD", "DtoH") if k in evt.name), "other_copies")
        else:
            key = "kernels"
        dev[key] += ms
    host_ops = sorted(
        (e for e in prof.key_averages() if e.self_cpu_time_total > 0),
        key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return dict(host_ms=host_ms, device_ms=dev,
                host_ops=[[e.key, e.self_cpu_time_total / 1e3, e.count] for e in host_ops])


def one(root: str) -> dict:
    """The numbers of the tree at `root`, in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from yuma_simulation_tpu_torch.models.config import SimulationHyperparameters
    from yuma_simulation_tpu_torch.models.variants import canonical_versions
    from yuma_simulation_tpu_torch.ops import _build
    from yuma_simulation_tpu_torch.scenarios import get_cases
    from yuma_simulation_tpu_torch.scenarios.base import Scenario
    from yuma_simulation_tpu_torch.simulation.engine import simulate
    from yuma_simulation_tpu_torch.v1.api import _simulate_suite

    assert _build.CSRC.is_relative_to(root), (_build.CSRC, root)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    for src in _build.SOURCES:
        _build.load(src)
    resilient = importlib.util.find_spec("yuma_simulation_tpu_torch.resilience") is not None
    out: dict = dict(tree=root, card=smi, resilience_tier=resilient)

    cases, versions = get_cases(), canonical_versions()
    hp = SimulationHyperparameters(bond_penalty=0.5)
    settings = {"plain": {}}
    if resilient:
        settings["supervised"] = {"supervised": True}

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    suite = {name: [] for name in settings}
    for kw in settings.values():
        _simulate_suite(cases, versions, hp, **kw)
    for i in range(SUITE_RUNS):
        order = list(settings.items())
        for name, kw in (order if i % 2 == 0 else order[::-1]):
            suite[name].append(timed(lambda: _simulate_suite(cases, versions, hp, **kw)))
    out["chart_suite_s"] = {name: dict(median=_median(v), runs=v) for name, v in suite.items()}
    if not resilient:
        return out

    from yuma_simulation_tpu_torch.resilience import default_deadline, default_retry_policy

    W_np, S_np, quiet_miner = cs.workload(0, cs.E)
    scenario = Scenario(
        name="synthetic", validators=[f"v{i}" for i in range(cs.V)], base_validator="v0",
        weights=W_np, stakes=S_np, num_epochs=cs.E, reset_bonds_index=quiet_miner,
        reset_bonds_epoch=cs.E // 2,
    )
    version = "Yuma 1 (paper)"
    calls = {
        "unsupervised": lambda: simulate(scenario, version),
        "supervised": lambda: simulate(scenario, version, retry_policy=default_retry_policy(),
                                       deadline=default_deadline()),
    }
    for fn in calls.values():
        fn()
    seconds = {name: [] for name in calls}
    for i in range(SIMULATE_PAIRS):
        order = list(calls.items())
        for name, fn in (order if i % 2 == 0 else order[::-1]):
            seconds[name].append(timed(fn))
    out["simulate_s"] = {name: dict(median=_median(v), epochs_per_s=cs.E / _median(v), runs=v)
                         for name, v in seconds.items()}
    host = {}
    for name, fn in calls.items():
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(PROFILED_CALLS):
            fn()
        prof.disable()
        host[name] = top_functions(prof, PROFILED_CALLS)
    out["host_profile"] = host
    out["device_profile"] = {name: device_profile(torch, fn) for name, fn in calls.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join("build", "supervision_cost.json"))
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.trees[0])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_supervision_cost: CUDA is not available", file=sys.stderr)
        return 2
    results = []
    for i, tree in enumerate(args.trees):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["run"] = i + 1
        results.append(rec)
        print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

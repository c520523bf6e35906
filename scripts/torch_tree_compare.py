#!/usr/bin/env python3
"""Time the port's scans in two or more source trees, in turns, on one
NVIDIA GPU.

    python3 scripts/torch_tree_compare.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout of this repository (for example the
parent commit unpacked with `git archive` into a gitignored directory, and
`.`); list them in the order to run, e.g. `parent . . parent`, so that
drift on the card cancels. Each runs in a fresh process that imports that
tree's `yuma_simulation_tpu_torch` and `chip_smoke.py` (its workload and
timers) and builds that tree's kernels into its own `build/`. The numbers,
all at chip_smoke.py's 256 x 4096 (Yuma 1, save flags off, 64 epochs):

- `ms`: CUDA-event ms of one call of K2 (`fused_case_scan`), K3
  (`fused_varying_scan`, tile 16), K5 (`fused_ema_scan`, VPU support) and
  K6 (`fused_ema_epoch`, 20 calls back to back; `ema_epoch` with a 0-d
  `w_scale` on the card, as the fused rung passes it, `ema_epoch_float`
  with a float one);
- `host_ms`: the wrappers' host time per call of K2 and both K6 spellings
  (host clock around a call that is not synchronized, on an idle stream,
  20 calls), and of one `torch.cuda.mem_get_info` (the free-memory query
  of the tile choice);
- `fused_epochs_per_s`: `simulate_scaled(epoch_impl="fused")` over 16
  epochs (K6 once an epoch), host clock, synchronized, best of 5;
- `constant_s`: seconds of `simulate_constant` (the eager rung, no
  kernel) over 64 epochs of the first epoch's weights, in full and
  hoisted, host clock, synchronized, best of 3;
- `plain_ms`: CUDA-event ms of one call of the plain versions of K2 and
  K3 (after one warm-up call);
- `simulate_epochs_per_s`: the main path, `simulate` with default
  arguments on chip_smoke.py's 64-epoch scenario (its reset included),
  host clock around each call (the copies and the host fetch included),
  the median of SIMULATE_RUNS after one warm-up, with numerics capture as
  the tree does it by default (`"on"`) and with ``YUMA_NUMERICS=0``
  (`"off"`; a tree without the capture runs the same path twice), the two
  alternating run by run;
- `simulate_host_profile`: the 16 functions with the most cumulative host
  time over PROFILED_CALLS `simulate` calls with ``YUMA_NUMERICS=0``
  under cProfile, per call; `weights_upload_ms`: the median host ms of the
  scenario's `[64, 256, 4096]` weights copied to the card from pageable
  memory, as `simulate` copies them;
- `k2_probe`: K2 called back to back (event ms a call, each call's
  unsynchronized host ms, the allocator's device allocations and frees)
  before and after the entry points' modules are imported;
- `phases`: device ms per phase kernel (torch.profiler) over one call of
  K2, K2 with liquid alpha, K3, K5, the fused rung's 16 epochs, and
  `simulate` with default arguments (its copies included).

Prints one JSON line per run and writes them all to FILE (default
build/tree_compare.json). Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import subprocess
import sys
import time

#: Timed `simulate` calls a setting in `simulate_epochs_per_s`.
SIMULATE_RUNS = 9
#: `simulate` calls under cProfile in `simulate_host_profile`.
PROFILED_CALLS = 5


def one(root: str) -> dict:
    """The numbers of the tree at `root`, in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from yuma_simulation_tpu_torch.models.config import YumaConfig
    from yuma_simulation_tpu_torch.models.variants import variant_for_version
    from yuma_simulation_tpu_torch.ops import _build
    from yuma_simulation_tpu_torch.ops.cuda_epoch import (
        fused_case_scan,
        fused_case_scan_plain,
        fused_ema_epoch,
        fused_ema_scan,
        fused_varying_scan,
        fused_varying_scan_plain,
    )

    assert _build.CSRC.is_relative_to(root), (_build.CSRC, root)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    for src in _build.SOURCES:
        _build.load(src)
    dev = torch.device("cuda")
    W_np, S_np, quiet_miner = cs.workload(0, cs.E)
    W, S = torch.tensor(W_np, device=dev), torch.tensor(S_np, device=dev)
    quiet = dict(save_bonds=False, save_incentives=False)
    # K2 before and after the entry points' modules (and with them the
    # telemetry) are imported.
    k2_probe = {"before_entry_imports": probe_k2(torch, cs, lambda: fused_case_scan(W, S, **quiet)),
                "telemetry_imported_before": "yuma_simulation_tpu_torch.telemetry.runctx" in sys.modules}
    from yuma_simulation_tpu_torch.scenarios.base import Scenario
    from yuma_simulation_tpu_torch.simulation.engine import (
        simulate,
        simulate_constant,
        simulate_scaled,
    )

    k2_probe["after_entry_imports"] = probe_k2(torch, cs, lambda: fused_case_scan(W, S, **quiet))
    W1, S1 = W[0].contiguous(), S[0].contiguous()
    Sn1 = (S1 / S1.sum()).contiguous()
    sc = (1.0 + 1e-7 * torch.arange(cs.E, dtype=torch.float32, device=dev)).contiguous()
    B_old = torch.rand((cs.V, cs.M), device=dev, generator=torch.Generator(dev).manual_seed(5))
    B_old *= 1e-3
    config, spec = YumaConfig(), variant_for_version("Yuma 1 (paper)")
    runs = {
        "case_scan": lambda: fused_case_scan(W, S, **quiet),
        "varying_scan": lambda: fused_varying_scan(W, S, epoch_tile=16, **quiet),
        "ema_scan": lambda: fused_ema_scan(W1, Sn1, sc),
        "ema_epoch": lambda: fused_ema_epoch(W1, Sn1, B_old, w_scale=sc[1]),
        "ema_epoch_float": lambda: fused_ema_epoch(W1, Sn1, B_old, w_scale=1.0000001),
    }
    ms = {name: cs.cuda_ms(torch, fn, 20 if name.startswith("ema_epoch") else 5)
          for name, fn in runs.items()}
    host = {}
    for name in ("case_scan", "ema_epoch", "ema_epoch_float"):
        fn, total = runs[name], 0.0
        fn()
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            total += time.perf_counter() - t0
        torch.cuda.synchronize()
        host[name] = total / 20 * 1e3
    t0 = time.perf_counter()
    for _ in range(20):
        torch.cuda.mem_get_info(dev)
    host["mem_get_info"] = (time.perf_counter() - t0) / 20 * 1e3

    def best_s(fn, n):
        """Best host seconds of `n` synchronized calls, after one more."""
        fn()
        best = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    def fused():
        out = simulate_scaled(W1, S1, sc[:16], config, spec, epoch_impl="fused")
        torch.cuda.synchronize()
        return out

    best = best_s(fused, 5)
    constant_s = {
        name: best_s(lambda: simulate_constant(W1, S1, cs.E, config, spec,
                                               hoist_invariant=hoist), 3)
        for name, hoist in (("full", False), ("hoisted", True))
    }
    plain_ms = {name: cs.cuda_ms(torch, fn, 1) for name, fn in (
        ("case_scan", lambda: fused_case_scan_plain(W, S, **quiet)),
        ("varying_scan", lambda: fused_varying_scan_plain(W, S, epoch_tile=16, **quiet)),
    )}
    scenario = Scenario(
        name="synthetic", validators=[f"v{i}" for i in range(cs.V)], base_validator="v0",
        weights=W_np, stakes=S_np, num_epochs=cs.E, reset_bonds_index=quiet_miner,
        reset_bonds_epoch=cs.E // 2,
    )
    simulate(scenario, "Yuma 1 (paper)")
    rates = {"on": [], "off": []}
    for i in range(SIMULATE_RUNS):
        for flag in (("on", "off") if i % 2 == 0 else ("off", "on")):
            os.environ["YUMA_NUMERICS"] = "1" if flag == "on" else "0"
            t0 = time.perf_counter()
            simulate(scenario, "Yuma 1 (paper)")
            rates[flag].append(cs.E / (time.perf_counter() - t0))
    simulate_rate = {k: sorted(v)[len(v) // 2] for k, v in rates.items()}
    # Where a `simulate` call's host time goes, numerics off: cProfile over
    # PROFILED_CALLS calls, and the weights' upload alone.
    os.environ["YUMA_NUMERICS"] = "0"
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(PROFILED_CALLS):
        simulate(scenario, "Yuma 1 (paper)")
    prof.disable()
    os.environ.pop("YUMA_NUMERICS")
    host_profile = top_functions(prof, PROFILED_CALLS)
    upload = []
    for _ in range(SIMULATE_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.as_tensor(W_np).to(dev)
        torch.cuda.synchronize()
        upload.append((time.perf_counter() - t0) * 1e3)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    phases = cs.phase_profile(torch, smi, (
        ("case_scan", runs["case_scan"]),
        ("case_scan_liquid", lambda: fused_case_scan(W, S, liquid_alpha=True, **quiet)),
        ("varying_scan", runs["varying_scan"]),
        ("ema_scan", runs["ema_scan"]),
        ("ema_epoch_x16", fused),
        ("simulate", lambda: simulate(scenario, "Yuma 1 (paper)")),
    ))
    return dict(tree=root, card=smi, ms=ms, host_ms=host, fused_epochs_per_s=16 / best,
                constant_s=constant_s, plain_ms=plain_ms, simulate_epochs_per_s=simulate_rate,
                simulate_host_profile=host_profile,
                weights_upload_ms=sorted(upload)[len(upload) // 2], k2_probe=k2_probe,
                phases=phases)


def probe_k2(torch, cs, call) -> dict:
    """K2 called back to back: CUDA-event ms a call over 5 calls (after one
    warm-up), the host ms of each of 5 more calls that are not
    synchronized (a call that blocks on the card reads ~its device time),
    and how many of the caching allocator's device allocations, frees and
    retries those 10 calls made."""
    keys = ("num_device_alloc", "num_device_free", "num_alloc_retries", "num_sync_all_streams")
    before = torch.cuda.memory_stats()
    event_ms = cs.cuda_ms(torch, call, 5)
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        call()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()
    return dict(event_ms=event_ms, call_host_ms=host,
                allocator={k: after.get(k, 0) - before.get(k, 0) for k in keys})


def top_functions(prof, calls: int, n: int = 16) -> list:
    """The `n` functions of a cProfile run with the most cumulative time:
    `[name, calls a run, own ms a run, cumulative ms a run]`."""
    import pstats

    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: kv[1][3], reverse=True)[:n]
    return [[f"{os.path.basename(fn)}:{line}({name})", nc / calls, tt / calls * 1e3,
             ct / calls * 1e3] for (fn, line, name), (_, nc, tt, ct, _) in rows]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join("build", "tree_compare.json"))
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.trees[0])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_tree_compare: CUDA is not available", file=sys.stderr)
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

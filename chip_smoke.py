#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (yuma_simulation_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # one GPU, a few minutes

(`python3 chip_smoke.py --cache-child MODE` is one process of the cache
phase below, started by the script itself.)

Builds the CUDA kernels from `yuma_simulation_tpu_torch/csrc` (nvcc, one
process per source, on first use), then:

1. prints the card's name and power limit (nvidia-smi), and holds the
   plain versions' exact multiply-add (ops/fma.py) bitwise against the
   card's `__fmaf_rn` on 2^21 float32 triples, half of them next to
   float32 halfway points;
2. holds K1 (consensus bisection) against its plain PyTorch version at
   256 validators x 4096 miners, one slab and a batch of 16: `c_high`
   bitwise equal; times a wrapper call (CUDA events) and the kernel alone
   (torch.profiler) at both;
3. holds K2 (case scan) and K3 (varying scan) against their plain versions
   at 256 x 4096 x 32 epochs of per-epoch weights (two tiles of 16; the
   plain versions' exact FMA chains make 64 slow), one run per bond model:
   quantized consensus bitwise, dividends and bonds within atol 2e-6 /
   rtol 1e-5; K3 against K2: consensus and incentives bitwise, dividends
   and bonds within 1e-6;
4. drives the main path through the entry points a user calls, with the
   launch counts zeroed before and read after each: `simulate` with default
   arguments (auto -> K3), `simulate(epoch_impl="fused_scan")` (K2), and
   `simulate(epoch_impl="eager", consensus_impl="kernel")` (K1); then the
   telemetry core on the same workload (telemetry_phase): every run's
   numerics sketches (K3 with and without the consensus saved, K2, the
   eager rung with K1) bitwise the CPU sketches of its outputs, a one-ulp
   flip moving one epoch's fingerprint by exactly 1, a streamed run's
   numerics bitwise the monolithic run's, the runs' span tree, the
   `simulate:fused_varying` profiler range holding K3's phase kernels, the
   metrics, the dispatch table and the device sample, and `simulate`'s
   epochs/s with numerics capture off and on in alternating pairs;
5. runs the reference surface: `simulate_batch` over the 14 built-in cases
   x 9 versions at beta=1.0 through `auto`, held to the golden CSV within
   1.5e-6;
   Then runs the artifact CLI as a user does (`total_dividends_sheet_generator
   main(["--out-dir", ...])`, auto -> K3, all four bond_penalty sheets),
   gated on the golden CSVs' header and quoting, on every differing
   rendered cell being pinned in tests/golden/csv_diff_cells.json, and on
   the totals within 1.5e-6 of the `*_full.csv` goldens; then the chart
   table's suite as `v1.api.generate_chart_table` runs it
   (`_simulate_suite`, 14 cases x 9 versions at the four bond_penalty
   values, 9 K3 launches each, every per-epoch array held to the same
   suite on the CPU and the totals to the goldens, every chart's numbers
   computed by the charts module's numpy helpers, nothing rendered) and a
   padded suite of mixed shapes at real width ([2, 64, 256, 4096] with
   miner masks, on the eager rung: no launch, the unpadded lane bitwise
   its solo run, the padded lane and a 16-epoch CPU run within
   PAD_RTOL / PAD_ATOL); and the grid sweeps at full width: an 8-point `config_grid` (bond_alpha x kappa)
   through `sweep_hyperparams` (K3; Yuma 1, and Yuma 3.1 with its reset)
   over the 256 x 4096 x 64 workload and `sweep_scaled_fused` (K5) over its
   first epoch x 64 scales, each lane bitwise its solo scalar run, with
   wall seconds per sheet and scenario-epochs/s printed; then the long
   runs (streams_phase): `simulate_streamed` and `simulate(max_resident_
   epochs=16)` bitwise the monolithic run at 256 x 4096 x 64 (slabs
   [16]*4 and [23, 23, 18], K3 and K2, Yuma 1 / 2 / 3.1, one launch a
   slab), a 2048-epoch stream of 256-epoch slabs bitwise the monolithic
   8.6 GB run with its peak allocation within the plan's two-slab
   estimate, the HBM preflight refusing a (20000, 256, 4096) stack with
   nothing allocated, `simulate_generated` over chunks drawn on the card,
   and a donor-packed mixed suite through `total_dividends_batch`; then the
   Monte-Carlo (mc_phase): K7, the weight slab, bitwise its plain version
   on PRNGKey(5)'s [8, 16, 256, 4096] slabs from epochs 0 and 70000 and
   held to values JAX made, `montecarlo_per_epoch_batched` over 8 x 64
   epochs at 256 x 4096 in K7 slabs of 16 (4 K7 and 4 K3 launches) within
   ATOL / RTOL of the same run on the plain versions and of chunks of 32,
   `montecarlo_total_dividends` over the one-device mesh bitwise that run,
   the constant-weights Monte-Carlo (64 x 500 epochs of 16 x 256) against
   the same on the CPU (within 500 float32 roundings of the totals), and `simulate_batch_sharded` over the one-device
   mesh bitwise `simulate_batch`; and, last of all (after step 8), the
   resilience tier (resilience_phase): `simulate` with the default ladder
   and deadline bitwise the unsupervised main run (one K3 launch), one
   injected fused fault retried and two demoting once to fused_scan_mxu
   (K2, K4 once a tile, bitwise a direct call), a `StallFault` past a
   0.5 s deadline killed and retried, a real `torch.cuda.OutOfMemoryError`
   classified, a 4-lane quarantined batch with a NaN lane on the eager
   rung (healthy lanes bitwise their solo runs, the report the CPU's), the
   chart suite with `supervised=True` bitwise the unsupervised one, K3
   against K2 + K4 (the canary pair) on the built-in suite and at
   256 x 4096, a checkpointed `SweepSupervisor` over 16 scenarios with one
   fault (its bundle checked, a resumed run launching nothing), and
   `simulate` epochs/s supervised against unsupervised in alternating
   pairs; no demotion but the injected ones; then the kernel-library
   cache (cache_phase) in four processes on a fresh build directory under
   build/chip_smoke/cache: a cold one building all four libraries (four
   misses "absent"), a warm one loading them under a
   `RecompilationSentinel(budget=0)` with no compile started, one after a
   library was truncated (a miss "corrupt", that library rebuilt, K3's
   output bitwise the warm process's), and one after a library's metadata
   was moved under another toolkit's key (a "stale" entry, rebuilt); the
   cost records (cost_phase) of every rung at 256 x 4096 x 64, the same
   work for each, K3's roofline equal to its bound in the kernel line and
   its attained fraction from K3's event time and from `simulate`'s
   epochs/s; and the foundry (foundry_phase): `synthetic_snapshot(0)` over
   40 epochs through `simulate` (one K3 launch, within ATOL / RTOL of K3's
   plain version), the snapshots of seeds 0-7 through
   `run_montecarlo(route="batch")` (one K3 launch over [8, 40, 256, 4096],
   each lane bitwise its solo `simulate`; two of them through the
   supervised route, on the eager rung, within ATOL / RTOL), the drill
   population through
   the batch and supervised routes (each route's rung and launches
   asserted, each lane bitwise its solo run on that rung, the rungs within
   ATOL), and `python -m yuma_simulation_tpu_torch.foundry --drill` on the
   card;
6. holds K4 (the bisection's support on the tensor cores) against its
   plain version at 256 x 4096 bitwise, timed as K1 at one slab and 16,
   and K2, K3 and K5 with `mxu=True`
   against `mxu=False` at 256 x 4096 x 16 epochs for the five bond models,
   bitwise on every output;
7. holds K5 (the scaled scan) against its plain version at 256 x 4096,
   16 epochs of `W * scales[e]`, for the five bond models and batched
   (Bb=4), and K6 (one fused epoch) against its plain version for EMA,
   EMA_RUST and EMA_PREV with a clip base, first epoch and later, and with
   `m_real < M`: within atol 2e-6 / rtol 1e-5;
8. drives the second main path, the scaled throughput path, through the
   entry points with the launch counts zeroed before and read after each:
   `simulate_scaled` with default arguments (auto) over 512 epochs at
   256 x 4096, `simulate_scaled_batch` (B=4), `simulate_scaled(epoch_impl=
   "fused_scan_mxu")`, `simulate_scaled(epoch_impl="fused")` over 16 epochs
   (K6 16 times) and `simulate_constant` both ways over 64 epochs; and
   times K5's two spellings over 64 epochs in 16 pairs of alternating order;
9. prints one `{"phases": {...}}` line, the device ms of each phase
   kernel over one call of K2 (Yuma 1, and Yuma 1 with liquid alpha), K3
   and K5 (both spellings) at 256 x 4096 x 64 epochs and over
   `simulate_scaled(epoch_impl="fused")`'s 16 epochs (K6 16 times; all by
   torch.profiler), one `{"host_ms": {...}}` line (the wrappers' host time
   per call of K2 and K6, K6 with a tensor w_scale on the card as the
   fused rung passes it and with a float: host clock around a call that
   is not synchronized, on an idle stream, averaged over 20 calls), one
   `{"bisect": {...}}` line (K1's and K4's event and device ms at 1 and 16
   slabs), one `{"charts": {...}}` line (the chart suite's seconds per
   beta, the padded suite's seconds and errors), one `{"cli": ...,
   "sweeps": ..., "fma_helper": ...}` line, one `{"streams": {...}}` line
   (the long stream's epochs/s, peak bytes and its parts timed alone; the
   preflight's message; the sync-debug warnings), one `{"mc": {...}}` line
   (the Monte-Carlo's scenario-epochs/s, K7's ms per slab and its bound,
   the constant run's seconds and errors), one `{"telemetry": {...}}` line
   (the stream sets, the capture's ms, the profile windows, the metrics,
   the numerics on / off epochs/s), one `{"resilience": {...}}` line (the
   quarantine's and the supervised sweep's seconds, the canary pair's
   first divergences, the supervised / unsupervised epochs/s), one
   `{"cache": ...}` line (each process's hits, misses by reason, stale
   entries, builds, load and process seconds), one `{"cost": ...}` line
   (the records, the card's spec, K3's and `simulate`'s rooflines), one
   `{"foundry": ...}` line (each route's rung, the largest K3 / plain and
   K3 / eager gaps, the seconds of each step, the drill's summary), and one
   `{"kernels": [...]}`
   line for K1-K7 (launches on the
   main paths, max |kernel - plain|, kernel and plain times from CUDA
   events, the roofline bound, and a library call's time where one
   exists), the card line, and last `{"ok": true, "device": {...}}`;
10. after the mesh and fleet phases, the serving tier (serve_phase: four
   tenants coalesced into one K3 launch, each lane bitwise its solo run,
   the eager and `fused_scan_mxu` requests, the smoke contract over HTTP
   with a table and a canary tick, every launch on the service's
   dispatcher side) and what-if replay (replay_phase: a served miss
   building its baseline on K2, a hit re-simulating only the suffix with
   no library built, bitwise the miss and the uncached K2 run, then the
   trailing-window sweep of two versions); each prints its line, `{"serve":
   ...}` and `{"replay": ...}`, with the card's name and power limit, and
   leaves its flight bundles under build/chip_smoke/{serve,replay}.
11. then the multi-process tier, every child process exec'd with `--device
   cuda` (scaleout_phase: the scale-out drill at 256 x 4096, a router
   here and three workers on one empty shared kernel-library cache, the
   affinity and control arms' what-ifs on K2 and the kill drill's
   [16, 64, 256] simulates on K3 bitwise this process's answers, an
   autoscaled worker with no library built, each worker's context in
   `nvidia-smi --query-compute-apps`; controller_phase: `python -m
   yuma_simulation_tpu_torch.replay --soak --device cuda` at 256 x 4096
   with 3 subnets, its writer, controller and host as processes with
   their SIGKILLs, every window published once and the incremental
   baselines bitwise their from-genesis builds); each prints its line,
   `{"scaleout": ...}` and `{"controller": ...}`, with the card's name and
   power limit. The children's K2 / K3 launches are read from their flight
   bundles and added to the kernel table's counts.

Any failure raises and exits non-zero. Without CUDA it exits 2 and prints
no result. The numbers and a per-kernel profile table are also written
under build/chip_smoke/ (gitignored).
"""

from __future__ import annotations

import collections
import csv
import json
import os
import subprocess
import sys
import time

import numpy as np

# The H100's peaks and the bound model (bytes over HBM's rate against
# operations over their peak) live with the cost records they also price.
from yuma_simulation_tpu_torch.telemetry.cost import BISECT_OPS, ELEMENTWISE_OPS, bound_ms

V, M, E = 256, 4096, 64
VERSIONS = [
    ("Yuma 0 (subtensor)", {}),
    ("Yuma 1 (paper) - liquid alpha on", dict(liquid_alpha=True)),
    ("Yuma 2 (Adrian-Fish)", {}),
    ("Yuma 3.2 (Rhef+conditional)", {}),
    (
        "Yuma 4 (Rhef+relative bonds) - liquid alpha on",
        dict(liquid_alpha=True, bond_alpha=0.025, alpha_high=0.99, alpha_low=0.9),
    ),
]
ATOL, RTOL = 2e-6, 1e-5
#: A padded lane against its run unpadded, both on the eager rung: the JAX
#: package's own tolerance for a padded suite against per-case runs
#: (tests/unit/test_api_v1.py). The padding moves the miner sum's blocks,
#: so a row sum, and through it a normalized weight, may move by an ulp.
PAD_RTOL, PAD_ATOL = 2e-5, 2e-6
OUT_DIR = os.path.join("build", "chip_smoke")
#: Calls that open a profiled window and are not counted (kernel_device_ms):
#: late in the script the profiler dropped up to 8 of a window's first
#: k_bisect_mma launches (PERF.md §6).
WINDOW_WARMUP = 15
#: What each profiled window of kernel_device_ms kept, and where its first
#: kept launch fell (printed as `{"profiler_windows": [...]}`).
PROFILER_WINDOWS: list = []


def workload(seed: int, E: int, nnz: int = 48, strong: int = 64, shape=None):
    """Per-epoch weights and stakes shaped like a real subnet (`shape` =
    `(V, M)`, by default the module's 256 x 4096), as the JAX
    package's foundry/metagraph.py::synthetic_snapshot draws one epoch:
    heavy-tailed lognormal stakes (sigma 1.2) drifting every epoch; a
    shared miner-quality vector (Gamma draws: `strong` miners, and a tail
    10^4 times lighter); each validator row touches `nnz` miners sampled by
    quality without replacement (Gumbel top-k) and re-noised every epoch.
    The strong set keeps ~50 miners in consensus, so the liquid-alpha
    0.99-quantile fallback has a spread (with a single Gamma(1/8) vector
    almost every miner's consensus is 0, every quantile coincides, and the
    reference's logistic fit divides by zero)."""
    V, M = shape or (globals()["V"], globals()["M"])
    rng = np.random.default_rng(seed)
    stakes0 = rng.lognormal(0.0, 1.2, V)
    drift = np.exp(np.cumsum(rng.normal(0.0, 0.05, (E, V)), axis=0))
    S = (stakes0 * drift).astype(np.float32)
    quality = rng.gamma(2.0, size=M)
    quality[rng.permutation(M)[strong:]] *= 1e-4
    quality /= quality.sum()
    logq = np.log(quality)
    W = np.zeros((E, V, M), np.float32)
    rows = np.arange(V)[:, None]
    for e in range(E):
        keys = logq + rng.gumbel(size=(V, M))
        chosen = np.argpartition(-keys, nnz, axis=1)[:, :nnz]
        row = quality[chosen] * rng.lognormal(0.0, 0.35, (V, nnz))
        W[e, rows, chosen] = (row / row.sum(axis=1, keepdims=True)).astype(np.float32)
    return W, S, int(np.argmin(quality))


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of `fn()` over `reps` runs, from CUDA events,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed_once(torch, fn):
    """`(fn(), milliseconds)` of one call, from CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def host_ms(torch, fn, calls: int = 20) -> float:
    """Mean host milliseconds of one call of `fn` that is not
    synchronized, each started on an idle stream (so a full launch queue
    never blocks it): the wrapper's own time, the card's excluded."""
    fn()
    total = 0.0
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / calls * 1e3


def held_profiler():
    """The process's profiler latch for one of the script's own
    torch.profiler windows: an ops-plane ProfileSession cannot open while
    it is held (telemetry/ops.py), and it cannot be taken while one is."""
    from yuma_simulation_tpu_torch.telemetry.ops import hold_profiler

    return hold_profiler({"mode": "chip_smoke"})


def kernel_device_ms(torch, fn, kernel: str, reps: int) -> float:
    """Mean device milliseconds of one launch of kernel `kernel` (its
    `k_*` name), from torch.profiler (CUPTI): the last `reps` of its
    launches in a window of WINDOW_WARMUP + `reps` calls of `fn` (each
    launching it once), after one call outside the window. The profiler
    may drop the first launches of a window (PERF.md §6), so the window's
    first WINDOW_WARMUP calls are not counted; every call launches the
    same kernel on the same inputs.
    A window that sees fewer than `reps` launches is taken again, twice at
    most, and then the script fails."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    calls = WINDOW_WARMUP + reps
    seen = []
    for _ in range(3):
        with held_profiler(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                with record_function("window_call"):
                    fn()
            torch.cuda.synchronize()
        spans, marks, others = [], [], collections.Counter()
        for evt in prof.events():
            if evt.device_type == DeviceType.CPU and evt.name == "window_call":
                marks.append(evt.time_range.start)
                continue
            if evt.device_type != DeviceType.CUDA:
                continue
            found = re.search(r"\bk_[a-z_]+", evt.name)
            if found and found.group(0) == kernel:
                spans.append((evt.time_range.start, evt.time_range.end))
            else:
                others[evt.name[:80]] += 1
        stats = window_stats(kernel, sorted(marks), sorted(spans))
        stats["other_device_events"] = dict(others.most_common(6))
        PROFILER_WINDOWS.append(stats)
        if len(spans) < calls:
            print(f"{kernel}: the profiler kept {len(spans)} of {calls} launches: {stats}",
                  flush=True)
        if len(spans) >= reps:
            return sum(end - start for start, end in sorted(spans)[-reps:]) / 1e3 / reps
        seen.append(len(spans))
    raise AssertionError(f"{kernel}: the profiler kept {seen} of {calls} launches")


def window_stats(kernel: str, marks: list, spans: list) -> dict:
    """Where a profiled window's kernels fell against its calls (`marks`: the
    host start of each call, `spans`: the device interval of each kernel
    kept, both in us on the trace's clock). Kernels are paired with calls
    from the end, so a window that lost launches loses its first ones:
    `lost_us` is the host time from the first call to the first call whose
    kernel was kept, `lead_us` the least time from a call's start to its
    kernel's (below 0: the device's clock reads behind the host's)."""
    kept, calls = len(spans), len(marks)
    leads = [s - m for (s, _), m in zip(reversed(spans), reversed(marks))]
    return dict(
        kernel=kernel, calls=calls, kept=kept,
        first_call_us=round(marks[0], 1) if marks else None,
        lost_us=round(marks[calls - kept] - marks[0], 1) if 0 < kept <= calls else None,
        lead_us=round(min(leads), 1) if leads else None,
    )


def bisect_phase(torch, W, S, mma: bool) -> dict:
    """K1 (or K4 with `mma`) against its plain version at one slab
    [V, M] (the first epoch of the workload) and at 16 slabs [16, V, M]
    (its first 16 epochs), bitwise; at each, the event ms of one wrapper
    call and the kernel's device ms (torch.profiler). K4 is also held to
    the masked integer sum (the plain version without mxu). Returns the
    one-slab record of the kernel line, with the 16-slab one under
    "slabs16"."""
    from yuma_simulation_tpu_torch.ops.consensus import stake_weighted_median
    from yuma_simulation_tpu_torch.ops.cuda_consensus import stake_weighted_median_cuda

    label, kernel = ("K4", "k_bisect_mma") if mma else ("K1", "k_bisect")
    recs = {}
    for n in (1, 16):
        Wn = (W[:n] / (W[:n].sum(-1, keepdim=True) + 1e-6)).contiguous()
        Sn = (S[:n] / S[:n].sum(-1, keepdim=True)).contiguous()
        if n == 1:
            Wn, Sn = Wn[0], Sn[0]
        got = stake_weighted_median_cuda(Wn, Sn, 0.5, mma=mma)
        plain = stake_weighted_median(Wn, Sn, 0.5, mxu=mma)
        torch.cuda.synchronize()
        check_equal(f"{label} c_high vs its plain version, {n} slab(s)", got, plain)
        if mma:
            vpu = stake_weighted_median(Wn, Sn, 0.5)
            check_equal(f"{label} c_high vs the masked integer sum, {n} slab(s)", got, vpu)
        rec = dict(
            max_abs_err=max_err(got, plain),
            ms=cuda_ms(torch, lambda: stake_weighted_median_cuda(Wn, Sn, 0.5, mma=mma), 50),
            device_ms=kernel_device_ms(
                torch, lambda: stake_weighted_median_cuda(Wn, Sn, 0.5, mma=mma), kernel, 20),
            plain_ms=cuda_ms(torch, lambda: stake_weighted_median(Wn, Sn, 0.5, mxu=mma), 5),
        )
        # K4 compares on the vector units and adds on the tensor cores.
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            4 * n * (V * M + V + M), n * (17 if mma else BISECT_OPS) * V * M,
            int8_ops=n * 17 * 2 * 4 * V * M if mma else 0.0,
        )
        recs[n] = rec
        print(f"{label} ok at {n} slab(s) of [{V}, {M}]: bitwise; {rec}", flush=True)
    return dict(recs[1], slabs16=recs[16])


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check_close(label, got, ref, atol=ATOL, rtol=RTOL):
    import torch

    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol, msg=lambda m: f"{label}: {m}")


def check_equal(label, got, ref):
    import torch

    if not torch.equal(got, ref):
        bad = int((got != ref).sum())
        raise AssertionError(f"{label}: {bad} of {got.numel()} values differ")


def phase_profile(torch, smi, runs, mode: str = "w") -> dict:
    """Device ms of each phase kernel over one call of each `(name, fn)`
    of `runs`, from torch.profiler (CUPTI): kernels by their `k_*` name,
    device-to-device copies and memsets as `copies`, and `total`. The
    profiler's own table goes to build/chip_smoke/chip_smoke_profile.txt
    (`mode` "a" appends to it)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    phases = {}
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), mode) as f:
        for name, fn in runs:
            with held_profiler(), profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            f.write(f"== {name} [{V}, {M}], one call, {smi}\n")
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))
            f.write("\n")
            ms: dict = {}
            for evt in prof.key_averages():
                kernel = re.search(r"\bk_[a-z_]+", evt.key)
                if kernel:
                    key = kernel.group(0)
                elif evt.key.startswith("Memcpy") or evt.key.startswith("Memset"):
                    key = "copies"
                else:
                    continue
                ms[key] = ms.get(key, 0.0) + evt.self_device_time_total / 1e3
            assert ms.get("k_bond", 0.0) > 0.0, (name, ms)  # the profiler saw the card
            ms["total"] = sum(ms.values())
            phases[name] = ms
    return phases


def k4_phase(torch, dev, W, S, measured, errs):
    """K4 against its plain version at one slab and at 16 slabs of 256 x
    4096, bitwise (bisect_phase); K2, K3 and K5 with mxu against their VPU
    spellings at 256 x 4096 x 16, bitwise; the time of torch._int_mm on
    one halving's contraction as the library yardstick."""
    from yuma_simulation_tpu_torch.models.config import YumaConfig, YumaParams
    from yuma_simulation_tpu_torch.models.variants import variant_for_version
    from yuma_simulation_tpu_torch.ops.consensus import support_fixed_stakes
    from yuma_simulation_tpu_torch.ops.cuda_consensus import stake_weighted_median_cuda
    from yuma_simulation_tpu_torch.ops.cuda_epoch import (
        fused_case_scan,
        fused_ema_scan,
        fused_varying_scan,
    )
    from yuma_simulation_tpu_torch.simulation.engine import fused_hparams

    rec = bisect_phase(torch, W, S, mma=True)
    rec["library_ms"] = None
    Wn = (W[0] / (W[0].sum(-1, keepdim=True) + 1e-6)).contiguous()
    Sn = (S[0] / S[0].sum()).contiguous()
    got = stake_weighted_median_cuda(Wn, Sn, 0.5, mma=True)
    # One halving's contraction as one library call: int8 limbs must stay
    # below 128, so S_int < 2^31 takes five 7-bit limbs, padded to the 32
    # rows torch._int_mm asks for.
    s_int = support_fixed_stakes(Sn)
    limbs = torch.zeros((32, V), dtype=torch.int8, device=dev)
    for j in range(5):
        limbs[j] = ((s_int >> (7 * j)) & 127).to(torch.int8)
    mask = (Wn > 0.5 * got.unsqueeze(0)).to(torch.int8).contiguous()
    try:
        torch._int_mm(limbs, mask)
        rec["library_ms"] = cuda_ms(torch, lambda: torch._int_mm(limbs, mask), 50)
    except RuntimeError as exc:  # the library call refuses these shapes
        rec["library_none_reason"] = f"torch._int_mm([32, {V}] x [{V}, {M}]): {exc}"[:300]
    measured["support_mma"] = rec
    print(f"K4 ok: bitwise; {rec}", flush=True)

    Wc, Sc = W[:16].contiguous(), S[:16].contiguous()
    scales = 1.0 + 1e-7 * torch.arange(16, dtype=torch.float32, device=dev)
    for version, params in VERSIONS:
        spec = variant_for_version(version)
        hp = fused_hparams(YumaConfig(yuma_params=YumaParams(**params)))
        x64 = spec.bonds_mode.value == "ema_rust"
        kw = dict(mode=spec.bonds_mode, x64=x64, **hp)
        scan_kw = dict(kw, save_bonds=True, save_incentives=True, save_consensus=True,
                       reset_mode=spec.reset_mode, reset_index=0, reset_epoch=8)
        pairs = [
            ("case_scan", lambda mxu: fused_case_scan(Wc, Sc, mxu=mxu, **scan_kw)),
            ("varying_scan",
             lambda mxu: fused_varying_scan(Wc, Sc, epoch_tile=16, mxu=mxu, **scan_kw)),
            ("ema_scan", lambda mxu: dict(zip(
                ("final_bonds", "dividends_total"),
                fused_ema_scan(Wc[0], Sn, scales, mxu=mxu, **kw)))),
        ]
        for name, run in pairs:
            a, b = run(False), run(True)
            torch.cuda.synchronize()
            assert set(a) == set(b), name
            for key in a:
                check_equal(f"{name} mxu {version} {key}", b[key], a[key])
        print(f"K2/K3/K5 mxu ok: {version}, bitwise on every output", flush=True)
    errs["support_mma"] = rec["max_abs_err"]


def fma_phase(torch, dev, report):
    """The exact multiply-add of the plain versions (ops/fma.py::fma) on
    the card against `__fmaf_rn` (csrc/consensus.cu, k_fmaf), bitwise, and
    its CPU result against the card's: 2^20 random float32 triples over
    wide exponents, and 2^20 built so that a*b + c lies next to a float32
    halfway point, where a float64 sum rounded again to float32 goes wrong
    (the count of such cases is printed)."""
    from yuma_simulation_tpu_torch.ops.fma import fma, fmaf_cuda

    rng = np.random.default_rng(11)
    n = 1 << 20
    sign = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    i = rng.integers(1, 1 << 12, n)
    sets = {
        "random": (
            rng.standard_normal(n) * 2.0 ** rng.integers(-40, 40, n),
            rng.standard_normal(n) * 2.0 ** rng.integers(-40, 40, n),
            rng.standard_normal(n) * 2.0 ** rng.integers(-60, 60, n),
        ),
        "halfway": (
            sign * (1.0 + i * 2.0**-23),
            2.0**-24 * (1.0 - i * 2.0**-23),
            sign * (1.0 + rng.integers(0, 1 << 23, n) * 2.0**-23),
        ),
    }
    rec = {}
    for name, arrays in sets.items():
        a, b, c = (torch.tensor(x.astype(np.float32), device=dev) for x in arrays)
        ref = fmaf_cuda(a, b, c)
        got = fma(a, b, c)
        cpu = fma(a.cpu(), b.cpu(), c.cpu())
        torch.cuda.synchronize()
        check_equal(f"fma helper vs __fmaf_rn, {name}", got, ref)
        check_equal(f"fma helper on the CPU vs __fmaf_rn, {name}", cpu, ref.cpu())
        twice = int(((a.double() * b.double() + c.double()).float() != ref).sum())
        rec[name] = dict(n=n, two_roundings_differ=twice)
    report["fma_helper"] = rec
    print(f"fma helper ok: bitwise __fmaf_rn on the card and the CPU; {rec}", flush=True)


def cli_phase(torch, launches, report):
    """The total-dividends CLI on the card, as a user runs it: all four
    bond_penalty sheets into build/chip_smoke/sheets. Gates: the header
    and quoting bytes and the case names are the goldens'; a rendered cell
    differs from tests/golden/total_dividends_b{beta}.csv only where
    tests/golden/csv_diff_cells.json pins it (the pin_key of
    tools/csv_byte_parity.py); the same table at full precision is within
    1.5e-6 of the `*_full.csv` goldens and renders to the sheet's bytes."""
    from yuma_simulation_tpu_torch.cli.total_dividends_sheet_generator import main as cli_main
    from yuma_simulation_tpu_torch.models.config import SimulationHyperparameters
    from yuma_simulation_tpu_torch.models.variants import canonical_versions
    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from yuma_simulation_tpu_torch.reporting.tables import generate_total_dividends_table
    from yuma_simulation_tpu_torch.scenarios import get_cases

    golden_dir = os.path.join("tests", "golden")
    with open(os.path.join(golden_dir, "csv_diff_cells.json")) as f:
        pins = json.load(f)
    out = os.path.join(OUT_DIR, "sheets")
    reset_launch_counts()
    seconds = cli_main(["--out-dir", out])
    counts = launch_counts()
    assert counts["varying_scan"] == 9 * len(seconds), counts
    launches["varying_scan"] += counts["varying_scan"]
    rec = {}
    for beta, sec in seconds.items():
        with open(os.path.join(out, f"total_dividends_b{beta}.csv"), newline="") as f:
            text = f.read()
        with open(os.path.join(golden_dir, f"total_dividends_b{beta}.csv"), newline="") as f:
            golden_text = f.read()
        with open(os.path.join(golden_dir, f"total_dividends_b{beta}_full.csv")) as f:
            full = list(csv.reader(f))
        assert "\r" not in text and text.endswith("\n"), beta
        mine, golden = list(csv.reader(text.splitlines())), list(csv.reader(golden_text.splitlines()))
        assert text.splitlines()[0] == golden_text.splitlines()[0], beta
        assert [r[0] for r in mine] == [r[0] for r in golden] == [r[0] for r in full], beta
        header = mine[0]
        differ, outside = 0, []
        for r in range(1, len(mine)):
            for c in range(1, len(header)):
                if mine[r][c] != golden[r][c]:
                    differ += 1
                    key = f"{mine[r][0]}|{header[c]}|{mine[r][c]}|{golden[r][c]}"
                    if key not in pins[beta]:
                        outside.append(key)
        assert not outside, f"beta={beta}: cells outside the pin: {outside}"
        table = generate_total_dividends_table(
            get_cases(), canonical_versions(),
            SimulationHyperparameters(bond_penalty=float(beta)),
        )
        assert table.to_csv() == text, beta
        worst = max(
            abs(table.rows[r - 1][c] - float(full[r][c]))
            for r in range(1, len(full)) for c in range(1, len(header))
        )
        assert worst < 1.5e-6, f"beta={beta}: |total - golden| {worst}"
        rec[beta] = dict(seconds=sec, cells_differing=differ, pinned=len(pins[beta]),
                         worst_abs=worst)
    report["cli"] = rec
    print(f"CLI ok: four sheets on the card, every differing cell pinned, full precision "
          f"within 1.5e-6; per sheet {rec}; launches {counts}", flush=True)


def charts_phase(torch, dev, W_np, S_np, launches, report):
    """The chart-table path on the card, as `generate_chart_table` runs it
    (v1/api.py::_simulate_suite), and a padded suite of mixed shapes at
    real width through `simulate_batch(miner_mask=)`.

    The suite: the 14 built-in cases x 9 versions at each of the CLI's four
    bond_penalty values, exactly 9 K3 launches a beta (auto); every
    per-epoch dividend, bond and incentive array within ATOL / RTOL of the
    same suite on the CPU (the eager rung, bitwise the JAX package's XLA
    rung); each case's summed dividends within 1.5e-6 of the `*_full.csv`
    goldens; every chart's numbers from the charts module's numpy helpers,
    not rendered (chip_smoke imports no matplotlib).

    The padded suite: the 256 x 4096 x 64 workload beside a 128 x 2048 x 48
    draw (seed 1), padded to [2, 64, 256, 4096] with a per-scenario miner
    mask (Yuma 1): no kernel launched (the eager rung); the unpadded lane
    bitwise its solo eager run; the padded lane within PAD_RTOL / PAD_ATOL
    of its solo unpadded eager run; both lanes within the same of the CPU
    eager run of the padded suite's first 16 epochs."""
    from yuma_simulation_tpu_torch.models.config import SimulationHyperparameters, YumaConfig
    from yuma_simulation_tpu_torch.models.variants import (
        canonical_versions,
        variant_for_version,
    )
    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from yuma_simulation_tpu_torch.reporting import charts
    from yuma_simulation_tpu_torch.scenarios import get_cases
    from yuma_simulation_tpu_torch.scenarios.base import Scenario
    from yuma_simulation_tpu_torch.simulation.sweep import (
        pad_scenarios,
        simulate_batch,
        stack_scenarios,
    )
    from yuma_simulation_tpu_torch.v1.api import _simulate_suite

    cases, versions = get_cases(), canonical_versions()
    golden_dir = os.path.join("tests", "golden")
    rec = {"suite_seconds": {}, "suite_worst_vs_cpu": {}, "golden_worst_abs": {}}
    for beta in ("0", "0.5", "0.99", "1.0"):
        hp = SimulationHyperparameters(bond_penalty=float(beta))
        reset_launch_counts()
        t0 = time.perf_counter()
        card = _simulate_suite(cases, versions, hp)
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        assert counts["varying_scan"] == len(versions) and sum(counts.values()) == len(versions), (
            beta, counts)
        launches["varying_scan"] += counts["varying_scan"]
        cpu = _simulate_suite(cases, versions, hp, device="cpu")
        with open(os.path.join(golden_dir, f"total_dividends_b{beta}_full.csv")) as f:
            golden = list(csv.DictReader(f))
        worst_cpu = worst_golden = 0.0
        for (i, version), (_, (div, bonds, inc)) in card.items():
            case = cases[i]
            _, (c_div, c_bonds, c_inc) = cpu[(i, version)]
            label = f"charts beta={beta} {case.name} {version}"
            pairs = [(np.asarray([div[v] for v in case.validators]),
                      np.asarray([c_div[v] for v in case.validators]), "dividends"),
                     (np.asarray(bonds), np.asarray(c_bonds), "bonds"),
                     (np.asarray(inc), np.asarray(c_inc), "incentives")]
            for got, ref, key in pairs:
                np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, err_msg=f"{label} {key}")
                worst_cpu = max(worst_cpu, float(np.abs(got - ref).max()))
            for j, std in enumerate(["Validator A", "Validator B", "Validator C"]):
                gap = abs(sum(div[case.validators[j]]) - float(golden[i][f"{std} - {version}"]))
                assert gap < 1.5e-6, f"{label} {std}: |total - golden| {gap}"
                worst_golden = max(worst_golden, gap)
            # Every chart's numbers, as the plotters compute them.
            lines = charts._dividend_series(case.validators, div, case.base_validator,
                                            case.num_epochs)
            assert [name for name, _, _ in lines] == case.validators, label
            assert all(np.isfinite(series).all() for _, series, _ in lines), label
            for normalize in (False, True):
                series = charts._bond_series(bonds, len(case.validators), len(case.servers),
                                             normalize)
                assert series.shape == (len(case.servers), len(case.validators),
                                        case.num_epochs) and np.isfinite(series).all(), label
            weights = charts._server2_weights(case.weights_epochs, len(case.validators),
                                              case.num_epochs)
            assert weights.shape == (case.num_epochs, len(case.validators)), label
            if case.plot_incentives:
                assert np.isfinite(charts._incentive_series(inc)).all(), label
        rec["suite_seconds"][beta] = seconds
        rec["suite_worst_vs_cpu"][beta] = worst_cpu
        rec["golden_worst_abs"][beta] = worst_golden
        print(f"chart suite ok: beta={beta}, 14 cases x 9 versions on the card in "
              f"{seconds:.4f} s, launches {counts}; max |card - CPU| {worst_cpu:.3g}, "
              f"worst |total - golden| {worst_golden:.3g}", flush=True)

    # ---- The padded suite at real width.
    W_small, S_small, _ = workload(seed=1, E=E * 3 // 4, shape=(V // 2, M // 2))
    suite = [
        Scenario(name=f"synthetic {w.shape[1]}x{w.shape[2]}",
                 validators=[f"v{i}" for i in range(w.shape[1])], base_validator="v0",
                 weights=w, stakes=st, num_epochs=w.shape[0])
        for w, st in ((W_np, S_np), (W_small, S_small))
    ]
    config, spec = YumaConfig(), variant_for_version("Yuma 1 (paper)")
    keys = ("dividends", "bonds", "incentives")
    saves = dict(save_bonds=True, save_incentives=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    Wp, Sp, ri, re_, mask = pad_scenarios(suite)
    padded = simulate_batch(Wp, Sp, ri, re_, config, spec, miner_mask=mask, **saves)
    torch.cuda.synchronize()
    pad_seconds = time.perf_counter() - t0
    counts = launch_counts()
    assert tuple(Wp.shape) == (2, E, V, M) and not any(counts.values()), (Wp.shape, counts)
    del Wp, Sp

    def real(out, lane, e, v, m):
        return {
            "dividends": out["dividends"][lane, :e, :v],
            "bonds": out["bonds"][lane, :e, :v, :m],
            "incentives": out["incentives"][lane, :e, :m],
        }

    pad_err = {}
    for lane, scenario in enumerate(suite):
        e, v, m = scenario.weights.shape
        solo = simulate_batch(*stack_scenarios([scenario]), config, spec,
                              epoch_impl="eager", **saves)
        for key in keys:
            got, ref = real(padded, lane, e, v, m)[key], real(solo, 0, e, v, m)[key]
            assert torch.isfinite(got).all(), (lane, key)
            if lane == 0:
                check_equal(f"padded suite, unpadded lane {key} vs its solo eager run", got, ref)
            else:
                check_close(f"padded suite, padded lane {key} vs its solo eager run", got, ref,
                            atol=PAD_ATOL, rtol=PAD_RTOL)
            pad_err[f"lane{lane}_{key}_vs_solo"] = max_err(got, ref)
        del solo
    prefix = min(16, E)
    cpu_suite = [Scenario(name=s.name, validators=s.validators, base_validator="v0",
                          weights=s.weights[:prefix], stakes=s.stakes[:prefix],
                          num_epochs=len(s.weights[:prefix])) for s in suite]
    Wc, Sc, ric, rec_, mask_c = pad_scenarios(cpu_suite, device="cpu")
    t0 = time.perf_counter()
    cpu = simulate_batch(Wc, Sc, ric, rec_, config, spec, miner_mask=mask_c, **saves)
    cpu_seconds = time.perf_counter() - t0
    for lane, scenario in enumerate(cpu_suite):
        e, v, m = scenario.weights.shape
        for key in keys:
            got = real(padded, lane, e, v, m)[key].cpu()
            ref = real(cpu, lane, e, v, m)[key]
            check_close(f"padded suite lane {lane} {key}: card vs the CPU, {prefix} epochs",
                        got, ref, atol=PAD_ATOL, rtol=PAD_RTOL)
            pad_err[f"lane{lane}_{key}_vs_cpu"] = max_err(got, ref)
    rec["padded"] = dict(shape=[2, E, V, M], lanes=[list(s.weights.shape) for s in suite],
                         version="Yuma 1 (paper)", seconds=pad_seconds, launches=counts,
                         cpu_prefix_epochs=prefix, cpu_prefix_seconds=cpu_seconds,
                         max_abs_err=pad_err)
    report["charts"] = rec
    print(f"padded suite ok: [2, {E}, {V}, {M}] with miner masks on the eager rung in "
          f"{pad_seconds:.3f} s, launches {counts}; unpadded lane bitwise its solo run; "
          f"max |err| {pad_err}", flush=True)


def sweep_phase(torch, dev, W_np, S_np, quiet_miner, launches, report):
    """The grid sweeps at full width: an 8-point config_grid (bond_alpha x
    kappa) over the 256 x 4096 x 64 workload through sweep_hyperparams
    (K3: Yuma 1, and Yuma 3.1 with its reset) and over its first epoch's
    weights x 64 scales through sweep_scaled_fused (K5). Each lane is held
    bitwise against the same point run alone with a scalar config
    (simulate_batch of one scenario, simulate_scaled)."""
    from yuma_simulation_tpu_torch.models.config import (
        SimulationHyperparameters,
        YumaConfig,
        YumaParams,
    )
    from yuma_simulation_tpu_torch.models.variants import variant_for_version
    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from yuma_simulation_tpu_torch.scenarios.base import Scenario
    from yuma_simulation_tpu_torch.simulation.engine import simulate_scaled
    from yuma_simulation_tpu_torch.simulation.sweep import (
        config_grid,
        simulate_batch,
        stack_scenarios,
        sweep_hyperparams,
        sweep_scaled_fused,
    )

    cfgs, points = config_grid(bond_alpha=[0.025, 0.05, 0.1, 0.2], kappa=[0.5, 0.6])
    G = len(points)

    def point_config(p):
        return YumaConfig(simulation=SimulationHyperparameters(kappa=p["kappa"]),
                          yuma_params=YumaParams(bond_alpha=p["bond_alpha"]))

    def timed(fn, counter):
        fn()  # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        assert counts[counter] == 1, counts
        launches[counter] = launches.get(counter, 0) + counts[counter]
        return out, seconds

    scenario = Scenario(
        name="synthetic 256x4096", validators=[f"v{i}" for i in range(V)],
        base_validator="v0", weights=W_np, stakes=S_np, num_epochs=E,
        reset_bonds_index=quiet_miner, reset_bonds_epoch=E // 2,
    )
    W1, S1, ri, re_ = stack_scenarios([scenario])
    rec = {}
    for version in ("Yuma 1 (paper)", "Yuma 3.1 (Rhef+reset)"):
        spec = variant_for_version(version)
        grid, seconds = timed(
            lambda: sweep_hyperparams(scenario, version, cfgs, save_bonds=True), "varying_scan")
        for i, p in enumerate(points):
            solo = simulate_batch(W1, S1, ri, re_, point_config(p), spec, save_bonds=True)
            for key in ("dividends", "bonds"):
                check_equal(f"sweep_hyperparams {version} lane {i} {key} vs solo",
                            grid[key][i], solo[key][0])
        assert torch.isfinite(grid["dividends"]).all(), version
        rec[version] = dict(lanes=G, epochs=E, seconds=seconds,
                            scenario_epochs_per_s=G * E / seconds)
        print(f"sweep_hyperparams ok: {version}, {G} lanes x [{E}, {V}, {M}] on K3, each "
              f"lane bitwise its solo run; {G * E / seconds:.1f} scenario-epochs/s", flush=True)
        del grid
    W0, S0 = W1[0, 0].contiguous(), S1[0, 0].contiguous()
    scales = (1.0 + 1e-7 * torch.arange(E, dtype=torch.float32, device=dev)).contiguous()
    (tot, bonds), seconds = timed(
        lambda: sweep_scaled_fused(W0, S0, scales, cfgs, "Yuma 1 (paper)"), "ema_scan")
    spec = variant_for_version("Yuma 1 (paper)")
    for i, p in enumerate(points):
        t1, b1 = simulate_scaled(W0, S0, scales, point_config(p), spec)
        check_equal(f"sweep_scaled_fused lane {i} totals vs solo", tot[i], t1)
        check_equal(f"sweep_scaled_fused lane {i} bonds vs solo", bonds[i], b1)
    rec["sweep_scaled_fused"] = dict(lanes=G, epochs=E, seconds=seconds,
                                     scenario_epochs_per_s=G * E / seconds)
    report["sweeps"] = rec
    print(f"sweep_scaled_fused ok: {G} lanes x {E} epochs of [{V}, {M}] on K5, each lane "
          f"bitwise its solo run; {G * E / seconds:.1f} scenario-epochs/s", flush=True)


def _np_equal(label, got, ref):
    if not np.array_equal(got, ref, equal_nan=True):
        bad = int((got != ref).sum())
        raise AssertionError(f"{label}: {bad} of {np.size(got)} values differ")


def streams_phase(torch, dev, W_np, S_np, quiet_miner, launches, report):
    """Long runs on the card (`simulate_streamed`, `simulate(max_resident_
    epochs=)`, `simulate_generated`), the HBM preflight, and a donor-packed
    mixed suite:

    - streamed against monolithic, bitwise (dividends and the final carry),
      at 256 x 4096 x 64 with slabs [16, 16, 16, 16] and [23, 23, 18], on
      auto (K3) and on "fused_scan" (K2), for Yuma 1, Yuma 2 (the w_prev
      carry) and Yuma 3.1 (its reset at epoch 30, inside the second slab);
      one scan launch a slab; one stream run under
      `torch.cuda.set_sync_debug_mode("warn")`, its warnings printed;
    - a long stream: 2048 epochs in 256-epoch slabs (1.07 GB each), the
      host holding four distinct slabs in turn; dividends bitwise the
      monolithic `simulate` of the same 8.6 GB stack; the stream's peak
      allocation within the plan's estimate for STREAM_BUFFERS resident
      slabs, and under half the monolithic peak; epochs/s of both; then
      the stream once more under `stream_timeline()`: CUDA events around
      each copy and scan inside the stream (the copy time that ran while a
      scan ran, the card's busy time and idle share) and the host's
      staging time inside `_CudaSlabs.stage`;
    - the preflight: `simulate` of a (20000, 256, 4096) broadcast view
      (84 GB, no host memory) raises HBMPreflightError naming a
      `max_resident_epochs`, with nothing allocated on the card;
    - `simulate_generated` over chunks drawn on the card (a CUDA
      torch.Generator seeded per chunk), bitwise the monolithic run;
    - `total_dividends_batch` of Case 1 with a random subnet (donor-packed,
      eager rung) within PAD_RTOL / PAD_ATOL of the same call on the CPU."""
    import warnings

    from yuma_simulation_tpu_torch.models.config import YumaConfig
    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from yuma_simulation_tpu_torch.scenarios import create_case
    from yuma_simulation_tpu_torch.scenarios.base import Scenario
    from yuma_simulation_tpu_torch.scenarios.synthetic import random_subnet_scenario
    from yuma_simulation_tpu_torch.simulation.engine import (
        simulate,
        simulate_generated,
        simulate_streamed,
        stream_timeline,
    )
    from yuma_simulation_tpu_torch.simulation.planner import (
        STREAM_BUFFERS,
        plan_dispatch,
        scan_scratch_bytes,
    )
    from yuma_simulation_tpu_torch.simulation.sweep import total_dividends_batch
    from yuma_simulation_tpu_torch.telemetry.cost import HBMPreflightError, estimate_hbm_bytes

    rec: dict = {}
    validators = [f"v{i}" for i in range(V)]
    reset_epoch = 30

    def scenario(Wx, Sx, reset=True):
        return Scenario(
            name="stream", validators=validators, base_validator="v0", weights=Wx,
            stakes=Sx, num_epochs=len(Wx), reset_bonds_index=quiet_miner if reset else None,
            reset_bonds_epoch=reset_epoch if reset else None,
        )

    def counted(fn):
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, launch_counts()

    # ---- Streamed against monolithic, bitwise, on K3 and K2.
    scen = scenario(W_np, S_np)
    offs = np.cumsum([0, 23, 23, 18])
    ragged = [(W_np[a:b], S_np[a:b]) for a, b in zip(offs[:-1], offs[1:])]
    even = [(W_np[a:a + 16], S_np[a:a + 16]) for a in range(0, E, 16)]
    checked = 0
    for version in ("Yuma 1 (paper)", "Yuma 2 (Adrian-Fish)", "Yuma 3.1 (Rhef+reset)"):
        for impl, counter in (("auto", "varying_scan"), ("fused_scan", "case_scan")):
            kw = dict(save_bonds=False, save_incentives=False, epoch_impl=impl,
                      return_state=True)
            mono = simulate(scen, version, **kw)
            for label, chunks in (("[16]*4", even), ("[23, 23, 18]", ragged)):
                got, counts = counted(lambda: simulate_streamed(
                    chunks, version, reset_bonds_index=quiet_miner,
                    reset_bonds_epoch=reset_epoch, **kw))
                assert got.engine == mono.engine, (got.engine, mono.engine)
                assert counts[counter] == len(chunks), (label, counts)
                launches[counter] = launches.get(counter, 0) + counts[counter]
                _np_equal(f"stream {version} {impl} {label} dividends",
                          got.dividends, mono.dividends)
                for key, value in mono.final_state.items():
                    _np_equal(f"stream {version} {impl} {label} final {key}",
                              got.final_state[key], value)
                checked += 1
            got, counts = counted(lambda: simulate(scen, version, max_resident_epochs=16, **kw))
            assert counts[counter] == 4, counts
            launches[counter] = launches.get(counter, 0) + counts[counter]
            _np_equal(f"max_resident_epochs {version} {impl}", got.dividends, mono.dividends)
            print(f"streams ok: {version} {impl} -> {mono.engine}: slabs [16]*4, "
                  "[23, 23, 18] and max_resident_epochs=16 bitwise the monolithic run",
                  flush=True)
    rec["bitwise_streams"] = checked
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            simulate_streamed(ragged, "Yuma 1 (paper)", reset_bonds_index=quiet_miner,
                              reset_bonds_epoch=reset_epoch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # torch announces the mode itself ("a prototype feature"); the rest
    # are synchronizing calls.
    syncs = sorted({f"{w.filename.split('yuma_simulation_tpu_torch/')[-1]}:{w.lineno}: "
                    f"{str(w.message)[:80]}" for w in caught
                    if "prototype feature" not in str(w.message)})
    rec["sync_debug_warnings"] = syncs
    print(f"streams: set_sync_debug_mode('warn') over a 3-slab stream: {len(syncs)} "
          f"synchronizing calls {syncs}", flush=True)

    # ---- A long stream: 2048 epochs in 256-epoch slabs, four distinct
    # slabs on the host, reused in turn.
    slab_epochs, n_slabs = 256, 8
    t0 = time.perf_counter()
    tiled_W = np.concatenate([W_np] * (slab_epochs // E))
    tiled_S = np.concatenate([S_np] * (slab_epochs // E))
    slabs = [(np.roll(tiled_W, 37 * k, axis=2), np.roll(tiled_S, 5 * k, axis=1))
             for k in range(4)]
    del tiled_W, tiled_S
    print(f"streams: four {slab_epochs}-epoch slabs made in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def stream():
        return (slabs[i % 4] for i in range(n_slabs))

    long_epochs = slab_epochs * n_slabs
    version = "Yuma 1 (paper)"
    plan = plan_dispatch("streams", (slab_epochs, V, M), version, YumaConfig(),
                         torch.float32, streaming=True, device=dev)
    two_slabs = estimate_hbm_bytes(
        V, M, resident_epochs=STREAM_BUFFERS * slab_epochs,
        scratch_bytes=scan_scratch_bytes(plan.engine, V, M),
    ).total_bytes
    simulate_streamed(stream(), version)  # warm-up: pinned buffers, allocator
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    streamed = simulate_streamed(stream(), version)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    counts = launch_counts()
    stream_peak = torch.cuda.max_memory_allocated() - base
    assert streamed.engine == plan.engine == "fused_varying", (streamed.engine, plan.engine)
    assert counts["varying_scan"] == n_slabs, counts
    launches["varying_scan"] += counts["varying_scan"]
    big = scenario(np.concatenate([s[0] for s in stream()]),
                   np.concatenate([s[1] for s in stream()]), reset=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mono = simulate(big, version, save_bonds=False, save_incentives=False)
    torch.cuda.synchronize()
    mono_s = time.perf_counter() - t0
    mono_peak = torch.cuda.max_memory_allocated() - base
    _np_equal("long stream dividends", streamed.dividends, mono.dividends)
    assert np.isfinite(streamed.dividends).all()
    assert stream_peak <= two_slabs, (stream_peak, two_slabs)
    assert stream_peak * 2 < mono_peak, (stream_peak, mono_peak)
    del big, mono
    # The same stream once more under the timeline: events around each
    # copy and scan inside the stream, the host's staging time in it.
    t0 = time.perf_counter()
    with stream_timeline() as timeline:
        timed = simulate_streamed(stream(), version)
        torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    _np_equal("timed long stream dividends", timed.dividends, streamed.dividends)
    tl = timeline.summary()
    assert tl["slabs"] == n_slabs and len(timeline.copies) == n_slabs, tl
    assert tl["copy_scan_overlap_ms"] <= min(tl["copy_ms"], tl["scan_ms"]) + 1e-3, tl
    rec["long_stream"] = dict(
        epochs=long_epochs, slab_epochs=slab_epochs, slab_bytes=slab_epochs * V * M * 4,
        stream_seconds=stream_s, stream_epochs_per_s=long_epochs / stream_s,
        monolithic_seconds=mono_s, monolithic_epochs_per_s=long_epochs / mono_s,
        stream_peak_bytes=stream_peak, two_slab_estimate_bytes=two_slabs,
        monolithic_peak_bytes=mono_peak, timed_stream_seconds=timed_s,
        device_idle_share=1.0 - tl["busy_ms"] / (timed_s * 1e3), timeline=tl,
    )
    print(f"streams: {long_epochs} epochs in {slab_epochs}-epoch slabs bitwise the monolithic "
          f"run; {long_epochs / stream_s:.1f} epochs/s streamed vs {long_epochs / mono_s:.1f} "
          f"monolithic; peak {stream_peak / 2**30:.3f} GiB (estimate for {STREAM_BUFFERS} "
          f"slabs {two_slabs / 2**30:.3f}, monolithic {mono_peak / 2**30:.3f})", flush=True)
    print(f"streams: timed stream {timed_s:.3f} s: host staging {tl['fill_s']:.3f} s filling "
          f"+ {tl['wait_s']:.3f} s waiting; copies {tl['copy_ms']:.1f} ms, scans "
          f"{tl['scan_ms']:.1f} ms, copy time hidden behind the scans "
          f"{tl['copy_scan_overlap_ms']:.2f} ms; card busy {tl['busy_ms']:.1f} ms "
          f"(idle share {rec['long_stream']['device_idle_share']:.4f}); "
          f"{tl['hidden_slabs']} of {n_slabs - 1} slabs' copy + scan "
          f"({tl['hidden_behind_staging_ms']:.1f} ms) ended behind the next slab's staging",
          flush=True)

    # ---- The preflight: an 84 GB stack is refused before any allocation.
    huge_E = 20000
    huge = Scenario(
        name="huge", validators=validators, base_validator="v0",
        weights=np.broadcast_to(W_np[:1], (huge_E, V, M)),
        stakes=np.broadcast_to(S_np[:1], (huge_E, V)), num_epochs=huge_E,
    )
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        simulate(huge, version)
    except HBMPreflightError as err:
        message = str(err)
    else:
        raise AssertionError("a (20000, 256, 4096) stack was not refused")
    assert "max_resident_epochs<=" in message, message
    assert torch.cuda.memory_allocated() == before
    rec["preflight"] = message
    print(f"streams: preflight refused [{huge_E}, {V}, {M}] with nothing allocated: {message}",
          flush=True)

    # ---- simulate_generated: chunks drawn on the card.
    CH, chunks_n = 64, 4

    def gen(i):
        g = torch.Generator(device=dev)
        g.manual_seed(1000 + i)
        Wg = torch.rand((CH, V, M), generator=g, device=dev)
        Wg = torch.where(Wg > 0.99, Wg, torch.zeros_like(Wg))
        return Wg, torch.rand((CH, V), generator=g, device=dev) + 0.01

    (d_gen, b_gen), counts = counted(lambda: simulate_generated(gen, chunks_n, version))
    assert counts["varying_scan"] == chunks_n, counts
    launches["varying_scan"] += counts["varying_scan"]
    parts = [gen(i) for i in range(chunks_n)]
    stack = scenario(torch.cat([p[0] for p in parts]).cpu().numpy(),
                     torch.cat([p[1] for p in parts]).cpu().numpy(), reset=False)
    del parts
    mono = simulate(stack, version, save_bonds=False, save_incentives=False, return_state=True)
    _np_equal("simulate_generated dividends", d_gen, mono.dividends)
    _np_equal("simulate_generated final bonds", b_gen, mono.final_state["bonds"])
    rec["generated"] = dict(chunks=chunks_n, chunk_epochs=CH, launches=counts["varying_scan"])
    print(f"streams: simulate_generated {chunks_n} x {CH} epochs drawn on the card bitwise "
          "the monolithic run", flush=True)

    # ---- A mixed suite through total_dividends_batch (donor-packed).
    suite = [create_case("Case 1"),
             random_subnet_scenario(7, num_validators=5, num_miners=4, num_epochs=30)]
    for version in ("Yuma 1 (paper)", "Yuma 1 (paper) - liquid alpha on"):
        got, counts = counted(lambda: total_dividends_batch(suite, version))
        ref = total_dividends_batch(suite, version, device="cpu")
        assert not any(counts.values()), counts  # the masked suite runs eager
        assert got.shape == ref.shape == (2, 8), got.shape
        np.testing.assert_allclose(got, ref, rtol=PAD_RTOL, atol=PAD_ATOL)
    rec["mixed_suite_max_abs"] = float(np.abs(got - ref).max())
    print("streams: total_dividends_batch of a mixed suite within PAD_RTOL / PAD_ATOL of "
          "the CPU run", flush=True)
    report["streams"] = rec


#: The Monte-Carlo phase (BASELINE config 5 as the JAX package's bench.py
#: runs it: 8 scenarios x 64 epochs at 256 x 4096, fresh weights every
#: epoch), in K7 slabs of 16 epochs: 4 K7 and 4 K3 launches.
MC_B, MC_E, MC_CHUNK, MC_SEED, MC_P = 8, 64, 16, 5, 0.05
#: Timed runs of it (host clock, synchronized); the median is reported.
MC_REPS = 3
#: JAX's own `_montecarlo_weight_slab` at these (scenario, epoch, validator,
#: miner) of PRNGKey(5)'s [8, 16, 256, 4096] slabs of ones, epochs from 0
#: and from 70000, p = 0.05 (made on the CPU with jax 0.9; the card's
#: machine has no JAX): K7 and its plain version are held to them bitwise.
K7_GOLDEN_INDEX = [(0, 0, 0, 0), (0, 0, 0, 1), (1, 3, 17, 2049), (3, 7, 100, 2000),
                   (5, 0, 255, 4095), (7, 15, 128, 7), (7, 15, 255, 4095)]
K7_GOLDEN = {
    0: ["0x1.144a32p+0", "0x1.f85228p-1", "0x1.00a798p+0", "0x1.f41f62p-1",
        "0x1.186948p+0", "0x1.fc6bdap-1", "0x1.0a32c6p+0"],
    70000: ["0x1.092726p+0", "0x1.fb3c0cp-1", "0x1.fa0816p-1", "0x1.08dab0p+0",
            "0x1.f24388p-1", "0x1.0831e2p+0", "0x1.0cb6fcp+0"],
}
#: K7's operations an element, as csrc/mc_weights.cu spells them: the
#: threefry block (20 rounds of add / rotate / xor, 5 key injections of 3
#: adds, 2 initial adds, the xor of the words: 78), the uniform (shift, or,
#: subtract, FMA, max: 5), `-x*x` and the negation of log1p (2), the
#: erf_inv polynomial (a compare, the shift of w, 8 FMAs, the |x| test and
#: the product: 12) and the weight (FMA, max: 2); plus log1p's branch:
#: the rational form (19) where |x*x| < sqrt(2) - 1, else log(1 + x) (31).
#: The epoch key (one threefry block a slab) is left out.
K7_OPS_COMMON, K7_OPS_LOG1P_SMALL, K7_OPS_LOG1P_LARGE = 99, 19, 31
#: The constant-weights Monte-Carlo: 64 scenarios of one 16 x 256
#: perturbation each, 500 epochs (the hoisted constant scan, no kernel).
CONST_B, CONST_E, CONST_V, CONST_M = 64, 500, 16, 256


def mc_profile(torch, smi, fn) -> dict:
    """Where one Monte-Carlo run's time goes, from torch.profiler (CUPTI):
    device ms of K7 (`k_mc_weights`), of K3's phase kernels (the other
    `k_*`), of PyTorch's own kernels and of copies; the card's busy ms (the
    union of every device interval: K7 runs on a side stream, beside the
    scans), the run's host wall ms, and the card's idle share over it. The
    profiler's table is appended to build/chip_smoke/chip_smoke_profile.txt."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with held_profiler(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "a") as f:
        f.write(f"== montecarlo_per_epoch_batched [{MC_B}, {MC_E}, {V}, {M}], chunks of "
                f"{MC_CHUNK}, one call, {smi}\n")
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
        f.write("\n")
    ms = {"k_mc_weights": 0.0, "scan_kernels": 0.0, "torch_kernels": 0.0, "copies": 0.0}
    spans = []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        kernel = re.search(r"\bk_[a-z_]+", evt.name)
        if kernel and kernel.group(0) == "k_mc_weights":
            key = "k_mc_weights"
        elif kernel:
            key = "scan_kernels"
        elif evt.name.startswith("Memcpy") or evt.name.startswith("Memset"):
            key = "copies"
        else:
            key = "torch_kernels"
        ms[key] += (end - start) / 1e3
    assert ms["k_mc_weights"] > 0 and ms["scan_kernels"] > 0, ms  # the profiler saw the card
    busy, last = 0.0, None
    for start, end in sorted(spans):
        if last is None or start > last:
            busy += end - start
            last = end
        elif end > last:
            busy += end - last
            last = end
    ms["busy_ms"] = busy / 1e3
    ms["wall_ms"] = wall_ms
    ms["idle_share"] = max(0.0, 1.0 - ms["busy_ms"] / wall_ms)
    return ms


def mc_phase(torch, dev, launches, measured, report):
    """The Monte-Carlo drivers (parallel/sharded.py) and K7. K7 against
    its plain version (random.py::perturbed_weights) on PRNGKey(5)'s
    [8, 16, 256, 4096] slabs from epochs 0 and 70000, bitwise, and both
    against JAX's golden values; `montecarlo_per_epoch_batched` (K7 + K3,
    chunks of 16) with its launches counted, within ATOL / RTOL of the same
    run on the plain versions, chunks of 32 against 16 within the same
    class, and `montecarlo_total_dividends` over the card's one-device mesh
    bitwise; the constant-weights Monte-Carlo on the card against the same
    on the CPU; `simulate_batch_sharded` over the one-device mesh bitwise
    `simulate_batch`."""
    import contextlib

    from yuma_simulation_tpu_torch import random as R
    from yuma_simulation_tpu_torch.models.config import YumaConfig
    from yuma_simulation_tpu_torch.models.variants import variant_for_version
    from yuma_simulation_tpu_torch.ops.cuda_epoch import fused_varying_scan_plain
    from yuma_simulation_tpu_torch.ops.cuda_random import mc_weights
    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from yuma_simulation_tpu_torch.parallel import (
        make_mesh,
        montecarlo_per_epoch_batched,
        montecarlo_total_dividends,
        sharded,
        simulate_batch_sharded,
    )
    from yuma_simulation_tpu_torch.scenarios import get_cases
    from yuma_simulation_tpu_torch.simulation import engine
    from yuma_simulation_tpu_torch.simulation.sweep import simulate_batch, stack_scenarios

    rec: dict = {}
    keys = R.split(R.split(R.PRNGKey(MC_SEED), 1)[0], MC_B).to(dev)
    base = torch.ones((V, M), device=dev)
    plain_ms = []
    for lo in (0, 70000):
        got = mc_weights(keys, lo, MC_CHUNK, base, MC_P)
        plain, ms = timed_once(
            torch, lambda: R.perturbed_weights(keys, lo, MC_CHUNK, base, MC_P))
        plain_ms.append(ms)
        check_equal(f"K7 vs its plain version, epochs from {lo}", got, plain)
        for idx, want in zip(K7_GOLDEN_INDEX, K7_GOLDEN[lo]):
            for label, x in (("K7", got), ("plain", plain)):
                assert float(x[idx]) == float.fromhex(want), (label, lo, idx, float(x[idx]))
        assert torch.isfinite(got).all() and bool((got >= 0).all())
        del plain
    out = torch.empty((MC_B, MC_CHUNK, V, M), device=dev)
    k7_ms = cuda_ms(torch, lambda: mc_weights(keys, 0, MC_CHUNK, base, MC_P, out=out), 20)
    # The operations this slab's draws need: log1p's branch, element by element.
    small = 0
    for b in range(MC_B):
        u = R.uniform(R.fold_in(keys[b], torch.arange(MC_CHUNK, device=dev)), (V, M),
                      R.NORMAL_LO, 1.0)
        small += int(((u * -u).abs() < R._LOG1P_SMALL).sum())
    n = MC_B * MC_CHUNK * V * M
    ops = n * K7_OPS_COMMON + small * K7_OPS_LOG1P_SMALL + (n - small) * K7_OPS_LOG1P_LARGE
    k7 = dict(max_abs_err=0.0, ms=k7_ms, plain_ms=sum(plain_ms) / len(plain_ms),
              library_ms=None)
    k7["bound_ms"], k7["bound_by"] = bound_ms(4 * n + 4 * V * M + 8 * MC_B, ops)
    measured["mc_weights"] = k7
    del out
    print(f"K7 ok: [{MC_B}, {MC_CHUNK}, {V}, {M}] slabs from epochs 0 and 70000 bitwise its "
          f"plain version and JAX's golden; {k7} ({ops / n:.1f} operations an element)",
          flush=True)

    def mc_run(**kw):
        return montecarlo_per_epoch_batched(R.PRNGKey(MC_SEED), MC_B, MC_E, V, M,
                                            "Yuma 1 (paper)", consensus_impl="bisect", **kw)

    mc_run(chunk_epochs=MC_CHUNK)  # warm-up
    runs = []
    for _ in range(MC_REPS):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        tot = mc_run(chunk_epochs=MC_CHUNK)
        runs.append(time.perf_counter() - t0)
        counts = launch_counts()
        if len(runs) > 1:
            _np_equal("montecarlo_per_epoch_batched run to run", tot, tot16)
        tot16 = tot
    seconds = sorted(runs)[len(runs) // 2]
    chunks = MC_E // MC_CHUNK
    assert counts["varying_scan"] == chunks and counts["mc_weights"] == chunks, counts
    assert tot16.shape == (MC_B, V) and np.isfinite(tot16).all()
    launches["varying_scan"] = launches.get("varying_scan", 0) + chunks
    launches["mc_weights"] = launches.get("mc_weights", 0) + chunks
    tot32 = mc_run(chunk_epochs=2 * MC_CHUNK)
    np.testing.assert_allclose(tot32, tot16, atol=ATOL, rtol=RTOL)
    mesh_tot = montecarlo_total_dividends(
        R.PRNGKey(MC_SEED), MC_B, MC_E, V, M, "Yuma 1 (paper)", mesh=make_mesh(),
        weights_mode="per_epoch", consensus_impl="bisect")
    _np_equal("montecarlo_total_dividends(mesh=make_mesh()) vs the batched driver",
              mesh_tot, tot16)

    @contextlib.contextmanager
    def plain_versions():
        """K7 and K3 swapped for their plain versions, on the card."""
        def plain_k7(keys, lo, n, base, p, *, out=None):
            w = R.perturbed_weights(keys, lo, n, base, p)
            return w if out is None else out.copy_(w)

        saved = sharded.mc_weights, engine.fused_varying_scan
        sharded.mc_weights, engine.fused_varying_scan = plain_k7, fused_varying_scan_plain
        try:
            yield
        finally:
            sharded.mc_weights, engine.fused_varying_scan = saved

    rec["profile"] = mc_profile(torch, report["card"], lambda: mc_run(chunk_epochs=MC_CHUNK))
    print(f"montecarlo profile (one run, torch.profiler): {rec['profile']}", flush=True)

    with plain_versions():
        reset_launch_counts()
        plain_tot, plain_run_ms = timed_once(torch, lambda: mc_run(chunk_epochs=MC_CHUNK))
        assert not any(launch_counts().values()), launch_counts()
    np.testing.assert_allclose(tot16, plain_tot, atol=ATOL, rtol=RTOL)
    rec["per_epoch"] = dict(
        scenarios=MC_B, epochs=MC_E, chunk_epochs=MC_CHUNK, seconds=seconds, runs_s=runs,
        scenario_epochs_per_s=MC_B * MC_E / seconds, launches=counts,
        max_abs_vs_plain=float(np.abs(tot16 - plain_tot).max()), plain_s=plain_run_ms / 1e3,
        chunk32_max_abs=float(np.abs(tot32 - tot16).max()),
        k7_ms_per_slab=k7_ms, k7_bound_ms=k7["bound_ms"], k7_bound_by=k7["bound_by"],
    )
    print(f"montecarlo_per_epoch_batched ok: {MC_B} x {MC_E} epochs of [{V}, {M}] in chunks "
          f"of {MC_CHUNK} (K7 + K3, launches {counts}): {MC_B * MC_E / seconds:.1f} "
          f"scenario-epochs/s; {rec['per_epoch']}", flush=True)

    const_kw = dict(weights_mode="constant", consensus_impl="bisect")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = montecarlo_total_dividends(R.PRNGKey(7), CONST_B, CONST_E, CONST_V, CONST_M,
                                      "Yuma 1 (paper)", mesh=make_mesh(), **const_kw)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = montecarlo_total_dividends(R.PRNGKey(7), CONST_B, CONST_E, CONST_V, CONST_M,
                                     "Yuma 1 (paper)", mesh=make_mesh(devices=["cpu"]),
                                     **const_kw)
    cpu_s = time.perf_counter() - t0
    assert card.shape == (CONST_B, CONST_V) and np.isfinite(card).all()
    # The card's and the CPU's reductions (outside xla_chains at M = 256) round
    # in other orders, so their per-epoch dividends differ by an ulp and the
    # float32 running sums of 500 of them round apart: bounded by the worst
    # case of such a sum, E float32 roundings of the total.
    np.testing.assert_allclose(card, cpu, atol=0, rtol=CONST_E * 2.0**-24)
    rec["constant"] = dict(scenarios=CONST_B, epochs=CONST_E, V=CONST_V, M=CONST_M,
                           seconds=card_s, cpu_seconds=cpu_s,
                           max_abs_vs_cpu=float(np.abs(card - cpu).max()),
                           max_rel_vs_cpu=float((np.abs(card - cpu) / np.abs(cpu)).max()))
    print(f"constant Monte-Carlo ok: {CONST_B} x {CONST_E} epochs of [{CONST_V}, {CONST_M}] "
          f"(hoisted) on the card against the CPU: {rec['constant']}", flush=True)

    cases = get_cases()
    reset_launch_counts()
    sharded_out = simulate_batch_sharded(cases, "Yuma 1 (paper)", mesh=make_mesh(),
                                         save_bonds=True, x64=True)
    counts = launch_counts()
    assert counts["varying_scan"] == 1, counts
    launches["varying_scan"] += 1
    Wc, Sc, ri, re_ = stack_scenarios(cases)
    ref = simulate_batch(Wc, Sc, ri, re_, YumaConfig(), variant_for_version("Yuma 1 (paper)"),
                         save_bonds=True, x64=True)
    for key in ("dividends", "bonds"):
        _np_equal(f"simulate_batch_sharded {key} vs simulate_batch", sharded_out[key],
                  ref[key].cpu().numpy())
    rec["sharded_batch"] = dict(cases=len(cases), mesh=make_mesh().shape, launches=counts)
    report["mc"] = rec
    print(f"simulate_batch_sharded ok: {len(cases)} cases over the one-device mesh bitwise "
          f"simulate_batch; launches {counts}", flush=True)


def scaled_phases(torch, dev, measured, launches, report):
    """K5 and K6 against their plain versions, then the scaled throughput
    path through its entry points."""
    from yuma_simulation_tpu_torch.models.config import YumaConfig, YumaParams
    from yuma_simulation_tpu_torch.models.epoch import BondsMode
    from yuma_simulation_tpu_torch.models.variants import variant_for_version
    from yuma_simulation_tpu_torch.ops.cuda_epoch import (
        fused_ema_epoch,
        fused_ema_epoch_plain,
        fused_ema_scan,
        fused_ema_scan_plain,
    )
    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from yuma_simulation_tpu_torch.ops.normalize import normalize_weight_rows
    from yuma_simulation_tpu_torch.simulation.engine import (
        fused_hparams,
        simulate_constant,
        simulate_scaled,
        simulate_scaled_batch,
    )
    from yuma_simulation_tpu_torch.simulation.planner import resolve_scaled_engine

    # Base weights: the first epoch of workload(seed, 1) - its 64 strong
    # miners keep liquid alpha finite; scales as bench.py's headline.
    base = [workload(seed, 1) for seed in range(4)]
    Wb = torch.tensor(np.stack([w[0] for w, _, _ in base]), device=dev)
    Sb = torch.tensor(np.stack([s[0] for _, s, _ in base]), device=dev)
    W1, S1 = Wb[0].contiguous(), Sb[0].contiguous()
    Sn1 = (S1 / S1.sum()).contiguous()
    Snb = (Sb / Sb.sum(-1, keepdim=True)).contiguous()

    def scales_of(n):
        return (1.0 + 1e-7 * torch.arange(n, dtype=torch.float32, device=dev)).contiguous()

    # ---- K5 vs its plain version: five bond models, and batched.
    sc16 = scales_of(16)
    err5 = 0.0
    for version, params in VERSIONS + [("Yuma 1 (paper) batched", {})]:
        batched = version.endswith("batched")
        spec = variant_for_version(version.replace(" batched", ""))
        kw = dict(mode=spec.bonds_mode, x64=spec.bonds_mode is BondsMode.EMA_RUST,
                  **fused_hparams(YumaConfig(yuma_params=YumaParams(**params))))
        W_, S_ = (Wb, Snb) if batched else (W1, Sn1)
        got = fused_ema_scan(W_, S_, sc16, **kw)
        ref = fused_ema_scan_plain(W_, S_, sc16, **kw)
        torch.cuda.synchronize()
        for g, r, key in zip(got, ref, ("final bonds", "D_n total")):
            check_close(f"K5 {version} {key}", g, r)
            assert torch.isfinite(g).all(), (version, key)
            err5 = max(err5, max_err(g, r))
    print(f"K5 ok: 5 bond models + batched x4, max |kernel - plain| {err5:.3g}", flush=True)

    # ---- K6 vs its plain version.
    rng = np.random.default_rng(5)
    B_old = torch.tensor((rng.random((V, M)) * 1e-3).astype(np.float32), device=dev)
    clip = normalize_weight_rows(Wb[1])
    err6 = 0.0
    for mode, clip_base, m_real in (
        (BondsMode.EMA, None, None), (BondsMode.EMA_RUST, None, None),
        (BondsMode.EMA_PREV, clip, None), (BondsMode.EMA, None, M * 31 // 32),
    ):
        for first in (True, False):
            kw = dict(w_scale=1.0000001, first_epoch=first, clip_base=clip_base, mode=mode,
                      m_real=m_real, x64=mode is BondsMode.EMA_RUST)
            got = fused_ema_epoch(W1, Sn1, B_old, **kw)
            ref = fused_ema_epoch_plain(W1, Sn1, B_old, **kw)
            torch.cuda.synchronize()
            for g, r, key in zip(got, ref, ("bonds", "D_n", "incentive")):
                check_close(f"K6 {mode.name} first={first} m_real={m_real} {key}", g, r)
                err6 = max(err6, max_err(g, r))
    print(f"K6 ok: EMA / EMA_RUST / EMA_PREV+clip / m_real, first and later; "
          f"max |kernel - plain| {err6:.3g}", flush=True)

    # ---- Timings: K5 over 64 epochs, its two spellings in 16 pairs, the
    # order alternating from pair to pair so that drift cancels; K6.
    sc64 = scales_of(64)
    pairs = []
    for i in range(16):
        t = {}
        for mxu in ((False, True) if i % 2 == 0 else (True, False)):
            t[mxu] = cuda_ms(torch, lambda: fused_ema_scan(W1, Sn1, sc64, mxu=mxu), 10)
        pairs.append((t[False], t[True]))
    t_vpu, t_mxu = [p[0] for p in pairs], [p[1] for p in pairs]
    k5_vpu, k5_mxu = float(np.median(t_vpu)), float(np.median(t_mxu))
    mxu_wins = sum(m < v for v, m in pairs)
    gap = float(np.median([v - m for v, m in pairs]))
    report["k5_spellings_ms_per_64_epochs"] = dict(
        pairs_vpu_mxu=pairs, mxu_wins=mxu_wins, median_vpu_minus_mxu=gap,
    )
    print(f"K5 at [{V}, {M}] x 64 epochs, 16 alternated pairs: median VPU support "
          f"{k5_vpu} ms, tensor-core support {k5_mxu} ms; tensor cores faster in "
          f"{mxu_wins} of 16, median paired gap (VPU - tensor cores) {gap} ms; "
          f"pairs {pairs}", flush=True)
    ops_epoch = (BISECT_OPS + ELEMENTWISE_OPS) * V * M
    k5 = dict(
        max_abs_err=err5, ms=k5_vpu, vpu_ms=k5_vpu, mxu_ms=k5_mxu,
        plain_ms=cuda_ms(torch, lambda: fused_ema_scan_plain(W1, Sn1, sc64), 1),
        library_ms=None,
    )
    k5["bound_ms"], k5["bound_by"] = bound_ms(4 * (2 * V * M + 2 * V + 64), 64 * ops_epoch)
    # K6 as the fused rung calls it: w_scale a 0-d tensor on the card.
    w_scale = sc64[1]
    k6 = dict(
        max_abs_err=err6,
        ms=cuda_ms(torch, lambda: fused_ema_epoch(W1, Sn1, B_old, w_scale=w_scale), 20),
        plain_ms=cuda_ms(
            torch, lambda: fused_ema_epoch_plain(W1, Sn1, B_old, w_scale=w_scale), 3),
        library_ms=None,
    )
    k6["bound_ms"], k6["bound_by"] = bound_ms(4 * (3 * V * M + 2 * V + M), ops_epoch)
    report["host_ms"]["ema_epoch"] = host_ms(
        torch, lambda: fused_ema_epoch(W1, Sn1, B_old, w_scale=w_scale))
    report["host_ms"]["ema_epoch_float_scale"] = host_ms(
        torch, lambda: fused_ema_epoch(W1, Sn1, B_old, w_scale=1.0000001))
    measured["ema_scan"], measured["ema_epoch"] = k5, k6
    print(f"K5 timing {k5}\nK6 timing {k6}", flush=True)

    # ---- The scaled main path, through the entry points.
    config, spec = YumaConfig(), variant_for_version("Yuma 1 (paper)")
    E_main = 512
    sc_main = scales_of(E_main)

    def counted(label, fn):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        print(f"scaled path: {label}: {seconds:.4f} s; launches {counts}", flush=True)
        return out, seconds, counts

    simulate_scaled(W1, S1, sc_main, config, spec)  # warm-up
    (tot, bonds), seconds, counts = counted(
        f"simulate_scaled auto, {E_main} epochs",
        lambda: simulate_scaled(W1, S1, sc_main, config, spec),
    )
    rung = resolve_scaled_engine((V, M), spec.bonds_mode, config, torch.float32, E_main,
                                 device=dev)
    assert counts["ema_scan"] == 1, counts
    assert tot.shape == (V,) and bonds.shape == (V, M), (tot.shape, bonds.shape)
    assert torch.isfinite(tot).all() and torch.isfinite(bonds).all()
    other = "fused_scan_mxu" if rung == "fused_scan" else "fused_scan"
    (tot2, bonds2), _, counts = counted(
        f"simulate_scaled {other}",
        lambda: simulate_scaled(W1, S1, sc_main, config, spec, epoch_impl=other),
    )
    assert counts["ema_scan"] == 1, counts
    assert launches["support_mma"] >= 1, launches
    check_equal("simulate_scaled auto vs the other K5 spelling, totals", tot2, tot)
    check_equal("simulate_scaled auto vs the other K5 spelling, bonds", bonds2, bonds)
    simulate_scaled_batch(Wb, Sb, sc_main, config, spec)  # warm-up
    (tot_b, bonds_b), seconds_b, counts = counted(
        f"simulate_scaled_batch auto, B=4 x {E_main} epochs",
        lambda: simulate_scaled_batch(Wb, Sb, sc_main, config, spec),
    )
    assert counts["ema_scan"] == 1, counts
    check_equal("batch lane 0 vs the single run, totals", tot_b[0], tot)
    check_equal("batch lane 0 vs the single run, bonds", bonds_b[0], bonds)
    (tot_f, bonds_f), seconds_f, counts = counted(
        "simulate_scaled fused, 16 epochs",
        lambda: simulate_scaled(W1, S1, sc16, config, spec, epoch_impl="fused"),
    )
    assert counts["ema_epoch"] == 16, counts
    tot_s, bonds_s = simulate_scaled(W1, S1, sc16, config, spec, epoch_impl="fused_scan")
    # The per-epoch rung converts each epoch's D_n, the scan their sum; the
    # clip and carried weights of "fused" are normalized by the blocked
    # miner sum: close, not bitwise.
    check_close("fused (K6) vs fused_scan (K5) totals, 16 epochs", tot_f, tot_s)
    check_close("fused (K6) vs fused_scan (K5) bonds, 16 epochs", bonds_f, bonds_s)
    const = {}
    for hoist in (False, True):
        (tot_c, bonds_c), sec_c, _ = counted(
            f"simulate_constant hoist_invariant={hoist}, 64 epochs",
            lambda: simulate_constant(W1, S1, 64, config, spec, hoist_invariant=hoist),
        )
        assert torch.isfinite(tot_c).all() and torch.isfinite(bonds_c).all()
        const[hoist] = (tot_c, bonds_c, sec_c)
    check_close("simulate_constant hoisted vs scan totals", const[True][0], const[False][0])
    check_close("simulate_constant hoisted vs scan bonds", const[True][1], const[False][1])
    k5["ms"] = k5_mxu if rung == "fused_scan_mxu" else k5_vpu
    report["scaled_path"] = dict(
        rung=rung, epochs=E_main, seconds=seconds, epochs_per_s=E_main / seconds,
        batch=4, batch_seconds=seconds_b, scenario_epochs_per_s=4 * E_main / seconds_b,
        fused_epochs_per_s=16 / seconds_f,
        constant_epochs_per_s={str(h): 64 / v[2] for h, v in const.items()},
    )
    print(f"scaled main path: simulate_scaled auto -> {rung}, {E_main / seconds:.1f} "
          f"epochs/s; batch x4 {4 * E_main / seconds_b:.1f} scenario-epochs/s; "
          f"fused (K6 per epoch) {16 / seconds_f:.1f} epochs/s (host clock, "
          f"synchronized)", flush=True)
    # Where K6's time goes: the fused rung's 16 epochs by phase kernel.
    report["phases"].update(phase_profile(torch, report["card"], (
        ("ema_epoch_x16",
         lambda: simulate_scaled(W1, S1, sc16, config, spec, epoch_impl="fused")),
    ), mode="a"))


#: Pairs of `simulate` runs, numerics capture off and on in alternating
#: order, that time the capture's cost (telemetry_phase).
NUMERICS_PAIRS = 16


def _sketch_equal(label, got: dict, ref: dict) -> None:
    """Two host sketch sets bitwise equal."""
    from yuma_simulation_tpu_torch.telemetry.numerics import sketch_mismatches

    bad = sketch_mismatches(got, ref)
    assert not bad, (label, bad)


def telemetry_phase(torch, dev, scenario, main_run, smi, launches, report):
    """The telemetry core on the main path's workload (256 x 4096 x 64):
    every run's numerics sketches (K3 with and without the consensus saved,
    K2, the eager rung with K1) are bitwise the port's CPU sketches of the
    same outputs; a one-ulp flip of one dividend cell moves its epoch's
    fingerprint by exactly 1; a streamed run's numerics are bitwise the
    monolithic run's; the runs nest in spans; under `profile_trace` the
    trace holds the `simulate:fused_varying` range and K3's phase kernels
    fall inside it; the metrics, the dispatch table and the device sample
    have their entries; and the capture's cost, `simulate`'s epochs/s with
    YUMA_NUMERICS=0 and =1 in NUMERICS_PAIRS alternating pairs."""
    from yuma_simulation_tpu_torch.ops.fingerprint import flip_ulp, ulp_delta
    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from yuma_simulation_tpu_torch.scenarios.base import Scenario
    from yuma_simulation_tpu_torch.simulation.engine import simulate
    from yuma_simulation_tpu_torch.simulation.planner import bucket_shape
    from yuma_simulation_tpu_torch.telemetry import (
        LatencySketch,
        dispatch_snapshot,
        ensure_run,
        get_registry,
        record_device_telemetry,
        span,
    )
    from yuma_simulation_tpu_torch.telemetry.numerics import (
        capture_streams,
        host_sketches,
        sketch_over_epochs,
        to_host,
    )
    from yuma_simulation_tpu_torch.utils.profiling import (
        profile_trace,
        trace_range_windows,
        within,
    )

    version = "Yuma 1 (paper)"
    out: dict = {}
    assert main_run.numerics is not None, "the main path returned no numerics"
    _sketch_equal("main path", main_run.numerics, host_sketches({"dividends": main_run.dividends}))
    reset_launch_counts()
    with ensure_run() as run, span("telemetry_phase", shape=f"{E}x{V}x{M}"):
        # ---- The stream set of each rung, each sketch bitwise the port's CPU
        # sketch of the same outputs copied to the host.
        with span("sketches"):
            k3 = simulate(scenario, version, save_consensus=True)
            assert k3.engine == "fused_varying", k3.engine
            _sketch_equal("K3, consensus saved", k3.numerics, host_sketches(
                {"dividends": k3.dividends, "consensus": k3.consensus}))
            k2 = simulate(scenario, version, epoch_impl="fused_scan")
            _sketch_equal("K2", k2.numerics, host_sketches({"dividends": k2.dividends}))
            short = Scenario(
                name="synthetic 256x4096, 4 epochs", validators=scenario.validators,
                base_validator="v0", weights=scenario.weights[:4], stakes=scenario.stakes[:4],
                num_epochs=4,
            )
            k1 = simulate(short, version, epoch_impl="eager", consensus_impl="kernel")
            k1c = simulate(short, version, epoch_impl="eager", consensus_impl="kernel",
                           save_consensus=True)
            # The eager rung sketches the consensus whether or not it is saved.
            _sketch_equal("K1 eager, consensus unsaved vs saved", k1.numerics, k1c.numerics)
            _sketch_equal("K1 eager", k1c.numerics, host_sketches(
                {"dividends": k1c.dividends, "consensus": k1c.consensus}))
        counts = launch_counts()
        assert counts["varying_scan"] >= 1 and counts["case_scan"] >= 1, counts
        assert counts["consensus_bisect"] == 8, counts
        out["stream_sets"] = {"fused_varying": sorted(main_run.numerics),
                              "fused_varying+consensus": sorted(k3.numerics),
                              "fused_scan": sorted(k2.numerics), "eager": sorted(k1.numerics)}
        # ---- One dividend cell one ulp up: its epoch's fingerprint moves by 1.
        D = torch.tensor(main_run.dividends, device=dev)
        e, v = E // 2, int(torch.argmax(D[E // 2]))
        D_flip = D.clone()
        D_flip[e, v] = flip_ulp(D_flip[e, v])
        base = to_host({"d": sketch_over_epochs(D, 0)})["d"].fingerprint
        moved = to_host({"d": sketch_over_epochs(D_flip, 0)})["d"].fingerprint
        deltas = [ulp_delta(a, b) for a, b in zip(base, moved)]
        assert deltas[e] == 1 and sum(abs(d) for d in deltas) == 1, deltas
        out["flip_ulp_delta"] = deltas[e]
        # The capture's own cost on the card: the main path's one stream.
        out["capture_ms"] = cuda_ms(
            torch, lambda: capture_streams({"dividends": D}, epoch_axis=0), 20)
        out["capture_host_ms"] = host_ms(
            torch, lambda: capture_streams({"dividends": D}, epoch_axis=0))
        # ---- Streaming: 16-epoch slabs, numerics bitwise the monolithic run's.
        with span("streamed"):
            streamed = simulate(scenario, version, max_resident_epochs=16)
        assert streamed.engine == "fused_varying", streamed.engine
        _sketch_equal("streamed vs monolithic", streamed.numerics, main_run.numerics)
        # ---- The profiler: the dispatch's range, and K3's kernels inside it.
        trace_dir = os.path.join(OUT_DIR, "trace")
        with span("profiled"), profile_trace(trace_dir):
            for _ in range(2):
                simulate(scenario, version)
            torch.cuda.synchronize()
        win = trace_range_windows(os.path.join(trace_dir, "trace.json"), "simulate:fused_varying")
        assert win["cpu"] and win["kernels"], (len(win["cpu"]), len(win["kernels"]))
        by_launch = all(within(launch, win["cpu"]) for _, _, launch in win["kernels"])
        assert by_launch, "a K3 kernel was launched outside the simulate:fused_varying range"
        on_card = all(within(k, win["gpu"]) for _, k, _ in win["kernels"]) if win["gpu"] else None
        assert on_card is not False, "a K3 kernel ran outside the range's window on the card"
        out["profile"] = dict(
            ranges_host=len(win["cpu"]), ranges_card=len(win["gpu"]),
            kernels=len(win["kernels"]), launched_inside=by_launch, ran_inside=on_card,
        )
    counts = launch_counts()
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    out["launches"] = counts
    records = run.span_records()
    names = {r["span_id"]: r["name"] for r in records}
    print("span tree (telemetry phase):", flush=True)
    for r in records:
        print(f"  {r['span_id']} <- {r['parent_id'] or '-':6s} {r['name']:18s} "
              f"{(r['t_end'] - r['t_start']) * 1e3:9.2f} ms steps={r.get('attrs', {}).get('steps')}",
              flush=True)
    assert all(r["parent_id"] in names for r in records if r["name"] != "telemetry_phase"), records
    out["spans"] = [r["name"] for r in records]
    # ---- Metrics, the dispatch table, the device sample.
    snap = get_registry().snapshot()
    assert snap["counters"].get("epochs_total", 0) > 0, snap
    assert snap["gauges"].get("epochs_per_sec", 0) > 0, snap
    bucket = bucket_shape(V, M, epochs=E).key
    keys = [k for k, rec in dispatch_snapshot().items()
            if (rec["engine"], rec["bucket"], rec["backend"]) == ("fused_varying", bucket, "gpu")]
    assert len(keys) == 1, (keys, sorted(dispatch_snapshot()))
    table = dispatch_snapshot()[keys[0]]
    sample = record_device_telemetry()
    assert sample["backend"] == "gpu" and sample["device_peak_bytes"], sample
    out["metrics"] = dict(
        epochs_total=snap["counters"]["epochs_total"], epochs_per_sec=snap["gauges"]["epochs_per_sec"],
        dispatch_key=keys[0], dispatches=table["dispatches"],
        dispatch_p50_s=LatencySketch.from_json(table["sketch"]).quantile(0.5),
        device=sample,
    )
    # ---- The capture's cost: epochs/s with numerics off and on, in turns.
    rates: dict = {"0": [], "1": []}
    previous = os.environ.get("YUMA_NUMERICS")
    reset_launch_counts()
    try:
        for i in range(NUMERICS_PAIRS):
            for flag in (("0", "1") if i % 2 == 0 else ("1", "0")):
                os.environ["YUMA_NUMERICS"] = flag
                t0 = time.perf_counter()
                r = simulate(scenario, version)
                rates[flag].append(E / (time.perf_counter() - t0))
                assert (r.numerics is None) == (flag == "0"), flag
    finally:
        if previous is None:
            os.environ.pop("YUMA_NUMERICS", None)
        else:
            os.environ["YUMA_NUMERICS"] = previous
    pair_counts = launch_counts()
    assert pair_counts["varying_scan"] == 2 * NUMERICS_PAIRS, pair_counts
    assert not any(n for name, n in pair_counts.items() if name != "varying_scan"), pair_counts
    launches["varying_scan"] += pair_counts["varying_scan"]
    out["launches_pairs"] = pair_counts
    out["numerics_cost"] = dict(
        card=smi, pairs=NUMERICS_PAIRS, off_epochs_per_s=float(np.median(rates["0"])),
        on_epochs_per_s=float(np.median(rates["1"])), off=rates["0"], on=rates["1"],
    )
    print(f"numerics capture cost ({smi}): simulate {E} epochs, median epochs/s off "
          f"{out['numerics_cost']['off_epochs_per_s']:.1f}, on "
          f"{out['numerics_cost']['on_epochs_per_s']:.1f} ({NUMERICS_PAIRS} pairs)", flush=True)
    report["telemetry"] = out
    print(f"telemetry ok: stream sets {out['stream_sets']}; profile {out['profile']}", flush=True)


#: The resilience phase's supervised / unsupervised `simulate` pairs.
SUPERVISION_PAIRS = 10


def ulp_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per element, the distance in float32 ulps between `a` and `b` (the
    bit patterns mapped onto one ordered integer line)."""

    def ordered(x):
        i = np.ascontiguousarray(x, dtype=np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def first_divergence(label: str, got: dict, ref: dict, epoch_axis: int) -> dict:
    """Where two runs' outputs first differ: per key, the first divergent
    epoch, the values that differ, the largest ulp and absolute gaps."""
    out = {}
    for key in ref:
        a, b = np.asarray(got[key]), np.asarray(ref[key])
        bad = a != b
        if not bad.any():
            out[key] = None
            continue
        per_epoch = np.moveaxis(bad, epoch_axis, 0).reshape(a.shape[epoch_axis], -1).any(1)
        out[key] = dict(first_epoch=int(np.argmax(per_epoch)), values=int(bad.sum()),
                        max_ulps=int(ulp_gap(a, b).max()),
                        max_abs=float(np.abs(a.astype(np.float64) - b).max()))
    print(f"{label}: {out}", flush=True)
    return out


def resilience_phase(torch, dev, W_np, S_np, quiet_miner, main_run, launches, report):
    """The resilience tier on the card (PERF.md §3's supervision layer), at
    256 x 4096 x 64:

    - `simulate` with `default_retry_policy()` + `default_deadline()` and no
      fault: fused_varying, no demotion, bitwise the unsupervised main run,
      one K3 launch; one injected fused fault is retried on the same rung
      (one K3 launch, `engine_retries` + 1); two demote once to
      fused_scan_mxu (no K3 launch, one K2, K4 once a tile), bitwise a
      direct `epoch_impl="fused_scan_mxu"` call;
    - a `StallFault` of 1 s past a 0.5 s deadline: one `EngineStall`, the
      retry's result bitwise, one K3 launch (the abandoned worker launches
      nothing);
    - `classify_failure` on a real `torch.cuda.OutOfMemoryError` (2^50
      bytes asked for);
    - a 4-lane quarantined batch (Yuma 2, lane 1's weights NaN from epoch 3)
      on the eager rung: no launch, the healthy lanes bitwise their solo
      runs, the report the CPU's (the same lanes' first 8 epochs);
    - the chart suite with `supervised=True` (14 cases x 9 versions, beta
      0.5): no demotion, bitwise the unsupervised suite, 9 K3 launches;
    - `SweepSupervisor(engine="fused_varying", quarantine=False)` over 16
      scenarios in 4 units with a checkpoint directory and one injected
      fault (one-attempt policy): unit 0 demoted to fused_scan_mxu, the
      bundle sound (`check_bundle`), and a resumed run reading every unit
      from disk with no launch;
    - the default `SweepSupervisor()` (the eager rung, quarantine on) and
      the fused one over 4 of those scenarios, timed: no launch, and one
      K3 launch;
    - K3 against K2 + K4 (the canary pair one rung apart) at 256 x 4096 and
      at the built-in [14, 40, 3, 2]: bitwise or the first divergence;
    - `simulate`'s epochs/s unsupervised and supervised, medians of
      SUPERVISION_PAIRS alternating pairs.

    No demotion happens outside the injected ones."""
    import shutil

    from yuma_simulation_tpu_torch.models.config import SimulationHyperparameters, YumaConfig
    from yuma_simulation_tpu_torch.models.variants import (
        canonical_versions,
        variant_for_version,
    )
    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from yuma_simulation_tpu_torch.resilience import (
        Deadline,
        EngineResourceExhausted,
        FaultPlan,
        RetryPolicy,
        StallFault,
        SweepSupervisor,
        build_quarantine_report,
        classify_failure,
        default_deadline,
        default_retry_policy,
        inject_faults,
    )
    from yuma_simulation_tpu_torch.scenarios import get_cases
    from yuma_simulation_tpu_torch.scenarios.base import Scenario
    from yuma_simulation_tpu_torch.simulation.engine import simulate
    from yuma_simulation_tpu_torch.simulation.sweep import simulate_batch, stack_scenarios
    from yuma_simulation_tpu_torch.telemetry.flight import check_bundle, load_bundle
    from yuma_simulation_tpu_torch.telemetry.metrics import get_registry
    from yuma_simulation_tpu_torch.v1.api import _simulate_suite

    rec: dict = {}
    registry = get_registry()

    def counter(name):
        return registry.counter(name).value

    def run(fn, **want):
        """`fn()` with the launch counts zeroed before and read after; every
        kernel's count must be `want`'s (0 when not named)."""
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = launch_counts()
        expect = {k: want.get(k, 0) for k in counts}
        assert counts == expect, (counts, expect)
        for k, n in counts.items():
            if n:
                launches[k] = launches.get(k, 0) + n
        return out

    def same_run(label, got, ref):
        for key in ("dividends", "bonds", "incentives"):
            _np_equal(f"{label} {key}", getattr(got, key), getattr(ref, key))

    scenario = Scenario(
        name="synthetic 256x4096", validators=[f"v{i}" for i in range(V)],
        base_validator="v0", weights=W_np, stakes=S_np, num_epochs=E,
        reset_bonds_index=quiet_miner, reset_bonds_epoch=E // 2,
    )
    version = "Yuma 1 (paper)"
    tiles = -(-E // 16)
    demotions0 = counter("engine_demotions")

    # -- the ladder and the watchdog through `simulate`
    sup = dict(retry_policy=default_retry_policy(), deadline=default_deadline())
    clean = run(lambda: simulate(scenario, version, **sup), varying_scan=1)
    assert clean.engine == "fused_varying" and clean.demotions is None, clean.engine
    same_run("supervised vs unsupervised simulate", clean, main_run)
    retries = counter("engine_retries")
    with inject_faults(FaultPlan(fused_oom_dispatches=1)):
        retried = run(lambda: simulate(scenario, version, **sup), varying_scan=1)
    assert retried.engine == "fused_varying" and retried.demotions is None
    assert counter("engine_retries") == retries + 1
    same_run("retried simulate", retried, main_run)
    with inject_faults(FaultPlan(fused_oom_dispatches=2)):
        demoted = run(lambda: simulate(scenario, version, **sup), case_scan=1,
                      support_mma=tiles)
    assert demoted.engine == "fused_scan_mxu", demoted.engine
    assert [(d.from_engine, d.to_engine) for d in demoted.demotions] == [
        ("fused_varying", "fused_scan_mxu")], demoted.demotions
    direct = run(lambda: simulate(scenario, version, epoch_impl="fused_scan_mxu"),
                 case_scan=1, support_mma=tiles)
    same_run("demoted vs direct fused_scan_mxu", demoted, direct)
    print(f"resilience: supervised simulate bitwise the unsupervised run (K3 x1); one fault "
          f"retried on fused_varying; two demoted it to fused_scan_mxu (K2 x1, K4 x{tiles}), "
          f"bitwise a direct call", flush=True)

    killed = counter("stalls_killed")
    stall_deadline = Deadline(budget_seconds=0.5, grace_seconds=60.0)
    t0 = time.perf_counter()
    with inject_faults(FaultPlan(stall=StallFault(seconds=1.0))) as state:
        stalled = run(lambda: simulate(scenario, version, retry_policy=default_retry_policy(),
                                       deadline=stall_deadline), varying_scan=1)
    stall_s = time.perf_counter() - t0
    reset_launch_counts()
    time.sleep(max(0.0, 1.2 - stall_s))  # the abandoned worker wakes, launches nothing
    torch.cuda.synchronize()
    assert sum(launch_counts().values()) == 0, launch_counts()
    assert state.stall_dispatches_fired == 1 and counter("stalls_killed") == killed + 1
    same_run("stalled then retried simulate", stalled, main_run)
    print(f"resilience: StallFault 1 s past a 0.5 s deadline: one EngineStall, the retry "
          f"bitwise ({stall_s:.3f} s in all)", flush=True)

    try:
        torch.empty(1 << 50, dtype=torch.uint8, device=dev)
        raise AssertionError("2^50 bytes were allocated")
    except torch.cuda.OutOfMemoryError as exc:
        typed = classify_failure(exc)
        assert isinstance(typed, EngineResourceExhausted), typed
        rec["oom_classified"] = type(typed).__name__
    print(f"resilience: a real torch.cuda.OutOfMemoryError classifies as "
          f"{rec['oom_classified']}", flush=True)

    # -- the quarantine on the eager rung
    qversion = "Yuma 2 (Adrian-Fish)"
    spec = variant_for_version(qversion)
    Wq = np.stack([W_np] * 4)
    Sq = np.stack([np.roll(S_np, k, axis=1) for k in range(4)])
    bad_miner = int(np.flatnonzero(W_np[3, 0])[0])
    Wq[1, 3:, 0, bad_miner] = np.nan
    ri = torch.full((4,), -1, dtype=torch.int32, device=dev)
    Wd, Sd = torch.tensor(Wq, device=dev), torch.tensor(Sq, device=dev)
    t0 = time.perf_counter()
    qys = run(lambda: simulate_batch(Wd, Sd, ri, ri, YumaConfig(), spec, quarantine=True))
    q_seconds = time.perf_counter() - t0
    report_q = build_quarantine_report(qys["quarantine"])
    assert [(e.case, e.epoch) for e in report_q.entries] == [(1, 3)], report_q
    for lane in (0, 2, 3):
        solo = run(lambda: simulate_batch(Wd[lane:lane + 1], Sd[lane:lane + 1], ri[:1], ri[:1],
                                          YumaConfig(), spec, epoch_impl="eager"))
        check_equal(f"quarantined batch lane {lane} vs solo", qys["dividends"][lane],
                    solo["dividends"][0])
    assert not qys["dividends"][1, 3:].any()
    cpu = simulate_batch(torch.tensor(Wq[:, :8]), torch.tensor(Sq[:, :8]), ri.cpu(), ri.cpu(),
                         YumaConfig(), spec, quarantine=True)
    for key in ("bad", "first_bad_epoch", "tensor_code"):
        check_equal(f"quarantine {key} vs the CPU's", qys["quarantine"][key].cpu(),
                    cpu["quarantine"][key])
    rec["quarantine"] = dict(lanes=4, epochs=E, seconds=q_seconds,
                             entries=[[e.case, e.epoch, e.tensor] for e in report_q.entries])
    print(f"resilience: quarantined batch [4, {E}, {V}, {M}] on the eager rung in "
          f"{q_seconds:.2f} s: {report_q.entries}; healthy lanes bitwise their solo runs, "
          f"the report the CPU's", flush=True)
    del Wd, Sd, qys, Wq

    # -- the chart suite, supervised
    cases, versions = get_cases(), canonical_versions()
    hp = SimulationHyperparameters(bond_penalty=0.5)
    plain_suite = run(lambda: _simulate_suite(cases, versions, hp), varying_scan=len(versions))
    super_suite = run(lambda: _simulate_suite(cases, versions, hp, supervised=True),
                      varying_scan=len(versions))
    for key, (_, (div, bonds, inc)) in super_suite.items():
        _, (p_div, p_bonds, p_inc) = plain_suite[key]
        assert div == p_div, key
        for a, b in ((bonds, p_bonds), (inc, p_inc)):
            _np_equal(f"supervised suite {key}", np.asarray(a), np.asarray(b))
    print("resilience: chart suite supervised=True bitwise the unsupervised suite "
          f"(14 cases x 9 versions, K3 x{len(versions)} each)", flush=True)

    # -- the canary pair one rung apart: K3 against K2 + K4
    Wc, Sc, ric, rec_ = stack_scenarios(cases)
    builtin = {}
    for v, params in versions:
        cfg = YumaConfig(simulation=hp, yuma_params=params)
        kw = dict(save_bonds=True, save_incentives=True, x64=True)
        k3 = run(lambda: simulate_batch(Wc, Sc, ric, rec_, cfg, variant_for_version(v),
                                        epoch_impl="fused_varying", **kw), varying_scan=1)
        k2 = run(lambda: simulate_batch(Wc, Sc, ric, rec_, cfg, variant_for_version(v),
                                        epoch_impl="fused_scan_mxu", **kw),
                 case_scan=1, support_mma=-(-40 // 16))
        builtin[v] = first_divergence(
            f"canary pair K3 vs K2+K4, built-in [14, 40, 3, 2], {v}",
            {k: k3[k].cpu().numpy() for k in ("dividends", "bonds", "incentives")},
            {k: k2[k].cpu().numpy() for k in ("dividends", "bonds", "incentives")}, 1)
    wide = first_divergence(
        f"canary pair K3 vs K2+K4, [{E}, {V}, {M}], {version}",
        {k: getattr(main_run, k) for k in ("dividends", "bonds", "incentives")},
        {k: getattr(direct, k) for k in ("dividends", "bonds", "incentives")}, 0)
    rec["canary_pair"] = {"builtin_14x40x3x2": builtin, f"{V}x{M}x{E}": wide}

    # -- the supervised sweep with its checkpoints and flight bundle
    directory = os.path.join(OUT_DIR, "supervised")
    shutil.rmtree(directory, ignore_errors=True)
    suite = [Scenario(name=f"s{k}", validators=scenario.validators, base_validator="v0",
                      weights=W_np, stakes=np.roll(S_np, k, axis=1), num_epochs=E,
                      reset_bonds_index=quiet_miner, reset_bonds_epoch=E // 2)
             for k in range(16)]

    def supervised_sweep():
        return SweepSupervisor(directory=directory, unit_size=4, quarantine=False,
                               engine="fused_varying",
                               retry_policy=RetryPolicy(max_attempts_per_rung=1),
                               deadline=default_deadline())

    t0 = time.perf_counter()
    with inject_faults(FaultPlan(fused_oom_dispatches=1)):
        swept = run(lambda: supervised_sweep().run_batch(suite, version), varying_scan=3,
                    case_scan=1, support_mma=tiles)
    sweep_s = time.perf_counter() - t0
    health = swept["report"]
    assert health.engine_demotions == 1 and health.units_total == 4, health
    assert health.engines_used == ("fused_scan_mxu", "fused_varying"), health
    _np_equal("supervised sweep lane 0 vs the demoted simulate", swept["dividends"][0],
              demoted.dividends)
    problems = check_bundle(load_bundle(directory))
    assert problems == [], problems
    resumed = run(lambda: supervised_sweep().run_batch(suite, version))
    assert resumed["report"].units_resumed == 4, resumed["report"]
    _np_equal("resumed sweep vs first", resumed["dividends"], swept["dividends"])
    rec["sweep"] = dict(scenarios=16, units=4, seconds=sweep_s,
                        scenario_epochs_per_s=16 * E / sweep_s,
                        report={k: v for k, v in health.__dict__.items() if k != "ledger_path"},
                        bundle=sorted(os.listdir(directory)))
    print(f"resilience: SweepSupervisor 16 x [{E}, {V}, {M}] in 4 units, one fault -> unit 0 "
          f"on fused_scan_mxu, bundle sound, {sweep_s:.2f} s; resumed from disk with no "
          f"launch", flush=True)

    # -- the default SweepSupervisor() (quarantine on the eager rung, no
    # kernel) against the fused sweep, on the same 4 scenarios, no fault
    few = suite[:4]
    t0 = time.perf_counter()
    default = run(lambda: SweepSupervisor().run_batch(few, version))
    default_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused = run(lambda: SweepSupervisor(quarantine=False, engine="fused_varying")
                .run_batch(few, version), varying_scan=1)
    fused_s = time.perf_counter() - t0
    for label, out, engine in (("default", default, "eager"), ("fused", fused, "fused_varying")):
        health = out["report"]
        assert health.engines_used == (engine,) and health.engine_demotions == 0, (label, health)
        assert not out["quarantine"].entries, label
        assert np.isfinite(np.asarray(out["dividends"])).all(), label
    gap = float(np.abs(np.asarray(default["dividends"], np.float64)
                       - np.asarray(fused["dividends"])).max())
    rec["default_sweep"] = dict(scenarios=4, units=1, eager_quarantined_s=default_s,
                                fused_varying_s=fused_s, max_abs_gap=gap)
    print(f"resilience: SweepSupervisor() defaults, 4 x [{E}, {V}, {M}] on the eager rung "
          f"with quarantine {default_s:.2f} s, no launch; fused_varying {fused_s:.2f} s (K3 x1); "
          f"dividends apart by at most {gap:.3g}", flush=True)

    # -- what the supervision costs: alternating pairs
    plain_s, super_s = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(SUPERVISION_PAIRS):
        for bucket, kw in ((plain_s, {}), (super_s, sup)):
            t0 = time.perf_counter()
            simulate(scenario, version, **kw)
            bucket.append(time.perf_counter() - t0)
    counts = launch_counts()
    assert counts["varying_scan"] == 2 * SUPERVISION_PAIRS and sum(counts.values()) == \
        2 * SUPERVISION_PAIRS, counts
    launches["varying_scan"] += counts["varying_scan"]
    rec["epochs_per_s"] = dict(
        pairs=SUPERVISION_PAIRS, unsupervised=E / float(np.median(plain_s)),
        supervised=E / float(np.median(super_s)),
        unsupervised_s=plain_s, supervised_s=super_s,
    )
    assert counter("engine_demotions") == demotions0 + 2, "a demotion nobody injected"
    report["resilience"] = rec
    print(f"resilience: simulate epochs/s unsupervised {rec['epochs_per_s']['unsupervised']:.1f}"
          f" / supervised {rec['epochs_per_s']['supervised']:.1f} (medians of "
          f"{SUPERVISION_PAIRS} alternating pairs)", flush=True)


#: The cache phase's build directory, made afresh each run.
CACHE_DIR = os.path.join(OUT_DIR, "cache")
#: Another toolkit's release line, for the stale entry the cache phase plants.
OTHER_NVCC = "Cuda compilation tools, release 11.8, V11.8.89"


def cache_child(mode: str) -> int:
    """One process of the cache phase (`chip_smoke.py --cache-child MODE`,
    its build directory in `$YUMA_TORCH_BUILD_DIR`): load every library
    through the cache under a `RecompilationSentinel` (budget 0 when `mode`
    is "warm", where starting `nvcc` to compile also fails the process;
    `nvcc --version` still gives the key's release line), run K3 once on
    a fixed input, and print the cache's counters, the compiles, the load
    seconds and a sha256 of K3's outputs as one JSON line."""
    import hashlib

    import torch

    from yuma_simulation_tpu_torch.ops import _build
    from yuma_simulation_tpu_torch.ops.cuda_epoch import fused_varying_scan
    from yuma_simulation_tpu_torch.ops.launches import launch_counts
    from yuma_simulation_tpu_torch.utils.profiling import RecompilationSentinel

    compiles = []
    compile_all = _build._compile_all

    def counted(jobs):
        if mode == "warm":
            raise AssertionError(f"the warm process started nvcc for {sorted(jobs)}")
        compiles.append(sorted(jobs))
        return compile_all(jobs)

    _build._compile_all = counted
    budget = {"cold": len(_build.SOURCES), "warm": 0, "rebuild": 1}[mode]
    t0 = time.perf_counter()
    with RecompilationSentinel(budget=budget, label=f"cache {mode}") as sentinel:
        for src in _build.SOURCES:
            _build.load(src)
    load_s = time.perf_counter() - t0
    W, S, _ = workload(seed=1, E=16, shape=(64, 1024))
    out = fused_varying_scan(torch.tensor(W, device="cuda"), torch.tensor(S, device="cuda"),
                             epoch_tile=16, save_bonds=False, save_incentives=False)
    digest = hashlib.sha256()
    for key in ("dividends_normalized", "final_bonds"):
        digest.update(out[key].cpu().numpy().tobytes())
    print(json.dumps(dict(
        stats=_build.active_cache().stats_payload(), compiles=compiles, load_s=load_s,
        aot_hits=sentinel.aot_hits, aot_builds=sentinel.aot_builds,
        k3_sha256=digest.hexdigest(), k3_launches=launch_counts()["varying_scan"],
    )))
    return 0


def cache_phase(report):
    """The kernel-library cache across processes, on a fresh build
    directory: a cold process builds every library (each miss "absent"); a
    warm one loads them all from disk and compiles nothing; after one
    library is truncated, a process finds it "corrupt", rebuilds it alone
    and runs K3 bitwise the warm process; after another library's metadata
    is moved under another environment's key, a process finds it "stale"
    and rebuilds it alone."""
    import glob
    import shutil

    from yuma_simulation_tpu_torch.ops import _build

    root = os.path.abspath(CACHE_DIR)
    shutil.rmtree(root, ignore_errors=True)
    here = os.path.dirname(os.path.abspath(__file__))
    n = len(_build.SOURCES)

    def child(mode):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cache-child", mode],
            capture_output=True, text=True, timeout=600, cwd=here,
            env={**os.environ, _build.EXECUTABLE_CACHE_ENV: root},
        )
        if proc.returncode:
            raise AssertionError(f"cache child {mode}: exit {proc.returncode}\n"
                                 f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        out["process_s"] = time.perf_counter() - t0
        stats = out["stats"]
        print(f"cache {mode}: {({k: stats[k] for k in ('hits', 'misses', 'stale', 'builds')})} "
              f"{stats['miss_reasons']}, load {out['load_s']:.2f} s, "
              f"process {out['process_s']:.1f} s", flush=True)
        assert stats["errors"] == 0 and out["k3_launches"] == 1, out
        return out

    def counts(out):
        s = out["stats"]
        return s["hits"], s["misses"], s["stale"], s["builds"], s["miss_reasons"]

    cold = child("cold")
    assert counts(cold) == (0, n, 0, n, {"absent": n}), cold
    assert cold["compiles"] == [sorted(_build.SOURCES)] and cold["aot_builds"] == n
    warm = child("warm")
    assert counts(warm) == (n, 0, 0, 0, {}) and warm["compiles"] == [], warm
    assert (warm["aot_hits"], warm["aot_builds"]) == (n, 0)
    assert warm["k3_sha256"] == cold["k3_sha256"]
    key = warm["stats"]["env_key"]

    def entry(stem):
        (found,) = glob.glob(os.path.join(root, f"{stem}-*"))
        return found

    meta_path = os.path.join(entry("case_scan"), f"{key}.json")
    with open(meta_path) as f:
        blob = os.path.join(entry("case_scan"), json.load(f)["blob"])
    with open(blob, "r+b") as f:
        f.truncate(os.path.getsize(blob) // 2)
    corrupt = child("rebuild")
    assert counts(corrupt) == (n - 1, 1, 0, 1, {"corrupt": 1}), corrupt
    assert corrupt["compiles"] == [["case_scan.cu"]]
    assert corrupt["k3_sha256"] == warm["k3_sha256"], "K3 after the rebuild"

    meta_path = os.path.join(entry("ema_scan"), f"{key}.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["environment"] = dict(meta["environment"], nvcc=OTHER_NVCC)
    with open(os.path.join(entry("ema_scan"), f"{_build.environment_key(meta['environment'])}.json"),
              "w") as f:
        json.dump(meta, f)
    os.remove(meta_path)
    stale = child("rebuild")
    assert counts(stale) == (n - 1, 0, 1, 1, {}), stale
    assert stale["compiles"] == [["ema_scan.cu"]]
    report["cache"] = dict(
        environment=warm["stats"]["environment"], env_key=key,
        **{mode: dict(hits=out["stats"]["hits"], misses=out["stats"]["misses"],
                      stale=out["stats"]["stale"], builds=out["stats"]["builds"],
                      miss_reasons=out["stats"]["miss_reasons"], load_s=out["load_s"],
                      process_s=out["process_s"])
           for mode, out in (("cold", cold), ("warm", warm), ("corrupt", corrupt),
                             ("stale", stale))},
        k3_bitwise_after_rebuild=True,
    )


def cost_phase(report, scans):
    """The cost records of every rung at the main path's 256 x 4096 x 64:
    the same work for each; K3's roofline against the card's spec is the
    bound of the kernel line (0.0814 ms, by bytes), and with K3's event
    time and `simulate`'s epochs/s gives the attained fractions."""
    import dataclasses

    from yuma_simulation_tpu_torch.telemetry.cost import (
        capture_engine_costs,
        resolve_device_spec,
        roofline,
    )

    t0 = time.perf_counter()
    records = capture_engine_costs(V, M, E)
    assert len({(r.flops, r.bytes_accessed) for r in records.values()}) == 1, records
    spec = resolve_device_spec(device="cuda")
    k3 = scans["varying_scan"]
    roof = roofline(records["fused_varying"], spec, measured_epochs_per_sec=E / (k3["ms"] / 1e3))
    assert roof.bound == "memory" and k3["bound_by"] == "bytes", (roof, k3)
    assert abs(roof.predicted_seconds * 1e3 - k3["bound_ms"]) <= 1e-12 * k3["bound_ms"], (roof, k3)
    assert round(k3["bound_ms"], 4) == 0.0814, k3["bound_ms"]
    end_to_end = roofline(records["fused_varying"], spec,
                          measured_epochs_per_sec=report["main_path"]["epochs_per_s"])
    report["cost"] = dict(
        spec=dataclasses.asdict(spec),
        records={name: r.to_json() for name, r in records.items()},
        k3=roof.to_json(), simulate=end_to_end.to_json(),
        seconds=time.perf_counter() - t0,
    )
    print(f"cost: K3 attains {roof.attained_fraction:.4f} of its roofline "
          f"({roof.predicted_epochs_per_sec:.1f} epochs/s); simulate "
          f"{end_to_end.attained_fraction:.6f}", flush=True)


def foundry_phase(torch, dev, launches, report):
    """The scenario foundry on the card. A synthetic real-subnet snapshot
    (256 x 4096, seed 0) tiled over 40 epochs through `simulate`: one K3
    launch, within ATOL / RTOL of the same call on K3's plain version. The
    snapshots of seeds 0-7 through `run_montecarlo(route="batch")`: one K3
    launch over [8, 40, 256, 4096], each lane bitwise its solo `simulate`;
    two of them through the supervised route, on the eager rung, within
    ATOL / RTOL of their K3 lanes.
    The 8-scenario drill population (mixed shapes, so donor-packed with
    miner masks) through the batch and supervised routes, both on the eager
    rung (no launch) and bitwise each other; its same-shaped lanes through
    the batch route on K3 (one launch), each bitwise its solo `simulate`,
    and through the supervised route on the eager rung (its quarantine
    default), each bitwise its solo eager run, the two rungs within ATOL.
    Then the drill itself, `python -m yuma_simulation_tpu_torch.foundry
    --drill`, on the card in a fresh bundle directory."""
    import shutil

    from yuma_simulation_tpu_torch.foundry import (
        run_montecarlo,
        scenario_from_snapshot,
        synthetic_snapshot,
    )
    from yuma_simulation_tpu_torch.foundry.__main__ import build_drill_suite
    from yuma_simulation_tpu_torch.ops.cuda_epoch import fused_varying_scan_plain
    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from yuma_simulation_tpu_torch.simulation import engine
    from yuma_simulation_tpu_torch.telemetry import check_bundle, load_bundle

    version = "Yuma 1 (paper)"
    out, seconds = {}, {}

    def step(name, fn):
        reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return result, launch_counts()

    snaps, seconds["snapshots"] = [], 0.0
    for seed in range(8):
        t0 = time.perf_counter()
        snaps.append(scenario_from_snapshot(synthetic_snapshot(seed), num_epochs=40))
        seconds["snapshots"] += time.perf_counter() - t0
    solo, counts = step("simulate", lambda: engine.simulate(snaps[0], version))
    assert solo.engine == "fused_varying" and counts["varying_scan"] == 1, (solo.engine, counts)
    assert solo.dividends.shape == (40, V) and np.isfinite(solo.dividends).all()
    launches["varying_scan"] += counts["varying_scan"]
    kernel = engine.fused_varying_scan
    engine.fused_varying_scan = fused_varying_scan_plain
    try:
        plain, counts = step("simulate_plain", lambda: engine.simulate(snaps[0], version))
    finally:
        engine.fused_varying_scan = kernel
    assert sum(counts.values()) == 0, counts
    np.testing.assert_allclose(solo.dividends, plain.dividends, atol=ATOL, rtol=RTOL)
    out["snapshot_vs_plain_max_abs"] = float(np.abs(solo.dividends - plain.dividends).max())

    batch, counts = step("batch_8_snapshots", lambda: run_montecarlo(snaps, version))
    assert counts["varying_scan"] == 1 and sum(counts.values()) == 1, counts
    assert batch["dividends"].shape == (8, 40, V)
    launches["varying_scan"] += 1
    solos, counts = step("solo_8_snapshots",
                         lambda: [engine.simulate(s, version).dividends for s in snaps])
    assert counts["varying_scan"] == 8, counts
    launches["varying_scan"] += 8
    for i, d in enumerate(solos):
        np.testing.assert_array_equal(batch["dividends"][i], d, err_msg=f"snapshot lane {i}")
    out["batch_weights_bytes"] = 8 * 40 * V * M * 4
    sup, counts = step("supervised_2_snapshots",
                       lambda: run_montecarlo(snaps[:2], version, route="supervised"))
    assert sum(counts.values()) == 0 and sup["report"].engines_used == ("eager",), counts
    np.testing.assert_allclose(sup["dividends"], batch["dividends"][:2], atol=ATOL, rtol=RTOL)
    out["snapshot_k3_vs_eager_max_abs"] = float(
        np.abs(sup["dividends"] - batch["dividends"][:2]).max())
    del snaps, solos, batch, sup

    suite = build_drill_suite(0, 8)
    packed, counts = step("drill_batch", lambda: run_montecarlo(suite, version))
    assert sum(counts.values()) == 0, counts
    sup, counts = step("drill_supervised",
                       lambda: run_montecarlo(suite, version, route="supervised", pack=True))
    assert sum(counts.values()) == 0 and sup["report"].engines_used == ("eager",), counts
    np.testing.assert_array_equal(sup["dividends"], packed["dividends"])
    same = [s for s in suite if s.weights.shape == suite[0].weights.shape]
    k3, counts = step("drill_same_shape_batch", lambda: run_montecarlo(same, version))
    assert counts["varying_scan"] == 1 and sum(counts.values()) == 1, counts
    launches["varying_scan"] += 1
    eager, counts = step("drill_same_shape_supervised",
                         lambda: run_montecarlo(same, version, route="supervised"))
    assert sum(counts.values()) == 0 and eager["report"].engines_used == ("eager",), counts
    solo_k3, counts = step("drill_solo_k3",
                           lambda: [engine.simulate(s, version).dividends for s in same])
    assert counts["varying_scan"] == len(same) and sum(counts.values()) == len(same), counts
    launches["varying_scan"] += len(same)
    solo_eager, counts = step("drill_solo_eager", lambda: [
        engine.simulate(s, version, epoch_impl="eager").dividends for s in same])
    assert sum(counts.values()) == 0, counts
    for i in range(len(same)):
        np.testing.assert_array_equal(k3["dividends"][i], solo_k3[i],
                                      err_msg=f"drill lane {i} on K3")
        np.testing.assert_array_equal(eager["dividends"][i], solo_eager[i],
                                      err_msg=f"drill lane {i} on the eager rung")
    np.testing.assert_allclose(k3["dividends"], eager["dividends"], atol=ATOL, rtol=0)
    out["routes"] = dict(
        drill_batch="eager (donor-packed: miner masks)", drill_supervised="eager",
        drill_same_shape_batch="fused_varying (K3)", drill_same_shape_supervised="eager",
        same_shape_lanes=len(same), shape=list(same[0].weights.shape),
        k3_vs_eager_max_abs=float(np.abs(k3["dividends"] - eager["dividends"]).max()),
    )

    bundle = os.path.abspath(os.path.join(OUT_DIR, "foundry_drill"))
    shutil.rmtree(bundle, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "yuma_simulation_tpu_torch.foundry", "--drill",
         "--bundle-dir", bundle],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    seconds["drill_process"] = time.perf_counter() - t0
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    assert check_bundle(load_bundle(bundle)) == []
    out["drill"] = proc.stdout.strip().splitlines()[-1]
    out["seconds"] = seconds
    report["foundry"] = out
    print(f"foundry: {json.dumps(out)}", flush=True)


def mesh_phase(torch, dev, launches, report):
    """Miner-axis sharding on the card (no kernel: the sharded rung is the
    eager one, and every launch count must stay 0 through its runs).
    `synthetic_snapshot(0)` at 256 x 4096 over 16 epochs through
    `simulate(mesh=)` on a [1, 4] and a [1, 2] mesh of `MeshDevice(i,
    dev)` (every shard on the one card), for Yuma 1, Yuma 1 with liquid
    alpha (the quantile over the gathered consensus, on the snapshot with
    512 weights a row, where the fit is not degenerate) and Yuma 3.1 (a
    reset at epoch 8): each run bitwise
    `simulate(epoch_impl="eager")` unsharded on the card, on every saved
    stream; the Yuma 1 run also within ATOL / RTOL of K3's `simulate` (one
    launch, counted). `shard_epoch_over_miners` on the [1, 4] mesh for the
    EMA, capacity and relative bond models, every key bitwise `yuma_epoch`.
    `simulate_constant(mesh=)` both ways, bitwise unsharded. The constant
    path's preflight refusing, with nothing allocated, a shape whose one
    shard fits the card but whose four shards on the one card do not."""
    import dataclasses

    from yuma_simulation_tpu_torch.foundry import scenario_from_snapshot, synthetic_snapshot
    from yuma_simulation_tpu_torch.models.config import YumaConfig, YumaParams
    from yuma_simulation_tpu_torch.models.epoch import BondsMode, yuma_epoch
    from yuma_simulation_tpu_torch.models.miner_shards import MinerSharded
    from yuma_simulation_tpu_torch.models.variants import variant_for_version
    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from yuma_simulation_tpu_torch.parallel import MeshDevice, make_mesh, shard_epoch_over_miners
    from yuma_simulation_tpu_torch.simulation.engine import simulate, simulate_constant
    from yuma_simulation_tpu_torch.telemetry.cost import (
        DEFAULT_MEMORY_FRACTION,
        WORKING_SET_VM_BUFFERS,
        HBMPreflightError,
        estimate_hbm_bytes,
        resolve_device_spec,
    )

    def mesh_of(n):
        return make_mesh(data=1, model=n, devices=[MeshDevice(i, dev) for i in range(n)])

    meshes = {"1x4": mesh_of(4), "1x2": mesh_of(2)}
    base = scenario_from_snapshot(synthetic_snapshot(0), num_epochs=16)
    reset = dataclasses.replace(base, reset_bonds_index=7, reset_bonds_epoch=8)
    # Liquid alpha's fit is degenerate (NaN rates) where the consensus
    # quantiles all sit on the lowest grid step, as at 48 weights a row:
    # its run takes 512 a row, where the 0.99 quantile is the fit's high.
    dense = scenario_from_snapshot(synthetic_snapshot(0, nnz_per_row=512), num_epochs=16)
    runs = [
        ("Yuma 1 (paper)", YumaConfig(), base),
        ("Yuma 1 (paper) - liquid alpha on",
         YumaConfig(yuma_params=YumaParams(liquid_alpha=True)), dense),
        ("Yuma 3.1 (Rhef+reset)", YumaConfig(), reset),
    ]
    out, seconds = {}, {}

    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        return result

    reset_launch_counts()
    for version, cfg, scen in runs:
        kw = dict(save_bonds=True, save_incentives=True, save_consensus=True)
        ref = timed(f"{version} unsharded eager",
                    lambda: simulate(scen, version, cfg, epoch_impl="eager", **kw))
        assert ref.engine == "eager" and np.isfinite(ref.dividends).all(), version
        for name, mesh in meshes.items():
            got = timed(f"{version} sharded {name}", lambda: simulate(scen, version, cfg,
                                                                        mesh=mesh, **kw))
            assert got.engine == "eager", got.engine
            for stream in ("dividends", "bonds", "incentives", "consensus"):
                _np_equal(f"mesh {name} {version} {stream}", getattr(got, stream),
                          getattr(ref, stream))
        if version == "Yuma 1 (paper)":
            eager_ref = ref
    assert sum(launch_counts().values()) == 0, launch_counts()

    rng = np.random.default_rng(3)
    W = torch.tensor(base.weights[0], dtype=torch.float32, device=dev)
    S = torch.tensor(base.stakes[0], dtype=torch.float32, device=dev)
    for mode in (BondsMode.EMA, BondsMode.CAPACITY, BondsMode.RELATIVE):
        scale = 1e18 if mode is BondsMode.CAPACITY else 0.5
        B = torch.tensor(rng.random((V, M)) * scale, dtype=torch.float32, device=dev)
        got = timed(f"shard_epoch_over_miners {mode.value}",
                    lambda: shard_epoch_over_miners(W, S, B, YumaConfig(), mesh=meshes["1x4"],
                                                    bonds_mode=mode))
        ref = yuma_epoch(W, S, B, YumaConfig(), bonds_mode=mode)
        assert set(got) == set(ref), (sorted(got), sorted(ref))
        for key, value in ref.items():
            g = got[key].numpy() if isinstance(got[key], MinerSharded) else got[key].cpu().numpy()
            _np_equal(f"shard_epoch_over_miners {mode.value} {key}", g, value.cpu().numpy())
    spec = variant_for_version("Yuma 1 (paper)")
    for hoist in (False, True):
        want = timed(f"simulate_constant hoist={hoist} unsharded",
                     lambda: simulate_constant(W, S, 16, YumaConfig(), spec,
                                               hoist_invariant=hoist))
        got = timed(f"simulate_constant hoist={hoist} sharded 1x4",
                    lambda: simulate_constant(W, S, 16, YumaConfig(), spec,
                                              hoist_invariant=hoist, mesh=meshes["1x4"]))
        for a, b, part in zip(got, want, ("total", "bonds")):
            check_equal(f"simulate_constant hoist={hoist} {part}", a, b)
    assert sum(launch_counts().values()) == 0, launch_counts()

    # K3 on the same Yuma 1 run: one launch, counted, within the engines'
    # reduction-order class of the sharded (= unsharded eager) run.
    k3 = timed("Yuma 1 (paper) K3", lambda: simulate(base, "Yuma 1 (paper)", save_bonds=True))
    counts = launch_counts()
    assert k3.engine == "fused_varying" and counts["varying_scan"] == 1, (k3.engine, counts)
    launches["varying_scan"] += 1
    np.testing.assert_allclose(eager_ref.dividends, k3.dividends, atol=ATOL, rtol=RTOL)
    out["k3_vs_sharded_max_abs"] = float(np.abs(eager_ref.dividends - k3.dividends).max())

    # The preflight per physical device: one shard's working set fits the
    # card, four shards on the one card do not; nothing is allocated.
    spec_card = resolve_device_spec(device=dev)
    budget = int(spec_card.memory_bytes * DEFAULT_MEMORY_FRACTION)
    Vp = 1024
    Mp = -(-2 * budget // (WORKING_SET_VM_BUFFERS * Vp * 4))
    Mp += (-Mp) % (8 * 64)
    shard = estimate_hbm_bytes(Vp, Mp, resident_epochs=0, miner_shards=4).total_bytes
    assert shard <= budget < 4 * shard, (shard, budget)
    big = torch.zeros(1, 1, device=dev).expand(Vp, Mp)  # a view: nothing of [V, M]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    try:
        simulate_constant(big, torch.ones(Vp, device=dev), 1, mesh=meshes["1x4"])
    except HBMPreflightError as e:
        message = str(e)
    else:
        raise AssertionError("the preflight let four shards on one card past its memory")
    assert torch.cuda.memory_allocated(dev) == before
    out["preflight"] = dict(shape=[Vp, Mp], shard_bytes=shard, budget_bytes=budget,
                            message=message)
    out["seconds"] = seconds
    report["mesh"] = out
    print(f"mesh: {json.dumps(out)}", flush=True)


def fleet_phase(torch, dev, launches, report):
    """The fleet fabric on the card, at full width. The snapshots of seeds
    0-7 as [8, 40, 256, 4096] through `run_fleet_batch` in this process with
    units of two lanes and a supervisor that runs K3 (`quarantine=False`,
    `engine="fused_varying"`): 4 K3 launches, each lane bitwise its solo
    `simulate` and `run_montecarlo(route="batch")`'s lane; a second call on
    the same store launches nothing; `run_montecarlo(route="fleet")` over
    the same suite gives the same bytes; the same call under the
    supervisor's quarantine default lands on the eager rung, within ATOL of
    K3. `run_drill` with its four host processes on the card (every healthy
    lane bitwise the oracle, `check_fleet` clean, no unit lost or published
    twice). Two concurrent `total_dividends_sheet_generator --fleet-store`
    processes: each sheet built once across them, every CSV byte-identical
    to the plain CLI's (cli_phase's). One ops-plane `ProfileSession` trace
    window over a fleet unit, opened after uncounted K1 calls, whose trace
    holds K3's phase kernels. The launches of child processes are not
    counted."""
    import shutil

    from yuma_simulation_tpu_torch.fabric import (
        FleetConfig,
        FleetStore,
        check_fleet,
        merged_ledger,
        run_fleet_batch,
    )
    from yuma_simulation_tpu_torch.fabric.simhost import run_drill
    from yuma_simulation_tpu_torch.foundry import (
        run_montecarlo,
        scenario_from_snapshot,
        synthetic_snapshot,
    )
    from yuma_simulation_tpu_torch.ops.cuda_consensus import stake_weighted_median_cuda
    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from yuma_simulation_tpu_torch.resilience import SweepSupervisor
    from yuma_simulation_tpu_torch.simulation.engine import simulate
    from yuma_simulation_tpu_torch.telemetry.ops import ProfileSession

    version = "Yuma 1 (paper)"
    root = os.path.abspath(os.path.join(OUT_DIR, "fleet"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out, seconds = {}, {}

    def step(name, fn):
        reset_launch_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return result, launch_counts()

    def k3_supervisor():
        return SweepSupervisor(directory=None, quarantine=False, engine="fused_varying")

    snaps = [scenario_from_snapshot(synthetic_snapshot(seed), num_epochs=40) for seed in range(8)]
    fleet, counts = step("fleet_batch", lambda: run_fleet_batch(
        snaps, version, FleetConfig(directory=os.path.join(root, "batch"), unit_size=2),
        supervisor=k3_supervisor()))
    assert counts["varying_scan"] == 4 and sum(counts.values()) == 4, counts
    launches["varying_scan"] += 4
    assert fleet["dividends"].shape == (8, 40, V) and fleet["report"].clean
    assert fleet["report"].units_published == 4
    assert check_fleet(os.path.join(root, "batch")) == []
    again, counts = step("fleet_batch_again", lambda: run_fleet_batch(
        snaps, version, FleetConfig(directory=os.path.join(root, "batch"), unit_size=2,
                                    host_id="late-joiner"),
        supervisor=k3_supervisor()))
    assert sum(counts.values()) == 0 and again["host"].units_published == 0, counts
    np.testing.assert_array_equal(again["dividends"], fleet["dividends"])
    batch, counts = step("batch_route", lambda: run_montecarlo(snaps, version))
    assert counts["varying_scan"] == 1, counts
    launches["varying_scan"] += 1
    solos, counts = step("solo_8", lambda: [simulate(s, version).dividends for s in snaps])
    assert counts["varying_scan"] == 8, counts
    launches["varying_scan"] += 8
    for i in range(8):
        _np_equal(f"fleet lane {i} vs solo", fleet["dividends"][i], solos[i])
        _np_equal(f"fleet lane {i} vs batch route", fleet["dividends"][i],
                  batch["dividends"][i])
    routed, counts = step("fleet_route", lambda: run_montecarlo(
        snaps, version, route="fleet",
        fleet=FleetConfig(directory=os.path.join(root, "route"), unit_size=2),
        supervisor=k3_supervisor()))
    assert counts["varying_scan"] == 4, counts
    launches["varying_scan"] += 4
    _np_equal("fleet route vs run_fleet_batch", routed["dividends"], fleet["dividends"])
    quarantined, counts = step("fleet_route_quarantine_default", lambda: run_montecarlo(
        snaps, version, route="fleet",
        fleet=FleetConfig(directory=os.path.join(root, "eager"), unit_size=2)))
    assert sum(counts.values()) == 0, counts
    engines = {engine for _, engine in quarantined["report"].unit_engines}
    assert engines == {"eager"}, quarantined["report"].unit_engines
    np.testing.assert_allclose(quarantined["dividends"], fleet["dividends"], atol=ATOL, rtol=0)
    out["k3_vs_eager_max_abs"] = float(np.abs(quarantined["dividends"]
                                              - fleet["dividends"]).max())
    del solos, batch, routed, quarantined, again

    # One ops-plane trace window over a fleet unit.
    session = ProfileSession(os.path.join(root, "ops"))
    W1 = torch.tensor(snaps[0].weights[0], dtype=torch.float32, device=dev)
    S1 = torch.tensor(snaps[0].stakes[0], dtype=torch.float32, device=dev)
    S1 = S1 / S1.sum()
    started = session.start(120.0)
    try:
        for _ in range(WINDOW_WARMUP):  # uncounted: absorb the window's dropped records
            stake_weighted_median_cuda(W1, S1, 0.5)
        torch.cuda.synchronize()
        unit, counts = step("profiled_fleet_unit", lambda: run_fleet_batch(
            snaps[:2], version, FleetConfig(directory=os.path.join(root, "profiled"),
                                            unit_size=2),
            supervisor=k3_supervisor()))
    finally:
        published = session.stop()
    assert counts["varying_scan"] == 1, counts
    launches["varying_scan"] += 1
    _np_equal("profiled fleet unit", unit["dividends"], fleet["dividends"][:2])
    with open(os.path.join(published["artifact"], "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    import re

    names = collections.Counter(
        found.group(0) for found in (
            re.search(r"\bk_[a-z_]+", ev.get("name", ""))
            for ev in events if ev.get("cat") == "kernel")
        if found
    )
    for kernel in ("k_rank", "k_bond", "k_incentive"):
        assert any(kernel in n for n in names), (kernel, dict(names))
    out["profile_window"] = dict(artifact=os.path.relpath(published["artifact"]),
                                 kernels=dict(names), started=started["mode"])

    # The drill: four host processes on the card.
    t0 = time.perf_counter()
    drill = run_drill(os.path.join(root, "drill"), device="cuda", timeout=400.0)
    seconds["drill"] = time.perf_counter() - t0
    rep = drill["report"]
    out["drill"] = dict(
        units=rep.num_units, published=rep.units_published, stolen=rep.units_stolen,
        hosts_lost=list(rep.hosts_lost), stalls_killed=rep.stalls_killed,
        lanes_quarantined=rep.lanes_quarantined, rcs=drill["rcs"],
    )

    # Two concurrent CLI processes on one store.
    store = os.path.join(root, "sheets_store")
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(p for p in [here, env.get("PYTHONPATH", "")] if p)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "yuma_simulation_tpu_torch.cli.total_dividends_sheet_generator",
         "--fleet-store", store, "--out-dir", os.path.join(root, f"sheets{i}")],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for i in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    seconds["cli_pair"] = time.perf_counter() - t0
    built = []
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0, stderr[-3000:]
        built.append(stdout.count("Generating total dividends sheet"))
    assert sum(built) == 4, built
    ok = [r for r in merged_ledger(FleetStore(store)) if r.get("event") == "unit_ok"]
    assert len(ok) == 4 and check_fleet(store) == [], ok
    for i in range(2):
        for beta in ("0", "0.5", "0.99", "1.0"):
            name = f"total_dividends_b{beta}.csv"
            with open(os.path.join(root, f"sheets{i}", name), "rb") as f:
                mine = f.read()
            with open(os.path.join(OUT_DIR, "sheets", name), "rb") as f:
                plain = f.read()
            assert mine == plain, (i, beta)
    out["cli_pair"] = dict(sheets_built_per_process=built)
    out["units_stolen"] = {"drill": rep.units_stolen}
    out["seconds"] = seconds
    report["fleet"] = out
    print(f"fleet: {json.dumps(out)}", flush=True)


class _LaunchThreads:
    """Record the thread of every K2 / K3 / K5 / K6 launch (a wrapper
    around `ops.cuda_epoch._scan_cuda`), so a phase can show which of its
    threads touched the card."""

    def __init__(self):
        self.names: list = []

    def __enter__(self):
        import threading

        from yuma_simulation_tpu_torch.ops import cuda_epoch

        self._module, self._orig = cuda_epoch, cuda_epoch._scan_cuda

        def recorded(*args, **kwargs):
            self.names.append(threading.current_thread().name)
            return self._orig(*args, **kwargs)

        cuda_epoch._scan_cuda = recorded
        return self

    def __exit__(self, *exc):
        self._module._scan_cuda = self._orig


#: The threads of the serving tier that may launch work: its dispatcher and
#: the watchdog workers it starts, and the co-hosted replay controller's
#: thread (`serve/__main__.py::CONTROLLER_THREAD`, which sets the service's
#: device before its first launch); the HTTP handler threads never do.
def _serving_thread(name: str) -> bool:
    return (name in ("yuma-serve-dispatcher", "replay-controller")
            or name.startswith("yuma-watchdog"))


def _scan_launches(counts: dict) -> int:
    """The launches among `counts` that go through `cuda_epoch._scan_cuda`
    (K2, K3, K5, K6): what `_LaunchThreads` records one name for each."""
    return sum(counts[k] for k in ("case_scan", "varying_scan", "ema_scan", "ema_epoch"))


def _server_timing(headers: dict) -> dict:
    """The `Server-Timing` phases of one reply, in ms by name."""
    phases = {}
    for part in headers.get("Server-Timing", "").split(","):
        name, _, dur = part.strip().partition(";dur=")
        if dur:
            phases[name] = float(dur)
    return phases


def _queued_dispatch(svc, payloads) -> dict:
    """Queue the simulate `payloads` (one tenant thread each) on a service
    whose dispatcher has not started, then start it and wait for every
    reply: the replies, the wall seconds from the start to the last reply,
    the launch counts of the dispatch, the threads that launched, and each
    reply's `Server-Timing` phases (ms)."""
    import threading

    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts

    replies = [None] * len(payloads)

    def tenant(i):
        replies[i] = svc.handle("simulate", dict(payloads[i], tenant=f"tenant-{i}"))

    threads = [threading.Thread(target=tenant, args=(i,), name=f"tenant-{i}")
               for i in range(len(payloads))]
    for th in threads:
        th.start()
    for _ in range(3000):
        if len(svc.queue) == len(payloads):
            break
        time.sleep(0.01)
    assert len(svc.queue) == len(payloads), len(svc.queue)
    reset_launch_counts()
    with _LaunchThreads() as where:
        t0 = time.perf_counter()
        svc.start_dispatcher()
        for th in threads:
            th.join(timeout=300)
        seconds = time.perf_counter() - t0
    counts = launch_counts()
    assert len(where.names) == _scan_launches(counts), (where.names, counts)
    assert all(_serving_thread(n) for n in where.names), where.names
    phases = {}
    for status, body, headers in replies:
        assert status == 200 and body["status"] == "ok", body
        for name, ms in _server_timing(headers).items():
            phases.setdefault(name, []).append(ms)
    return dict(replies=replies, seconds=seconds, launches=counts,
                threads=sorted(set(where.names)), phases_ms=phases)


def _bundle_gate(path) -> dict:
    """The port's own gates of a flight bundle, as `tools.obsreport
    --check` and `tools.sloreport --check --require` apply them (those
    tools import the JAX package, which the card's machine lacks): the
    bundle is sound, it recorded SLO state, and no SLO was fast-burning."""
    from yuma_simulation_tpu_torch.telemetry.flight import check_bundle, load_bundle

    bundle = load_bundle(path)
    problems = check_bundle(bundle)
    assert problems == [], (str(path), problems)
    assert bundle.slo is not None and isinstance(bundle.slo.get("states"), dict), str(path)
    burning = [n for n, st in bundle.slo["states"].items()
               if (st.get("state") if isinstance(st, dict) else st) == "fast_burn"]
    assert burning == [], (str(path), burning)
    return dict(spans=len(bundle.spans), ledger=len(bundle.ledger),
                slo_states=len(bundle.slo["states"]))


def serve_phase(torch, dev, launches, report):
    """The serving tier on the card. In process, at full width: a
    `SimulationService(ServeConfig(device="cuda", warmup_shapes=((40, 256,
    4096),)))` (its warmup runs the eager rung packed and one K3 launch);
    four tenants on four threads `handle()` `quarantine: false` requests of
    the seed 0-3 snapshots over 40 epochs, queued before the dispatcher
    starts: ONE K3 launch, on the dispatcher's side, each lane bitwise its
    solo `simulate`; where that dispatch's time goes (`Server-Timing`, the
    host stack and upload), against the same requests with no gathering
    window and one at a time, and eight small-subnet requests all three
    ways, each lane bitwise; a default request over 16 epochs on the eager
    rung (no launch) within ATOL of K3; a `fused_scan_mxu` request
    launching K2 with K4, bitwise the solo K2 run. Every launch count is
    read after the call it counts. Over HTTP (`SimulationServer` on
    127.0.0.1:0, `SimulationClient`): Case 3, a table request (K3, its
    Yuma 1 totals within 1.5e-6 of the golden), a typed admission
    rejection, a quota shed with 429 and Retry-After, a coalesced pair, the
    metrics and health surface and one canary tick (K3 against the next
    kernel rung, drift-clean). Both bundles pass the port's gates."""
    import shutil
    import threading

    from yuma_simulation_tpu_torch.foundry import scenario_from_snapshot, synthetic_snapshot
    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from yuma_simulation_tpu_torch.scenarios.base import Scenario
    from yuma_simulation_tpu_torch.serve import (
        ServeConfig,
        SimulationClient,
        SimulationServer,
        SimulationService,
        wait_until_ready,
    )
    from yuma_simulation_tpu_torch.simulation.engine import simulate
    from yuma_simulation_tpu_torch.simulation.sweep import stack_scenarios

    version = "Yuma 1 (paper)"
    root = os.path.abspath(os.path.join(OUT_DIR, "serve"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out, seconds = {}, {}

    t0 = time.perf_counter()
    svc = SimulationService(ServeConfig(
        device="cuda", warmup_shapes=((40, V, M),), coalesce_window_seconds=0.05,
        max_batch=8, queue_limit=16, start_dispatcher=False,
        bundle_dir=os.path.join(root, "inproc"),
    ))
    torch.cuda.synchronize()
    seconds["service_with_warmup"] = time.perf_counter() - t0
    snaps = [scenario_from_snapshot(synthetic_snapshot(seed), num_epochs=40) for seed in range(4)]
    full = [{"weights": s.weights, "stakes": s.stakes, "quarantine": False} for s in snaps]

    try:
        run = _queued_dispatch(svc, full)
        counts = run["launches"]
        assert counts["varying_scan"] == 1 and sum(counts.values()) == 1, counts
        launches["varying_scan"] += counts["varying_scan"]
        seconds["coalesced_4x40"] = run["seconds"]
        out["coalesced"] = {k: run[k] for k in ("launches", "threads", "phases_ms")}
        reset_launch_counts()
        t0 = time.perf_counter()
        solos = [simulate(s, version) for s in snaps]
        seconds["solo_4x40"] = time.perf_counter() - t0
        counts = launch_counts()
        assert counts["varying_scan"] == 4 and sum(counts.values()) == 4, counts
        launches["varying_scan"] += counts["varying_scan"]
        for i, solo in enumerate(solos):
            _status, body, _ = run["replies"][i]
            assert body["coalesced"] == 4 and body["engine"] == "fused_varying", body["engine"]
            assert solo.engine == "fused_varying"
            _np_equal(f"served lane {i} vs solo K3", np.asarray(body["dividends"], np.float32),
                      solo.dividends)
        coalesced_replies = run["replies"]
        del run

        # Where a coalesced dispatch's time goes: the host stack and upload
        # of its lanes (1 and 4), against the same requests coalesced with
        # no gathering window (the queue holds them all already) and
        # dispatched one at a time (max_batch 1: no window, no stack), and
        # a mix of eight small-subnet requests (64 x 1024) all three ways.
        for lanes in (1, 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stacked = stack_scenarios(snaps[:lanes], device=dev)
            torch.cuda.synchronize()
            seconds[f"stack_upload_{lanes}x40"] = time.perf_counter() - t0
            del stacked
        small = [scenario_from_snapshot(synthetic_snapshot(seed, num_validators=64,
                                                           num_miners=1024), num_epochs=40)
                 for seed in range(8)]
        mixes = {"full_4x40": (full, snaps, 4),
                 "small_8x40": ([{"weights": s.weights, "stakes": s.stakes,
                                  "quarantine": False} for s in small], small, 8)}
        out["dispatch"] = {}
        for mix, (payloads, scenarios, n) in mixes.items():
            row = {}
            for how, max_batch, window in (("coalesced", 8, 0.05), ("no_window", 8, 0.0),
                                           ("serial", 1, 0.05)):
                if mix == "full_4x40" and how == "coalesced":
                    continue  # measured above, on the service with its warmup
                other = SimulationService(ServeConfig(
                    device="cuda", coalesce_window_seconds=window, max_batch=max_batch,
                    queue_limit=16, start_dispatcher=False))
                try:
                    run = _queued_dispatch(other, payloads)
                finally:
                    other.close()
                counts = run["launches"]
                want = n if how == "serial" else 1
                assert counts["varying_scan"] == want and sum(counts.values()) == want, counts
                launches["varying_scan"] += counts["varying_scan"]
                for i, (_status, body, _) in enumerate(run["replies"]):
                    assert body["engine"] == "fused_varying", body["engine"]
                    assert body["coalesced"] == (1 if how == "serial" else n), body
                    ref = (coalesced_replies[i][1]["dividends"] if mix == "full_4x40"
                           else row["coalesced_dividends"][i] if how != "coalesced" else None)
                    if ref is not None:
                        _np_equal(f"{mix} {how} lane {i} vs coalesced",
                                  np.asarray(body["dividends"], np.float32),
                                  np.asarray(ref, np.float32))
                if how == "coalesced":
                    row["coalesced_dividends"] = [b["dividends"] for _s, b, _h in run["replies"]]
                row[how] = dict(seconds=run["seconds"], launches=counts["varying_scan"],
                                phases_ms=run["phases_ms"])
                del run
            row.pop("coalesced_dividends", None)
            out["dispatch"][mix] = row
        out["dispatch"]["full_4x40"]["coalesced"] = dict(
            seconds=seconds["coalesced_4x40"], launches=1,
            phases_ms=out["coalesced"]["phases_ms"])
        del coalesced_replies, small

        short = [Scenario(name=f"s{i}", validators=snaps[i].validators,
                          base_validator=snaps[i].base_validator,
                          weights=snaps[i].weights[:16], stakes=snaps[i].stakes[:16],
                          num_epochs=16) for i in range(2)]
        reset_launch_counts()
        status, body, _ = svc.handle("simulate", {"tenant": "default",
                                                  "weights": short[0].weights,
                                                  "stakes": short[0].stakes})
        assert status == 200 and body["engine"] == "eager", body.get("engine")
        assert sum(launch_counts().values()) == 0, launch_counts()
        reset_launch_counts()
        k3_short = simulate(short[0], version)
        counts = launch_counts()
        assert counts["varying_scan"] == 1 and sum(counts.values()) == 1, counts
        assert k3_short.engine == "fused_varying", k3_short.engine
        launches["varying_scan"] += counts["varying_scan"]
        gap = float(np.abs(np.asarray(body["dividends"], np.float32) - k3_short.dividends).max())
        assert gap <= ATOL, gap
        out["eager_vs_k3_max_abs"] = gap

        reset_launch_counts()
        with _LaunchThreads() as where:
            status, body, _ = svc.handle("simulate", {
                "tenant": "mxu", "weights": short[1].weights, "stakes": short[1].stakes,
                "quarantine": False, "engine": "fused_scan_mxu"})
        counts = launch_counts()
        assert status == 200 and body["engine"] == "fused_scan_mxu", body
        assert counts["case_scan"] == 1 and counts["support_mma"] > 0, counts
        assert counts["varying_scan"] == 0 and len(where.names) == _scan_launches(counts) \
            and all(_serving_thread(n) for n in where.names), (counts, where.names)
        launches["case_scan"] += counts["case_scan"]
        launches["support_mma"] += counts["support_mma"]
        out["mxu_request"] = dict(launches=counts)
        reset_launch_counts()
        k2 = simulate(short[1], version, epoch_impl="fused_scan")
        counts = launch_counts()
        assert counts["case_scan"] == 1 and sum(counts.values()) == 1, counts
        assert k2.engine == "fused_scan", k2.engine
        launches["case_scan"] += counts["case_scan"]
        _np_equal("fused_scan_mxu request vs solo K2",
                  np.asarray(body["dividends"], np.float32), k2.dividends)
    finally:
        svc.close()
    out["inproc_bundle"] = _bundle_gate(os.path.join(root, "inproc"))
    del solos

    # ---- Over HTTP: the smoke contract of the JAX package's CLI, plus a table.
    server = SimulationServer(ServeConfig(
        device="cuda", bundle_dir=os.path.join(root, "http"), queue_limit=16,
        tenant_burst=4, coalesce_window_seconds=0.3,
        tenant_overrides={"greedy": (0.0, 4)},
    )).start()
    reset_launch_counts()
    try:
        with _LaunchThreads() as where:
            assert wait_until_ready(server.url, timeout=60)
            client = SimulationClient(server.url, tenant="smoke", timeout=300)
            t0 = time.perf_counter()
            r = client.simulate(case="Case 3")
            seconds["http_case3"] = time.perf_counter() - t0
            assert r.ok and r.body["engine"] == "eager", r.body
            assert r.request_id and "execute" in r.server_timing, r.headers
            t0 = time.perf_counter()
            table = client.table(versions=[version])
            seconds["http_table"] = time.perf_counter() - t0
            assert table.ok and table.body["csv"].startswith("Case,"), table.body
            bad = client.simulate(weights=[[1.0]])
            assert bad.status == 400 and bad.body["error"] == "AdmissionRejected", bad.body
            assert bad.request_id
            greedy = SimulationClient(server.url, tenant="greedy", timeout=300)
            shed = None
            for _ in range(6):
                g = greedy.simulate(case="Case 2")
                if g.status == 429:
                    shed = g
                    break
            assert shed is not None and shed.retry_after and \
                shed.body["error"] == "QueueOverflow", shed
            pair = [None, None]

            def one(i):
                pair[i] = SimulationClient(server.url, tenant=f"pair{i}",
                                           timeout=300).simulate(case="Case 3")

            ths = [threading.Thread(target=one, args=(i,)) for i in range(2)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=300)
            assert all(p.status == 200 for p in pair), [p.body for p in pair]
            assert max(p.body["coalesced"] for p in pair) >= 2, [p.body for p in pair]
            metrics = client.metrics()
            for series in ("serve_queue_depth", "serve_requests_shed", "serve_breaker_open"):
                assert series in metrics, series
            assert client.healthz().body["ready"] is True
            http_counts = launch_counts()
            http_threads = sorted(set(where.names))
            http_names = len(where.names)
            reset_launch_counts()
            state = server.service.run_canary_once()
            torch.cuda.synchronize()
            canary_counts = launch_counts()
        canary_names = len(where.names) - http_names
        assert state is not None and state["ticks"] >= 1 and state["drift"] == 0, state
        assert client.healthz().body["canary"]["ticks"] >= 1
    finally:
        server.close()
    # The table's suite is one K3 launch; every smoke simulate rode the eager rung.
    assert http_counts["varying_scan"] == 1 and sum(http_counts.values()) == 1, http_counts
    assert http_names == _scan_launches(http_counts), (http_names, http_counts)
    assert all(_serving_thread(n) for n in http_threads), http_threads
    launches["varying_scan"] += http_counts["varying_scan"]
    assert canary_counts["varying_scan"] == 1 and canary_counts["case_scan"] == 1, canary_counts
    assert canary_names == _scan_launches(canary_counts), (canary_names, canary_counts)
    launches["varying_scan"] += canary_counts["varying_scan"]
    launches["case_scan"] += canary_counts["case_scan"]
    launches["support_mma"] += canary_counts["support_mma"]
    golden_path = os.path.join("tests", "golden", "total_dividends_b1.0_full.csv")
    with open(golden_path) as f:
        golden = list(csv.DictReader(f))
    served = list(csv.DictReader(table.body["csv"].splitlines()))
    worst = max(abs(float(row[f"{std} - {version}"]) - float(ref[f"{std} - {version}"]))
                for row, ref in zip(served, golden)
                for std in ("Validator A", "Validator B", "Validator C"))
    assert len(served) == len(golden) == 14 and worst < 1.5e-6, worst
    out["http"] = dict(launches=http_counts, threads=http_threads, canary=state,
                       canary_launches=canary_counts, table_golden_worst_abs=worst,
                       bundle=_bundle_gate(os.path.join(root, "http")))
    out["seconds"] = seconds
    report["serve"] = out
    print(f"serve: {json.dumps(out)}", flush=True)


def replay_phase(torch, dev, launches, report):
    """What-if replay on the card at full width. `synthetic_timeline(archive,
    21, snapshots=5)` at 256 x 4096, mounted on a fresh server with four
    epochs a snapshot (E = 20) and checkpoints every 4 epochs; two identical
    `POST /v1/whatif` from epoch 13: the first a `state_cache_miss` that
    builds the baseline on K2 (five 4-epoch segments) and runs the suffix
    from the checkpoint it wrote (six K2 launches in all), the second a hit
    re-simulating only the 8-epoch suffix (one K2 launch) with no library
    built, its deltas the first's; then the hit in process, bitwise the
    uncached run of the perturbed world and a monolithic K2 `simulate` of
    it. Then `sweep_trailing_window` for Yuma 1 and Yuma 2 into a fleet
    store (the units on the eager rung, Yuma 1's baseline already cached,
    Yuma 2's five K2 launches), its stores checked and drift-free, each
    K2 baseline within ATOL of an eager run of its window."""
    import dataclasses
    import shutil

    from yuma_simulation_tpu_torch.fabric import check_fleet
    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from yuma_simulation_tpu_torch.replay import (
        SnapshotArchive,
        StateCache,
        WhatIfSpec,
        run_whatif,
        sweep_trailing_window,
        synthetic_timeline,
    )
    from yuma_simulation_tpu_torch.replay.whatif import apply_arrays
    from yuma_simulation_tpu_torch.serve import (
        ServeConfig,
        SimulationClient,
        SimulationServer,
        wait_until_ready,
    )
    from yuma_simulation_tpu_torch.simulation.aot import process_stats
    from yuma_simulation_tpu_torch.simulation.engine import simulate
    from yuma_simulation_tpu_torch.telemetry.metrics import get_registry

    version = "Yuma 1 (paper)"
    root = os.path.abspath(os.path.join(OUT_DIR, "replay"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out, seconds = {}, {}
    t0 = time.perf_counter()
    archive = SnapshotArchive(os.path.join(root, "archive"))
    entries = synthetic_timeline(archive, 21, snapshots=5)
    seconds["archive"] = time.perf_counter() - t0
    assert [(e.validators, e.miners) for e in entries] == [(V, M)] * 5
    spec = {"netuid": 21, "version": version, "from_epoch": 13, "stake_scale": [[1, 2.0]]}
    registry = get_registry()
    cache_counters = ("state_cache_hits", "state_cache_misses", "replay_suffix_epochs_saved")
    before = [registry.counter(n).value for n in cache_counters]
    server = SimulationServer(ServeConfig(
        device="cuda", bundle_dir=os.path.join(root, "serve"),
        replay_archive_dir=os.path.join(root, "archive"),
        replay_cache_dir=os.path.join(root, "cache"),
        replay_epochs_per_snapshot=4, replay_stride=4,
    )).start()
    try:
        with _LaunchThreads() as where:
            assert wait_until_ready(server.url, timeout=60)
            client = SimulationClient(server.url, tenant="replay", timeout=600)
            reset_launch_counts()
            t0 = time.perf_counter()
            first = client.whatif(spec)
            seconds["miss"] = time.perf_counter() - t0
            miss_counts = launch_counts()
            reset_launch_counts()
            builds = process_stats().builds
            t0 = time.perf_counter()
            second = client.whatif(spec)
            seconds["hit"] = time.perf_counter() - t0
            hit_counts = launch_counts()
            hit_builds = process_stats().builds - builds
        assert len(where.names) == _scan_launches(miss_counts) + _scan_launches(hit_counts) \
            and all(_serving_thread(n) for n in where.names), where.names
        assert first.status == 200 and first.body["cache_hit"] is False, first.body
        assert first.body["epochs_simulated"] == 20 and first.body["resume_epoch"] == 0
        assert miss_counts["case_scan"] == 6 and sum(miss_counts.values()) == 6, miss_counts
        assert second.body["cache_hit"] is True, second.body
        assert (second.body["resume_epoch"], second.body["epochs_simulated"],
                second.body["epochs_saved"]) == (12, 8, 12), second.body
        assert hit_counts["case_scan"] == 1 and sum(hit_counts.values()) == 1, hit_counts
        assert hit_builds == 0, hit_builds
        after = [registry.counter(n).value for n in cache_counters]
        assert [b - a for a, b in zip(before, after)] == [1, 1, 12], (before, after)
        for key in ("total_dividend_delta", "total_incentive_delta", "max_abs_dividend_delta",
                    "baseline_key"):
            assert second.body[key] == first.body[key], key
        launches["case_scan"] += miss_counts["case_scan"] + hit_counts["case_scan"]

        replay = server.service.replay
        whatif = WhatIfSpec.from_json(spec)
        reset_launch_counts()
        hit = replay.whatif(whatif)
        meta = replay.cache.meta(hit.baseline_key)
        assert hit.cache_hit and meta.engine == "fused_scan", meta
        scenario = replay._window_scenario(21, meta.scenario_fingerprint)
        uncached = run_whatif(replay.cache, meta, scenario, None, whatif, use_cache=False,
                              device="cuda")
        W2, S2 = apply_arrays(scenario.weights, scenario.stakes, whatif)
        whole = simulate(dataclasses.replace(scenario, weights=W2, stakes=S2), version,
                         epoch_impl="fused_scan")
        counts = launch_counts()
        assert counts["case_scan"] == 3 and sum(counts.values()) == 3, counts
        launches["case_scan"] += counts["case_scan"]
        for key in ("dividends", "incentives", "dividend_delta", "incentive_delta"):
            _np_equal(f"what-if hit vs uncached {key}", getattr(hit, key), getattr(uncached, key))
        _np_equal("uncached what-if vs monolithic K2", uncached.dividends, whole.dividends)
        _np_equal("served delta vs in-process hit",
                  np.asarray(second.body["total_dividend_delta"], np.float32),
                  hit.total_dividend_delta.astype(np.float32))
        assert np.abs(hit.dividend_delta[:13]).max() == 0
        assert np.abs(hit.dividend_delta[13:]).max() > 0
        out["whatif"] = dict(
            miss_launches=miss_counts, hit_launches=hit_counts, hit_builds=hit_builds,
            resume_epoch=hit.resume_epoch, suffix_epochs=hit.epochs_simulated,
            max_abs_dividend_delta=float(np.abs(hit.dividend_delta).max()),
            threads=sorted(set(where.names)),
        )
    finally:
        server.close()
    gate = _bundle_gate(os.path.join(root, "serve"))
    from yuma_simulation_tpu_torch.telemetry.flight import load_bundle

    served = [r for r in load_bundle(os.path.join(root, "serve")).ledger
              if r.get("event") == "whatif_served"]
    assert [(r["cache_hit"], r["suffix_epochs"], r["full_epochs"]) for r in served] == [
        (False, 20, 20), (True, 8, 20)], served
    out["serve_bundle"] = gate

    reset_launch_counts()
    t0 = time.perf_counter()
    summary = sweep_trailing_window(
        archive, StateCache(os.path.join(root, "cache")),
        store_root=os.path.join(root, "sweeps"),
        versions=[version, "Yuma 2 (Adrian-Fish)"], epochs_per_snapshot=4, stride=4,
        unit_size=1, device="cuda")
    seconds["sweep_2_versions"] = time.perf_counter() - t0
    counts = launch_counts()
    assert counts["case_scan"] == 5 and sum(counts.values()) == 5, counts
    launches["case_scan"] += counts["case_scan"]
    assert summary["units_completed"] == 2 and summary["drift_events"] == 0, summary
    assert summary["canaries_run"] >= 2, summary
    for store in summary["stores"]:
        assert check_fleet(store) == [], store
    # The units ran the eager rung and the baselines K2: not bitwise, so
    # each baseline is held to an eager run of its window within ATOL.
    window = archive.window_scenario(21, epochs_per_snapshot=4)
    eager_gap = {}
    for outcome in summary["outcomes"]:
        cached = StateCache(os.path.join(root, "cache")).load_baseline(outcome["baseline_key"])
        eager = simulate(window, outcome["version"], epoch_impl="eager")
        eager_gap[outcome["version"]] = float(np.abs(cached["dividends"] - eager.dividends).max())
        assert eager_gap[outcome["version"]] <= ATOL, eager_gap
    out["sweep"] = dict(launches=counts, units=summary["units_completed"],
                        baseline_vs_eager_max_abs=eager_gap,
                        canaries=summary["canaries_run"], drift=summary["drift_events"],
                        stores=[os.path.relpath(s) for s in summary["stores"]])
    out["seconds"] = seconds
    report["replay"] = out
    print(f"replay: {json.dumps(out)}", flush=True)


def _whatif_launches(cache_hit: bool, epochs_simulated: int, stride: int) -> int:
    """K2 launches of one what-if on a pinned K2 baseline: the perturbed
    suffix is one `simulate` call from the checkpoint, and a miss first
    builds the baseline, one call a `stride` of epochs (a miss reports
    every epoch as simulated)."""
    return 1 if cache_hit else -(-epochs_simulated // stride) + 1


def _gpu_memory_used() -> float:
    """The card's used memory in MiB (`nvidia-smi --query-gpu=memory.used`)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    ).stdout
    return float(out.strip().splitlines()[0])


def _compute_apps() -> list:
    """`nvidia-smi --query-compute-apps=pid,used_memory` as (pid, MiB)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout
    apps = []
    for line in out.strip().splitlines():
        pid, _, mem = line.partition(",")
        try:
            apps.append((int(pid.strip()), float(mem.strip().split()[0])))
        except (ValueError, IndexError):
            apps.append((line.strip(), None))
    return apps


#: The kill load's simulate shape, [epochs, validators, miners]: explicit
#: arrays cross HTTP as JSON, so the routed requests are small.
SCALEOUT_SIMULATE = (16, 64, 256)


def scaleout_phase(torch, dev, launches, report, smi):
    """The horizontal serving tier on the card (`serve/drill.py`'s
    `run_scaleout_drill`, every process on the card): a router in this
    process and three worker processes (each exec'd with `--device cuda`,
    warming the kill load's K3 shape at startup) on one empty shared
    kernel-library cache; an archive of two subnets of `synthetic_timeline`
    snapshots at 256 x 4096 (three snapshots of four epochs, checkpoints
    every 4). Affinity: what-ifs from epoch 9 on subnet 1 land on the worker
    that built its K2 baseline (a hit, 8 epochs saved), the affinity-off
    control router's land on cold workers that rebuild, every delta bitwise
    the in-process service's (its ReplayService on the card). The router
    hop: one [16, 64, 256] `quarantine: false` simulate (K3) through the
    router against the same request straight to a worker. Kill drill: 16
    such requests on four threads, the affinity worker SIGKILLed 0.2 s in:
    every answer a 200 bitwise the in-process K3 answer, `worker_lost` and
    `request_rerouted` ledgered. Autoscaler: a synthetic fast burn spawns a
    worker that reports 0 library builds, idling retires it. The merged
    bundle passes `check_bundle` and `check_stitched`. Each worker's
    context shows in `nvidia-smi --query-compute-apps` with its memory
    (where this sandbox shows other pids than the processes', one entry a
    process), and the card's used memory before the drill and with the
    three workers up gives their contexts' share. Each worker that exits
    gracefully leaves its launch counts beside its bundle
    (`ops/launches.py::publish_launch_counts`; the killed worker's died
    with it), and each must equal what the requests it answered launch:
    one K3 for its warmup shape and for each simulate dispatch (requests
    queued together share one stacked launch; the dispatches, each with
    the requests it served, are read from the worker's bundle and must
    hold every simulate it answered), one K2 for each what-if's suffix
    and a stride of epochs each for a miss's baseline."""
    import argparse
    import shutil

    from yuma_simulation_tpu_torch.ops.launches import (
        launch_counts,
        read_launch_counts,
        reset_launch_counts,
    )
    from yuma_simulation_tpu_torch.serve.drill import run_scaleout_drill
    from yuma_simulation_tpu_torch.telemetry.flight import load_bundle

    root = os.path.abspath(os.path.join(OUT_DIR, "scaleout"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    E_s, V_s, M_s = SCALEOUT_SIMULATE
    rng = np.random.default_rng(16)
    W = rng.random((E_s, V_s, M_s)).astype(np.float32)
    S = (rng.random((E_s, V_s)) + 0.1).astype(np.float32)
    args = argparse.Namespace(device=dev.type, bundle_dir=os.path.join(root, "merged"))
    stride = 4
    warmup = (f"{E_s}x{V_s}x{M_s}",)
    sizes = dict(
        validators=V, miners=M, snapshots=3, epochs_per_snapshot=4, stride=stride,
        from_epoch=9, requests=16,
        simulate={"weights": W.tolist(), "stakes": S.tolist(), "quarantine": False},
        warmup=warmup, workdir=os.path.join(root, "work"),
    )
    probed = {}

    def probe(pids):
        apps = _compute_apps()
        probed.update(apps=apps, workers=pids, used_mib=_gpu_memory_used())
        return {"apps": apps, "workers": pids}

    out = {}
    used_before = _gpu_memory_used()
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = run_scaleout_drill(args, sizes=sizes, report=out, probe=probe)
    seconds = time.perf_counter() - t0
    in_process = launch_counts()
    assert rc == 0, out.get("failures")
    # Every worker's CUDA context on the card: its pid among the compute
    # apps (the router's too), unless this sandbox shows other pids.
    pids = {pid for pid, _ in probed["apps"]}
    if os.getpid() in pids:
        missing = [p for p in probed["workers"] if p not in pids]
        assert not missing, (missing, probed["apps"])
    else:
        assert len(probed["apps"]) >= len(probed["workers"]) + 1, probed
    memory = {str(pid): mib for pid, mib in probed["apps"]}
    spawns = out["spawns"]
    # The first worker builds every library into the empty shared cache.
    from yuma_simulation_tpu_torch.ops._build import SOURCES

    cold_builds = len(SOURCES) if dev.type == "cuda" else 0
    assert [s["aot_builds"] for s in spawns] == [cold_builds, 0, 0], spawns
    assert out["autoscaled"]["aot_builds"] == 0, out["autoscaled"]
    kill = out["kill"]
    assert kill["errors"] == 0 and kill["mismatched"] == 0 and kill["reroutes"] >= 1, kill
    # Each surviving worker's counts against what it answered.
    assert out["served"] and all(w for w, _, _ in out["served"]), out["served"]
    per_worker = {}
    for bundle in out["worker_bundles"]:
        worker = os.path.basename(os.path.dirname(bundle))
        record = read_launch_counts(bundle)
        if worker == out["kill"]["worker"]:
            assert record is None, (worker, record)
            continue
        assert record is not None, worker
        served = {"simulate": 0, "whatif": 0}
        want = {"varying_scan": 0, "case_scan": 0}
        for who, kind, body in out["served"]:
            if who == worker:
                served[kind] += 1
                if kind == "whatif":
                    want["case_scan"] += _whatif_launches(
                        body["cache_hit"], body["epochs_simulated"], stride)
        dispatched = {"simulate": [], "whatif": []}
        for sp in load_bundle(bundle).spans:
            kind = sp.get("name", "").partition("dispatch:")[2]
            if kind in dispatched:
                dispatched[kind].append(len((sp.get("attrs") or {}).get("requests") or ()))
        assert {k: sum(v) for k, v in dispatched.items()} == served, (worker, dispatched, served)
        want["varying_scan"] = len(warmup) + len(dispatched["simulate"])
        if dev.type != "cuda":
            want = {k: 0 for k in want}
        got = {k: record["launches"][k] for k in want}
        assert got == want, (worker, got, want)
        per_worker[worker] = dict(got, pid=record["pid"],
                                  simulate_dispatches=dispatched["simulate"])
    children = {k: sum(w[k] for w in per_worker.values()) for k in ("varying_scan", "case_scan")}
    if dev.type == "cuda":
        assert children["varying_scan"] >= 1 and children["case_scan"] >= 1, per_worker
    for kernel in ("varying_scan", "case_scan"):
        launches[kernel] += children[kernel] + in_process[kernel]
    med = lambda xs: float(np.median(xs)) if xs else None  # noqa: E731
    summary = dict(
        card=smi, seconds=seconds,
        spawn_seconds=dict(cold=spawns[0]["seconds"], warm=[s["seconds"] for s in spawns[1:]],
                           autoscaled=out["autoscaled"]["seconds"]),
        whatif=dict(miss_seconds=out["whatif_miss_seconds"],
                    affinity_hit_seconds=out["whatif"]["affinity_seconds"],
                    control_seconds=out["whatif"]["control_seconds"],
                    control_misses=out["whatif"]["control_misses"],
                    epochs_saved=out["whatif"]["epochs_saved"]),
        router_hop=dict(routed_median_s=med(out["router_hop"]["routed_seconds"]),
                        direct_median_s=med(out["router_hop"]["direct_seconds"]),
                        routed_s=out["router_hop"]["routed_seconds"],
                        direct_s=out["router_hop"]["direct_seconds"]),
        kill=dict(requests=kill["requests"], reroutes=kill["reroutes"], errors=kill["errors"],
                  rerouted_s=kill["rerouted_seconds"],
                  other_median_s=med(kill["other_seconds"])),
        context_mib=dict(router=memory.get(str(os.getpid())),
                         workers={str(p): memory.get(str(p)) for p in probed["workers"]},
                         apps=probed["apps"], pids_visible=os.getpid() in pids,
                         card_used_before=used_before, card_used_with_workers=probed["used_mib"],
                         per_worker=(probed["used_mib"] - used_before) / len(probed["workers"])),
        launches=dict(children=children, per_worker=per_worker,
                      in_process={k: in_process[k] for k in ("varying_scan", "case_scan")}),
        simulate_shape=list(SCALEOUT_SIMULATE),
    )
    report["scaleout"] = summary
    print(f"scaleout: {json.dumps(summary)}", flush=True)


#: The soak on the card (`python -m yuma_simulation_tpu_torch.replay --soak`)
#: at 256 x 4096: 3 subnets (the minimum), two versions, one epoch a
#: snapshot, checkpoints every 8 epochs, 86 rounds a second apart. Its
#: timing knobs follow the card's pace (a controller's first cycle ~12 s
#: after the soak starts, then 2-6 s a cycle of three windows; a restarted
#: one sweeps its first cycle ~14 s after the kill, and drained 82-round
#: timelines in 43-44 s, ~0.25 s more a round): three windows a cycle, so
#: subnet 0's two pairs and one of subnet 1's are swept each cycle while
#: the writer runs and the stalled subnet 2 is shed until the restart; a
#: stall deadline of 52 s, past which subnet 2 stalls before the kill at
#: 76 s and no subnet stalls while the restarted controller drains; the
#: writer's last round (~82 s) between the kill and the restarted
#: controller's first cycle (~90 s); a freshness budget of 1 s, under a
#: cycle of the restarted controller, so its backlog burns the SLO fast
#: (PERF.md §6).
SOAK_STRIDE = 8
SOAK_ARGS = (
    "--subnets", "3", "--validators", str(V), "--miners", str(M),
    "--versions", "Yuma 2 (Adrian-Fish)", "Yuma 1 (paper)", "--max-windows", "3",
    "--rounds", "86", "--interval", "1.0", "--epochs-per-snapshot", "1",
    "--stride", str(SOAK_STRIDE), "--stall-after", "3", "--corrupt-round", "3",
    "--kill-after", "76", "--downtime", "6", "--stall-deadline", "52",
    "--freshness-budget", "1.0", "--drain-timeout", "240", "--recovery-timeout", "90",
)


def controller_phase(torch, dev, launches, report, smi):
    """The continuous replay controller on the card: the soak
    (`replay/soak.py`) as a user runs it, `python -m
    yuma_simulation_tpu_torch.replay --soak --device cuda` at 256 x 4096
    with 3 subnets (SOAK_ARGS lists the cuts). Its writer, controller and
    helper host are real processes exec'd with `--device cuda`; the host
    and the controller are SIGKILLed mid-sweep and the controller
    restarted cold. The soak must pass every one of its checks (exit 0):
    among them every window published exactly once, and the final
    incremental baselines of the clean and the corrupted subnet bitwise
    (and keyed as) from-genesis builds on the controller's rung (the eager
    rung, `replay/controller.py::CONTROLLER_ENGINE`: no kernel launch).
    The soak's serve tier answers what-ifs on K2 throughout; its launch
    counts, left beside its bundle, must equal what its what-ifs launch.
    Prints the seconds per cycle, the windows per cycle and the soak's
    seconds."""
    import glob
    import re
    import shutil

    from yuma_simulation_tpu_torch.ops.launches import read_launch_counts

    root = os.path.abspath(os.path.join(OUT_DIR, "controller"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    target = os.path.join(root, "soak")
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(p for p in [here, env.get("PYTHONPATH", "")] if p)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "yuma_simulation_tpu_torch.replay", "--soak", "--device", dev.type,
         "--bundle-dir", target, *SOAK_ARGS],
        cwd=here, env=env, capture_output=True, text=True, timeout=420,
    )
    seconds = time.perf_counter() - t0
    with open(os.path.join(root, "soak.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    failed = [ln[5:] for ln in proc.stdout.splitlines() if re.match(r"^FAIL ", ln)]
    assert proc.returncode == 0 and not failed, (
        proc.returncode, failed, proc.stdout[-3000:], proc.stderr[-3000:])
    with open(os.path.join(target, "soak_summary.json")) as f:
        summary = json.load(f)
    cycles = summary["cycles"]
    working = [c for c in cycles if c["swept"]]
    # The serve tier's K2 launches: each what-if's suffix, and each baseline
    # its cache holds (each built by one what-if's miss; fewer than the
    # cache's bound of 64, so none was evicted) a stride of epochs each.
    record = read_launch_counts(os.path.join(target, "serve"))
    assert record is not None, "the soak's serve tier left no launch counts"
    metas = glob.glob(os.path.join(target, "serve-cache", "*", "meta.json"))
    assert len(metas) < 64, len(metas)
    built = []
    for path in metas:
        with open(path) as f:
            built.append(json.load(f)["epochs"])
    want = (summary["whatifs_ok"] + sum(-(-e // SOAK_STRIDE) for e in built)
            if dev.type == "cuda" else 0)
    got = record["launches"]["case_scan"]
    assert got == want, (got, want, summary["whatifs_ok"], built)
    if dev.type == "cuda":
        assert got >= 1, record
    launches["case_scan"] += got
    out = dict(
        card=smi, rc=proc.returncode, seconds=seconds, soak_seconds=summary["seconds"],
        windows=summary["windows_swept"], whatifs=summary["whatifs_ok"],
        units_published=summary["units_published"], unit_ok=summary["unit_ok_records"],
        cycles=len(cycles), sweeping_cycles=len(working),
        windows_per_sweeping_cycle=(float(np.mean([c["swept"] for c in working]))
                                    if working else 0.0),
        seconds_per_sweeping_cycle=(float(np.mean([c["seconds"] for c in working]))
                                    if working else 0.0),
        seconds_per_window=(sum(c["seconds"] for c in working)
                            / max(1, sum(c["swept"] for c in working))),
        incidents=summary["incidents"], sealed_segments=summary["sealed_segments"],
        launches=dict(serve=record["launches"]["case_scan"]), cuts=list(SOAK_ARGS),
    )
    report["controller"] = out
    print(f"controller: {json.dumps(out)}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2

    from yuma_simulation_tpu_torch.models.config import (
        SimulationHyperparameters,
        YumaConfig,
        YumaParams,
    )
    from yuma_simulation_tpu_torch.models.variants import (
        canonical_versions,
        variant_for_version,
    )
    from yuma_simulation_tpu_torch.ops import _build
    from yuma_simulation_tpu_torch.ops.cuda_epoch import (
        fused_case_scan,
        fused_case_scan_plain,
        fused_ema_scan,
        fused_varying_scan,
        fused_varying_scan_plain,
    )
    from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
    from yuma_simulation_tpu_torch.scenarios import get_cases
    from yuma_simulation_tpu_torch.scenarios.base import Scenario
    from yuma_simulation_tpu_torch.simulation.engine import simulate
    from yuma_simulation_tpu_torch.simulation.sweep import simulate_batch, stack_scenarios

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {"card": smi}

    t0 = time.perf_counter()
    for src in _build.SOURCES:
        _build.load(src)
    report["build_s"] = time.perf_counter() - t0
    print(f"built {_build.SOURCES} in {report['build_s']:.1f} s", flush=True)

    fma_phase(torch, dev, report)

    t0 = time.perf_counter()
    W_np, S_np, quiet_miner = workload(seed=0, E=E)
    print(f"workload [{E}, {V}, {M}] made in {time.perf_counter() - t0:.1f} s", flush=True)
    W = torch.tensor(W_np, device=dev)
    S = torch.tensor(S_np, device=dev)

    # ---- K1: consensus bisection vs its plain version, bitwise, at one
    # slab and at 16; event and device times.
    k1 = bisect_phase(torch, W, S, mma=False)

    # ---- K2 / K3 vs their plain versions, one run per bond model over all
    # E epochs with a reset at E // 2. Each plain call is timed once (CUDA
    # events): its result is the one the kernels are held to.
    tile = 16
    errs = {"case_scan": 0.0, "varying_scan": 0.0}
    plain_times = {"case_scan": [], "varying_scan": []}
    for version, params in VERSIONS:
        spec = variant_for_version(version)
        cfg = YumaConfig(yuma_params=YumaParams(**params))
        kw = dict(
            reset_index=quiet_miner, reset_epoch=E // 2, reset_mode=spec.reset_mode,
            mode=spec.bonds_mode, save_bonds=True, save_incentives=True,
            save_consensus=True, x64=spec.bonds_mode.value == "ema_rust",
            kappa=cfg.kappa, bond_penalty=cfg.bond_penalty, bond_alpha=cfg.bond_alpha,
            capacity_alpha=cfg.capacity_alpha, decay_rate=cfg.decay_rate,
            liquid_alpha=cfg.liquid_alpha, alpha_low=cfg.alpha_low,
            alpha_high=cfg.alpha_high,
        )
        k2 = fused_case_scan(W, S, **kw)
        p2, ms2 = timed_once(torch, lambda: fused_case_scan_plain(W, S, **kw))
        k3 = fused_varying_scan(W, S, epoch_tile=tile, **kw)
        p3, ms3 = timed_once(torch, lambda: fused_varying_scan_plain(W, S, epoch_tile=tile, **kw))
        plain_times["case_scan"].append(ms2)
        plain_times["varying_scan"].append(ms3)
        for name, got, ref in (("case_scan", k2, p2), ("varying_scan", k3, p3)):
            check_equal(f"{name} {version} consensus", got["consensus"], ref["consensus"])
            for key in ("dividends_normalized", "bonds", "final_bonds", "incentives"):
                check_close(f"{name} {version} {key}", got[key], ref[key])
                if key != "incentives":
                    errs[name] = max(errs[name], max_err(got[key], ref[key]))
            assert torch.isfinite(got["dividends_normalized"]).all(), (name, version)
        for key in ("consensus", "incentives"):
            check_equal(f"K3 vs K2 {version} {key}", k3[key], k2[key])
        for key in ("dividends_normalized", "bonds", "final_bonds"):
            check_close(f"K3 vs K2 {version} {key}", k3[key], k2[key], atol=1e-6, rtol=0)
        print(f"K2/K3 ok: {version}; max |kernel - plain| {errs}; plain ms "
              f"{ms2:.1f} / {ms3:.1f}", flush=True)
        del k2, p2, k3, p3

    time_kw = dict(save_bonds=False, save_incentives=False)
    scans = {}
    for name, kernel, extra in (
        ("case_scan", fused_case_scan, {}),
        ("varying_scan", fused_varying_scan, {"epoch_tile": tile}),
    ):
        rec = dict(
            max_abs_err=errs[name],
            ms=cuda_ms(torch, lambda: kernel(W, S, **extra, **time_kw), 20),
            # The mean of the checked plain calls (with their saves and reset).
            plain_ms=sum(plain_times[name]) / len(plain_times[name]),
        )
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            4 * (E * V * M + 2 * E * V + V * M), E * 17 * 2 * V * M
        )
        scans[name] = rec
        print(f"{name} timing at [{E}, {V}, {M}]: {rec}", flush=True)
    report["host_ms"] = {"case_scan": host_ms(torch, lambda: fused_case_scan(W, S, **time_kw))}
    # Where the scans' time goes, by phase kernel (torch.profiler / CUPTI).
    os.makedirs(OUT_DIR, exist_ok=True)
    W1, S1 = W[0].contiguous(), (S[0] / S[0].sum()).contiguous()
    sc = (1.0 + 1e-7 * torch.arange(E, dtype=torch.float32, device=dev)).contiguous()
    liquid = dict(liquid_alpha=True, **time_kw)
    report["phases"] = phase_profile(torch, smi, (
        ("case_scan", lambda: fused_case_scan(W, S, **time_kw)),
        ("case_scan_liquid", lambda: fused_case_scan(W, S, **liquid)),
        ("varying_scan", lambda: fused_varying_scan(W, S, epoch_tile=tile, **time_kw)),
        ("ema_scan", lambda: fused_ema_scan(W1, S1, sc)),
        ("ema_scan_mxu", lambda: fused_ema_scan(W1, S1, sc, mxu=True)),
    ))

    # ---- The main path, through the entry points.
    scenario = Scenario(
        name="synthetic 256x4096", validators=[f"v{i}" for i in range(V)],
        base_validator="v0", weights=W_np, stakes=S_np, num_epochs=E,
        reset_bonds_index=quiet_miner, reset_bonds_epoch=E // 2,
    )
    simulate(scenario, "Yuma 1 (paper)")  # warm-up: allocator and caches
    launches = {}
    reset_launch_counts()
    t0 = time.perf_counter()
    main_run = simulate(scenario, "Yuma 1 (paper)")
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    assert main_run.engine == "fused_varying", main_run.engine
    assert counts["varying_scan"] >= 1, counts
    assert main_run.dividends.shape == (E, V) and np.isfinite(main_run.dividends).all()
    assert np.isfinite(main_run.bonds).all()
    report["main_path"] = dict(
        engine=main_run.engine, epochs=E, seconds=seconds, epochs_per_s=E / seconds,
        launches=counts,
    )
    launches["varying_scan"] = counts["varying_scan"]
    print(f"main path: simulate auto -> {main_run.engine}, {E / seconds:.1f} epochs/s "
          f"(host clock, host->device copies included); launches {counts}", flush=True)

    reset_launch_counts()
    case_run = simulate(scenario, "Yuma 1 (paper)", epoch_impl="fused_scan")
    counts = launch_counts()
    assert counts["case_scan"] >= 1, counts
    launches["case_scan"] = counts["case_scan"]
    np.testing.assert_allclose(case_run.dividends, main_run.dividends, atol=1e-6, rtol=0)
    print(f"main path: simulate fused_scan; launches {counts}", flush=True)

    short = Scenario(
        name="synthetic 256x4096, 4 epochs", validators=scenario.validators,
        base_validator="v0", weights=W_np[:4], stakes=S_np[:4], num_epochs=4,
    )
    reset_launch_counts()
    eager_run = simulate(short, "Yuma 1 (paper)", epoch_impl="eager", consensus_impl="kernel")
    counts = launch_counts()
    assert counts["consensus_bisect"] == 4, counts
    launches["consensus_bisect"] = counts["consensus_bisect"]
    # The eager rung normalizes rows with the blocked miner_sum spelling and
    # the scans with a left-to-right sum: a knife-edge weight may move one
    # consensus cell by a grid step, so this is a loose sanity bound.
    eager_gap = float(np.abs(eager_run.dividends - main_run.dividends[:4]).max())
    assert np.isfinite(eager_run.dividends).all() and eager_gap < 1e-3, eager_gap
    report["eager_vs_fused_max_abs"] = eager_gap
    print(f"main path: simulate eager + consensus kernel; launches {counts}; "
          f"max |eager - fused| dividends {eager_gap:.3g}", flush=True)

    # ---- The telemetry core on the main path's workload.
    telemetry_phase(torch, dev, scenario, main_run, smi, launches, report)

    # ---- The reference surface: 14 cases x 9 versions vs the golden CSV.
    golden_path = os.path.join("tests", "golden", "total_dividends_b1.0_full.csv")
    with open(golden_path) as f:
        golden = list(csv.DictReader(f))
    cases = get_cases()
    Wc, Sc, ri, re_ = stack_scenarios(cases)
    reset_launch_counts()
    worst = 0.0
    for version, params in canonical_versions():
        cfg = YumaConfig(simulation=SimulationHyperparameters(bond_penalty=1.0),
                         yuma_params=params)
        ys = simulate_batch(Wc, Sc, ri, re_, cfg, variant_for_version(version), x64=True)
        totals = ys["dividends"].double().sum(dim=1).cpu().numpy()
        for i in range(len(cases)):
            for j, std in enumerate(["Validator A", "Validator B", "Validator C"]):
                worst = max(worst, abs(totals[i, j] - float(golden[i][f"{std} - {version}"])))
    counts = launch_counts()
    assert worst < 1.5e-6, f"golden surface drift {worst}"
    assert counts["varying_scan"] == 9, counts
    launches["varying_scan"] += counts["varying_scan"]
    report["golden_worst_abs"] = worst
    print(f"golden surface ok: 14 cases x 9 versions, worst |total - golden| {worst:.3g}; "
          f"launches {counts}", flush=True)

    # ---- The artifact CLI and the grid sweeps.
    cli_phase(torch, launches, report)
    charts_phase(torch, dev, W_np, S_np, launches, report)
    sweep_phase(torch, dev, W_np, S_np, quiet_miner, launches, report)
    streams_phase(torch, dev, W_np, S_np, quiet_miner, launches, report)

    # ---- K4, K5, K6, the scaled throughput path, and the Monte-Carlo (K7).
    measured = {"consensus_bisect": k1, **scans}
    mc_phase(torch, dev, launches, measured, report)
    k4_phase(torch, dev, W, S, measured, errs)
    scaled_phases(torch, dev, measured, launches, report)
    # Last: the profiler windows of the phases above drop more of their
    # first launches the more the process has run before them (PERF.md §7).
    resilience_phase(torch, dev, W_np, S_np, quiet_miner, main_run, launches, report)
    # The kernel cache across processes, the rungs' cost records, the foundry.
    cache_phase(report)
    cost_phase(report, scans)
    foundry_phase(torch, dev, launches, report)
    # Miner-axis sharding and the fleet fabric.
    mesh_phase(torch, dev, launches, report)
    fleet_phase(torch, dev, launches, report)
    # The serving tier and what-if replay.
    serve_phase(torch, dev, launches, report)
    replay_phase(torch, dev, launches, report)
    # The multi-process tier: the router and its workers, the controller's soak.
    scaleout_phase(torch, dev, launches, report, smi)
    controller_phase(torch, dev, launches, report, smi)

    replaces = {
        "consensus_bisect": "yuma_simulation_tpu/ops/pallas_consensus.py:80",
        "case_scan": "yuma_simulation_tpu/ops/pallas_epoch.py:1517",
        "varying_scan": "yuma_simulation_tpu/ops/pallas_epoch.py:2181",
        "support_mma": "yuma_simulation_tpu/ops/pallas_epoch.py:160",
        "ema_scan": "yuma_simulation_tpu/ops/pallas_epoch.py:1026",
        "ema_epoch": "yuma_simulation_tpu/ops/pallas_epoch.py:2512",
        # Not a TPU kernel: the JAX package makes this slab in XLA.
        "mc_weights": "none (XLA: yuma_simulation_tpu/parallel/sharded.py:714)",
    }
    sources = {
        "consensus_bisect": "yuma_simulation_tpu_torch/csrc/consensus.cu",
        "case_scan": "yuma_simulation_tpu_torch/csrc/case_scan.cu",
        "varying_scan": "yuma_simulation_tpu_torch/csrc/case_scan.cu",
        "support_mma": "yuma_simulation_tpu_torch/csrc/common.cuh",
        "ema_scan": "yuma_simulation_tpu_torch/csrc/ema_scan.cu",
        "ema_epoch": "yuma_simulation_tpu_torch/csrc/ema_scan.cu",
        "mc_weights": "yuma_simulation_tpu_torch/csrc/mc_weights.cu",
    }
    kernels = []
    for name in replaces:
        m = measured[name]
        assert launches.get(name, 0) > 0, (name, launches)
        kernels.append(dict(
            name=name, route="cuda", source=sources[name], replaces=replaces[name],
            launches=launches[name], max_abs_err=m["max_abs_err"], ms=m["ms"],
            plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
            library_ms=m.get("library_ms"),
        ))
        if name in ("varying_scan", "case_scan"):
            kernels[-1]["launches_note"] = (
                "in-process launches, plus the scale-out workers' and the soak's serve "
                "tier's read from their flight bundles; the fleet drill's host processes, "
                "the --fleet-store CLI processes and the SIGKILLed worker are not counted")
    report["kernels"] = kernels

    report["bisect"] = {
        name: {str(n): {k: rec[k] for k in ("ms", "device_ms", "bound_ms", "max_abs_err")}
               for n, rec in ((1, measured[name]), (16, measured[name]["slabs16"]))}
        for name in ("consensus_bisect", "support_mma")
    }
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(json.dumps({"phases": report["phases"]}))
    print(json.dumps({"host_ms": report["host_ms"]}))
    print(json.dumps({"bisect": report["bisect"]}))
    print(json.dumps({"charts": report["charts"]}))
    print(json.dumps({"cli": report["cli"], "sweeps": report["sweeps"],
                      "fma_helper": report["fma_helper"]}))
    print(json.dumps({"streams": report["streams"]}))
    print(json.dumps({"mc": report["mc"]}))
    print(json.dumps({"telemetry": report["telemetry"]}))
    print(json.dumps({"resilience": report["resilience"]}))
    print(json.dumps({"profiler_windows": PROFILER_WINDOWS}))
    print(json.dumps({"cache": report["cache"]}))
    print(json.dumps({"cost": report["cost"]}))
    print(json.dumps({"foundry": report["foundry"]}))
    print(json.dumps({"mesh": report["mesh"]}))
    print(json.dumps({"fleet": report["fleet"]}))
    print(json.dumps({"serve": report["serve"], "card": smi}))
    print(json.dumps({"replay": report["replay"], "card": smi}))
    print(json.dumps({"scaleout": report["scaleout"], "card": smi}))
    print(json.dumps({"controller": report["controller"], "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cache-child"]:
        sys.exit(cache_child(sys.argv[2]))
    sys.exit(main())

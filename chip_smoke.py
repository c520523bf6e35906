#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (yuma_simulation_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # one GPU, about a minute and a half

Builds the CUDA kernels from `yuma_simulation_tpu_torch/csrc` (nvcc, on
first use), then:

1. prints the card's name and power limit (nvidia-smi);
2. holds K1 (consensus bisection) against its plain PyTorch version at
   256 validators x 4096 miners: `c_high` bitwise equal;
3. holds K2 (case scan) and K3 (varying scan) against their plain versions
   at 256 x 4096 x 64 epochs of per-epoch weights, one run per bond model:
   quantized consensus bitwise, dividends and bonds within atol 2e-6 /
   rtol 1e-5; K3 against K2: consensus and incentives bitwise, dividends
   and bonds within 1e-6;
4. drives the main path through the entry points a user calls, with the
   launch counts zeroed before and read after each: `simulate` with default
   arguments (auto -> K3), `simulate(epoch_impl="fused_scan")` (K2), and
   `simulate(epoch_impl="eager", consensus_impl="kernel")` (K1);
5. runs the reference surface: `simulate_batch` over the 14 built-in cases
   x 9 versions at beta=1.0 through `auto`, held to the golden CSV within
   1.5e-6;
6. prints one `{"kernels": [...]}` line (launches, max |kernel - plain|,
   kernel and plain times from CUDA events, the roofline bound), the card
   line, and last `{"ok": true, "device": {...}}`.

Any failure raises and exits non-zero. Without CUDA it exits 2 and prints
no result. The numbers and a per-kernel profile table are also written
under build/chip_smoke/ (gitignored).
"""

from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
import time

import numpy as np

V, M, E = 256, 4096, 64
#: H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth, and the
#: non-tensor-core float32 rate, against which the bisection's int32
#: compare-adds are counted (the data sheet gives no int32 vector rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
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
OUT_DIR = os.path.join("build", "chip_smoke")


def workload(seed: int, E: int, nnz: int = 48, strong: int = 64):
    """Per-epoch weights and stakes shaped like a real subnet, as the JAX
    package's foundry/metagraph.py::synthetic_snapshot draws one epoch:
    heavy-tailed lognormal stakes (sigma 1.2) drifting every epoch; a
    shared miner-quality vector (Gamma draws: `strong` miners, and a tail
    10^4 times lighter); each validator row touches `nnz` miners sampled by
    quality without replacement (Gumbel top-k) and re-noised every epoch.
    The strong set keeps ~50 miners in consensus, so the liquid-alpha
    0.99-quantile fallback has a spread (with a single Gamma(1/8) vector
    almost every miner's consensus is 0, every quantile coincides, and the
    reference's logistic fit divides by zero)."""
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


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
    from yuma_simulation_tpu_torch.ops.consensus import stake_weighted_median
    from yuma_simulation_tpu_torch.ops.cuda_consensus import stake_weighted_median_cuda
    from yuma_simulation_tpu_torch.ops.cuda_epoch import (
        fused_case_scan,
        fused_case_scan_plain,
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

    t0 = time.perf_counter()
    W_np, S_np, quiet_miner = workload(seed=0, E=E)
    print(f"workload [{E}, {V}, {M}] made in {time.perf_counter() - t0:.1f} s", flush=True)
    W = torch.tensor(W_np, device=dev)
    S = torch.tensor(S_np, device=dev)

    # ---- K1: consensus bisection vs its plain version, bitwise.
    Wn = (W[0] / (W[0].sum(-1, keepdim=True) + 1e-6)).contiguous()
    Sn = (S[0] / S[0].sum()).contiguous()
    c_kernel = stake_weighted_median_cuda(Wn, Sn, 0.5)
    c_plain = stake_weighted_median(Wn, Sn, 0.5)
    torch.cuda.synchronize()
    check_equal("K1 c_high", c_kernel, c_plain)
    k1 = dict(
        max_abs_err=max_err(c_kernel, c_plain),
        ms=cuda_ms(torch, lambda: stake_weighted_median_cuda(Wn, Sn, 0.5), 50),
        plain_ms=cuda_ms(torch, lambda: stake_weighted_median(Wn, Sn, 0.5), 5),
    )
    k1["bound_ms"], k1["bound_by"] = bound_ms(4 * (V * M + V + M), 17 * 2 * V * M)
    print(f"K1 ok: bitwise; {k1}", flush=True)

    # ---- K2 / K3 vs their plain versions, one run per bond model.
    tile = 16
    errs = {"case_scan": 0.0, "varying_scan": 0.0}
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
        p2 = fused_case_scan_plain(W, S, **kw)
        k3 = fused_varying_scan(W, S, epoch_tile=tile, **kw)
        p3 = fused_varying_scan_plain(W, S, epoch_tile=tile, **kw)
        torch.cuda.synchronize()
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
        print(f"K2/K3 ok: {version}; max |kernel - plain| {errs}", flush=True)
        del k2, p2, k3, p3

    time_kw = dict(save_bonds=False, save_incentives=False)
    scans = {}
    for name, kernel, plain, extra in (
        ("case_scan", fused_case_scan, fused_case_scan_plain, {}),
        ("varying_scan", fused_varying_scan, fused_varying_scan_plain, {"epoch_tile": tile}),
    ):
        rec = dict(
            max_abs_err=errs[name],
            ms=cuda_ms(torch, lambda: kernel(W, S, **extra, **time_kw), 5),
            plain_ms=cuda_ms(torch, lambda: plain(W, S, **extra, **time_kw), 1),
        )
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            4 * (E * V * M + 2 * E * V + V * M), E * 17 * 2 * V * M
        )
        scans[name] = rec
        print(f"{name} timing at [{E}, {V}, {M}]: {rec}", flush=True)
    # Where the scans' time goes, by phase kernel (torch.profiler / CUPTI).
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
        for name, fn in (
            ("case_scan", lambda: fused_case_scan(W, S, **time_kw)),
            ("varying_scan", lambda: fused_varying_scan(W, S, epoch_tile=tile, **time_kw)),
        ):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            f.write(f"== {name} [{E}, {V}, {M}], one call, {smi}\n")
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))
            f.write("\n")

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

    replaces = {
        "consensus_bisect": "yuma_simulation_tpu/ops/pallas_consensus.py:80",
        "case_scan": "yuma_simulation_tpu/ops/pallas_epoch.py:1517",
        "varying_scan": "yuma_simulation_tpu/ops/pallas_epoch.py:2181",
    }
    sources = {
        "consensus_bisect": "yuma_simulation_tpu_torch/csrc/consensus.cu",
        "case_scan": "yuma_simulation_tpu_torch/csrc/case_scan.cu",
        "varying_scan": "yuma_simulation_tpu_torch/csrc/case_scan.cu",
    }
    measured = {"consensus_bisect": k1, **scans}
    kernels = []
    for name in ("consensus_bisect", "case_scan", "varying_scan"):
        m = measured[name]
        assert launches[name] > 0, (name, launches)
        kernels.append(dict(
            name=name, route="cuda", source=sources[name], replaces=replaces[name],
            launches=launches[name], max_abs_err=m["max_abs_err"], ms=m["ms"],
            plain_ms=m["plain_ms"], bound_ms=m["bound_ms"], bound_by=m["bound_by"],
            library_ms=None,
        ))
    report["kernels"] = kernels
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

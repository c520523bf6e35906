#!/usr/bin/env python3
"""Time the port's kernels with the tiling constants of their CUDA sources
changed, against the committed ones, on one NVIDIA GPU.

    python3 scripts/torch_phase_variants.py [--group all|phases|scan|bisect] [--out DIR]

Run from the repo root. Each variant is `csrc/` with a few constants
replaced: in `scan_phases.cuh` the bond phase's warps per block and
validators per thread in registers, and the row sum's rows per block,
columns per ring stage and ring depth (group "phases"); the rank phase's
warps per block and rows loaded at once, the dividend normalization's
tiles a group, launches without programmatic dependence, and probes that
leave a piece out to time it (their results are wrong on purpose and not
checked) (group "scan"); in `common.cuh` the consensus bisection's
layout: K1's miners per block, warps and validators per warp in
registers, K1's 16- against 4-byte loads, and K4's register cap (group
"bisect"). Every variant of the chosen group (default all) is built with
the package's nvcc flags, one process per source, all at once. Then each
variant's K2, K3 and K5 (and K5 with
the tensor-core support) at 256 x 4096 x 64 epochs and K6 chained over 16
epochs (one slab a launch) are held to the committed build's for the
five bond models of chip_smoke.py (K6 for its EMA-family ones; consensus
and incentives bitwise, the rest within atol 2e-6 / rtol 1e-5), timed by
CUDA events in three rounds of alternating order, and profiled by phase
kernel (chip_smoke.phase_profile); with the bisection's variants, K1 and
K4 alone are held bitwise to the committed build at one slab [256, 4096]
and at 16 slabs [16, 256, 4096] and their device ms taken from the
profiler in the same three rounds.
Prints one JSON line per variant and writes `variants.json` under DIR
(default build/phase_variants). Exits non-zero without CUDA or on any
mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES, COMMON = "scan_phases.cuh", "common.cuh"
#: name -> [(file in csrc/, text in the committed file, its replacement)]
VARIANTS = {
    "committed": [],
    "bond 8 warps x 32 validators": [
        (PHASES, "kBondWarps = 32;", "kBondWarps = 8;"),
        (PHASES, "kBondCache = 8;", "kBondCache = 32;")],
    "bond 16 warps x 16 validators": [
        (PHASES, "kBondWarps = 32;", "kBondWarps = 16;"),
        (PHASES, "kBondCache = 8;", "kBondCache = 16;")],
    "rowsum 128 columns x 8 stages": [
        (PHASES, "kSumCols = 256;", "kSumCols = 128;"),
        (PHASES, "kSumStages = 4;", "kSumStages = 8;")],
    "rowsum 4 rows": [(PHASES, "kSumRows = 8;", "kSumRows = 4;")],
    "bisect 8 warps x 32 validators": [
        (COMMON, "kBisectRows = 16;", "kBisectRows = 8;"),
        (COMMON, "kBisectWarps = 4;", "kBisectWarps = 8;")],
    "bisect 16 warps x 16 validators": [
        (COMMON, "kBisectRows = 16;", "kBisectRows = 4;"),
        (COMMON, "kBisectWarps = 4;", "kBisectWarps = 16;")],
    "bisect 32 warps x 8 validators": [
        (COMMON, "kBisectRows = 16;", "kBisectRows = 2;"),
        (COMMON, "kBisectWarps = 4;", "kBisectWarps = 32;")],
    "bisect 2 warps x 128 validators": [
        (COMMON, "kBisectRows = 16;", "kBisectRows = 32;"),
        (COMMON, "kBisectWarps = 4;", "kBisectWarps = 2;")],
    "bisect 64 miners, 8 warps x 32 validators": [
        (COMMON, "kBisectTM = 32;", "kBisectTM = 64;"),
        (COMMON, "kBisectWarps = 4;", "kBisectWarps = 8;")],
    "bisect 64 miners, 4 warps x 64 validators": [
        (COMMON, "kBisectTM = 32;", "kBisectTM = 64;"),
        (COMMON, "kBisectRows = 16;", "kBisectRows = 32;")],
    "bisect 4-byte first loads": [
        (COMMON, "kBisectVecLoads = true;", "kBisectVecLoads = false;")],
    "mma no register cap": [(COMMON, "kMmaMinBlocks = 4;", "kMmaMinBlocks = 1;")],
    "rank 32 warps at any slab count": [
        (PHASES, "kRankWarpsMany = 8;", "kRankWarpsMany = 32;")],
    "rank 8 warps at any slab count": [
        (PHASES, "kRankWarpsFew = 32;", "kRankWarpsFew = 8;")],
    "rank 16 warps for many slabs": [
        (PHASES, "kRankWarpsMany = 8;", "kRankWarpsMany = 16;")],
    "rank 16 rows at once": [(PHASES, "kRankCache = 8;", "kRankCache = 16;")],
    "launch without programmatic dependence": [
        (COMMON, "kProgrammaticLaunch = true;", "kProgrammaticLaunch = false;")],
    "dividends 8 tiles a group": [(PHASES, "kDnormGroup = 16;", "kDnormGroup = 8;")],
    "dividends 32 tiles a group": [(PHASES, "kDnormGroup = 16;", "kDnormGroup = 32;")],
    # Probes: wrong results on purpose (never checked), to time a piece.
    "probe: no phase 8": [
        (PHASES, "    dividends_alone(a, t - 1, e - 1, ntiles, sh);\n    return;", "    return;"),
        (PHASES, "  if (last) dividends_last(a, t, e, ntiles, prev, sh);\n", "")],
    "probe: no tickets": [
        (PHASES, "int members, BondShared& sh) {\n", "int members, BondShared& sh) {\n  return false;\n")],
    "probe: no fences": [
        (PHASES, "    __threadfence();\n    sh.last", "    sh.last"),
        (PHASES, "if (sh.last) __threadfence();", "")],
}
SOURCES = ("consensus.cu", "case_scan.cu", "ema_scan.cu")
#: Header constants that size the wrappers' scratch, and their mirrors in
#: ops/cuda_epoch.py, set to the variant's value while it runs.
MIRRORS = {"kDnormGroup": "DIVIDEND_GROUP"}


def group_of(name: str) -> str:
    if name.startswith(("rank", "dividends", "launch", "probe")):
        return "scan"
    return "bisect" if COMMON in {f for f, _, _ in VARIANTS[name]} else "phases"


def build(out_dir: str, names: list) -> dict:
    """{variant: {source: loaded library}} for the variants `names`."""
    from yuma_simulation_tpu_torch.ops import _build

    procs = []
    for i, name in enumerate(names):
        src_dir = os.path.join(out_dir, f"v{i}", "csrc")
        shutil.rmtree(src_dir, ignore_errors=True)
        shutil.copytree(str(_build.CSRC), src_dir)
        for fname, old, new in VARIANTS[name]:
            path = os.path.join(src_dir, fname)
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} not found once in {fname}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        for src in SOURCES:
            lib = os.path.join(src_dir, src.replace(".cu", ".so"))
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", src_dir, "-o", lib,
                   os.path.join(src_dir, src)]
            procs.append((name, src, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs: dict = {}
    for name, src, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} {src} failed:\n{log}")
        libs.setdefault(name, {})[src] = ctypes.CDLL(lib)
    return libs


def use(libs: dict, name: str) -> None:
    """Make the wrappers launch variant `name`'s kernels, with the
    wrappers' mirrors of the constants it changes."""
    import re

    from yuma_simulation_tpu_torch.ops import _build, cuda_epoch

    _build.load("consensus.cu")  # builds and registers every committed source first
    for src, lib in libs[name].items():
        _build._libs[_build.memo_key(src)] = lib
    header = (_build.CSRC / PHASES).read_text()
    for const, mirror in MIRRORS.items():
        value = re.search(r"%s = (\d+);" % const, header).group(1)
        for _, _, new in VARIANTS[name]:
            found = re.search(r"%s = (\d+);" % const, new)
            value = found.group(1) if found else value
        setattr(cuda_epoch, mirror, int(value))
    cuda_epoch._scratch_layout.cache_clear()


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--group", choices=("all", "phases", "scan", "bisect"), default="all")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "phase_variants"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_phase_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from yuma_simulation_tpu_torch.models.config import YumaConfig, YumaParams
    from yuma_simulation_tpu_torch.models.variants import variant_for_version
    from yuma_simulation_tpu_torch.ops.cuda_consensus import stake_weighted_median_cuda
    from yuma_simulation_tpu_torch.models.epoch import EMA_MODES, BondsMode
    from yuma_simulation_tpu_torch.ops.cuda_epoch import (
        fused_case_scan, fused_ema_epoch, fused_ema_scan, fused_varying_scan)
    from yuma_simulation_tpu_torch.simulation.engine import fused_hparams

    os.makedirs(args.out, exist_ok=True)
    cs.OUT_DIR = args.out
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    names = [n for n in VARIANTS
             if n == "committed" or args.group in ("all", group_of(n))]
    t0 = time.perf_counter()
    libs = build(args.out, names)
    print(f"card: {smi}; built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda")
    W_np, S_np, quiet = cs.workload(0, cs.E)
    W, S = torch.tensor(W_np, device=dev), torch.tensor(S_np, device=dev)
    W1, S1 = W[0].contiguous(), (S[0] / S[0].sum()).contiguous()
    sc = (1.0 + 1e-7 * torch.arange(cs.E, dtype=torch.float32, device=dev)).contiguous()
    Wb = W[:4].contiguous()
    Sb = (S[:4] / S[:4].sum(-1, keepdim=True)).contiguous()
    floats = sc[:16].tolist()

    def k6_chain(mode=BondsMode.EMA, x64=False, kappa=0.5, bond_penalty=1.0, bond_alpha=0.1, **_):
        """K6 over 16 epochs of W1 * scales[e], each on the bonds before."""
        if mode not in EMA_MODES:
            return {}
        bonds, D_n = torch.zeros_like(W1), None
        for e in range(16):
            bonds, D_n, _ = fused_ema_epoch(
                W1, S1, bonds, w_scale=floats[e], first_epoch=e == 0, mode=mode,
                x64=x64, kappa=kappa, bond_penalty=bond_penalty, bond_alpha=bond_alpha)
        return {"bonds": bonds, "D_n": D_n}

    runs = {
        "K3": lambda **kw: fused_varying_scan(W, S, epoch_tile=16, **kw),
        "K2": lambda **kw: fused_case_scan(W, S, **kw),
        "K5": lambda **kw: dict(zip(("bonds", "totals"), fused_ema_scan(W1, S1, sc, **kw))),
        "K5 mxu": lambda **kw: dict(zip(("bonds", "totals"),
                                        fused_ema_scan(W1, S1, sc, mxu=True, **kw))),
        "K5 B=4": lambda **kw: dict(zip(("bonds", "totals"), fused_ema_scan(Wb, Sb, sc, **kw))),
        "K6 x16": lambda **kw: k6_chain(**kw),
    }
    # K1 and K4 alone: one slab (K2's and K6's phase 4) and 16 (K3's, K5's).
    Wn16 = (W[:16] / (W[:16].sum(-1, keepdim=True) + 1e-6)).contiguous()
    Sn16 = (S[:16] / S[:16].sum(-1, keepdim=True)).contiguous()
    # With one halving (precision 2) as well: the difference is the time of
    # 16 halvings, the rest the launch and the first loads.
    alone = {} if args.group not in ("all", "bisect") else {
        f"{label} x{n}" + ("" if p == 100_000 else " 1 halving"): (
            kernel, lambda n=n, mma=mma, p=p: stake_weighted_median_cuda(
                Wn16[0] if n == 1 else Wn16, Sn16[0] if n == 1 else Sn16, 0.5, p, mma=mma))
        for label, kernel, mma in (("K1", "k_bisect", False), ("K4", "k_bisect_mma", True))
        for n in (1, 16) for p in (100_000, 2)
    }

    ref = {}
    for name in libs:
        use(libs, name)
        for version, params in cs.VERSIONS:
            spec = variant_for_version(version)
            kw = dict(mode=spec.bonds_mode, x64=spec.bonds_mode.value == "ema_rust",
                      **fused_hparams(YumaConfig(yuma_params=YumaParams(**params))))
            scan_kw = dict(kw, reset_index=quiet, reset_epoch=cs.E // 2,
                           reset_mode=spec.reset_mode, save_consensus=True)
            for kernel, run in runs.items():
                out = run(**(kw if kernel.startswith(("K5", "K6")) else scan_kw))
                torch.cuda.synchronize()
                if name == "committed":
                    ref[version, kernel] = out
                    continue
                if name.startswith("probe"):
                    continue
                for key, got in out.items():
                    want = ref[version, kernel][key]
                    if key in ("consensus", "incentives"):
                        cs.check_equal(f"{name} {kernel} {version} {key}", got, want)
                    else:
                        cs.check_close(f"{name} {kernel} {version} {key}", got, want)
        for label, (_, run) in alone.items():
            got = run()
            torch.cuda.synchronize()
            if name == "committed":
                ref[label] = got
            elif not name.startswith("probe"):
                cs.check_equal(f"{name} {label} c_high", got, ref[label])
    del ref

    quiet_kw = dict(save_bonds=False, save_incentives=False)
    times: dict = {name: {k: [] for k in runs} for name in libs}
    device: dict = {name: {k: [] for k in alone} for name in libs}
    order = list(libs)
    for rnd in range(3):
        for name in order if rnd % 2 == 0 else order[::-1]:
            use(libs, name)
            for kernel, run in runs.items():
                kw = {} if kernel.startswith(("K5", "K6")) else quiet_kw
                times[name][kernel].append(cs.cuda_ms(torch, lambda: run(**kw), 5))
            for label, (kernel, run) in alone.items():
                device[name][label].append(cs.kernel_device_ms(torch, run, kernel, 20))
    report = {"card": smi, "shape": [cs.E, cs.V, cs.M], "variants": {}}
    for name in libs:
        use(libs, name)
        phases = cs.phase_profile(torch, smi, [
            (kernel, lambda run=run, kernel=kernel: run(
                **({} if kernel.startswith(("K5", "K6")) else quiet_kw)))
            for kernel, run in runs.items()
        ])
        rec = dict(
            substitutions=VARIANTS[name],
            median_ms={k: float(np.median(v)) for k, v in times[name].items()},
            ms=times[name],
            alone_device_ms={k: float(np.median(v)) for k, v in device[name].items()},
            alone_device_ms_rounds=device[name],
            phases_ms=phases,
        )
        report["variants"][name] = rec
        print(json.dumps({
            "variant": name, "median_ms": rec["median_ms"],
            "alone_device_ms": rec["alone_device_ms"],
            "k_bisect_ms": {k: p.get("k_bisect", p.get("k_bisect_mma")) for k, p in phases.items()},
            "k_bond_ms": {k: p.get("k_bond") for k, p in phases.items()},
            "k_rowsum_ms": {k: p.get("k_rowsum") for k, p in phases.items()},
            "k_rank_ms": {k: p.get("k_rank") for k, p in phases.items()},
        }), flush=True)
    with open(os.path.join(args.out, "variants.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

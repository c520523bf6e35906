#!/usr/bin/env python3
"""Which launches a torch.profiler window keeps, on one NVIDIA GPU.

    python3 scripts/torch_profiler_windows.py [--calls N] [--out FILE]

`chip_smoke.py::kernel_device_ms` times K1 (`k_bisect`) and K4
(`k_bisect_mma`) from torch.profiler windows, and K4's windows lose their
first launches. This opens windows of N calls of each wrapper at one
[256, 4096] slab of chip_smoke.py's workload and reports, per window, what
`chip_smoke.window_stats` reads (launches kept, the host time the lost
ones took, `lead_us`) and the host ms of each of the first 6 calls,
under four openings:

- `none`: the calls straight after the profiler starts;
- `sync`: one uncounted call and a synchronize first;
- `sleep20`, `sleep100`: a 20 or 100 ms host sleep first, no launch.

Each opening runs twice, K1 and K4 in turns. Prints one JSON line and
writes it to FILE (default build/profiler_windows.json). Exits non-zero
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def window(torch, fn, kernel: str, calls: int, opening: str) -> dict:
    """One window of `calls` calls of `fn` after `opening`."""
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if opening == "sync":
            fn()
            torch.cuda.synchronize()
        elif opening.startswith("sleep"):
            time.sleep(int(opening[5:]) / 1e3)
        for _ in range(calls):
            with record_function("window_call"):
                fn()
        torch.cuda.synchronize()
    spans, marks = [], []
    for evt in prof.events():
        if evt.device_type == DeviceType.CPU and evt.name == "window_call":
            marks.append((evt.time_range.start, evt.time_range.end))
            continue
        found = re.search(r"\bk_[a-z_]+", evt.name)
        if evt.device_type == DeviceType.CUDA and found and found.group(0) == kernel:
            spans.append((evt.time_range.start, evt.time_range.end))
    marks.sort()
    spans.sort()
    if opening == "sync" and len(spans) > calls:
        spans = spans[1:]  # the opening call's kernel
    out = cs.window_stats(kernel, [m[0] for m in marks], spans)
    out["opening"] = opening
    out["first_calls_ms"] = [round((end - start) / 1e3, 3) for start, end in marks[:6]]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=25)
    ap.add_argument("--out", default=os.path.join("build", "profiler_windows.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_profiler_windows: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from yuma_simulation_tpu_torch.ops import _build
    from yuma_simulation_tpu_torch.ops.cuda_consensus import stake_weighted_median_cuda

    for src in _build.SOURCES:
        _build.load(src)
    W_np, S_np, _ = cs.workload(0, 1)
    W = torch.tensor(W_np[0], device="cuda")
    S = torch.tensor(S_np[0], device="cuda")
    Wn = (W / (W.sum(-1, keepdim=True) + 1e-6)).contiguous()
    Sn = (S / S.sum()).contiguous()
    kernels = {
        "k_bisect": lambda: stake_weighted_median_cuda(Wn, Sn, 0.5, mma=False),
        "k_bisect_mma": lambda: stake_weighted_median_cuda(Wn, Sn, 0.5, mma=True),
    }
    for fn in kernels.values():
        fn()
    rows = []
    for _ in range(2):
        for opening in ("none", "sync", "sleep20", "sleep100"):
            for kernel, fn in kernels.items():
                rows.append(window(torch, fn, kernel, args.calls, opening))
                print(json.dumps(rows[-1]), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

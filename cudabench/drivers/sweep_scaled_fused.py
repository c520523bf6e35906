"""A hyperparameter grid over the scaled run: `simulation/sweep.py::
sweep_scaled_fused`, the whole grid a call.

The grid is the cartesian product of the mix's `grid` (field name ->
values, as `config_grid` takes them) over the configuration's
hyperparameters; every point runs `epochs` epochs of `W * (1 + 1e-7 e)` on
the snapshot made from the seed (K5 with the grid as its lanes on the
card). A call ends with the total dividends `[G, V]` and final bonds
`[G, V, M]` on the host. Every call runs the same grid: the reference runs
once for `check_points` points drawn from the seed, and every call's
answers at those points are compared with it.

Parameters: `epochs`, `grid`, `check_points`.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np

from cudabench.core.program import yuma_config
from cudabench.core.snapshot import synthetic_snapshot
from cudabench.reference import yuma as reference

#: The per-epoch weight scale of the scaled workload.
SCALE_STEP = 1e-7


def setup(ctx):
    from yuma_simulation_tpu_torch.simulation.sweep import config_grid, sweep_scaled_fused

    torch, cfg, p = ctx.torch, ctx.config, ctx.params
    V, M, E = cfg["num_validators"], cfg["num_miners"], int(p["epochs"])
    W, S = synthetic_snapshot(ctx.seed, num_validators=V, num_miners=M,
                              **cfg["snapshot"])
    scales = 1 + SCALE_STEP * torch.arange(E, dtype=torch.float32)
    base = yuma_config(cfg)
    grid, points = config_grid(base.simulation, base.yuma_params, **p["grid"])
    rng = np.random.default_rng([ctx.seed, 0x6A1D])
    state = SimpleNamespace(
        torch=torch, device=ctx.device, W=W, S=S, scales=scales, E=E, V=V, M=M, config=cfg,
        points=points, grid=grid, run=sweep_scaled_fused,
        checked=sorted(rng.choice(len(points), size=min(int(p["check_points"]), len(points)),
                                  replace=False).tolist()),
        Wd=torch.from_numpy(W).to(ctx.device), Sd=torch.from_numpy(S).to(ctx.device),
        scales_d=scales.to(ctx.device),
    )
    call(state, 0)  # warm-up: builds or loads the kernels
    return state


def call(state, i: int):
    total, bonds = state.run(state.Wd, state.Sd, state.scales_d, state.grid,
                             state.config["yuma_version"])
    return total.cpu().numpy(), bonds.cpu().numpy()


def shape(state) -> dict:
    return {"scenarios": len(state.points), "epochs": state.E, "validators": state.V,
            "miners": state.M}


def release(state) -> None:
    state.Wd = state.Sd = state.scales_d = state.run = None


def check(state, outputs, control=None) -> dict:
    """Per call and checked point: the largest gap of the total dividends
    and of the final bonds from the reference's, each as a share of the
    reference's largest."""
    torch = state.torch
    W = torch.from_numpy(state.W).to(state.device)
    S = torch.from_numpy(state.S).to(state.device)
    scales = state.scales.to(state.device)
    base = reference.params_of(state.config)
    div, bond = [], []
    for g in state.checked:
        params = dataclasses.replace(base, **state.points[g])

        def ref(dtype):
            total, bonds = reference.scaled_run(W, S, scales, params, dtype)
            return total.double().cpu().numpy(), bonds.float().cpu().numpy()

        want_total, want_bonds = ref(torch.float32)
        got = ref(control) if control is not None else None
        for i, (total, bonds) in enumerate(outputs):
            t, b = got if got is not None else (total[g], bonds[g])
            div.append((i, float(np.abs(t - want_total).max() / np.abs(want_total).max())))
            bond.append((i, float(np.abs(b - want_bonds).max() / np.abs(want_bonds).max())))
    return {"div_gap": div, "bond_gap": bond}



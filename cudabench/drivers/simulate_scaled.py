"""The long-horizon scaled run: `simulation/engine.py::simulate_scaled`,
one `epochs`-epoch study a call.

Epoch `e` simulates `W * (1 + 1e-7 e)` on the snapshot's weights and
stakes made from the seed: the scale generator of the JAX package's
`bench.py` and `chip_smoke.py`'s scaled path, which row normalization all
but divides out while every epoch does its full work. The weights,
stakes and scales are uploaded in set-up; a call ends with the total
dividends `[V]` and the final bonds `[V, M]` on the host. Every call runs
the same study, so the reference runs once and every call's answers are
compared with it.

Parameters: `epochs`.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from cudabench.core.program import yuma_config
from cudabench.core.snapshot import synthetic_snapshot
from cudabench.reference import yuma as reference

#: The per-epoch weight scale of the scaled workload.
SCALE_STEP = 1e-7


def setup(ctx):
    from yuma_simulation_tpu_torch.models.variants import variant_for_version
    from yuma_simulation_tpu_torch.simulation.engine import simulate_scaled

    torch, cfg = ctx.torch, ctx.config
    V, M = cfg["num_validators"], cfg["num_miners"]
    W, S = synthetic_snapshot(ctx.seed, num_validators=V, num_miners=M,
                              **cfg["snapshot"])
    E = int(ctx.params["epochs"])
    scales = 1 + SCALE_STEP * torch.arange(E, dtype=torch.float32)
    state = SimpleNamespace(
        torch=torch, device=ctx.device, W=W, S=S, scales=scales, config=cfg, E=E,
        Wd=torch.from_numpy(W).to(ctx.device), Sd=torch.from_numpy(S).to(ctx.device),
        scales_d=scales.to(ctx.device), run=simulate_scaled,
        yuma_config=yuma_config(cfg),
        spec=variant_for_version(cfg["yuma_version"]),
    )
    call(state, 0)  # warm-up: builds or loads the kernels
    return state


def call(state, i: int):
    total, bonds = state.run(state.Wd, state.Sd, state.scales_d, state.yuma_config, state.spec)
    return total.cpu().numpy(), bonds.cpu().numpy()


def shape(state) -> dict:
    V, M = state.W.shape
    return {"scenarios": 1, "epochs": state.E, "validators": V, "miners": M}


def release(state) -> None:
    state.Wd = state.Sd = state.scales_d = state.run = None


def check(state, outputs, control=None) -> dict:
    """Per call: the largest gap of the total dividends and of the final
    bonds from the reference's, each as a share of the reference's largest."""
    torch = state.torch
    params = reference.params_of(state.config)
    W = torch.from_numpy(state.W).to(state.device)
    S = torch.from_numpy(state.S).to(state.device)
    scales = state.scales.to(state.device)

    def ref(dtype):
        total, bonds = reference.scaled_run(W, S, scales, params, dtype)
        return total.double().cpu().numpy(), bonds.float().cpu().numpy()

    want_total, want_bonds = ref(torch.float32)
    if control is not None:
        outputs = [ref(control)] * len(outputs)
    div, bond = [], []
    for i, (total, bonds) in enumerate(outputs):
        div.append((i, float(np.abs(total - want_total).max() / np.abs(want_total).max())))
        bond.append((i, float(np.abs(bonds - want_bonds).max() / np.abs(want_bonds).max())))
    return {"div_gap": div, "bond_gap": bond}

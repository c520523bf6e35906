"""The main path: `simulation/engine.py::simulate` on one scenario with
per-epoch weights, its per-epoch dividends and bonds returned.

The scenario (`epochs` epochs of a subnet whose weights and stakes drift
every epoch, made from the seed by `core/snapshot.py::epoch_workload`) is
built on the host in set-up, as a user holds it; every call hands it to
`simulate`, which copies it to the card, runs the planner's rung and
copies the dividends `[E, V]` and bonds `[E, V, M]` back. Every call runs
the same scenario: the reference runs once; every call's dividends are
compared with it, and the bonds of `check_calls` calls drawn from the seed
(the others' bonds are dropped as they come, to bound the host's memory).

Parameters: `epochs`, `check_calls`.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from cudabench.core.program import yuma_config
from cudabench.core.snapshot import epoch_workload
from cudabench.reference import yuma as reference


def setup(ctx):
    from yuma_simulation_tpu_torch.scenarios.base import Scenario
    from yuma_simulation_tpu_torch.simulation.engine import simulate

    cfg, p = ctx.config, ctx.params
    V, M, E = cfg["num_validators"], cfg["num_miners"], int(p["epochs"])
    W, S = epoch_workload(ctx.seed, E, num_validators=V, num_miners=M,
                          nnz_per_row=cfg["snapshot"]["nnz_per_row"])
    names = [f"v{v}" for v in range(V)]
    rng = np.random.default_rng([ctx.seed, 0xB0D5])
    state = SimpleNamespace(
        torch=ctx.torch, device=ctx.device, W=W, S=S, E=E, V=V, M=M, config=cfg,
        scenario=Scenario(name="cudabench", validators=names, base_validator=names[0],
                          weights=W, stakes=S, num_epochs=E,
                          servers=[f"m{m}" for m in range(M)]),
        yuma_config=yuma_config(cfg),
        bonds_of=set(), rng=rng, check_calls=int(p["check_calls"]), run=simulate,
    )
    call(state, -1)  # warm-up: builds or loads the kernels
    return state


def call(state, i: int):
    result = state.run(state.scenario, state.config["yuma_version"], state.yuma_config,
                       save_bonds=True, device=state.device)
    if len(state.bonds_of) < state.check_calls and i >= 0 and state.rng.random() < 0.5:
        state.bonds_of.add(i)
        return result.dividends, result.bonds
    return result.dividends, None


def shape(state) -> dict:
    return {"scenarios": 1, "epochs": state.E, "validators": state.V, "miners": state.M}


def release(state) -> None:
    state.run = None


def check(state, outputs, control=None) -> dict:
    """Per call: the largest gap of the per-epoch dividends and (where kept)
    of the per-epoch bonds from the reference's, each as a share of the
    reference's largest."""
    torch = state.torch
    params = reference.params_of(state.config)
    W = torch.from_numpy(state.W).to(state.device)
    S = torch.from_numpy(state.S).to(state.device)

    def ref(dtype):
        div, bonds = reference.epoch_run(W, S, params, dtype)
        return div.float().cpu().numpy(), bonds.float().cpu().numpy()

    want_div, want_bonds = ref(torch.float32)
    if control is not None:
        got = ref(control)
        outputs = [(got[0], got[1] if b is not None else None) for _, b in outputs]
    div, bond = [], []
    for i, (d, b) in enumerate(outputs):
        div.append((i, float(np.abs(d - want_div).max() / np.abs(want_div).max())))
        if b is not None:
            bond.append((i, float(np.abs(b - want_bonds).max() / np.abs(want_bonds).max())))
    return {"div_gap": div, "bond_gap": bond}

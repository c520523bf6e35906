"""The per-epoch Monte-Carlo study: `parallel/sharded.py::
montecarlo_per_epoch_batched`, one study a call.

Each call is one study of the configuration's `num_scenarios` scenarios
over `epochs` epochs, every scenario drawing fresh weights `relu(base + perturbation * normal)` each
epoch from its key, on the snapshot's base weights and stakes made from the
seed. Call `i` takes its own key from `(seed, i)`, so no two calls repeat
a study. The base is uploaded in set-up; a call ends with the `[B, V]`
total dividends on the host. The planner picks the chunk length, as a user
leaves it.

Parameters: `epochs`, `perturbation`, `check_rows` (how many scenario
lanes of the batch are compared with the reference: each lane at most
once, from a call of the window drawn from the seed).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from cudabench.core.program import yuma_config
from cudabench.core.snapshot import synthetic_snapshot
from cudabench.reference import yuma as reference


#: The index of the warm-up call's key, which no call of a window reaches.
WARMUP_CALL = 2**32
#: Scenarios the reference advances together in the check.
CHECK_BLOCK = 64


def call_key(seed: int, i: int) -> np.ndarray:
    """The key of call `i`: two 32-bit words drawn from `(seed, i)`."""
    words = np.random.default_rng([seed, i]).integers(0, 2**32, 2, dtype=np.uint64)
    return words.astype(np.int64)


def setup(ctx):
    cfg, p = ctx.config, ctx.params
    V, M = cfg["num_validators"], cfg["num_miners"]
    W, S = synthetic_snapshot(ctx.seed, num_validators=V, num_miners=M,
                              **cfg["snapshot"])
    state = SimpleNamespace(
        torch=ctx.torch, device=ctx.device, seed=ctx.seed, W=W, S=S, V=V, M=M,
        B=int(cfg["num_scenarios"]), E=int(p["epochs"]),
        perturbation=float(p["perturbation"]), check_rows=int(p["check_rows"]),
        version=cfg["yuma_version"], config=cfg, yuma_config=yuma_config(cfg),
        Wd=ctx.torch.from_numpy(W).to(ctx.device), Sd=ctx.torch.from_numpy(S).to(ctx.device),
    )
    from yuma_simulation_tpu_torch.parallel.sharded import montecarlo_per_epoch_batched

    state.run = montecarlo_per_epoch_batched
    call(state, WARMUP_CALL)  # builds or loads the kernels, sizes the slabs
    return state


def call(state, i: int) -> np.ndarray:
    return state.run(
        call_key(state.seed, i), state.B, state.E, state.V, state.M, state.version,
        state.yuma_config, base_weights=state.Wd, base_stakes=state.Sd,
        perturbation=state.perturbation, device=state.device,
    )


def shape(state) -> dict:
    return {"scenarios": state.B, "epochs": state.E, "validators": state.V, "miners": state.M}


def release(state) -> None:
    state.Wd = state.Sd = state.run = None


def check(state, outputs, control=None) -> dict:
    """The largest gap, over validators, between a scenario's total
    dividends and the reference's, as a share of the reference's largest;
    for `check_rows` lanes of the batch (all of them where it is the batch),
    each from a call of the window drawn from the seed, computed together on
    the device in blocks of rows."""
    torch = state.torch
    rng = np.random.default_rng([state.seed, 0x5EED])
    rows = rng.permutation(state.B)[:min(state.check_rows, state.B)]
    calls = rng.integers(0, len(outputs), size=len(rows))
    keys = torch.tensor(np.stack([call_key(state.seed, int(c)) for c in calls]),
                        device=state.device)
    W = torch.from_numpy(state.W).to(state.device)
    S = torch.from_numpy(state.S).to(state.device)
    params = reference.params_of(state.config)

    def ref(dtype, lo, hi):
        return reference.montecarlo_totals(
            keys[lo:hi], state.B, rows[lo:hi], state.E, W, S, state.perturbation, params, dtype,
        ).double().cpu().numpy()

    gaps = []
    for lo in range(0, len(rows), CHECK_BLOCK):
        hi = min(lo + CHECK_BLOCK, len(rows))
        want = ref(torch.float32, lo, hi)
        if control is None:
            got = np.stack([outputs[int(c)][int(b)] for c, b in zip(calls[lo:hi], rows[lo:hi])])
        else:
            got = ref(control, lo, hi)
        gap = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
        gaps += [(int(c), float(g)) for c, g in zip(calls[lo:hi], gap)]
    return {"div_gap": gaps}

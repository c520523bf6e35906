"""The benchmark's subnets, made from the seed: a synthetic metagraph
snapshot, and a subnet whose weights and stakes change every epoch.

Frozen copy of `yuma_simulation_tpu_torch/foundry/metagraph.py::
synthetic_snapshot` at commit b289c29 (the JAX package's generator of the
same name, draw for draw): heavy-tailed lognormal stakes, a shared
Gamma miner-quality vector that every validator's row follows with its own
noise, and `nnz_per_row` miners a row sampled by quality. Seeded numpy, so
the same seed gives the same subnet on every machine.
"""

from __future__ import annotations

import numpy as np


def synthetic_snapshot(seed: int, *, num_validators: int, num_miners: int, nnz_per_row: int,
                       stake_tail: float, consensus_sharpness: float):
    """`(weights [V, M] float32, rows summing to 1, stakes [V] float32)`."""
    rng = np.random.default_rng(seed)
    stakes = rng.lognormal(mean=0.0, sigma=stake_tail, size=num_validators).astype(np.float32)
    quality = rng.gamma(1.0 / consensus_sharpness, size=num_miners).astype(np.float64)
    quality /= quality.sum()
    W = np.zeros((num_validators, num_miners), np.float32)
    nnz = min(nnz_per_row, num_miners)
    for v in range(num_validators):
        chosen = rng.choice(num_miners, size=nnz, replace=False, p=quality)
        row = quality[chosen] * rng.lognormal(mean=0.0, sigma=0.35, size=nnz)
        W[v, chosen] = (row / row.sum()).astype(np.float32)
    return W, stakes


def epoch_workload(seed: int, num_epochs: int, *, num_validators: int, num_miners: int,
                   nnz_per_row: int, strong: int = 64):
    """Per-epoch weights `[E, V, M]` and stakes `[E, V]` of a subnet that
    drifts: frozen copy of `chip_smoke.py::workload` at commit b289c29.
    Lognormal stakes (sigma 1.2) drifting every epoch; a miner-quality
    vector with `strong` miners and a tail 10^4 times lighter; each row
    touching `nnz_per_row` miners sampled by quality without replacement
    (Gumbel top-k) and re-noised every epoch."""
    V, M, E, nnz = num_validators, num_miners, num_epochs, nnz_per_row
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
    return W, S

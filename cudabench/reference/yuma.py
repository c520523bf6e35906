"""The plain reference: the Yuma epoch in a few dozen PyTorch operations.

Written from the published reference implementation's epoch functions
(github.com/DarnoX-reef/yuma-simulation, `yumas.py`, and their
liquid-alpha branch), batched over a leading scenario axis, in one dtype
throughout. The bonds model is a file of `bonds/`, named by the
configuration (`ema`: `Yuma`, Yuma 1; `relative`: `Yuma4`). It imports nothing of the program under test. Departures from
that source, none of which changes the mathematics:

- the consensus bisection runs the source's halvings on every miner at
  once (`ceil(log2(precision))` of them, strict comparisons), with the
  stake support summed in the working dtype;
- the quantile of liquid alpha is linear interpolation at `q * (n - 1)`
  (what `torch.quantile` does), written out so that it runs in any dtype.

`dtype` is the precision of every operation of an epoch: float32 for the
reference, bfloat16 for the control. Dividends are summed over epochs in
float64, so that a total over 10,000 epochs carries no rounding of its own
(in float32 a sum of 10,000 like terms drifts by some 1e-4 of itself).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from types import SimpleNamespace

import torch

from cudabench.reference import bonds as bond_models
from cudabench.reference import threefry

#: Operations a `[V, M]` cell costs in one epoch outside the bonds model:
#: the row normalization (the row sum's add, the divide), the consensus
#: bisection (17 halvings of a compare and the support's add), the clip
#: (a min) and the rank (a multiply and an add), and the dividend (a
#: multiply and an add). The per-miner and per-validator work (the
#: quantize, the incentive, liquid alpha's fit, the normalized dividends)
#: is left out: under 1% of the cell's at V = 256. The roofline metrics
#: count an epoch's work from it and the bonds model's `OPS_PER_CELL`.
EPOCH_OPS_PER_CELL = 2 + 17 * 2 + 1 + 2 + 2


@dataclass(frozen=True)
class Params:
    """The hyperparameters of one configuration file (its `simulation`
    and `yuma_params` groups) and the bonds model it names."""

    bonds: str
    kappa: float
    bond_penalty: float
    bond_alpha: float
    alpha_low: float
    alpha_high: float
    liquid_alpha: bool
    precision: int
    total_epoch_emission: float
    validator_emission_ratio: float
    total_subnet_stake: float


def params_of(config: dict) -> Params:
    sim, yp = config["simulation"], config["yuma_params"]
    return Params(
        bonds=config["bonds_model"],
        kappa=sim["kappa"], bond_penalty=sim["bond_penalty"], bond_alpha=yp["bond_alpha"],
        alpha_low=yp["alpha_low"], alpha_high=yp["alpha_high"],
        liquid_alpha=yp["liquid_alpha"], precision=sim["consensus_precision"],
        total_epoch_emission=sim["total_epoch_emission"],
        validator_emission_ratio=sim["validator_emission_ratio"],
        total_subnet_stake=sim["total_subnet_stake"],
    )


def consensus(W_n: torch.Tensor, S_n: torch.Tensor, kappa: float, precision: int):
    """The stake-weighted median of each miner column by bisection: the
    source's `while c_high - c_low > 1 / precision` loop, `[..., M]`."""
    iters = math.ceil(math.log2(precision))
    c_lo = torch.zeros(W_n.shape[:-2] + W_n.shape[-1:], dtype=W_n.dtype, device=W_n.device)
    c_hi = torch.ones_like(c_lo)
    S_col = S_n.unsqueeze(-1)
    for _ in range(iters):
        c_mid = (c_hi + c_lo) / 2
        support = torch.where(W_n > c_mid.unsqueeze(-2), S_col, 0).sum(dim=-2)
        above = support > kappa
        c_lo = torch.where(above, c_mid, c_lo)
        c_hi = torch.where(above, c_hi, c_mid)
    return c_hi


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    s = torch.sort(x, dim=-1).values
    p = q * (x.shape[-1] - 1)
    lo, hi = math.floor(p), math.ceil(p)
    w = p - lo
    return s[..., lo] * (1 - w) + s[..., hi] * w


def liquid_rate(C: torch.Tensor, p: Params) -> torch.Tensor:
    """The source's liquid-alpha branch: a logistic fitted between the
    consensus quartiles (the 0.99 quantile where they coincide), clamped to
    `[alpha_low, alpha_high]`; returns the per-miner EMA rate `[..., M]`."""
    c_high = quantile(C, 0.75)
    c_low = quantile(C, 0.25)
    c_high = torch.where(c_high == c_low, quantile(C, 0.99), c_high)
    logit_high = math.log(1 / p.alpha_high - 1)
    logit_low = math.log(1 / p.alpha_low - 1)
    a = (logit_high - logit_low) / (c_low - c_high)
    b = logit_low + a * c_low
    alpha = 1 / (1 + torch.exp(-a.unsqueeze(-1) * C + b.unsqueeze(-1)))
    return 1 - torch.clamp(alpha, p.alpha_low, p.alpha_high)


def epoch(W: torch.Tensor, S: torch.Tensor, B_old, p: Params):
    """One epoch: raw weights `[..., V, M]`, raw stakes `[..., V]` and the
    carried bonds (None on the first epoch). Returns the new bonds and the
    dividend per 1000 tao of each validator `[..., V]`."""
    W_n = W / (W.sum(dim=-1, keepdim=True) + 1e-6)
    S_n = S / S.sum(dim=-1, keepdim=True)
    C = consensus(W_n, S_n, p.kappa, p.precision)
    C = (C / C.sum(dim=-1, keepdim=True) * 65535).int().to(W.dtype) / 65535
    W_c = torch.minimum(W_n, C.unsqueeze(-2))
    S_col = S_n.unsqueeze(-1)
    R = (S_col * W_c).sum(dim=-2)
    incentive = torch.nan_to_num(R / R.sum(dim=-1, keepdim=True))
    rate = liquid_rate(C, p).unsqueeze(-2) if p.liquid_alpha else p.bond_alpha
    q = SimpleNamespace(W_n=W_n, S_n=S_n, C=C, W_c=W_c, incentive=incentive, rate=rate)
    B, D = bond_models.model(p.bonds).step(q, B_old, p)
    D_n = D / (D.sum(dim=-1, keepdim=True) + 1e-6)
    stake_units = S * p.total_subnet_stake / 1000
    emission = p.validator_emission_ratio * D_n * p.total_epoch_emission
    return B, torch.where(stake_units > 1e-6, emission / stake_units, 0)


def montecarlo_totals(keys: torch.Tensor, num_scenarios: int, scenarios, num_epochs: int,
                      base: torch.Tensor, stakes: torch.Tensor, perturbation: float,
                      p: Params, dtype) -> torch.Tensor:
    """Total dividends `[n, V]` of the chosen scenarios of Monte-Carlo
    studies: `keys [n, 2]` are the studies' keys and `scenarios [n]` the
    index of each chosen scenario among a study's `num_scenarios`. Each
    scenario's key is `split(split(key, 1)[0], num_scenarios)[b]`, and its
    epoch `e` weighs `relu(base + perturbation * normal(fold_in(key, e)))`."""
    skeys = torch.stack([
        threefry.split(threefry.split(k, 1)[0], num_scenarios)[int(b)]
        for k, b in zip(keys, scenarios)
    ])
    base32 = base.to(torch.float32)
    S = stakes.to(dtype).expand(len(skeys), -1)
    bonds, total = None, torch.zeros(S.shape, dtype=torch.float64, device=S.device)
    for e in range(num_epochs):
        noise = threefry.normal(threefry.fold_in(skeys, e), tuple(base.shape))
        W = torch.clamp_min(base32 + perturbation * noise, 0).to(dtype)
        bonds, div = epoch(W, S, bonds, p)
        total = total + div.double()
    return total


def scaled_run(W: torch.Tensor, S: torch.Tensor, scales: torch.Tensor, p: Params, dtype):
    """`(total dividends [V], final bonds [V, M])` of epochs `e` on
    `W * scales[e]`."""
    W, S = W.to(dtype), S.to(dtype)
    bonds, total = None, torch.zeros(S.shape, dtype=torch.float64, device=S.device)
    for e in range(len(scales)):
        bonds, div = epoch(W * scales[e].to(dtype), S, bonds, p)
        total = total + div.double()
    return total, bonds


def epoch_run(W: torch.Tensor, S: torch.Tensor, p: Params, dtype):
    """`(dividends [E, V], bonds [E, V, M])` of per-epoch weights `[E, V, M]`
    and stakes `[E, V]`."""
    bonds, divs, saved = None, [], []
    for e in range(W.shape[0]):
        bonds, div = epoch(W[e].to(dtype), S[e].to(dtype), bonds, p)
        divs.append(div)
        saved.append(bonds)
    return torch.stack(divs), torch.stack(saved)

"""The unified Yuma epoch: one function, a bonds-model switch.

The reference implements five near-identical epoch functions (reference
yumas.py:61-606). The shared pipeline —

    row-normalize W -> normalize S -> prerank -> bisection consensus ->
    u16 quantization -> clip -> rank / incentive / trust

— is written once, and the five bonds models hang off :class:`BondsMode`.
Inputs may carry leading batch dimensions (`W [..., V, M]`, `S [..., V]`):
every reduction names its axis from the end, so a scenario suite runs as
one call per epoch.

Parity-critical details reproduced from the reference: epsilon placement,
u16 truncation, the float64 quantization divide of Yuma 0 (`x64=True`),
strict bisection comparisons, `nan_to_num` placement, the first-epoch EMA
adoption, and Yuma 3's `2^64 - 1` capacity constant entering float32
arithmetic.
"""

from __future__ import annotations

import enum
from typing import Optional

import torch

from yuma_simulation_tpu_torch.models.config import YumaConfig
from yuma_simulation_tpu_torch.ops.consensus import (
    bisection_iterations,
    quantize_u16,
    stake_weighted_median,
    stake_weighted_median_sorted,
)
from yuma_simulation_tpu_torch.ops.fma import fma, fma_chain
from yuma_simulation_tpu_torch.ops.liquid import liquid_alpha_rate
from yuma_simulation_tpu_torch.ops.normalize import (
    EMA_FOLD_VALIDATORS,
    FOLD_VALIDATORS,
    ema_blend,
    fold_sum,
    miner_sum,
    normalize_stake,
    normalize_weight_rows,
    rank_sum,
    sequential_sum,
    validator_dot,
    validator_sum,
    xla_chains,
)

MAXINT = float(2**64 - 1)


class BondsMode(enum.Enum):
    """The five bonds models behind the nine named versions."""

    EMA_RUST = "ema_rust"  # Yuma 0: col-norm bonds w/ eps, EMA re-normalized
    EMA = "ema"  # Yuma 1: blended-weight bonds, plain EMA
    EMA_PREV = "ema_prev"  # Yuma 2: clip & bond against previous weights
    CAPACITY = "capacity"  # Yuma 3.x: stake-capacity bond purchases
    RELATIVE = "relative"  # Yuma 4: per-(validator, miner) bonds in [0, 1]


EMA_MODES = (BondsMode.EMA_RUST, BondsMode.EMA, BondsMode.EMA_PREV)


def config_value(x, like: torch.Tensor) -> torch.Tensor:
    """A config value as a tensor of `like`'s dtype and device that
    broadcasts against it: 0-d, or a `[B]` field of a config grid (one
    value per scenario of the leading batch axis) as `[B, 1, ...]`."""
    t = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return t.reshape(t.shape + (1,) * (like.ndim - 1)) if t.ndim else t


def _per_lane(x, like: torch.Tensor) -> torch.Tensor:
    """A config value or `[..., M]` rate broadcast against `[..., V, M]`."""
    t = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return t.unsqueeze(-2) if t.ndim else t


def ema_bonds_target(S_n, W_n, clip_base, W_clipped, config, bonds_mode):
    """The EMA families' purchase target: column-normalized stake-weighted
    (blended) bonds (reference yumas.py:113-116, 227-229, 341-343).
    Returns `(B_target, weight_for_bond_or_None)`. XLA contracts the
    blend's `(1 - beta) * bond_base` into its add."""
    S_col = S_n.unsqueeze(-1)
    if bonds_mode is BondsMode.EMA_RUST:
        B = S_col * W_clipped
        B = B / (validator_dot(S_col, W_clipped) + 1e-6)
        return torch.nan_to_num(B), None
    beta = config_value(config.bond_penalty, W_n)
    bond_base = W_n if bonds_mode is BondsMode.EMA else clip_base
    W_b = fma(1.0 - beta, bond_base, beta * W_clipped)
    B = S_col * W_b
    B = B / validator_dot(S_col, W_b)  # no epsilon here (yumas.py:228,342)
    return torch.nan_to_num(B), W_b


def ema_column_sum(B_ema, B_target, B_old, rate, first=None):
    """Yuma 0's re-normalization sum of `B_ema` over validators (kept).
    Where :func:`..ops.normalize.xla_chains`, as XLA compiles it: the
    adopted target adds left to right, and the reduce of the EMA
    `fma(1 - rate, B_old, rate * B_target)` folds the running sum into the
    inner product, `acc = fma(1 - rate, B_old[v], fma(rate, B_target[v],
    acc))`. Else the plain sum."""
    if not xla_chains(*B_ema.shape[-2:]):
        return validator_sum(B_ema, keepdim=True)
    adopted = sequential_sum(B_target, -2, keepdim=True)
    if B_old is None:
        return adopted
    rate = torch.as_tensor(rate, dtype=B_target.dtype, device=B_target.device)
    Bt, Bo, r = torch.broadcast_tensors(B_target, B_old, rate)
    keep = 1.0 - r
    acc = torch.zeros_like(Bt[..., 0, :])
    for v in range(Bt.shape[-2]):
        acc = fma(keep[..., v, :], Bo[..., v, :], fma(r[..., v, :], Bt[..., v, :], acc))
    acc = acc.unsqueeze(-2)
    return acc if first is None else torch.where(first, adopted, acc)


def ema_bonds_update(B_target, B_old, rate, first_epoch, renormalize: bool):
    """EMA toward the target; the first epoch adopts the target outright
    (yumas.py:145), as a select; Yuma 0 re-normalizes (yumas.py:147-149).

    The EMA fuses one of the products of JAX's `rate * B_target + (1 -
    rate) * B_old` into the add, as XLA's CPU backend does
    (:func:`..ops.normalize.ema_blend`), and the port rounds as it does."""
    first = None
    if B_old is None:
        B_ema = B_target
    else:
        B_ema = ema_blend(rate, B_old, B_target)
        if first_epoch is not None:
            first = torch.as_tensor(first_epoch, device=B_ema.device)
            B_ema = torch.where(first, B_target, B_ema)
    if renormalize:
        colsum = ema_column_sum(B_ema, B_target, B_old, rate, first)
        B_ema = torch.nan_to_num(B_ema / (colsum + 1e-6))
    return B_ema


def capacity_bonds_update(B_prev, W_n, S_n, config):
    """Yuma 3.x stake-capacity bond purchase (reference yumas.py:455-472)."""
    maxint = torch.tensor(MAXINT, dtype=W_n.dtype, device=W_n.device)
    capacity = S_n * maxint
    capacity_per_bond = S_n.unsqueeze(-1) * maxint
    remaining = torch.clamp(capacity_per_bond - B_prev, min=0.0)
    cap_alpha = (config_value(config.capacity_alpha, capacity) * capacity).unsqueeze(-1)
    purchase = torch.minimum(cap_alpha, remaining) * W_n
    # XLA contracts the decay product into the add (see ema_bonds_update).
    B = fma(1.0 - config_value(config.decay_rate, W_n), B_prev, purchase)
    return torch.minimum(B, capacity_per_bond)


def relative_bonds_update(B_prev, W_n, rate):
    """Yuma 4 relative bonds in [0, 1] (reference yumas.py:574-586)."""
    B_decayed = B_prev * (1.0 - rate)
    remaining = torch.clamp(1.0 - B_decayed, min=0.0)
    purchase = torch.minimum(rate * W_n, remaining)
    return torch.clamp(B_decayed + purchase, max=1.0)


def dividends(B, incentive, S_n=None, msum=miner_sum, fold=FOLD_VALIDATORS):
    """`(D [..., V], sum(D) [..., 1])`: each validator's bond-weighted
    incentive `D = msum(B * incentive)` (times `S_n` for Yuma 4's relative
    bonds) and its total. Where :func:`..ops.normalize.xla_chains`, both
    round as the XLA rung rounds them: each product is fused into its
    miner chain, Yuma 4's total is a chain of `S_n * D` over validators,
    and the others' total is one chain over every (validator, miner)
    product, as XLA merges the two sums, except at the validator counts in
    `fold` (4 or 8; the EMA modes pass
    :data:`..ops.normalize.EMA_FOLD_VALIDATORS`, which adds 2), where XLA
    keeps D in one vector register and sums it with its horizontal
    reduction (:func:`..ops.normalize.fold_sum`). Else plain sums."""
    inc = incentive.unsqueeze(-2)
    if not xla_chains(*B.shape[-2:]):
        D = msum(B * inc)
        D = D if S_n is None else S_n * D
        return D, D.sum(dim=-1, keepdim=True)
    D = fma_chain(B, inc)
    if S_n is not None:
        return S_n * D, fma_chain(S_n, D, keepdim=True)
    if B.shape[-2] in fold:
        return D, fold_sum(D)
    return D, fma_chain(B.flatten(-2), inc.expand_as(B).flatten(-2), keepdim=True)


def yuma_epoch(
    W: torch.Tensor,
    S: torch.Tensor,
    B_old: Optional[torch.Tensor] = None,
    config: Optional[YumaConfig] = None,
    *,
    bonds_mode: BondsMode = BondsMode.EMA,
    W_prev: Optional[torch.Tensor] = None,
    first_epoch=None,
    miner_mask: Optional[torch.Tensor] = None,
    consensus_impl: str = "bisect",
    x64: bool = False,
) -> dict:
    """One consensus epoch. Returns the reference's named-output dict.

    Args:
      W: raw validator->miner weights `[..., V, M]`.
      S: raw stake `[..., V]`.
      B_old: carried bond state `[..., V, M]`, or None on the first epoch.
      config: hyperparameters; float fields may be Python floats or 0-d
        tensors (the engine passes tensors, as JAX's jitted engine traces
        its config).
      bonds_mode: the variant switch.
      W_prev: previous epoch's normalized weights (EMA_PREV only); None
        means "use this epoch's weights" (reference yumas.py:299-300).
      first_epoch: a bool (or bool tensor) selecting the fresh-bond branch
        of the EMA modes when `B_old` is always a tensor; None derives it
        from `B_old is None`.
      miner_mask: optional `[..., M]` 0/1 mask of a padded suite's miner
        columns (1 = real); it reaches the u16 quantize and the liquid-alpha
        quantiles, and nothing else.
      consensus_impl: "bisect" (default), "sorted" (closed form, identical
        values) or "kernel" (the CUDA bisection kernel on CUDA tensors, its
        plain version on CPU tensors; identical values).
      x64: run Yuma 0's quantization divide in float64 (reference
        yumas.py:81,97), as the JAX package does under `jax_enable_x64`.
    """
    config = config if config is not None else YumaConfig()
    dtype = W.dtype

    W_n = normalize_weight_rows(W)
    S_n = normalize_stake(torch.as_tensor(S, dtype=dtype, device=W.device))

    # Prerank: stake-weighted column sums of the un-clipped weights.
    P = validator_sum(S_n.unsqueeze(-1) * W_n)

    kappa = config.kappa
    if consensus_impl == "sorted":
        C_raw = stake_weighted_median_sorted(
            W_n, S_n, kappa, config.consensus_precision
        )
    elif consensus_impl == "kernel":
        from yuma_simulation_tpu_torch.ops.cuda_consensus import (
            stake_weighted_median_cuda,
        )

        C_raw = stake_weighted_median_cuda(
            W_n, S_n, kappa, config.consensus_precision
        )
    elif consensus_impl == "bisect":
        C_raw = stake_weighted_median(W_n, S_n, kappa, config.consensus_precision)
    else:
        raise ValueError(f"unknown consensus_impl {consensus_impl!r}")
    rust64 = bonds_mode is BondsMode.EMA_RUST and x64
    C = quantize_u16(
        C_raw,
        sum_dtype=torch.float64 if rust64 else None,
        out_dtype=dtype,
        miner_mask=miner_mask,
        grid_bits=bisection_iterations(config.consensus_precision),
    )

    # Clip, rank, incentive, trust.
    clip_base = W_n
    if bonds_mode is BondsMode.EMA_PREV and W_prev is not None:
        clip_base = W_prev
    W_clipped = torch.minimum(clip_base, C.unsqueeze(-2))
    R = rank_sum(S_n.unsqueeze(-1), W_clipped, W_clipped[..., 0, 0].numel()).squeeze(-2)
    incentive = torch.nan_to_num(R / miner_sum(R, keepdim=True))
    T = torch.nan_to_num(R / P)
    T_v = miner_sum(W_clipped) / miner_sum(W_n)

    out = {
        "weight": W_n,
        "stake": S_n,
        "server_prerank": P,
        "server_consensus_weight": C,
        "consensus_clipped_weight": W_clipped,
        "server_rank": R,
        "server_incentive": incentive,
    }

    nan = torch.tensor(float("nan"), dtype=dtype, device=W.device)
    a = b = nan
    bond_alpha = config_value(config.bond_alpha, C)
    if config.liquid_alpha and bonds_mode is not BondsMode.CAPACITY:
        bond_alpha, a, b = liquid_alpha_rate(
            C,
            config.alpha_low,
            config.alpha_high,
            override_consensus_high=config.override_consensus_high,
            override_consensus_low=config.override_consensus_low,
            miner_mask=miner_mask,
        )
    rate_vm = _per_lane(bond_alpha, W_n)

    if bonds_mode in EMA_MODES:
        B, W_b = ema_bonds_target(S_n, W_n, clip_base, W_clipped, config, bonds_mode)
        if W_b is not None:
            out["weight_for_bond"] = W_b
        B_ema = ema_bonds_update(
            B,
            B_old,
            rate_vm,
            first_epoch,
            renormalize=bonds_mode is BondsMode.EMA_RUST,
        )
        D, D_tot = dividends(B_ema, incentive, fold=EMA_FOLD_VALIDATORS)
        out.update(
            server_trust=T,
            validator_trust=T_v,
            validator_bond=B,
            validator_ema_bond=B_ema,
            bond_alpha=bond_alpha,
            alpha_a=a,
            alpha_b=b,
        )
    elif bonds_mode is BondsMode.CAPACITY:
        B_prev = torch.zeros_like(W_n) if B_old is None else B_old
        B = capacity_bonds_update(B_prev, W_n, S_n, config)
        D, D_tot = dividends(B, incentive)
        out.update(server_trust=T, validator_trust=T_v, validator_bonds=B)
    elif bonds_mode is BondsMode.RELATIVE:
        B_prev = torch.zeros_like(W_n) if B_old is None else B_old
        B = relative_bonds_update(B_prev, W_n, rate_vm)
        D, D_tot = dividends(B, incentive, S_n)
        out["validator_bonds"] = B
    else:  # pragma: no cover
        raise ValueError(f"unknown bonds mode: {bonds_mode}")

    out["validator_reward"] = D
    out["validator_reward_normalized"] = D / (D_tot + 1e-6)
    return out

"""Liquid-alpha: consensus-dependent per-miner bond EMA rates.

Fits a logistic between the 0.25/0.75 consensus quantiles (with overrides
and a degenerate-quantile fallback to the 0.99 quantile) and maps each
miner's consensus weight to an EMA rate in `[1-alpha_high, 1-alpha_low]`
(reference yumas.py:118-140).

Parity notes, as in the JAX package:
- with Python-float bounds the logits are Python `math.log` values; with
  tensor bounds (the engine passes 0-d tensors, as JAX's jitted engine
  traces its config) they are float32 `log`s;
- the logistic is `e ** (-a*C + b)` (a power with base `math.e`), not `exp`;
- the quantile is linear interpolation `v_lo*(1-frac) + v_hi*frac` at
  position `q*(n-1)`: `jnp.quantile`'s, in float64 (the JAX package's
  parity mode) with the interpolation one float64 FMA; over a padded
  suite's real miners only (`miner_mask`), in the working dtype with the
  interpolation one float32 FMA;
- `b = logit_low + a * c_low` is one FMA, and the exponent `-a * C + b` is
  `fma(k, -a * U16_INV, b)` on the u16 grid integers k of C: these are the
  multiply-adds XLA:CPU contracts in the jitted scan (ROADMAP §C, C2), so
  the eager rung's rate is bitwise the XLA rung's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from yuma_simulation_tpu_torch.ops.fma import fma, fma64
from yuma_simulation_tpu_torch.ops.consensus import U16_INV


def _logit(x) -> float:
    return math.log(1.0 / x - 1.0)


def _quantile(C: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation quantile over the last axis, as `jnp.quantile`
    computes it in the JAX package's parity mode (x64): the position
    `q * (n - 1)` and the weights in float64, the sorted float32 values
    widened, `v_lo * w_lo + v_hi * w_hi` contracted into one float64 FMA
    (as XLA:CPU compiles it), rounded once to float32."""
    s = torch.sort(C, dim=-1).values
    p = q * (C.shape[-1] - 1.0)
    lo, hi = math.floor(p), math.ceil(p)
    w_hi = p - lo
    v_lo, v_hi = s[..., lo].double(), s[..., hi].double()
    return fma64(v_lo, 1.0 - w_hi, v_hi * w_hi).to(C.dtype)


def _masked_quantile(C: torch.Tensor, q: float, mask: torch.Tensor) -> torch.Tensor:
    """The quantile over the real miners only (`mask` 1 = real, 0 =
    padding, `[..., M]`), so padded columns cannot shift the liquid-alpha
    quantiles: a sort with `+inf` in the padded places, then linear
    interpolation at `q * (n - 1)`, `n` the real count of each row. XLA's
    CPU backend contracts the interpolation's first product into its add
    (ROADMAP §C), so it is `fma(v_lo, 1 - frac, v_hi * frac)`."""
    dtype = C.dtype
    real = mask.to(torch.bool)
    s = torch.sort(torch.where(real, C, _as(math.inf, C)), dim=-1).values
    n = real.to(dtype).sum(dim=-1)
    p = _as(q, C) * (n - 1.0)
    lo = torch.floor(p).to(torch.int64)
    hi = torch.ceil(p).to(torch.int64)
    frac = p - lo.to(dtype)
    v_lo = torch.gather(s, -1, lo.unsqueeze(-1)).squeeze(-1)
    v_hi = torch.gather(s, -1, hi.unsqueeze(-1)).squeeze(-1)
    return fma(v_lo, 1.0 - frac, v_hi * frac)


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def liquid_alpha_rate(
    C: torch.Tensor,
    alpha_low,
    alpha_high,
    *,
    override_consensus_high: Optional[float] = None,
    override_consensus_low: Optional[float] = None,
    miner_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-miner EMA rate from quantized consensus `[..., M]`. With
    `miner_mask` (`[..., M]` 0/1, a padded suite) the quantiles are taken
    over the real miners only.

    Returns `(bond_alpha [..., M], a, b)`, `a`/`b` the fitted logistic
    coefficients (0-d, or `[...]` when batched).
    """
    dtype = C.dtype
    grid = np.ndim(alpha_low) + np.ndim(alpha_high) > 0
    if grid and C.ndim > 1 and len(C) > 1 and C.device.type == "cpu":
        # A config grid's lanes one at a time: PyTorch's CPU `pow` rounds
        # an element by where it falls in its vector loop, so only a lane's
        # own layout gives it the bits of its run alone.
        lanes = [
            liquid_alpha_rate(
                C[i : i + 1], *(x[i : i + 1] if np.ndim(x) else x for x in (alpha_low, alpha_high)),
                override_consensus_high=override_consensus_high,
                override_consensus_low=override_consensus_low,
                miner_mask=(miner_mask[i : i + 1]
                            if miner_mask is not None and miner_mask.ndim > 1 else miner_mask),
            )
            for i in range(C.shape[0])
        ]
        return tuple(torch.cat(parts) for parts in zip(*lanes))

    def quant(q):
        if miner_mask is None:
            return _quantile(C, q)
        return _masked_quantile(C, q, miner_mask)

    # Degenerate spread falls back to the 0.99 quantile (yumas.py:132-133),
    # checked after the overrides are substituted; with BOTH overridden the
    # reference compares two Python floats, decided here statically.
    if override_consensus_high is not None and override_consensus_low is not None:
        c_low = _as(override_consensus_low, C)
        c_high = (
            quant(0.99)
            if override_consensus_high == override_consensus_low
            else _as(override_consensus_high, C)
        )
    else:
        if override_consensus_high is not None:
            c_high = _as(override_consensus_high, C)
        else:
            c_high = quant(0.75)
        if override_consensus_low is not None:
            c_low = _as(override_consensus_low, C)
        else:
            c_low = quant(0.25)
        c_high = torch.where(c_high == c_low, quant(0.99), c_high)

    if isinstance(alpha_high, (int, float)) and isinstance(alpha_low, (int, float)):
        num = _as(_logit(alpha_high) - _logit(alpha_low), C)
        logit_low = _logit(alpha_low)
    else:
        alpha_high = _as(alpha_high, C)
        alpha_low = _as(alpha_low, C)
        one = _as(1.0, C)
        logit_high = torch.log(one / alpha_high - 1.0)
        logit_low = torch.log(one / alpha_low - 1.0)
        num = logit_high - logit_low

    a = num / (c_low - c_high)
    # XLA:CPU contracts the intercept into one FMA, and folds the u16
    # grid's constant into the slope: the exponent `-a * C + b` becomes
    # `fma(k, -a * U16_INV, b)` on the grid integers k = C * 65535.
    b = fma(a, c_low, logit_low)
    if a.ndim:
        a_b, b_b = a.unsqueeze(-1), b.unsqueeze(-1)
    else:
        a_b, b_b = a, b
    alpha = _as(1.0, C) / (1.0 + torch.pow(_as(math.e, C), _grid_exponent(a_b, b_b, C)))
    lo = _as(alpha_low, C)
    hi = _as(alpha_high, C)
    if lo.ndim:
        lo = lo.unsqueeze(-1)
    if hi.ndim:
        hi = hi.unsqueeze(-1)
    bond_alpha = 1.0 - torch.minimum(torch.maximum(alpha, lo), hi)
    return bond_alpha.to(dtype), a, b



def _grid_exponent(a, b, C):
    """The logistic's exponent `-a * C + b` over quantized consensus, as
    XLA:CPU compiles it in the scan (ROADMAP §C, C2): C is `k * U16_INV`
    with k the u16 grid integer, the constant is folded into the slope,
    and the product fused into the add."""
    k = torch.round(C * 65535.0)
    return fma(k, -a * U16_INV, b)

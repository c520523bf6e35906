"""Stake-weighted-median consensus, vectorized over the whole weight matrix.

The reference computes consensus with a per-miner Python `while`
bisection (reference yumas.py:83-95). Here the bisection runs as a fixed
number of whole-array halvings: `ceil(log2(precision))` of them (17 at the
default precision of 100 000), each evaluating the stake support of every
miner at once. Every midpoint is a dyadic rational `k/2^17`, exact in
float32, and both comparisons are strict `>` as in the reference.

The support test runs on canonical fixed-point integers
(:func:`support_fixed_stakes`): integer addition is exact and
order-independent, so the strict `support > kappa` decision cannot depend
on any engine's reduction order. That is what lets the CUDA kernels agree
bitwise with these functions whatever their thread layout.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from yuma_simulation_tpu_torch.ops.normalize import miner_sum

#: Fixed-point bits of the canonical support test. 2^30 keeps the sum of
#: normalized stakes (<= ~1 + V/2^31) inside int32.
SUPPORT_FIXED_BITS = 30

#: Above this many `V x M` cells the shape-gated default is "bisect" (the
#: JAX package's compile-time gate; kept so "auto" resolves the same way).
SORTED_COMPILE_PATHOLOGY_CELLS = 512 * 8192


def bisection_iterations(precision: int) -> int:
    """Halvings of [0, 1] until the interval width is <= 1/precision."""
    return int(math.ceil(math.log2(precision)))


#: float32(1/65535). The u16 grid value `k / 65535` is computed as
#: `k * U16_INV`: XLA compiles the JAX package's divide by the constant
#: 65535 into this multiply (its jitted engines and Pallas kernels round
#: so), and the port's kernels and plain versions spell it the same way,
#: so quantized consensus is bitwise the JAX engines' on every device.
U16_INV = float(np.float32(1.0) / np.float32(65535.0))


def support_fixed_stakes(S: torch.Tensor) -> torch.Tensor:
    """Canonical fixed-point stake encoding `round(S * 2^30)` as int32
    (half to even). Precondition: `S` normalized. `S * 2^30` is an exact
    exponent shift, so the encoding is deterministic on every backend."""
    return torch.round(S * float(2**SUPPORT_FIXED_BITS)).to(torch.int32)


def support_rounded(support_int: torch.Tensor, dtype) -> torch.Tensor:
    """The support value the strict kappa comparison sees: the exact
    integer sum rounded once to `dtype`, then an exact exponent shift. The
    final rounding reproduces the reference's float support tensor."""
    return support_int.to(dtype) * (2.0**-SUPPORT_FIXED_BITS)


def dyadic_grid_fits_int32(count: int, grid_bits: int) -> bool:
    """Whether `count` dyadic grid values `k * 2^-grid_bits` can be summed
    exactly in int32."""
    return (count << grid_bits) < 2**31


def dyadic_grid_denom(C: torch.Tensor, grid_bits: int) -> torch.Tensor:
    """Exact last-axis sum of dyadic grid values `k * 2^-grid_bits`,
    rounded once to `C.dtype` (keepdim). The integer sum is
    order-independent."""
    return dyadic_grid_count(C, grid_bits).to(C.dtype) * (2.0**-grid_bits)


def dyadic_grid_count(C: torch.Tensor, grid_bits: int) -> torch.Tensor:
    """The exact int64 last-axis sum (keepdim) of the grid integers `k` of
    `C = k * 2^-grid_bits`: partial counts over column shards add to the
    whole count in any order."""
    k = torch.round(C * float(2**grid_bits)).to(torch.int32)
    return k.sum(dim=-1, keepdim=True, dtype=torch.int64)


def default_consensus_impl(num_validators: int, num_miners: int) -> str:
    """"sorted" below the shape threshold, "bisect" at or above it."""
    cells = num_validators * num_miners
    return "sorted" if cells < SORTED_COMPILE_PATHOLOGY_CELLS else "bisect"


def resolve_consensus_impl(
    consensus_impl: str, num_validators: int, num_miners: int
) -> str:
    """"auto" becomes the shape-gated default; "sorted", "bisect" and
    "kernel" (the CUDA bisection kernel) pass through; anything else
    raises."""
    if consensus_impl == "auto":
        return default_consensus_impl(num_validators, num_miners)
    if consensus_impl not in ("sorted", "bisect", "kernel"):
        raise ValueError(
            f"unknown consensus_impl {consensus_impl!r}; "
            "expected 'auto', 'sorted', 'bisect' or 'kernel'"
        )
    return consensus_impl


def _kappa_like(kappa, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(kappa, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# the support sum as an exact integer matrix product (K4's plain version)

#: Validators the exact limb-split support covers: the JAX package's
#: `exact_mxu_support_covers` gate, kept so both packages refuse the same
#: inputs (the port's u8 limbs would stay exact up to V * 255 < 2^31).
MXU_MAX_VALIDATORS = 2**14
#: The canonical stakes `S_int < 2^31` as four 8-bit limbs.
LIMB_BITS, NUM_LIMBS = 8, 4


def exact_mxu_support_covers(num_validators: int) -> bool:
    """Whether the exact limb-split support covers this validator count."""
    return num_validators <= MXU_MAX_VALIDATORS


def check_mxu_support_covers(num_validators: int) -> None:
    """The kernels' refusal of the limb-split support beyond V = 2^14,
    worded as the JAX package's (pallas_epoch.py:1089-1093)."""
    if not exact_mxu_support_covers(num_validators):
        raise ValueError(
            "the exact MXU stake split covers V <= 2^14 validators, got "
            f"V={num_validators}; use the VPU path (mxu=False)"
        )


def stake_limb_split(S_int: torch.Tensor) -> torch.Tensor:
    """The canonical fixed-point stakes `[..., V]` (int32, non-negative) as
    their four 8-bit limbs `[..., 4, V]`, least significant first, so that
    `S_int == sum_j limb_j << 8j` exactly. These are the u8 rows K4
    contracts on the tensor cores (the JAX package splits into bf16 heads
    and residuals instead, because its matrix unit rounds to bf16)."""
    V = S_int.shape[-1]
    if not exact_mxu_support_covers(V):
        raise ValueError(f"no exact MXU stake split for V={V}")
    limbs = [(S_int >> (LIMB_BITS * j)) & 0xFF for j in range(NUM_LIMBS)]
    return torch.stack(limbs, dim=-2)


def support_limbs(limbs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The support sum `[..., M]` (int32) as K4 computes it: the limb rows
    `[..., 4, V]` times the 0/1 mask `[..., V, M]`, one exact integer sum
    per limb (products of a limb <= 255 and 0/1, added up to V * 255 <
    2^53, are exact in float64 in any order), recombined most significant
    limb first by shifts in int32."""
    sums = (limbs.double() @ mask.double()).to(torch.int64)  # [..., 4, M]
    support = torch.zeros_like(sums[..., 0, :])
    for j in reversed(range(NUM_LIMBS)):
        support = (support << LIMB_BITS) + sums[..., j, :]
    return support.to(torch.int32)


def stake_weighted_median(
    W: torch.Tensor,
    S: torch.Tensor,
    kappa,
    precision: int = 100_000,
    *,
    mxu: bool = False,
) -> torch.Tensor:
    """Per-miner consensus weight via vectorized bisection.

    Args:
      W: row-normalized weights `[..., V, M]`.
      S: normalized stake `[..., V]`.
      kappa: consensus threshold (scalar or `[...]`).
      precision: the reference's `consensus_precision`.
      mxu: take each halving's support sum as the exact limb contraction
        (:func:`support_limbs`, K4's plain version) instead of a masked
        integer sum; bitwise the same result. Needs V <= 2^14.

    Returns the bisection's final `c_high` per miner `[..., M]`.
    """
    iters = bisection_iterations(precision)
    dtype = W.dtype
    batch_m = W.shape[:-2] + W.shape[-1:]
    S_int = support_fixed_stakes(S).unsqueeze(-1)  # [..., V, 1]
    limbs = stake_limb_split(S_int[..., 0]) if mxu else None
    kappa = _kappa_like(kappa, W)
    if kappa.ndim:
        kappa = kappa.unsqueeze(-1)
    zero = torch.zeros((), dtype=torch.int32, device=W.device)
    c_lo = torch.zeros(batch_m, dtype=dtype, device=W.device)
    c_hi = torch.ones(batch_m, dtype=dtype, device=W.device)
    for _ in range(iters):
        c_mid = (c_hi + c_lo) * 0.5
        mask = W > c_mid.unsqueeze(-2)
        if mxu:
            support = support_limbs(limbs, mask)
        else:
            support = torch.where(mask, S_int, zero).sum(dim=-2, dtype=torch.int64)
        above = support_rounded(support, dtype) > kappa
        c_lo, c_hi = torch.where(above, c_mid, c_lo), torch.where(above, c_hi, c_mid)
    return c_hi


def quantize_u16(
    C: torch.Tensor,
    *,
    sum_dtype: Optional[torch.dtype] = None,
    out_dtype: torch.dtype = torch.float32,
    miner_mask: Optional[torch.Tensor] = None,
    grid_bits: Optional[int] = None,
    denom: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum-normalize C and truncate onto the u16 grid:
    `(C / C.sum() * 65535).int() / 65535` (reference yumas.py:97), with
    truncation toward zero (the final divide as a multiply by
    :data:`U16_INV`, as XLA compiles it). `sum_dtype=torch.float64` runs the normalizing
    divide in float64 (Yuma 0, reference yumas.py:81). With `grid_bits`
    (every C is a grid point `k * 2^-grid_bits`) the float32 denominator is
    the exact integer sum of the `k`; beyond the int32 bound it falls back
    to :func:`miner_sum`.

    `miner_mask` (`[..., M]`, 1 = real miner, 0 = padding of a padded
    suite) zeroes the padded columns before the sum, so padding cannot move
    the grid of the real miners. The int32 gate still takes the padded
    width, as the JAX package's does.

    `denom` (keepdim, in the sum's dtype) replaces the normalizing sum: a
    miner shard passes the sum of the whole row (:mod:`..models.miner_shards`)."""
    if miner_mask is not None:
        C = torch.where(miner_mask.to(torch.bool), C, torch.zeros_like(C))
    if sum_dtype is not None:
        C = C.to(sum_dtype)
    if denom is None:
        if (
            grid_bits is not None
            and sum_dtype is None
            and dyadic_grid_fits_int32(C.shape[-1], grid_bits)
        ):
            denom = dyadic_grid_denom(C, grid_bits)
        else:
            denom = miner_sum(C, keepdim=True)
    scaled = C / denom * 65535.0
    return scaled.to(torch.int32).to(out_dtype) * U16_INV


def consensus_weights(
    W: torch.Tensor,
    S: torch.Tensor,
    kappa,
    precision: int = 100_000,
    *,
    sum_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Bisection consensus followed by u16 quantization (the full C stage)."""
    C = stake_weighted_median(W, S, kappa, precision)
    return quantize_u16(
        C,
        sum_dtype=sum_dtype,
        out_dtype=W.dtype,
        grid_bits=bisection_iterations(precision),
    )


def stake_weighted_median_sorted(
    W: torch.Tensor,
    S: torch.Tensor,
    kappa,
    precision: int = 100_000,
) -> torch.Tensor:
    """Exact closed-form consensus via a per-column sort; values identical
    to :func:`stake_weighted_median`.

    The bisection converges to the unique grid point `g = k/2^p` with
    strict stake support `<= kappa` at `g` and `> kappa` at `g - 2^-p`.
    The support is a non-increasing step function whose breakpoints are
    the weights, so the answer is the smallest weight `w*` whose support
    is `<= kappa`, rounded up to the grid — or `2^-p` when the stake on
    strictly positive weights never exceeds kappa.
    """
    iters = bisection_iterations(precision)
    scale = float(2**iters)
    dtype = W.dtype
    kappa = _kappa_like(kappa, W)
    batched_kappa = kappa.ndim > 0
    kap = kappa[..., None, None] if batched_kappa else kappa

    # Each miner column sorted by weight, descending; the stable sort
    # carries the fixed-point stakes along, so the cumulative support is
    # the exact integer sum.
    S_int = support_fixed_stakes(S)
    Wt = W.transpose(-1, -2)  # [..., M, V]
    St = S_int.unsqueeze(-2).expand(Wt.shape)
    w_neg, order = torch.sort(-Wt, dim=-1, stable=True)
    s_sorted = torch.gather(St, -1, order).to(torch.int64)
    w_sorted = -w_neg
    # Strict support at w_sorted[k] = stake on strictly greater weights;
    # tied entries share the support of the first element of their run,
    # forward-filled by a running max.
    excl = torch.cumsum(s_sorted, dim=-1) - s_sorted
    first_of_run = torch.cat(
        [
            torch.ones_like(w_sorted[..., :1], dtype=torch.bool),
            w_sorted[..., 1:] != w_sorted[..., :-1],
        ],
        dim=-1,
    )
    run_support = torch.where(
        first_of_run, excl, torch.full_like(excl, torch.iinfo(torch.int64).min)
    )
    support_at = torch.cummax(run_support, dim=-1).values
    qualifies = support_rounded(support_at, dtype) <= kap
    inf = torch.full_like(w_sorted, math.inf)
    w_star = torch.where(qualifies, w_sorted, inf).amin(dim=-1)

    # Round w* up to the grid: the smallest of {k-1, k, k+1} whose exact
    # grid value is >= w*.
    k = torch.floor(w_star * scale)
    cand = torch.stack([k - 1, k, k + 1], dim=-1)
    grid = (cand / scale).to(dtype)
    ok = grid >= w_star.unsqueeze(-1)
    g = torch.where(ok, grid, torch.full_like(grid, math.inf)).amin(dim=-1)

    # The support(0+) <= kappa regime: c_high bottoms out at 2^-p.
    zero = torch.zeros((), dtype=torch.int64, device=W.device)
    support0 = torch.where(W > 0, S_int.unsqueeze(-1).to(torch.int64), zero).sum(-2)
    kap0 = kappa.unsqueeze(-1) if batched_kappa else kappa
    floor_c = torch.full_like(g, 1.0 / scale)
    return torch.where(
        support_rounded(support0, dtype) > kap0,
        torch.maximum(g, floor_c),
        floor_c,
    ).to(dtype)

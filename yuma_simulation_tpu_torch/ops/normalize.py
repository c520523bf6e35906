"""Row/column normalizations with the reference's exact epsilon conventions.

- weight rows are normalized with a `+1e-6` denominator guard
  (reference yumas.py:72,186,297,411,505);
- stake is normalized with a bare sum, no epsilon (yumas.py:75,189,303,414,508).

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch

from yuma_simulation_tpu_torch.ops.fma import fma, fma_chain

WEIGHT_EPS = 1e-6

#: Fixed block count of the miner-axis sum (see :func:`miner_sum`).
SUM_BLOCKS = 8


def sequential_sum(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Sum along `dim` added strictly left to right, from 0.

    The order is part of the result: float addition is not associative,
    and a sum that feeds the consensus (row and stake normalization) can
    move a normalized weight by one ulp and so flip a bisection outcome.
    XLA's CPU backend reduces short rows in this order, and the port's CUDA
    kernels add in it too, so the JAX package, the port's plain versions
    and its kernels normalize bitwise alike. (PyTorch's own `sum` uses
    several accumulators and differs in the last ulp for most rows.)"""
    x = x.movedim(dim, -1)
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc.unsqueeze(dim) if keepdim else acc


def miner_sum(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Sum over the last (miner) axis, spelled with a fixed structure: 8
    blocks reduced independently, then combined by an explicit sequential
    add chain — the JAX package's eager-rung spelling (it makes a
    miner-sharded run add in the same order as an unsharded one), kept so
    the port's eager rung adds as that rung does. Small or non-8-divisible
    miner counts keep a single reduce (every built-in case is M=2). Each
    reduce runs left to right (:func:`sequential_sum`)."""
    M = x.shape[-1]
    if M % SUM_BLOCKS or M < 2 * SUM_BLOCKS:
        return sequential_sum(x, -1, keepdim)
    part = sequential_sum(x.reshape(x.shape[:-1] + (SUM_BLOCKS, M // SUM_BLOCKS)), -1)
    total = part[..., 0]
    for i in range(1, SUM_BLOCKS):
        total = total + part[..., i]
    return total.unsqueeze(-1) if keepdim else total


#: Widest validator axis, and the miner count bound, of an epoch whose
#: reduces the port spells as XLA's chains of FMAs (see :func:`xla_chains`).
XLA_CHAIN_MAX = 16

#: The whole epoch's miner count while its columns run in shards
#: (:func:`miner_width`); None when the tensors hold every column.
_MINER_WIDTH: contextvars.ContextVar = contextvars.ContextVar("miner_width", default=None)


@contextlib.contextmanager
def miner_width(num_miners: int) -> Iterator[None]:
    """Within the block, the reduce-spelling predicates (:func:`xla_chains`,
    :func:`ema_target_columns`) read the epoch's miner count as
    `num_miners`, not the last axis of the tensors they are given: a miner
    shard's helpers then spell every reduce as the unsharded epoch does
    (:mod:`..models.miner_shards`)."""
    token = _MINER_WIDTH.set(int(num_miners))
    try:
        yield
    finally:
        _MINER_WIDTH.reset(token)


def _width(M: int) -> int:
    width = _MINER_WIDTH.get()
    return M if width is None else width


def xla_chains(V: int, M: int) -> bool:
    """Whether the reduces of products of a `[V, M]` epoch (the rank's and
    the bond target's column sums, the dividends and their total, Yuma 0's
    re-normalization) are spelled as the chains of FMAs XLA's CPU backend
    compiles them into (:func:`..ops.fma.fma_chain`): at most 16
    validators and fewer than 16 miners, with the exceptions XLA makes
    there (:func:`rank_sum`, :func:`fold_sum`). tests/test_torch_simulate.py
    pins the port's epochs there bitwise to JAX's XLA rung: the built-in
    cases ([3, 2]) and random [5, 8], [6, 5], [7, 2], [4, 8] and [8, 2]
    suites (ROADMAP §C, C2, has the shapes it does not reach yet). Past
    these widths XLA's order
    depends on the shape (on random data no spelling tried matched at
    V = 17 to 200 with M = 2, or at M = 31, 300, 512 or 4096), so the port
    keeps its plain sums there, in the engines' reduction-order class
    (atol 2e-6) and at one op per sum instead of a loop of FMAs."""
    return V <= XLA_CHAIN_MAX and _width(M) < XLA_CHAIN_MAX


def validator_sum(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Sum over the validator axis (-2), added strictly in validator order
    (:func:`sequential_sum`). Every miner column then sums in the same
    order whatever the tensor's width, so a miner shard's columns sum
    bitwise as the whole tensor's do (:mod:`..models.miner_shards`).
    PyTorch's own `sum` over that axis picks a column's order by where it
    falls among the tensor's vector groups (on the CPU, the columns past
    the last whole group of 4 vectors add in four interleaved partial
    sums), so a narrower tensor can round a column differently."""
    return sequential_sum(x, -2, keepdim)


def validator_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """`sum(x * y)` over the validator axis (-2), kept: one fused chain
    where :func:`xla_chains`, else :func:`validator_sum` of the products."""
    x, y = torch.broadcast_tensors(x, y)
    if xla_chains(*x.shape[-2:]):
        return fma_chain(x, y, -2, keepdim=True)
    return validator_sum(x * y, keepdim=True)


#: Validator counts at which XLA's CPU backend holds the per-validator
#: dividends in one vector register and sums them with its horizontal
#: reduction (:func:`fold_sum`), not as a chain over (validator, miner).
FOLD_VALIDATORS = (4, 8)
#: The same for the EMA modes' dividends, whose total XLA also folds at 2
#: validators, `D[0] + D[1]` (the capacity modes' stays the chain there;
#: ROADMAP §C, C2, probed against the jitted XLA rung).
EMA_FOLD_VALIDATORS = (2,) + FOLD_VALIDATORS


def fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a vector register's horizontal reduction:
    the upper half added onto the lower half, lane by lane, until one lane
    is left (for 8: `(x0 + x4) + (x2 + x6)`, plus `(x1 + x5) + (x3 + x7)`);
    a length that is a power of two. Kept."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x


#: Validators whose products the rank's first column adds plainly at M = 2
#: (:func:`rank_sum`): one 8-lane register's worth.
RANK_PLAIN_HEAD = 8


def rank_sum(S: torch.Tensor, W_clipped: torch.Tensor, lanes: int) -> torch.Tensor:
    """The rank `R = sum(S * W_clipped)` over validators, kept, as XLA's
    CPU backend compiles the JAX package's `einsum("v,vm->m")` (a batched
    dot over `lanes` scenarios under `vmap`): :func:`validator_dot`, except
    at M = 2 with 3 <= V <= 16 and two or more lanes, where the dot's first
    miner column adds the products of its first 8 validators plainly, left
    to right, and chains the rest as FMAs; the second column is a chain of
    FMAs (probes of the jitted einsum, ROADMAP §C, C2)."""
    R = validator_dot(S, W_clipped)
    V, M = W_clipped.shape[-2:]
    if M == 2 and 3 <= V <= XLA_CHAIN_MAX and lanes >= 2:
        x, y = torch.broadcast_tensors(S, W_clipped)
        head = min(V, RANK_PLAIN_HEAD)
        first = sequential_sum(x[..., :head, 0] * y[..., :head, 0], -1)
        for v in range(head, V):
            first = fma(x[..., v, 0], y[..., v, 0], first)
        R = torch.cat([first.unsqueeze(-1).unsqueeze(-1), R[..., 1:]], dim=-1)
    return R


#: The validator count at which XLA:CPU's vector code holds a column of
#: the EMA's `[V, M]` operands in one 8-lane register (see :func:`ema_blend`).
EMA_REGISTER_VALIDATORS = 8


def ema_target_columns(V: int, M: int) -> list:
    """The miner columns in which XLA:CPU's EMA with a rate shared by the
    miners fuses `rate * B_target` into its add instead of `(1 - rate) *
    B_old`: at V = 8 with M <= 8 its vector code takes the columns four at
    a time (two 16-lane registers of two columns each) and fuses the
    target's product there, and of a remainder of three columns the first
    two; a remainder of one or two fuses the old bonds' product. Empty at
    every other shape (a dump of JAX's XLA rung at [8, 5] and a probe of
    every spelling per column at M = 2 to 8, ROADMAP §C, C2)."""
    if V != EMA_REGISTER_VALIDATORS or _width(M) > EMA_REGISTER_VALIDATORS:
        return []
    q = M // 4 * 4
    return list(range(q)) + ([q, q + 1] if M - q == 3 else [])


def ema_blend(rate, B_old: torch.Tensor, B_target: torch.Tensor) -> torch.Tensor:
    """The EMA `rate * B_target + (1 - rate) * B_old` `[..., V, M]` with
    one product fused into the add, as XLA:CPU compiles the JAX package's
    bond update: `fma(1 - rate, B_old, rate * B_target)`, except, for a
    rate shared by the miners (a scalar, or `[..., 1]`), in the columns of
    :func:`ema_target_columns`, which fuse `rate * B_target`."""
    keep = fma(1.0 - rate, B_old, rate * B_target)
    cols = ema_target_columns(*B_target.shape[-2:])
    r = torch.as_tensor(rate)
    if not cols or (r.ndim and r.shape[-1] != 1):  # none here, or a per-miner rate
        return keep
    mask = torch.zeros(B_target.shape[-1], dtype=torch.bool, device=B_target.device)
    mask[cols] = True
    return torch.where(mask, fma(rate, B_target, (1.0 - rate) * B_old), keep)


def normalize_weight_rows(W: torch.Tensor, eps: float = WEIGHT_EPS) -> torch.Tensor:
    """Normalize each validator's weight row `[..., V, M]` to sum to ~1;
    all-zero rows map to zero rows."""
    return W / (miner_sum(W, keepdim=True) + eps)


def normalize_stake(S: torch.Tensor) -> torch.Tensor:
    """Normalize the stake vector `[..., V]` to sum to 1 (no epsilon)."""
    return S / sequential_sum(S, -1, keepdim=True)

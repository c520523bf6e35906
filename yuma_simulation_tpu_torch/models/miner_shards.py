"""The epoch with its miner axis split into column shards.

The miner axis is this domain's sequence-parallel axis: a subnet whose
`[V, M]` state outgrows one device keeps `W`, the bonds, the previous
weights and every `[M]` vector in contiguous column shards, shard `j`
holding columns `[j * M/n, (j + 1) * M/n)` on its own device. The
bisection consensus, the clip, the rank and every bond update are per
miner and stay shard-local. What crosses shards is:

- the miner-axis sums (row normalization, the incentive's and the
  validator trust's sums, the dividends): :func:`..ops.normalize.miner_sum`
  adds 8 fixed blocks left to right and then chains the block partials.
  With a shard count dividing 8 each shard holds whole blocks, so each
  shard computes its own blocks' partials and the chain runs on in block
  order, its `[V]` accumulator carried from one shard's device to the
  next (:meth:`MinerLayout.miner_sum`);
- the u16 quantization's sum: exact integer counts
  (:func:`..ops.consensus.dyadic_grid_count`), added in any order;
- liquid alpha's quantiles: the `[M]` consensus is gathered onto the
  first shard's device and the rate computed there, then split again.

Every operation is the unsharded epoch's on the same values in the same
order, so a sharded run is bitwise the unsharded eager rung ("same
program, same answer, any mesh", the JAX package's contract). The
layout requires more than one shard to have `M % 8 == 0` and `M >= 16`
(:meth:`MinerLayout.build`): below that `miner_sum` is one plain reduce
and has no shard-local blocks. Inside the shards the reduce-spelling
predicates see the whole width (:func:`..ops.normalize.miner_width`); at
`M >= 16` every reduce of the epoch takes its plain spelling, and every
plain sum over validators adds in validator order
(:func:`..ops.normalize.validator_sum`), which no column's place in its
tensor changes.

Shards are plain tensors on `torch.device`s, one program on one host as
a JAX mesh is: several shards may share one card (each cross-shard move
is a `.to()`, a no-op there) or sit on several. No kernel runs here: the
miner-sharded epoch is the eager rung's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from yuma_simulation_tpu_torch.models.epoch import (
    EMA_MODES,
    BondsMode,
    _per_lane,
    capacity_bonds_update,
    config_value,
    ema_bonds_target,
    ema_bonds_update,
    relative_bonds_update,
)
from yuma_simulation_tpu_torch.ops.consensus import (
    bisection_iterations,
    dyadic_grid_count,
    dyadic_grid_fits_int32,
    quantize_u16,
    stake_weighted_median,
    stake_weighted_median_sorted,
)
from yuma_simulation_tpu_torch.ops.liquid import liquid_alpha_rate
from yuma_simulation_tpu_torch.ops.normalize import (
    SUM_BLOCKS,
    WEIGHT_EPS,
    miner_sum,
    miner_width,
    normalize_stake,
    sequential_sum,
    validator_sum,
)

#: Output keys of :func:`sharded_epoch` that stay split over the miner axis
#: (`[V, M]` matrices and `[M]` vectors); the rest are `[V]` vectors or
#: scalars on the last shard's device.
SHARDED_KEYS = (
    "weight",
    "server_prerank",
    "server_consensus_weight",
    "consensus_clipped_weight",
    "server_rank",
    "server_incentive",
    "server_trust",
    "weight_for_bond",
    "validator_bond",
    "validator_ema_bond",
    "validator_bonds",
    "bond_alpha",  # with liquid alpha; else one 0-d tensor
)


@dataclasses.dataclass(frozen=True)
class MinerLayout:
    """`num_miners` columns in `len(devices)` equal contiguous shards, shard
    `j` on `devices[j]` (devices may repeat: several shards on one card)."""

    devices: tuple
    num_miners: int

    @classmethod
    def build(cls, devices: Sequence, num_miners: int) -> "MinerLayout":
        """The layout with the JAX package's two refusals: a shard count that
        does not divide :data:`SUM_BLOCKS` (the blocks of `miner_sum` would
        straddle shards), and, for more than one shard, a miner count that
        is not a multiple of 8 or is under 16 (`miner_sum` is then one plain
        reduce, and the bitwise sharded == unsharded contract is lost)."""
        devices = tuple(torch.device(d) for d in devices)
        shards = len(devices)
        if shards < 1 or SUM_BLOCKS % shards:
            raise ValueError(
                f"miner-axis sharding supports mesh sizes dividing {SUM_BLOCKS} "
                f"(got {shards}): the partition-invariant miner_sum blocks must be "
                "shard-local for the bitwise sharded==unsharded contract"
            )
        if shards > 1 and (num_miners % SUM_BLOCKS or num_miners < 2 * SUM_BLOCKS):
            raise ValueError(
                f"miner-axis sharding over {shards} shards requires a miner count "
                f"that is a multiple of {SUM_BLOCKS} and at least {2 * SUM_BLOCKS} "
                f"(got M={num_miners}): below that, miner_sum's blocked "
                "partition-invariant spelling degrades to a plain reduce and the "
                "bitwise sharded==unsharded contract is lost — pad the miner axis "
                "or run unsharded"
            )
        return cls(devices=devices, num_miners=int(num_miners))

    @property
    def shards(self) -> int:
        return len(self.devices)

    @property
    def width(self) -> int:
        return self.num_miners // self.shards

    def bounds(self, j: int) -> tuple:
        return j * self.width, (j + 1) * self.width

    def shards_per_device(self) -> dict:
        """How many shards each physical device holds."""
        counts: dict = {}
        for d in self.devices:
            counts[d] = counts.get(d, 0) + 1
        return counts

    def split(self, x, dtype: Optional[torch.dtype] = None) -> tuple:
        """`x [..., M]` (a tensor anywhere, or a host array) as its column
        shards, each contiguous on its shard's device."""
        out = []
        for j, dev in enumerate(self.devices):
            lo, hi = self.bounds(j)
            if isinstance(x, torch.Tensor):
                part = x[..., lo:hi].to(device=dev, dtype=dtype or x.dtype)
            else:
                part = torch.as_tensor(np.ascontiguousarray(np.asarray(x)[..., lo:hi]),
                                       dtype=dtype).to(dev)
            out.append(part.contiguous())
        return tuple(out)

    def gather(self, shards: Sequence[torch.Tensor], device=None) -> torch.Tensor:
        """The shards concatenated along the miner axis on `device` (default
        the first shard's): a copy of the whole width, for a caller."""
        device = self.devices[0] if device is None else torch.device(device)
        return torch.cat([s.to(device) for s in shards], dim=-1)

    def host(self, shards: Sequence[torch.Tensor]) -> np.ndarray:
        """The shards gathered into one host array."""
        return np.concatenate([s.cpu().numpy() for s in shards], axis=-1)

    def miner_sum(self, shards: Sequence[torch.Tensor], keepdim: bool = False) -> torch.Tensor:
        """:func:`..ops.normalize.miner_sum` over the sharded last axis, in its
        order: each shard's blocks reduced left to right on its own device,
        then the chain over the block partials in block order, the running
        total carried from shard to shard. On the last shard's device. (A
        single shard is the unsharded sum, at any width.)"""
        if self.shards == 1:
            return miner_sum(shards[0], keepdim)
        per = SUM_BLOCKS // self.shards
        block = self.num_miners // SUM_BLOCKS
        total = None
        for x in shards:
            part = sequential_sum(x.reshape(x.shape[:-1] + (per, block)), -1)
            for i in range(per):
                total = part[..., i] if total is None else total.to(x.device) + part[..., i]
        return total.unsqueeze(-1) if keepdim else total

    def normalize_rows(self, W: Sequence[torch.Tensor]) -> tuple:
        """:func:`..ops.normalize.normalize_weight_rows` of sharded rows."""
        rows = self.miner_sum(W, keepdim=True)
        return tuple(w / (rows.to(w.device) + WEIGHT_EPS) for w in W)


@dataclasses.dataclass(frozen=True)
class MinerSharded:
    """One output of :func:`..parallel.sharded.shard_epoch_over_miners` that
    stays split over the miner axis: `shards[j]` holds the layout's
    columns of shard `j` on its device. :meth:`gather` copies the whole
    width onto one device for a caller."""

    layout: MinerLayout
    shards: tuple

    @property
    def shape(self) -> tuple:
        lead = tuple(self.shards[0].shape[:-1])
        return lead + (self.layout.num_miners,)

    def gather(self, device=None) -> torch.Tensor:
        return self.layout.gather(self.shards, device)

    def numpy(self) -> np.ndarray:
        return self.layout.host(self.shards)


def _median(consensus_impl: str, W_n, S_n, kappa, precision):
    if consensus_impl == "sorted":
        return stake_weighted_median_sorted(W_n, S_n, kappa, precision)
    if consensus_impl == "kernel":
        from yuma_simulation_tpu_torch.ops.cuda_consensus import stake_weighted_median_cuda

        return stake_weighted_median_cuda(W_n, S_n, kappa, precision)
    if consensus_impl == "bisect":
        return stake_weighted_median(W_n, S_n, kappa, precision)
    raise ValueError(f"unknown consensus_impl {consensus_impl!r}")


def _quantize(layout: MinerLayout, C_raw: tuple, config, rust64: bool, dtype) -> tuple:
    """`quantize_u16` of the sharded raw consensus with the whole row's sum:
    the exact grid count where the unsharded quantize takes it, else the
    blocked `miner_sum` (float64 for Yuma 0's parity mode)."""
    grid_bits = bisection_iterations(config.consensus_precision)
    sum_dtype = torch.float64 if rust64 else None
    if not rust64 and dyadic_grid_fits_int32(layout.num_miners, grid_bits):
        count = None
        for c in C_raw:
            part = dyadic_grid_count(c, grid_bits)
            count = part if count is None else count.to(c.device) + part
        denom = count.to(C_raw[0].dtype) * (2.0**-grid_bits)
    else:
        denom = layout.miner_sum([c.to(sum_dtype or c.dtype) for c in C_raw], keepdim=True)
    return tuple(
        quantize_u16(c, sum_dtype=sum_dtype, out_dtype=dtype, grid_bits=grid_bits,
                     denom=denom.to(c.device))
        for c in C_raw
    )


def sharded_dividends(layout: MinerLayout, B: Sequence[torch.Tensor], incentive: Sequence,
                      S_n: Optional[torch.Tensor] = None) -> tuple:
    """`(D [V], sum(D) [1])` of :func:`..models.epoch.dividends` at its plain
    spelling (every sharded epoch has `M >= 16`): `D = miner_sum(B *
    incentive)`, times `S_n` for Yuma 4, on the last shard's device."""
    D = layout.miner_sum([b * inc.unsqueeze(-2) for b, inc in zip(B, incentive)])
    if S_n is not None:
        D = S_n.to(D.device) * D
    return D, D.sum(dim=-1, keepdim=True)


def sharded_epoch(
    layout: MinerLayout,
    W: Sequence[torch.Tensor],
    S: torch.Tensor,
    B_old: Optional[Sequence[torch.Tensor]],
    config,
    *,
    bonds_mode: BondsMode = BondsMode.EMA,
    W_prev: Optional[Sequence[torch.Tensor]] = None,
    first_epoch=None,
    consensus_impl: str = "bisect",
    x64: bool = False,
) -> dict:
    """:func:`..models.epoch.yuma_epoch` over miner shards: `W`, `B_old` and
    `W_prev` are tuples of `[V, M/n]` shards, `S [V]` the raw stakes. The
    keys of :data:`SHARDED_KEYS` come back as tuples of shards, the `[V]`
    outputs on the last shard's device; ``"_rate"`` is the bond EMA rate
    as the bond update takes it (per shard)."""
    n = layout.shards
    devs = layout.devices
    dtype = W[0].dtype
    with miner_width(layout.num_miners):
        rows = layout.miner_sum(W, keepdim=True)
        W_n = tuple(w / (rows.to(w.device) + WEIGHT_EPS) for w in W)
        S_n0 = normalize_stake(torch.as_tensor(S, dtype=dtype).to(devs[0]))
        S_n = tuple(S_n0.to(d) for d in devs)
        P = tuple(validator_sum(s.unsqueeze(-1) * w) for s, w in zip(S_n, W_n))
        C_raw = tuple(
            _median(consensus_impl, w, s, config.kappa, config.consensus_precision)
            for w, s in zip(W_n, S_n)
        )
        rust64 = bonds_mode is BondsMode.EMA_RUST and x64
        C = _quantize(layout, C_raw, config, rust64, dtype)

        clip_base = W_n
        if bonds_mode is BondsMode.EMA_PREV and W_prev is not None:
            clip_base = tuple(W_prev)
        W_clipped = tuple(torch.minimum(cb, c.unsqueeze(-2)) for cb, c in zip(clip_base, C))
        R = tuple(validator_sum(s.unsqueeze(-1) * wc) for s, wc in zip(S_n, W_clipped))
        R_total = layout.miner_sum(R, keepdim=True)
        incentive = tuple(torch.nan_to_num(r / R_total.to(r.device)) for r in R)
        T = tuple(torch.nan_to_num(r / p) for r, p in zip(R, P))
        T_v = layout.miner_sum(W_clipped) / layout.miner_sum(W_n)

        last = devs[-1]
        nan = torch.tensor(float("nan"), dtype=dtype, device=last)
        a = b = nan
        if config.liquid_alpha and bonds_mode is not BondsMode.CAPACITY:
            # The quantiles sort the whole consensus row: gathered first.
            alpha, a, b = liquid_alpha_rate(
                layout.gather(C), config.alpha_low, config.alpha_high,
                override_consensus_high=config.override_consensus_high,
                override_consensus_low=config.override_consensus_low,
            )
            bond_alpha = layout.split(alpha)
            rate = tuple(_per_lane(r, w) for r, w in zip(bond_alpha, W_n))
        else:
            bond_alpha = config_value(config.bond_alpha, C[-1])
            rate = tuple(_per_lane(config_value(config.bond_alpha, c), w)
                         for c, w in zip(C, W_n))

        out = {
            "weight": W_n,
            "stake": S_n[-1],
            "server_prerank": P,
            "server_consensus_weight": C,
            "consensus_clipped_weight": W_clipped,
            "server_rank": R,
            "server_incentive": incentive,
            "_rate": rate,
        }
        old = tuple(B_old) if B_old is not None else (None,) * n
        if bonds_mode in EMA_MODES:
            targets = [
                ema_bonds_target(s, w, cb, wc, config, bonds_mode)
                for s, w, cb, wc in zip(S_n, W_n, clip_base, W_clipped)
            ]
            B = tuple(t for t, _ in targets)
            if targets[0][1] is not None:
                out["weight_for_bond"] = tuple(wb for _, wb in targets)
            B_ema = tuple(
                ema_bonds_update(bt, bo, r, first_epoch,
                                 renormalize=bonds_mode is BondsMode.EMA_RUST)
                for bt, bo, r in zip(B, old, rate)
            )
            D, D_tot = sharded_dividends(layout, B_ema, incentive)
            out.update(
                server_trust=T, validator_trust=T_v, validator_bond=B,
                validator_ema_bond=B_ema, bond_alpha=bond_alpha, alpha_a=a, alpha_b=b,
            )
        elif bonds_mode is BondsMode.CAPACITY:
            B = tuple(
                capacity_bonds_update(torch.zeros_like(w) if bo is None else bo, w, s, config)
                for bo, w, s in zip(old, W_n, S_n)
            )
            D, D_tot = sharded_dividends(layout, B, incentive)
            out.update(server_trust=T, validator_trust=T_v, validator_bonds=B)
        elif bonds_mode is BondsMode.RELATIVE:
            B = tuple(
                relative_bonds_update(torch.zeros_like(w) if bo is None else bo, w, r)
                for bo, w, r in zip(old, W_n, rate)
            )
            D, D_tot = sharded_dividends(layout, B, incentive, S_n[-1])
            out["validator_bonds"] = B
        else:  # pragma: no cover
            raise ValueError(f"unknown bonds mode: {bonds_mode}")
    out["validator_reward"] = D
    out["validator_reward_normalized"] = D / (D_tot + 1e-6)
    return out


def sharded_reset(layout: MinerLayout, B: Sequence[torch.Tensor], C_prev: Sequence[torch.Tensor],
                  epoch: int, reset_index: int, reset_epoch: int, conditional: bool) -> tuple:
    """:func:`..simulation.engine._apply_reset` on bond shards: zero the
    reset miner's column in the shard that holds it when the rule fires
    (`reset_epoch == epoch > 0`, and under the conditional rule only where
    that miner's previous consensus is 0)."""
    if not (reset_epoch == epoch and epoch > 0 and reset_index >= 0):
        return tuple(B)
    out = []
    for j, (b, c) in enumerate(zip(B, C_prev)):
        lo, hi = layout.bounds(j)
        if not lo <= reset_index < hi:
            out.append(b)
            continue
        col = torch.arange(hi - lo, device=b.device) == reset_index - lo
        if conditional:
            col = col & (c[reset_index - lo] == 0.0)
        out.append(torch.where(col.unsqueeze(-2), torch.zeros_like(b), b))
    return tuple(out)

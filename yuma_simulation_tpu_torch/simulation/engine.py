"""The epoch loop and the reference-compatible driver API.

The reference's `run_simulation` (reference simulation_utils.py:26-112) is
a Python `for` over epochs carrying `(B_state, W_prev, consensus)`. Here
the loop runs on one of these rungs:

- "fused_varying": the epoch-tiled varying scan (CUDA kernel K3);
- "fused_scan": the case scan (CUDA kernel K2; JAX steps it one epoch at a
  time, the port over tiles of up to 16 epochs, with the same results);
- "fused_varying_mxu" / "fused_scan_mxu": the same kernels with the
  consensus support sum on the tensor cores (K4), bitwise the same;
- "eager": a Python loop over :func:`..models.epoch.yuma_epoch` (the
  counterpart of the JAX package's XLA `lax.scan` rung).

Every entry point plans through :func:`..planner.plan_dispatch` (the scaled
ones through :func:`..planner.resolve_scaled_engine`). `epoch_impl="auto"`
resolves as the JAX package's planner does on the TPU: the varying scan
when its epoch tile reaches 2, else the case scan, for CUDA tensors;
"eager" on `device="cpu"`, as JAX's "auto" resolves to its XLA rung off the
TPU, and where the dyadic quantize grid no longer fits int32 (the fused and
eager quantize fallbacks may differ by an ulp there, so "auto" never mixes
them), and for a padded suite with per-scenario miner masks, which only the
eager rung takes. "xla", JAX's name of the bottom rung, runs "eager". The
fused rungs on CPU tensors run the kernels' plain PyTorch versions.

Resilience: `retry_policy=` runs a dispatch down the engine ladder
(:mod:`..resilience.retry`: each classified failure retried, then demoted
one rung, every rung on the same device) and `deadline=` under the
watchdog (:mod:`..resilience.watchdog`); the eager rung hosts the per-lane
quarantine guard and the fault hooks' operands
(:mod:`..resilience.guards`, :mod:`..resilience.faults`).

Long runs: :func:`simulate` with `max_resident_epochs`, and
:func:`simulate_streamed`, run the epoch stack in slabs with the carry
threaded between them, the next slab's copy to the card overlapping the
scan over the current one; :func:`simulate_generated` runs slabs that a
function builds on the card. Both are bitwise the monolithic run on the
same rung.

The throughput paths (:func:`simulate_scaled`, :func:`simulate_scaled_batch`,
:func:`simulate_constant`) return dividend totals and the final bonds
only: the scaled ones run the scaled scan (K5) or the per-epoch fused
kernel (K6) on the card, or the eager loop.
"""

from __future__ import annotations

import collections
import collections.abc
import contextlib
import itertools
import time
from dataclasses import dataclass, field, fields, replace
from typing import Optional

import numpy as np
import torch

from yuma_simulation_tpu_torch.models.config import YumaConfig
from yuma_simulation_tpu_torch.models.epoch import (
    EMA_MODES,
    BondsMode,
    _per_lane,
    config_value,
    capacity_bonds_update,
    dividends,
    ema_bonds_update,
    relative_bonds_update,
    yuma_epoch,
)
from yuma_simulation_tpu_torch.models.miner_shards import (
    MinerLayout,
    sharded_dividends,
    sharded_epoch,
    sharded_reset,
)
from yuma_simulation_tpu_torch.models.variants import (
    ResetMode,
    VariantSpec,
    variant_for_version,
)
from yuma_simulation_tpu_torch.ops.consensus import resolve_consensus_impl
from yuma_simulation_tpu_torch.ops.cuda_epoch import (
    fused_case_scan,
    fused_ema_epoch,
    fused_ema_scan,
    fused_varying_scan,
)
from yuma_simulation_tpu_torch.ops.fingerprint import flip_ulp
from yuma_simulation_tpu_torch.ops.liquid import liquid_alpha_rate
from yuma_simulation_tpu_torch.ops.normalize import (
    miner_width,
    normalize_stake,
    normalize_weight_rows,
)
from yuma_simulation_tpu_torch.resilience import faults
from yuma_simulation_tpu_torch.resilience.errors import classify_failure
from yuma_simulation_tpu_torch.resilience.guards import quarantine_init, quarantine_step
from yuma_simulation_tpu_torch.scenarios.base import Scenario
from yuma_simulation_tpu_torch.simulation.carry import (
    HoistedCarry,
    ScaledCarry,
    ScanCarry,
    TotalsCarry,
)
from yuma_simulation_tpu_torch.simulation.planner import (
    FUSED_CASE_RUNGS,
    STREAM_BUFFERS,
    plan_dispatch,
    resolve_scaled_engine,
    rung_flags,
)
# The module, not its names: numerics imports simulation.carry, which
# imports this package.
from yuma_simulation_tpu_torch.telemetry import numerics as _numerics
from yuma_simulation_tpu_torch.telemetry.runctx import dispatch_annotation
from yuma_simulation_tpu_torch.telemetry.slo import observe_dispatch
from yuma_simulation_tpu_torch.utils.profiling import timed

#: Above this many bytes for one saved per-epoch stream, `save_bonds="auto"`
#: / `save_incentives="auto"` resolve to False.
SAVE_AUTO_LIMIT_BYTES = 1 << 30


@dataclass
class SimulationResult:
    """Host-side view of one simulated scenario."""

    dividends: np.ndarray  # [E, V] dividend per 1000 tao per epoch
    bonds: Optional[np.ndarray]  # [E, V, M] post-epoch bond state
    incentives: Optional[np.ndarray]  # [E, M] server incentive
    consensus: Optional[np.ndarray]  # [E, M] quantized consensus
    #: The carry after the last epoch (``{"bonds", "consensus"[, "w_prev"]}``
    #: host arrays), only with ``return_state=True``; fed back as
    #: ``initial_state=`` with ``epoch_offset=`` it continues the run.
    final_state: Optional[dict] = None
    #: Per-epoch numerics sketches of the output streams,
    #: ``{stream: NumericsSketch}`` with `[E]` numpy leaves
    #: (:mod:`..telemetry.numerics`); None when ``YUMA_NUMERICS=0``.
    numerics: Optional[dict] = None
    #: The rung that ran (one of :data:`..planner.FUSED_CASE_RUNGS`, or "eager").
    engine: str = ""
    #: The ladder's demotions on the way to `engine`
    #: (:class:`..resilience.retry.DemotionRecord`), with `retry_policy`;
    #: None when no demotion happened.
    demotions: Optional[tuple] = None


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA (the default) must be
    present: an entry point never continues on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def backend_name(dev: torch.device) -> str:
    """The JAX package's platform name of a device: "gpu" for CUDA, "cpu"."""
    return "gpu" if dev.type == "cuda" else dev.type


def _dividends_per_1k(D_n, S, config):
    """Dividend per 1000 tao (reference simulation_utils.py:45-49,
    95-107), from normalized dividends and the raw stakes. The divide by
    1000 is a multiply by float32(0.001), as XLA compiles it."""
    ratio, total, stake = (
        config_value(x, S) if np.ndim(x) else x  # a grid's [B] field, per scenario
        for x in (config.validator_emission_ratio, config.total_epoch_emission,
                  config.total_subnet_stake)
    )
    stakes_units = S * stake * 0.001
    emission = ratio * D_n * total
    return torch.where(stakes_units > 1e-6, emission / stakes_units, 0.0)


def fused_hparams(config: YumaConfig) -> dict:
    """The one config -> fused-kernel hyperparameter mapping."""
    return dict(
        kappa=config.kappa,
        bond_penalty=config.bond_penalty,
        bond_alpha=config.bond_alpha,
        capacity_alpha=config.capacity_alpha,
        decay_rate=config.decay_rate,
        liquid_alpha=config.liquid_alpha,
        alpha_low=config.alpha_low,
        alpha_high=config.alpha_high,
        override_consensus_high=config.override_consensus_high,
        override_consensus_low=config.override_consensus_low,
        precision=config.consensus_precision,
    )


def _map_config(config: YumaConfig, fn) -> YumaConfig:
    """`config` with each field's value `v` replaced by `fn(field, v)`."""

    def conv(dc):
        return replace(dc, **{f.name: fn(f, getattr(dc, f.name)) for f in fields(dc)})

    return YumaConfig(simulation=conv(config.simulation), yuma_params=conv(config.yuma_params))


def _tensor_config(config: YumaConfig, device) -> YumaConfig:
    """The config with its float fields as float32 tensors — what JAX's
    jitted engine sees of its config (traced leaves), which selects the
    float32 logit branch of the liquid-alpha fit: a scalar as a 0-d tensor,
    a `[B]` field of a :func:`..sweep.config_grid` grid as a `[B]` tensor
    (its consumers broadcast it per lane)."""

    def conv(f, v):
        if f.type != "float":
            return v
        if np.ndim(v):
            return torch.as_tensor(v, dtype=torch.float32).to(device)
        if isinstance(v, (int, float)):
            return torch.tensor(float(v), dtype=torch.float32, device=device)
        return v

    return _map_config(config, conv)


def zero_carry(spec: VariantSpec, V: int, M: int, dtype=torch.float32, device="cuda") -> dict:
    """The carry at global epoch 0, as the engines' zero-init makes it:
    `bonds [V, M]`, `consensus [M]`, and `w_prev [V, M]` for a variant that
    carries previous weights; on the card unless `device` says otherwise."""
    dev = resolve_device(device)
    carry = {
        "bonds": torch.zeros((V, M), dtype=dtype, device=dev),
        "consensus": torch.zeros((M,), dtype=dtype, device=dev),
    }
    if spec.carries_prev_weights:
        carry["w_prev"] = torch.zeros((V, M), dtype=dtype, device=dev)
    return carry


def config_is_batched(config: YumaConfig) -> bool:
    """Whether any field of the config carries a leading batch axis (a
    :func:`..sweep.config_grid` grid). One shared predicate: the engines
    agree on what counts as batched."""
    return any(
        np.ndim(getattr(part, f.name)) > 0
        for part in (config.simulation, config.yuma_params)
        for f in fields(part)
    )


def config_vmap_axes(config: YumaConfig) -> YumaConfig:
    """Per field, 0 where it carries the batch axis and None where it is
    shared: which fields of a partly batched config vary per lane."""
    return _map_config(config, lambda _, v: 0 if np.ndim(v) else None)


def config_lanes(config: YumaConfig, lanes: Optional[int] = None) -> int:
    """The lane count of a batched config (1 for a scalar one): every
    batched field must hold one value per lane, and `lanes` of them when
    given (one per scenario of a batch)."""
    sizes = {
        np.shape(getattr(part, f.name))
        for part in (config.simulation, config.yuma_params)
        for f in fields(part)
        if np.ndim(getattr(part, f.name))
    }
    want = {(lanes,)} if lanes is not None else sizes
    if len(sizes) > 1 or (sizes and sizes != want):
        raise ValueError(
            f"batched config fields have shapes {sorted(sizes)}; a batched config "
            f"needs one value per scenario ({lanes if lanes is not None else 'all alike'})"
        )
    return sizes.pop()[0] if sizes else 1


def _miner_shardings(mesh, num_miners: int) -> MinerLayout:
    """The miner-axis layout of `mesh`: the miner axis split over the mesh's
    last (``model``) axis, shard `j` on the `j`-th device of the mesh's
    first row (further rows would hold replicas of the same split; the
    port computes it once). Refuses, as the JAX package does, a model
    width that does not divide :data:`..ops.normalize.SUM_BLOCKS` (8), and
    more than one shard over a miner count that is not a multiple of 8 or
    is under 16 (:meth:`..models.miner_shards.MinerLayout.build`). Each
    device must be usable (a CUDA entry needs CUDA)."""
    row = mesh.grid[0]
    return MinerLayout.build([resolve_device(d.device) for d in row], num_miners)


def _preflight_miner_shards(label: str, layout: MinerLayout, V: int, **estimate_kwargs):
    """The HBM preflight of a miner-sharded dispatch, per physical device:
    one shard's footprint (:func:`..telemetry.cost.estimate_hbm_bytes` with
    `miner_shards`) times the shards that share the device, so four shards
    on one card are held to one card's memory. Host arithmetic, before
    anything is allocated; raises :class:`..telemetry.cost.HBMPreflightError`."""
    from yuma_simulation_tpu_torch.telemetry.cost import estimate_hbm_bytes, preflight_hbm

    for dev, count in layout.shards_per_device().items():
        estimate = estimate_hbm_bytes(
            V, layout.num_miners, miner_shards=layout.shards, shards_per_device=count,
            **estimate_kwargs,
        )
        preflight_hbm(label, estimate, device=dev)


def _apply_reset(B, C_prev, epoch: int, reset_index, reset_epoch, reset_mode, M):
    """Zero the reset miner's bond column when the variant's rule fires
    (reference simulation_utils.py:62-88); `reset_epoch < 0` disables and
    the rule needs `epoch > 0`. Leading batch dims broadcast."""
    do = (reset_epoch == epoch) & (epoch > 0) & (reset_index >= 0)
    if reset_mode is ResetMode.CONDITIONAL:
        idx = reset_index.clamp(0, M - 1).long().unsqueeze(-1)
        prev_c = torch.gather(C_prev, -1, idx).squeeze(-1)
        do = do & (prev_c == 0.0)
    col = (torch.arange(M, device=B.device) == reset_index.unsqueeze(-1)) & do.unsqueeze(-1)
    return torch.where(col.unsqueeze(-2), torch.zeros_like(B), B)


def _simulate_scan(
    weights: torch.Tensor,  # [(B,) E, V, M]
    stakes: torch.Tensor,  # [(B,) E, V]
    reset_index: torch.Tensor,  # int, scalar or [B], -1 = none
    reset_epoch: torch.Tensor,
    config: YumaConfig,
    spec: VariantSpec,
    *,
    save_bonds: bool = True,
    save_incentives: bool = True,
    save_consensus: bool = False,
    consensus_impl: str = "bisect",
    miner_mask: Optional[torch.Tensor] = None,  # [(B,) M] 1 = real, 0 = padding
    carry: Optional[dict] = None,
    epoch_offset: int = 0,
    return_carry: bool = False,
    x64: bool = False,
    capture_numerics: bool = False,
    guard_nonfinite: bool = False,
    nan_fault_epoch=None,  # int or [B] int tensor, -1 = off
    drift_fault_epoch=None,  # int or [B] int tensor, -1 = off
):
    """The eager rung: a Python loop over :func:`yuma_epoch`, threading a
    :class:`..carry.ScanCarry` (bonds, w_prev, consensus). Returns the
    per-epoch outputs stacked on the epoch axis (`dividends [(B,) E, V]`,
    ...), plus the final carry with `return_carry`. `miner_mask` marks a
    padded suite's real miner columns, per scenario (`[B, M]`) or shared
    (`[M]`). `capture_numerics` adds ``ys["numerics"]``: the sketches of
    the dividends and of the per-epoch consensus, saved or not, as the JAX
    package's XLA rung takes them.

    `guard_nonfinite` folds the per-lane quarantine
    (:mod:`..resilience.guards`) into the carry: each epoch's outputs are
    isfinite-checked per lane, the first failure latches `(first_bad_epoch,
    tensor_code)`, and from that epoch on every output and the carry of
    that lane are zero; healthy lanes are bitwise an unguarded run. The
    state stays on the device and rides ``ys["quarantine"]``.

    `nan_fault_epoch` / `drift_fault_epoch` are the fault hooks' operands
    (:func:`..resilience.faults.active_nan_fault` / `active_drift_fault`):
    at that global epoch the lane's dividends become NaN, or validator 0's
    dividend moves by one ulp; -1 leaves the lane alone."""
    if guard_nonfinite and (carry is not None or return_carry):
        raise ValueError(
            "guard_nonfinite does not compose with chunked streaming "
            "carries; run the quarantine on monolithic scans"
        )
    *lead, E, V, M = weights.shape
    dtype, dev = weights.dtype, weights.device
    cfg = _tensor_config(config, dev)
    ri = torch.as_tensor(reset_index, device=dev)
    r_epoch = torch.as_tensor(reset_epoch, device=dev)
    if miner_mask is not None:
        miner_mask = torch.as_tensor(miner_mask, dtype=dtype).to(dev)
    prev = spec.carries_prev_weights
    if carry is None:
        zeros = torch.zeros(tuple(lead) + (V, M), dtype=dtype, device=dev)
        state = ScanCarry(
            bonds=zeros, w_prev=zeros if prev else None,
            consensus=torch.zeros(tuple(lead) + (M,), dtype=dtype, device=dev),
            quarantine=quarantine_init(lead, dev) if guard_nonfinite else None,
        )
    else:
        def take(key):
            return torch.as_tensor(carry[key], dtype=dtype).to(dev)

        bonds = take("bonds")
        w_prev = take("w_prev") if "w_prev" in carry else torch.zeros_like(bonds)
        state = ScanCarry(bonds=bonds, w_prev=w_prev if prev else None,
                          consensus=take("consensus"))
    ys: dict = {"dividends": []}
    if save_bonds:
        ys["bonds"] = []
    if save_incentives:
        ys["incentives"] = []
    if save_consensus or capture_numerics:
        ys["consensus"] = []
    nan_at = None if nan_fault_epoch is None else torch.as_tensor(nan_fault_epoch, device=dev)
    drift_at = None if drift_fault_epoch is None else torch.as_tensor(drift_fault_epoch, device=dev)
    for e in range(E):
        epoch = e + epoch_offset
        W = weights[..., e, :, :]
        S = stakes[..., e, :]
        B = state.bonds
        if spec.reset_mode is not ResetMode.NONE:
            B = _apply_reset(B, state.consensus, epoch, ri, r_epoch, spec.reset_mode, M)
        kernel_prev = None
        if prev:
            # Epoch 0 falls back to this epoch's normalized weights
            # (reference yumas.py:299-300).
            kernel_prev = normalize_weight_rows(W) if epoch == 0 else state.w_prev
        res = yuma_epoch(
            W, S, B, cfg,
            bonds_mode=spec.bonds_mode,
            W_prev=kernel_prev,
            first_epoch=epoch == 0,
            miner_mask=miner_mask,
            consensus_impl=consensus_impl,
            x64=x64,
        )
        bonds = res[spec.bond_state_key]
        w_prev = res["weight"] if prev else None
        consensus = res["server_consensus_weight"]
        incentive = res["server_incentive"]
        div = _dividends_per_1k(res["validator_reward_normalized"], S, cfg)
        if nan_at is not None:
            poison = (nan_at == epoch).unsqueeze(-1)
            div = torch.where(poison, torch.full_like(div, float("nan")), div)
        if drift_at is not None:
            # One ulp on validator 0 at the lane's drift epoch: the
            # smallest drift the numerics canary must localize.
            flip = (drift_at == epoch).unsqueeze(-1) & (torch.arange(V, device=dev) == 0)
            div = torch.where(flip, flip_ulp(div), div)
        qstate = None
        if guard_nonfinite:
            # Priority-ordered health check (codes index
            # guards.QUARANTINE_TENSORS); the mask zeroes this lane's
            # carry and outputs from the first bad epoch on. The incentive
            # stream is checked only when it is emitted.
            checks = [(0, div), (1, bonds), (2, consensus)]
            if prev:
                checks.append((3, w_prev))
            if save_incentives:
                checks.append((4, incentive))
            qstate, qmask = quarantine_step(state.quarantine, epoch, checks)
            div, bonds, consensus = qmask(div), qmask(bonds), qmask(consensus)
            w_prev = qmask(w_prev) if prev else None
            incentive = qmask(incentive) if save_incentives else incentive
        state = ScanCarry(bonds=bonds, w_prev=w_prev, consensus=consensus, quarantine=qstate)
        ys["dividends"].append(div)
        if save_bonds:
            ys["bonds"].append(state.bonds)
        if save_incentives:
            ys["incentives"].append(incentive)
        if "consensus" in ys:
            ys["consensus"].append(state.consensus)
    axis = len(lead)
    ys = {k: torch.stack(v, dim=axis) for k, v in ys.items()}
    if capture_numerics:
        streams = {"dividends": ys["dividends"], "consensus": ys["consensus"]}
        ys["numerics"] = _numerics.capture_streams(streams, epoch_axis=axis)
    if not save_consensus:
        ys.pop("consensus", None)
    if guard_nonfinite:
        ys["quarantine"] = state.quarantine
    if not return_carry:
        return ys
    return ys, state.to_dict()


def _simulate_scan_miners(
    layout: MinerLayout,
    weights,  # [E, V, M], host array or tensor
    stakes,  # [E, V]
    reset_index: int,
    reset_epoch: int,
    config: YumaConfig,
    spec: VariantSpec,
    *,
    save_bonds: bool = True,
    save_incentives: bool = True,
    save_consensus: bool = False,
    consensus_impl: str = "bisect",
    carry: Optional[dict] = None,
    epoch_offset: int = 0,
    return_carry: bool = False,
    x64: bool = False,
    capture_numerics: bool = False,
    nan_fault_epoch=None,
    dtype: torch.dtype = torch.float32,
):
    """The eager rung with the miner axis sharded over `layout`
    (:mod:`..models.miner_shards`): each shard's columns of the weights,
    the bonds, the previous weights and the consensus live on its device
    for the whole run, and every epoch is :func:`..models.miner_shards.
    sharded_epoch`, bitwise :func:`_simulate_scan`'s on the same inputs.
    Returns :func:`_simulate_scan`'s ys, except that the `[E, V, M]` bonds
    and the `[E, M]` incentives and consensus stay tuples of per-shard
    stacks (the dividends, `[E, V]`, are on the last shard's device); the
    carry with `return_carry` comes back gathered onto the first shard's
    device."""
    E, V, M = tuple(np.shape(weights))
    first_dev, last_dev = layout.devices[0], layout.devices[-1]
    cfg = _tensor_config(config, first_dev)
    W_all = layout.split(weights, dtype)
    S_all = torch.as_tensor(stakes, dtype=dtype).to(last_dev)
    prev = spec.carries_prev_weights
    if carry is None:
        bonds = tuple(torch.zeros((V, layout.width), dtype=dtype, device=d) for d in layout.devices)
        w_prev = bonds if prev else None
        consensus = tuple(torch.zeros((layout.width,), dtype=dtype, device=d)
                          for d in layout.devices)
    else:
        bonds = layout.split(torch.as_tensor(carry["bonds"], dtype=dtype))
        consensus = layout.split(torch.as_tensor(carry["consensus"], dtype=dtype))
        w_prev = layout.split(torch.as_tensor(carry["w_prev"], dtype=dtype)) if prev else None
    ys: dict = {"dividends": []}
    if save_bonds:
        ys["bonds"] = []
    if save_incentives:
        ys["incentives"] = []
    if save_consensus or capture_numerics:
        ys["consensus"] = []
    conditional = spec.reset_mode is ResetMode.CONDITIONAL
    for e in range(E):
        epoch = e + epoch_offset
        W = tuple(w[e] for w in W_all)
        S = S_all[e]
        B = bonds
        if spec.reset_mode is not ResetMode.NONE:
            B = sharded_reset(layout, B, consensus, epoch, reset_index, reset_epoch, conditional)
        kernel_prev = None
        if prev:
            kernel_prev = layout.normalize_rows(W) if epoch == 0 else w_prev
        res = sharded_epoch(
            layout, W, S, B, cfg, bonds_mode=spec.bonds_mode, W_prev=kernel_prev,
            first_epoch=epoch == 0, consensus_impl=consensus_impl, x64=x64,
        )
        bonds = res[spec.bond_state_key]
        w_prev = res["weight"] if prev else None
        consensus = res["server_consensus_weight"]
        div = _dividends_per_1k(res["validator_reward_normalized"], S, cfg)
        if nan_fault_epoch is not None and nan_fault_epoch == epoch:
            div = torch.full_like(div, float("nan"))
        ys["dividends"].append(div)
        for key, value in (("bonds", bonds), ("incentives", res["server_incentive"]),
                           ("consensus", consensus)):
            if key in ys:
                ys[key].append(value)
    out = {"dividends": torch.stack(ys.pop("dividends"))}
    for key, steps in ys.items():
        out[key] = tuple(torch.stack([step[j] for step in steps]) for j in range(layout.shards))
    if capture_numerics:
        streams = {"dividends": out["dividends"],
                   "consensus": layout.gather(out["consensus"], last_dev)}
        out["numerics"] = _numerics.capture_streams(streams, epoch_axis=0)
    if not save_consensus:
        out.pop("consensus", None)
    if not return_carry:
        return out
    state = {"bonds": layout.gather(bonds), "consensus": layout.gather(consensus)}
    if prev:
        state["w_prev"] = layout.gather(w_prev)
    return out, state


def _simulate_case_fused(
    weights: torch.Tensor,  # [(B,) E, V, M]
    stakes: torch.Tensor,
    reset_index,
    reset_epoch,
    config: YumaConfig,
    spec: VariantSpec,
    *,
    save_bonds: bool = True,
    save_incentives: bool = True,
    save_consensus: bool = False,
    varying: bool = False,
    mxu: bool = False,
    epoch_tile: Optional[int] = None,
    carry: Optional[dict] = None,
    epoch_offset: int = 0,
    return_carry: bool = False,
    x64: bool = False,
    capture_numerics: bool = False,
):
    """The fused rungs: the whole epoch loop in the case scan (K2) or the
    varying scan (K3, `varying=True`), with the support sum on the tensor
    cores (K4) under `mxu`; only the dividend-per-1000-tao conversion
    happens out here. Returns the same ys dict as :func:`_simulate_scan`;
    its numerics sketch the dividends, and the consensus only when it is
    saved, as the JAX package's fused rungs do."""
    kwargs = dict(
        reset_index=reset_index,
        reset_epoch=reset_epoch,
        reset_mode=spec.reset_mode,
        mode=spec.bonds_mode,
        save_bonds=save_bonds,
        save_incentives=save_incentives,
        save_consensus=save_consensus,
        carry=carry,
        epoch_offset=epoch_offset,
        return_carry=return_carry,
        x64=x64,
        mxu=mxu,
        **fused_hparams(config),
    )
    if varying:
        res = fused_varying_scan(weights, stakes, epoch_tile=epoch_tile, **kwargs)
    else:
        res = fused_case_scan(weights, stakes, **kwargs)
    ys = {"dividends": _dividends_per_1k(res["dividends_normalized"], stakes, config)}
    for key in ("bonds", "incentives", "consensus"):
        if key in res:
            ys[key] = res[key]
    if capture_numerics:
        streams = {k: ys[k] for k in ("dividends", "consensus") if k in ys}
        ys["numerics"] = _numerics.capture_streams(
            streams, epoch_axis=1 if weights.ndim == 4 else 0
        )
    if not return_carry:
        return ys
    carry_out = {"bonds": res["final_bonds"], "consensus": res["final_consensus"]}
    if spec.carries_prev_weights:
        carry_out["w_prev"] = res["final_w_prev"]
    return ys, carry_out


def _resolve_save(flag, nbytes: int, name: str) -> bool:
    if flag == "auto":
        return nbytes <= SAVE_AUTO_LIMIT_BYTES
    if not isinstance(flag, bool):
        raise ValueError(f"{name} must be True, False or 'auto', got {flag!r}")
    return flag


def validate_initial_state(initial_state, spec: VariantSpec, V: int, M: int) -> dict:
    """`initial_state` must be the carry dict of a `return_state=True` run:
    `bonds [V, M]`, `consensus [M]`, and `w_prev [V, M]` exactly when the
    variant carries previous weights."""
    if not isinstance(initial_state, dict):
        raise ValueError(
            "initial_state must be the carry dict of a return_state=True run, "
            f"got {type(initial_state).__name__}"
        )
    want = {"bonds": (V, M), "consensus": (M,)}
    if spec.carries_prev_weights:
        want["w_prev"] = (V, M)
    if set(initial_state) != set(want):
        raise ValueError(
            f"initial_state has keys {sorted(initial_state)}; this variant's "
            f"carry is {sorted(want)}"
        )
    for key, shape in want.items():
        got = tuple(np.shape(initial_state[key]))
        if got != shape:
            raise ValueError(f"initial_state[{key!r}] has shape {got}, expected {shape}")
    return initial_state


def simulate(
    scenario: Scenario,
    yuma_version: str,
    config: Optional[YumaConfig] = None,
    *,
    save_bonds="auto",
    save_incentives="auto",
    save_consensus: bool = False,
    consensus_impl: str = "bisect",
    epoch_impl: str = "auto",
    dtype: torch.dtype = torch.float32,
    mesh=None,
    max_resident_epochs: Optional[int] = None,
    retry_policy=None,
    deadline=None,
    initial_state: Optional[dict] = None,
    epoch_offset: int = 0,
    return_state: bool = False,
    device="cuda",
    x64: bool = False,
) -> SimulationResult:
    """Simulate one scenario under one named version; returns host arrays.

    `epoch_impl`: "auto" (default; see the module docstring), "eager"
    ("xla", the JAX package's name, runs it), "fused_scan", "fused_varying"
    or their tensor-core twins "fused_scan_mxu" / "fused_varying_mxu".
    `consensus_impl`: "bisect" (default), "sorted", "kernel" (the CUDA
    bisection kernel inside the eager rung) or "auto"; the fused rungs
    bisect in-kernel. `x64=True` runs Yuma 0's quantization divide in
    float64, the JAX package's parity mode.

    The dispatch plan (:func:`..planner.plan_dispatch`) preflights the
    footprint before anything is copied to the card: a stack that cannot
    fit raises :class:`..telemetry.cost.HBMPreflightError`, which names a
    `max_resident_epochs` that would.

    `max_resident_epochs`: when set and the scenario is longer, the epoch
    stack runs in slabs of that many epochs through
    :func:`simulate_streamed` (the next slab's copy overlapping the scan
    over the current one; on the card two slabs resident at a time),
    bitwise the monolithic run on the same rung. The plan may cut the slabs
    further, to its `memory.chunk_epochs`.

    `initial_state` / `epoch_offset` / `return_state`: the `final_state` of
    a `return_state=True` run fed back with `epoch_offset` set to that run's
    epoch count continues the trajectory over global epochs
    `[offset, offset + E)`.

    `retry_policy` (a :class:`..resilience.retry.RetryPolicy`, default None
    = fail fast): arm the engine-degradation ladder. A classified engine
    failure (out of memory, a stall) retries on the same rung with
    jittered backoff, then demotes one rung down `plan.ladder`
    (fused_varying -> fused_scan_mxu -> fused_scan, and on the CPU on to
    eager), logging one ``event=engine_demoted`` record per step; the rung
    that ran is `result.engine` and the walk `result.demotions`. Every rung
    runs on `device`; on the card a kernel that will not build or launch
    raises at once, and a fused plan never demotes to the eager rung
    (:mod:`..resilience.retry`). Caller errors are never retried.

    `deadline` (a :class:`..resilience.watchdog.Deadline`, default None =
    unbounded): each dispatch runs on a supervised worker thread and ends
    in a synchronize of its stream; one that posts no heartbeat within the
    budget raises a typed `EngineStall`, which with `retry_policy` retries
    and demotes like any engine failure. The streamed path
    (`max_resident_epochs`) takes `retry_policy` only, as the JAX
    package's does.

    `mesh` (a :class:`..parallel.mesh.Mesh`): the miner axis of every
    `[V, M]` matrix and `[M]` vector is split over the mesh's ``model``
    axis for the whole run, shard `j` on the `j`-th device of the mesh's
    first row, and `device` is not used. The plan takes the eager rung
    (the fused rungs are single-device kernels, and an explicit one
    raises), and the result is bitwise the unsharded eager run for every
    version (:mod:`..models.miner_shards`). Streaming cannot be combined
    with a mesh.
    """
    layout = None
    if mesh is not None:
        layout = _miner_shardings(mesh, np.shape(scenario.weights)[-1])
        dev = layout.devices[0]
        if layout.shards == 1:  # the unsharded program on the mesh's device
            layout = None
    else:
        dev = resolve_device(device)
    config = config if config is not None else YumaConfig()
    spec = variant_for_version(yuma_version)
    E, V, M = np.shape(scenario.weights)
    if initial_state is not None:
        validate_initial_state(initial_state, spec, V, M)
    if epoch_offset < 0:
        raise ValueError(f"epoch_offset must be >= 0, got {epoch_offset}")
    if max_resident_epochs is not None and max_resident_epochs < 1:
        raise ValueError(f"max_resident_epochs must be >= 1, got {max_resident_epochs}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    save_bonds = _resolve_save(save_bonds, E * V * M * itemsize, "save_bonds")
    save_incentives = _resolve_save(save_incentives, E * M * itemsize, "save_incentives")
    will_stream = max_resident_epochs is not None and E > max_resident_epochs
    # A streamed run is planned on the whole stack's rung, not re-decided on
    # its first slab, so it stays bitwise the monolithic run; its memory is
    # planned by simulate_streamed, on the slabs.
    plan = plan_dispatch(
        f"simulate:{yuma_version}", (E, V, M), spec, config, dtype,
        epoch_impl=epoch_impl, consensus_impl=consensus_impl, save_bonds=save_bonds,
        save_incentives=save_incentives, save_consensus=save_consensus,
        max_resident_epochs=max_resident_epochs, check_memory=not will_stream, device=dev,
        mesh=mesh,
    )
    if will_stream:
        if mesh is not None:
            raise ValueError(
                "max_resident_epochs streaming is single-device; it cannot be "
                "combined with a miner-sharding mesh"
            )

        def chunk_gen():
            for lo in range(0, E, max_resident_epochs):
                hi = min(lo + max_resident_epochs, E)
                yield scenario.weights[lo:hi], scenario.stakes[lo:hi]

        return simulate_streamed(
            # Re-iterable, not a one-shot generator: the whole stack lives on
            # the scenario, so a demotion under retry_policy can restart the
            # stream from chunk 0 wherever the failure surfaced.
            _ReiterableChunks(chunk_gen), yuma_version, config,
            reset_bonds_index=scenario.reset_bonds_index,
            reset_bonds_epoch=scenario.reset_bonds_epoch,
            save_bonds=save_bonds, save_incentives=save_incentives,
            save_consensus=save_consensus, consensus_impl=plan.consensus_impl,
            epoch_impl=plan.engine, dtype=dtype, retry_policy=retry_policy,
            initial_state=initial_state, epoch_offset=epoch_offset,
            return_state=return_state, device=dev, x64=x64,
        )
    plan.record()
    if layout is None:
        weights = torch.as_tensor(scenario.weights, dtype=dtype).to(dev)
        stakes = torch.as_tensor(scenario.stakes, dtype=dtype).to(dev)
    capture = _numerics.numerics_enabled()

    def dispatch(rung: str):
        # The carry is made afresh for every attempt: a retried rung must
        # see untouched inputs.
        carry = None
        if initial_state is not None:
            carry = {
                k: torch.as_tensor(np.array(v), dtype=dtype).to(dev)
                for k, v in initial_state.items()
            }
        eager_kwargs = {}
        if rung not in FUSED_CASE_RUNGS:
            nf = faults.active_nan_fault()
            if nf is not None and nf.case is None:
                eager_kwargs["nan_fault_epoch"] = nf.epoch
        if layout is not None:
            with dispatch_annotation(f"simulate:{rung}"):
                return _simulate_scan_miners(
                    layout, scenario.weights, scenario.stakes,
                    _reset_int(scenario.reset_bonds_index),
                    _reset_int(scenario.reset_bonds_epoch), config, spec,
                    save_bonds=save_bonds, save_incentives=save_incentives,
                    save_consensus=save_consensus, consensus_impl=plan.consensus_impl,
                    carry=carry, epoch_offset=epoch_offset, return_carry=return_state,
                    x64=x64, capture_numerics=capture, dtype=dtype,
                    nan_fault_epoch=eager_kwargs.get("nan_fault_epoch"),
                )
        with dispatch_annotation(f"simulate:{rung}"):
            out = _dispatch_case(
                plan.demoted(rung), weights, stakes, _reset_int(scenario.reset_bonds_index),
                _reset_int(scenario.reset_bonds_epoch), config, spec,
                eager_kwargs=eager_kwargs, save_bonds=save_bonds,
                save_incentives=save_incentives, save_consensus=save_consensus,
                carry=carry, epoch_offset=epoch_offset, return_carry=return_state,
                x64=x64, capture_numerics=capture,
            )
        return out

    # One epoch-rate record a run: the dispatch and the host fetch timed
    # together, through the metrics registry (`epochs_total` /
    # `epochs_per_sec`, one `event=epoch_rate` line).
    from yuma_simulation_tpu_torch.resilience.retry import supervise

    t_dispatch = timed(f"simulate:{yuma_version}", epochs=E)
    with t_dispatch:
        out, engine_used, records = supervise(
            dispatch, plan, retry_policy, deadline, label=yuma_version
        )
        demotions = tuple(records) or None
        state = None
        if return_state:
            out, carry_out = out
        sketches = out.pop("numerics", None)
        # The sketches' one copy rides the outputs' own: it is queued first
        # and complete once they are on the host.
        fetch = _numerics.HostFetch(sketches) if sketches is not None else None
        if return_state:
            state = {k: v.cpu().numpy() for k, v in carry_out.items()}
        host = {k: layout.host(v) if isinstance(v, tuple) else v.cpu().numpy()
                for k, v in out.items()}
        numerics = fetch.result() if fetch is not None else None
    # The always-on dispatch timing seam: one observation a dispatched
    # region, keyed by the rung, the plan's shape bucket and the backend.
    observe_dispatch(
        engine=engine_used, bucket=plan.bucket.key, backend=backend_name(dev),
        seconds=t_dispatch.seconds, epochs=E,
    )
    return SimulationResult(
        dividends=host["dividends"],
        bonds=host.get("bonds"),
        incentives=host.get("incentives"),
        consensus=host.get("consensus"),
        final_state=state,
        numerics=numerics,
        engine=engine_used,
        demotions=demotions,
    )


def _reset_int(x) -> int:
    return -1 if x is None else int(x)


def _dispatch_case(plan, weights, stakes, reset_index, reset_epoch, config, spec, *,
                   miner_mask=None, eager_kwargs=None, **common):
    """One `[(B,) E, V, M]` dispatch on the plan's rung. The reset rule's
    index and epoch are ints or `[B]` vectors; `miner_mask` (a padded
    suite's) and `eager_kwargs` (the quarantine guard, the fault operands)
    go to the eager rung, the only one the plan lets take them. A fused
    dispatch first passes the fault hook
    (:func:`..resilience.faults.maybe_fail_fused_dispatch`), a single
    `is None` check unless a test armed a fault plan."""
    if plan.engine in FUSED_CASE_RUNGS:
        faults.maybe_fail_fused_dispatch()
        return _simulate_case_fused(
            weights, stakes, reset_index, reset_epoch, config, spec,
            **rung_flags(plan.engine), **common,
        )
    return _simulate_scan(
        weights, stakes, reset_index, reset_epoch, config, spec,
        consensus_impl=plan.consensus_impl, miner_mask=miner_mask,
        **(eager_kwargs or {}), **common,
    )


def run_simulation(
    case: Scenario,
    yuma_version: str,
    yuma_config: Optional[YumaConfig] = None,
    *,
    supervised: bool = False,
    fleet=None,
    device="cuda",
    x64: bool = False,
) -> tuple[dict[str, list[float]], list[np.ndarray], list[np.ndarray]]:
    """Drop-in equivalent of the reference driver (simulation_utils.py:26-112):
    `(dividends_per_validator, bonds_per_epoch, server_incentives_per_epoch)`
    with numpy arrays in place of torch tensors. `supervised=True` arms the
    default engine ladder and the default deadline watchdog, as the JAX
    package's does.

    `fleet` (a store directory or a :class:`..fabric.FleetConfig`): the
    case runs as one lease-claimed unit of that store
    (:func:`..fabric.scheduler.run_fleet_case`, always under the default
    ladder and watchdog, as the JAX package's), so N processes calling at
    once run it exactly once and all return the published triple."""
    if fleet is not None:
        from yuma_simulation_tpu_torch.fabric.scheduler import run_fleet_case

        return run_fleet_case(case, yuma_version, yuma_config, fleet=fleet,
                              supervised=True, device=device, x64=x64)
    supervision = {}
    if supervised:
        from yuma_simulation_tpu_torch.resilience.retry import default_retry_policy
        from yuma_simulation_tpu_torch.resilience.supervisor import default_deadline

        supervision = dict(retry_policy=default_retry_policy(), deadline=default_deadline())
    result = simulate(
        case, yuma_version, yuma_config, save_bonds=True, save_incentives=True,
        device=device, x64=x64, **supervision,
    )
    dividends_per_validator = {
        validator: [float(x) for x in result.dividends[:, i]]
        for i, validator in enumerate(case.validators)
    }
    return dividends_per_validator, list(result.bonds), list(result.incentives)


# ---------------------------------------------------------------------------
# long runs: the epoch stack in slabs, the carry threaded between them


def simulate_streamed(
    chunks,
    yuma_version: str,
    config: Optional[YumaConfig] = None,
    *,
    reset_bonds_index: Optional[int] = None,
    reset_bonds_epoch: Optional[int] = None,
    save_bonds: bool = False,
    save_incentives: bool = False,
    save_consensus: bool = False,
    consensus_impl: str = "bisect",
    epoch_impl: str = "auto",
    dtype: torch.dtype = torch.float32,
    retry_policy=None,
    initial_state: Optional[dict] = None,
    epoch_offset: int = 0,
    return_state: bool = False,
    device="cuda",
    x64: bool = False,
) -> SimulationResult:
    """A run of per-epoch weights longer than the card holds, slab by slab.

    `chunks` is any iterable of `(W [Ec, V, M], S [Ec, V])` slabs (numpy
    arrays, CPU tensors, or tensors already on `device`). Each slab runs on
    one rung with the `(bonds, consensus[, w_prev])` carry threaded between
    slabs and the global epoch index driving first-epoch adoption and the
    bond reset, so the result is bitwise the monolithic run of the
    concatenated stack on the same rung. The rung is planned once, on the
    first slab (:func:`..planner.plan_dispatch` with `streaming=True`:
    "auto" is the varying scan on the card, which takes every slab at its
    own epoch tile), and pinned; slabs longer than the plan's
    `memory.chunk_epochs` are cut to it.

    On the card the copies are double-buffered: a host slab is staged into
    one of :data:`..planner.STREAM_BUFFERS` pinned buffers (allocated once
    per stream), copied without blocking on a side stream into one of two
    device slabs, and the scan waits for that copy on the card, not on the
    host; the outputs come back through pinned buffers, and a slab's are
    read on the host after the next slab is dispatched. Two slabs are on the
    card at a time. Nothing continues on the CPU: a failed pinned allocation
    or copy raises.

    Defaults save only the `[E, V]` dividends; the save flags must be bools
    (the stream's length is unknown here, so "auto" cannot be sized).
    `initial_state` / `epoch_offset` / `return_state`: the suffix-resume
    contract of :func:`simulate`.

    `retry_policy` arms the engine-degradation ladder around the WHOLE
    stream: the rung is pinned per attempt, so a demotion restarts the
    stream from chunk 0 on the lower rung (never mixes rungs mid-stream).
    A one-shot generator can only be replayed while every chunk it gave is
    still held (the two the double buffer had in hand); past that, pass a
    re-iterable sequence to make demotion possible — otherwise a
    ValueError says exactly that. Each attempt ends in its outputs' host
    copy, so a failure on the card surfaces inside the attempt.
    """
    for name, flag in (("save_bonds", save_bonds), ("save_incentives", save_incentives),
                       ("save_consensus", save_consensus)):
        if not isinstance(flag, bool):
            raise ValueError(
                f"simulate_streamed {name} must be True or False, got {flag!r}: the "
                "total stream length is unknown up front, so 'auto' cannot be sized "
                "here (resolve it against the full shape via simulate(), or pass an "
                "explicit bool)"
            )
    config = config if config is not None else YumaConfig()
    spec = variant_for_version(yuma_version)
    if epoch_offset < 0:
        raise ValueError(f"epoch_offset must be >= 0, got {epoch_offset}")
    kwargs = dict(
        reset_bonds_index=reset_bonds_index, reset_bonds_epoch=reset_bonds_epoch,
        save_bonds=save_bonds, save_incentives=save_incentives,
        save_consensus=save_consensus, consensus_impl=consensus_impl, dtype=dtype,
        initial_state=initial_state, epoch_offset=epoch_offset,
        return_state=return_state, device=resolve_device(device), x64=x64,
    )
    if retry_policy is not None:
        return _simulate_streamed_ladder(
            chunks, yuma_version, config, spec, epoch_impl=epoch_impl,
            retry_policy=retry_policy, **kwargs,
        )
    return _simulate_streamed_attempt(
        iter(chunks), yuma_version, config, spec, epoch_impl=epoch_impl, **kwargs,
    )


class _ReiterableChunks:
    """A chunk stream that can be iterated from the start any number of
    times — `iter()` invokes the factory afresh. What the streamed
    ladder needs to restart on a demoted rung regardless of where in the
    stream the failure surfaced."""

    def __init__(self, make_iter):
        self._make_iter = make_iter

    def __iter__(self):
        return iter(self._make_iter())


class _CountingIter:
    """Iterator wrapper that counts consumed chunks and holds the most
    recent TWO (the double-buffered driver keeps one slab in flight
    ahead of the one computing), so an early failure can be replayed on
    a lower rung without re-materializing the stream."""

    def __init__(self, it):
        self._it = it
        self.consumed = 0
        self.recent = collections.deque(maxlen=2)

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self._it)
        self.consumed += 1
        self.recent.append(item)
        return item


def _simulate_streamed_ladder(chunks, yuma_version: str, config: YumaConfig,
                              spec: VariantSpec, *, epoch_impl: str, retry_policy, **kwargs):
    """The degradation ladder around a whole chunk stream (see
    :func:`simulate_streamed`): peek the first chunk to plan the starting
    rung, then run each attempt with the rung pinned; on a classified
    engine failure restart the stream on the next rung."""
    from yuma_simulation_tpu_torch.resilience.retry import supervise

    it = iter(chunks)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("simulate_streamed received no chunks") from None
    # Shape only: the rung and its ladder are all this needs; each attempt
    # plans (and records) in full.
    shape0 = np.shape(first[0])
    if len(shape0) != 3:
        raise ValueError(f"streamed chunks must be [E_chunk, V, M], got {shape0}")
    plan0 = plan_dispatch(
        f"streamed:{yuma_version}", shape0, spec, config, kwargs["dtype"],
        epoch_impl=epoch_impl, consensus_impl=kwargs["consensus_impl"],
        save_bonds=kwargs["save_bonds"], streaming=True, check_memory=False,
        device=kwargs["device"],
    )
    # Anything that is not its own iterator (lists, tuples, re-iterable
    # chunk factories like simulate()'s slab slicer) restarts from chunk
    # 0; a one-shot generator cannot.
    reiterable = not isinstance(chunks, collections.abc.Iterator)
    state = {"it": itertools.chain([first], it)}

    def dispatch(rung: str):
        tracker = _CountingIter(state["it"])
        try:
            return _simulate_streamed_attempt(
                tracker, yuma_version, config, spec, epoch_impl=rung, **kwargs,
            )
        except BaseException as exc:
            if classify_failure(exc) is None:
                raise  # a caller error: no replay bookkeeping needed
            if reiterable:
                state["it"] = iter(chunks)
            elif tracker.consumed <= len(tracker.recent):
                # Every consumed chunk is still held (at most the two the
                # double buffer had in hand): re-feed them ahead of the
                # untouched rest of the generator.
                state["it"] = itertools.chain(list(tracker.recent), tracker._it)
            else:
                raise ValueError(
                    "engine demotion needs to restart the stream from chunk 0, "
                    f"but {tracker.consumed} chunks of a one-shot generator were "
                    "already consumed — pass a re-iterable sequence (list/tuple) "
                    "of chunks to use retry_policy with simulate_streamed"
                ) from exc
            raise

    result, _, records = supervise(
        dispatch, plan0, retry_policy, label=f"streamed:{yuma_version}"
    )
    result.demotions = tuple(records) or None
    return result


class _HostSlabs:
    """The staging of a stream's slabs off the card: each slab becomes a
    tensor of the stream's dtype, outputs are read back as they are."""

    def __init__(self, dev, dtype):
        self.dev, self.dtype = dev, dtype

    def stage(self, Wc, Sc):
        return tuple(torch.as_tensor(x, dtype=self.dtype).to(self.dev) for x in (Wc, Sc))

    def scan_begins(self) -> None:
        pass

    def dispatched(self, slot) -> None:
        pass

    def fetch(self, ys: dict):
        return ys

    def flush(self, pending) -> dict:
        return {k: v.cpu().numpy() for k, v in pending.items()}


@dataclass
class StreamTimeline:
    """The timeline of the streams run on the card inside
    :func:`stream_timeline`: CUDA events around each slab's copy on the
    side stream and each scan on the compute stream, and the host's time
    in staging (waiting for a pinned buffer's last copy, and allocating
    the buffers on first use; then filling it). `hidden[k]` is whether
    slab k's copy and scan had both ended by the time the host finished
    filling slab k+1's buffer, that is whether the card's work on slab k
    ran behind the host's staging. For slabs staged from the host."""

    fill_s: float = 0.0
    wait_s: float = 0.0
    copies: list = field(default_factory=list)  # (start, end) events, side stream
    scans: list = field(default_factory=list)  # (start, end) events, compute stream
    hidden: list = field(default_factory=list)  # per slab but the last

    def summary(self) -> dict:
        """Milliseconds from the events (call after the card is synchronized):
        the copies' and scans' sums, the time copies ran while a scan ran
        (``copy_scan_overlap_ms``), the card's busy time (their union) and
        span, and the copy + scan time of the slabs hidden behind staging."""
        if not self.copies:
            return {}
        t0 = self.copies[0][0]

        def spans(pairs):
            return [(t0.elapsed_time(a), t0.elapsed_time(b)) for a, b in pairs]

        copies, scans = spans(self.copies), spans(self.scans)
        copy_ms = sum(b - a for a, b in copies)
        scan_ms = sum(b - a for a, b in scans)
        overlap = sum(max(0.0, min(c1, s1) - max(c0, s0))
                      for c0, c1 in copies for s0, s1 in scans)
        hidden = sum((c1 - c0) + (s1 - s0)
                     for h, (c0, c1), (s0, s1) in zip(self.hidden, copies, scans) if h)
        return dict(
            slabs=len(scans), fill_s=self.fill_s, wait_s=self.wait_s, copy_ms=copy_ms,
            scan_ms=scan_ms, copy_scan_overlap_ms=overlap,
            busy_ms=copy_ms + scan_ms - overlap,
            span_ms=max(e for _, e in copies + scans),
            hidden_slabs=sum(self.hidden), hidden_behind_staging_ms=hidden,
        )


_TIMELINE: Optional[StreamTimeline] = None


@contextlib.contextmanager
def stream_timeline():
    """Record a :class:`StreamTimeline` of the streams run on the card in
    this block (one timeline across them: use one stream per block)."""
    global _TIMELINE
    previous, _TIMELINE = _TIMELINE, StreamTimeline()
    try:
        yield _TIMELINE
    finally:
        _TIMELINE = previous


class _CudaSlabs:
    """The double buffer of a stream on the card.

    Host slabs are staged into :data:`STREAM_BUFFERS` pinned buffers and
    copied without blocking, on a side stream, into as many device slabs;
    the compute stream waits for a slab's copy event before its scan, and
    the copy into a device slab waits, on the card, for the scan that last
    read it. A pinned buffer is refilled only after its previous copy's
    event has completed. Outputs go back without blocking into pinned
    buffers, one set per slot, read after the next slab is dispatched.
    The buffers are allocated once per stream (again only for a longer
    slab) and reused."""

    def __init__(self, dev, dtype, timeline: Optional[StreamTimeline] = None):
        self.dev, self.dtype = dev, dtype
        self.timeline = timeline
        self.compute = torch.cuda.current_stream(dev)
        self.side = torch.cuda.Stream(dev)
        self.pinned: list = [None] * STREAM_BUFFERS  # (W, S) pinned, per slot
        self.slabs: list = [None] * STREAM_BUFFERS  # (W, S) on the card, per slot
        self.copied: list = [None] * STREAM_BUFFERS  # event: the slot's copy is done
        self.read: list = [None] * STREAM_BUFFERS  # event: the slot's scan is done
        self.outs: list = [dict() for _ in range(STREAM_BUFFERS)]  # pinned outputs
        self.staged = self.fetched = 0

    def _buffers(self, j: int, n: int, V: int, M: int):
        have = self.slabs[j]
        if have is None or have[0].shape[0] < n or have[0].shape[1:] != (V, M):
            if self.read[j] is not None:
                self.read[j].synchronize()  # the scan that read the old slab
            shapes = ((n, V, M), (n, V))
            self.pinned[j] = tuple(
                torch.empty(sh, dtype=self.dtype, pin_memory=True) for sh in shapes
            )
            with torch.cuda.stream(self.side):
                self.slabs[j] = tuple(
                    torch.empty(sh, dtype=self.dtype, device=self.dev) for sh in shapes
                )
            for x in self.slabs[j]:
                # Written on the side stream, read on the compute stream.
                x.record_stream(self.compute)
        return self.pinned[j], self.slabs[j]

    def stage(self, Wc, Sc):
        if isinstance(Wc, torch.Tensor) and Wc.is_cuda:  # already on a card
            return Wc.to(self.dev, self.dtype), torch.as_tensor(Sc).to(self.dev, self.dtype)
        j = self.staged % STREAM_BUFFERS
        self.staged += 1
        n, V, M = np.shape(Wc)
        tl = self.timeline
        t0 = time.perf_counter()
        if self.copied[j] is not None:
            self.copied[j].synchronize()  # the pinned buffer's last copy
        (pW, pS), (dW, dS) = self._buffers(j, n, V, M)
        t1 = time.perf_counter()
        pW[:n].numpy()[...] = Wc
        pS[:n].numpy()[...] = Sc
        if tl is not None:
            tl.wait_s += t1 - t0
            tl.fill_s += time.perf_counter() - t1
            if tl.scans:
                tl.hidden.append(tl.scans[-1][1].query())
        with torch.cuda.stream(self.side):
            if self.read[j] is not None:
                self.side.wait_event(self.read[j])
            if tl is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record(self.side)
            dW[:n].copy_(pW[:n], non_blocking=True)
            dS[:n].copy_(pS[:n], non_blocking=True)
            self.copied[j] = torch.cuda.Event(enable_timing=tl is not None)
            self.copied[j].record(self.side)
            if tl is not None:
                tl.copies.append((start, self.copied[j]))
        self.compute.wait_event(self.copied[j])
        return _Slot(dW[:n], dS[:n], j)

    def scan_begins(self) -> None:
        if self.timeline is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.compute)
            self.timeline.scans.append((start, None))

    def dispatched(self, slot) -> None:
        """After the scan over `slot` is queued: the next copy into its
        device slab waits for this point of the compute stream."""
        tl = self.timeline
        if tl is None and not isinstance(slot, _Slot):
            return
        end = torch.cuda.Event(enable_timing=tl is not None)
        end.record(self.compute)
        if isinstance(slot, _Slot):
            self.read[slot.j] = end
        if tl is not None:
            tl.scans[-1] = (tl.scans[-1][0], end)

    def fetch(self, ys: dict):
        bufs = self.outs[self.fetched % STREAM_BUFFERS]
        self.fetched += 1
        out = {}
        for k, v in ys.items():
            buf = bufs.get(k)
            if buf is None or buf.shape[0] < v.shape[0] or buf.shape[1:] != v.shape[1:]:
                buf = bufs[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            out[k] = buf[: v.shape[0]]
            out[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self.compute)
        return out, done

    def flush(self, pending) -> dict:
        out, done = pending
        done.synchronize()
        return {k: v.numpy().copy() for k, v in out.items()}


@dataclass
class _Slot:
    """A staged slab on the card and the slot of its buffers."""

    W: torch.Tensor
    S: torch.Tensor
    j: int

    def __iter__(self):
        return iter((self.W, self.S))


def _simulate_streamed_attempt(
    chunks, yuma_version: str, config: YumaConfig, spec: VariantSpec, *,
    reset_bonds_index, reset_bonds_epoch, save_bonds: bool, save_incentives: bool,
    save_consensus: bool, consensus_impl: str, epoch_impl: str, dtype,
    initial_state=None, epoch_offset: int = 0, return_state: bool = False,
    device: torch.device, x64: bool = False,
) -> SimulationResult:
    """One rung-pinned, double-buffered pass over the stream: slab k is
    dispatched, then slab k+1 is taken from the source and staged (its
    copy overlapping the scan over slab k), then slab k-1's outputs are
    read on the host."""
    ri, re_ = _reset_int(reset_bonds_index), _reset_int(reset_bonds_epoch)
    state: dict = {}  # "plan", set on the first slab
    saves = dict(save_bonds=save_bonds, save_incentives=save_incentives,
                 save_consensus=save_consensus)
    capture = _numerics.numerics_enabled()
    # Per-slab sketches ride the slab's output fetch as one packed byte
    # tensor; their layouts wait here, in slab order.
    layouts: list = []
    sketches: list = []

    def slabs():
        for Wc, Sc in chunks:
            if len(np.shape(Wc)) != 3:
                raise ValueError(f"streamed chunks must be [E_chunk, V, M], got {np.shape(Wc)}")
            if "plan" not in state:
                # Planned once and pinned: a rung switched mid-stream would
                # break the bitwise equality with the monolithic run.
                plan = plan_dispatch(
                    f"streamed:{yuma_version}", np.shape(Wc), spec, config, dtype,
                    epoch_impl=epoch_impl, consensus_impl=consensus_impl, **saves,
                    streaming=True, device=device,
                )
                plan.record()
                state["plan"] = plan
            cap = state["plan"].memory.chunk_epochs
            n = int(np.shape(Wc)[0])
            if cap is None or n <= cap:
                yield Wc, Sc
            else:
                for lo in range(0, n, cap):
                    yield Wc[lo : lo + cap], Sc[lo : lo + cap]

    pipe = (_CudaSlabs(device, dtype, _TIMELINE) if device.type == "cuda"
            else _HostSlabs(device, dtype))
    it = slabs()
    cur = next(it, None)
    if cur is None:
        raise ValueError("simulate_streamed received no chunks")
    V, M = np.shape(cur[0])[-2:]
    if initial_state is not None:
        validate_initial_state(initial_state, spec, V, M)
        carry = {
            k: torch.as_tensor(np.array(v), dtype=dtype).to(device)
            for k, v in initial_state.items()
        }
    else:
        carry = zero_carry(spec, V, M, dtype, device=device)
    cur = pipe.stage(*cur)
    offset = epoch_offset
    host: dict = {}
    pending = None
    while cur is not None:
        Wc, Sc = cur
        n_epochs = int(Wc.shape[0])
        pipe.scan_begins()
        ys, carry = _dispatch_case(
            state["plan"], Wc, Sc, ri, re_, config, spec, carry=carry, epoch_offset=offset,
            return_carry=True, x64=x64, capture_numerics=capture, **saves,
        )
        pipe.dispatched(cur)
        if "numerics" in ys:
            ys["numerics"], layout = _numerics.pack_sketches(ys["numerics"])
            layouts.append(layout)
        fetched = pipe.fetch(ys)
        del ys
        offset += n_epochs
        nxt = next(it, None)
        cur = None if nxt is None else pipe.stage(*nxt)
        if pending is not None:
            _collect(pipe.flush(pending), host, sketches, layouts)
        pending = fetched
    _collect(pipe.flush(pending), host, sketches, layouts)
    cat = {k: np.concatenate(v) for k, v in host.items()}
    return SimulationResult(
        dividends=cat["dividends"],
        bonds=cat.get("bonds"),
        incentives=cat.get("incentives"),
        consensus=cat.get("consensus"),
        final_state={k: v.cpu().numpy() for k, v in carry.items()} if return_state else None,
        numerics=_numerics.concat_sketches(sketches) if sketches else None,
        engine=state["plan"].engine,
    )


def _collect(flushed: dict, host: dict, sketches: list, layouts: list) -> None:
    """One slab's host outputs into the stream's lists: the packed sketches
    unpacked with the oldest waiting layout."""
    packed = flushed.pop("numerics", None)
    if packed is not None:
        sketches.append(_numerics.unpack_sketches(packed, layouts.pop(0)))
    for k, v in flushed.items():
        host.setdefault(k, []).append(v)


def simulate_generated(
    gen_fn,
    num_chunks: int,
    yuma_version: str,
    config: Optional[YumaConfig] = None,
    *,
    epoch_impl: str = "auto",
    consensus_impl: str = "bisect",
    x64: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Chunked streaming of generated weights: `gen_fn(i)` returns chunk
    `i`'s `(W [CH, V, M], S [CH, V])` tensors, built on the device the run
    goes on (on the card: no host round trip). A host loop runs each chunk
    through the same carry-threaded dispatch as :func:`simulate_streamed`,
    one scan a chunk, the dividends gathered on the device; only one chunk
    needs to be alive at a time. No bond reset fires. Bitwise the
    monolithic run of the concatenated chunks on the same rung.

    The JAX package unrolls this loop into one compiled program (a
    `lax.fori_loop` around its Pallas scan compiled for minutes); a host
    loop over kernel launches has no such cost, so the note does not apply.

    Returns `(dividends [num_chunks * CH, V], final_bonds [V, M])` as host
    arrays."""
    config = config if config is not None else YumaConfig()
    spec = variant_for_version(yuma_version)
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    W0, S0 = gen_fn(0)
    dev = resolve_device(W0.device)
    CH, V, M = W0.shape
    # check_memory=False: one generated chunk lives at a time, whatever
    # num_chunks is; the epoch-stack model of the preflight does not apply.
    plan = plan_dispatch(
        f"generated:{yuma_version}", tuple(W0.shape), spec, config, W0.dtype,
        epoch_impl=epoch_impl, consensus_impl=consensus_impl, streaming=True,
        check_memory=False, device=dev,
    )
    plan.record()
    carry = zero_carry(spec, V, M, W0.dtype, device=dev)
    D = torch.empty((num_chunks * CH, V), dtype=W0.dtype, device=dev)
    for i in range(num_chunks):
        W, S = (W0, S0) if i == 0 else gen_fn(i)
        if tuple(W.shape) != (CH, V, M):
            raise ValueError(f"gen_fn({i}) gave weights {tuple(W.shape)}, expected {(CH, V, M)}")
        ys, carry = _dispatch_case(
            plan, W, S, -1, -1, config, spec, carry=carry, epoch_offset=i * CH,
            return_carry=True, save_bonds=False, save_incentives=False,
            save_consensus=False, x64=x64,
        )
        D[i * CH : (i + 1) * CH] = ys["dividends"]
        W0 = S0 = None
    return D.cpu().numpy(), carry["bonds"].cpu().numpy()


# ---------------------------------------------------------------------------
# the throughput paths: totals and final bonds, no per-epoch outputs

def _check_scalar_config(config: YumaConfig, name: str) -> None:
    """The single-scenario entry points take scalar configs only; a
    `[B]`-vector config (a `config_grid` grid) goes through the batched
    ones (`simulate_batch`, `simulate_scaled_batch`, the sweeps)."""
    if config_is_batched(config):
        raise ValueError(
            f"{name} runs one scenario and takes a scalar config; run a "
            "config_grid grid through simulate_scaled_batch or the sweeps"
        )


def _throughput_inputs(W, S, *extra):
    """The device the tensors live on, and `S` / `extra` as tensors of
    `W`'s dtype there."""
    dev = resolve_device(W.device)
    return dev, [torch.as_tensor(x, dtype=W.dtype, device=dev) for x in (S,) + extra]


def _scaled_eager(W, S, scales, config, spec, consensus_impl, x64):
    """The eager rung of the scaled path: epoch e runs :func:`yuma_epoch`
    on `W * scales[e]`, any leading batch dims included."""
    cfg = _tensor_config(config, W.device)
    zero_b = torch.zeros_like(W)
    carry = ScaledCarry(
        bonds=zero_b,
        w_prev=zero_b if spec.carries_prev_weights else None,
        acc=torch.zeros(W.shape[:-1], dtype=W.dtype, device=W.device),
    )
    for e in range(scales.shape[0]):
        Wv = W * scales[e]
        first = e == 0
        kernel_prev = None
        if spec.bonds_mode is BondsMode.EMA_PREV:
            kernel_prev = normalize_weight_rows(Wv) if first else carry.w_prev
        res = yuma_epoch(
            Wv, S, carry.bonds, cfg, bonds_mode=spec.bonds_mode, W_prev=kernel_prev,
            first_epoch=first, consensus_impl=consensus_impl, x64=x64,
        )
        carry = ScaledCarry(
            bonds=res[spec.bond_state_key],
            w_prev=res["weight"] if spec.carries_prev_weights else None,
            acc=carry.acc + _dividends_per_1k(res["validator_reward_normalized"], S, cfg),
        )
    return carry.acc, carry.bonds


def _scaled_scan(W, S, scales, config, spec, engine, x64):
    """K5 over the whole scan; the per-1000-tao conversion is linear in
    D_n, so it is applied once to the in-kernel epoch sum (engine.py:1830
    of the JAX package)."""
    B_final, D_tot = fused_ema_scan(
        W, normalize_stake(S), scales, mode=spec.bonds_mode,
        mxu=engine == "fused_scan_mxu", x64=x64, **fused_hparams(config),
    )
    return _dividends_per_1k(D_tot, S, _tensor_config(config, W.device)), B_final


def simulate_scaled(
    W: torch.Tensor,
    S: torch.Tensor,
    scales: torch.Tensor,
    config: Optional[YumaConfig] = None,
    spec: Optional[VariantSpec] = None,
    consensus_impl: str = "bisect",
    epoch_impl: str = "auto",
    *,
    x64: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The epoch-varying throughput workload: epoch e simulates
    `W * scales[e]` (`W [V, M]` base weights, `S [V]` raw stakes, `scales
    [E]`), on the device `W` lives on. The scale is numerically almost
    neutral (row normalization divides it out) but makes every epoch do
    its full work.

    `epoch_impl`: "auto" (see :func:`..planner.resolve_scaled_engine`),
    "eager" (the loop over :func:`yuma_epoch`; "xla", JAX's name, runs it), "fused_scan" /
    "fused_scan_mxu" (the whole scan in K5, all five bond models; with
    the support on the tensor cores, bitwise the same), "fused" /
    "fused_mxu" (K6 once per epoch; EMA family, no liquid alpha).
    `spec` defaults to Yuma 1. `x64=True` runs Yuma 0's quantize divide in
    float64, the JAX package's x64 parity mode.

    Returns `(total_dividends [V], final_bonds [V, M])`: the dividend per
    1000 tao summed over epochs.
    """
    config = config if config is not None else YumaConfig()
    spec = spec if spec is not None else variant_for_version("Yuma 1 (paper)")
    _check_scalar_config(config, "simulate_scaled")
    if W.ndim != 2:
        raise ValueError(f"W must be [V, M], got {tuple(W.shape)}")
    dev, (S, scales) = _throughput_inputs(W, S, scales)
    V, M = W.shape
    consensus_impl = resolve_consensus_impl(consensus_impl, V, M)
    engine = resolve_scaled_engine(
        (V, M), spec.bonds_mode, config, W.dtype, scales.shape[0], device=dev,
        epoch_impl=epoch_impl, consensus_impl=consensus_impl,
    )
    if engine in ("fused_scan", "fused_scan_mxu"):
        return _scaled_scan(W, S, scales, config, spec, engine, x64)
    if engine == "eager":
        return _scaled_eager(W, S, scales, config, spec, consensus_impl, x64)
    # "fused" / "fused_mxu": K6 once per epoch.
    if spec.bonds_mode not in EMA_MODES:
        raise ValueError("fused epoch_impl supports the EMA family only")
    if config.liquid_alpha:
        raise ValueError("fused epoch_impl does not support liquid alpha")
    cfg = _tensor_config(config, dev)
    hp = fused_hparams(config)
    ema_hp = {k: hp[k] for k in ("kappa", "bond_penalty", "bond_alpha", "precision")}
    S_n = normalize_stake(S)  # stake is epoch-constant: normalize once
    zero_b = torch.zeros_like(W)
    carry = ScaledCarry(
        bonds=zero_b,
        w_prev=zero_b if spec.carries_prev_weights else None,
        acc=torch.zeros((V,), dtype=W.dtype, device=dev),
    )
    for e in range(scales.shape[0]):
        first = e == 0
        # The clip base and the carried previous weights are normalized with
        # the eager rung's blocked miner_sum (JAX engine.py:1850, 1863);
        # EMA and EMA_RUST read neither.
        W_n_now = None
        if spec.bonds_mode is BondsMode.EMA_PREV or spec.carries_prev_weights:
            W_n_now = normalize_weight_rows(W * scales[e])
        clip = None
        if spec.bonds_mode is BondsMode.EMA_PREV:
            clip = W_n_now if first else carry.w_prev
        B_next, D_n, _ = fused_ema_epoch(
            W, S_n, carry.bonds, w_scale=scales[e], first_epoch=first, clip_base=clip,
            mode=spec.bonds_mode, mxu=engine == "fused_mxu", x64=x64, **ema_hp,
        )
        carry = ScaledCarry(
            bonds=B_next,
            w_prev=W_n_now if spec.carries_prev_weights else None,
            acc=carry.acc + _dividends_per_1k(D_n, S, cfg),
        )
    return carry.acc, carry.bonds


def simulate_scaled_batch(
    W: torch.Tensor,
    S: torch.Tensor,
    scales: torch.Tensor,
    config: Optional[YumaConfig] = None,
    spec: Optional[VariantSpec] = None,
    consensus_impl: str = "bisect",
    epoch_impl: str = "auto",
    *,
    x64: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A scenario batch of the scaled workload: `W [B, V, M]`, `S [B, V]`,
    one `scales [E]` shared by all. `epoch_impl`: "auto", "eager" (the
    loop over :func:`yuma_epoch` with the batch as a leading dim),
    "fused_scan" or "fused_scan_mxu" (K5 advancing every scenario each
    epoch). `config` may carry `[B]` fields (a :func:`..sweep.config_grid`
    grid, one value per scenario): K5 reads them as its per-scenario
    hyperparameter table `[B, 9]`; the eager rung broadcasts them per
    lane. Returns `(total_dividends [B, V], final_bonds
    [B, V, M])`."""
    config = config if config is not None else YumaConfig()
    spec = spec if spec is not None else variant_for_version("Yuma 1 (paper)")
    if W.ndim != 3:
        raise ValueError(f"W must be [B, V, M], got {tuple(W.shape)}")
    config_lanes(config, W.shape[0])
    dev, (S, scales) = _throughput_inputs(W, S, scales)
    consensus_impl = resolve_consensus_impl(consensus_impl, *W.shape[-2:])
    engine = resolve_scaled_engine(
        tuple(W.shape), spec.bonds_mode, config, W.dtype, scales.shape[0], device=dev,
        epoch_impl=epoch_impl, consensus_impl=consensus_impl, batched=True,
    )
    if engine == "eager":
        return _scaled_eager(W, S, scales, config, spec, consensus_impl, x64)
    return _scaled_scan(W, S, scales, config, spec, engine, x64)


def simulate_constant(
    W: torch.Tensor,
    S: torch.Tensor,
    num_epochs: int,
    config: Optional[YumaConfig] = None,
    spec: Optional[VariantSpec] = None,
    consensus_impl: str = "bisect",
    hoist_invariant: bool = False,
    mesh=None,
    *,
    x64: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The epoch-constant throughput path: `num_epochs` epochs of the same
    `W [V, M]` and `S [V]`, on the device `W` lives on, with the dividend
    total accumulated in the carry and no per-epoch outputs. It runs no
    kernel: the eager loop over :func:`yuma_epoch`.

    `hoist_invariant=True` runs the epoch's consensus front half (which
    depends only on `(W, S)`) once and then only the bond recurrence and
    the dividends, with the same update helpers :func:`yuma_epoch` uses;
    it needs `num_epochs >= 1`. The constant path has no scenario, so no
    bond reset fires.

    Before anything is allocated, the HBM preflight holds the `[V, M]`
    working set (no epoch stack: ``resident_epochs=0``) to the device's
    memory, and refuses an unfittable shape with one
    ``event=preflight_rejected`` record and
    :class:`..telemetry.cost.HBMPreflightError`.

    `mesh`: the miner axis split over the mesh's ``model`` axis for the
    whole run, both ways (:mod:`..models.miner_shards`), bitwise the
    unsharded run; the preflight then holds one shard's working set times
    the shards on each physical device. The dividend total comes back on
    the last shard's device and the final bonds gathered onto the first
    shard's.

    Returns `(total_dividends [V], final_bonds [V, M])`.
    """
    config = config if config is not None else YumaConfig()
    spec = spec if spec is not None else variant_for_version("Yuma 1 (paper)")
    _check_scalar_config(config, "simulate_constant")
    if W.ndim != 2:
        raise ValueError(f"W must be [V, M], got {tuple(W.shape)}")
    V, M = W.shape
    itemsize = W.element_size()
    if mesh is not None:
        layout = _miner_shardings(mesh, M)
        _preflight_miner_shards("simulate_constant", layout, V, resident_epochs=0,
                                itemsize=itemsize)
    else:
        from yuma_simulation_tpu_torch.telemetry.cost import estimate_hbm_bytes, preflight_hbm

        preflight_hbm("simulate_constant",
                      estimate_hbm_bytes(V, M, resident_epochs=0, itemsize=itemsize),
                      device=W.device)
    consensus_impl = resolve_consensus_impl(consensus_impl, V, M)
    if mesh is not None and layout.shards == 1:  # the unsharded program there
        W = W.to(layout.devices[0])
    elif mesh is not None:
        cfg = _tensor_config(config, layout.devices[0])
        S = torch.as_tensor(S, dtype=W.dtype).to(layout.devices[-1])
        return _constant_run_miners(layout, W, S, num_epochs, cfg, spec, consensus_impl,
                                    hoist_invariant, x64)
    dev, (S,) = _throughput_inputs(W, S)
    return _constant_run(W, S, num_epochs, _tensor_config(config, dev), spec, consensus_impl,
                         hoist_invariant, x64)


def _constant_run_miners(layout, W, S, num_epochs, cfg, spec, consensus_impl,
                         hoist_invariant, x64):
    """:func:`_constant_run` with the miner axis sharded over `layout`:
    the same loops on :func:`..models.miner_shards.sharded_epoch`, `S` on
    the last shard's device. Returns the total there and the final bonds
    gathered onto the first shard's device."""
    W_sh = layout.split(W)
    if hoist_invariant:
        if num_epochs < 1:
            raise ValueError("hoist_invariant path requires num_epochs >= 1")
        res0 = sharded_epoch(layout, W_sh, S, None, cfg, bonds_mode=spec.bonds_mode,
                             consensus_impl=consensus_impl, x64=x64)
        rate, incentive = res0["_rate"], res0["server_incentive"]
        relative = spec.bonds_mode is BondsMode.RELATIVE

        def dividends_of(B):
            D, D_tot = sharded_dividends(layout, B, incentive, res0["stake"] if relative else None)
            return _dividends_per_1k(D / (D_tot + 1e-6), S, cfg)

        if spec.bonds_mode in EMA_MODES:
            renorm = spec.bonds_mode is BondsMode.EMA_RUST

            def bonds_update(B_prev):
                return tuple(ema_bonds_update(bt, bp, r, None, renorm) for bt, bp, r
                             in zip(res0["validator_bond"], B_prev, rate))

            bonds = res0["validator_ema_bond"]
        elif spec.bonds_mode is BondsMode.CAPACITY:
            S_n = [res0["stake"].to(d) for d in layout.devices]

            def bonds_update(B_prev):
                return tuple(capacity_bonds_update(bp, w, s, cfg) for bp, w, s
                             in zip(B_prev, res0["weight"], S_n))

            bonds = res0["validator_bonds"]
        else:  # RELATIVE

            def bonds_update(B_prev):
                return tuple(relative_bonds_update(bp, w, r) for bp, w, r
                             in zip(B_prev, res0["weight"], rate))

            bonds = res0["validator_bonds"]
        acc = dividends_of(bonds)
        with miner_width(layout.num_miners):
            for _ in range(num_epochs - 1):
                bonds = bonds_update(bonds)
                acc = acc + dividends_of(bonds)
        return acc, layout.gather(bonds)
    bonds = tuple(torch.zeros_like(w) for w in W_sh)
    w_prev = bonds
    acc = torch.zeros(W.shape[:-1], dtype=W.dtype, device=layout.devices[-1])
    for epoch in range(num_epochs):
        first = epoch == 0
        kernel_prev = None
        if spec.bonds_mode is BondsMode.EMA_PREV:
            kernel_prev = layout.normalize_rows(W_sh) if first else w_prev
        res = sharded_epoch(layout, W_sh, S, bonds, cfg, bonds_mode=spec.bonds_mode,
                            W_prev=kernel_prev, first_epoch=first,
                            consensus_impl=consensus_impl, x64=x64)
        bonds = res[spec.bond_state_key]
        w_prev = res["weight"] if spec.carries_prev_weights else w_prev
        acc = acc + _dividends_per_1k(res["validator_reward_normalized"], S, cfg)
    return acc, layout.gather(bonds)


def _constant_run(W, S, num_epochs, cfg, spec, consensus_impl, hoist_invariant, x64):
    """:func:`simulate_constant`'s loops on `W [..., V, M]` and `S [..., V]`
    (leading dims: a batch of scenarios, as the Monte-Carlo's constant
    weights run them) with a tensor config."""
    if hoist_invariant:
        return _simulate_constant_hoisted(W, S, num_epochs, cfg, spec, consensus_impl, x64)
    zero_b = torch.zeros_like(W)
    carry = TotalsCarry(
        bonds=zero_b, w_prev=zero_b,
        consensus=torch.zeros(W.shape[:-2] + W.shape[-1:], dtype=W.dtype, device=W.device),
        acc=torch.zeros(W.shape[:-1], dtype=W.dtype, device=W.device),
    )
    for epoch in range(num_epochs):
        first = epoch == 0
        kernel_prev = None
        if spec.bonds_mode is BondsMode.EMA_PREV:
            kernel_prev = normalize_weight_rows(W) if first else carry.w_prev
        res = yuma_epoch(
            W, S, carry.bonds, cfg, bonds_mode=spec.bonds_mode, W_prev=kernel_prev,
            first_epoch=first, consensus_impl=consensus_impl, x64=x64,
        )
        carry = TotalsCarry(
            bonds=res[spec.bond_state_key],
            w_prev=res["weight"] if spec.carries_prev_weights else carry.w_prev,
            consensus=res["server_consensus_weight"],
            acc=carry.acc + _dividends_per_1k(res["validator_reward_normalized"], S, cfg),
        )
    return carry.acc, carry.bonds


def _simulate_constant_hoisted(W, S, num_epochs, cfg, spec, consensus_impl, x64):
    """Epoch 0 of :func:`yuma_epoch` supplies every epoch-invariant value
    (normalized weights and stakes, consensus, incentive, the liquid rate
    and, for the EMA families, the purchase target); the loop then applies
    only the bond update helpers of :mod:`..models.epoch`."""
    if num_epochs < 1:
        raise ValueError("hoist_invariant path requires num_epochs >= 1")
    res0 = yuma_epoch(
        W, S, None, cfg, bonds_mode=spec.bonds_mode, consensus_impl=consensus_impl,
        x64=x64,
    )
    W_n, S_n, incentive = res0["weight"], res0["stake"], res0["server_incentive"]
    if cfg.liquid_alpha and spec.bonds_mode is not BondsMode.CAPACITY:
        rate, _, _ = liquid_alpha_rate(
            res0["server_consensus_weight"], cfg.alpha_low, cfg.alpha_high,
            override_consensus_high=cfg.override_consensus_high,
            override_consensus_low=cfg.override_consensus_low,
        )
    else:
        rate = cfg.bond_alpha
    rate = _per_lane(rate, W)

    def dividends_of(B):
        # D and its total as the full epoch rounds them.
        D, D_tot = dividends(B, incentive, S_n if spec.bonds_mode is BondsMode.RELATIVE else None)
        return _dividends_per_1k(D / (D_tot + 1e-6), S, cfg)

    if spec.bonds_mode in EMA_MODES:
        B_target = res0["validator_bond"]
        renorm = spec.bonds_mode is BondsMode.EMA_RUST

        def bonds_update(B_prev):
            return ema_bonds_update(B_target, B_prev, rate, None, renorm)

        B0 = res0["validator_ema_bond"]
    elif spec.bonds_mode is BondsMode.CAPACITY:

        def bonds_update(B_prev):
            return capacity_bonds_update(B_prev, W_n, S_n, cfg)

        B0 = res0["validator_bonds"]
    else:  # RELATIVE

        def bonds_update(B_prev):
            return relative_bonds_update(B_prev, W_n, rate)

        B0 = res0["validator_bonds"]
    carry = HoistedCarry(bonds=B0, acc=dividends_of(B0))
    for _ in range(num_epochs - 1):
        B_next = bonds_update(carry.bonds)
        carry = HoistedCarry(bonds=B_next, acc=carry.acc + dividends_of(B_next))
    return carry.acc, carry.bonds

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

`epoch_impl="auto"` resolves as the JAX package's planner does on the TPU:
the varying scan when its epoch tile reaches 2, else the case scan, for
CUDA tensors; "eager" on `device="cpu"`, as JAX's "auto" resolves to its
XLA rung off the TPU, and where the dyadic quantize grid no longer fits
int32 (the fused and eager quantize fallbacks may differ by an ulp there,
so "auto" never mixes them), and for a padded suite with per-scenario miner
masks, which only the eager rung takes. The fused rungs on CPU tensors run
the kernels' plain PyTorch versions.

The throughput paths (:func:`simulate_scaled`, :func:`simulate_scaled_batch`,
:func:`simulate_constant`) return dividend totals and the final bonds
only: the scaled ones run the scaled scan (K5) or the per-epoch fused
kernel (K6) on the card, or the eager loop.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional

import numpy as np
import torch

from yuma_simulation_tpu_torch.models.config import YumaConfig
from yuma_simulation_tpu_torch.models.epoch import (
    EMA_MODES,
    BondsMode,
    config_value,
    capacity_bonds_update,
    dividends,
    ema_bonds_update,
    relative_bonds_update,
    yuma_epoch,
)
from yuma_simulation_tpu_torch.models.variants import (
    ResetMode,
    VariantSpec,
    variant_for_version,
)
from yuma_simulation_tpu_torch.ops.consensus import (
    bisection_iterations,
    dyadic_grid_fits_int32,
    resolve_consensus_impl,
)
from yuma_simulation_tpu_torch.ops.cuda_epoch import (
    fused_case_scan,
    fused_ema_epoch,
    fused_ema_scan,
    fused_varying_scan,
    varying_scan_epoch_tile,
)
from yuma_simulation_tpu_torch.ops.liquid import liquid_alpha_rate
from yuma_simulation_tpu_torch.ops.normalize import (
    normalize_stake,
    normalize_weight_rows,
)
from yuma_simulation_tpu_torch.scenarios.base import Scenario
from yuma_simulation_tpu_torch.simulation.carry import (
    HoistedCarry,
    ScaledCarry,
    TotalsCarry,
)

#: The tensor-core (K4) twins of the fused rungs, bitwise the same.
MXU_RUNGS = ("fused_scan_mxu", "fused_varying_mxu")
FUSED_RUNGS = ("fused_scan", "fused_varying") + MXU_RUNGS
EPOCH_IMPLS = ("auto", "eager") + FUSED_RUNGS

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
    #: The rung that ran (one of :data:`FUSED_RUNGS`, or "eager").
    engine: str = ""


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


def plan_engine(
    epoch_impl: str,
    consensus_impl: str,
    shape,
    dtype,
    device: torch.device,
    precision: int = 100_000,
    has_miner_mask: bool = False,
) -> str:
    """Resolve `epoch_impl` for a `[(B,) E, V, M]` workload to a rung.
    `auto` never picks a fused rung once `M * 2^iters >= 2^31` (the JAX
    package's gate, pallas_epoch.py:1308-1315); that test comes before any
    query of the device. A padded suite's per-scenario miner mask
    (`has_miner_mask`) runs on the eager rung only, as the JAX planner
    sends it to its XLA rung: "auto" resolves to "eager" and a fused rung
    raises."""
    if epoch_impl not in EPOCH_IMPLS:
        raise ValueError(
            f"unknown epoch_impl {epoch_impl!r}; expected one of {EPOCH_IMPLS}"
        )
    if consensus_impl not in ("auto", "sorted", "bisect", "kernel"):
        raise ValueError(
            f"unknown consensus_impl {consensus_impl!r}; "
            "expected 'auto', 'sorted', 'bisect' or 'kernel'"
        )
    fusable = consensus_impl in ("auto", "bisect") and dtype == torch.float32
    if epoch_impl == "auto":
        if device.type != "cuda" or not fusable or has_miner_mask or shape[-3] < 1:
            return "eager"
        if not dyadic_grid_fits_int32(shape[-1], bisection_iterations(precision)):
            return "eager"
        tile = varying_scan_epoch_tile(tuple(shape), device)
        return "fused_varying" if tile >= 2 else "fused_scan"
    if epoch_impl in FUSED_RUNGS and has_miner_mask:
        raise ValueError(
            "the batched fused case scan has no per-scenario miner masks; "
            "heterogeneous suites use epoch_impl='eager'"
        )
    if epoch_impl in FUSED_RUNGS and not fusable:
        raise ValueError(
            f"epoch_impl={epoch_impl!r} bisects in-kernel on float32: it needs "
            "consensus_impl 'auto' or 'bisect' and dtype torch.float32"
        )
    return epoch_impl


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


def zero_carry(spec: VariantSpec, V: int, M: int, dtype=torch.float32, device="cpu") -> dict:
    """The carry at global epoch 0, as the engines' zero-init makes it:
    `bonds [V, M]`, `consensus [M]`, and `w_prev [V, M]` for a variant that
    carries previous weights."""
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
):
    """The eager rung: a Python loop over :func:`yuma_epoch`, carrying
    `(bonds, w_prev, consensus)`. Returns the per-epoch outputs stacked on
    the epoch axis (`dividends [(B,) E, V]`, ...), plus the final carry
    with `return_carry`. `miner_mask` marks a padded suite's real miner
    columns, per scenario (`[B, M]`) or shared (`[M]`)."""
    *lead, E, V, M = weights.shape
    dtype, dev = weights.dtype, weights.device
    cfg = _tensor_config(config, dev)
    ri = torch.as_tensor(reset_index, device=dev)
    r_epoch = torch.as_tensor(reset_epoch, device=dev)
    if miner_mask is not None:
        miner_mask = torch.as_tensor(miner_mask, dtype=dtype).to(dev)
    if carry is None:
        B = torch.zeros(tuple(lead) + (V, M), dtype=dtype, device=dev)
        W_prev = torch.zeros_like(B)
        C_prev = torch.zeros(tuple(lead) + (M,), dtype=dtype, device=dev)
    else:
        B = torch.as_tensor(carry["bonds"], dtype=dtype).to(dev)
        W_prev = torch.as_tensor(carry.get("w_prev", torch.zeros_like(B)), dtype=dtype).to(dev)
        C_prev = torch.as_tensor(carry["consensus"], dtype=dtype).to(dev)
    ys: dict = {"dividends": []}
    if save_bonds:
        ys["bonds"] = []
    if save_incentives:
        ys["incentives"] = []
    if save_consensus:
        ys["consensus"] = []
    for e in range(E):
        epoch = e + epoch_offset
        W = weights[..., e, :, :]
        S = stakes[..., e, :]
        if spec.reset_mode is not ResetMode.NONE:
            B = _apply_reset(B, C_prev, epoch, ri, r_epoch, spec.reset_mode, M)
        kernel_prev = None
        if spec.carries_prev_weights:
            # Epoch 0 falls back to this epoch's normalized weights
            # (reference yumas.py:299-300).
            kernel_prev = normalize_weight_rows(W) if epoch == 0 else W_prev
        res = yuma_epoch(
            W, S, B, cfg,
            bonds_mode=spec.bonds_mode,
            W_prev=kernel_prev,
            first_epoch=epoch == 0,
            miner_mask=miner_mask,
            consensus_impl=consensus_impl,
            x64=x64,
        )
        B = res[spec.bond_state_key]
        if spec.carries_prev_weights:
            W_prev = res["weight"]
        C_prev = res["server_consensus_weight"]
        ys["dividends"].append(
            _dividends_per_1k(res["validator_reward_normalized"], S, cfg)
        )
        if save_bonds:
            ys["bonds"].append(B)
        if save_incentives:
            ys["incentives"].append(res["server_incentive"])
        if save_consensus:
            ys["consensus"].append(C_prev)
    axis = len(lead)
    ys = {k: torch.stack(v, dim=axis) for k, v in ys.items()}
    if not return_carry:
        return ys
    carry_out = {"bonds": B, "consensus": C_prev}
    if spec.carries_prev_weights:
        carry_out["w_prev"] = W_prev
    return ys, carry_out


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
):
    """The fused rungs: the whole epoch loop in the case scan (K2) or the
    varying scan (K3, `varying=True`), with the support sum on the tensor
    cores (K4) under `mxu`; only the dividend-per-1000-tao conversion
    happens out here. Returns the same ys dict as :func:`_simulate_scan`."""
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
    device="cuda",
    x64: bool = False,
    initial_state: Optional[dict] = None,
    epoch_offset: int = 0,
    return_state: bool = False,
) -> SimulationResult:
    """Simulate one scenario under one named version; returns host arrays.

    `epoch_impl`: "auto" (default; see the module docstring), "eager",
    "fused_scan", "fused_varying" or their tensor-core twins
    "fused_scan_mxu" / "fused_varying_mxu". `consensus_impl`: "bisect" (default),
    "sorted", "kernel" (the CUDA bisection kernel inside the eager rung) or
    "auto"; the fused rungs bisect in-kernel. `x64=True` runs Yuma 0's
    quantization divide in float64, the JAX package's parity mode.

    `initial_state` / `epoch_offset` / `return_state`: the `final_state` of
    a `return_state=True` run fed back with `epoch_offset` set to that run's
    epoch count continues the trajectory over global epochs
    `[offset, offset + E)`.
    """
    dev = resolve_device(device)
    config = config if config is not None else YumaConfig()
    spec = variant_for_version(yuma_version)
    E, V, M = np.shape(scenario.weights)
    if initial_state is not None:
        validate_initial_state(initial_state, spec, V, M)
    if epoch_offset < 0:
        raise ValueError(f"epoch_offset must be >= 0, got {epoch_offset}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    save_bonds = _resolve_save(save_bonds, E * V * M * itemsize, "save_bonds")
    save_incentives = _resolve_save(save_incentives, E * M * itemsize, "save_incentives")
    engine = plan_engine(
        epoch_impl, consensus_impl, (E, V, M), dtype, dev, config.consensus_precision
    )

    weights = torch.as_tensor(scenario.weights, dtype=dtype).to(dev)
    stakes = torch.as_tensor(scenario.stakes, dtype=dtype).to(dev)
    ri = -1 if scenario.reset_bonds_index is None else scenario.reset_bonds_index
    re_ = -1 if scenario.reset_bonds_epoch is None else scenario.reset_bonds_epoch
    carry = None
    if initial_state is not None:
        carry = {
            k: torch.as_tensor(np.asarray(v), dtype=dtype).to(dev)
            for k, v in initial_state.items()
        }
    common = dict(
        save_bonds=save_bonds,
        save_incentives=save_incentives,
        save_consensus=save_consensus,
        carry=carry,
        epoch_offset=epoch_offset,
        return_carry=return_state,
        x64=x64,
    )
    if engine in FUSED_RUNGS:
        out = _simulate_case_fused(
            weights, stakes, ri, re_, config, spec,
            varying=engine.startswith("fused_varying"),
            mxu=engine in MXU_RUNGS, **common,
        )
    else:
        out = _simulate_scan(
            weights, stakes, torch.tensor(ri), torch.tensor(re_), config, spec,
            consensus_impl=resolve_consensus_impl(consensus_impl, V, M), **common,
        )
    state = None
    if return_state:
        out, carry_out = out
        state = {k: v.cpu().numpy() for k, v in carry_out.items()}
    host = {k: v.cpu().numpy() for k, v in out.items()}
    return SimulationResult(
        dividends=host["dividends"],
        bonds=host.get("bonds"),
        incentives=host.get("incentives"),
        consensus=host.get("consensus"),
        final_state=state,
        engine=engine,
    )


def run_simulation(
    case: Scenario,
    yuma_version: str,
    yuma_config: Optional[YumaConfig] = None,
    *,
    device="cuda",
    x64: bool = False,
) -> tuple[dict[str, list[float]], list[np.ndarray], list[np.ndarray]]:
    """Drop-in equivalent of the reference driver (simulation_utils.py:26-112):
    `(dividends_per_validator, bonds_per_epoch, server_incentives_per_epoch)`
    with numpy arrays in place of torch tensors."""
    result = simulate(
        case, yuma_version, yuma_config, save_bonds=True, save_incentives=True,
        device=device, x64=x64,
    )
    dividends_per_validator = {
        validator: [float(x) for x in result.dividends[:, i]]
        for i, validator in enumerate(case.validators)
    }
    return dividends_per_validator, list(result.bonds), list(result.incentives)


# ---------------------------------------------------------------------------
# the throughput paths: totals and final bonds, no per-epoch outputs

#: The scaled path's rungs; the batch takes the scans and the eager rung.
SCALED_IMPLS = ("auto", "eager", "fused", "fused_mxu", "fused_scan", "fused_scan_mxu")
SCALED_BATCH_IMPLS = ("auto", "eager", "fused_scan", "fused_scan_mxu")


def plan_scaled_engine(
    epoch_impl: str,
    consensus_impl: str,
    shape,
    dtype,
    device: torch.device,
    num_epochs: int,
    precision: int = 100_000,
    *,
    batched: bool = False,
) -> str:
    """Resolve `epoch_impl` of :func:`simulate_scaled` (`shape [V, M]`) or
    :func:`simulate_scaled_batch` (`[B, V, M]`, `batched=True`) to a rung
    (the JAX package's `planner.resolve_scaled_engine` with the numeric
    gates of `fused_scan_eligible`). `auto` runs the scaled scan with the
    VPU support ("fused_scan") on float32 CUDA tensors with at least one
    epoch while the dyadic quantize grid fits int32, else "eager". Its
    tensor-core spelling is bitwise the same and was not measurably faster
    at 256 x 4096 on an NVIDIA H100 80GB HBM3 at 700 W: faster in 11 of
    chip_smoke.py's 16 alternated pairs, short of the 13 fixed beforehand
    (PERF.md). JAX's further gate
    on Yuma 0 in x64 (`M * 2^iters >= 2^23`) guards its double-single
    float64 emulation; the port divides in native float64 and drops it.
    JAX's VMEM admission does not carry over: K5's state lives in device
    memory. `consensus_impl` is validated on every rung; the fused rungs
    bisect in-kernel and do not read it."""
    resolve_consensus_impl(consensus_impl, *shape[-2:])
    impls = SCALED_BATCH_IMPLS if batched else SCALED_IMPLS
    if epoch_impl not in impls:
        name = "simulate_scaled_batch" if batched else "simulate_scaled"
        raise ValueError(
            f"unknown epoch_impl {epoch_impl!r} for {name}; expected one of {impls}"
        )
    if epoch_impl != "auto":
        return epoch_impl
    M = shape[-1]
    if (
        device.type != "cuda"
        or dtype != torch.float32
        or num_epochs < 1
        or not dyadic_grid_fits_int32(M, bisection_iterations(precision))
    ):
        return "eager"
    return "fused_scan"


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

    `epoch_impl`: "auto" (see :func:`plan_scaled_engine`), "eager" (the
    loop over :func:`yuma_epoch`, JAX's "xla"), "fused_scan" /
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
    engine = plan_scaled_engine(
        epoch_impl, consensus_impl, (V, M), W.dtype, dev, scales.shape[0],
        config.consensus_precision,
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
    engine = plan_scaled_engine(
        epoch_impl, consensus_impl, tuple(W.shape), W.dtype, dev, scales.shape[0],
        config.consensus_precision, batched=True,
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
    bond reset fires. (JAX's `mesh=` and its HBM preflight are not ported
    yet: ROADMAP queue A, slices 4 and 5.)

    Returns `(total_dividends [V], final_bonds [V, M])`.
    """
    config = config if config is not None else YumaConfig()
    spec = spec if spec is not None else variant_for_version("Yuma 1 (paper)")
    _check_scalar_config(config, "simulate_constant")
    if W.ndim != 2:
        raise ValueError(f"W must be [V, M], got {tuple(W.shape)}")
    dev, (S,) = _throughput_inputs(W, S)
    V, M = W.shape
    consensus_impl = resolve_consensus_impl(consensus_impl, V, M)
    cfg = _tensor_config(config, dev)
    if hoist_invariant:
        return _simulate_constant_hoisted(W, S, num_epochs, cfg, spec, consensus_impl, x64)
    zero_b = torch.zeros_like(W)
    carry = TotalsCarry(
        bonds=zero_b, w_prev=zero_b,
        consensus=torch.zeros((M,), dtype=W.dtype, device=dev),
        acc=torch.zeros((V,), dtype=W.dtype, device=dev),
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
        rate = torch.as_tensor(cfg.bond_alpha, dtype=W.dtype, device=W.device)

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

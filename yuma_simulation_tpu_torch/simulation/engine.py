"""The epoch loop and the reference-compatible driver API.

The reference's `run_simulation` (reference simulation_utils.py:26-112) is
a Python `for` over epochs carrying `(B_state, W_prev, consensus)`. Here
the loop runs on one of three rungs:

- "fused_varying": the epoch-tiled varying scan (CUDA kernel K3);
- "fused_scan": the case scan, one epoch per step (CUDA kernel K2);
- "eager": a Python loop over :func:`..models.epoch.yuma_epoch` (the
  counterpart of the JAX package's XLA `lax.scan` rung).

`epoch_impl="auto"` resolves as the JAX package's planner does on the TPU:
the varying scan when its epoch tile reaches 2, else the case scan, for
CUDA tensors; on `device="cpu"` it resolves to "eager", as JAX's "auto"
resolves to its XLA rung off the TPU. The fused rungs on CPU tensors run
the kernels' plain PyTorch versions.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional

import numpy as np
import torch

from yuma_simulation_tpu_torch.models.config import YumaConfig
from yuma_simulation_tpu_torch.models.epoch import yuma_epoch
from yuma_simulation_tpu_torch.models.variants import (
    ResetMode,
    VariantSpec,
    variant_for_version,
)
from yuma_simulation_tpu_torch.ops.consensus import resolve_consensus_impl
from yuma_simulation_tpu_torch.ops.cuda_epoch import (
    fused_case_scan,
    fused_varying_scan,
    varying_scan_epoch_tile,
)
from yuma_simulation_tpu_torch.ops.normalize import normalize_weight_rows
from yuma_simulation_tpu_torch.scenarios.base import Scenario

EPOCH_IMPLS = ("auto", "eager", "fused_scan", "fused_varying")
FUSED_RUNGS = ("fused_scan", "fused_varying")
#: The JAX package's MXU twins of the fused rungs; not ported yet.
MXU_RUNGS = ("fused_scan_mxu", "fused_varying_mxu")

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
    #: The rung that ran ("fused_varying", "fused_scan" or "eager").
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
    epoch_impl: str, consensus_impl: str, shape, dtype, device: torch.device
) -> str:
    """Resolve `epoch_impl` for a `[(B,) E, V, M]` workload to a rung."""
    if epoch_impl in MXU_RUNGS:
        raise NotImplementedError(
            f"epoch_impl={epoch_impl!r}: the exact tensor-core support twins "
            "are not ported yet (ROADMAP B4); use "
            f"{epoch_impl[: -len('_mxu')]!r}, whose values they equal"
        )
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
        if device.type != "cuda" or not fusable or shape[-3] < 1:
            return "eager"
        tile = varying_scan_epoch_tile(tuple(shape), device)
        return "fused_varying" if tile >= 2 else "fused_scan"
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
    stakes_units = S * config.total_subnet_stake * 0.001
    emission = config.validator_emission_ratio * D_n * config.total_epoch_emission
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


def _tensor_config(config: YumaConfig, device) -> YumaConfig:
    """The config with its float fields as 0-d float32 tensors — what
    JAX's jitted engine sees of its config (traced leaves), which selects
    the float32 logit branch of the liquid-alpha fit."""

    def conv(dc):
        vals = {}
        for f in fields(dc):
            v = getattr(dc, f.name)
            if f.type == "float" and isinstance(v, (int, float)):
                v = torch.tensor(float(v), dtype=torch.float32, device=device)
            vals[f.name] = v
        return replace(dc, **vals)

    return YumaConfig(simulation=conv(config.simulation), yuma_params=conv(config.yuma_params))


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
    carry: Optional[dict] = None,
    epoch_offset: int = 0,
    return_carry: bool = False,
    x64: bool = False,
):
    """The eager rung: a Python loop over :func:`yuma_epoch`, carrying
    `(bonds, w_prev, consensus)`. Returns the per-epoch outputs stacked on
    the epoch axis (`dividends [(B,) E, V]`, ...), plus the final carry
    with `return_carry`."""
    *lead, E, V, M = weights.shape
    dtype, dev = weights.dtype, weights.device
    cfg = _tensor_config(config, dev)
    ri = torch.as_tensor(reset_index, device=dev)
    r_epoch = torch.as_tensor(reset_epoch, device=dev)
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
    epoch_tile: Optional[int] = None,
    carry: Optional[dict] = None,
    epoch_offset: int = 0,
    return_carry: bool = False,
    x64: bool = False,
):
    """The fused rungs: the whole epoch loop in the case scan (K2) or the
    varying scan (K3, `varying=True`); only the dividend-per-1000-tao
    conversion happens out here. Returns the same ys dict as
    :func:`_simulate_scan`."""
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
    "fused_scan" or "fused_varying". `consensus_impl`: "bisect" (default),
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
    engine = plan_engine(epoch_impl, consensus_impl, (E, V, M), dtype, dev)

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
            varying=engine == "fused_varying", **common,
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

"""Batched sweeps: a scenario suite stacked on a leading axis, one call.

`simulate_batch` runs a `[B, E, V, M]` suite on one rung: the fused scans
take the scenario batch as a grid dimension with per-scenario reset
vectors and hyperparameter rows; the eager rung runs the batch through
:func:`yuma_epoch`'s leading batch dimension. A config may carry `[B]`
fields, one value per scenario (:func:`config_grid`): the fused scans read
them as their `[B, 9]` hyperparameter table, and the eager rung broadcasts
them per lane. Either way a lane is bitwise the same point run alone with
a scalar config.

The grid sweeps: :func:`sweep_hyperparams` (one scenario over a config
grid, on the case scans), :func:`sweep_scaled_fused` (the scaled workload
over a grid, on the scaled scan) and :func:`total_dividends_batch`. A suite
of mixed shapes is padded to one shape by :func:`pad_scenarios` (donor-packed
to the planner's bucket by :func:`pack_scenarios`), with a per-scenario miner
mask that :func:`simulate_batch` takes.
"""

from __future__ import annotations

import itertools
from dataclasses import replace
from typing import Optional, Sequence

import numpy as np
import torch

from yuma_simulation_tpu_torch.models.config import (
    SimulationHyperparameters,
    YumaConfig,
    YumaParams,
)
from yuma_simulation_tpu_torch.models.variants import VariantSpec, variant_for_version
from yuma_simulation_tpu_torch.resilience import faults
from yuma_simulation_tpu_torch.scenarios.base import Scenario
from yuma_simulation_tpu_torch.simulation.engine import (
    _dispatch_case,
    config_lanes,
    resolve_device,
    simulate_scaled_batch,
    validate_initial_state,
)
from yuma_simulation_tpu_torch.simulation.planner import (
    FUSED_CASE_RUNGS,
    bucket_shape,
    plan_dispatch,
)
# The module, not its names: numerics imports simulation.carry, which
# imports this package.
from yuma_simulation_tpu_torch.telemetry import numerics as _numerics
from yuma_simulation_tpu_torch.telemetry.runctx import dispatch_annotation


def _reset_metadata(scenarios: Sequence[Scenario], device):
    """`([B] reset_index, [B] reset_epoch)` int32, -1 for None."""
    r_idx = torch.tensor(
        [-1 if s.reset_bonds_index is None else s.reset_bonds_index for s in scenarios],
        dtype=torch.int32,
    )
    r_epoch = torch.tensor(
        [-1 if s.reset_bonds_epoch is None else s.reset_bonds_epoch for s in scenarios],
        dtype=torch.int32,
    )
    return r_idx.to(device), r_epoch.to(device)


def pad_scenarios(
    scenarios: Sequence[Scenario],
    dtype: torch.dtype = torch.float32,
    *,
    pack_tiles: bool = False,
    device="cuda",
):
    """Pad a suite of mixed shapes to one `[B, E, V, M]` shape, as the JAX
    package does: appended epochs get zero weights and zero stakes (the
    dividend conversion's `stake > 1e-6` guard gives them zero dividends),
    appended validators zero stake, and appended miner columns zero weight
    and a 0 in the returned per-scenario miner mask, which keeps them out
    of the u16 quantize and the liquid-alpha quantiles.

    `pack_tiles=True` is donor packing (:func:`pack_scenarios`): the shared
    `[V, M]` is rounded up to the planner's (8, 128) bucket
    (:func:`..planner.bucket_shape`), the extra rows and columns padded by
    the same inert mechanism.

    Returns `(W [B, E, V, M], S [B, E, V], reset_index [B], reset_epoch
    [B], miner_mask [B, M])` on `device`."""
    dev = resolve_device(device)
    E = max(s.weights.shape[0] for s in scenarios)
    V = max(s.weights.shape[1] for s in scenarios)
    M = max(s.weights.shape[2] for s in scenarios)
    B = len(scenarios)
    if pack_tiles:
        bucket = bucket_shape(V, M, epochs=E, batch=B)
        V, M = bucket.padded_V, bucket.padded_M
    W = np.zeros((B, E, V, M), np.float32)
    S = np.zeros((B, E, V), np.float32)
    mask = np.zeros((B, M), np.float32)
    for i, s in enumerate(scenarios):
        e, v, m = s.weights.shape
        W[i, :e, :v, :m] = s.weights
        S[i, :e, :v] = s.stakes
        mask[i, :m] = 1.0
    r_idx, r_epoch = _reset_metadata(scenarios, dev)
    return (
        torch.as_tensor(W, dtype=dtype).to(dev),
        torch.as_tensor(S, dtype=dtype).to(dev),
        r_idx,
        r_epoch,
        torch.as_tensor(mask, dtype=dtype).to(dev),
    )


def pack_scenarios(scenarios: Sequence[Scenario], dtype: torch.dtype = torch.float32, *,
                   device="cuda"):
    """Donor packing: a mixed suite as one padded batch on the planner's
    (8, 128) bucket, :func:`pad_scenarios` with `pack_tiles=True`; the
    tensors are the JAX package's `pack_scenarios`'. It runs on the eager
    rung, the one that takes the miner mask."""
    return pad_scenarios(scenarios, dtype, pack_tiles=True, device=device)


def stack_scenarios(
    scenarios: Sequence[Scenario], dtype: torch.dtype = torch.float32, device="cuda"
):
    """Stack same-shaped scenarios into `[B, E, V, M]` / `[B, E, V]`
    tensors on `device` plus the reset metadata vectors."""
    dev = resolve_device(device)
    shapes = {s.weights.shape for s in scenarios}
    if len(shapes) != 1:
        raise ValueError(f"scenarios must share one [E,V,M] shape, got {shapes}")
    W = torch.as_tensor(np.stack([s.weights for s in scenarios]), dtype=dtype).to(dev)
    S = torch.as_tensor(np.stack([s.stakes for s in scenarios]), dtype=dtype).to(dev)
    r_idx, r_epoch = _reset_metadata(scenarios, dev)
    return W, S, r_idx, r_epoch


def simulate_batch(
    weights: torch.Tensor,  # [B, E, V, M]
    stakes: torch.Tensor,  # [B, E, V]
    reset_index: torch.Tensor,  # [B] int32
    reset_epoch: torch.Tensor,  # [B] int32
    config: YumaConfig,
    spec: VariantSpec,
    save_bonds: bool = False,
    save_incentives: bool = False,
    consensus_impl: str = "bisect",
    miner_mask: Optional[torch.Tensor] = None,  # [B, M] for padded suites
    epoch_impl: str = "auto",
    quarantine: bool = False,
    retry_policy=None,
    deadline=None,
    x64: bool = False,
) -> dict:
    """A scenario suite in one call, on the device the tensors live on.
    Returns `{"dividends": [B, E, V], ...}` tensors, and under
    ``"numerics"`` the per-lane, per-epoch sketches (``{stream:
    NumericsSketch}`` with `[B, E]` tensor leaves; :func:`..telemetry.
    numerics.to_host` brings them to the host) unless ``YUMA_NUMERICS=0``.
    `epoch_impl` as in
    :func:`..engine.simulate` ("auto" is the varying or case scan on CUDA
    tensors, the eager rung on CPU tensors). `config` may carry `[B]`
    fields, one value per scenario (a :func:`config_grid` grid).
    `miner_mask` (from :func:`pad_scenarios`) marks each scenario's real
    miners; such a suite runs on the eager rung ("auto" resolves to it, a
    fused rung raises), as the JAX package runs it on its XLA rung.

    `quarantine=True` folds the per-lane non-finite guard into the eager
    rung's carry ("auto" then resolves to "eager"; a fused rung raises): a
    lane whose outputs go NaN/Inf at epoch k is masked to zero from that
    epoch on and recorded in the returned ``ys["quarantine"]`` state
    (`{bad [B], first_bad_epoch [B], tensor_code [B]}` on the device — feed
    it to :func:`..resilience.guards.build_quarantine_report`), while
    healthy lanes stay bit-for-bit an unguarded run.

    `retry_policy` (a :class:`..resilience.retry.RetryPolicy`) arms the
    engine-degradation ladder: a classified engine failure on a fused rung
    retries with backoff, then demotes down `plan.ladder` on the same
    device (on the card down to the last kernel rung, never to "eager"),
    one ``event=engine_demoted`` record per step (the ys dict stays plain
    tensors). `deadline` (a :class:`..resilience.watchdog.Deadline`) runs
    each dispatch under the watchdog, ending in a synchronize of its
    stream; a hang raises a typed `EngineStall`, which an armed ladder
    retries and demotes like any engine failure."""
    if weights.ndim != 4:
        raise ValueError(f"weights must be [B, E, V, M], got {tuple(weights.shape)}")
    config_lanes(config, weights.shape[0])
    dev = resolve_device(weights.device)
    # check_memory=False: the tensors are already placed.
    plan = plan_dispatch(
        "simulate_batch", weights.shape, spec, config, weights.dtype,
        epoch_impl=epoch_impl, consensus_impl=consensus_impl, save_bonds=save_bonds,
        save_incentives=save_incentives, quarantine=quarantine,
        has_miner_mask=miner_mask is not None, check_memory=False, device=dev,
    )
    plan.record()
    capture = _numerics.numerics_enabled()

    def lane_epochs(fault):
        """The `[B]` epoch operand of a per-case fault (-1 = healthy lane),
        shared by the NaN and drift injections."""
        if fault is None:
            return None
        B = weights.shape[0]
        lanes = torch.full((B,), -1, dtype=torch.int32)
        if fault.case is None:
            lanes[:] = fault.epoch
        elif 0 <= fault.case < B:
            lanes[fault.case] = fault.epoch
        return lanes.to(dev)

    def dispatch(rung: str):
        eager_kwargs = {}
        if rung not in FUSED_CASE_RUNGS:
            eager_kwargs = dict(
                guard_nonfinite=quarantine,
                nan_fault_epoch=lane_epochs(faults.active_nan_fault()),
                # Armed only inside canary re-executions (faults.canary_scope).
                drift_fault_epoch=lane_epochs(faults.active_drift_fault()),
            )
        with dispatch_annotation(f"simulate_batch:{rung}"):
            return _dispatch_case(
                plan.demoted(rung), weights, stakes, reset_index, reset_epoch, config, spec,
                miner_mask=miner_mask, eager_kwargs=eager_kwargs, save_bonds=save_bonds,
                save_incentives=save_incentives, save_consensus=False, x64=x64,
                capture_numerics=capture,
            )

    from yuma_simulation_tpu_torch.resilience.retry import supervise

    ys, _, _ = supervise(dispatch, plan, retry_policy, deadline, label="simulate_batch")
    return ys


def sweep_hyperparams(
    scenario: Scenario,
    yuma_version: str,
    configs: YumaConfig,
    *,
    save_bonds: bool = False,
    quarantine: bool = False,
    dtype: torch.dtype = torch.float32,
    initial_state: Optional[dict] = None,
    epoch_offset: int = 0,
    epoch_impl: str = "auto",
    device="cuda",
    x64: bool = False,
) -> dict:
    """One scenario over a batched config (build it with
    :func:`config_grid`): the scenario is repeated over the grid axis and
    run as one batch, as :func:`simulate_batch` runs one (on the card the
    varying or the case scan, K3 or K2, with the grid as its `[G, 9]`
    hyperparameter table).
    Returns `{"dividends": [G, E, V](, "bonds": [G, E, V, M])}` and the
    `[G, E]` ``"numerics"`` sketches (as :func:`simulate_batch`'s); each
    lane is bitwise the same point run alone with a scalar config.

    `initial_state` / `epoch_offset`: resume every lane from ONE shared
    carry (the `final_state` of a `return_state=True` run), with the
    scenario's epochs indexed as global epochs `[offset, offset + E)`.

    `quarantine=True` arms the per-lane non-finite guard exactly as in
    :func:`simulate_batch` — here a lane is one grid point, which is the
    batch axis where NaNs originate (a pathological `bond_alpha` or `kappa`
    poisons its own recurrence while every other grid point is fine): the
    bad lane is masked and recorded in ``ys["quarantine"]``, the rest of
    the grid returns bit-for-bit the unguarded values. It runs on the eager
    rung and is incompatible with `initial_state` (the guard rides a
    monolithic scan carry)."""
    if epoch_offset < 0:
        raise ValueError(f"epoch_offset must be >= 0, got {epoch_offset}")
    if initial_state is not None and quarantine:
        raise ValueError(
            "sweep_hyperparams: initial_state does not compose with "
            "quarantine (the guard rides a monolithic scan carry); "
            "pass quarantine=False for suffix-resume grid units"
        )
    spec = variant_for_version(yuma_version)
    dev = resolve_device(device)
    G = config_lanes(configs)
    E, V, M = np.shape(scenario.weights)
    W = torch.as_tensor(np.asarray(scenario.weights), dtype=dtype).to(dev)
    S = torch.as_tensor(np.asarray(scenario.stakes), dtype=dtype).to(dev)
    ri, re_ = _reset_metadata([scenario] * G, dev)
    carry = None
    if initial_state is not None:
        validate_initial_state(initial_state, spec, V, M)
        carry = {
            k: torch.as_tensor(np.asarray(v), dtype=dtype).to(dev).expand((G,) + np.shape(v))
            for k, v in initial_state.items()
        }
    plan = plan_dispatch(
        "sweep_hyperparams", (G, E, V, M), spec, configs, dtype, epoch_impl=epoch_impl,
        save_bonds=save_bonds, quarantine=quarantine, check_memory=False, device=dev,
    )
    plan.record()
    return _dispatch_case(
        plan, W.expand(G, E, V, M), S.expand(G, E, V), ri, re_, configs, spec,
        eager_kwargs={"guard_nonfinite": True} if quarantine else None,
        carry=carry, epoch_offset=epoch_offset,
        save_bonds=save_bonds, save_incentives=False, save_consensus=False, x64=x64,
        capture_numerics=_numerics.numerics_enabled(),
    )


def sweep_scaled_fused(
    W: torch.Tensor,  # [V, M] shared base weights (or [G, V, M] per point)
    S: torch.Tensor,  # [V] shared stakes (or [G, V])
    scales: torch.Tensor,  # [E] per-epoch weight scale
    configs: YumaConfig,  # from config_grid: [G] fields
    yuma_version: str,
    *,
    epoch_impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """A hyperparameter grid over the scaled workload as one call: the
    shared scenario is broadcast over the grid and run by
    :func:`..engine.simulate_scaled_batch` (on the card the scaled scan,
    K5, with the grid as its `[G, 9]` hyperparameter table), on the device
    the tensors live on. Returns `(total_dividends [G, V], final_bonds
    [G, V, M])`."""
    spec = variant_for_version(yuma_version)
    G = config_lanes(configs)
    if W.ndim == 2:
        W = W.expand((G,) + tuple(W.shape))
        S = torch.as_tensor(S, dtype=W.dtype, device=W.device).expand((G,) + tuple(S.shape))
    return simulate_scaled_batch(W, S, scales, configs, spec, epoch_impl=epoch_impl)


def sweepable_config_fields(
    base_simulation: SimulationHyperparameters,
    base_params: YumaParams,
) -> tuple[set, set]:
    """The (simulation, yuma_params) field names a batched config may
    vary: floats only. The fields that select a different kernel path
    (`consensus_precision`, `liquid_alpha`, the quantile overrides) are
    excluded; the JAX package's one exclusion list."""
    sim_fields = {f for f in vars(base_simulation) if f != "consensus_precision"}
    par_fields = {
        f
        for f in vars(base_params)
        if f not in ("liquid_alpha", "override_consensus_high", "override_consensus_low")
    }
    return sim_fields, par_fields


def build_config_batch(
    points: Sequence[dict],
    base_simulation: Optional[SimulationHyperparameters] = None,
    base_params: Optional[YumaParams] = None,
) -> YumaConfig:
    """Stack per-point float-field overrides into one batched
    :class:`YumaConfig` whose sweepable fields are `[len(points)]`
    float32 tensors (on the CPU; the engines move them). Rejects fields
    that cannot be swept and unknown names."""
    if not points:
        raise ValueError("config batch needs at least one point")
    base_simulation = base_simulation or SimulationHyperparameters()
    base_params = base_params or YumaParams()
    sim_fields, par_fields = sweepable_config_fields(base_simulation, base_params)
    for point in points:
        for name in point:
            if name not in sim_fields and name not in par_fields:
                raise ValueError(f"cannot sweep non-float/static field '{name}'")

    def column(base, name):
        return torch.tensor(
            np.asarray([p.get(name, getattr(base, name)) for p in points], np.float32)
        )

    sim = replace(base_simulation, **{f: column(base_simulation, f) for f in sim_fields})
    par = replace(base_params, **{f: column(base_params, f) for f in par_fields})
    return YumaConfig(simulation=sim, yuma_params=par)


def config_grid(
    base_simulation: Optional[SimulationHyperparameters] = None,
    base_params: Optional[YumaParams] = None,
    **axes: Sequence[float],
) -> tuple[YumaConfig, list[dict]]:
    """A batched :class:`YumaConfig` from a cartesian hyperparameter grid:
    `axes` maps field names (`kappa`, `bond_alpha`, `bond_penalty`, ...)
    to value lists. Returns the batched config (fields stacked over the
    grid's flat order, the last axis fastest) and the grid-point dicts in
    the same order."""
    names = list(axes)
    points = [dict(zip(names, combo)) for combo in itertools.product(*axes.values())]
    return build_config_batch(points, base_simulation, base_params), points


def total_dividends_batch(
    scenarios: Sequence[Scenario],
    yuma_version: str,
    config: Optional[YumaConfig] = None,
    *,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    x64: bool = False,
) -> np.ndarray:
    """`[B, V]` total dividends of a suite: the per-epoch dividends of one
    :func:`simulate_batch`, summed over epochs on the device. A same-shaped
    suite runs unpadded ("auto": K3 or K2 on the card); a suite of mixed
    shapes is donor-packed (:func:`pack_scenarios`) and runs with its miner
    masks on the eager rung, its rows then as wide as the packed validator
    count (entries past a scenario's own validators are zero)."""
    config = config if config is not None else YumaConfig()
    spec = variant_for_version(yuma_version)
    if len({np.shape(s.weights) for s in scenarios}) == 1:
        W, S, ri, re_ = stack_scenarios(scenarios, dtype, device)
        ys = simulate_batch(W, S, ri, re_, config, spec, x64=x64)
    else:
        W, S, ri, re_, mask = pack_scenarios(scenarios, dtype, device=device)
        ys = simulate_batch(W, S, ri, re_, config, spec, miner_mask=mask, x64=x64)
    return ys["dividends"].sum(dim=1).cpu().numpy()

"""Scenario-batch sharding and the Monte-Carlo drivers, the counterpart of
the JAX package's `parallel/sharded.py`.

- :func:`simulate_batch_sharded`: a scenario suite split over the mesh's
  ``data`` axis, one :func:`..simulation.sweep.simulate_batch` per data
  shard on that shard's device. Scenarios are independent: no collective
  runs, and the outputs are gathered on the host.
- :func:`montecarlo_per_epoch_batched`: the weight-perturbation study with
  fresh weights every epoch (BASELINE config 5) as one batched ride. On
  the card the planner takes the varying scan (K3); each chunk's weights
  are a `[B, CH, V, M]` slab drawn on the card by K7
  (:func:`..ops.cuda_random.mc_weights`), double-buffered: the next slab is
  drawn on a side stream while the current chunk's scan runs, and the bond
  carry is threaded between chunks. The eager rung (the CPU's, JAX's XLA
  rung) draws each epoch's weights inside its loop, as JAX's scan does.
- :func:`montecarlo_total_dividends`: the same study sharded over a mesh,
  with weights constant per scenario (the hoisted constant scan) or fresh
  per epoch.

Every draw is JAX's threefry (:mod:`..random`): the same key gives the same
scenarios as the JAX package. :func:`simulate_batch_sharded` takes the
resilience tier's `elastic=` (shrink the mesh on device loss),
`quarantine=` and `deadline=`. :func:`shard_epoch_over_miners` runs one
epoch with the miner axis split over the mesh's ``model`` axis
(:mod:`..models.miner_shards`).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from yuma_simulation_tpu_torch import random as jrandom
from yuma_simulation_tpu_torch.models.config import YumaConfig
from yuma_simulation_tpu_torch.models.epoch import BondsMode, yuma_epoch
from yuma_simulation_tpu_torch.models.variants import VariantSpec, variant_for_version
from yuma_simulation_tpu_torch.ops.consensus import resolve_consensus_impl
from yuma_simulation_tpu_torch.ops.cuda_epoch import VARYING_EPOCH_TILE_MAX
from yuma_simulation_tpu_torch.ops.cuda_random import mc_weights
from yuma_simulation_tpu_torch.ops.normalize import normalize_weight_rows
from yuma_simulation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    MeshDegradation,
    surviving_mesh,
)
from yuma_simulation_tpu_torch.resilience import faults
from yuma_simulation_tpu_torch.resilience.errors import DeviceLossError, classify_failure
from yuma_simulation_tpu_torch.resilience.guards import build_quarantine_report
from yuma_simulation_tpu_torch.resilience.watchdog import run_with_deadline
from yuma_simulation_tpu_torch.scenarios.base import Scenario
from yuma_simulation_tpu_torch.simulation.carry import NumericsSketch, TotalsCarry
from yuma_simulation_tpu_torch.simulation.engine import (
    _constant_run,
    _dispatch_case,
    _dividends_per_1k,
    _tensor_config,
    resolve_device,
)
from yuma_simulation_tpu_torch.simulation.planner import (
    FUSED_CASE_RUNGS,
    STREAM_BUFFERS,
    plan_dispatch,
    resolve_montecarlo_engine,
)
from yuma_simulation_tpu_torch.simulation.sweep import simulate_batch, stack_scenarios
from yuma_simulation_tpu_torch.telemetry.metrics import get_registry
from yuma_simulation_tpu_torch.telemetry.numerics import SKETCH_FIELDS, to_host
from yuma_simulation_tpu_torch.telemetry.runctx import dispatch_annotation
from yuma_simulation_tpu_torch.telemetry.runctx import span as telemetry_span
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)


def _pad_batch(n: int, shards: int) -> int:
    """Scenarios to add so the batch divides evenly over the data axis."""
    return (-n) % shards


def _unpad_outputs(ys: dict, n: int) -> dict:
    """The gathered outputs as numpy, padded lanes dropped; the per-epoch
    numerics sketches (``{stream: NumericsSketch}``, `[B, E]` leaves) are
    trimmed leaf by leaf, and a per-lane quarantine state becomes a
    :class:`..resilience.guards.QuarantineReport` over the un-padded batch."""
    numerics = ys.pop("numerics", None)
    qstate = ys.pop("quarantine", None)
    out = {k: np.asarray(v)[:n] for k, v in ys.items()}
    if numerics is not None:
        out["numerics"] = {
            stream: NumericsSketch(**{f: np.asarray(getattr(sk, f))[:n] for f in SKETCH_FIELDS})
            for stream, sk in numerics.items()
        }
    if qstate is not None:
        out["quarantine"] = build_quarantine_report(
            {k: np.asarray(v)[:n] for k, v in qstate.items()}
        )
    return out


def _gather_shards(outs: list) -> dict:
    """The shards' outputs on the host, concatenated over the lane axis;
    each shard's sketches come over in one copy."""
    gathered = {k: np.concatenate([o[k].cpu().numpy() for o in outs])
                for k in outs[0] if k not in ("numerics", "quarantine")}
    if "quarantine" in outs[0]:
        gathered["quarantine"] = {
            k: np.concatenate([o["quarantine"][k].cpu().numpy() for o in outs])
            for k in outs[0]["quarantine"]
        }
    if "numerics" in outs[0]:
        host = [to_host(o["numerics"]) for o in outs]
        gathered["numerics"] = {
            stream: NumericsSketch(**{
                f: np.concatenate([getattr(h[stream], f) for h in host]) for f in SKETCH_FIELDS
            })
            for stream in host[0]
        }
    return gathered


def simulate_batch_sharded(
    scenarios: Sequence[Scenario],
    yuma_version: str,
    config: Optional[YumaConfig] = None,
    *,
    mesh: Mesh,
    save_bonds: bool = False,
    quarantine: bool = False,
    dtype: torch.dtype = torch.float32,
    elastic: bool = False,
    deadline=None,
    x64: bool = False,
) -> dict:
    """A scenario suite sharded over the mesh's data axis: the batch is
    padded to a multiple of the axis with copies of the last scenario,
    each shard's lanes run as one `simulate_batch` ("auto": K3 on the card)
    on the shard's device, and the per-epoch dividends `[B, E, V]` (and
    bonds with `save_bonds`) come back as numpy with the padding dropped.
    Each lane is bitwise its unsharded `simulate_batch` lane on the same
    rung.

    `quarantine=True` arms the per-lane non-finite guard in every shard (on
    the eager rung): the returned dict gains a ``"quarantine"`` report (a
    :class:`..resilience.guards.QuarantineReport` over the un-padded batch).

    `elastic=True` arms shrink-and-continue on device loss: a dispatch
    failure attributable to specific devices (a typed
    :class:`..resilience.errors.DeviceLossError`, real or fault-injected; a
    sticky CUDA error on one shard is attributed to that shard's device)
    rebuilds the mesh over the surviving devices
    (:func:`..mesh.surviving_mesh`), re-pads and re-shards the batch for the
    new data-axis width, and re-dispatches — one ``event=mesh_degraded``
    record and one ``mesh_shrinks`` count per shrink, the walk returned as
    ``out["mesh_degradations"]`` (a tuple of :class:`..mesh.MeshDegradation`,
    empty on the healthy path). The last rung is one device without
    sharding, taken when at most one device survives or when the failure
    names no device of the mesh. Lanes are independent of the data-axis
    layout, so a degraded run's lanes are bitwise the full mesh's. Failures
    that are not device loss propagate unchanged.

    `deadline` (a :class:`..resilience.watchdog.Deadline`) supervises EACH
    mesh attempt separately (the attempt ends in the outputs' host copy):
    the shrink walk runs on the caller side of the heartbeat, so each rung
    of a degradation gets a fresh budget, with the retry grace after the
    first. A stall raises a typed `EngineStall` to the caller."""
    config = config if config is not None else YumaConfig()
    spec = variant_for_version(yuma_version)
    n = len(scenarios)
    if n < 1:
        raise ValueError("simulate_batch_sharded needs at least one scenario")
    E, V, M = np.shape(scenarios[0].weights)

    def run_lanes(padded, members, label):
        """`padded` split evenly over `members` (MeshDevices), one
        `simulate_batch` each; the outputs gathered on the host. A sticky
        CUDA error on one member is attributed to it."""
        shards = len(members)
        lanes = len(padded) // shards
        W, S, ri, re_ = stack_scenarios(padded, dtype, device="cpu")
        outs = []
        for s, member in enumerate(members):
            dev = resolve_device(member.device)
            # Each device holds `lanes` scenarios: preflighted per shard.
            plan_dispatch(
                f"sharded_batch:{label}", (lanes, E, V, M), spec, config, dtype,
                save_bonds=save_bonds, quarantine=quarantine, device=dev,
            ).record()
            lane = slice(s * lanes, (s + 1) * lanes)
            try:
                with dispatch_annotation(f"sharded_batch:{label}"):
                    outs.append(simulate_batch(
                        W[lane].to(dev), S[lane].to(dev), ri[lane].to(dev), re_[lane].to(dev),
                        config, spec, save_bonds=save_bonds, save_incentives=False,
                        quarantine=quarantine, x64=x64,
                    ))
            except BaseException as exc:  # noqa: BLE001 — classified below
                typed = classify_failure(exc)
                if isinstance(typed, DeviceLossError) and not typed.device_ids:
                    raise DeviceLossError(
                        str(typed), device_ids=(member.id,), context_lost=typed.context_lost
                    ) from exc
                raise
        return _gather_shards(outs)

    def dispatch_on(mesh_now: Mesh) -> dict:
        members = [row[0] for row in mesh_now.grid]
        pad = _pad_batch(n, len(members))
        padded = list(scenarios) + [scenarios[-1]] * pad
        return run_lanes(padded, members, f"{len(members)}dev")

    degradations: list = []
    mesh_now: Optional[Mesh] = mesh
    fallback = mesh.grid[0][0]
    while True:
        # Each iteration supervises ONE dispatch on ONE mesh; the shrink
        # logic below runs on the caller side of the watchdog heartbeat.
        # The attempt index is the shrink count, so post-shrink attempts
        # get the retry grace.
        try:
            if mesh_now is None:
                with telemetry_span("mesh:single_device"):
                    faults.maybe_lose_device([fallback])
                    ys = run_with_deadline(
                        lambda: run_lanes(list(scenarios), [fallback], "single_device"),
                        deadline, label="sharded_batch:single_device",
                        attempt=len(degradations),
                    )
            else:
                with telemetry_span(f"mesh:{mesh_now.size}dev"):
                    # Test-only device-loss drill (inert in production):
                    # fires while the armed plan's lost device is still part
                    # of this mesh, before any launch.
                    faults.maybe_lose_device(list(mesh_now.devices.flat))
                    # Bind by value: an abandoned (stalled) worker must not
                    # read a mesh the caller has since replaced.
                    ys = run_with_deadline(
                        lambda m=mesh_now: dispatch_on(m), deadline,
                        label="sharded_batch", attempt=len(degradations),
                    )
            break
        except BaseException as exc:  # noqa: BLE001 — classified below
            typed = classify_failure(exc)
            if not elastic or mesh_now is None or not isinstance(typed, DeviceLossError):
                raise
            present = {d.id for d in mesh_now.devices.flat}
            lost = tuple(i for i in typed.device_ids if i in present)
            if typed.device_ids and not lost:
                # Names only devices this mesh does not route to: shrinking
                # cannot help, so propagate rather than loop.
                raise
            survivors = [d for d in mesh_now.devices.flat if d.id not in set(lost)]
            if lost and not survivors:
                raise
            new_mesh = surviving_mesh(mesh_now, lost) if lost else None
            if new_mesh is None and lost:
                fallback = survivors[0]
            from_n = mesh_now.size
            to_n = new_mesh.size if new_mesh is not None else 1
            record = MeshDegradation(
                from_devices=from_n, to_devices=to_n, lost_device_ids=lost,
                reason=type(typed).__name__,
            )
            degradations.append(record)
            get_registry().counter("mesh_shrinks", help="elastic mesh degradations").inc()
            log_event(
                logger, "mesh_degraded", from_devices=from_n, to_devices=to_n,
                lost=",".join(map(str, lost)) if lost else "unattributed",
                reason=record.reason,
            )
            mesh_now = new_mesh
    out = _unpad_outputs(ys, n)
    if elastic:
        out["mesh_degradations"] = tuple(degradations)
    return out


# ---------------------------------------------------------------------------
# the Monte-Carlo drivers


def _base_tensors(V: int, M: int, base_weights, base_stakes, dtype, dev):
    W = torch.ones((V, M)) if base_weights is None else torch.as_tensor(base_weights)
    S = torch.ones((V,)) if base_stakes is None else torch.as_tensor(base_stakes)
    return W.to(dev, dtype).contiguous(), S.to(dev, dtype).contiguous()


def _scenario_keys(key, num: int, dev) -> torch.Tensor:
    """The scenario keys of a single-device run, `split(split(key, 1)[0],
    num)`: the keys of :func:`montecarlo_total_dividends` on a mesh of
    one device."""
    return jrandom.split(jrandom.split(jrandom.as_key(key), 1)[0], num).to(dev)


def _mc_zero_carry(B: int, V: int, M: int, dtype, dev) -> TotalsCarry:
    z = torch.zeros((B, V, M), dtype=dtype, device=dev)
    return TotalsCarry(bonds=z, w_prev=z, consensus=torch.zeros((B, M), dtype=dtype, device=dev),
                       acc=torch.zeros((B, V), dtype=dtype, device=dev))


def _mc_varying_step(carry: TotalsCarry, keys, epoch: int, spec: VariantSpec, cfg, base, S,
                     perturbation, consensus_impl: str, x64: bool) -> TotalsCarry:
    """One epoch of the per-epoch Monte-Carlo on the eager rung (JAX's
    `_mc_varying_step`, batched): fresh weights from `fold_in(key, epoch)`
    (the GLOBAL epoch), the full epoch, dividends accumulated."""
    W = jrandom.perturbed(jrandom.fold_in(keys, epoch), base, perturbation)
    first = epoch == 0
    kernel_prev = None
    if spec.bonds_mode is BondsMode.EMA_PREV:
        kernel_prev = normalize_weight_rows(W) if first else carry.w_prev
    res = yuma_epoch(W, S, carry.bonds, cfg, bonds_mode=spec.bonds_mode, W_prev=kernel_prev,
                     first_epoch=first, consensus_impl=consensus_impl, x64=x64)
    return TotalsCarry(
        bonds=res[spec.bond_state_key],
        w_prev=res["weight"] if spec.carries_prev_weights else carry.w_prev,
        consensus=res["server_consensus_weight"],
        acc=carry.acc + _dividends_per_1k(res["validator_reward_normalized"], S, cfg),
    )


def _montecarlo_varying_chunk(keys, carry: TotalsCarry, epoch_lo: int, chunk_epochs: int, *,
                              spec, cfg, base, S, perturbation, consensus_impl,
                              x64) -> TotalsCarry:
    """`chunk_epochs` global epochs from `epoch_lo` for every scenario, the
    carry threaded: chunked is bitwise the monolithic run."""
    for epoch in range(epoch_lo, epoch_lo + chunk_epochs):
        carry = _mc_varying_step(carry, keys, epoch, spec, cfg, base, S, perturbation,
                                 consensus_impl, x64)
    return carry


def _mc_epoch_sum(totals: torch.Tensor, dividends: torch.Tensor) -> torch.Tensor:
    """`totals` plus `dividends [B, CH, V]` summed over the epoch axis
    strictly in epoch order, so the chunk length never changes the sum."""
    for e in range(dividends.shape[1]):
        totals = totals + dividends[:, e]
    return totals


class _SlabPair:
    """The double buffer of the fused Monte-Carlo on the card: two device
    slabs, allocated once; K7 draws into one on a side stream while the
    scan reads the other, the compute stream waiting for a slab's draw
    event and a draw into a slab waiting, on the card, for the scan that
    last read it."""

    def __init__(self, B: int, CH: int, V: int, M: int, dev):
        self.dev = dev
        self.compute = torch.cuda.current_stream(dev)
        self.side = torch.cuda.Stream(dev)
        self.side.wait_stream(self.compute)  # keys and base were made on the compute stream
        self.flat = [torch.empty(B * CH * V * M, dtype=torch.float32, device=dev)
                     for _ in range(STREAM_BUFFERS)]
        self.drawn: list = [None] * STREAM_BUFFERS
        self.read: list = [None] * STREAM_BUFFERS

    def draw(self, j: int, keys, lo: int, n: int, base, perturbation) -> None:
        B, (V, M) = keys.shape[0], base.shape
        with torch.cuda.stream(self.side):
            if self.read[j] is not None:
                self.side.wait_event(self.read[j])
            slab = self.flat[j][: B * n * V * M].view(B, n, V, M)
            mc_weights(keys, lo, n, base, perturbation, out=slab)
            self.drawn[j] = torch.cuda.Event()
            self.drawn[j].record(self.side)

    def take(self, j: int, B: int, n: int, V: int, M: int) -> torch.Tensor:
        self.compute.wait_event(self.drawn[j])
        return self.flat[j][: B * n * V * M].view(B, n, V, M)

    def release(self, j: int) -> None:
        self.read[j] = torch.cuda.Event()
        self.read[j].record(self.compute)


def _montecarlo_fused(plan, keys, E: int, chunk: int, base, S, perturbation, config, spec,
                      x64: bool) -> torch.Tensor:
    """The fused rungs: each chunk's `[B, CH, V, M]` slab from K7 (its plain
    version on CPU tensors), the scan over it with the carry threaded, the
    per-epoch dividends summed in epoch order."""
    B, (V, M), dev = keys.shape[0], base.shape, base.device
    carry = {"bonds": torch.zeros((B, V, M), device=dev),
             "consensus": torch.zeros((B, M), device=dev)}
    if spec.carries_prev_weights:
        carry["w_prev"] = torch.zeros((B, V, M), device=dev)
    totals = torch.zeros((B, V), device=dev)
    S_chunk = S.expand(B, chunk, V)
    pair = _SlabPair(B, chunk, V, M, dev) if dev.type == "cuda" else None
    starts = list(range(0, E, chunk))

    def draw(k: int):
        """Chunk k's slab: on the card drawn into slot k % 2 on the side
        stream (taken later), elsewhere drawn and returned."""
        lo = starts[k]
        n = min(chunk, E - lo)
        if pair is None:
            return mc_weights(keys, lo, n, base, perturbation)
        pair.draw(k % STREAM_BUFFERS, keys, lo, n, base, perturbation)
        return None

    staged = draw(0)
    for k, lo in enumerate(starts):
        n = min(chunk, E - lo)
        W = staged if pair is None else pair.take(k % STREAM_BUFFERS, B, n, V, M)
        if k + 1 < len(starts):
            staged = draw(k + 1)  # the next slab, on the card while this scan runs
        ys, carry = _dispatch_case(
            plan, W, S_chunk[:, :n], -1, -1, config, spec, carry=carry, epoch_offset=lo,
            return_carry=True, save_bonds=False, save_incentives=False,
            save_consensus=False, x64=x64,
        )
        if pair is not None:
            pair.release(k % STREAM_BUFFERS)
        totals = _mc_epoch_sum(totals, ys["dividends"])
    return totals


def montecarlo_per_epoch_batched(
    key,
    num_scenarios: int,
    num_epochs: int,
    num_validators: int,
    num_miners: int,
    yuma_version: str,
    config: Optional[YumaConfig] = None,
    *,
    base_weights=None,
    base_stakes=None,
    perturbation: float = 0.05,
    consensus_impl: str = "auto",
    epoch_impl: str = "auto",
    chunk_epochs: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    x64: bool = False,
) -> np.ndarray:
    """The per-epoch-weights Monte-Carlo as one batched ride: `B` scenarios,
    each epoch `e` of scenario `b` drawing `relu(base + p * normal(
    fold_in(key_b, e)))` with the scenario keys `split(split(key, 1)[0],
    B)` (those of :func:`montecarlo_total_dividends` on a one-device mesh).

    The rung is planned by :func:`..simulation.planner.plan_dispatch` on
    `[B, E, V, M]` as a stream: on the card "auto" is the varying scan
    (K3), fed by K7 slabs of `chunk_epochs` epochs (default: the memory
    plan's slab length, or the whole run), double-buffered, with the bond
    carry threaded; on the varying rung the chunk is rounded down to a
    multiple of 16 (its largest tile) once it is longer. The eager rung
    (the CPU's "auto", JAX's XLA rung) draws each epoch inside its loop and
    runs `chunk_epochs` epochs at a time (default all), bitwise the
    monolithic run. `key` is a :mod:`..random` key (`[2]`, or anything
    `jax.random.PRNGKey` returns). Returns `[B, V]` total dividends per
    1000 tao."""
    dev = resolve_device(device)
    config = config if config is not None else YumaConfig()
    spec = variant_for_version(yuma_version)
    B, E, V, M = int(num_scenarios), int(num_epochs), int(num_validators), int(num_miners)
    if E < 1:
        raise ValueError(f"num_epochs must be >= 1, got {num_epochs}")
    plan = plan_dispatch(
        f"montecarlo_batched:{yuma_version}", (B, E, V, M), spec, config, dtype,
        epoch_impl=epoch_impl, consensus_impl=consensus_impl, streaming=True, device=dev,
    )
    plan.record()
    fused = plan.engine in FUSED_CASE_RUNGS
    if chunk_epochs is None:
        # Only the fused rungs hold a slab; the eager rung draws in its loop.
        chunk_epochs = (plan.memory.chunk_epochs or E) if fused else E
    chunk = max(1, min(int(chunk_epochs), E))
    if plan.engine.startswith("fused_varying") and chunk > VARYING_EPOCH_TILE_MAX:
        # The varying scan pads no epochs: every full chunk at its deepest tile.
        chunk -= chunk % VARYING_EPOCH_TILE_MAX
    base, S = _base_tensors(V, M, base_weights, base_stakes, dtype, dev)
    keys = _scenario_keys(key, B, dev)
    if fused:
        totals = _montecarlo_fused(plan, keys, E, chunk, base, S, perturbation, config, spec,
                                   x64)
        return totals.cpu().numpy()
    cfg = _tensor_config(config, dev)
    carry = _mc_zero_carry(B, V, M, dtype, dev)
    for lo in range(0, E, chunk):
        carry = _montecarlo_varying_chunk(
            keys, carry, lo, min(chunk, E - lo), spec=spec, cfg=cfg, base=base, S=S,
            perturbation=perturbation, consensus_impl=plan.fallback_consensus, x64=x64,
        )
    return carry.acc.cpu().numpy()


def montecarlo_total_dividends(
    key,
    num_scenarios: int,
    num_epochs: int,
    num_validators: int,
    num_miners: int,
    yuma_version: str,
    config: Optional[YumaConfig] = None,
    *,
    mesh: Mesh,
    base_weights=None,
    base_stakes=None,
    perturbation: float = 0.05,
    weights_mode: str = "constant",
    consensus_impl: str = "auto",
    epoch_impl: str = "auto",
    dtype: torch.dtype = torch.float32,
    x64: bool = False,
) -> np.ndarray:
    """The weight-perturbation study (BASELINE config 5) sharded over the
    mesh's data axis: `[num_scenarios, V]` total dividends.

    `weights_mode` "constant" (default): one perturbation per scenario,
    `relu(base + p * normal(key_b, (V, M)))`, its epochs run by the
    constant scan ("auto": "hoisted", consensus once; "eager"/"xla": the
    full epoch each time), the shard's scenarios as one batch on its
    device. "per_epoch": fresh weights every epoch (`fold_in(key_b,
    epoch)`); on a one-device mesh with "auto" this is
    :func:`montecarlo_per_epoch_batched` (K7 and K3 on the card), with the
    same scenario keys; otherwise each shard runs the eager rung.
    "hoisted" with "per_epoch" raises. Scenario keys are `split(key,
    shards)` per shard, each split into the shard's scenarios; the batch
    is padded to a multiple of the data axis and trimmed.
    `consensus_impl="auto"` takes "sorted" below the shape threshold and
    "bisect" at or above it, as the JAX package's shape gate does."""
    config = config if config is not None else YumaConfig()
    spec = variant_for_version(yuma_version)
    V, M = int(num_validators), int(num_miners)
    consensus_impl = resolve_consensus_impl(consensus_impl, V, M)
    if weights_mode not in ("constant", "per_epoch"):
        raise ValueError(
            f"unknown weights_mode {weights_mode!r}; expected 'constant' or 'per_epoch'"
        )
    varying = weights_mode == "per_epoch"
    devices = mesh.data_devices()
    if varying and epoch_impl == "auto" and mesh.size == 1:
        return montecarlo_per_epoch_batched(
            key, num_scenarios, num_epochs, V, M, yuma_version, config,
            base_weights=base_weights, base_stakes=base_stakes, perturbation=perturbation,
            consensus_impl=consensus_impl, epoch_impl="auto", dtype=dtype,
            device=devices[0], x64=x64,
        )
    engine = resolve_montecarlo_engine(epoch_impl, varying)
    shards = mesh.shape[DATA_AXIS]
    per_shard = (num_scenarios + _pad_batch(num_scenarios, shards)) // shards
    shard_keys = jrandom.split(jrandom.as_key(key), shards)
    outs = []
    for s, dev in enumerate(devices):
        dev = resolve_device(dev)
        base, S = _base_tensors(V, M, base_weights, base_stakes, dtype, dev)
        keys = jrandom.split(shard_keys[s], per_shard).to(dev)
        cfg = _tensor_config(config, dev)
        if varying:
            carry = _montecarlo_varying_chunk(
                keys, _mc_zero_carry(per_shard, V, M, dtype, dev), 0, int(num_epochs),
                spec=spec, cfg=cfg, base=base, S=S, perturbation=perturbation,
                consensus_impl=consensus_impl, x64=x64,
            )
            outs.append(carry.acc)
        else:
            W = jrandom.perturbed(keys, base, perturbation)
            total, _ = _constant_run(W, S, int(num_epochs), cfg, spec, consensus_impl,
                                     engine == "hoisted", x64)
            outs.append(total)
    return np.concatenate([o.cpu().numpy() for o in outs])[:num_scenarios]


def shard_epoch_over_miners(
    W,
    S,
    B_old,
    config: YumaConfig,
    *,
    mesh: Mesh,
    bonds_mode,
    consensus_impl: str = "bisect",
) -> dict:
    """One consensus epoch with the miner axis sharded over the mesh's
    ``model`` axis (the JAX package's `shard_epoch_over_miners`): `W [V, M]`
    and `B_old [V, M]` (or None) split into column shards on the devices of
    the mesh's first row, `S [V]` replicated. The bisection is per miner and
    stays shard-local; only the miner-axis sums, the quantization's exact
    count and liquid alpha's quantiles cross shards
    (:func:`..models.miner_shards.sharded_epoch`).

    Returns :func:`..models.epoch.yuma_epoch`'s keys. The `[V, M]` and `[M]`
    outputs stay sharded: each is a
    :class:`..models.miner_shards.MinerSharded` (`.shards`, one tensor a
    shard; `.gather()` copies the whole width onto one device for a caller,
    `.numpy()` onto the host). The `[V]` outputs are tensors on the last
    shard's device. Values are bitwise the unsharded eager epoch's."""
    from yuma_simulation_tpu_torch.models.miner_shards import (
        SHARDED_KEYS,
        MinerSharded,
        sharded_epoch,
    )
    from yuma_simulation_tpu_torch.simulation.engine import _miner_shardings

    W = torch.as_tensor(W) if not isinstance(W, torch.Tensor) else W
    layout = _miner_shardings(mesh, W.shape[-1])
    dtype = W.dtype if W.is_floating_point() else torch.float32
    W_sh = layout.split(W, dtype)
    B_sh = None if B_old is None else layout.split(torch.as_tensor(B_old), dtype)
    S = torch.as_tensor(S, dtype=dtype).to(layout.devices[-1])
    cfg = _tensor_config(config, layout.devices[0])
    consensus_impl = resolve_consensus_impl(consensus_impl, *W.shape)
    with dispatch_annotation("shard_epoch_over_miners"):
        if layout.shards == 1:  # the unsharded epoch on the mesh's device
            out = yuma_epoch(W_sh[0], S, None if B_sh is None else B_sh[0], cfg,
                             bonds_mode=bonds_mode, consensus_impl=consensus_impl)
            out = {k: (v,) if k in SHARDED_KEYS and v.ndim else v for k, v in out.items()}
        else:
            out = sharded_epoch(layout, W_sh, S, B_sh, cfg, bonds_mode=bonds_mode,
                                consensus_impl=consensus_impl)
            out.pop("_rate")
    return {k: MinerSharded(layout, v) if isinstance(v, tuple) else v for k, v in out.items()}

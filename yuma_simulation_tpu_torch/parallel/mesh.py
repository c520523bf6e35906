"""Device meshes for the scenario batch, the counterpart of the JAX
package's `parallel/mesh.py`.

A :class:`Mesh` is plain data: a `(data, model)` grid of devices, single
controller, as a `jax.sharding.Mesh` is on one host. Its axes:

- ``"data"``: the scenario / Monte-Carlo batch axis, with no per-epoch
  traffic (:mod:`.sharded` runs one batch per data shard, on that shard's
  device);
- ``"model"``: the miner axis of the `[V, M]` matrices: ``simulate(mesh=)``,
  ``simulate_constant(mesh=)`` and :func:`.sharded.shard_epoch_over_miners`
  split it into column shards over the first row's devices
  (:mod:`..models.miner_shards`); a data shard of a scenario batch runs on
  the first device of its row.

Single controller: one process drives every shard, with no
`torch.distributed` collective. Entries may share a device (a `[1, n]`
mesh of `n` :class:`MeshDevice` entries with distinct ids on one
``cuda:0``) or sit on `n` cards.

A mesh entry is a :class:`MeshDevice`, a `torch.device` with the integer
`id` that elastic degradation names lost devices by (the JAX device's `id`):
a CUDA device's index by default, the position in `devices=` otherwise.
:func:`initialize_distributed` joins a multi-process run on
`torch.distributed` with JAX's failure semantics.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
from typing import Optional, Sequence

import numpy as np
import torch

# Re-exported: the typed error lives with the resilience taxonomy.
from yuma_simulation_tpu_torch.resilience.errors import DistributedInitError  # noqa: F401
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshDevice:
    """One mesh entry: the device a shard runs on and its id."""

    id: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A `(data, model)` grid of :class:`MeshDevice`, row-major."""

    grid: tuple  # tuple of rows, each a tuple of MeshDevice
    axis_names: tuple = (DATA_AXIS, MODEL_AXIS)

    @property
    def devices(self) -> np.ndarray:
        """The grid as a `[data, model]` object array (JAX's `Mesh.devices`)."""
        arr = np.empty((len(self.grid), len(self.grid[0])), dtype=object)
        for i, row in enumerate(self.grid):
            for j, d in enumerate(row):
                arr[i, j] = d
        return arr

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.grid), MODEL_AXIS: len(self.grid[0])}

    @property
    def size(self) -> int:
        return len(self.grid) * len(self.grid[0])

    def data_devices(self) -> list:
        """The device each data shard runs on: the first of its row."""
        return [row[0].device for row in self.grid]


def _mesh_devices(devices) -> list:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: make_mesh() spans the CUDA devices by default; "
                "pass devices= (for example [torch.device('cpu')] * 4) to build a mesh "
                "elsewhere"
            )
        return [MeshDevice(i, torch.device("cuda", i)) for i in range(torch.cuda.device_count())]
    out = []
    for pos, d in enumerate(devices):
        if isinstance(d, MeshDevice):
            out.append(d)
        else:
            d = torch.device(d)
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported mesh device {d}")
            out.append(MeshDevice(pos, d))
    if len({d.id for d in out}) != len(out):
        raise ValueError(f"mesh device ids must be unique, got {[d.id for d in out]}")
    return out


def make_mesh(data: int = -1, model: int = 1, *, devices: Optional[Sequence] = None) -> Mesh:
    """A `(data, model)` mesh over `devices` (default: every CUDA device;
    raises without CUDA). ``data=-1`` takes whatever is left after
    ``model``. `devices` may hold `torch.device`s, device strings or
    :class:`MeshDevice`s."""
    devs = _mesh_devices(devices)
    n = len(devs)
    if n < 1:
        raise ValueError("a mesh needs at least one device")
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    grid = tuple(tuple(devs[i * model:(i + 1) * model]) for i in range(data))
    return Mesh(grid)


@dataclasses.dataclass(frozen=True)
class MeshDegradation:
    """One elastic shrink of a sweep's mesh: which devices were dropped,
    what the mesh shrank from and to, and why."""

    from_devices: int
    to_devices: int
    lost_device_ids: tuple
    reason: str


def surviving_members(members: Sequence, lost_ids: Sequence, *, key=None) -> list:
    """`members` without `lost_ids`, identity taken from ``member.id`` when
    present, else the member itself."""
    if key is None:
        key = lambda m: getattr(m, "id", m)  # noqa: E731
    lost = set(lost_ids)
    return [m for m in members if key(m) not in lost]


def surviving_mesh(mesh: Mesh, lost_device_ids: Sequence[int]) -> Optional[Mesh]:
    """`mesh` rebuilt over its surviving devices after losing
    `lost_device_ids`, or None when at most one survives. The ``model``
    width is kept when the survivors still divide by it, else it becomes
    1 (JAX's rule)."""
    survivors = surviving_members(list(mesh.devices.flat), lost_device_ids)
    if len(survivors) <= 1:
        return None
    model = mesh.shape.get(MODEL_AXIS, 1)
    if model > 1 and len(survivors) % model:
        model = 1
    return make_mesh(data=-1, model=model, devices=survivors)


def make_hybrid_mesh(data_per_slice: int = -1, model: int = 1) -> Mesh:
    """The JAX package's multi-slice mesh (the data axis over slices, the
    model axis inside one). A single-controller PyTorch process sees one
    host's cards, one slice, so this is :func:`make_mesh` over them, as
    JAX's falls back to on one slice."""
    return make_mesh(data_per_slice, model)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    initialization_timeout: Optional[int] = None,
) -> None:
    """Join a multi-process run on `torch.distributed` (NCCL with CUDA,
    gloo without). A no-op when already joined.

    With every argument defaulted, the rendezvous is read from the
    environment (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`) and a
    failed join degrades to a single-process run with a debug log. With an
    explicit `coordinator_address` ("host:port") the caller has declared
    the run distributed: a peer that never joins raises
    :class:`DistributedInitError` within `initialization_timeout` seconds
    instead of silently simulating 1/N of the workload (JAX's contract)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    explicit = coordinator_address is not None
    kwargs: dict = {"backend": "nccl" if torch.cuda.is_available() else "gloo"}
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    if explicit:
        kwargs.update(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes if num_processes is not None else 1,
                      rank=process_id if process_id is not None else 0)
    else:
        kwargs["init_method"] = "env://"
        if num_processes is not None:
            kwargs["world_size"] = num_processes
        if process_id is not None:
            kwargs["rank"] = process_id
    try:
        dist.init_process_group(**kwargs)
        logger.info("distributed: process %d/%d (%s)", dist.get_rank(),
                    dist.get_world_size(), kwargs["backend"])
    except (RuntimeError, ValueError) as e:
        if explicit:
            log_event(
                logger, "distributed_init_failed", coordinator=coordinator_address,
                process="" if process_id is None else process_id,
                num_processes="" if num_processes is None else num_processes,
                timeout_s="" if initialization_timeout is None else initialization_timeout,
                error=type(e).__name__,
            )
            raise DistributedInitError(
                f"distributed join failed for explicit coordinator {coordinator_address} "
                f"(process {process_id}/{num_processes}); refusing to degrade to a "
                "single-process run"
            ) from e
        logger.debug("single-process run (distributed init skipped: %s)", e)

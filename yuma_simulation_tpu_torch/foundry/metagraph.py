"""Bittensor metagraph snapshot ingestion: real subnets as Scenarios.

The documented snapshot schema (no chain client, no network — a
snapshot is a file an operator exports once and replays forever):

**JSON** (``*.json``)::

    {
      "format": "yuma-metagraph-v1",
      "netuid": 21,                  # subnet id (int)
      "block": 4_200_000,            # chain block the snapshot was read at
      "stakes": [.. V floats ..],    # raw TAO stake per validator
      "weights": [[.. M floats ..],  # dense row per validator, raw u16-scale
                  ...],              # or chain-normalized — rows are
    }                                # re-normalized on ingestion

**npz** (``*.npz``) — the bulk format for real-subnet shapes: arrays
``stakes [V] f32``, plus either dense ``weights [V, M] f32`` or the
sparse row triplet ``weights_indptr [V+1] i64`` / ``weights_indices
[nnz] i64`` / ``weights_values [nnz] f32`` (CSR — what a chain export
actually looks like: each validator weights a few dozen of 4096
miners), and scalars ``netuid`` / ``block``.

:func:`synthetic_snapshot` generates a deterministic snapshot at the
real-subnet shape (V=256, M=4096), so tests and `chip_smoke.py` exercise
the ingestion path and the Yuma variants at that shape with no network and
no checked-in fixture. :func:`scenario_from_snapshot` tiles a snapshot
into the dense `Scenario` arrays every engine rung and `plan_dispatch`
take unchanged. A numpy-only copy of the JAX package's
`foundry/metagraph.py`: the same schema, files and draws, bitwise.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from yuma_simulation_tpu_torch.scenarios.base import Scenario
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

FORMAT = "yuma-metagraph-v1"


class SnapshotError(ValueError):
    """A snapshot file that violates the documented schema."""


@dataclass(frozen=True)
class MetagraphSnapshot:
    """One subnet metagraph at one block: dense `[V, M]` weights +
    `[V]` stakes (raw scale; normalization happens at ingestion)."""

    netuid: int
    block: int
    stakes: np.ndarray  # [V] float32, raw (un-normalized) stake
    weights: np.ndarray  # [V, M] float32, raw weight rows

    def __post_init__(self):
        object.__setattr__(
            self, "stakes", np.asarray(self.stakes, np.float32)
        )
        object.__setattr__(
            self, "weights", np.asarray(self.weights, np.float32)
        )
        V = self.stakes.shape[0]
        if self.weights.ndim != 2 or self.weights.shape[0] != V:
            raise SnapshotError(
                f"weights {self.weights.shape} inconsistent with "
                f"stakes [{V}]"
            )

    @property
    def num_validators(self) -> int:
        return int(self.stakes.shape[0])

    @property
    def num_miners(self) -> int:
        return int(self.weights.shape[1])


def _check_snapshot(snap: MetagraphSnapshot) -> MetagraphSnapshot:
    if not np.isfinite(snap.weights).all() or (snap.weights < 0).any():
        raise SnapshotError(
            f"netuid {snap.netuid}: weights must be finite and "
            "non-negative"
        )
    if not np.isfinite(snap.stakes).all() or (snap.stakes < 0).any():
        raise SnapshotError(
            f"netuid {snap.netuid}: stakes must be finite and non-negative"
        )
    if snap.stakes.sum() <= 0:
        raise SnapshotError(f"netuid {snap.netuid}: zero total stake")
    return snap


# ------------------------------------------------------------------ load/save


def load_metagraph_snapshot(
    path: Union[str, pathlib.Path],
) -> MetagraphSnapshot:
    """Load a snapshot file (JSON or npz — see the module docstring for
    the schema) with full validation: a malformed or poisoned snapshot
    fails here as a typed :class:`SnapshotError`, never as NaNs in a
    consensus reduction."""
    path = pathlib.Path(path)
    if path.suffix == ".json":
        snap = _load_json(path)
    elif path.suffix == ".npz":
        snap = _load_npz(path)
    else:
        raise SnapshotError(
            f"unknown snapshot extension {path.suffix!r} (want .json/.npz)"
        )
    snap = _check_snapshot(snap)
    log_event(
        logger,
        "metagraph_loaded",
        level=logging.INFO,
        path=str(path),
        netuid=snap.netuid,
        block=snap.block,
        validators=snap.num_validators,
        miners=snap.num_miners,
    )
    return snap


def _load_json(path: pathlib.Path) -> MetagraphSnapshot:
    try:
        payload = json.loads(path.read_text(encoding="utf-8"))
    except json.JSONDecodeError as exc:
        raise SnapshotError(f"{path}: not valid JSON ({exc})") from None
    if payload.get("format") != FORMAT:
        raise SnapshotError(
            f"{path}: format={payload.get('format')!r}, want {FORMAT!r}"
        )
    for key in ("netuid", "block", "stakes", "weights"):
        if key not in payload:
            raise SnapshotError(f"{path}: missing key {key!r}")
    return MetagraphSnapshot(
        netuid=int(payload["netuid"]),
        block=int(payload["block"]),
        stakes=np.asarray(payload["stakes"], np.float32),
        weights=np.asarray(payload["weights"], np.float32),
    )


def _load_npz(path: pathlib.Path) -> MetagraphSnapshot:
    with np.load(path) as data:
        names = set(data.files)
        if "stakes" not in names:
            raise SnapshotError(f"{path}: missing 'stakes' array")
        stakes = np.asarray(data["stakes"], np.float32)
        if "weights" in names:
            weights = np.asarray(data["weights"], np.float32)
        elif {"weights_indptr", "weights_indices", "weights_values"} <= names:
            weights = _dense_from_csr(
                data["weights_indptr"],
                data["weights_indices"],
                data["weights_values"],
                num_validators=stakes.shape[0],
                num_miners=int(data["num_miners"])
                if "num_miners" in names
                else None,
            )
        else:
            raise SnapshotError(
                f"{path}: need 'weights' or the CSR triplet "
                "'weights_indptr'/'weights_indices'/'weights_values'"
            )
        return MetagraphSnapshot(
            netuid=int(data["netuid"]) if "netuid" in names else 0,
            block=int(data["block"]) if "block" in names else 0,
            stakes=stakes,
            weights=weights,
        )


def _dense_from_csr(
    indptr, indices, values, *, num_validators: int, num_miners: Optional[int]
) -> np.ndarray:
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    values = np.asarray(values, np.float32)
    if indptr.shape != (num_validators + 1,):
        raise SnapshotError(
            f"weights_indptr shape {indptr.shape} != [V+1]="
            f"[{num_validators + 1}]"
        )
    if indices.shape != values.shape:
        raise SnapshotError("weights_indices/values length mismatch")
    M = int(num_miners) if num_miners else int(indices.max(initial=-1)) + 1
    if indices.size and (
        int(indices.min()) < 0 or int(indices.max()) >= max(M, 1)
    ):
        # A negative index would silently wrap onto the LAST miner
        # column; an oversized one would crash as a raw IndexError —
        # both must surface as the typed schema error the loader
        # promises.
        raise SnapshotError(
            f"weights_indices out of range [0, {M}): "
            f"min={int(indices.min())}, max={int(indices.max())}"
        )
    W = np.zeros((num_validators, max(M, 1)), np.float32)
    for v in range(num_validators):
        lo, hi = int(indptr[v]), int(indptr[v + 1])
        W[v, indices[lo:hi]] = values[lo:hi]
    return W


def save_metagraph_snapshot(
    snap: MetagraphSnapshot,
    path: Union[str, pathlib.Path],
    *,
    sparse: bool = True,
) -> pathlib.Path:
    """Write a snapshot in the documented schema (the format
    round-trips bitwise — pinned by tests). JSON writes dense rows;
    npz writes CSR when `sparse` (the realistic export: a few dozen
    non-zeros per 4096-wide row) else dense."""
    path = pathlib.Path(path)
    _check_snapshot(snap)
    if path.suffix == ".json":
        payload = {
            "format": FORMAT,
            "netuid": snap.netuid,
            "block": snap.block,
            "stakes": [float(s) for s in snap.stakes],
            "weights": [[float(w) for w in row] for row in snap.weights],
        }
        path.write_text(json.dumps(payload), encoding="utf-8")
        return path
    if path.suffix != ".npz":
        raise SnapshotError(
            f"unknown snapshot extension {path.suffix!r} (want .json/.npz)"
        )
    if sparse:
        indptr = [0]
        indices: list = []
        values: list = []
        for row in snap.weights:
            (nz,) = np.nonzero(row)
            indices.extend(int(i) for i in nz)
            values.extend(row[nz])
            indptr.append(len(indices))
        np.savez_compressed(
            path,
            netuid=snap.netuid,
            block=snap.block,
            stakes=snap.stakes,
            weights_indptr=np.asarray(indptr, np.int64),
            weights_indices=np.asarray(indices, np.int64),
            weights_values=np.asarray(values, np.float32),
            num_miners=snap.num_miners,
        )
    else:
        np.savez_compressed(
            path,
            netuid=snap.netuid,
            block=snap.block,
            stakes=snap.stakes,
            weights=snap.weights,
        )
    return path


# ------------------------------------------------------------------ synthesis


def synthetic_snapshot(
    seed: int,
    *,
    num_validators: int = 256,
    num_miners: int = 4096,
    nnz_per_row: int = 48,
    stake_tail: float = 1.2,
    consensus_sharpness: float = 8.0,
    netuid: int = 0,
    block: int = 0,
) -> MetagraphSnapshot:
    """A deterministic snapshot at real-subnet shape (default V=256,
    M=4096), statistically subnet-shaped:

    - stakes are heavy-tailed (Pareto-ish via lognormal, `stake_tail`
      controlling dispersion) — a few whales, a long tail;
    - a shared "consensus" miner-quality vector (Dirichlet-like via
      Gamma draws, `consensus_sharpness` concentrating mass on few
      miners) that every validator's row follows with individual noise;
    - each row touches only `nnz_per_row` miners (chain reality: u16
      weight slots are scarce), sampled by consensus quality.

    Pure numpy on an explicit `default_rng(seed)`, in the JAX package's
    call order and dtypes: bitwise its snapshot on any machine.
    """
    rng = np.random.default_rng(seed)
    stakes = rng.lognormal(
        mean=0.0, sigma=stake_tail, size=num_validators
    ).astype(np.float32)
    quality = rng.gamma(
        1.0 / consensus_sharpness, size=num_miners
    ).astype(np.float64)
    quality /= quality.sum()
    W = np.zeros((num_validators, num_miners), np.float32)
    nnz = min(nnz_per_row, num_miners)
    for v in range(num_validators):
        chosen = rng.choice(num_miners, size=nnz, replace=False, p=quality)
        noise = rng.lognormal(mean=0.0, sigma=0.35, size=nnz)
        row = quality[chosen] * noise
        W[v, chosen] = (row / row.sum()).astype(np.float32)
    return _check_snapshot(
        MetagraphSnapshot(
            netuid=netuid, block=block, stakes=stakes, weights=W
        )
    )


# ------------------------------------------------------------------ ingestion


def scenario_from_snapshot(
    snap: MetagraphSnapshot,
    *,
    num_epochs: int = 40,
    name: Optional[str] = None,
) -> Scenario:
    """Tile a snapshot into the dense `Scenario` every engine rung and
    `plan_dispatch` consume: weight rows re-normalized (zero rows stay
    zero), stakes normalized to fractions, both held constant across
    `num_epochs` (replaying a snapshot SEQUENCE as an epoch-varying
    scenario is the chain-replay service's job:
    :meth:`..replay.archive.SnapshotArchive.window_scenario`).
    Validated on the way out — row-normalized, finite, non-negative."""
    row_sums = snap.weights.sum(axis=1, keepdims=True)
    W_n = np.divide(
        snap.weights,
        row_sums,
        out=np.zeros_like(snap.weights),
        where=row_sums > 0,
    ).astype(np.float32)
    S_n = (snap.stakes / snap.stakes.sum()).astype(np.float32)
    V = snap.num_validators
    validators = [f"uid {v} ({S_n[v]:.4f})" for v in range(V)]
    scenario = Scenario(
        name=name
        or (
            f"metagraph netuid={snap.netuid} block={snap.block} "
            f"({V}x{snap.num_miners})"
        ),
        validators=validators,
        base_validator=validators[int(np.argmax(S_n))],
        weights=np.tile(W_n[None], (num_epochs, 1, 1)),
        stakes=np.tile(S_n[None], (num_epochs, 1)),
        num_epochs=num_epochs,
        servers=[f"Server {m + 1}" for m in range(snap.num_miners)],
    )
    scenario.validate(normalized=True)
    from yuma_simulation_tpu_torch.foundry.dsl import record_scenario_generated

    record_scenario_generated()
    return scenario


def snapshot_to_dict(snap: MetagraphSnapshot) -> dict:
    """JSON-able form (the `.json` schema) — symmetric with
    :func:`load_metagraph_snapshot` for tests and tooling."""
    return {
        "format": FORMAT,
        **{
            k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in dataclasses.asdict(snap).items()
        },
    }

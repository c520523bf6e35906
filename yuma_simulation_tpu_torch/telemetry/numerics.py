"""Per-epoch numerics sketches: what each run's output streams looked like.

The counterpart of the JAX package's `telemetry/numerics.py`, bitwise the
same observable:

- :func:`sketch_over_epochs` / :func:`epoch_sketch` compute a
  :class:`..simulation.carry.NumericsSketch` per epoch (per lane for a
  batch): the finite fraction, min / max / absmax over the finite values,
  and the wrapping u32 fingerprint of the raw bits
  (:mod:`..ops.fingerprint`). They run on the device that holds the
  stream, right after the rung produced it: a few small reductions per
  stream, no host synchronization of their own.
- Every reduction is exact and order-independent, so sketches are bitwise
  the same whether the epochs ran in one call or in slabs: merging slab
  captures is concatenation along the epoch axis (:func:`concat_sketches`).
- :func:`to_host` / :class:`HostFetch` bring a sketch set to the host in
  one copy (all leaves packed into one byte buffer); :func:`sketch_records`
  serializes host sketches into the ``numerics.jsonl`` records of the JAX
  package's flight bundles, and :func:`first_divergence` /
  :func:`compare_sketches` / :func:`diff_records` locate the first epoch
  where two captures differ, with the ulp distance there.

Two details make the sketches bitwise the JAX engines' (which compute them
inside `jit`): XLA compiles the finite fraction's divide by the constant
size into a multiply by its reciprocal, so the port multiplies by the
reciprocal too; and XLA's min / max order -0.0 below +0.0, which PyTorch's
`amin` / `amax` do not promise, so a zero result takes its sign from the
zeros present.

One switch turns the capture off everywhere: ``YUMA_NUMERICS=0`` (or
``false`` / ``off``); results then carry ``numerics=None``.
"""

from __future__ import annotations

import math
import os
from dataclasses import fields
from typing import Optional

import numpy as np
import torch

from yuma_simulation_tpu_torch.ops.fingerprint import fingerprint_u32, ulp_delta
from yuma_simulation_tpu_torch.simulation.carry import NumericsSketch

#: Stream names captured per engine dispatch, in capture order. The fused
#: rungs emit per-epoch consensus only when asked to save it, so records
#: compare on the intersection of the streams present.
NUMERICS_STREAMS = ("dividends", "consensus")

#: The sketch's fields, in declaration order.
SKETCH_FIELDS = tuple(f.name for f in fields(NumericsSketch))


def numerics_enabled() -> bool:
    """``YUMA_NUMERICS=0`` (or ``false`` / ``off``) disables per-epoch
    numerics capture everywhere; on by default."""
    return os.environ.get("YUMA_NUMERICS", "1").strip().lower() not in (
        "0",
        "false",
        "off",
    )


# ------------------------------------------------------------------ capture


def epoch_sketch(x: torch.Tensor) -> NumericsSketch:
    """The sketch of one epoch's tensor (all axes reduced): scalars."""
    sk = sketch_over_epochs(x[None], epoch_axis=0)
    return NumericsSketch(**{f: getattr(sk, f)[0] for f in SKETCH_FIELDS})


def sketch_over_epochs(x: torch.Tensor, epoch_axis: int) -> NumericsSketch:
    """Per-epoch :class:`NumericsSketch` of a stacked stream: every axis
    after `epoch_axis` is reduced per epoch, leading axes (batch lanes) are
    kept. `[E, V] -> [E]` sketches, `[B, E, V] -> [B, E]` sketches."""
    x = torch.as_tensor(x)
    axes = tuple(range(epoch_axis + 1, x.ndim))
    size = max(1, math.prod(int(d) for d in x.shape[epoch_axis + 1 :]))

    def reduce(fn, t):
        return fn(t, dim=axes) if axes else t

    def const(v):
        # Made where `x` lives: a host scalar copied over would block.
        return torch.full((), v, dtype=x.dtype, device=x.device)

    ok = torch.isfinite(x)
    finite = reduce(torch.sum, ok.to(torch.int32))
    # XLA divides by the constant size as a multiply by its reciprocal,
    # rounded once in the stream's dtype. The float64 quotient rounds to
    # the float32 reciprocal itself: 1/size is no closer than 2^-49 of its
    # value to a float32 rounding midpoint for size < 2^24.
    recip = const(1.0 / size)

    lo = reduce(torch.amin, torch.where(ok, x, const(math.inf)))
    hi = reduce(torch.amax, torch.where(ok, x, const(-math.inf)))
    # XLA's min / max order -0.0 below +0.0: a zero min is -0.0 when any
    # -0.0 is present, a zero max is +0.0 when any +0.0 is.
    zero, neg = x == 0, torch.signbit(x)
    any_neg0 = reduce(torch.any, zero & neg)
    any_pos0 = reduce(torch.any, zero & ~neg)
    lo = torch.where(lo == 0, torch.where(any_neg0, const(-0.0), const(0.0)), lo)
    hi = torch.where(hi == 0, torch.where(any_pos0, const(0.0), const(-0.0)), hi)
    return NumericsSketch(
        finite_frac=finite.to(x.dtype) * recip,
        lo=lo,
        hi=hi,
        absmax=reduce(torch.amax, torch.where(ok, x.abs(), const(0.0))),
        fingerprint=fingerprint_u32(x, axes=axes),
    )


def capture_streams(streams: dict, epoch_axis: Optional[int] = None) -> dict:
    """Sketch every non-None stream. `epoch_axis=None` means single-epoch
    tensors; an int means stacked streams (`[.., E, ..]`)."""
    out = {}
    for name, x in streams.items():
        if x is None:
            continue
        out[name] = epoch_sketch(x) if epoch_axis is None else sketch_over_epochs(x, epoch_axis)
    return out


# --------------------------------------------------------------- host side


def pack_sketches(sketches: dict) -> tuple[torch.Tensor, list]:
    """Every leaf of a sketch set (tensors on one device) as one flat
    `uint8` tensor, and the layout :func:`unpack_sketches` reads it back
    by. The fingerprints travel as their int32 bit patterns."""
    parts, layout = [], []
    for stream, sk in sketches.items():
        for f in SKETCH_FIELDS:
            t = getattr(sk, f)
            if f == "fingerprint":
                t = torch.where(t > 0x7FFFFFFF, t - (1 << 32), t).to(torch.int32)
                host_dtype = np.uint32
            else:
                host_dtype = np.dtype(str(t.dtype).removeprefix("torch."))
            t = t.contiguous().reshape(-1)
            parts.append(t.view(torch.uint8))
            layout.append((stream, f, host_dtype, tuple(getattr(sk, f).shape)))
    return torch.cat(parts), layout


def unpack_sketches(flat: np.ndarray, layout: list) -> dict:
    """The host sketch set from :func:`pack_sketches`' bytes (copied to the
    host as numpy) and layout: numpy leaves, fingerprints `uint32`."""
    buf = np.ascontiguousarray(flat).view(np.uint8)
    out: dict = {}
    at = 0
    for stream, f, dtype, shape in layout:
        n = math.prod(shape) * np.dtype(dtype).itemsize
        out.setdefault(stream, {})[f] = buf[at : at + n].view(dtype).reshape(shape).copy()
        at += n
    return {stream: NumericsSketch(**leaves) for stream, leaves in out.items()}


class HostFetch:
    """A sketch set's one copy to the host, started now and read by
    :meth:`result`. On the card the packed leaves go without blocking into
    pinned memory, so the copy completes behind whatever synchronizes the
    stream next (the outputs' own host copies) and costs no wait of its
    own."""

    def __init__(self, sketches: dict):
        flat, self._layout = pack_sketches(sketches)
        self._done = None
        if flat.is_cuda:
            self._buf = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            self._buf.copy_(flat, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self._buf = flat

    def result(self) -> dict:
        if self._done is not None:
            self._done.synchronize()
        return unpack_sketches(self._buf.numpy(), self._layout)


def to_host(sketches: dict) -> dict:
    """Fetch a sketch set of tensors to the host: numpy leaves,
    fingerprints `uint32` (one copy for the whole set). A set already on
    the host (numpy leaves, as the sharded batch gathers it) is returned
    as it is, as `jax.device_get` returns host arrays."""
    if all(not isinstance(getattr(sk, f), torch.Tensor)
           for sk in sketches.values() for f in SKETCH_FIELDS):
        return sketches
    return HostFetch(sketches).result()


def host_sketches(arrays: dict, epoch_axis: int = 0) -> dict:
    """The sketches of host (numpy) streams, computed on the CPU: what a
    capture on the card is held to, bit for bit."""
    return to_host(capture_streams(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()},
        epoch_axis=epoch_axis,
    ))


def sketch_mismatches(got: dict, ref: dict) -> list[str]:
    """Where two host sketch sets differ: their stream sets, or a leaf's
    dtype, shape or bytes. Empty when they are bitwise equal."""
    if set(got) != set(ref):
        return [f"streams {sorted(got)} != {sorted(ref)}"]
    out = []
    for stream in sorted(ref):
        for f in SKETCH_FIELDS:
            a, b = getattr(got[stream], f), getattr(ref[stream], f)
            if a.dtype != b.dtype or a.shape != b.shape:
                out.append(f"{stream}.{f}: {a.dtype}{a.shape} != {b.dtype}{b.shape}")
            elif not np.array_equal(a.view(np.uint8), b.view(np.uint8)):
                out.append(f"{stream}.{f}: bits differ")
    return out


def concat_sketches(chunks: list) -> dict:
    """Merge per-slab host captures of one stream set along the epoch axis
    (the last axis of every leaf): per-epoch values concatenate, nothing is
    re-reduced."""
    if not chunks:
        return {}
    return {
        stream: NumericsSketch(**{
            f: np.concatenate(
                [np.atleast_1d(np.asarray(getattr(c[stream], f))) for c in chunks], axis=-1
            )
            for f in SKETCH_FIELDS
        })
        for stream in chunks[0]
    }


def _lane_lists(arr: np.ndarray) -> list:
    """`[E]` or `[L, E]` -> per-lane python lists (always 2-D)."""
    a = np.atleast_2d(np.asarray(arr))
    return [lane.tolist() for lane in a]


def sketch_records(
    sketches: dict,
    *,
    unit: int,
    lanes,
    engine: str,
    role: str = "primary",
    label: str = "",
) -> list:
    """Serialize one dispatch's host sketches into ``numerics.jsonl``
    records: one record per stream, per-lane arrays nested
    (`fingerprint[lane][epoch]`, u32 as ints). `role` is "primary" or
    "canary"; `lanes` the `[lo, hi)` global-lane window."""
    records = []
    for stream, sk in sorted(sketches.items()):
        fp = np.atleast_2d(np.asarray(sk.fingerprint)).astype(np.uint32)
        records.append(
            {
                "unit": int(unit),
                "lanes": [int(lanes[0]), int(lanes[1])],
                "stream": stream,
                "engine": engine,
                "role": role,
                "label": label,
                "epochs": int(fp.shape[-1]),
                "fingerprint": [lane.tolist() for lane in fp],
                "finite_frac": _lane_lists(sk.finite_frac),
                "min": _lane_lists(sk.lo),
                "max": _lane_lists(sk.hi),
                "absmax": _lane_lists(sk.absmax),
            }
        )
    return records


def first_divergence(fp_a, fp_b) -> Optional[tuple]:
    """First epoch where two per-epoch fingerprint sequences differ, with
    the ulp distance there: `(epoch, ulp)`, or None when bitwise identical.
    Sequences of different lengths diverge at the shorter length."""
    a = np.asarray(fp_a, np.uint32).ravel()
    b = np.asarray(fp_b, np.uint32).ravel()
    n = min(a.size, b.size)
    neq = np.nonzero(a[:n] != b[:n])[0]
    if neq.size:
        e = int(neq[0])
        return e, ulp_delta(int(a[e]), int(b[e]))
    if a.size != b.size:
        return n, 0
    return None


def _lane_divergences(fa, fb) -> list:
    out = []
    for lane in range(max(len(fa), len(fb))):
        a = fa[lane] if lane < len(fa) else np.empty(0, np.uint32)
        b = fb[lane] if lane < len(fb) else np.empty(0, np.uint32)
        div = first_divergence(a, b)
        if div is not None:
            out.append({"lane": lane, "first_divergent_epoch": div[0], "ulp_distance": div[1]})
    return out


def compare_sketches(primary: dict, canary: dict) -> dict:
    """Per-stream divergences between two host sketch sets of the same
    workload: ``{stream: [{"lane", "first_divergent_epoch",
    "ulp_distance"}, ...]}`` over the streams both captured. Empty =
    bitwise identical wherever the captures overlap."""
    out: dict = {}
    for stream in sorted(set(primary) & set(canary)):
        divergences = _lane_divergences(
            np.atleast_2d(np.asarray(primary[stream].fingerprint)),
            np.atleast_2d(np.asarray(canary[stream].fingerprint)),
        )
        if divergences:
            out[stream] = divergences
    return out


def numerics_identity(rec: dict) -> tuple:
    """The record identity of the ``numerics.jsonl`` stream: ``(unit,
    lanes, stream, role, label)``, engine-free, so a unit re-run on another
    rung replaces its earlier capture."""
    return (
        rec.get("unit"),
        tuple(rec.get("lanes") or ()),
        rec.get("stream"),
        rec.get("role"),
        rec.get("label", ""),
    )


def check_numerics_records(records) -> list[str]:
    """Structural faults in serialized ``numerics.jsonl`` records (a record
    that cannot be compared is not a pass); empty when sound."""
    problems: list[str] = []
    for i, rec in enumerate(records):
        for field in ("stream", "engine", "role"):
            if not rec.get(field):
                problems.append(f"numerics[{i}] names no {field}")
        if rec.get("role") not in ("primary", "canary", None):
            problems.append(f"numerics[{i}] has unknown role {rec.get('role')!r}")
        fp = rec.get("fingerprint")
        if not isinstance(fp, list) or not fp:
            problems.append(f"numerics[{i}] carries no fingerprint lanes")
            continue
        epochs = rec.get("epochs")
        for lane in fp:
            if not isinstance(lane, list) or (isinstance(epochs, int) and len(lane) != epochs):
                problems.append(
                    f"numerics[{i}] fingerprint lane length mismatches "
                    f"declared epochs={epochs!r}"
                )
                break
    return problems


def diff_records(primary: dict, canary: dict) -> list:
    """Per-lane divergences between two ``numerics.jsonl`` records of the
    same (unit, stream): ``[{"lane", "first_divergent_epoch",
    "ulp_distance"}, ...]`` (empty = bitwise identical). Lanes index within
    the record's window; add ``lanes[0]`` for the global lane."""
    return _lane_divergences(primary.get("fingerprint", []), canary.get("fingerprint", []))

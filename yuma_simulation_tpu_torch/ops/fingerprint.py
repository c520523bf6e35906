"""The one bit-level tensor fingerprint every engine shares.

The counterpart of the JAX package's `ops/fingerprint.py`, bit for bit.
The fingerprint is deliberately not a hash:

- every float is **bit-cast to an unsigned 32-bit integer** (float32
  directly; float64 folds its 64 bits to 32 by xor-ing the halves), then
- the integers are **summed mod 2^32**.

Wrapping integer addition is exact, associative and commutative, so the
reduction is partition- and chunk-invariant by construction: a streamed
per-slab capture and a monolithic run give the identical fingerprint for
identical bits. Adjacent same-sign float32 values differ by exactly 1 in
their bit patterns, so the fingerprint delta between two captures of the
same tensor is the signed sum of the per-element ulp distances: one cell
flipped by one ulp moves the fingerprint by exactly 1 (:func:`ulp_delta`).

PyTorch has little `uint32` arithmetic, so the u32 values live in `int64`
tensors here (0 <= v < 2^32): the bits are summed as `int64`, which wraps
mod 2^64, and masked with ``& 0xFFFFFFFF``, which is the sum mod 2^32. On
the host :func:`..telemetry.numerics.to_host` hands them over as numpy
`uint32`, as the JAX package does.

Every capture site must call these functions: a second spelling would
fork the observable.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def bits_u32(x: torch.Tensor) -> torch.Tensor:
    """`x`'s raw bits as u32 values (in an `int64` tensor), elementwise.
    float32 bit-casts directly; float64 folds its 64 bits to 32 by xor-ing
    the high and low halves (the shift is arithmetic on `int64`, so the
    high half is masked after it). Other dtypes are cast to float32 first."""
    if x.dtype == torch.float64:
        b = x.view(torch.int64)
        return (b & _U32) ^ ((b >> 32) & _U32)
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    return x.view(torch.int32).to(torch.int64) & _U32


def fingerprint_u32(x: torch.Tensor, axes=None) -> torch.Tensor:
    """Wrapping u32 sum of `x`'s bits over `axes` (None = all axes; an int
    or a tuple), as an `int64` tensor of values in [0, 2^32).
    Order-independent by construction."""
    b = bits_u32(x)
    if axes is None:
        total = b.sum()
    else:
        axes = (axes,) if isinstance(axes, int) else tuple(axes)
        total = b.sum(dim=axes) if axes else b
    return total & _U32


def flip_ulp(x: torch.Tensor) -> torch.Tensor:
    """`x` with every element's bit pattern incremented by one (wrapping):
    one ulp up for positive finite values. The smallest drift a numerics
    comparison must catch."""
    if x.dtype == torch.float64:
        return (x.view(torch.int64) + 1).view(torch.float64)
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    up = x.view(torch.int32).to(torch.int64) + 1
    # Back into int32's range before narrowing: 0x7FFFFFFF + 1 is -2^31.
    up = torch.where(up > 0x7FFFFFFF, up - (1 << 32), up)
    return up.to(torch.int32).view(torch.float32)


def ulp_delta(a: int, b: int) -> int:
    """Host side: the signed mod-2^32 distance between two fingerprints,
    the summed per-element ulp distance when the tensors differ only in
    same-sign neighbourhoods. Returns the representative in [-2^31, 2^31)."""
    d = (int(b) - int(a)) % (1 << 32)
    return d - (1 << 32) if d >= (1 << 31) else d

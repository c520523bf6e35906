"""JAX's threefry key schedule and bits, for the plain reference.

Frozen copy of `yuma_simulation_tpu_torch/random.py` at commit b289c29
(`threefry2x32`, `fold_in`, `split`, `random_bits` and the unit-float
mapping of `uniform`), kept here so that later changes to the program
cannot move the reference. The integer rounds are exact, so the bits are
the program's. The normal transform is plain: `sqrt(2) * torch.erfinv(u)`
in the working dtype, where the program follows XLA:CPU's polynomial and
FMAs, so a drawn weight may differ from the program's in its last bit or
two. Keys are int64 tensors `[..., 2]` holding 32-bit words.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: `nextafter(-1, 0)` in float32: the lower bound of `jax.random.normal`'s uniform.
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _i64(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, of the counters `(x0, x1)` under the key `(k0, k1)`."""
    dev = next((v.device for v in (k0, k1, x0, x1) if isinstance(v, torch.Tensor)), None)
    k0, k1, x0, x1 = torch.broadcast_tensors(*(_i64(v, dev) for v in (k0, k1, x0, x1)))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for keys `[..., 2]` and integer data."""
    key = _i64(key)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, _i64(data, key.device) & MASK32)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """`jax.random.split(key, num)` for one key `[2]`: `[num, 2]`."""
    key = _i64(key)
    idx = torch.arange(int(num), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK32)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.bits(key, shape)` as int64 words; keys `[..., 2]` give `[..., *shape]`."""
    key = _i64(key)
    shape = tuple(int(n) for n in shape)
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=key.device).reshape(shape)
    k = key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,))
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], idx >> 32, idx & MASK32)
    return y0 ^ y1


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """Float32 standard normals of `jax.random.normal`'s construction:
    23 random mantissa bits as a unit float, mapped onto `[nextafter(-1, 0), 1)`,
    then `sqrt(2) * erfinv(u)`."""
    bits = random_bits(key, shape)
    unit = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(unit * (1.0 - NORMAL_LO) + NORMAL_LO, NORMAL_LO)
    return torch.erfinv(u) * float(np.sqrt(2.0))


def key_words(seed_words) -> torch.Tensor:
    """A key from two 32-bit words."""
    return _i64([int(w) & MASK32 for w in seed_words])

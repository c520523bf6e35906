"""JAX's threefry random numbers, bit for bit, in PyTorch.

The JAX package draws its Monte-Carlo weights with `jax.random`
(`parallel/sharded.py::_montecarlo_weight_slab`, `_mc_varying_step`,
`scenarios/synthetic.py::weight_perturbation_batch`). PyTorch's Philox
gives other numbers, so the port carries its own copy of JAX 0.9's
partitionable threefry (`jax_threefry_partitionable=True`): the same key
gives the port's users the same Monte-Carlo scenarios as the JAX
package's.

A key is what `jax.random.PRNGKey` returns, two 32-bit words, here an
int64 tensor `[..., 2]` with values in `[0, 2**32)`; every function takes
a batch of keys on the leading axes. The threefry rounds are exact
integer arithmetic on int64 tensors masked to 32 bits. The floats follow
XLA:CPU's program for `jax.random.uniform` / `normal` step by step,
including the multiply-adds LLVM contracts into one FMA there
(:func:`..ops.fma.fma`) and XLA's own `log1p` and `log` expansions, so
`normal` is JAX's on the CPU bitwise (tests/test_torch_random.py).

The layout of the counters (JAX `prng.py`):

- `split(key, n)[i]` and `fold_in(key, i)` are both
  `threefry2x32(key, (0, i))`, the two output words forming the new key;
- `random_bits(key, shape)` hashes the flat index `i` of each element
  as the pair `(i >> 32, i & 0xffffffff)` and xors the two output words.

This module is the plain version of kernel K7 (`csrc/mc_weights.cu`,
:mod:`.ops.cuda_random`), which computes :func:`perturbed_weights` in
one launch on the card.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from yuma_simulation_tpu_torch.ops.fma import fma

MASK32 = 0xFFFFFFFF
#: The key-schedule parity constant of Threefry.
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

_F32 = torch.float32


def _i64(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def as_key(key, device=None) -> torch.Tensor:
    """Keys as this module's int64 words: its own keys, or what
    `jax.random.PRNGKey` / `split` return (arrays of 32-bit words)."""
    return torch.as_tensor(np.asarray(key), dtype=torch.int64).to(device)


def PRNGKey(seed: int) -> torch.Tensor:
    """The key of an integer seed, as `jax.random.PRNGKey(seed)`: the
    seed's high and low 32 bits (a negative seed as its 64-bit two's
    complement)."""
    seed = int(seed)
    if not -(2**63) <= seed < 2**64:
        raise OverflowError(f"seed {seed} does not fit 64 bits")
    seed &= (1 << 64) - 1
    return _i64([seed >> 32, seed & MASK32])


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (JAX `prng.py::_threefry2x32_lowering`)
    of the counter pair `(x0, x1)` under the key `(k0, k1)`; int64 tensors
    holding 32-bit words, broadcast together."""
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
    """`jax.random.fold_in(key, data)`: keys `[..., 2]` and integer data
    `[...]` (taken modulo 2**32) broadcast; returns keys."""
    key = _i64(key)
    data = _i64(data, key.device) & MASK32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: Union[int, Sequence[int]] = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: `[*num, 2]` keys for one key `[2]`
    (`num` an int or a shape); a batch of keys `[..., 2]` gives `[...,
    *num, 2]`."""
    key = _i64(key)
    shape = (int(num),) if np.ndim(num) == 0 else tuple(int(n) for n in num)
    hi, lo = _counters(shape, key.device)
    k = key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,))
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], hi, lo)
    return torch.stack([y0, y1], dim=-1)


def _counters(shape: Sequence[int], device) -> tuple[torch.Tensor, torch.Tensor]:
    """The high and low words of each element's flat index."""
    idx = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64, device=device)
    idx = idx.reshape(tuple(shape))
    return idx >> 32, idx & MASK32


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (32 bits) as int64 words: keys `[...,
    2]` give `[..., *shape]`."""
    key = _i64(key)
    shape = tuple(int(n) for n in shape)
    hi, lo = _counters(shape, key.device)
    k = key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,))
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], hi, lo)
    return y0 ^ y1


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """23 random mantissa bits under exponent 0, minus one: `[0, 1)`."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(_F32) - 1.0


def uniform(key: torch.Tensor, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`:
    `max(minval, floats * (maxval - minval) + minval)`, the multiply-add one
    FMA as XLA:CPU compiles it."""
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    floats = _bits_to_unit(random_bits(key, shape))
    return torch.clamp_min(fma(floats, span, lo), float(lo))


#: `nextafter(-1, 0)` in float32: the lower bound of `normal`'s uniform.
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2.0)))


def _normal_erf_inv(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`erf_inv(u)` of `normal`'s uniform: the normal draw before its
    `sqrt(2)` factor."""
    return erf_inv(uniform(key, shape, NORMAL_LO, 1.0))


def normal(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.normal(key, shape, float32)`: `sqrt(2) * erf_inv(u)` of
    a uniform `u` in `[nextafter(-1, 0), 1)`."""
    return SQRT2 * _normal_erf_inv(key, shape)


def scaled_sqrt2(scale: float) -> float:
    """`scale * sqrt(2)` rounded to float32. XLA's simplifier turns `scale
    * normal(...)` into `erf_inv(u) * (scale * sqrt(2))`, the scalar
    product first, so the port multiplies in that order too."""
    return float(np.float32(scale) * np.float32(SQRT2))


def perturbed(keys: torch.Tensor, base: torch.Tensor, perturbation: float) -> torch.Tensor:
    """`relu(base + p * normal(key, base.shape))` for keys `[..., 2]`, as
    XLA:CPU compiles the JAX package's Monte-Carlo draws:
    `max(fma(erf_inv(u), p * sqrt(2), base), 0)`. Returns `[...,
    *base.shape]`."""
    r = _normal_erf_inv(keys, tuple(base.shape))
    return torch.clamp_min(fma(r, scaled_sqrt2(perturbation), base), 0.0)


def perturbed_weights(keys: torch.Tensor, epoch_lo: int, chunk_epochs: int,
                      base_weights: torch.Tensor, perturbation: float) -> torch.Tensor:
    """`[B, CH, V, M]` Monte-Carlo weights, the JAX package's
    `_montecarlo_weight_slab`: scenario b's epoch `lo + e` draws
    :func:`perturbed` with `fold_in(keys[b], lo + e)`. The plain version of
    kernel K7; it works one scenario at a time to bound its temporaries."""
    keys = _i64(keys, base_weights.device)
    base = base_weights.to(_F32)
    epochs = torch.arange(epoch_lo, epoch_lo + chunk_epochs, dtype=torch.int64,
                          device=base.device)
    out = torch.empty((keys.shape[0], chunk_epochs) + tuple(base.shape), dtype=_F32,
                      device=base.device)
    for b in range(keys.shape[0]):
        out[b] = perturbed(fold_in(keys[b], epochs), base, perturbation)
    return out


# ---------------------------------------------------------------------------
# XLA:CPU's float32 expansions of erf_inv, log1p, log and exp


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (the hardware's `sqrtps`,
    which XLA emits). PyTorch's CPU float32 `sqrt` is off by an ulp on
    some inputs; the float64 root rounded once to float32 is exact."""
    return torch.sqrt(x.double()).to(_F32)


def _c(v: float) -> float:
    return float(np.float32(v))


#: XLA's `log` (Cephes): the polynomial in x = m - 1, m in [sqrt(1/2), sqrt(2)).
_LOG_P = [_c(v) for v in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]
_LN2_HI = _c(0.693359375)
_LN2_LO = _c(-2.12194440e-4)
_SQRTHF = _c(0.707106781186547524)
_MIN_NORMAL = float(np.float32(2.0**-126))


def xla_log(u: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 `log` (its `log_f32` intrinsic, Cephes' `logf`):
    `u = m * 2**e` with `m` moved into `[sqrt(1/2), sqrt(2))`, a degree-8
    polynomial in three interleaved Horner parts, `e * ln 2` in two parts,
    each multiply-add one FMA where the compiled object has one."""
    bits = torch.clamp_min(u, _MIN_NORMAL).view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(_F32)
    e = ((bits >> 23) - 127).to(_F32) + 1.0
    small = m < _SQRTHF
    x = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - torch.where(small, 1.0, 0.0)
    x2 = x * x
    x3 = x2 * x
    P = _LOG_P
    y0 = fma(fma(x, P[0], P[1]), x, P[2])
    y1 = fma(fma(x, P[3], P[4]), x, P[5])
    y2 = fma(fma(x, P[6], P[7]), x, P[8])
    t = fma(fma(fma(y0, x3, y1), x3, y2), x3, e * _LN2_LO)
    r = fma(e, _LN2_HI, fma(-x2, 0.5, x) + t)
    r = torch.where((u < 0) | torch.isnan(u), float("nan"), r)
    r = torch.where(u == 0, float("-inf"), r)
    return torch.where(u == float("inf"), float("inf"), r)


#: XLA's `exp` (Cephes' `expf`): input clamp, `log2(e)`, and the
#: polynomial of `exp(x) - 1 - x` in `x - n ln 2`.
_EXP_LO = _c(-87.8)
_EXP_HI = _c(88.8)
_LOG2E = _c(1.44269504088896341)
_EXP_P = [_c(v) for v in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                          4.1665795894e-2, 1.6666665459e-1, 0.5)]


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 `exp` (its `exp_f32` intrinsic): `x` clamped to
    `[-87.8, 88.8]`, `n = floor(x log2(e) + 0.5)` clamped to `[-127,
    127]`, `r = x - n ln 2` in two parts, `1 + r + r**2 * P(r)` scaled by
    `2**n`, each multiply-add one FMA where the compiled object has one;
    results below the smallest normal are zero."""
    x = torch.as_tensor(x, dtype=_F32)
    x = torch.where(x < _EXP_LO, _EXP_LO, x)  # NaN passes
    x = torch.where(x > _EXP_HI, _EXP_HI, x)
    n = torch.floor(fma(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma(-n, _LN2_LO, fma(-n, _LN2_HI, x))
    y = fma(r, _EXP_P[0], _EXP_P[1])
    for k in _EXP_P[2:]:
        y = fma(y, r, k)
    y = (1.0 + fma(y, r * r, r)) * ((n.to(torch.int32) + 127) << 23).view(_F32)
    return torch.where(y.abs() < _MIN_NORMAL, y * 0.0, y)  # flushed, as XLA:CPU does


_LOG1P_DEN = [_c(v) for v in (1.5062909083469192043167e1, 8.3047565967967209469434e1,
                              2.2176239823732856465394e2, 3.0909872225312059774938e2,
                              2.1642788614495947685003e2, 6.0118660497603843919306e1)]
_LOG1P_NUM = [_c(v) for v in (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                              6.5787325942061044846969e0, 2.9911919328553073277375e1,
                              6.0949667980987787057556e1, 5.7112963590585538103336e1,
                              2.0039553499201281259648e1)]
#: `sqrt(2) - 1`: below it in magnitude, log1p takes the rational form.
_LOG1P_SMALL = _c(0.41421356237309504880)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 `log1p` (its `log1p_f32` intrinsic): `log(1 + x)`
    by :func:`xla_log`, or for `|x| < sqrt(2) - 1` Cephes' rational form
    `x - x**2 / 2 + x**3 * P(x) / Q(x)`, each Horner step one FMA. Inputs
    below the smallest normal are zero, as XLA:CPU flushes them."""
    x = torch.where(x.abs() < _MIN_NORMAL, x * 0.0, x)
    large = xla_log(x + 1.0)
    x2 = x * x
    den = x + _LOG1P_DEN[0]
    for k in _LOG1P_DEN[1:]:
        den = fma(den, x, k)
    num = fma(_LOG1P_NUM[0], x, _LOG1P_NUM[1])
    for k in _LOG1P_NUM[2:]:
        num = fma(num, x, k)
    small = x + fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


#: XLA's ErfInv32 (Giles' single-precision approximation): the Horner
#: coefficients for `w < 5` and for `w >= 5`.
_ERFINV_LT5 = [_c(v) for v in (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                               -4.39150654e-06, 0.00021858087, -0.00125372503,
                               -0.00417768164, 0.246640727, 1.50140941)]
_ERFINV_GE5 = [_c(v) for v in (-0.000200214257, 0.000100950558, 0.00134934322,
                               -0.00367342844, 0.00573950773, -0.0076224613,
                               0.00943887047, 1.00167406, 2.83297682)]


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 `erf_inv` as XLA:CPU compiles it: `w = -log1p(-x*x)`
    (:func:`xla_log1p`), then `w - 2.5` or `sqrt(w) - 3` into a Horner
    polynomial of 9 coefficients with each step one FMA, times `x`;
    `erf_inv(+-1) = +-inf`."""
    x = torch.as_tensor(x, dtype=_F32)
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_rn(w) - 3.0)
    lt5 = torch.tensor(_ERFINV_LT5, dtype=_F32, device=x.device)
    ge5 = torch.tensor(_ERFINV_GE5, dtype=_F32, device=x.device)
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = fma(p, w, torch.where(lt, lt5[i], ge5[i]))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)

"""A float32 fused multiply-add, correctly rounded, on any device.

XLA's CPU backend contracts some `a * b + c` of the JAX package's programs
into one FMA instruction: the product is not rounded before the add. Where
it does, the port computes the same single rounding with :func:`fma`, so
its values match JAX's bit for bit; the CUDA kernels spell those sites as
`__fmaf_rn` (they are built with `--fmad=false`, so no other FMA exists).

PyTorch has no fused multiply-add. The product of two float32 values is
exact in float64 (48 significant bits), but the float64 sum rounds, and a
second rounding to float32 can then land on the wrong side of a float32
halfway point. So the float64 sum is first rounded to odd (Boldo and
Melquiond, "Emulation of FMA and correctly rounded sums: proved algorithms
using rounding to odd", IEEE TC 2008): its exact error comes from TwoSum,
and an inexact sum whose last bit is even moves one ulp toward the exact
value. A float64 rounded to odd has 29 bits more than float32, so rounding
it to nearest float32 gives the correctly rounded `a * b + c`.
"""

from __future__ import annotations

import torch


def _f64(x, like=None) -> torch.Tensor:
    """`x` as float32 first (a Python float rounds as a float32 constant
    would), then widened to float64 exactly."""
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=dev).double()


def fma(a, b, c) -> torch.Tensor:
    """`round_f32(a * b + c)` with one rounding, as `fmaf` / `__fmaf_rn`
    compute it; the arguments broadcast and are taken as float32."""
    like = next((x for x in (a, b, c) if isinstance(x, torch.Tensor)), None)
    p = _f64(a, like) * _f64(b, like)  # exact
    c64 = _f64(c, like)
    s = p + c64
    # TwoSum: s + err == p + c exactly.
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    bits = s.view(torch.int64)
    nudge = (err != 0) & torch.isfinite(err) & ((bits & 1) == 0)
    # An even, inexact sum steps one ulp toward the exact value: up in
    # magnitude when the error has the sum's sign, down otherwise.
    step = torch.where((err > 0) == (s > 0), 1, -1)
    odd = torch.where(nudge, bits + step, bits).view(torch.float64)
    return odd.to(torch.float32)


def _round_to_odd(s, err):
    """The float64 `s` rounded to odd, given the exact error `err` of the
    sum it rounds: an even, inexact sum steps one ulp toward the exact
    value (up in magnitude when the error has the sum's sign)."""
    bits = s.view(torch.int64)
    nudge = (err != 0) & torch.isfinite(err) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(nudge, bits + step, bits).view(torch.float64)


def _two_sum(a, b):
    s = a + b
    bv = s - a
    return s, (a - (s - bv)) + (b - bv)


def _split(a):
    """Veltkamp's split of a float64 into two halves of 26 bits each."""
    t = a * 134217729.0  # 2^27 + 1
    hi = t - (t - a)
    return hi, a - hi


def fma64(a, b, c) -> torch.Tensor:
    """`round_f64(a * b + c)` with one rounding, for float64 tensors, as an
    FMA instruction on float64 computes it: the product exactly as a sum of
    two doubles (Dekker), then the three-term sum rounded once (Boldo and
    Melquiond: `RN(th + RO(tl + pl))`, the inner sum rounded to odd)."""
    a, b, c = (torch.as_tensor(x, dtype=torch.float64) for x in (a, b, c))
    ph = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pl = ((ah * bh - ph) + ah * bl + al * bh) + al * bl  # ph + pl == a * b
    th, tl = _two_sum(c, ph)
    v, err = _two_sum(tl, pl)
    return th + _round_to_odd(v, err)


def fma_chain(x: torch.Tensor, y: torch.Tensor, dim: int = -1, keepdim: bool = False):
    """`sum(x * y)` along `dim` as XLA's CPU backend contracts a reduce of
    products: from 0, left to right, each step one FMA
    (`acc = fma(x[i], y[i], acc)`); `x` and `y` broadcast."""
    x, y = torch.broadcast_tensors(x, y)
    x, y = x.movedim(dim, -1), y.movedim(dim, -1)
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[-1]):
        acc = fma(x[..., i], y[..., i], acc)
    return acc.unsqueeze(dim) if keepdim else acc


def fmaf_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """`__fmaf_rn(a, b, c)` elementwise on the card (`csrc/consensus.cu`,
    `k_fmaf`), for contiguous float32 CUDA tensors of one shape: what
    :func:`fma` is held to, bitwise, on the card. No launch counter: it is
    on no simulation path."""
    import ctypes

    from yuma_simulation_tpu_torch.ops import _build

    for x in (a, b, c):
        if x.device.type != "cuda" or x.dtype != torch.float32 or x.shape != a.shape:
            raise ValueError("fmaf_cuda takes float32 CUDA tensors of one shape")
    a, b, c = (x.contiguous() for x in (a, b, c))
    out = torch.empty_like(a)
    fn = _build.load("consensus.cu").yuma_fmaf
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), a.numel(),
             torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"k_fmaf failed: CUDA error {err}")
    return out

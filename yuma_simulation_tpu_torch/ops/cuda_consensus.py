"""K1: the consensus bisection as a hand-written CUDA kernel
(`csrc/consensus.cu`), the counterpart of the JAX package's
`ops/pallas_consensus.py::stake_weighted_median_pallas`; and K4, the same
bisection with each halving's support sum on the tensor cores
(`k_bisect_mma`, `csrc/common.cuh`), the counterpart of the JAX package's
exact MXU support (`ops/pallas_epoch.py::_stake_limb_split` /
`_support_limbs_mxu`).

:func:`stake_weighted_median_cuda` launches the kernel on CUDA tensors and
runs its plain version, :func:`..ops.consensus.stake_weighted_median`, on
CPU tensors. The support test runs on the canonical fixed-point stakes, so
the two agree bitwise, with `mma` and without.
"""

from __future__ import annotations

import ctypes
import math

import torch

from yuma_simulation_tpu_torch.ops import _build
from yuma_simulation_tpu_torch.ops.consensus import (
    check_mxu_support_covers,
    stake_weighted_median,
)
from yuma_simulation_tpu_torch.ops.launches import COUNTERS

LAUNCHES = COUNTERS["consensus_bisect"]
#: K4's count: every launch of the tensor-core bisection, by this wrapper
#: with `mma=True` and inside the scans with `mxu=True` (one per epoch tile).
MMA_LAUNCHES = COUNTERS["support_mma"]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: `yuma_bisect`'s parameters (csrc/consensus.cu): wn, sn, kappa (by
#: value), chi, nslab, V, M, iters, mma, stream.
BISECT_ARGTYPES = [_P, _P, ctypes.c_float, _P, _I, _I, _I, _I, _I, _P]


def _bisect_fn():
    fn = _build.load("consensus.cu").yuma_bisect
    fn.argtypes = BISECT_ARGTYPES
    fn.restype = _I
    return fn


def check_cuda_float32(name: str, x: torch.Tensor, shape=None) -> None:
    """The kernels' input contract: a contiguous float32 CUDA tensor of
    the expected shape."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")


def stake_weighted_median_cuda(
    W: torch.Tensor,
    S: torch.Tensor,
    kappa,
    precision: int = 100_000,
    *,
    mma: bool = False,
) -> torch.Tensor:
    """Drop-in for :func:`..ops.consensus.stake_weighted_median`:
    row-normalized `W [..., V, M]`, normalized stake `S [..., V]`, scalar
    `kappa` (a number, passed to the kernel by value); returns the final
    `c_high [..., M]`. `mma=True` runs K4 (V <= 2^14). CPU tensors run the
    plain version; CUDA tensors launch the kernel, one launch and one
    allocation (the output) a call; other devices raise."""
    if W.device.type == "cpu":
        return stake_weighted_median(W, S, kappa, precision, mxu=mma)
    if W.ndim < 2:
        raise ValueError(f"consensus expects [..., V, M] weights, got {tuple(W.shape)}")
    lead = tuple(W.shape[:-2])
    V, M = W.shape[-2:]
    check_cuda_float32("W", W)
    check_cuda_float32("S", S, lead + (V,))
    if mma:
        check_mxu_support_covers(V)
    nslab = math.prod(lead)
    iters = int(math.ceil(math.log2(precision)))
    chi = torch.empty(lead + (M,), dtype=torch.float32, device=W.device)
    err = _bisect_fn()(
        W.data_ptr(),
        S.data_ptr(),
        float(kappa),  # rounded to float32 by ctypes, as the plain version rounds it
        chi.data_ptr(),
        nslab,
        V,
        M,
        iters,
        int(mma),
        torch.cuda.current_stream(W.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"consensus bisection kernel failed: CUDA error {err}")
    (MMA_LAUNCHES if mma else LAUNCHES).add()
    return chi

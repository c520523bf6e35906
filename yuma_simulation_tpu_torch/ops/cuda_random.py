"""K7: the Monte-Carlo weight slab as a hand-written CUDA kernel
(`csrc/mc_weights.cu`, `k_mc_weights`).

:func:`mc_weights` computes :func:`..random.perturbed_weights`, the JAX
package's `parallel/sharded.py::_montecarlo_weight_slab`: `[B, CH, V, M]`
weights `relu(base + p * normal(fold_in(keys[b], lo + e), (V, M)))` drawn
with JAX's threefry. It replaces no TPU kernel (JAX makes the slab in
XLA); it exists because the plain version is some twenty int64 tensor
operations a threefry round over every element, several GB of
temporaries at the Monte-Carlo bench's slab, where the kernel writes each
element once. On CUDA tensors it launches the kernel, bitwise its plain
version; on CPU tensors it runs the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from yuma_simulation_tpu_torch.ops import _build
from yuma_simulation_tpu_torch.ops.cuda_consensus import check_cuda_float32
from yuma_simulation_tpu_torch.ops.launches import COUNTERS
from yuma_simulation_tpu_torch.random import MASK32, perturbed_weights, scaled_sqrt2

LAUNCHES = COUNTERS["mc_weights"]

_P = ctypes.c_void_p
#: `yuma_mc_weights`'s parameters (csrc/mc_weights.cu): keys, base, out, B,
#: CH, VM, lo, p_sqrt2 (by value), stream.
MC_WEIGHTS_ARGTYPES = [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_uint, ctypes.c_float, _P]


def _mc_weights_fn():
    fn = _build.load("mc_weights.cu").yuma_mc_weights
    fn.argtypes = MC_WEIGHTS_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def key_words(keys: torch.Tensor) -> torch.Tensor:
    """Keys `[..., 2]` (int64 holding 32-bit words) as the int32 tensor
    whose bytes are the kernel's uint32 words."""
    keys = torch.as_tensor(keys, dtype=torch.int64) & MASK32
    return (keys - (keys >= 2**31).to(torch.int64) * 2**32).to(torch.int32)


def mc_weights(keys: torch.Tensor, epoch_lo: int, chunk_epochs: int,
               base_weights: torch.Tensor, perturbation: float, *,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`[B, CH, V, M]` Monte-Carlo weights for scenario keys `[B, 2]`,
    global epochs `[lo, lo + CH)`, `base_weights [V, M]` and the scale
    `perturbation`, on the device `base_weights` lives on. CUDA: one
    launch of K7 into `out` (a contiguous float32 `[B, CH, V, M]` on the
    card) or a new tensor; CPU: the plain version."""
    if base_weights.device.type == "cpu":
        res = perturbed_weights(keys, epoch_lo, chunk_epochs, base_weights, perturbation)
        if out is None:
            return res
        out.copy_(res)
        return out
    if base_weights.ndim != 2:
        raise ValueError(f"base_weights must be [V, M], got {tuple(base_weights.shape)}")
    check_cuda_float32("base_weights", base_weights)
    dev = base_weights.device
    words = key_words(keys).to(dev)
    if words.ndim != 2 or words.shape[1] != 2:
        raise ValueError(f"keys must be [B, 2], got {tuple(words.shape)}")
    B, CH = int(words.shape[0]), int(chunk_epochs)
    if not (0 <= int(epoch_lo) and int(epoch_lo) + CH <= 2**32):
        raise ValueError(f"epochs [{epoch_lo}, {epoch_lo + CH}) must lie in [0, 2**32)")
    shape = (B, CH) + tuple(base_weights.shape)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    check_cuda_float32("out", out, shape)
    err = _mc_weights_fn()(
        words.data_ptr(), base_weights.data_ptr(), out.data_ptr(), B, CH,
        base_weights.numel(), int(epoch_lo), scaled_sqrt2(perturbation),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"Monte-Carlo weight kernel failed: CUDA error {err}")
    LAUNCHES.add()
    return out

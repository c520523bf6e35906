"""The epoch scans as hand-written CUDA kernels, the counterparts of the
JAX package's `ops/pallas_epoch.py` kernels:

- K2 and K3 (`csrc/case_scan.cu`): :func:`fused_case_scan` and
  :func:`fused_varying_scan`, the epoch loop over per-epoch weights;
- K5 and K6 (`csrc/ema_scan.cu`): :func:`fused_ema_scan`, the whole scan
  of `W * scales[e]` (the scaled throughput path), and
  :func:`fused_ema_epoch`, one EMA-family epoch.

All four are launch sequences of one set of phase kernels
(`csrc/scan_phases.cuh`): the bond-independent phases (row normalization,
the bisection, the quantize, clip / rank and the liquid rate) run once per
tile of epochs, and only the bond recurrence epoch by epoch.
:func:`fused_case_scan` takes the largest tile up to 16, its last tile
taking what is left; :func:`fused_varying_scan` and :func:`fused_ema_scan`
the largest that divides E; each a smaller one only when that tile's
scratch does not fit on the card (:func:`case_scan_epoch_tile`,
:func:`varying_scan_epoch_tile`); :func:`fused_ema_epoch` is one epoch.
Each takes the JAX function's inputs and returns its outputs. `mxu=True`
runs the bisection's support sum on the tensor cores (K4,
`csrc/common.cuh`), bitwise the same.
On CUDA tensors they launch the kernels; on CPU tensors they run the plain
PyTorch versions below, which are written from the Pallas kernels' own
phases (`_consensus_phase`, `_clip_rank_rate`, `_bond_phase`,
`_liquid_rate_on_grid`) rather than from `yuma_epoch`.

The row and stake sums, which feed the consensus, add strictly left to
right (:func:`..ops.normalize.sequential_sum`) in the kernels and in the
plain versions alike, so both compute bitwise the same normalized weights
and fixed-point stakes, and so bitwise the same consensus. That is also the
order XLA's CPU backend gives the Pallas kernels' short row sums.

Yuma 0's float64 quantization divide (`x64=True`) runs in native float64;
the Pallas kernels emulate it in double-single float32 because Pallas on
the TPU is float32-only.
"""

from __future__ import annotations

import ctypes
import functools
import math
import numbers
from typing import Optional

import torch

from yuma_simulation_tpu_torch.models.epoch import (
    EMA_MODES,
    MAXINT,
    BondsMode,
    dividends,
    ema_column_sum,
)
from yuma_simulation_tpu_torch.models.variants import ResetMode
from yuma_simulation_tpu_torch.ops import _build
from yuma_simulation_tpu_torch.ops.consensus import (
    U16_INV,
    bisection_iterations,
    dyadic_grid_denom,
    dyadic_grid_fits_int32,
    check_mxu_support_covers,
    stake_weighted_median,
)
from yuma_simulation_tpu_torch.ops.cuda_consensus import MMA_LAUNCHES, check_cuda_float32
from yuma_simulation_tpu_torch.ops.fma import fma, fma64
from yuma_simulation_tpu_torch.ops.launches import COUNTERS
from yuma_simulation_tpu_torch.ops.normalize import (
    EMA_FOLD_VALIDATORS,
    FOLD_VALIDATORS,
    ema_blend,
    miner_sum,
    rank_sum,
    sequential_sum,
    validator_dot,
)

CASE_SCAN_LAUNCHES = COUNTERS["case_scan"]
VARYING_SCAN_LAUNCHES = COUNTERS["varying_scan"]
EMA_SCAN_LAUNCHES = COUNTERS["ema_scan"]
EMA_EPOCH_LAUNCHES = COUNTERS["ema_epoch"]

#: Every bond model the scans implement (pallas_epoch.py::_SCAN_MODES).
SCAN_MODES = EMA_MODES + (BondsMode.CAPACITY, BondsMode.RELATIVE)

#: Epoch-tile ceiling of :func:`fused_varying_scan` (pallas_epoch.py:1848).
VARYING_EPOCH_TILE_MAX = 16

#: Miners per block of the bond phase (`kBondTM` in csrc/scan_phases.cuh):
#: the kernel leaves one dividend partial per validator per tile.
BOND_TILE = 32
#: Bond-phase tiles whose dividend partials are summed together first
#: (`kDnormGroup`): one sum and one ticket per group.
DIVIDEND_GROUP = 16

_MODE_CODE = {
    BondsMode.EMA_RUST: 0,
    BondsMode.EMA: 1,
    BondsMode.EMA_PREV: 2,
    BondsMode.CAPACITY: 3,
    BondsMode.RELATIVE: 4,
}
_RESET_CODE = {ResetMode.NONE: 0, ResetMode.ALWAYS: 1, ResetMode.CONDITIONAL: 2}
_QUANTILES = (0.75, 0.25, 0.99)


# ---------------------------------------------------------------------------
# the plain PyTorch versions of the kernel phases


def _row_normalize(W):
    """W / (left-to-right row sum + 1e-6): the kernels' phase 3."""
    return W / (sequential_sum(W, -1, keepdim=True) + 1e-6)


def _consensus_phase(W, S_n, kappa, *, precision: int, rust64: bool, mxu: bool, m_real: int):
    """Row-normalize -> bisection consensus (K1's plain version, or K4's
    with `mxu`: the kernels share their bodies for this phase) -> u16
    quantize, over any leading dims (pallas_epoch.py:437). `W [..., V, M]`,
    `S_n [..., V, 1]`, `kappa` broadcast against the leading dims; miners
    from `m_real` on are left out of the quantize sum. Returns
    `(W_n, C [..., 1, M])`."""
    M = W.shape[-1]
    iters = bisection_iterations(precision)
    W_n = _row_normalize(W)
    c_hi = stake_weighted_median(
        W_n, S_n[..., 0], kappa, precision, mxu=mxu
    ).unsqueeze(-2)
    if m_real != M:
        real = torch.arange(M, device=W.device) < m_real
        c_hi = torch.where(real, c_hi, torch.zeros_like(c_hi))
    if rust64:
        c64 = c_hi.double()
        scaled = c64 / c64.sum(dim=-1, keepdim=True) * 65535.0
    else:
        if dyadic_grid_fits_int32(m_real, iters):
            denom = dyadic_grid_denom(c_hi, iters)
        else:
            denom = sequential_sum(c_hi, -1, keepdim=True)
        scaled = c_hi / denom * 65535.0
    C = scaled.to(torch.int32).to(W.dtype) * U16_INV
    return W_n, C


def _liquid_spec(n: int, override_high, override_low):
    """The static rank selection of the liquid-alpha quantiles
    (pallas_epoch.py:336-359): `(ks, pos, both_static, static_degenerate)`,
    `ks` the order statistics to select and `pos[q] = (lo, hi, frac)`."""
    both_static = override_high is not None and override_low is not None
    static_degenerate = both_static and override_high == override_low
    quantiles = []
    if override_high is None:
        quantiles.append(0.75)
    if override_low is None:
        quantiles.append(0.25)
    if not both_static or static_degenerate:
        quantiles.append(0.99)
    pos: dict = {}
    ks: list = []
    for q in quantiles:
        p = q * (n - 1)
        lo_i, hi_i = int(math.floor(p)), int(math.ceil(p))
        pos[q] = (lo_i, hi_i, p - lo_i)
        for k in (lo_i, hi_i):
            if k not in ks:
                ks.append(k)
    return ks, pos, both_static, static_degenerate


def _liquid_rate_on_grid(
    C,
    logit_low,
    logit_num,
    alpha_low,
    alpha_high,
    *,
    n: int,
    override_high=None,
    override_low=None,
):
    """Per-miner liquid-alpha EMA rate from the quantized consensus
    `[..., 1, M]` without a sort (pallas_epoch.py:257): every C lies on the
    u16 grid, so each quantile's order statistics come from a 16-halving
    integer counting bisection, all ranks jointly; the degenerate spread is
    tested on the integer order statistics."""
    dtype = C.dtype
    C_int = torch.round(C * 65535.0).to(torch.int32)
    ks, pos, both_static, static_degenerate = _liquid_spec(
        n, override_high, override_low
    )
    if ks:
        thresh = torch.tensor([k + 1 for k in ks], device=C.device).reshape(-1, 1)
        shape = C.shape[:-2] + (len(ks), 1)
        lo = torch.zeros(shape, dtype=torch.int64, device=C.device)
        hi = torch.full(shape, 65535, dtype=torch.int64, device=C.device)
        for _ in range(16):
            mid = torch.div(lo + hi, 2, rounding_mode="floor")
            cnt = (C_int <= mid).sum(dim=-1, keepdim=True)
            ok = cnt >= thresh
            lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
        sel = hi
        stats = sel.to(dtype) * U16_INV

    def stat_i(k):
        i = ks.index(k)
        return sel[..., i : i + 1, :]

    def stat(k):
        i = ks.index(k)
        return stats[..., i : i + 1, :]

    def quant(q):
        # In float64 with one FMA, as ops/liquid.py::_quantile.
        lo_i, hi_i, frac = pos[q]
        v_lo = stat(lo_i)
        if hi_i == lo_i:
            return v_lo
        return fma64(v_lo.double(), 1.0 - frac, stat(hi_i).double() * frac).to(dtype)

    def const(x):
        return torch.tensor(x, dtype=dtype, device=C.device)

    if both_static:
        c_low = const(override_low)
        c_high = quant(0.99) if static_degenerate else const(override_high)
    else:
        c_high0 = quant(0.75) if override_high is None else const(override_high)
        c_low = quant(0.25) if override_low is None else const(override_low)
        if override_high is None and override_low is None:
            degenerate = stat_i(pos[0.75][1]) == stat_i(pos[0.25][0])
        else:
            degenerate = c_high0 == c_low
        c_high = torch.where(degenerate, quant(0.99), c_high0)
    a = logit_num / (c_low - c_high)
    b = fma(a, c_low, logit_low)
    # The exponent `-a * C + b` on the grid integers, as ops/liquid.py.
    sig = const(1.0) / (1.0 + torch.pow(const(math.e), fma(C_int.to(dtype), -a * U16_INV, b)))
    return (1.0 - torch.minimum(torch.maximum(sig, alpha_low), alpha_high)).to(dtype)


def _clip_rank_rate(S, C, clip_base, alpha, *, mode, liquid, liquid_scal, overrides):
    """Consensus clip, rank / incentive and the per-miner EMA rate
    (pallas_epoch.py:531). Returns `(W_clipped, incentive [..., 1, M],
    rate)`; `rate` is `alpha` when liquid alpha is off."""
    W_clipped = torch.minimum(clip_base, C)
    R = rank_sum(S, W_clipped, lanes=W_clipped.shape[1])
    incentive = torch.nan_to_num(R / miner_sum(R, keepdim=True))
    rate = alpha
    if liquid and mode is not BondsMode.CAPACITY:
        def rate_of(C, *scal):
            return _liquid_rate_on_grid(C, *scal, n=C.shape[-1], override_high=overrides[0],
                                        override_low=overrides[1])

        if C.device.type == "cpu":
            # Scenario by scenario, each from a contiguous copy: PyTorch's
            # CPU `pow` rounds an element by where it falls in its vector
            # loop, so only the same layout gives a lane its run alone's bits.
            rate = torch.cat([
                rate_of(C[:, i : i + 1].contiguous(), *(x[i : i + 1] for x in liquid_scal))
                for i in range(C.shape[1])
            ], dim=1)
        else:
            rate = rate_of(C, *liquid_scal)
    return W_clipped, incentive, rate


def _bond_phase(
    S, B_old, W_n, clip_base, W_clipped, incentive, rate, first, beta, *,
    mode, cap_alpha, decay,
):
    """The bond recurrence and normalized dividends of one epoch
    (pallas_epoch.py:568). Returns `(B_next, D_n [..., V, 1])`. Products
    and sums round as on the JAX package's XLA rung, with the same helpers
    as :func:`..models.epoch.yuma_epoch` (its multiply-adds fused)."""
    if mode in EMA_MODES:
        if mode is BondsMode.EMA_RUST:
            B_t = S * W_clipped
            B_t = torch.nan_to_num(B_t / (validator_dot(S, W_clipped) + 1e-6))
        else:
            bond_base = W_n if mode is BondsMode.EMA else clip_base
            W_b = fma(1.0 - beta, bond_base, beta * W_clipped)
            B_t = torch.nan_to_num(S * W_b / validator_dot(S, W_b))
        # First-epoch adoption is a select, never a blend.
        B_next = B_t if first else ema_blend(rate, B_old, B_t)
        if mode is BondsMode.EMA_RUST:
            colsum = ema_column_sum(B_next, B_t, None if first else B_old, rate)
            B_next = torch.nan_to_num(B_next / (colsum + 1e-6))
    elif mode is BondsMode.CAPACITY:
        # The 2^64-1 constant enters float32 arithmetic deliberately.
        cap_vec = S * torch.tensor(MAXINT, dtype=S.dtype, device=S.device)
        remaining = torch.clamp(cap_vec - B_old, min=0.0)
        purchase = torch.minimum(cap_alpha * cap_vec, remaining) * W_n
        B_next = torch.minimum(fma(1.0 - decay, B_old, purchase), cap_vec)
    else:  # RELATIVE
        B_dec = B_old * (1.0 - rate)
        remaining = torch.clamp(1.0 - B_dec, min=0.0)
        purchase = torch.minimum(rate * W_n, remaining)
        B_next = torch.clamp(B_dec + purchase, max=1.0)
    S_rel = S[..., 0] if mode is BondsMode.RELATIVE else None
    fold = EMA_FOLD_VALIDATORS if mode in EMA_MODES else FOLD_VALIDATORS
    D, D_tot = dividends(B_next, incentive[..., 0, :], S_rel, msum=lambda x: x.sum(dim=-1),
                         fold=fold)
    return B_next, (D / (D_tot + 1e-6)).unsqueeze(-1)


def _scan_plain(W, S, hp, reset_index, reset_epoch, state, *, T, p):
    """The plain version of every scan kernel, in the kernels' phase
    order: phases 2-6 batched over each tile of up to T epochs (the last
    tile takes what is left), then the bond recurrence epoch by epoch.
    `W [B, EW, V, M]` and `S [B, ES, V]` store E epochs each, or one shared
    by all (EW / ES = 1); `p["scales"]` multiplies epoch e's weights before
    the row sum. `state = (bonds, cprev, wprev)`: cprev may be None where no
    CONDITIONAL reset reads it."""
    Bn, _, V, M = W.shape
    E, mode, scales = p["E"], p["mode"], p["scales"]

    def sc(i):
        return hp[:, i].reshape(Bn, 1, 1)

    def weights(lo, n):  # [n, B, V, M]: epochs lo .. lo + n - 1
        Wt = W.expand(Bn, E, V, M)[:, lo : lo + n].transpose(0, 1)
        if scales is not None:
            Wt = Wt * scales[lo : lo + n].reshape(n, 1, 1, 1)
        return Wt

    bonds, cprev, wprev = state  # [B, V, M], [B, 1, M], [B, V, M] or None
    colm = torch.arange(M, device=W.device).reshape(1, M)
    ri = reset_index.reshape(Bn, 1, 1).long()
    r_epoch = reset_epoch.reshape(Bn, 1, 1).long()
    liquid_scal = (sc(5), sc(6), sc(7), sc(8))
    per_epoch_rate = p["liquid"] and mode is not BondsMode.CAPACITY
    prev_mode = p["clip_src"] if mode is BondsMode.EMA_PREV else "own"
    dacc = torch.zeros((Bn, V), dtype=W.dtype, device=W.device) if p["accumulate"] else None
    dn, bond_rows, inc_rows, cons_rows = [], [], [], []
    for e0 in range(0, E, T):
        n = min(T, E - e0)
        if prev_mode == "scan" and p["recompute_prev"] and e0 > 0:
            # The recompute spelling: the previous epoch's W_n re-derived
            # from its weights, the same ops as its own phase 3.
            wprev = _row_normalize(weights(e0 - 1, 1)[0])
        St = S.expand(Bn, E, V)[:, e0 : e0 + n].transpose(0, 1).unsqueeze(-1)
        S_n = St if p["s_normalized"] else St / sequential_sum(St, -2, keepdim=True)
        W_n, C = _consensus_phase(
            weights(e0, n), S_n, hp[:, 0], precision=p["precision"],
            rust64=p["rust64"], mxu=p["mxu"], m_real=p["m_real"],
        )
        if prev_mode == "scan":
            tt = torch.arange(n, device=W.device).reshape(n, 1, 1, 1)
            first_b = (e0 + tt + p["epoch_offset"]) == 0
            clip_prev = torch.cat([wprev.unsqueeze(0), W_n[:-1]], dim=0)
            clip_base = torch.where(first_b, W_n, clip_prev)
        elif prev_mode == "given":
            clip_base = wprev.unsqueeze(0).expand_as(W_n)
        else:
            clip_base = W_n
        W_clipped, incentive, rate = _clip_rank_rate(
            S_n, C, clip_base, sc(2), mode=mode, liquid=p["liquid"],
            liquid_scal=liquid_scal, overrides=p["overrides"],
        )
        for t in range(n):
            eg = e0 + t + p["epoch_offset"]
            if p["reset_mode"] is not ResetMode.NONE:
                do = (r_epoch == eg) & (eg > 0) & (ri >= 0)
                if p["reset_mode"] is ResetMode.CONDITIONAL:
                    c_before = cprev if t == 0 else C[t - 1]
                    idx = ri.clamp(0, M - 1)
                    prev_c = torch.gather(c_before, -1, idx)
                    do = do & (prev_c == 0.0)
                bonds = torch.where((colm == ri) & do, torch.zeros_like(bonds), bonds)
            bonds, D_n = _bond_phase(
                S_n[t], bonds, W_n[t], clip_base[t], W_clipped[t], incentive[t],
                rate[t] if per_epoch_rate else rate, eg == 0, sc(1),
                mode=mode, cap_alpha=sc(3), decay=sc(4),
            )
            if dacc is not None:
                dacc = dacc + D_n[..., 0]
            else:
                dn.append(D_n[..., 0])
            if p["save_bonds"]:
                bond_rows.append(bonds)
            inc_rows.append(incentive[t, :, 0])
            cons_rows.append(C[t, :, 0])
        cprev = C[n - 1]
        if prev_mode == "scan" and not p["recompute_prev"]:
            wprev = W_n[n - 1]
    out = {"final_bonds": bonds}
    if dacc is not None:
        out["dividends_total"] = dacc
    else:
        out["dividends_normalized"] = torch.stack(dn, dim=1)
    if p["save_bonds"]:
        out["bonds"] = torch.stack(bond_rows, dim=1)
    if p["save_incentives"]:
        out["incentives"] = torch.stack(inc_rows, dim=1)
    if p["save_consensus"]:
        out["consensus"] = torch.stack(cons_rows, dim=1)
    out["final_consensus"] = cprev[:, 0]
    out["final_w_prev"] = wprev
    return out


# ---------------------------------------------------------------------------
# the CUDA kernels


class _LiquidSpec(ctypes.Structure):
    _fields_ = [
        ("K", ctypes.c_int),
        ("thresh", ctypes.c_int * 6),
        ("q_lo", ctypes.c_int * 3),
        ("q_hi", ctypes.c_int * 3),
        ("q_wlo", ctypes.c_double * 3),
        ("q_whi", ctypes.c_double * 3),
        ("regime", ctypes.c_int),
        ("has_high", ctypes.c_int),
        ("has_low", ctypes.c_int),
        ("ov_high", ctypes.c_float),
        ("ov_low", ctypes.c_float),
    ]


class _ScanArgs(ctypes.Structure):
    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "W", "S", "hp", "reset_index", "reset_epoch", "bonds", "bonds_in",
            "cprev", "wprev", "dn", "bonds_out", "inc_out", "cons_out", "wn", "sn",
            "sint", "chi", "C", "inc", "rate", "dsum", "dpart", "dgroup", "rden",
            "pden", "ticket", "dtot", "scales", "dacc", "stream",
        )
    ] + [
        (name, ctypes.c_int)
        for name in (
            "B", "E", "V", "M", "T", "mode", "reset_mode", "iters", "rust64",
            "liquid", "epoch_offset", "w_epochs", "s_epochs", "s_normalized",
            "m_real", "clip_src", "recompute_prev", "mxu", "reset_index0",
            "reset_epoch0",
        )
    ] + [("hpv", ctypes.c_float * 9), ("liq", _LiquidSpec)]

_CLIP_CODE = {"scan": 0, "given": 1, "own": 2}
#: kernel name -> (source, C entry point, launch counter)
_ENTRIES = {
    "case_scan": ("case_scan.cu", "yuma_case_scan", CASE_SCAN_LAUNCHES),
    "varying_scan": ("case_scan.cu", "yuma_varying_scan", VARYING_SCAN_LAUNCHES),
    "ema_scan": ("ema_scan.cu", "yuma_ema_scan", EMA_SCAN_LAUNCHES),
    "ema_epoch": ("ema_scan.cu", "yuma_ema_epoch", EMA_EPOCH_LAUNCHES),
}
#: (source, entry) -> (library, its entry with argtypes set)
_ENTRY_FNS: dict = {}


@functools.lru_cache(maxsize=64)
def _liquid_struct(n: int, override_high, override_low) -> _LiquidSpec:
    ks, pos, both_static, static_degenerate = _liquid_spec(
        n, override_high, override_low
    )
    spec = _LiquidSpec()
    spec.K = len(ks)
    for i, k in enumerate(ks):
        spec.thresh[i] = k + 1
    for i, q in enumerate(_QUANTILES):
        if q in pos:
            lo_i, hi_i, frac = pos[q]
            spec.q_lo[i], spec.q_hi[i] = ks.index(lo_i), ks.index(hi_i)
            spec.q_wlo[i], spec.q_whi[i] = 1.0 - frac, frac
        else:
            spec.q_lo[i] = spec.q_hi[i] = -1
    if both_static:
        spec.regime = 3 if static_degenerate else 2
    else:
        spec.regime = 0 if override_high is None and override_low is None else 1
    spec.has_high = override_high is not None
    spec.has_low = override_low is not None
    spec.ov_high = 0.0 if override_high is None else override_high
    spec.ov_low = 0.0 if override_low is None else override_low
    return spec


def _entry(kernel: str):
    """The C entry of `kernel` in its loaded library, with its argtypes."""
    source, entry, _ = _ENTRIES[kernel]
    lib = _build.load(source)
    cached = _ENTRY_FNS.get((source, entry))
    if cached is None or cached[0] is not lib:
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.POINTER(_ScanArgs)]
        fn.restype = ctypes.c_int
        cached = _ENTRY_FNS[source, entry] = (lib, fn)
    return cached[1]


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _to_device(x: torch.Tensor, dev) -> torch.Tensor:
    """`x` on `dev` without waiting for the card: a CPU tensor goes through
    pinned memory with a non-blocking copy (a pageable one would
    synchronize the stream)."""
    if x.device.type != "cpu" or dev.type != "cuda":
        return x.to(dev).contiguous()
    return x.contiguous().pin_memory().to(dev, non_blocking=True)


#: Byte alignment of each region of the scans' one scratch allocation.
_ALIGN = 256


@functools.lru_cache(maxsize=64)
def _scratch_layout(T: int, Bn: int, V: int, M: int) -> tuple:
    """`(bytes, ((name, offset), ...))`: the scratch of a scan over tiles
    of T epochs, one allocation carved into `_ALIGN`-aligned regions
    (`ScanArgs` in csrc/scan_phases.cuh says what each holds)."""
    f4, tiles = 4, -(-M // BOND_TILE)
    groups = -(-tiles // DIVIDEND_GROUP)
    regions = (
        ("wn", f4 * T * Bn * V * M), ("sn", f4 * T * Bn * V), ("sint", f4 * T * Bn * V),
        ("chi", f4 * T * Bn * M), ("C", f4 * T * Bn * M), ("inc", f4 * T * Bn * M),
        ("rate", f4 * T * Bn * M), ("dsum", f4 * Bn * V), ("dpart", f4 * 2 * Bn * tiles * V),
        ("dgroup", f4 * Bn * groups * V), ("rden", f4 * T * Bn * V), ("pden", f4 * Bn * V),
        ("ticket", f4 * Bn * (groups + 1)), ("dtot", f4 * 2 * Bn),
    )
    offsets, total = [], 0
    for name, nbytes in regions:
        offsets.append((name, total))
        total += -(-nbytes // _ALIGN) * _ALIGN
    return total, tuple(offsets)


def _scan_cuda(W, S, hp, reset_index, reset_epoch, state, *, T, p, kernel: str):
    """Launch one of K2, K3, K5, K6 (`kernel`, a key of `_ENTRIES`) on
    contiguous CUDA tensors: `W [B, EW, V, M]`, `S [B, ES, V]`. `hp` is one
    row of hyperparameters shared by every scenario (a tuple, passed by
    value) or a CPU table `[B, 9]`; the reset index and epoch are ints
    (by value) or `[B]` tensors; `p["scales"]` a float32 CUDA tensor `[E]`
    or None. `state = (bonds, cprev, wprev)`: the
    bonds before the first epoch (read, never written: the kernel writes
    a new buffer), the previous consensus `[B, 1, M]` (in/out) or None,
    EMA_PREV's previous W_n. Nothing here waits for the card."""
    Bn, EW, V, M = W.shape
    E = p["E"]
    check_cuda_float32("W", W)
    check_cuda_float32("S", S, (Bn, S.shape[1], V))
    dev = W.device
    bonds_in, cprev, wprev = state
    check_cuda_float32("bonds", bonds_in, (Bn, V, M))

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {
        "dividends_normalized": None if p["accumulate"] else empty(Bn, E, V),
        "dividends_total": (
            torch.zeros((Bn, V), dtype=torch.float32, device=dev)
            if p["accumulate"] else None
        ),
        "bonds": empty(Bn, E, V, M) if p["save_bonds"] else None,
        "incentives": empty(Bn, E, M) if p["save_incentives"] else None,
        "consensus": empty(Bn, E, M) if p["save_consensus"] else None,
    }
    bonds = empty(Bn, V, M)
    # One allocation for all the scratch; the caching allocator hands it
    # out again only in stream order, after the kernels that read it.
    nbytes, offsets = _scratch_layout(T, Bn, V, M)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    ptrs = {name: base + off for name, off in offsets}
    args = _ScanArgs(
        W=W.data_ptr(), S=S.data_ptr(), bonds=bonds.data_ptr(),
        bonds_in=bonds_in.data_ptr(), cprev=_ptr(cprev), wprev=_ptr(wprev),
        dn=_ptr(out["dividends_normalized"]), bonds_out=_ptr(out["bonds"]),
        inc_out=_ptr(out["incentives"]), cons_out=_ptr(out["consensus"]),
        dacc=_ptr(out["dividends_total"]), **ptrs,
        stream=torch.cuda.current_stream(dev).cuda_stream,
        B=Bn, E=E, V=V, M=M, T=T, mode=_MODE_CODE[p["mode"]],
        reset_mode=_RESET_CODE[p["reset_mode"]],
        iters=bisection_iterations(p["precision"]),
        rust64=int(p["rust64"]), liquid=int(p["liquid"]),
        epoch_offset=p["epoch_offset"], w_epochs=EW, s_epochs=S.shape[1],
        s_normalized=int(p["s_normalized"]), m_real=p["m_real"],
        clip_src=_CLIP_CODE[p["clip_src"]], recompute_prev=int(p["recompute_prev"]),
        mxu=int(p["mxu"]), liq=_liquid_struct(M, *p["overrides"]),
    )
    keep = []  # tensors the launch reads, alive until it is queued
    if isinstance(hp, tuple):
        args.hpv[:] = hp
    else:
        keep.append(_to_device(hp, dev))
        args.hp = keep[-1].data_ptr()
    for name, x in (("reset_index", reset_index), ("reset_epoch", reset_epoch)):
        if isinstance(x, int):
            setattr(args, name + "0", x)
        else:
            keep.append(_to_device(x.to(torch.int32).reshape(Bn), dev))
            setattr(args, name, keep[-1].data_ptr())
    if p["scales"] is not None:
        check_cuda_float32("scales", p["scales"], (E,))
        args.scales = p["scales"].data_ptr()
    err = _entry(kernel)(ctypes.byref(args))
    if err:
        raise RuntimeError(f"{kernel} kernel failed: CUDA error {err}")
    _ENTRIES[kernel][2].add()
    if p["mxu"]:
        MMA_LAUNCHES.add(-(-E // T))  # run_scan launches k_bisect_mma once per tile
    out = {k: v for k, v in out.items() if v is not None}
    out["final_bonds"] = bonds
    if cprev is not None:
        out["final_consensus"] = cprev[:, 0]
    out["final_w_prev"] = wprev
    return out


# ---------------------------------------------------------------------------
# the public wrappers

_HP_KEYS = ("kappa", "bond_penalty", "bond_alpha", "capacity_alpha", "decay_rate",
            "liquid_alpha", "alpha_low", "alpha_high")


@functools.lru_cache(maxsize=256)
def _hp_row(kappa, bond_penalty, bond_alpha, capacity_alpha, decay_rate,
            liquid_alpha, alpha_low, alpha_high) -> tuple:
    """One scenario's hyperparameter row of 9 values (column order of
    pallas_epoch.py:1667-1677), computed on the host in float32 so the
    kernel and the plain version read identical values."""

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).cpu()

    if liquid_alpha:
        one = torch.tensor(1.0)
        al, ah = f32(alpha_low), f32(alpha_high)
        logit_low = torch.log(one / al - 1.0)
        logit_num = torch.log(one / ah - 1.0) - logit_low
    else:
        al = ah = logit_low = logit_num = torch.zeros(())
    vals = [kappa, bond_penalty, bond_alpha, capacity_alpha, decay_rate,
            logit_low, logit_num, al, ah]
    return tuple(float(f32(v)) for v in vals)


def _hyperparams(Bn: int, **hp):
    """The hyperparameters as the kernels take them: one row shared by
    every scenario (a tuple of 9 float32 values) when each is a Python
    number, else the CPU float32 table `[B, 9]` of per-scenario values
    (`[B]` or 0-d tensors or arrays). Each row of the table is computed
    as a shared row is, so a scenario reads the bits its run alone with
    scalar hyperparameters reads."""
    vals = tuple(hp[k] for k in _HP_KEYS)
    if all(type(v) in (float, int, bool) for v in vals):  # the common case, cached
        return _hp_row(*vals)
    if all(isinstance(v, numbers.Real) for v in vals):
        return _hp_row(*(float(v) for v in vals))
    cols = [
        v if isinstance(v, bool)
        else torch.as_tensor(v, dtype=torch.float32).cpu().broadcast_to((Bn,))
        for v in vals
    ]
    rows = [
        _hp_row(*(v if isinstance(v, bool) else float(v[i]) for v in cols))
        for i in range(Bn)
    ]
    return torch.tensor(rows, dtype=torch.float32)


def _reset_arg(x, Bn: int):
    """A reset index or epoch: an int shared by every scenario, or a `[B]`
    int32 tensor."""
    if isinstance(x, numbers.Integral):
        return int(x)
    return torch.as_tensor(x, dtype=torch.int32).broadcast_to((Bn,))


def _plain_inputs(hp, ri, re_, Bn, dev):
    """`_scan_plain`'s tensors on `dev` from the kernels' arguments."""
    hp = torch.tensor(hp, dtype=torch.float32).expand(Bn, 9) if isinstance(hp, tuple) else hp

    def vec(x):
        return torch.as_tensor(x, dtype=torch.int32).broadcast_to((Bn,)).to(dev)

    return hp.to(dev), vec(ri), vec(re_)


def _largest_tile(E: int, per_epoch: int, free: Optional[int], divides: bool) -> int:
    """Largest epoch tile (<= :data:`VARYING_EPOCH_TILE_MAX`, dividing E if
    `divides`) whose scratch of `per_epoch` bytes an epoch fits half of
    `free` bytes (None: no bound). 0 when not even one epoch fits."""
    for et in range(min(VARYING_EPOCH_TILE_MAX, max(1, E)), 0, -1):
        if (not divides or E % et == 0) and (free is None or et * per_epoch <= free // 2):
            return et
    return 0


def _tile_bound(shape, device):
    """(E, scratch bytes per epoch, free device bytes or None: no bound,
    on the CPU)."""
    E, V, M = shape[-3:]
    Bn = shape[0] if len(shape) == 4 else 1
    per_epoch = 4 * Bn * (V * M + 3 * V + 4 * M)
    free = None
    if device is not None and torch.device(device).type == "cuda":
        free = torch.cuda.mem_get_info(torch.device(device))[0]
    return E, per_epoch, free


def varying_scan_epoch_tile(shape, device=None) -> int:
    """Largest epoch tile (<= :data:`VARYING_EPOCH_TILE_MAX`) that divides
    the epoch count of `shape` (`[E, V, M]` or `[B, E, V, M]`) and whose
    tile scratch fits half the free device memory (no check on the CPU).
    Returns 0 when not even a one-epoch tile fits."""
    E, per_epoch, free = _tile_bound(shape, device)
    return _largest_tile(E, per_epoch, free, divides=True)


def case_scan_epoch_tile(shape, device=None) -> int:
    """The case scan's epoch tile: the largest up to
    :data:`VARYING_EPOCH_TILE_MAX` whose scratch fits half the free device
    memory, whether or not it divides E (the last tile takes what is
    left); 0 when not even one epoch fits."""
    E, per_epoch, free = _tile_bound(shape, device)
    return _largest_tile(E, per_epoch, free, divides=False)


def _epoch_tile(epoch_tile, shape, device, label: str, divides: bool = True) -> int:
    """`epoch_tile`, checked (to divide E when `divides`), or the largest
    that fits when None."""
    E = shape[-3]
    if epoch_tile is None:
        E, per_epoch, free = _tile_bound(shape, device)
        T = _largest_tile(E, per_epoch, free, divides)
        if T < 1:
            raise ValueError(f"{list(shape)} too large for the {label} at any tile")
        return T
    T = int(epoch_tile)
    if T < 1 or (divides and E % T):
        raise ValueError(f"epoch_tile={T} must be >= 1 and divide the epoch count (E={E})")
    return T


def _params(*, mode, precision, rust64, E, m_real, mxu, **overrides) -> dict:
    """The scan parameters the kernels and the plain version read, with
    the defaults of K2 / K3 (per-epoch raw inputs, no scale, per-epoch
    dividends)."""
    p = dict(
        mode=mode, reset_mode=ResetMode.NONE, precision=int(precision),
        rust64=rust64, liquid=False, overrides=(None, None), epoch_offset=0,
        save_bonds=False, save_incentives=False, save_consensus=False, E=E,
        scales=None, s_normalized=False, m_real=m_real, clip_src="scan",
        recompute_prev=False, mxu=bool(mxu), accumulate=False,
    )
    p.update(overrides)
    return p


def _run(kernel: str, plain: bool, W4, S3, hp, ri, re_, state, *, T, p) -> dict:
    """The kernel on CUDA tensors (unless `plain`), else its plain version.
    `hp` from :func:`_hyperparams`, `ri` / `re_` from :func:`_reset_arg`."""
    if W4.device.type == "cuda" and not plain:
        return _scan_cuda(W4, S3, hp, ri, re_, state, T=T, p=p, kernel=kernel)
    hp, ri, re_ = _plain_inputs(hp, ri, re_, W4.shape[0], W4.device)
    return _scan_plain(W4, S3, hp, ri, re_, state, T=T, p=p)


def _run_tiled(kernel, plain, W4, S3, hp, ri, re_, state, *, T, auto, divides, label, p):
    """:func:`_run` at tile T. An `auto` tile (the largest up to
    :data:`VARYING_EPOCH_TILE_MAX`, dividing E if `divides`) is taken
    without asking the card for its free memory, a query that costs about
    a millisecond of host time a call (PERF.md §6). Only if the kernel's
    scratch at that tile does not fit does the scan ask, and run at the
    largest tile whose scratch fits half the free memory."""
    try:
        return _run(kernel, plain, W4, S3, hp, ri, re_, state, T=T, p=p)
    except torch.cuda.OutOfMemoryError:
        # _scan_cuda allocates everything before its launch: nothing ran.
        if not auto or plain or W4.device.type != "cuda":
            raise
    T = _epoch_tile(None, W4.shape, W4.device, label, divides)
    return _run(kernel, plain, W4, S3, hp, ri, re_, state, T=T, p=p)


def _check_mxu(mxu: bool, V: int) -> None:
    if mxu:
        check_mxu_support_covers(V)


def _scan(
    W, S, *, varying, plain, epoch_tile, reset_index, reset_epoch, reset_mode, kappa,
    bond_penalty, bond_alpha, capacity_alpha, decay_rate, liquid_alpha,
    alpha_low, alpha_high, override_consensus_high, override_consensus_low,
    mode, precision, save_bonds, save_incentives, save_consensus, carry,
    epoch_offset, return_carry, x64, mxu,
):
    reset_mode = ResetMode.NONE if reset_mode is None else reset_mode
    if W.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {W.device}")
    if W.ndim == 4:
        Bn, E, V, M = W.shape
        lead: tuple = (Bn,)
    elif W.ndim == 3:
        E, V, M = W.shape
        Bn, lead = 1, ()
    else:
        raise ValueError(f"weights must be [(B,) E, V, M], got {tuple(W.shape)}")
    if E < 1:
        raise ValueError("fused scan requires at least one epoch")
    if tuple(S.shape) != lead + (E, V):
        raise ValueError(f"stakes must be {lead + (E, V)}, got {tuple(S.shape)}")
    if W.dtype != torch.float32 or S.dtype != torch.float32:
        raise ValueError("the fused scans take float32 weights and stakes")
    _check_mxu(mxu, V)
    dev = W.device
    W4 = W.reshape(Bn, E, V, M).contiguous()
    S3 = S.reshape(Bn, E, V).contiguous()
    label = "varying scan" if varying else "case scan"
    T = _epoch_tile(epoch_tile, W4.shape, None, label, divides=varying)

    need = {"bonds", "consensus"} | ({"w_prev"} if mode is BondsMode.EMA_PREV else set())
    if carry is not None:
        if set(carry) != need:
            raise ValueError(
                f"carry must have exactly keys {sorted(need)} for mode {mode}, "
                f"got {sorted(carry)}"
            )

        def carried(key, shape, copy=True):
            x = carry[key]
            if not isinstance(x, torch.Tensor) or x.device != dev:
                x = _to_device(torch.as_tensor(x, dtype=torch.float32), dev)
            x = x.to(torch.float32)
            if tuple(x.shape) != lead + shape:
                raise ValueError(f"carry {key} must be {lead + shape}, got {tuple(x.shape)}")
            x = x.reshape((Bn,) + shape)
            return x.clone(memory_format=torch.contiguous_format) if copy else x.contiguous()

        # The scans read the carried bonds and write new ones; the carried
        # consensus and weights are updated in place, so they are copied.
        bonds = carried("bonds", (V, M), copy=False)
        cprev = carried("consensus", (M,)).reshape(Bn, 1, M)
        wprev = carried("w_prev", (V, M)) if "w_prev" in need else None
    else:
        bonds = torch.zeros((Bn, V, M), dtype=torch.float32, device=dev)
        cprev = torch.zeros((Bn, 1, M), dtype=torch.float32, device=dev)
        wprev = torch.zeros_like(bonds) if mode is BondsMode.EMA_PREV else None

    hp = _hyperparams(
        Bn, kappa=kappa, bond_penalty=bond_penalty, bond_alpha=bond_alpha,
        capacity_alpha=capacity_alpha, decay_rate=decay_rate,
        liquid_alpha=liquid_alpha, alpha_low=alpha_low, alpha_high=alpha_high,
    )
    p = _params(
        mode=mode, precision=precision, rust64=mode is BondsMode.EMA_RUST and x64,
        E=E, m_real=M, mxu=mxu, reset_mode=reset_mode, liquid=bool(liquid_alpha),
        overrides=(override_consensus_high, override_consensus_low),
        epoch_offset=int(epoch_offset), save_bonds=save_bonds,
        save_incentives=save_incentives, save_consensus=save_consensus,
    )
    ri, re_ = _reset_arg(reset_index, Bn), _reset_arg(reset_epoch, Bn)
    res = _run_tiled(
        "varying_scan" if varying else "case_scan", plain, W4, S3, hp, ri, re_,
        (bonds, cprev, wprev), T=T, auto=epoch_tile is None, divides=varying,
        label=label, p=p,
    )

    def unlead(x):
        return x if lead else x[0]

    out = {"dividends_normalized": unlead(res["dividends_normalized"]),
           "final_bonds": unlead(res["final_bonds"])}
    for key in ("bonds", "incentives", "consensus"):
        if key in res:
            out[key] = unlead(res[key])
    if return_carry:
        out["final_consensus"] = unlead(res["final_consensus"])
        if mode is BondsMode.EMA_PREV:
            out["final_w_prev"] = unlead(res["final_w_prev"])
    return out


def _scan_kwargs(
    reset_index=-1, reset_epoch=-1, reset_mode=None, kappa=0.5,
    bond_penalty=1.0, bond_alpha=0.1, capacity_alpha=0.1, decay_rate=0.1,
    liquid_alpha: bool = False, alpha_low=0.7, alpha_high=0.9,
    override_consensus_high: Optional[float] = None,
    override_consensus_low: Optional[float] = None,
    mode: BondsMode = BondsMode.EMA, precision: int = 100_000,
    save_bonds: bool = True, save_incentives: bool = True,
    save_consensus: bool = False, carry: Optional[dict] = None,
    epoch_offset: int = 0, return_carry: bool = False, x64: bool = False,
    mxu: bool = False,
) -> dict:
    """The keyword arguments of the two scans, with the JAX functions'
    defaults."""
    return dict(locals())


def fused_case_scan(W: torch.Tensor, S: torch.Tensor, **kwargs) -> dict:
    """The whole epoch loop (K2). `W [(B,) E, V, M]` and `S [(B,) E, V]`
    are per-epoch raw weights and stakes. The bond-independent phases run
    over tiles of up to 16 epochs (any E: the last tile takes what is left;
    :func:`case_scan_epoch_tile` when their scratch does not fit), the bond recurrence epoch by epoch; the results
    are those of JAX's one-epoch-per-step kernel. Keyword
    arguments as JAX's `fused_case_scan` (`reset_index`, `reset_epoch`,
    `reset_mode`, the hyperparameters, `mode`, `precision`, the `save_*`
    flags, `carry`, `epoch_offset`, `return_carry`, `mxu`: the support sum
    on the tensor cores, K4, V <= 2^14), plus `x64` for Yuma 0's float64
    quantization divide. Returns `dividends_normalized
    [(B,) E, V]`, `final_bonds`, the saved per-epoch streams and, with
    `return_carry`, `final_consensus` (+ `final_w_prev` for EMA_PREV)."""
    return _scan(W, S, varying=False, plain=False, epoch_tile=None, **_scan_kwargs(**kwargs))


def fused_varying_scan(
    W: torch.Tensor, S: torch.Tensor, *, epoch_tile: Optional[int] = None, **kwargs
) -> dict:
    """:func:`fused_case_scan`'s epoch-tiled twin (K3): the same inputs,
    outputs and carry contract, with the bond-independent phases run once
    per `epoch_tile` epochs (a divisor of E; None picks the largest up to
    16, or :func:`varying_scan_epoch_tile` when its scratch does not fit). Consensus and incentives are bitwise
    the case scan's for every tile."""
    return _scan(
        W, S, varying=True, plain=False, epoch_tile=epoch_tile, **_scan_kwargs(**kwargs)
    )


def fused_case_scan_plain(W: torch.Tensor, S: torch.Tensor, **kwargs) -> dict:
    """K2's plain PyTorch version on any device (what :func:`fused_case_scan`
    runs for CPU tensors); the yardstick the kernel is held to on the card."""
    return _scan(W, S, varying=False, plain=True, epoch_tile=None, **_scan_kwargs(**kwargs))


def fused_varying_scan_plain(
    W: torch.Tensor, S: torch.Tensor, *, epoch_tile: Optional[int] = None, **kwargs
) -> dict:
    """K3's plain PyTorch version on any device."""
    return _scan(
        W, S, varying=True, plain=True, epoch_tile=epoch_tile, **_scan_kwargs(**kwargs)
    )


# ---------------------------------------------------------------------------
# K5 and K6: the scaled scan and the single fused epoch


def _rust64_bound(M: int, precision: int) -> None:
    """The JAX package's bound on Yuma 0's float64 quantize in its fused
    kernels (pallas_epoch.py:1101-1106), kept so both packages refuse the
    same inputs; the port divides in native float64 and would not need it."""
    if (M << bisection_iterations(precision)) >= 2**31:
        raise ValueError(
            "the fused kernels' float64 quantize keeps the JAX package's bound "
            f"M * 2^iters < 2^31 (M={M}, precision={precision}); use the eager "
            "epoch path"
        )


def _ema_scan(
    W, S_n, scales, *, plain, kappa=0.5, bond_penalty=1.0, bond_alpha=0.1,
    capacity_alpha=0.1, decay_rate=0.1, liquid_alpha: bool = False,
    alpha_low=0.7, alpha_high=0.9,
    override_consensus_high: Optional[float] = None,
    override_consensus_low: Optional[float] = None,
    mode: BondsMode = BondsMode.EMA, mxu: bool = False, precision: int = 100_000,
    recompute_prev: Optional[bool] = None, x64: bool = False,
):
    if mode not in SCAN_MODES:
        raise ValueError(f"fused scan does not implement bonds mode {mode}")
    if W.ndim == 3:
        Bn, V, M = W.shape
        lead: tuple = (Bn,)
    elif W.ndim == 2:
        (V, M), Bn, lead = W.shape, 1, ()
    else:
        raise ValueError(f"weights must be [(Bb,) V, M], got {tuple(W.shape)}")
    _check_mxu(mxu, V)
    dev = W.device
    scales = _to_device(torch.as_tensor(scales, dtype=torch.float32), dev).reshape(-1)
    E = scales.shape[0]
    if E < 1:
        raise ValueError("fused scan requires at least one epoch")
    rust64 = mode is BondsMode.EMA_RUST and x64
    if rust64:
        _rust64_bound(M, precision)
    if tuple(S_n.shape) != lead + (V,):
        raise ValueError(f"stakes must be {lead + (V,)}, got {tuple(S_n.shape)}")
    if W.dtype != torch.float32 or S_n.dtype != torch.float32:
        raise ValueError("the fused scans take float32 weights and stakes")
    W4 = W.reshape(Bn, 1, V, M).contiguous()
    S3 = S_n.reshape(Bn, 1, V).contiguous()
    T = _epoch_tile(None, (Bn, E, V, M), None, "scaled scan")
    hp = _hyperparams(
        Bn, kappa=kappa, bond_penalty=bond_penalty, bond_alpha=bond_alpha,
        capacity_alpha=capacity_alpha, decay_rate=decay_rate,
        liquid_alpha=liquid_alpha, alpha_low=alpha_low, alpha_high=alpha_high,
    )
    p = _params(
        mode=mode, precision=precision, rust64=rust64, E=E, m_real=M, mxu=mxu,
        liquid=bool(liquid_alpha),
        overrides=(override_consensus_high, override_consensus_low),
        scales=scales.contiguous(), s_normalized=True, accumulate=True,
        recompute_prev=bool(recompute_prev) and mode is BondsMode.EMA_PREV,
    )
    bonds = torch.zeros((Bn, V, M), dtype=torch.float32, device=dev)
    wprev = torch.zeros_like(bonds) if mode is BondsMode.EMA_PREV else None
    # No reset and no consensus carry: the scan keeps no previous consensus.
    res = _run_tiled("ema_scan", plain, W4, S3, hp, -1, -1, (bonds, None, wprev), T=T,
                     auto=True, divides=True, label="scaled scan", p=p)
    B_final, D_tot = res["final_bonds"], res["dividends_total"]
    return (B_final, D_tot) if lead else (B_final[0], D_tot[0])


def fused_ema_scan(
    W: torch.Tensor, S_n: torch.Tensor, scales: torch.Tensor, **kwargs
) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole scan of the scaled workload (K5, JAX `fused_ema_scan`):
    epoch e simulates `W * scales[e]`, for all five bond models with liquid
    alpha and its overrides. `W [(Bb,) V, M]` raw weights (a scenario batch
    shares `scales [E]`), `S_n [(Bb,) V]` NORMALIZED stakes (not
    re-normalized). Keyword arguments: the hyperparameters (scalars or
    `[Bb]` per scenario), `mode`, `mxu` (K4, V <= 2^14), `precision`,
    `recompute_prev` (EMA_PREV: re-derive the previous epoch's weights
    instead of carrying them; bitwise the same) and `x64` (Yuma 0's float64
    quantize). The epochs run in tiles of the largest divisor of E up to
    16 (:func:`varying_scan_epoch_tile` when its scratch does not fit).
    Returns
    `(B_final [(Bb,) V, M], D_n_total [(Bb,) V])`, the sum over epochs of
    the normalized dividends."""
    return _ema_scan(W, S_n, scales, plain=False, **kwargs)


def fused_ema_scan_plain(
    W: torch.Tensor, S_n: torch.Tensor, scales: torch.Tensor, **kwargs
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's plain PyTorch version on any device (what :func:`fused_ema_scan`
    runs for CPU tensors); the yardstick the kernel is held to on the card."""
    return _ema_scan(W, S_n, scales, plain=True, **kwargs)


def _ema_epoch(
    W, S_n, B_old, *, plain, w_scale=1.0, kappa=0.5, bond_penalty=1.0,
    bond_alpha=0.1, first_epoch=False, clip_base: Optional[torch.Tensor] = None,
    mode: BondsMode = BondsMode.EMA, mxu: bool = False, precision: int = 100_000,
    m_real: Optional[int] = None, x64: bool = False,
):
    if mode not in EMA_MODES:
        raise ValueError(f"fused epoch supports the EMA family only, got {mode}")
    if clip_base is not None and mode is not BondsMode.EMA_PREV:
        raise ValueError("clip_base is only meaningful for EMA_PREV")
    if W.ndim != 2:
        raise ValueError(f"weights must be [V, M], got {tuple(W.shape)}")
    V, M = W.shape
    _check_mxu(mxu, V)
    rust64 = mode is BondsMode.EMA_RUST and x64
    if rust64:
        _rust64_bound(M, precision)
    m_real = M if m_real is None else int(m_real)
    if not 0 < m_real <= M:
        raise ValueError(f"m_real must be in (0, {M}], got {m_real}")
    for name, x, shape in (("S_n", S_n, (V,)), ("B_old", B_old, (V, M))) + (
        (("clip_base", clip_base, (V, M)),) if clip_base is not None else ()
    ):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got {x.dtype} {tuple(x.shape)}")
    if W.dtype != torch.float32:
        raise ValueError("the fused epoch takes float32 weights")
    dev = W.device
    hp = _hyperparams(
        1, kappa=kappa, bond_penalty=bond_penalty, bond_alpha=bond_alpha,
        capacity_alpha=0.0, decay_rate=0.0, liquid_alpha=False, alpha_low=0.0,
        alpha_high=0.0,
    )
    # The scale as the fused rung passes it, a tensor on the card, is read
    # where it lies; any other goes there without a synchronizing copy.
    scale = torch.as_tensor(w_scale, dtype=torch.float32).reshape(1)
    if scale.device != dev:
        scale = _to_device(scale, dev)
    # The first-epoch select reads "global epoch 0"; the clip base is the
    # one given (the caller resolves EMA_PREV's first-epoch fallback, as
    # JAX's caller does), else this epoch's W_n.
    p = _params(
        mode=mode, precision=precision, rust64=rust64, E=1, m_real=m_real, mxu=mxu,
        epoch_offset=0 if bool(first_epoch) else 1, save_incentives=True,
        scales=scale, s_normalized=True,
        clip_src="given" if clip_base is not None else "own",
    )
    wprev = None if clip_base is None else clip_base.reshape(1, V, M).contiguous()
    res = _run(
        "ema_epoch", plain, W.reshape(1, 1, V, M).contiguous(),
        S_n.reshape(1, 1, V).contiguous(), hp, -1, -1,
        (B_old.reshape(1, V, M).contiguous(), None, wprev), T=1, p=p,
    )
    return res["final_bonds"][0], res["dividends_normalized"][0, 0], res["incentives"][0, 0]


def fused_ema_epoch(
    W: torch.Tensor, S_n: torch.Tensor, B_old: torch.Tensor, **kwargs
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused EMA-family epoch (K6, JAX `fused_ema_epoch`): raw weights
    `W [V, M]` scaled by `w_scale` in the kernel, NORMALIZED stakes `S_n
    [V]`, the carried bonds `B_old [V, M]`. Keyword arguments: `w_scale`,
    `kappa`, `bond_penalty`, `bond_alpha`, `first_epoch` (adopt the target
    outright), `clip_base` (EMA_PREV only: the previous epoch's normalized
    weights; None clips against this epoch's), `mode` (EMA, EMA_RUST,
    EMA_PREV), `mxu`, `precision`, `m_real` (miners from `m_real` on are
    left out of the quantize sum) and `x64`. Returns `(B_ema [V, M],
    D_n [V], incentive [M])`."""
    return _ema_epoch(W, S_n, B_old, plain=False, **kwargs)


def fused_ema_epoch_plain(
    W: torch.Tensor, S_n: torch.Tensor, B_old: torch.Tensor, **kwargs
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6's plain PyTorch version on any device."""
    return _ema_epoch(W, S_n, B_old, plain=True, **kwargs)

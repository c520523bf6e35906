"""K2 and K3: the whole epoch loop as hand-written CUDA kernels
(`csrc/case_scan.cu`), the counterparts of the JAX package's
`ops/pallas_epoch.py::fused_case_scan` and `fused_varying_scan`.

:func:`fused_case_scan` advances one epoch per step; :func:`fused_varying_scan`
runs the bond-independent phases (row normalization, the bisection, the
quantize, clip / rank and the liquid rate) once per T-epoch tile and only
the bond recurrence epoch by epoch. Both take the JAX functions' inputs and
return their output dict, with the same `carry` / `epoch_offset` /
`return_carry` contract. On CUDA tensors they launch the kernels; on CPU
tensors they run the plain PyTorch versions below, which are written from
the Pallas kernels' own phases (`_consensus_phase`, `_clip_rank_rate`,
`_bond_phase`, `_liquid_rate_on_grid`) rather than from `yuma_epoch`.

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
import math
from typing import Optional

import torch

from yuma_simulation_tpu_torch.models.epoch import EMA_MODES, MAXINT, BondsMode
from yuma_simulation_tpu_torch.models.variants import ResetMode
from yuma_simulation_tpu_torch.ops import _build
from yuma_simulation_tpu_torch.ops.consensus import (
    U16_INV,
    bisection_iterations,
    dyadic_grid_denom,
    dyadic_grid_fits_int32,
    stake_weighted_median,
)
from yuma_simulation_tpu_torch.ops.cuda_consensus import check_cuda_float32
from yuma_simulation_tpu_torch.ops.launches import COUNTERS
from yuma_simulation_tpu_torch.ops.normalize import sequential_sum

CASE_SCAN_LAUNCHES = COUNTERS["case_scan"]
VARYING_SCAN_LAUNCHES = COUNTERS["varying_scan"]

#: Epoch-tile ceiling of :func:`fused_varying_scan` (pallas_epoch.py:1848).
VARYING_EPOCH_TILE_MAX = 16

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


def _consensus_phase(W, S_n, kappa, *, precision: int, rust64: bool):
    """Row-normalize -> bisection consensus (K1's plain version: the
    kernels share K1's body for this phase) -> u16 quantize, over any
    leading dims (pallas_epoch.py:437). `W [..., V, M]`, `S_n [..., V, 1]`,
    `kappa` broadcast against the leading dims; returns
    `(W_n, C [..., 1, M])`."""
    M = W.shape[-1]
    iters = bisection_iterations(precision)
    W_n = W / (sequential_sum(W, -1, keepdim=True) + 1e-6)
    c_hi = stake_weighted_median(W_n, S_n[..., 0], kappa, precision).unsqueeze(-2)
    if rust64:
        c64 = c_hi.double()
        scaled = c64 / c64.sum(dim=-1, keepdim=True) * 65535.0
    else:
        if dyadic_grid_fits_int32(M, iters):
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
        lo_i, hi_i, frac = pos[q]
        v_lo = stat(lo_i)
        if hi_i == lo_i:
            return v_lo
        return v_lo * (1.0 - frac) + stat(hi_i) * frac

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
    b = logit_low + a * c_low
    sig = const(1.0) / (1.0 + torch.pow(const(math.e), -a * C + b))
    return (1.0 - torch.minimum(torch.maximum(sig, alpha_low), alpha_high)).to(dtype)


def _clip_rank_rate(S, C, clip_base, alpha, *, mode, liquid, liquid_scal, overrides):
    """Consensus clip, rank / incentive and the per-miner EMA rate
    (pallas_epoch.py:531). Returns `(W_clipped, incentive [..., 1, M],
    rate)`; `rate` is `alpha` when liquid alpha is off."""
    W_clipped = torch.minimum(clip_base, C)
    R = (W_clipped * S).sum(dim=-2, keepdim=True)
    incentive = torch.nan_to_num(R / R.sum(dim=-1, keepdim=True))
    rate = alpha
    if liquid and mode is not BondsMode.CAPACITY:
        rate = _liquid_rate_on_grid(
            C,
            *liquid_scal,
            n=C.shape[-1],
            override_high=overrides[0],
            override_low=overrides[1],
        )
    return W_clipped, incentive, rate


def _bond_phase(
    S, B_old, W_n, clip_base, W_clipped, incentive, rate, first, beta, *,
    mode, cap_alpha, decay,
):
    """The bond recurrence and normalized dividends of one epoch
    (pallas_epoch.py:568). Returns `(B_next, D_n [..., V, 1])`."""
    if mode in EMA_MODES:
        if mode is BondsMode.EMA_RUST:
            B_t = S * W_clipped
            B_t = torch.nan_to_num(B_t / (B_t.sum(dim=-2, keepdim=True) + 1e-6))
        else:
            bond_base = W_n if mode is BondsMode.EMA else clip_base
            W_b = (1.0 - beta) * bond_base + beta * W_clipped
            B_t = S * W_b
            B_t = torch.nan_to_num(B_t / B_t.sum(dim=-2, keepdim=True))
        # First-epoch adoption is a select, never a blend.
        B_next = B_t if first else rate * B_t + (1.0 - rate) * B_old
        if mode is BondsMode.EMA_RUST:
            B_next = torch.nan_to_num(
                B_next / (B_next.sum(dim=-2, keepdim=True) + 1e-6)
            )
        D = (B_next * incentive).sum(dim=-1, keepdim=True)
    elif mode is BondsMode.CAPACITY:
        # The 2^64-1 constant enters float32 arithmetic deliberately.
        cap_vec = S * torch.tensor(MAXINT, dtype=S.dtype, device=S.device)
        remaining = torch.clamp(cap_vec - B_old, min=0.0)
        purchase = torch.minimum(cap_alpha * cap_vec, remaining) * W_n
        B_next = (1.0 - decay) * B_old + purchase
        B_next = torch.minimum(B_next, cap_vec)
        D = (B_next * incentive).sum(dim=-1, keepdim=True)
    else:  # RELATIVE
        B_dec = B_old * (1.0 - rate)
        remaining = torch.clamp(1.0 - B_dec, min=0.0)
        purchase = torch.minimum(rate * W_n, remaining)
        B_next = torch.clamp(B_dec + purchase, max=1.0)
        D = S * (B_next * incentive).sum(dim=-1, keepdim=True)
    D_tot = D.sum(dim=-1, keepdim=True).sum(dim=-2, keepdim=True)
    return B_next, D / (D_tot + 1e-6)


def _scan_plain(W, S, hp, reset_index, reset_epoch, state, *, T, p):
    """The plain version of both kernels over `W [B, E, V, M]`: phases 2-6
    batched over each T-epoch tile, then the bond recurrence epoch by
    epoch (T = 1 is the case scan)."""
    Bn, E, V, M = W.shape
    mode = p["mode"]

    def sc(i):
        return hp[:, i].reshape(Bn, 1, 1)

    bonds, cprev, wprev = state  # [B, V, M], [B, 1, M], [B, V, M] or None
    colm = torch.arange(M, device=W.device).reshape(1, M)
    ri = reset_index.reshape(Bn, 1, 1).long()
    r_epoch = reset_epoch.reshape(Bn, 1, 1).long()
    liquid_scal = (sc(5), sc(6), sc(7), sc(8))
    per_epoch_rate = p["liquid"] and mode is not BondsMode.CAPACITY
    dn, bond_rows, inc_rows, cons_rows = [], [], [], []
    for e0 in range(0, E, T):
        Wt = W[:, e0 : e0 + T].transpose(0, 1)  # [T, B, V, M]
        St = S[:, e0 : e0 + T].transpose(0, 1).unsqueeze(-1)  # [T, B, V, 1]
        S_n = St / sequential_sum(St, -2, keepdim=True)
        W_n, C = _consensus_phase(
            Wt, S_n, hp[:, 0], precision=p["precision"], rust64=p["rust64"]
        )
        if mode is BondsMode.EMA_PREV:
            tt = torch.arange(T, device=W.device).reshape(T, 1, 1, 1)
            first_b = (e0 + tt + p["epoch_offset"]) == 0
            clip_prev = torch.cat([wprev.unsqueeze(0), W_n[:-1]], dim=0)
            clip_base = torch.where(first_b, W_n, clip_prev)
        else:
            clip_base = W_n
        W_clipped, incentive, rate = _clip_rank_rate(
            S_n, C, clip_base, sc(2), mode=mode, liquid=p["liquid"],
            liquid_scal=liquid_scal, overrides=p["overrides"],
        )
        for t in range(T):
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
            dn.append(D_n[..., 0])
            if p["save_bonds"]:
                bond_rows.append(bonds)
            inc_rows.append(incentive[t, :, 0])
            cons_rows.append(C[t, :, 0])
        cprev = C[T - 1]
        if mode is BondsMode.EMA_PREV:
            wprev = W_n[T - 1]
    out = {"dividends_normalized": torch.stack(dn, dim=1), "final_bonds": bonds}
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
        ("q_wlo", ctypes.c_float * 3),
        ("q_whi", ctypes.c_float * 3),
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
            "W", "S", "hp", "reset_index", "reset_epoch", "bonds", "cprev",
            "wprev", "dn", "bonds_out", "inc_out", "cons_out", "wn", "sn",
            "sint", "chi", "C", "inc", "rate", "dsum", "rden", "stream",
        )
    ] + [
        (name, ctypes.c_int)
        for name in (
            "B", "E", "V", "M", "T", "mode", "reset_mode", "iters", "rust64",
            "liquid", "epoch_offset",
        )
    ] + [("liq", _LiquidSpec)]


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


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _scan_cuda(W, S, hp, reset_index, reset_epoch, state, *, T, p, varying: bool):
    """Launch K2 (`varying=False`, T = 1) or K3 on contiguous CUDA tensors."""
    Bn, E, V, M = W.shape
    check_cuda_float32("W", W)
    check_cuda_float32("S", S, (Bn, E, V))
    mode = p["mode"]
    dev = W.device
    bonds, cprev, wprev = state

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {
        "dividends_normalized": empty(Bn, E, V),
        "bonds": empty(Bn, E, V, M) if p["save_bonds"] else None,
        "incentives": empty(Bn, E, M) if p["save_incentives"] else None,
        "consensus": empty(Bn, E, M) if p["save_consensus"] else None,
    }
    scratch = dict(
        wn=empty(T, Bn, V, M), sn=empty(T, Bn, V),
        sint=empty(T, Bn, V, dtype=torch.int32), chi=empty(T, Bn, M),
        C=empty(T, Bn, M), inc=empty(T, Bn, M), rate=empty(T, Bn, M),
        dsum=empty(Bn, V), rden=empty(T, Bn, V),
    )
    args = _ScanArgs(
        W=W.data_ptr(), S=S.data_ptr(), hp=hp.data_ptr(),
        reset_index=reset_index.data_ptr(), reset_epoch=reset_epoch.data_ptr(),
        bonds=bonds.data_ptr(), cprev=cprev.data_ptr(), wprev=_ptr(wprev),
        dn=out["dividends_normalized"].data_ptr(), bonds_out=_ptr(out["bonds"]),
        inc_out=_ptr(out["incentives"]), cons_out=_ptr(out["consensus"]),
        **{k: v.data_ptr() for k, v in scratch.items()},
        stream=torch.cuda.current_stream(dev).cuda_stream,
        B=Bn, E=E, V=V, M=M, T=T, mode=_MODE_CODE[mode],
        reset_mode=_RESET_CODE[p["reset_mode"]],
        iters=bisection_iterations(p["precision"]),
        rust64=int(p["rust64"]), liquid=int(p["liquid"]),
        epoch_offset=p["epoch_offset"],
        liq=_liquid_struct(M, *p["overrides"]),
    )
    lib = _build.load("case_scan.cu")
    fn = lib.yuma_varying_scan if varying else lib.yuma_case_scan
    fn.argtypes = [ctypes.POINTER(_ScanArgs)]
    fn.restype = ctypes.c_int
    err = fn(ctypes.byref(args))
    if err:
        name = "varying scan" if varying else "case scan"
        raise RuntimeError(f"{name} kernel failed: CUDA error {err}")
    (VARYING_SCAN_LAUNCHES if varying else CASE_SCAN_LAUNCHES).add()
    out = {k: v for k, v in out.items() if v is not None}
    out["final_bonds"] = bonds
    out["final_consensus"] = cprev[:, 0]
    out["final_w_prev"] = wprev
    return out


# ---------------------------------------------------------------------------
# the public wrappers


def _hp_rows(Bn, device, *, kappa, bond_penalty, bond_alpha, capacity_alpha,
             decay_rate, liquid_alpha, alpha_low, alpha_high):
    """The per-scenario hyperparameter rows `[B, 9]` (column order of
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
    rows = torch.stack([f32(v).broadcast_to((Bn,)) for v in vals], dim=1)
    return rows.contiguous().to(device)


def varying_scan_epoch_tile(shape, device=None) -> int:
    """Largest epoch tile (<= :data:`VARYING_EPOCH_TILE_MAX`) that divides
    the epoch count of `shape` (`[E, V, M]` or `[B, E, V, M]`) and whose
    tile scratch fits half the free device memory (no check on the CPU).
    Returns 0 when not even a one-epoch tile fits."""
    E, V, M = shape[-3:]
    Bn = shape[0] if len(shape) == 4 else 1
    per_epoch = 4 * Bn * (V * M + 3 * V + 4 * M)
    free = None
    if device is not None and torch.device(device).type == "cuda":
        free = torch.cuda.mem_get_info(torch.device(device))[0]
    for et in range(min(VARYING_EPOCH_TILE_MAX, max(1, E)), 0, -1):
        if E % et == 0 and (free is None or et * per_epoch <= free // 2):
            return et
    return 0


def _scan(
    W, S, *, varying, plain, epoch_tile, reset_index, reset_epoch, reset_mode, kappa,
    bond_penalty, bond_alpha, capacity_alpha, decay_rate, liquid_alpha,
    alpha_low, alpha_high, override_consensus_high, override_consensus_low,
    mode, precision, save_bonds, save_incentives, save_consensus, carry,
    epoch_offset, return_carry, x64,
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
    dev = W.device
    W4 = W.reshape(Bn, E, V, M).contiguous()
    S3 = S.reshape(Bn, E, V).contiguous()

    T = 1
    if varying:
        if epoch_tile is None:
            T = varying_scan_epoch_tile(W4.shape, dev)
            if T < 1:
                raise ValueError(
                    f"{list(W.shape)} too large for the varying scan at any tile"
                )
        else:
            T = int(epoch_tile)
            if T < 1 or E % T:
                raise ValueError(
                    f"epoch_tile={T} must be >= 1 and divide the epoch count (E={E})"
                )

    def vec(x):
        return torch.as_tensor(x, dtype=torch.int32).cpu().broadcast_to((Bn,)).contiguous().to(dev)

    need = {"bonds", "consensus"} | ({"w_prev"} if mode is BondsMode.EMA_PREV else set())
    if carry is not None:
        if set(carry) != need:
            raise ValueError(
                f"carry must have exactly keys {sorted(need)} for mode {mode}, "
                f"got {sorted(carry)}"
            )

        def carried(key, shape):
            x = torch.as_tensor(carry[key], dtype=torch.float32).to(dev)
            if tuple(x.shape) != lead + shape:
                raise ValueError(f"carry {key} must be {lead + shape}, got {tuple(x.shape)}")
            return x.reshape((Bn,) + shape).clone().contiguous()

        bonds = carried("bonds", (V, M))
        cprev = carried("consensus", (M,)).reshape(Bn, 1, M)
        wprev = carried("w_prev", (V, M)) if "w_prev" in need else None
    else:
        bonds = torch.zeros((Bn, V, M), dtype=torch.float32, device=dev)
        cprev = torch.zeros((Bn, 1, M), dtype=torch.float32, device=dev)
        wprev = torch.zeros_like(bonds) if mode is BondsMode.EMA_PREV else None

    hp = _hp_rows(
        Bn, dev, kappa=kappa, bond_penalty=bond_penalty, bond_alpha=bond_alpha,
        capacity_alpha=capacity_alpha, decay_rate=decay_rate,
        liquid_alpha=liquid_alpha, alpha_low=alpha_low, alpha_high=alpha_high,
    )
    p = dict(
        mode=mode, reset_mode=reset_mode, precision=int(precision),
        rust64=mode is BondsMode.EMA_RUST and x64, liquid=bool(liquid_alpha),
        overrides=(override_consensus_high, override_consensus_low),
        epoch_offset=int(epoch_offset), save_bonds=save_bonds,
        save_incentives=save_incentives, save_consensus=save_consensus,
    )
    ri, re_ = vec(reset_index), vec(reset_epoch)
    state = (bonds, cprev, wprev)
    if dev.type == "cuda" and not plain:
        res = _scan_cuda(W4, S3, hp, ri, re_, state, T=T, p=p, varying=varying)
    else:
        res = _scan_plain(W4, S3, hp, ri, re_, state, T=T, p=p)

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
) -> dict:
    """The keyword arguments of the two scans, with the JAX functions'
    defaults."""
    return dict(locals())


def fused_case_scan(W: torch.Tensor, S: torch.Tensor, **kwargs) -> dict:
    """The whole epoch loop, one epoch per step (K2). `W [(B,) E, V, M]`
    and `S [(B,) E, V]` are per-epoch raw weights and stakes; keyword
    arguments as JAX's `fused_case_scan` (`reset_index`, `reset_epoch`,
    `reset_mode`, the hyperparameters, `mode`, `precision`, the `save_*`
    flags, `carry`, `epoch_offset`, `return_carry`), plus `x64` for Yuma
    0's float64 quantization divide. Returns `dividends_normalized
    [(B,) E, V]`, `final_bonds`, the saved per-epoch streams and, with
    `return_carry`, `final_consensus` (+ `final_w_prev` for EMA_PREV)."""
    return _scan(W, S, varying=False, plain=False, epoch_tile=None, **_scan_kwargs(**kwargs))


def fused_varying_scan(
    W: torch.Tensor, S: torch.Tensor, *, epoch_tile: Optional[int] = None, **kwargs
) -> dict:
    """:func:`fused_case_scan`'s epoch-tiled twin (K3): the same inputs,
    outputs and carry contract, with the bond-independent phases run once
    per `epoch_tile` epochs (a divisor of E; None picks
    :func:`varying_scan_epoch_tile`). Consensus and incentives are bitwise
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

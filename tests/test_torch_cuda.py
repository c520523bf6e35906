"""The port's CUDA kernels K1-K6 against their plain PyTorch versions, on
the card, at small shapes and over the options that chip_smoke.py's one
configuration does not reach: every version, liquid alpha overrides,
batched suites with firing resets, several epoch tiles, the carry /
epoch_offset contract, the float-sum quantize fallback, K1 and K4 at
every edge of their register layouts (V, M, batch, knife-edge weights on
the 2^-17 grid, NaN / +-inf, zero and all-holding stakes), the
tensor-core (K4) spellings of every scan, the case scan at epoch tiles
that do not divide E, phase 8 inside phase 7's launch and the rank phase
at the edges of their layouts, the scaled scan (K5) and the single fused
epoch (K6) with their options, K6 called back to back without a
synchronization, the refusals on CUDA tensors, and the chart path: the
chart table's suite through K3, a padded suite with miner masks on the
eager rung, and the chart CLI (skipped where matplotlib is missing); the
long runs; and the Monte-Carlo path: K7 (the weight slab) bitwise its
plain version, the per-epoch Monte-Carlo through K7 + K3 chunk-invariant,
and the sharded batch over the card's one-device mesh; and the serving
tier: a coalesced K3 batch bitwise its solo runs, and a served what-if's
hit bitwise its miss and the uncached run on K2.

Every test is marked `cuda` and takes the `cuda` fixture, which skips it
where no CUDA device is present. The JAX package is not needed (the card's
machine has none); run with its conftest left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The reference is the plain version on CPU tensors, which the CPU tests
(tests/test_torch_*.py) hold to the JAX package. Tolerances: `c_high`
and quantized consensus bitwise (integer-exact on both sides), every
`mxu` spelling bitwise its VPU spelling on the card; dividends,
bonds and incentives within atol 2e-6 and rtol 1e-5, the JAX package's
fused-vs-XLA tolerance (the kernels add floats in another order than
PyTorch's CPU sums).
"""

import numpy as np
import pytest
import torch

from yuma_simulation_tpu_torch.models.config import (
    SimulationHyperparameters,
    YumaConfig,
    YumaParams,
)
from yuma_simulation_tpu_torch.models.variants import canonical_versions, variant_for_version
from yuma_simulation_tpu_torch.ops.consensus import stake_weighted_median
from yuma_simulation_tpu_torch.ops.cuda_consensus import stake_weighted_median_cuda
from yuma_simulation_tpu_torch.models.epoch import BondsMode
from yuma_simulation_tpu_torch.ops import cuda_epoch
from yuma_simulation_tpu_torch.ops.cuda_epoch import (
    fused_case_scan,
    fused_ema_epoch,
    fused_ema_scan,
    fused_varying_scan,
)
from yuma_simulation_tpu_torch.ops.launches import launch_counts, reset_launch_counts
from yuma_simulation_tpu_torch.scenarios import create_case
from yuma_simulation_tpu_torch.simulation.engine import (
    fused_hparams,
    simulate,
    simulate_constant,
    simulate_scaled,
    simulate_scaled_batch,
)
from yuma_simulation_tpu_torch.telemetry.numerics import host_sketches, sketch_mismatches

pytestmark = pytest.mark.cuda

ATOL, RTOL = 2e-6, 1e-5
VERSIONS = canonical_versions()
IDS = [name for name, _ in VERSIONS]
# Scenario 0 resets (ALWAYS) at epoch 4; scenario 1's miner 3 loses all
# weight from epoch 3, so the CONDITIONAL rule fires at its epoch 5; in a
# batch of 4, scenario 3's miner 1 loses its weight from epoch 5 and resets
# at epoch 7.
RESET_INDEX = np.array([2, 3, -1, 1], np.int32)
RESET_EPOCH = np.array([4, 5, -1, 7], np.int32)
# (V, M, B): the CPU tests' shape, and one that spans several row blocks,
# miner tiles and row-sum chunks of the kernels; then the edges of the
# bond phase's tiling (32-miner tiles, 8 validator slices of at most 32
# validators in registers) and of the row sum (8-row blocks, 16-byte
# copies only when M % 4 == 0): a single validator, V = 7 (fewer
# validators than slices), M = 33 and 65 (ragged tiles, M % 4 != 0), a
# batch of 4 with resets firing, and V = 300 (slices of 38: the re-read
# tail past the register cache).
SHAPES = [(6, 18, 3), (40, 300, 3), (1, 33, 3), (7, 65, 4), (300, 40, 4)]
SHAPE_IDS = [f"{v}x{m}" + ("" if b == 3 else f"-b{b}") for v, m, b in SHAPES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc and run only on the card")
    return torch.device("cuda")


def _suite(V, M, seed=0, B=3, E=10):
    rng = np.random.default_rng(seed)
    W = rng.random((B, E, V, M)).astype(np.float32)
    W[W < 0.3] = 0.0
    W[1, 3:, :, 3] = 0.0
    if B > 3:
        W[3, 5:, :, 1] = 0.0
    S = (rng.random((B, E, V)) + 0.01).astype(np.float32)
    return torch.tensor(W), torch.tensor(S)


def _scan_kwargs(version, params, B=3, **extra):
    spec = variant_for_version(version)
    kw = fused_hparams(YumaConfig(yuma_params=params))
    kw.update(
        reset_index=torch.tensor(RESET_INDEX[:B]), reset_epoch=torch.tensor(RESET_EPOCH[:B]),
        reset_mode=spec.reset_mode, mode=spec.bonds_mode,
        save_bonds=True, save_incentives=True, save_consensus=True,
    )
    kw.update(extra)
    return kw


def _assert_matches(got: dict, ref: dict, label: str, atol=ATOL, rtol=RTOL):
    assert set(got) == set(ref), (label, sorted(set(got) ^ set(ref)))
    for key, r in ref.items():
        g = got[key].cpu()
        if key in ("consensus", "final_consensus"):
            torch.testing.assert_close(g, r, rtol=0, atol=0, msg=lambda m: f"{label} {key}: {m}")
        else:
            torch.testing.assert_close(g, r, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{label} {key}: {m}")


# K1's and K4's edge cases beyond the existing ones (lead, V, M, kind):
# V across every layout boundary of launch_bisect (a single validator; one
# k-step of K4, 32 validators, and one past it; 255, 256 = all
# warps' register slices at the committed 4 warps x 64, and 257, whose tail
# is re-read every halving; 1000 and 4096, long tails, and K4's k-steps past
# its 8 in registers), M across the tiles (1, 31, 33, 4097; 4096 takes K1's
# 16-byte loads), one slab and a leading batch. "grid" weights lie on the
# 2^-17 grid, so midpoints hit them exactly (the strict `>` at knife
# edges), with a row of zeros, a zero-stake validator and NaN / +-inf
# weights; "holder" gives one validator all the stake (S_int = 2^30).
BISECT_EDGES = [
    ((), 1, 33, "grid"), ((), 31, 4097, "grid"), ((), 32, 1, "grid"),
    ((), 33, 31, "grid"), ((), 255, 4096, "grid"), ((), 256, 4096, "grid"),
    ((2,), 256, 4096, "holder"), ((), 257, 33, "grid"), ((2,), 1000, 4097, "grid"),
    ((), 4096, 31, "grid"), ((3,), 33, 1, "holder"),
]
BISECT_EDGE_IDS = [
    f"{kind}-{V}x{M}" + (f"-b{lead[0]}" if lead else "") for lead, V, M, kind in BISECT_EDGES
]


def _bisect_inputs(lead, V, M, kind, seed):
    """Weights `[*lead, V, M]` and normalized stakes `[*lead, V]` (CPU).
    "random": uniform weights, half of them zero, row-normalized, lognormal
    (sigma 1.2) stakes; "grid" and "holder" as BISECT_EDGES says."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        W = rng.random(lead + (V, M)).astype(np.float32)
        W[W < 0.5] = 0.0
        W = W / (W.sum(-1, keepdims=True) + np.float32(1e-6))
        S = rng.lognormal(0.0, 1.2, lead + (V,)).astype(np.float32)
        S = S / S.sum(-1, keepdims=True)
        return torch.tensor(W), torch.tensor(S)
    W = (rng.integers(0, 2**17 + 1, size=lead + (V, M)) * 2.0**-17).astype(np.float32)
    W[rng.random(W.shape) < 0.5] = 0.0
    S = rng.lognormal(0.0, 2.0, lead + (V,)).astype(np.float32)
    if kind == "holder":
        S[:] = 0.0
        S[..., V // 2] = 1.0
    else:
        W[..., 0, :] = 0.0
        if V > 1:
            S[..., 1] = 0.0
        flat = W.reshape(-1)
        cells = rng.choice(flat.size, size=min(flat.size, 3 * (1 + flat.size // 997)),
                           replace=False)
        flat[cells] = np.array([np.nan, np.inf, -np.inf], np.float32)[np.arange(cells.size) % 3]
    S = S / S.sum(-1, keepdims=True)
    return torch.tensor(W), torch.tensor(S)


@pytest.mark.parametrize(
    "lead,V,M,kind",
    [((), 8, 32, "random"), ((), 256, 700, "random"), ((3,), 1000, 200, "random"),
     ((), 4096, 160, "random")] + BISECT_EDGES,
    ids=["small", "tile128", "tile32-batched", "unstaged"] + BISECT_EDGE_IDS,
)
def test_k1_matches_plain_bitwise(cuda, lead, V, M, kind):
    """K1 against its plain version, bitwise, at the shapes the earlier
    staged layout took (small, 128-miner tiles, 32-miner tiles over a batch,
    unstaged) and at every edge of the register layout (BISECT_EDGES)."""
    W, S = _bisect_inputs(lead, V, M, kind, seed=V)
    reset_launch_counts()
    got = stake_weighted_median_cuda(W.to(cuda), S.to(cuda), 0.5)
    torch.cuda.synchronize()
    assert launch_counts()["consensus_bisect"] == 1
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), stake_weighted_median(W, S, 0.5), rtol=0, atol=0)


@pytest.mark.parametrize("V,M,B", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("version,params", VERSIONS, ids=IDS)
def test_scans_match_plain(cuda, version, params, V, M, B):
    """K2, and K3 at tiles 2 and 5, on a batched suite with firing resets
    and saved bonds; K3 also held to K2 under the varying scan's own
    contract: consensus and incentives bitwise, dividends and bonds within
    1e-6."""
    W, S = _suite(V, M, B=B)
    kw = _scan_kwargs(version, params, B=B, return_carry=True)
    reset_launch_counts()
    k2 = fused_case_scan(W.to(cuda), S.to(cuda), **kw)
    _assert_matches(k2, fused_case_scan(W, S, **kw), f"{version} case scan")
    for tile in (2, 5):
        k3 = fused_varying_scan(W.to(cuda), S.to(cuda), epoch_tile=tile, **kw)
        ref = fused_varying_scan(W, S, epoch_tile=tile, **kw)
        _assert_matches(k3, ref, f"{version} varying scan, tile {tile}")
        for key in ("consensus", "incentives"):
            torch.testing.assert_close(k3[key], k2[key], rtol=0, atol=0)
        for key in ("dividends_normalized", "bonds", "final_bonds"):
            torch.testing.assert_close(k3[key], k2[key], rtol=0, atol=1e-6)
    assert launch_counts() == {"consensus_bisect": 0, "case_scan": 1, "varying_scan": 2,
                               "support_mma": 0, "ema_scan": 0, "ema_epoch": 0,
                               "mc_weights": 0}


def _case_scan_at(W, S, tile, **kw):
    """K2 (CUDA tensors) or its plain version (CPU) over `tile`-epoch tiles."""
    return cuda_epoch._scan(W, S, varying=False, plain=False, epoch_tile=tile,
                            **cuda_epoch._scan_kwargs(**kw))


@pytest.mark.parametrize("E,tile", [(17, 16), (7, 4), (7, 3)], ids=["17by16", "7by4", "7by3"])
@pytest.mark.parametrize(
    "version", ["Yuma 2 (Adrian-Fish)", "Yuma 3.2 (Rhef+conditional)",
                "Yuma 1 (paper) - liquid alpha on",
                "Yuma 4 (Rhef+relative bonds) - liquid alpha on"],
)
def test_case_scan_ragged_tiles_match_plain(cuda, version, E, tile):
    """K2 over tiles that do not divide E (the last one shorter), on a
    batch of 4 with resets firing at and inside tile boundaries, against
    its plain version at the same tiles; bitwise K3 (at tile 1, which
    divides every E) and K2 with its own tile choice on consensus and
    incentives, within 1e-6 on dividends and bonds."""
    params = dict(VERSIONS)[version]
    W, S = _suite(40, 300, seed=8, B=4, E=E)
    kw = _scan_kwargs(version, params, B=4, return_carry=True)
    kw["reset_epoch"] = torch.tensor([4, tile, -1, 7], dtype=torch.int32)
    reset_launch_counts()
    got = _case_scan_at(W.to(cuda), S.to(cuda), tile, **kw)
    assert launch_counts()["case_scan"] == 1
    _assert_matches(got, _case_scan_at(W, S, tile, **kw), f"{version} K2 tile {tile} of {E}")
    for other in (fused_varying_scan(W.to(cuda), S.to(cuda), epoch_tile=1, **kw),
                  fused_case_scan(W.to(cuda), S.to(cuda), **kw)):
        for key in ("consensus", "incentives", "final_consensus"):
            torch.testing.assert_close(got[key], other[key], rtol=0, atol=0)
        for key in ("dividends_normalized", "bonds", "final_bonds"):
            torch.testing.assert_close(got[key], other[key], rtol=0, atol=1e-6)


# (V, M, B): phase 8 inside k_bond with one group of 16 miner tiles, with
# three groups, the last one ragged (34 tiles), and with validators strided
# over the block's 1024 threads and more of them than its shared memory
# holds (V > 8448: D[v] in device memory); the rank phase at V not a
# multiple of its 32 validator slices and M % 32 != 0.
FOLD_SHAPES = [(33, 47, 3), (260, 1057, 2), (8500, 33, 2)]


@pytest.mark.parametrize("V,M,B", FOLD_SHAPES, ids=[f"{v}x{m}-b{b}" for v, m, b in FOLD_SHAPES])
@pytest.mark.parametrize(
    "version", ["Yuma 1 (paper)", "Yuma 0 (subtensor)", "Yuma 4 (Rhef+relative bonds)"],
)
def test_dividend_fold_and_rank_layout(cuda, version, V, M, B):
    """K2, K3 and K5 (its dividends summed over epochs in the folded phase
    8) against their plain versions at the edges of phase 8's grouping and
    the rank phase's slices; K2 bitwise K3 on consensus and incentives;
    two runs bitwise the same (the tickets are integers, no float
    atomics)."""
    params = dict(VERSIONS)[version]
    W, S = _suite(V, M, seed=9, B=B, E=6)
    kw = _scan_kwargs(version, params, B=B)
    k2 = fused_case_scan(W.to(cuda), S.to(cuda), **kw)
    _assert_matches(k2, fused_case_scan(W, S, **kw), f"{version} K2 {V}x{M}")
    k3 = fused_varying_scan(W.to(cuda), S.to(cuda), epoch_tile=3, **kw)
    _assert_matches(k3, fused_varying_scan(W, S, epoch_tile=3, **kw), f"{version} K3 {V}x{M}")
    for key in ("consensus", "incentives"):
        torch.testing.assert_close(k3[key], k2[key], rtol=0, atol=0)
    again = fused_case_scan(W.to(cuda), S.to(cuda), **kw)
    for key in k2:
        torch.testing.assert_close(again[key], k2[key], rtol=0, atol=0)
    mode = variant_for_version(version).bonds_mode
    hp = _hp(params)
    Ws, S_n, scales = _scaled_inputs(V, M, E=6, B=B, seed=9)
    ekw = dict(mode=mode, x64=mode is BondsMode.EMA_RUST, **hp)
    got = fused_ema_scan(Ws.to(cuda), S_n.to(cuda), scales.to(cuda), **ekw)
    ref = fused_ema_scan(Ws, S_n, scales, **ekw)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, rtol=RTOL, atol=ATOL)


# (V, M) inside ops/normalize.py::xla_chains where phase 8's dividend total
# is not phase 7's chain: 2 validators (the EMA modes' D[0] + D[1]), and 4
# and 8 (every mode but Yuma 4 folds D by halves); 3 keeps the chain.
TOTAL_WIDTHS = [(2, 5), (3, 5), (4, 8), (8, 5)]


@pytest.mark.parametrize("V,M", TOTAL_WIDTHS, ids=[f"{v}x{m}" for v, m in TOTAL_WIDTHS])
@pytest.mark.parametrize("version,params", VERSIONS, ids=IDS)
def test_dividend_total_widths_match_plain(cuda, version, params, V, M):
    """K2 and K3 against their plain versions at the widths where phase 8
    spells the dividend total as a fold (ops/normalize.py::
    EMA_FOLD_VALIDATORS, FOLD_VALIDATORS) and one where it is the chain,
    every version: consensus bitwise, the rest within ATOL / RTOL. (Not
    bitwise on these random suites: the kernels' other sums round in their
    own order; ROADMAP §C.)"""
    W, S = _suite(V, M, seed=21, E=6)
    kw = _scan_kwargs(version, params)
    for name, scan, extra in (("K2", fused_case_scan, {}),
                              ("K3", fused_varying_scan, {"epoch_tile": 3})):
        got = scan(W.to(cuda), S.to(cuda), **extra, **kw)
        _assert_matches(got, scan(W, S, **extra, **kw), f"{version} {name} {V}x{M}")


@pytest.mark.parametrize("mode,with_clip", [("EMA", False), ("EMA_PREV", True)],
                         ids=["ema", "ema-prev-clip"])
def test_ema_epoch_back_to_back_matches_synchronized(cuda, mode, with_clip):
    """20 K6 calls in a row, each on the bonds of the one before, with a
    float w_scale (copied from pinned memory) and a tensor one, queued
    without a synchronization: bitwise the same 20 calls with
    torch.cuda.synchronize() after each."""
    rng = np.random.default_rng(12)
    V, M = 40, 300
    W = torch.tensor(rng.random((V, M)).astype(np.float32), device=cuda)
    S = torch.tensor(rng.random(V).astype(np.float32) + 0.01, device=cuda)
    S_n = S / S.sum()
    clip = torch.tensor(rng.random((V, M)).astype(np.float32), device=cuda) if with_clip else None
    scales = torch.tensor((1.0 + 1e-4 * rng.random(20)).astype(np.float32), device=cuda)
    floats = scales.tolist()

    def chain(sync):
        B, outs = torch.zeros((V, M), device=cuda), []
        for e in range(20):
            w_scale = floats[e] if e % 2 else scales[e]
            B, D_n, inc = fused_ema_epoch(W, S_n, B, w_scale=w_scale, first_epoch=e == 0,
                                          clip_base=clip, mode=getattr(BondsMode, mode))
            outs.append((B, D_n, inc))
            if sync:
                torch.cuda.synchronize()
        return outs

    reset_launch_counts()
    queued = chain(False)
    torch.cuda.synchronize()
    synced = chain(True)
    assert launch_counts()["ema_epoch"] == 40
    for a, b in zip(queued, synced):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("x64", [False, True], ids=["f32", "x64"])
def test_yuma0_quantize_modes(cuda, x64):
    """Yuma 0's quantize with the float32 dyadic denominator and with the
    native float64 divide."""
    W, S = _suite(40, 300, seed=1)
    version, params = VERSIONS[0]
    kw = _scan_kwargs(version, params, x64=x64)
    _assert_matches(fused_case_scan(W.to(cuda), S.to(cuda), **kw),
                    fused_case_scan(W, S, **kw), f"Yuma 0 x64={x64}")


@pytest.mark.parametrize(
    "overrides",
    [
        dict(override_consensus_high=0.05),
        dict(override_consensus_low=0.001),
        dict(override_consensus_high=0.05, override_consensus_low=0.001),
        dict(override_consensus_high=0.02, override_consensus_low=0.02),
    ],
    ids=["high", "low", "both", "both-equal"],
)
def test_liquid_overrides_match_plain(cuda, overrides):
    """The liquid-alpha regimes the kernel selects from the static
    quantile overrides."""
    W, S = _suite(40, 300, seed=2)
    params = YumaParams(liquid_alpha=True, **overrides)
    kw = _scan_kwargs("Yuma 1 (paper) - liquid alpha on", params)
    _assert_matches(fused_case_scan(W.to(cuda), S.to(cuda), **kw),
                    fused_case_scan(W, S, **kw), f"liquid {overrides}")


def test_liquid_degenerate_spread_matches_plain(cuda):
    """Only 4 of 18 miners get weight: the 0.25 and 0.75 quantiles
    coincide and the fit falls back to the 0.99 quantile."""
    rng = np.random.default_rng(6)
    W = np.zeros((6, 6, 18), np.float32)
    W[:, :, 14:] = rng.random((6, 6, 4)).astype(np.float32)
    S = (rng.random((6, 6)) + 0.01).astype(np.float32)
    W, S = torch.tensor(W), torch.tensor(S)
    kw = dict(mode=variant_for_version("Yuma 1 (paper)").bonds_mode, liquid_alpha=True,
              save_consensus=True)
    _assert_matches(fused_case_scan(W.to(cuda), S.to(cuda), **kw),
                    fused_case_scan(W, S, **kw), "degenerate liquid")


@pytest.mark.parametrize(
    "version", ["Yuma 2 (Adrian-Fish)", "Yuma 3.2 (Rhef+conditional)",
                "Yuma 4 (Rhef+relative bonds) - liquid alpha on"],
)
def test_carry_continues_run(cuda, version):
    """A run stopped after 6 epochs (return_carry) and continued from its
    carry at epoch_offset=6 is bitwise the uninterrupted case scan, and
    within the varying contract of it through K3."""
    params = dict(VERSIONS)[version]
    W, S = _suite(40, 300, seed=3)
    W, S = W.to(cuda), S.to(cuda)
    kw = _scan_kwargs(version, params)
    full = fused_case_scan(W, S, **kw)
    head = fused_case_scan(W[:, :6], S[:, :6], return_carry=True, **kw)
    carry = {"bonds": head["final_bonds"], "consensus": head["final_consensus"]}
    if "final_w_prev" in head:
        carry["w_prev"] = head["final_w_prev"]
    tail = fused_case_scan(W[:, 6:], S[:, 6:], carry=carry, epoch_offset=6, **kw)
    for key in ("dividends_normalized", "bonds", "incentives", "consensus"):
        torch.testing.assert_close(tail[key], full[key][:, 6:], rtol=0, atol=0)
    var = fused_varying_scan(W[:, 6:], S[:, 6:], carry=carry, epoch_offset=6,
                             epoch_tile=2, **kw)
    for key in ("consensus", "incentives"):
        torch.testing.assert_close(var[key], full[key][:, 6:], rtol=0, atol=0)
    for key in ("dividends_normalized", "bonds"):
        torch.testing.assert_close(var[key], full[key][:, 6:], rtol=0, atol=1e-6)


def test_quantize_fallback_beyond_int32_grid(cuda):
    """M * 2^iters >= 2^31 (M=32 at precision 2^26): the kernel's
    left-to-right float denominator against the plain version's."""
    W, S = _suite(6, 32, seed=4)
    kw = _scan_kwargs("Yuma 1 (paper)", YumaParams(), precision=2**26)
    _assert_matches(fused_case_scan(W.to(cuda), S.to(cuda), **kw),
                    fused_case_scan(W, S, **kw), "quantize fallback")


def test_auto_tile_falls_back_when_its_scratch_does_not_fit(cuda):
    """With too little free memory for a 16-epoch tile's scratch, the case
    scan and the scaled scan, tiled automatically, ask the card for its
    free memory and run at a smaller tile (K4 counts one launch a tile, so
    more than one): the results of the scans at full memory."""
    rng = np.random.default_rng(21)
    E, V, M = 16, 256, 4096  # a tile's scratch ~4.2 MB an epoch
    W = torch.tensor(rng.random((E, V, M), dtype=np.float32), device=cuda)
    S = torch.tensor(rng.random((E, V), dtype=np.float32) + 0.01, device=cuda)
    S_n = S[0] / S[0].sum()
    scales = 1.0 + 1e-4 * torch.arange(E, dtype=torch.float32, device=cuda)
    kw = dict(save_bonds=False, mxu=True)
    want_case = fused_case_scan(W, S, **kw)
    want_ema = fused_ema_scan(W[0], S_n, scales, mxu=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    hog = torch.empty(torch.cuda.mem_get_info(cuda)[0] - (40 << 20), dtype=torch.uint8,
                      device=cuda)
    try:
        reset_launch_counts()
        got_case = fused_case_scan(W, S, **kw)
        tiles_case = launch_counts()["support_mma"]
        reset_launch_counts()
        got_ema = fused_ema_scan(W[0], S_n, scales, mxu=True)
        counts = launch_counts()
        torch.cuda.synchronize()
    finally:
        del hog
        torch.cuda.empty_cache()
    assert tiles_case > 1 and counts["support_mma"] > 1, (tiles_case, counts)
    assert counts["ema_scan"] == 1, counts
    for key in ("consensus", "incentives"):
        if key in got_case:
            torch.testing.assert_close(got_case[key], want_case[key], rtol=0, atol=0)
    for key in ("dividends_normalized", "final_bonds"):
        torch.testing.assert_close(got_case[key], want_case[key], rtol=0, atol=1e-6)
    for g, w in zip(got_ema, want_ema):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


def test_scans_are_reproducible(cuda):
    """No float atomics: two runs are bitwise the same."""
    W, S = _suite(40, 300, seed=5)
    kw = _scan_kwargs("Yuma 1 (paper) - liquid alpha on", YumaParams(liquid_alpha=True))
    W, S = W.to(cuda), S.to(cuda)
    a = fused_varying_scan(W, S, epoch_tile=5, **kw)
    b = fused_varying_scan(W, S, epoch_tile=5, **kw)
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


@pytest.mark.parametrize(
    "epoch_impl,consensus_impl,engine,counter",
    [
        ("auto", "bisect", "fused_varying", "varying_scan"),
        ("fused_scan", "bisect", "fused_scan", "case_scan"),
        ("eager", "kernel", "eager", "consensus_bisect"),
    ],
    ids=["auto", "fused_scan", "eager-kernel"],
)
def test_simulate_on_card_matches_cpu(cuda, epoch_impl, consensus_impl, engine, counter):
    """`simulate` on the card through each rung against the CPU eager rung
    (Case 5: 40 epochs, a reset at epoch 20), with the rung's kernel
    launched."""
    case = create_case("Case 5")
    config = YumaConfig(simulation=SimulationHyperparameters(bond_penalty=0.5))
    version = "Yuma 3.1 (Rhef+reset)"
    reset_launch_counts()
    got = simulate(case, version, config, epoch_impl=epoch_impl,
                   consensus_impl=consensus_impl, save_consensus=True, device=cuda)
    counts = launch_counts()
    assert got.engine == engine
    assert counts[counter] == (case.num_epochs if counter == "consensus_bisect" else 1), counts
    ref = simulate(case, version, config, epoch_impl="eager", save_consensus=True,
                   device="cpu")
    np.testing.assert_array_equal(got.consensus, ref.consensus)
    for key in ("dividends", "bonds", "incentives"):
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key), atol=ATOL, rtol=RTOL)


def test_kernels_refuse_what_they_do_not_take(cuda):
    W, S = _suite(6, 18)
    Wn, Sn = W[0, 0].to(cuda), (S[0, 0] / S[0, 0].sum()).to(cuda)
    with pytest.raises(ValueError, match="float32"):
        stake_weighted_median_cuda(Wn.double(), Sn.double(), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        stake_weighted_median_cuda(Wn.t(), Sn, 0.5)
    with pytest.raises(ValueError, match="shape"):
        stake_weighted_median_cuda(Wn, Sn[:3], 0.5)
    for mma in (False, True):  # launch_bisect refuses an empty miner axis
        with pytest.raises(RuntimeError, match="CUDA error"):
            stake_weighted_median_cuda(Wn[:, :0].contiguous(), Sn, 0.5, mma=mma)
    with pytest.raises(ValueError, match="float32"):
        fused_case_scan(W.to(cuda).double(), S.to(cuda).double())


# ---------------------------------------------------------------------------
# K4: the support sum on the tensor cores


@pytest.mark.parametrize(
    "lead,V,M,kind",
    [((), 8, 32, "grid0"), ((), 256, 700, "grid0"), ((3,), 1000, 200, "grid0"),
     ((), 4096, 160, "grid0"), ((), 33, 4097, "grid0")] + BISECT_EDGES,
    ids=["small", "tile128", "tile32-batched", "unstaged", "ragged"] + BISECT_EDGE_IDS,
)
def test_k4_matches_plain_bitwise(cuda, lead, V, M, kind):
    """K4 against the plain bisection (masked integer sum) and the plain
    limb contraction, with weights on the 2^-17 grid so that midpoints
    hit them exactly (the strict `>` at knife edges); "grid0" is the grid
    without the special rows and values of BISECT_EDGES."""
    if kind == "grid0":
        rng = np.random.default_rng(V + M)
        W = (rng.integers(0, 2**17 + 1, size=lead + (V, M)) * 2.0**-17).astype(np.float32)
        W[rng.random(W.shape) < 0.5] = 0.0
        S = rng.lognormal(0.0, 2.0, lead + (V,)).astype(np.float32)
        S = S / S.sum(-1, keepdims=True)
        W, S = torch.tensor(W), torch.tensor(S)
    else:
        W, S = _bisect_inputs(lead, V, M, kind, seed=V + M)
    reset_launch_counts()
    got = stake_weighted_median_cuda(W.to(cuda), S.to(cuda), 0.5, mma=True)
    torch.cuda.synchronize()
    assert launch_counts()["support_mma"] == 1
    ref = stake_weighted_median(W, S, 0.5)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=0)
    torch.testing.assert_close(got.cpu(), stake_weighted_median(W, S, 0.5, mxu=True),
                               rtol=0, atol=0)


@pytest.mark.parametrize("version,params", VERSIONS, ids=IDS)
def test_mxu_scans_bitwise_vpu_scans(cuda, version, params):
    """K2 and K3 with mxu, on the card, bitwise their VPU spellings on
    every output."""
    W, S = _suite(40, 300, seed=7)
    W, S = W.to(cuda), S.to(cuda)
    kw = _scan_kwargs(version, params, return_carry=True)
    for scan, extra in ((fused_case_scan, {}), (fused_varying_scan, {"epoch_tile": 5})):
        vpu = scan(W, S, **extra, **kw)
        mxu = scan(W, S, mxu=True, **extra, **kw)
        assert set(vpu) == set(mxu)
        for key in vpu:
            torch.testing.assert_close(mxu[key], vpu[key], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K5: the scaled scan; K6: one fused epoch


def _scaled_inputs(V, M, E=9, B=3, seed=0):
    rng = np.random.default_rng(seed)
    W = rng.random((B, V, M)).astype(np.float32)
    W[W < 0.3] = 0.0
    S = (rng.random((B, V)) + 0.01).astype(np.float32)
    S_n = S / S.sum(-1, keepdims=True)
    scales = (1.0 + 1e-4 * rng.random(E)).astype(np.float32)
    return torch.tensor(W), torch.tensor(S_n), torch.tensor(scales)


def _hp(params):
    kw = fused_hparams(YumaConfig(yuma_params=params))
    return kw


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("V,M,B", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("version,params", VERSIONS, ids=IDS)
def test_ema_scan_matches_plain(cuda, version, params, V, M, B, batched):
    """K5 against its plain version at E=9 (one tile of 9 epochs) and E=17
    (17 tiles of one), for every version; its mxu spelling bitwise, with
    one tensor-core bisection launched per tile."""
    mode = variant_for_version(version).bonds_mode
    kw = dict(mode=mode, x64=mode is BondsMode.EMA_RUST, **_hp(params))
    reset_launch_counts()
    for E in (9, 17):
        W, S_n, scales = _scaled_inputs(V, M, E=E, B=B)
        if not batched:
            W, S_n = W[0], S_n[0]
        ref = fused_ema_scan(W, S_n, scales, **kw)
        got = fused_ema_scan(W.to(cuda), S_n.to(cuda), scales.to(cuda), **kw)
        for g, r, key in zip(got, ref, ("bonds", "D_n total")):
            torch.testing.assert_close(g.cpu(), r, rtol=RTOL, atol=ATOL,
                                       msg=lambda m: f"{version} E={E} {key}: {m}")
        mxu = fused_ema_scan(W.to(cuda), S_n.to(cuda), scales.to(cuda), mxu=True, **kw)
        for g, x in zip(got, mxu):
            torch.testing.assert_close(x, g, rtol=0, atol=0)
    counts = launch_counts()
    assert (counts["ema_scan"], counts["support_mma"]) == (4, 1 + 17), counts


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_ema_scan_recompute_prev_bitwise(cuda, batched):
    """EMA_PREV's two spellings bitwise, at tiles 1 (E=17), 2 and 9."""
    for E in (17, 2, 9):
        W, S_n, scales = _scaled_inputs(40, 300, E=E, seed=1)
        if not batched:
            W, S_n = W[0], S_n[0]
        W, S_n, scales = W.to(cuda), S_n.to(cuda), scales.to(cuda)
        ref = fused_ema_scan(W, S_n, scales, mode=BondsMode.EMA_PREV, recompute_prev=False)
        got = fused_ema_scan(W, S_n, scales, mode=BondsMode.EMA_PREV, recompute_prev=True)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("m_real", [None, 250], ids=["all", "m_real"])
@pytest.mark.parametrize("first", [False, True], ids=["later", "first"])
@pytest.mark.parametrize(
    "mode,with_clip",
    [("EMA", False), ("EMA_RUST", False), ("EMA_PREV", False), ("EMA_PREV", True)],
    ids=["ema", "ema-rust", "ema-prev", "ema-prev-clip"],
)
def test_ema_epoch_matches_plain(cuda, mode, with_clip, first, m_real):
    _check_ema_epoch(cuda, 40, 300, mode, with_clip, first, m_real)


@pytest.mark.parametrize("cut", [False, True], ids=["all", "m_real"])
@pytest.mark.parametrize("first", [False, True], ids=["later", "first"])
@pytest.mark.parametrize(
    "mode,with_clip",
    [("EMA", False), ("EMA_RUST", False), ("EMA_PREV", False), ("EMA_PREV", True)],
    ids=["ema", "ema-rust", "ema-prev", "ema-prev-clip"],
)
@pytest.mark.parametrize("V,M", [(1, 33), (7, 65), (300, 40)], ids=["1x33", "7x65", "300x40"])
def test_ema_epoch_edge_shapes_match_plain(cuda, V, M, mode, with_clip, first, cut):
    """K6 at the edges of the bond phase's tiling (see SHAPES)."""
    _check_ema_epoch(cuda, V, M, mode, with_clip, first, M - M // 6 if cut else None)


def _check_ema_epoch(cuda, V, M, mode, with_clip, first, m_real):
    rng = np.random.default_rng(11)
    W = rng.random((V, M)).astype(np.float32)
    W[W < 0.3] = 0.0
    if m_real is not None:
        W[:, m_real:] = 0.0
    S = (rng.random(V) + 0.01).astype(np.float32)
    args = [torch.tensor(W), torch.tensor(S / S.sum()),
            torch.tensor((rng.random((V, M)) * 0.1).astype(np.float32))]
    clip = torch.tensor(rng.random((V, M)).astype(np.float32)) if with_clip else None
    kw = dict(w_scale=1.0001, kappa=0.5, bond_penalty=0.7, bond_alpha=0.1,
              first_epoch=first, mode=getattr(BondsMode, mode), m_real=m_real,
              x64=mode == "EMA_RUST")
    ref = fused_ema_epoch(*args, clip_base=clip, **kw)
    dev_args = [a.to(cuda) for a in args]
    dev_clip = None if clip is None else clip.to(cuda)
    reset_launch_counts()
    got = fused_ema_epoch(*dev_args, clip_base=dev_clip, **kw)
    mxu = fused_ema_epoch(*dev_args, clip_base=dev_clip, mxu=True, **kw)
    assert launch_counts()["ema_epoch"] == 2
    for g, x, r in zip(got, mxu, ref):
        torch.testing.assert_close(g.cpu(), r, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(x, g, rtol=0, atol=0)


@pytest.mark.parametrize(
    "version,rung,counter",
    [
        ("Yuma 1 (paper)", "auto", "ema_scan"),
        ("Yuma 3 (Rhef)", "fused_scan_mxu", "ema_scan"),
        ("Yuma 2 (Adrian-Fish)", "fused", "ema_epoch"),
        ("Yuma 0 (subtensor)", "fused_mxu", "ema_epoch"),
        ("Yuma 4 (Rhef+relative bonds)", "eager", None),
    ],
)
def test_simulate_scaled_on_card_matches_cpu(cuda, version, rung, counter):
    """simulate_scaled on CUDA tensors through each rung against the same
    rung on CPU tensors (the plain versions), with the rung's kernel
    launched; and the batch and constant paths on the card."""
    W, _, scales = _scaled_inputs(40, 300, E=6)
    S = torch.tensor(np.random.default_rng(2).random((3, 40)).astype(np.float32) + 0.01)
    spec = variant_for_version(version)
    reset_launch_counts()
    got = simulate_scaled(W[0].to(cuda), S[0].to(cuda), scales.to(cuda), None, spec,
                          epoch_impl=rung)
    counts = launch_counts()
    if counter is not None:
        assert counts[counter] == (6 if counter == "ema_epoch" else 1), counts
    ref = simulate_scaled(W[0], S[0], scales, None, spec,
                          epoch_impl="fused_scan" if rung == "auto" else rung)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, rtol=RTOL, atol=ATOL)
    batch = simulate_scaled_batch(W.to(cuda), S.to(cuda), scales.to(cuda), None, spec)
    batch_ref = simulate_scaled_batch(W, S, scales, None, spec, epoch_impl="fused_scan")
    for g, r in zip(batch, batch_ref):
        torch.testing.assert_close(g.cpu(), r, rtol=RTOL, atol=ATOL)
    for hoist in (False, True):
        const = simulate_constant(W[0].to(cuda), S[0].to(cuda), 4, None, spec,
                                  hoist_invariant=hoist)
        const_ref = simulate_constant(W[0], S[0], 4, None, spec, hoist_invariant=hoist)
        for g, r in zip(const, const_ref):
            torch.testing.assert_close(g.cpu(), r, rtol=RTOL, atol=ATOL)


def test_scaled_kernels_refuse_what_they_do_not_take(cuda):
    W, S_n, scales = _scaled_inputs(6, 18)
    W, S_n, scales = W[0].to(cuda), S_n[0].to(cuda), scales.to(cuda)
    B0 = torch.zeros_like(W)
    with pytest.raises(ValueError, match="at least one epoch"):
        fused_ema_scan(W, S_n, scales[:0])
    big = torch.zeros(2**14 + 1, 2, device=cuda)
    with pytest.raises(ValueError, match="V <= 2\\^14"):
        fused_ema_scan(big, torch.zeros(2**14 + 1, device=cuda), scales, mxu=True)
    with pytest.raises(ValueError, match="V <= 2\\^14"):
        stake_weighted_median_cuda(big, torch.zeros(2**14 + 1, device=cuda), 0.5, mma=True)
    with pytest.raises(ValueError, match="M \\* 2\\^iters"):
        fused_ema_scan(torch.zeros(2, 2**14, device=cuda), torch.ones(2, device=cuda) / 2,
                       scales, mode=BondsMode.EMA_RUST, x64=True)
    with pytest.raises(ValueError, match="EMA family"):
        fused_ema_epoch(W, S_n, B0, mode=BondsMode.RELATIVE)
    with pytest.raises(ValueError, match="EMA_PREV"):
        fused_ema_epoch(W, S_n, B0, clip_base=W, mode=BondsMode.EMA)
    with pytest.raises(ValueError, match="m_real"):
        fused_ema_epoch(W, S_n, B0, m_real=W.shape[1] + 1)
    with pytest.raises(ValueError, match="float32"):
        fused_ema_scan(W.double(), S_n.double(), scales)


# ---------------------------------------------------------------------------
# Per-scenario hyperparameter tables, the exact multiply-add, the CLI.

GRID = dict(kappa=[0.5, 0.6], bond_alpha=[0.025, 0.1], bond_penalty=[0.5, 1.0])
GRID_VERSIONS = [
    ("Yuma 0 (subtensor)", {}),
    ("Yuma 1 (paper) - liquid alpha on", dict(liquid_alpha=True)),
    ("Yuma 2 (Adrian-Fish)", {}),
    ("Yuma 3.1 (Rhef+reset)", {}),
    ("Yuma 4 (Rhef+relative bonds)", {}),
]


def _grid_rows(params):
    """The 8 points of GRID as per-scenario hyperparameter vectors (the
    wrappers' `[B, 9]` table) and as one scalar set per point."""
    import itertools

    points = [dict(zip(GRID, combo)) for combo in itertools.product(*GRID.values())]
    base = fused_hparams(YumaConfig(yuma_params=YumaParams(**params)))
    table = dict(base, **{k: torch.tensor([p[k] for p in points], dtype=torch.float32)
                          for k in GRID})
    return table, [dict(base, **p) for p in points]


@pytest.mark.parametrize("kernel", ["K2", "K3", "K5"])
@pytest.mark.parametrize("version,params", GRID_VERSIONS, ids=[v for v, _ in GRID_VERSIONS])
def test_hp_table_lanes_bitwise_solo(cuda, kernel, version, params):
    """A `[B, 9]` hyperparameter table through K2, K3 and K5: every lane
    bitwise the same scenario run alone with scalar hyperparameters (the
    row passed by value)."""
    spec = variant_for_version(version)
    table, points = _grid_rows(params)
    G = len(points)
    W, S = _suite(40, 300, seed=3, E=10)
    W, S = W[:1], S[:1]
    x64 = spec.bonds_mode is BondsMode.EMA_RUST
    if kernel == "K5":
        Wg, Sg = W[:, 0].to(cuda), (S[:, 0] / S[:, 0].sum(-1, keepdim=True)).to(cuda)
        scales = (1.0 + 1e-4 * torch.arange(10, dtype=torch.float32)).to(cuda)

        def run(Wx, Sx, hp):
            return fused_ema_scan(Wx, Sx, scales, mode=spec.bonds_mode, x64=x64, **hp)

        grid = run(Wg.expand(G, -1, -1).contiguous(), Sg.expand(G, -1).contiguous(), table)
        for i, hp in enumerate(points):
            solo = run(Wg[0], Sg[0], hp)
            for g, s in zip(grid, solo):
                torch.testing.assert_close(g[i], s, rtol=0, atol=0)
        return
    scan = fused_case_scan if kernel == "K2" else fused_varying_scan
    kw = dict(reset_mode=spec.reset_mode, reset_index=3, reset_epoch=5, mode=spec.bonds_mode,
              x64=x64, save_bonds=True, save_incentives=True, save_consensus=True)
    Wc, Sc = W.to(cuda), S.to(cuda)
    grid = scan(Wc.expand(G, -1, -1, -1).contiguous(), Sc.expand(G, -1, -1).contiguous(),
                **kw, **table)
    for i, hp in enumerate(points):
        solo = scan(Wc, Sc, **kw, **hp)
        for key, value in solo.items():
            torch.testing.assert_close(grid[key][i], value[0], rtol=0, atol=0,
                                       msg=lambda m: f"{kernel} lane {i} {key}: {m}")


@pytest.mark.parametrize("mode", ["EMA", "EMA_RUST", "EMA_PREV"])
def test_k6_hp_table_bitwise_by_value(cuda, mode):
    """K6 with its hyperparameters as one-row tensors (the `[1, 9]` table
    path) bitwise the same call with Python numbers (the row by value)."""
    bonds_mode = BondsMode[mode]
    W, S = _suite(40, 300, seed=4, E=2)
    W1 = W[0, 0].to(cuda)
    S_n = (S[0, 0] / S[0, 0].sum()).to(cuda)
    B_old = (W[0, 1] * 1e-3).to(cuda)
    clip = (W[0, 1] / W[0, 1].sum(-1, keepdim=True)).to(cuda) if mode == "EMA_PREV" else None
    scalars = dict(kappa=0.6, bond_penalty=0.5, bond_alpha=0.05)
    tensors = {k: torch.tensor([v], dtype=torch.float32) for k, v in scalars.items()}
    for first in (True, False):
        kw = dict(mode=bonds_mode, first_epoch=first, clip_base=clip,
                  x64=bonds_mode is BondsMode.EMA_RUST)
        a = fused_ema_epoch(W1, S_n, B_old, **kw, **scalars)
        b = fused_ema_epoch(W1, S_n, B_old, **kw, **tensors)
        for x, y in zip(a, b):
            torch.testing.assert_close(y, x, rtol=0, atol=0)


def test_fma_helper_matches_fmaf_rn(cuda):
    """ops/fma.py::fma on CUDA and CPU tensors bitwise `__fmaf_rn` on the
    card: random triples, and triples next to float32 halfway points
    (where two roundings differ from one)."""
    from yuma_simulation_tpu_torch.ops.fma import fma, fmaf_cuda

    rng = np.random.default_rng(0)
    n = 1 << 16
    i = rng.integers(1, 1 << 12, n)
    sign = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    for a, b, c in (
        (rng.standard_normal(n) * 2.0 ** rng.integers(-40, 40, n),
         rng.standard_normal(n), rng.standard_normal(n) * 2.0 ** rng.integers(-60, 60, n)),
        (sign * (1 + i * 2.0**-23), 2.0**-24 * (1 - i * 2.0**-23),
         sign * (1 + rng.integers(0, 1 << 23, n) * 2.0**-23)),
    ):
        a, b, c = (torch.tensor(x.astype(np.float32)) for x in (a, b, c))
        ref = fmaf_cuda(a.to(cuda), b.to(cuda), c.to(cuda))
        torch.testing.assert_close(fma(a.to(cuda), b.to(cuda), c.to(cuda)), ref, rtol=0, atol=0)
        torch.testing.assert_close(fma(a, b, c), ref.cpu(), rtol=0, atol=0)


def test_cli_sheets_on_card(cuda, tmp_path):
    """The CLI's four sheets on the card (auto runs K3): header bytes and
    case names the goldens', every differing rendered cell pinned in
    tests/golden/csv_diff_cells.json."""
    import csv
    import json
    import pathlib

    from yuma_simulation_tpu_torch.cli.total_dividends_sheet_generator import main

    golden = pathlib.Path(__file__).resolve().parent / "golden"
    pins = json.loads((golden / "csv_diff_cells.json").read_text())
    reset_launch_counts()
    seconds = main(["--out-dir", str(tmp_path)])
    assert launch_counts()["varying_scan"] == 36
    for beta in seconds:
        text = (tmp_path / f"total_dividends_b{beta}.csv").read_bytes().decode()
        ref = (golden / f"total_dividends_b{beta}.csv").read_bytes().decode()
        assert "\r" not in text and text.splitlines()[0] == ref.splitlines()[0]
        mine, gold = list(csv.reader(text.splitlines())), list(csv.reader(ref.splitlines()))
        outside = [
            f"{mine[r][0]}|{mine[0][c]}|{mine[r][c]}|{gold[r][c]}"
            for r in range(1, len(mine)) for c in range(1, len(mine[0]))
            if mine[r][c] != gold[r][c]
            and f"{mine[r][0]}|{mine[0][c]}|{mine[r][c]}|{gold[r][c]}" not in pins[beta]
        ]
        assert not outside, (beta, outside)


def test_chart_suite_on_card(cuda):
    """The chart table's suite (v1/api.py::_simulate_suite) on the card:
    the 14 cases x 9 versions at bond_penalty 0.5 in 9 K3 launches, every
    per-epoch dividend, bond and incentive array within atol 2e-6 / rtol
    1e-5 of the same suite on the CPU."""
    from yuma_simulation_tpu_torch.scenarios import get_cases
    from yuma_simulation_tpu_torch.v1.api import _simulate_suite

    hp = SimulationHyperparameters(bond_penalty=0.5)
    reset_launch_counts()
    card = _simulate_suite(get_cases(), VERSIONS, hp)
    assert launch_counts()["varying_scan"] == 9 and sum(launch_counts().values()) == 9
    cpu = _simulate_suite(get_cases(), VERSIONS, hp, device="cpu")
    assert set(card) == set(cpu)
    for key, (_, (div, bonds, inc)) in card.items():
        _, (c_div, c_bonds, c_inc) = cpu[key]
        np.testing.assert_allclose(np.asarray(list(div.values())),
                                   np.asarray(list(c_div.values())), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(np.asarray(bonds), np.asarray(c_bonds), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(np.asarray(inc), np.asarray(c_inc), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("version,params", VERSIONS, ids=IDS)
def test_padded_suite_eager_on_card(cuda, version, params):
    """A padded suite of mixed shapes with its miner masks on CUDA tensors:
    "auto" runs the eager rung (no kernel launch) within atol 2e-6 / rtol
    1e-5 of the same run on CPU tensors; the fused rungs refuse the mask."""
    from yuma_simulation_tpu_torch.scenarios.base import Scenario
    from yuma_simulation_tpu_torch.simulation.sweep import pad_scenarios, simulate_batch

    rng = np.random.default_rng(3)
    suite = [create_case("Case 10")] + [
        Scenario(name=f"random {e}x{v}x{m}", validators=[f"v{i}" for i in range(v)],
                 base_validator="v0", weights=rng.random((e, v, m), dtype=np.float32),
                 stakes=np.tile(rng.gamma(1.0, size=v).astype(np.float32), (e, 1)),
                 num_epochs=e)
        for e, v, m in ((30, 5, 4), (20, 3, 37))
    ]
    config, spec = YumaConfig(yuma_params=params), variant_for_version(version)
    padded = pad_scenarios(suite, device=cuda)
    reset_launch_counts()
    got = simulate_batch(*padded[:4], config, spec, miner_mask=padded[4], save_bonds=True,
                         save_incentives=True, x64=True)
    assert not any(launch_counts().values()), launch_counts()
    ref = simulate_batch(*(t.cpu() for t in padded[:4]), config, spec,
                         miner_mask=padded[4].cpu(), save_bonds=True, save_incentives=True,
                         x64=True)
    for i, scenario in enumerate(suite):
        e, v, m = scenario.weights.shape
        for key, cut in (("dividends", (slice(e), slice(v))),
                         ("bonds", (slice(e), slice(v), slice(m))),
                         ("incentives", (slice(e), slice(m)))):
            torch.testing.assert_close(got[key][i][cut].cpu(), ref[key][i][cut], atol=ATOL,
                                       rtol=RTOL, msg=lambda msg: f"lane {i} {key}: {msg}")
    with pytest.raises(ValueError, match="no per-scenario miner masks"):
        simulate_batch(*padded[:4], config, spec, miner_mask=padded[4],
                       epoch_impl="fused_varying")


def test_chart_cli_on_card(cuda, tmp_path):
    """The chart CLI on the card (where matplotlib is installed):
    `--bond-penalty 0.5 --cases "Case 1"` simulates through K3 (9
    launches) and writes 36 PNG images."""
    pytest.importorskip("matplotlib")
    from yuma_simulation_tpu_torch.cli.charts_table_generator import main

    reset_launch_counts()
    seconds = main(["--bond-penalty", "0.5", "--cases", "Case 1", "--out-dir", str(tmp_path)])
    assert list(seconds) == ["0.5"]
    assert launch_counts()["varying_scan"] == 9
    html = (tmp_path / "simulation_results_b0.5.html").read_text()
    assert html.count('<img src="data:image/png;base64,') == 36


# ---------------------------------------------------------------------------
# long runs: streamed, generated, the preflight


def _stream_scenario(E=24, V=32, M=300, seed=5, reset=(7, 10)):
    from yuma_simulation_tpu_torch.scenarios.base import Scenario

    rng = np.random.default_rng(seed)
    W = rng.random((E, V, M)).astype(np.float32)
    W[W < 0.6] = 0.0
    S = (rng.random((E, V)) + 0.01).astype(np.float32)
    return Scenario(name="stream", validators=[f"v{i}" for i in range(V)], base_validator="v0",
                    weights=W, stakes=S, num_epochs=E, reset_bonds_index=reset[0],
                    reset_bonds_epoch=reset[1])


@pytest.mark.parametrize("slabs", [(8, 8, 8), (7, 7, 10)], ids=["even", "ragged"])
@pytest.mark.parametrize("impl,counter", [("auto", "varying_scan"), ("fused_scan", "case_scan")],
                         ids=["K3", "K2"])
@pytest.mark.parametrize("version", ["Yuma 1 (paper)", "Yuma 2 (Adrian-Fish)",
                                     "Yuma 3.1 (Rhef+reset)",
                                     "Yuma 4 (Rhef+relative bonds) - liquid alpha on"])
def test_streamed_bitwise_monolithic_on_card(cuda, version, impl, counter, slabs):
    """`simulate_streamed` through the double buffer (pinned staging, side
    stream copies) bitwise the monolithic run on K3 and K2, every output
    and the final carry, one scan launch a slab; the reset at epoch 10
    falls in the second slab, and the ragged slabs run K3 at tiles 7, 7, 10."""
    from yuma_simulation_tpu_torch.simulation.engine import simulate_streamed

    scen = _stream_scenario()
    params = dict(VERSIONS)[version]
    config = YumaConfig(yuma_params=params)
    kw = dict(save_bonds=True, save_incentives=True, save_consensus=True, epoch_impl=impl,
              return_state=True)
    mono = simulate(scen, version, config, **kw)
    bounds = np.cumsum((0,) + slabs)
    chunks = [(scen.weights[a:b], scen.stakes[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    reset_launch_counts()
    got = simulate_streamed(chunks, version, config, reset_bonds_index=7, reset_bonds_epoch=10,
                            **kw)
    assert launch_counts()[counter] == len(slabs), launch_counts()
    assert got.engine == mono.engine != "eager"
    for key in ("dividends", "bonds", "incentives", "consensus"):
        np.testing.assert_array_equal(getattr(got, key), getattr(mono, key), err_msg=key)
    for key, value in mono.final_state.items():
        np.testing.assert_array_equal(got.final_state[key], value, err_msg=key)
    capped = simulate(scen, version, config, max_resident_epochs=slabs[0], **kw)
    np.testing.assert_array_equal(capped.dividends, mono.dividends)


def test_stream_timeline_on_card(cuda):
    """A stream of four host slabs under `stream_timeline()`: one copy and
    one scan timed a slab, the copy time that ran while a scan ran at most
    either side's sum, the card's busy time within the span, and the
    result bitwise the same stream run without the timeline."""
    from yuma_simulation_tpu_torch.simulation.engine import simulate_streamed, stream_timeline

    scen = _stream_scenario()
    chunks = [(scen.weights[a:a + 6], scen.stakes[a:a + 6]) for a in range(0, 24, 6)]
    plain = simulate_streamed(chunks, "Yuma 1 (paper)")
    with stream_timeline() as timeline:
        timed = simulate_streamed(chunks, "Yuma 1 (paper)")
        torch.cuda.synchronize()
    np.testing.assert_array_equal(timed.dividends, plain.dividends)
    got = timeline.summary()
    assert got["slabs"] == len(timeline.copies) == 4 and len(timeline.hidden) == 3, got
    assert 0 <= got["copy_scan_overlap_ms"] <= min(got["copy_ms"], got["scan_ms"]) + 1e-3, got
    assert 0 < got["busy_ms"] <= got["span_ms"] + 1e-3, got
    assert got["fill_s"] > 0 and got["wait_s"] >= 0, got


def test_preflight_refuses_before_allocating(cuda):
    """A (20000, 256, 4096) stack (84 GB, a broadcast view: no host
    memory) is refused with a `max_resident_epochs` suggestion, and
    nothing is allocated on the card."""
    from yuma_simulation_tpu_torch.scenarios.base import Scenario
    from yuma_simulation_tpu_torch.telemetry.cost import HBMPreflightError

    E, V, M = 20000, 256, 4096
    row = np.full((1, V, M), 1.0 / M, np.float32)
    huge = Scenario(name="huge", validators=[f"v{i}" for i in range(V)], base_validator="v0",
                    weights=np.broadcast_to(row, (E, V, M)),
                    stakes=np.broadcast_to(np.ones((1, V), np.float32), (E, V)), num_epochs=E)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with pytest.raises(HBMPreflightError, match=r"max_resident_epochs<=\d+"):
        simulate(huge, "Yuma 1 (paper)")
    assert torch.cuda.memory_allocated() == before


def test_simulate_generated_on_card(cuda):
    """Chunks drawn on the card by a CUDA generator seeded per chunk:
    `simulate_generated` bitwise the monolithic run of the concatenated
    chunks (K3), one launch a chunk."""
    from yuma_simulation_tpu_torch.scenarios.base import Scenario
    from yuma_simulation_tpu_torch.simulation.engine import simulate_generated

    CH, V, M, n = 16, 32, 300, 3

    def gen(i):
        g = torch.Generator(device=cuda)
        g.manual_seed(100 + i)
        W = torch.rand((CH, V, M), generator=g, device=cuda)
        return torch.where(W > 0.7, W, torch.zeros_like(W)), torch.rand(
            (CH, V), generator=g, device=cuda) + 0.01

    for version in ("Yuma 1 (paper)", "Yuma 2 (Adrian-Fish)"):
        reset_launch_counts()
        d, b = simulate_generated(gen, n, version)
        assert launch_counts()["varying_scan"] == n, launch_counts()
        W = torch.cat([gen(i)[0] for i in range(n)]).cpu().numpy()
        S = torch.cat([gen(i)[1] for i in range(n)]).cpu().numpy()
        mono = simulate(Scenario(name="g", validators=[f"v{i}" for i in range(V)],
                                 base_validator="v0", weights=W, stakes=S, num_epochs=CH * n),
                        version, return_state=True)
        np.testing.assert_array_equal(d, mono.dividends)
        np.testing.assert_array_equal(b, mono.final_state["bonds"])


def test_stream_under_tiny_device_spec_reslices_bitwise(cuda, monkeypatch):
    """Under a `YUMA_TPU_DEVICE_SPEC` override sized so the plan caps slabs
    at 3 epochs, one 24-epoch chunk runs as 8 slabs of 3 (8 K3 launches),
    bitwise the monolithic run made without the override."""
    import json

    from yuma_simulation_tpu_torch.simulation.engine import simulate_streamed
    from yuma_simulation_tpu_torch.simulation.planner import plan_dispatch, scan_scratch_bytes
    from yuma_simulation_tpu_torch.telemetry.cost import DEVICE_SPEC_ENV, estimate_hbm_bytes

    scen = _stream_scenario()
    E, V, M = scen.weights.shape
    version = "Yuma 3.1 (Rhef+reset)"
    mono = simulate(scen, version, save_bonds=False, save_incentives=False)
    scratch = scan_scratch_bytes("fused_varying", V, M)
    fixed = estimate_hbm_bytes(V, M, scratch_bytes=scratch).total_bytes
    per_epoch = estimate_hbm_bytes(V, M, resident_epochs=1, scratch_bytes=scratch).total_bytes - fixed
    memory = int((fixed + 7 * per_epoch) / 0.92)
    monkeypatch.setenv(DEVICE_SPEC_ENV, json.dumps({"name": "tiny", "memory_bytes": memory}))
    plan = plan_dispatch("t", (E, V, M), version, YumaConfig(), torch.float32, streaming=True)
    assert plan.engine == "fused_varying" and plan.memory.chunk_epochs == 3, plan.memory
    reset_launch_counts()
    got = simulate_streamed([(scen.weights, scen.stakes)], version, reset_bonds_index=7,
                            reset_bonds_epoch=10)
    assert launch_counts()["varying_scan"] == 8, launch_counts()
    np.testing.assert_array_equal(got.dividends, mono.dividends)


# ---------------------------------------------------------------------------
# the Monte-Carlo path: K7, the batched driver, the one-device mesh


@pytest.mark.parametrize("B,CH,V,M,lo", [(3, 6, 4, 8, 0), (2, 5, 7, 33, 70000),
                                        (4, 16, 16, 300, 2**16 + 5)])
def test_k7_bitwise_plain(cuda, B, CH, V, M, lo):
    """K7 (csrc/mc_weights.cu) bitwise its plain version
    (random.py::perturbed_weights), epochs past 2^16 included, base
    weights with zeros (the relu clips), one launch a call."""
    from yuma_simulation_tpu_torch import random as R
    from yuma_simulation_tpu_torch.ops.cuda_random import mc_weights

    g = torch.Generator().manual_seed(B * V + M)
    base = torch.rand((V, M), generator=g)
    base[base < 0.2] = 0.0
    keys = R.split(R.split(R.PRNGKey(5), 1)[0], B)
    reset_launch_counts()
    got = mc_weights(keys.to(cuda), lo, CH, base.to(cuda), 0.3)
    assert launch_counts()["mc_weights"] == 1
    ref = R.perturbed_weights(keys, lo, CH, base, 0.3)
    assert torch.equal(got.cpu(), ref)
    out = torch.empty((B, CH, V, M), device=cuda)
    assert mc_weights(keys.to(cuda), lo, CH, base.to(cuda), 0.3, out=out) is out
    assert torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("version", ["Yuma 1 (paper)", "Yuma 2 (Adrian-Fish)",
                                     "Yuma 3.1 (Rhef+reset)"])
def test_montecarlo_per_epoch_chunk_invariant_on_card(cuda, version):
    """The per-epoch Monte-Carlo through K7 + K3 (auto): one launch of each
    a chunk, chunks of 4 and 8 bitwise a single chunk of 16 (K3 composes
    across calls), and within the class of the plain versions on the CPU."""
    from yuma_simulation_tpu_torch import random as R
    from yuma_simulation_tpu_torch.parallel import montecarlo_per_epoch_batched

    g = torch.Generator().manual_seed(4)
    base, stakes = torch.rand((8, 64), generator=g), torch.rand((8,), generator=g) + 0.1
    kw = dict(base_weights=base, base_stakes=stakes, consensus_impl="bisect")
    runs = {}
    for chunk in (16, 8, 4):
        reset_launch_counts()
        runs[chunk] = montecarlo_per_epoch_batched(R.PRNGKey(9), 3, 16, 8, 64, version,
                                                   chunk_epochs=chunk, **kw)
        counts = launch_counts()
        assert counts["varying_scan"] == 16 // chunk == counts["mc_weights"], counts
    np.testing.assert_array_equal(runs[8], runs[16])
    np.testing.assert_array_equal(runs[4], runs[16])
    cpu = montecarlo_per_epoch_batched(R.PRNGKey(9), 3, 16, 8, 64, version, chunk_epochs=16,
                                       epoch_impl="fused_varying", device="cpu", **kw)
    np.testing.assert_allclose(runs[16], cpu, atol=ATOL, rtol=RTOL)


def test_sharded_batch_one_device_mesh_bitwise(cuda):
    """`simulate_batch_sharded` over the card's one-device mesh is its
    `simulate_batch`, bitwise (K3, one launch)."""
    from yuma_simulation_tpu_torch.parallel import make_mesh, simulate_batch_sharded
    from yuma_simulation_tpu_torch.scenarios import get_cases
    from yuma_simulation_tpu_torch.simulation.sweep import simulate_batch, stack_scenarios

    cases = get_cases()[:5]
    mesh = make_mesh()
    assert mesh.size == torch.cuda.device_count()
    reset_launch_counts()
    out = simulate_batch_sharded(cases, "Yuma 2 (Adrian-Fish)", mesh=make_mesh(1, devices=[cuda]),
                                 save_bonds=True)
    assert launch_counts()["varying_scan"] == 1
    W, S, ri, re_ = stack_scenarios(cases)
    ref = simulate_batch(W, S, ri, re_, YumaConfig(), variant_for_version("Yuma 2 (Adrian-Fish)"),
                         save_bonds=True)
    for key in ("dividends", "bonds"):
        np.testing.assert_array_equal(out[key], ref[key].cpu().numpy(), err_msg=key)


# ---------------------------------------------------------------------------
# telemetry: numerics sketches, the profiler range, the device sample


def _sketches_bitwise(got: dict, ref: dict, label: str):
    bad = sketch_mismatches(got, ref)
    assert not bad, (label, bad)


@pytest.mark.parametrize("save_consensus", [False, True], ids=["dividends", "with-consensus"])
@pytest.mark.parametrize("impl,counter", [("auto", "varying_scan"), ("fused_scan", "case_scan")],
                         ids=["K3", "K2"])
def test_numerics_on_card_bitwise_host_sketch(cuda, impl, counter, save_consensus):
    """The sketches a run on the card returns (computed on the card from
    the rung's outputs) are bitwise the CPU sketches of the same outputs
    copied to the host; the stream set is JAX's fused rungs' (the
    consensus only when saved); a one-ulp flip of one dividend cell moves
    its epoch's fingerprint by exactly one."""
    from yuma_simulation_tpu_torch.ops.fingerprint import flip_ulp, ulp_delta
    from yuma_simulation_tpu_torch.telemetry.numerics import sketch_over_epochs, to_host

    scen = _stream_scenario()
    reset_launch_counts()
    r = simulate(scen, "Yuma 1 (paper)", epoch_impl=impl, save_consensus=save_consensus)
    assert launch_counts()[counter] == 1, launch_counts()
    streams = {"dividends": r.dividends}
    if save_consensus:
        streams["consensus"] = r.consensus
    _sketches_bitwise(r.numerics, host_sketches(streams), impl)
    D = torch.tensor(r.dividends, device=cuda)
    e, v = 5, int(torch.argmax(D[5]))
    flipped = D.clone()
    flipped[e, v] = flip_ulp(flipped[e, v])
    a = to_host({"d": sketch_over_epochs(D, 0)})["d"].fingerprint
    b = to_host({"d": sketch_over_epochs(flipped, 0)})["d"].fingerprint
    assert [ulp_delta(x, y) for x, y in zip(a, b)] == [int(i == e) for i in range(len(a))]


def test_streamed_numerics_bitwise_monolithic_on_card(cuda):
    """K3 in slabs of 7 (ragged) through `max_resident_epochs`: the
    numerics are bitwise the monolithic run's; the eager rung with K1 sketches
    the consensus too, bitwise the CPU sketch of its saved consensus."""
    scen = _stream_scenario()
    mono = simulate(scen, "Yuma 2 (Adrian-Fish)")
    reset_launch_counts()
    stream = simulate(scen, "Yuma 2 (Adrian-Fish)", max_resident_epochs=7)
    assert launch_counts()["varying_scan"] == 4, launch_counts()
    _sketches_bitwise(stream.numerics, mono.numerics, "streamed")
    eager = simulate(scen, "Yuma 1 (paper)", epoch_impl="eager", consensus_impl="kernel",
                     save_consensus=True)
    _sketches_bitwise(eager.numerics, host_sketches(
        {"dividends": eager.dividends, "consensus": eager.consensus}), "eager")


def test_profile_trace_range_holds_k3_kernels(cuda, tmp_path):
    """Under `profile_trace`, inside a span: the Chrome trace holds the
    `simulate:fused_varying` range, every K3 phase kernel was launched
    inside it and (where the trace has the range on the card) ran inside
    it; the dispatch's step number is on the span; the dispatch table has
    the run's (rung, bucket, "gpu") key; the device sample has a peak."""
    from yuma_simulation_tpu_torch.simulation.planner import bucket_shape
    from yuma_simulation_tpu_torch.telemetry import (
        dispatch_snapshot,
        ensure_run,
        sample_device_telemetry,
        span,
    )
    from yuma_simulation_tpu_torch.utils.profiling import (
        profile_trace,
        trace_range_windows,
        within,
    )

    scen = _stream_scenario()
    simulate(scen, "Yuma 1 (paper)")
    with ensure_run() as run, span("profiled") as s, profile_trace(str(tmp_path)):
        r = simulate(scen, "Yuma 1 (paper)")
        torch.cuda.synchronize()
    assert r.engine == "fused_varying" and s.attrs["steps"] and s.attrs["plan"]["engine"] == r.engine
    assert [rec["name"] for rec in run.span_records()] == ["profiled"]
    win = trace_range_windows(str(tmp_path / "trace.json"), "simulate:fused_varying")
    assert win["cpu"] and win["kernels"]
    for name, on_card, launch in win["kernels"]:
        assert within(launch, win["cpu"]), name
        if win["gpu"]:
            assert within(on_card, win["gpu"]), name
    E, V, M = scen.weights.shape
    key = f"fused_varying|{bucket_shape(V, M, epochs=E).key}|gpu"
    assert dispatch_snapshot()[key]["dispatches"] >= 2
    sample = sample_device_telemetry()
    assert sample["backend"] == "gpu" and sample["device_peak_bytes"] > 0


# ---------------------------------------------------------------------------
# the kernel-library cache (ops/_build.py, simulation/aot.py) and the foundry

#: A child process that loads every library through the cache at
#: `$YUMA_TORCH_BUILD_DIR` (compiling nothing when `warm`), runs K3 on a
#: fixed input and prints the cache's counters and a sha256 of K3's output.
CACHE_CHILD = """
import hashlib, json, sys
import numpy as np, torch
from yuma_simulation_tpu_torch.ops import _build
from yuma_simulation_tpu_torch.ops.cuda_epoch import fused_varying_scan
if sys.argv[1] == "warm":
    def refuse(jobs):
        raise AssertionError(f"nvcc started for {sorted(jobs)}")
    _build._compile_all = refuse
for src in _build.SOURCES:
    _build.load(src)
rng = np.random.default_rng(3)
W = torch.tensor(rng.random((8, 16, 256)), dtype=torch.float32, device="cuda")
S = torch.tensor(rng.random((8, 16)) + 0.01, dtype=torch.float32, device="cuda")
out = fused_varying_scan(W, S, epoch_tile=4, save_bonds=False, save_incentives=False)
digest = hashlib.sha256(out["dividends_normalized"].cpu().numpy().tobytes()).hexdigest()
print(json.dumps(dict(stats=_build.active_cache().stats_payload(), k3=digest)))
"""


def _cache_child(root, mode):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c", CACHE_CHILD, mode], capture_output=True, text=True, timeout=600,
        cwd=repo, env={**os.environ, "YUMA_TORCH_BUILD_DIR": str(root),
                       "PYTHONPATH": str(repo)},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cache_warm_process_compiles_nothing_and_a_corrupt_library_is_rebuilt(cuda, tmp_path):
    """A cold process builds every library; a warm one loads them all and
    starts no compile; a truncated library is a "corrupt" miss, rebuilt
    alone, and K3 runs bitwise as before."""
    import json

    from yuma_simulation_tpu_torch.ops import _build

    n = len(_build.SOURCES)
    cold = _cache_child(tmp_path, "cold")
    assert (cold["stats"]["builds"], cold["stats"]["miss_reasons"]) == (n, {"absent": n})
    warm = _cache_child(tmp_path, "warm")
    assert (warm["stats"]["hits"], warm["stats"]["builds"], warm["stats"]["misses"]) == (n, 0, 0)
    assert warm["k3"] == cold["k3"]
    entry = next(tmp_path.glob("case_scan-*"))
    meta = json.loads((entry / f"{warm['stats']['env_key']}.json").read_text())
    blob = entry / meta["blob"]
    blob.write_bytes(blob.read_bytes()[:1000])
    again = _cache_child(tmp_path, "rebuild")
    assert again["stats"]["miss_reasons"] == {"corrupt": 1}
    assert (again["stats"]["builds"], again["stats"]["hits"]) == (1, n - 1)
    assert again["k3"] == cold["k3"]


def test_preload_shapes_builds_launches_and_raises_on_a_failed_build(cuda, tmp_path,
                                                                     monkeypatch):
    from yuma_simulation_tpu_torch.ops import _build
    from yuma_simulation_tpu_torch.simulation.aot import configure_executable_cache, preload_shapes

    reset_launch_counts()
    assert preload_shapes([(16, 8, 128), (40, 3, 2)]) == 2
    assert preload_shapes([(16, 8, 128)], batch=3) == 1
    assert launch_counts()["varying_scan"] == 3
    _build.deactivate_executable_cache()
    try:
        configure_executable_cache(tmp_path)
        monkeypatch.setattr(_build, "_compile_all",
                            lambda jobs: {src: (1, "ptxas fatal : forced") for src in jobs})
        with pytest.raises(RuntimeError, match="nvcc .* failed"):
            preload_shapes([(16, 8, 128)])
        assert _build.active_cache().stats.errors == len(_build.SOURCES)
    finally:
        _build.deactivate_executable_cache()


def test_attach_executable_runs_the_rung(cuda):
    from yuma_simulation_tpu_torch.simulation.planner import plan_dispatch

    case = create_case("Case 3")
    plan = plan_dispatch("t", case.weights.shape, "Yuma 1 (paper)", YumaConfig(), torch.float32,
                         device="cuda")
    exe = plan.attach_executable().executable
    assert exe.source in ("cache", "built") and plan.engine == "fused_varying"
    W = torch.tensor(case.weights, device="cuda")
    S = torch.tensor(case.stakes, device="cuda")
    reset_launch_counts()
    ys = exe.call(W, S, -1, -1, YumaConfig())
    assert launch_counts()["varying_scan"] == 1
    ref = simulate(case, "Yuma 1 (paper)", save_bonds=False, save_incentives=False)
    np.testing.assert_array_equal(ys["dividends"].cpu().numpy(), ref.dividends)


def test_foundry_batch_route_on_k3(cuda):
    """A same-shaped generated population: the batch route is one K3
    launch, each lane bitwise its solo `simulate`; the supervised route
    runs the eager rung (its quarantine default), each lane bitwise its
    solo eager run; the two rungs, and the CPU, within ATOL."""
    from yuma_simulation_tpu_torch.foundry import run_montecarlo, weight_copier_scenario

    suite = [weight_copier_scenario(s, num_miners=4, num_epochs=16).scenario for s in range(4)]
    for version in ("Yuma 1 (paper)", "Yuma 3 (Rhef)", "Yuma 4 (Rhef+relative bonds)"):
        reset_launch_counts()
        k3 = run_montecarlo(suite, version)["dividends"]
        assert launch_counts()["varying_scan"] == 1
        sup = run_montecarlo(suite, version, route="supervised")
        assert sup["report"].engines_used == ("eager",)
        assert launch_counts()["varying_scan"] == 1
        cpu = run_montecarlo(suite, version, device="cpu")["dividends"]
        for i, s in enumerate(suite):
            np.testing.assert_array_equal(k3[i], simulate(s, version).dividends)
            np.testing.assert_array_equal(
                sup["dividends"][i], simulate(s, version, epoch_impl="eager").dividends)
        np.testing.assert_allclose(k3, sup["dividends"], atol=ATOL, rtol=0)
        np.testing.assert_allclose(k3, cpu, atol=ATOL, rtol=0)


def test_foundry_drill_on_the_card(cuda, tmp_path):
    from yuma_simulation_tpu_torch.foundry.__main__ import main
    from yuma_simulation_tpu_torch.telemetry import check_bundle, load_bundle

    assert main(["--drill", "--bundle-dir", str(tmp_path / "b")]) == 0
    assert check_bundle(load_bundle(tmp_path / "b")) == []


# ---------------------------------------------------------------------------
# miner-axis sharding, the fleet fabric and the ops plane


@pytest.mark.parametrize("version", ["Yuma 1 (paper)", "Yuma 1 (paper) - liquid alpha on",
                                     "Yuma 3.1 (Rhef+reset)", "Yuma 4 (Rhef+relative bonds)"])
def test_miner_sharded_simulate_bitwise_unsharded_on_card(cuda, version):
    """`simulate(mesh=)` on [1, 2] and [1, 4] meshes of the one card is
    bitwise the unsharded eager run on every saved stream, and launches no
    kernel. 256 miners: 128 and 64 a shard."""
    import dataclasses

    from yuma_simulation_tpu_torch.parallel import MeshDevice, make_mesh
    from yuma_simulation_tpu_torch.scenarios.synthetic import random_subnet_scenario

    scen = dataclasses.replace(
        random_subnet_scenario(4, num_validators=24, num_miners=256, num_epochs=8),
        reset_bonds_index=5, reset_bonds_epoch=4)
    params = dict(canonical_versions())[version]
    cfg = YumaConfig(yuma_params=params)
    kw = dict(save_bonds=True, save_incentives=True, save_consensus=True)
    ref = simulate(scen, version, cfg, epoch_impl="eager", **kw)
    for n in (2, 4):
        mesh = make_mesh(data=1, model=n, devices=[MeshDevice(i, cuda) for i in range(n)])
        reset_launch_counts()
        got = simulate(scen, version, cfg, mesh=mesh, **kw)
        assert sum(launch_counts().values()) == 0
        for name in ("dividends", "bonds", "incentives", "consensus"):
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name),
                                          err_msg=f"x{n} {name}")


def test_fleet_batch_on_k3_counts_launches(cuda, tmp_path):
    """`run_fleet_batch` with a supervisor that runs K3: one launch a unit,
    each lane bitwise its solo `simulate`; a second call on the store
    launches nothing."""
    from yuma_simulation_tpu_torch.fabric import FleetConfig, run_fleet_batch
    from yuma_simulation_tpu_torch.foundry import weight_copier_scenario
    from yuma_simulation_tpu_torch.resilience import SweepSupervisor

    suite = [weight_copier_scenario(s, num_miners=8, num_epochs=16).scenario for s in range(6)]
    sup = SweepSupervisor(directory=None, quarantine=False, engine="fused_varying")
    reset_launch_counts()
    out = run_fleet_batch(suite, "Yuma 1 (paper)",
                          FleetConfig(directory=tmp_path, unit_size=2), supervisor=sup)
    assert launch_counts()["varying_scan"] == 3
    assert out["report"].units_published == 3 and out["report"].clean
    for i, s in enumerate(suite):
        np.testing.assert_array_equal(out["dividends"][i],
                                      simulate(s, "Yuma 1 (paper)").dividends)
    reset_launch_counts()
    again = run_fleet_batch(suite, "Yuma 1 (paper)",
                            FleetConfig(directory=tmp_path, unit_size=2, host_id="late"),
                            supervisor=sup)
    assert sum(launch_counts().values()) == 0 and again["host"].units_published == 0
    np.testing.assert_array_equal(again["dividends"], out["dividends"])


def test_profile_session_trace_holds_k3_kernels(cuda, tmp_path):
    """An ops-plane `ProfileSession` window (its profiler on its own
    thread) over a K3 dispatch: the trace holds K3's phase kernels; the
    window is registered in profiles.jsonl; `profile_trace` refuses while
    it is open. Then a memory snapshot, pickled and registered."""
    import json

    from yuma_simulation_tpu_torch.telemetry.ops import ProfileBusyError, ProfileSession
    from yuma_simulation_tpu_torch.utils.profiling import profile_trace

    scen = _stream_scenario()
    simulate(scen, "Yuma 1 (paper)")
    session = ProfileSession(tmp_path)
    session.start(60.0)
    try:
        with pytest.raises(ProfileBusyError):
            with profile_trace(str(tmp_path / "second")):
                pass
        W = torch.rand(16, 64, device=cuda)
        S = torch.rand(16, device=cuda) + 0.1
        for _ in range(15):  # uncounted: a late window may drop its first records
            stake_weighted_median_cuda(W / W.sum(1, keepdim=True), S / S.sum(), 0.5)
        r = simulate(scen, "Yuma 1 (paper)")
        torch.cuda.synchronize()
    finally:
        record = session.stop()
    assert r.engine == "fused_varying"
    with open(f"{record['artifact']}/trace.json") as f:
        names = [ev["name"] for ev in json.load(f)["traceEvents"] if ev.get("cat") == "kernel"]
    for kernel in ("k_rank", "k_bond", "k_incentive"):
        assert any(kernel in n for n in names), (kernel, sorted(set(names))[:20])
    assert (tmp_path / "profiles.jsonl").read_text().count("profile_published") == 1
    # The memory mode: one snapshot of the caching allocator, registered.
    import pickle

    snap = session.start(1.0, mode="memory")
    with open(snap["artifact"], "rb") as f:
        assert "segments" in pickle.load(f)
    assert (tmp_path / "profiles.jsonl").read_text().count("profile_published") == 2


def test_fleet_drill_on_the_card(cuda, tmp_path):
    """`run_drill` with its four host processes on the card: the healthy
    lanes bitwise the oracle's, every unit published once, the fleet gate
    clean (the drill raises otherwise)."""
    from yuma_simulation_tpu_torch.fabric.simhost import run_drill

    out = run_drill(tmp_path / "drill", device="cuda", timeout=400.0)
    report = out["report"]
    assert report.units_published == report.num_units == 5
    assert "crash-host" in report.hosts_lost and report.units_stolen >= 1


def _serve_payloads(n, E, V, M, seed=0):
    from yuma_simulation_tpu_torch.scenarios.synthetic import random_subnet_scenario

    scens = [random_subnet_scenario(seed + i, num_validators=V, num_miners=M, num_epochs=E)
             for i in range(n)]
    return scens, [{"tenant": f"t{i}", "weights": s.weights, "stakes": s.stakes,
                    "quarantine": False} for i, s in enumerate(scens)]


def test_serve_coalesced_k3_batch_bitwise_solo(cuda):
    """Four `quarantine: false` requests of one shape, queued before the
    dispatcher starts, ride ONE K3 launch; each lane is bitwise its solo
    `simulate` on K3. A default request lands on the eager rung (no
    launch); a `fused_scan_mxu` request launches K2 with K4, bitwise the
    solo K2 run."""
    import threading
    import time

    from yuma_simulation_tpu_torch.serve import ServeConfig, SimulationService

    scens, payloads = _serve_payloads(4, 12, 16, 64)
    svc = SimulationService(ServeConfig(device="cuda", coalesce_window_seconds=0.05,
                                        start_dispatcher=False))
    try:
        results = {}
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, svc.handle("simulate", payloads[i]))) for i in range(4)]
        for th in threads:
            th.start()
        for _ in range(200):
            if len(svc.queue) == 4:
                break
            time.sleep(0.02)
        reset_launch_counts()
        svc.start_dispatcher()
        for th in threads:
            th.join(timeout=120)
        assert launch_counts()["varying_scan"] == 1, launch_counts()
        for i, s in enumerate(scens):
            status, body, _ = results[i]
            assert status == 200 and body["coalesced"] == 4, body
            assert body["engine"] == "fused_varying"
            solo = simulate(s, "Yuma 1 (paper)")
            assert solo.engine == "fused_varying"
            np.testing.assert_array_equal(np.asarray(body["dividends"], np.float32),
                                          solo.dividends)
        reset_launch_counts()
        status, body, _ = svc.handle("simulate", {"weights": scens[0].weights,
                                                  "stakes": scens[0].stakes})
        assert status == 200 and body["engine"] == "eager"
        assert sum(launch_counts().values()) == 0
        np.testing.assert_allclose(np.asarray(body["dividends"], np.float32),
                                   simulate(scens[0], "Yuma 1 (paper)").dividends,
                                   atol=ATOL, rtol=0)
        reset_launch_counts()
        status, body, _ = svc.handle("simulate", dict(payloads[0], engine="fused_scan_mxu"))
        counts = launch_counts()
        assert status == 200 and counts["case_scan"] == 1 and counts["support_mma"] > 0
        np.testing.assert_array_equal(
            np.asarray(body["dividends"], np.float32),
            simulate(scens[0], "Yuma 1 (paper)", epoch_impl="fused_scan").dividends)
    finally:
        svc.close()


def test_whatif_hit_bitwise_miss_and_uncached_on_k2(cuda, tmp_path):
    """A served what-if on the card: the miss builds the baseline on K2
    (the varying rung's pinned twin) in stride segments, the hit
    re-simulates only the suffix, and both are bitwise the uncached run
    of the perturbed world on K2."""
    import dataclasses

    from yuma_simulation_tpu_torch.replay import (
        ReplayService,
        SnapshotArchive,
        WhatIfSpec,
        run_whatif,
        synthetic_timeline,
    )
    from yuma_simulation_tpu_torch.replay.whatif import apply_arrays

    arch = SnapshotArchive(tmp_path / "archive")
    synthetic_timeline(arch, 5, snapshots=5, seed=3, num_validators=16, num_miners=64)
    svc = ReplayService(tmp_path / "archive", tmp_path / "cache", epochs_per_snapshot=4,
                        stride=4, device="cuda")
    spec = WhatIfSpec(netuid=5, version="Yuma 1 (paper)", from_epoch=13,
                      stake_scale=((1, 2.0),))
    reset_launch_counts()
    miss = svc.whatif(spec)
    assert launch_counts()["case_scan"] == 6 and launch_counts()["varying_scan"] == 0
    reset_launch_counts()
    hit = svc.whatif(spec)
    assert launch_counts()["case_scan"] == 1
    assert (miss.cache_hit, hit.cache_hit, hit.resume_epoch, hit.epochs_simulated) == (
        False, True, 12, 8)
    meta = svc.cache.meta(hit.baseline_key)
    assert meta.engine == "fused_scan"
    scenario = svc._window_scenario(5, meta.scenario_fingerprint)
    uncached = run_whatif(svc.cache, meta, scenario, None, spec, use_cache=False,
                          device="cuda")
    W2, S2 = apply_arrays(scenario.weights, scenario.stakes, spec)
    whole = simulate(dataclasses.replace(scenario, weights=W2, stakes=S2), "Yuma 1 (paper)",
                     epoch_impl="fused_scan")
    for got in (miss, hit):
        np.testing.assert_array_equal(got.dividends, uncached.dividends)
        np.testing.assert_array_equal(got.dividend_delta, uncached.dividend_delta)
        np.testing.assert_array_equal(got.incentives, uncached.incentives)
    np.testing.assert_array_equal(uncached.dividends, whole.dividends)


# ---------------------------------------------------------------------------
# the multi-process tier: router, workers, the kernel-library cache across
# processes


def _cache_children(root, modes):
    """Start one CACHE_CHILD process per mode together on the library
    cache at `root`; return each one's counters and K3 digest."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    env = {**os.environ, "YUMA_TORCH_BUILD_DIR": str(root), "PYTHONPATH": str(repo)}
    procs = [subprocess.Popen([sys.executable, "-c", CACHE_CHILD, mode], cwd=repo, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for mode in modes]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


def test_two_cold_processes_build_each_library_once(cuda, tmp_path):
    """Two processes cold-started together on one empty library cache both
    load every library and run K3 bitwise alike; the root's build lock
    makes each library built once between them."""
    from yuma_simulation_tpu_torch.ops import _build

    n = len(_build.SOURCES)
    a, b = _cache_children(tmp_path, ["cold", "cold"])
    assert a["stats"]["builds"] + b["stats"]["builds"] == n, (a["stats"], b["stats"])
    assert a["stats"]["builds"] + a["stats"]["hits"] == n == b["stats"]["builds"] + b["stats"][
        "hits"]
    assert a["k3"] == b["k3"]


def _pool_worker(pool, extra):
    ad = pool.spawn(extra_argv=extra)
    assert ad["alive"], ad
    return ad


def test_worker_spawned_warm_reports_zero_builds(cuda, tmp_path):
    """A worker spawned on an empty shared cache builds every library as
    it warms a K3 shape; the next worker on the same cache builds none."""
    from yuma_simulation_tpu_torch.ops import _build
    from yuma_simulation_tpu_torch.serve import WorkerPool

    pool = WorkerPool(tmp_path / "pool", max_slots=2, device="cuda", spawn_wait_seconds=300)
    extra = ["--executable-cache", str(tmp_path / "cache"), "--warmup", "8x16x256"]
    try:
        cold = _pool_worker(pool, extra)
        warm = _pool_worker(pool, extra)
        assert cold["aot_builds"] == len(_build.SOURCES) and warm["aot_builds"] == 0
    finally:
        pool.close()


def test_router_one_worker_whatif_bitwise_in_process(cuda, tmp_path):
    """A router with one worker on the card answers a full-width what-if
    (a miss that builds the K2 baseline, then the hit) bitwise the
    in-process ReplayService, with the router's baseline key the
    worker's."""
    from yuma_simulation_tpu_torch.replay import (
        ReplayService,
        SnapshotArchive,
        WhatIfSpec,
        synthetic_timeline,
    )
    from yuma_simulation_tpu_torch.serve import (
        RouterConfig,
        RouterService,
        SimulationClient,
        SimulationServer,
        wait_until_ready,
    )

    synthetic_timeline(SnapshotArchive(tmp_path / "archive"), 4, snapshots=3, seed=2)
    spec = {"netuid": 4, "version": "Yuma 1 (paper)", "from_epoch": 9,
            "stake_scale": [[1, 2.0]]}
    ref = ReplayService(tmp_path / "archive", tmp_path / "ref-cache", epochs_per_snapshot=4,
                        stride=4, device="cuda").whatif(WhatIfSpec.from_json(spec))
    router = RouterService(RouterConfig(
        pool_dir=str(tmp_path / "pool"), workers=1, max_workers=1, device="cuda",
        worker_args=("--replay-archive", str(tmp_path / "archive"), "--replay-cache",
                     str(tmp_path / "cache"), "--replay-epochs-per-snapshot", "4",
                     "--replay-stride", "4"),
        replay_archive_dir=str(tmp_path / "archive"),
        replay_cache_dir=str(tmp_path / "router-cache"), replay_epochs_per_snapshot=4,
        replay_stride=4, spawn_wait_seconds=300, forward_timeout=300))
    front = SimulationServer(service=router)
    try:
        router.start_workers()
        front.start()
        assert wait_until_ready(front.url)
        client = SimulationClient(front.url, tenant="t", timeout=300)
        miss, hit = client.whatif(spec), client.whatif(spec)
        assert miss.status == hit.status == 200, (miss.body, hit.body)
        assert (miss.body["cache_hit"], hit.body["cache_hit"]) == (False, True)
        assert miss.body["baseline_key"] == ref.baseline_key == hit.body["baseline_key"]
        for got in (miss, hit):
            np.testing.assert_array_equal(
                np.asarray(got.body["total_dividend_delta"], np.float32),
                ref.total_dividend_delta.astype(np.float32))
            assert got.body["total_dividend_delta"] == miss.body["total_dividend_delta"]
    finally:
        front.close()

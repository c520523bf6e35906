"""The scaled throughput path of the port against the JAX package: K5
(`fused_ema_scan`), K6 (`fused_ema_epoch`) and K4's plain version (the
exact limb-split support), and the entry points `simulate_scaled`,
`simulate_scaled_batch` and `simulate_constant`, on identical numpy inputs
made from a seed. JAX's Pallas kernels run with `interpret=True` (as
tests/unit/test_fused_epoch.py runs them) and its engines jitted; on CPU
tensors the port runs its kernels' plain versions.

Tolerances: K5 and K6 within atol 2e-6 / rtol 1e-5 of JAX (the JAX
package's fused-vs-XLA tolerance); the entry points' fused rungs within
1e-6 of JAX's fused rungs and the eager rung within 2e-6 of JAX's XLA rung
(the JAX package's own fused-vs-XLA reduction-order bound), with rtol 1e-5
on the bonds, whose capacity model runs at the 2^64 scale. K4 and every
`mxu` spelling are
bitwise their plain integer counterparts, and the two EMA_PREV spellings
(`recompute_prev`) bitwise each other. The JAX session runs with x64 on
(tests/conftest.py), which the port matches with `x64=True`.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yuma_simulation_tpu.models.config import YumaConfig as JConfig
from yuma_simulation_tpu.models.config import YumaParams as JParams
from yuma_simulation_tpu.models.epoch import BondsMode as JBondsMode
from yuma_simulation_tpu.models.variants import variant_for_version as j_variant
from yuma_simulation_tpu.ops.consensus import support_fixed_stakes as j_fixed_stakes
from yuma_simulation_tpu.ops.pallas_epoch import _stake_limb_split as j_limb_split
from yuma_simulation_tpu.ops.pallas_epoch import _support_limbs_mxu as j_support_limbs
from yuma_simulation_tpu.ops.pallas_epoch import fused_ema_epoch as j_ema_epoch
from yuma_simulation_tpu.ops.pallas_epoch import fused_ema_scan as j_ema_scan
from yuma_simulation_tpu.simulation import engine as j_engine
from yuma_simulation_tpu_torch.models.config import (
    SimulationHyperparameters,
    YumaConfig,
    YumaParams,
)
from yuma_simulation_tpu_torch.models.epoch import BondsMode
from yuma_simulation_tpu_torch.models.variants import variant_for_version
from yuma_simulation_tpu_torch.ops.consensus import (
    stake_limb_split,
    stake_weighted_median,
    support_fixed_stakes,
    support_limbs,
)
from yuma_simulation_tpu_torch.ops.cuda_epoch import fused_ema_epoch, fused_ema_scan
from yuma_simulation_tpu_torch.ops.normalize import normalize_weight_rows
from yuma_simulation_tpu_torch.simulation.engine import (
    simulate_constant,
    simulate_scaled,
    simulate_scaled_batch,
)
from yuma_simulation_tpu_torch.simulation.planner import resolve_scaled_engine

ATOL, RTOL = 2e-6, 1e-5
V, M, E, BB = 6, 18, 8, 2
LIQUID4 = dict(liquid_alpha=True, bond_alpha=0.025, alpha_high=0.99, alpha_low=0.9)
# The five bond models; liquid alpha on two of them, with both quantile
# overrides on the relative model (with near-constant weights the EMA
# families sit at their bond fixed point, where the rate cannot show).
VERSIONS = [
    ("Yuma 0 (subtensor)", {}),
    ("Yuma 1 (paper) - liquid alpha on", dict(liquid_alpha=True)),
    ("Yuma 2 (Adrian-Fish)", {}),
    ("Yuma 3.2 (Rhef+conditional)", {}),
    ("Yuma 4 (Rhef+relative bonds) - liquid alpha on",
     dict(LIQUID4, override_consensus_high=0.03, override_consensus_low=0.001)),
]
IDS = ["yuma0", "yuma1-liquid", "yuma2", "yuma32", "yuma4-liquid-overrides"]
HP_KEYS = ("kappa", "bond_penalty", "bond_alpha", "capacity_alpha", "decay_rate",
           "liquid_alpha", "alpha_low", "alpha_high", "override_consensus_high",
           "override_consensus_low")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    W = rng.random((BB, V, M)).astype(np.float32)
    W[W < 0.3] = 0.0
    S = (rng.random((BB, V)) + 0.01).astype(np.float32)
    S_n = (S / S.sum(-1, keepdims=True)).astype(np.float32)
    scales = (1.0 + 1e-4 * rng.random(E)).astype(np.float32)
    return W, S, S_n, scales


W_NP, S_NP, SN_NP, SCALES_NP = _inputs()


def _hparams(params):
    cfg = YumaConfig(yuma_params=YumaParams(**params))
    return {k: getattr(cfg, k) for k in HP_KEYS}


@pytest.fixture(scope="module")
def jax_scan():
    """JAX `fused_ema_scan` (interpret mode) per (version, batched, mxu),
    computed once for the module."""

    @functools.lru_cache(maxsize=None)
    def ref(version, batched, mxu):
        params = dict(VERSIONS)[version]
        W, S_n = (W_NP, SN_NP) if batched else (W_NP[0], SN_NP[0])
        b, d = j_ema_scan(
            jnp.asarray(W), jnp.asarray(S_n), jnp.asarray(SCALES_NP),
            mode=j_variant(version).bonds_mode, mxu=mxu, interpret=True,
            **_hparams(params),
        )
        return np.asarray(b), np.asarray(d)

    return ref


def _close(got, ref, label, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=rtol,
                               err_msg=label)


def _equal(a, b, label):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=label)


# ---------------------------------------------------------------------------
# K5: fused_ema_scan


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("version,params", VERSIONS, ids=IDS)
def test_ema_scan_matches_jax(jax_scan, version, params, batched):
    """The plain K5 with `mxu` False and True against JAX's VPU scan
    (single) and MXU scan (batched); the port's two spellings bitwise."""
    W, S_n = (W_NP, SN_NP) if batched else (W_NP[0], SN_NP[0])
    mode = variant_for_version(version).bonds_mode
    outs = {}
    for mxu in (False, True):
        outs[mxu] = fused_ema_scan(
            torch.tensor(W), torch.tensor(S_n), torch.tensor(SCALES_NP), mode=mode,
            mxu=mxu, x64=True, **_hparams(params),
        )
    jb, jd = jax_scan(version, batched, batched)
    for mxu, (b, d) in outs.items():
        assert b.shape == jb.shape and d.shape == jd.shape
        _close(b, jb, f"{version} bonds mxu={mxu}")
        _close(d, jd, f"{version} D_n total mxu={mxu}")
    for x, y in zip(outs[True], outs[False]):
        _equal(x, y, f"{version}: mxu bitwise VPU")


def test_ema_scan_liquid_overrides_take_effect(jax_scan):
    """The overrides reach the kernel: with them the bonds move away from
    the no-override run (so the agreement above is not vacuous)."""
    version, params = VERSIONS[4]
    mode = variant_for_version(version).bonds_mode
    plain = dict(params, override_consensus_high=None, override_consensus_low=None)
    args = (torch.tensor(W_NP[0]), torch.tensor(SN_NP[0]), torch.tensor(SCALES_NP))
    b0, _ = fused_ema_scan(*args, mode=mode, **_hparams(plain))
    b1, _ = fused_ema_scan(*args, mode=mode, **_hparams(params))
    assert float((b1 - b0).abs().max()) > 1e-4


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_ema_scan_recompute_prev_bitwise(batched):
    """EMA_PREV's two spellings: the previous W_n carried, or re-derived
    from W * scales[e-1] - bitwise the same, at tiles 1 (E=17), 2 and 8
    (the tile is the largest divisor of E up to 16)."""
    W, S_n = (W_NP, SN_NP) if batched else (W_NP[0], SN_NP[0])
    scales = torch.tensor(1.0 + 1e-4 * np.random.default_rng(3).random(17), dtype=torch.float32)
    for n in (17, 2, 8):
        args = (torch.tensor(W), torch.tensor(S_n), scales[:n])
        ref = fused_ema_scan(*args, mode=BondsMode.EMA_PREV, recompute_prev=False)
        got = fused_ema_scan(*args, mode=BondsMode.EMA_PREV, recompute_prev=True)
        for x, y in zip(got, ref):
            _equal(x, y, f"E={n}")


# ---------------------------------------------------------------------------
# K6: fused_ema_epoch


def _epoch_case(seed):
    rng = np.random.default_rng(seed)
    W = rng.random((V, M)).astype(np.float32)
    W[W < 0.3] = 0.0
    S = (rng.random(V) + 0.01).astype(np.float32)
    S_n = (S / S.sum()).astype(np.float32)
    B0 = (rng.random((V, M)) * 0.1).astype(np.float32)
    clip = rng.random((V, M)).astype(np.float32)
    clip = (clip / (clip.sum(-1, keepdims=True) + np.float32(1e-6))).astype(np.float32)
    return W, S_n, B0, clip


@pytest.mark.parametrize("first", [False, True], ids=["later", "first"])
@pytest.mark.parametrize(
    "mode,with_clip",
    [("EMA", False), ("EMA_RUST", False), ("EMA_PREV", False), ("EMA_PREV", True)],
    ids=["ema", "ema-rust", "ema-prev", "ema-prev-clip"],
)
def test_ema_epoch_matches_jax(mode, with_clip, first):
    W, S_n, B0, clip = _epoch_case(3)
    kw = dict(w_scale=1.0001, kappa=0.5, bond_penalty=0.7, bond_alpha=0.1,
              first_epoch=first)
    jb, jd, ji = j_ema_epoch(
        jnp.asarray(W), jnp.asarray(S_n), jnp.asarray(B0),
        clip_base=jnp.asarray(clip) if with_clip else None,
        mode=getattr(JBondsMode, mode), interpret=True, **kw,
    )
    for mxu in (False, True):
        got = fused_ema_epoch(
            torch.tensor(W), torch.tensor(S_n), torch.tensor(B0),
            clip_base=torch.tensor(clip) if with_clip else None,
            mode=getattr(BondsMode, mode), mxu=mxu, x64=True, **kw,
        )
        for g, r, key in zip(got, (jb, jd, ji), ("bonds", "D_n", "incentive")):
            _close(g, r, f"{mode} clip={with_clip} first={first} mxu={mxu} {key}")


def test_ema_epoch_m_real_matches_jax():
    """Padded dead columns from `m_real` on leave the real miners' results
    as they are, in JAX and in the port alike."""
    W, S_n, B0, _ = _epoch_case(4)
    pad = 5
    W_p = np.concatenate([W, np.zeros((V, pad), np.float32)], axis=1)
    B_p = np.concatenate([B0, np.zeros((V, pad), np.float32)], axis=1)
    kw = dict(kappa=0.5, bond_penalty=1.0, bond_alpha=0.1, first_epoch=False)
    jb, jd, ji = j_ema_epoch(jnp.asarray(W_p), jnp.asarray(S_n), jnp.asarray(B_p), m_real=M,
                             interpret=True, **kw)
    got = fused_ema_epoch(torch.tensor(W_p), torch.tensor(S_n), torch.tensor(B_p), m_real=M,
                          **kw)
    for g, r in zip(got, (jb, jd, ji)):
        _close(g, r, "m_real")
    unpadded = fused_ema_epoch(torch.tensor(W), torch.tensor(S_n), torch.tensor(B0), **kw)
    _equal(got[0][:, :M], unpadded[0], "bonds")
    _equal(got[1], unpadded[1], "D_n")
    _equal(got[2][:M], unpadded[2], "incentive")


# ---------------------------------------------------------------------------
# the entry points, each rung against JAX's same rung

JAX_RUNG = {"eager": "xla"}
SCALED_CASES = [
    (VERSIONS[0], "eager"), (VERSIONS[0], "fused"), (VERSIONS[0], "fused_scan"),
    (VERSIONS[2], "eager"), (VERSIONS[2], "fused"), (VERSIONS[2], "fused_mxu"),
    (VERSIONS[2], "fused_scan"), (VERSIONS[2], "fused_scan_mxu"),
    (VERSIONS[3], "eager"), (VERSIONS[3], "fused_scan"),
    (VERSIONS[4], "eager"), (VERSIONS[4], "fused_scan_mxu"),
]


def _assert_totals(got, ref, rung, label):
    tol = 2e-6 if rung == "eager" else 1e-6
    t, b = (np.asarray(x) for x in got)
    jt, jb = (np.asarray(x) for x in ref)
    assert t.shape == jt.shape and b.shape == jb.shape, label
    _close(t, jt, f"{label} totals", atol=tol, rtol=0)
    _close(b, jb, f"{label} bonds", atol=tol, rtol=RTOL)


@pytest.mark.parametrize(
    "version,params,rung",
    [(v, p, r) for (v, p), r in SCALED_CASES],
    ids=[f"{IDS[VERSIONS.index(vp)]}-{r}" for vp, r in SCALED_CASES],
)
def test_simulate_scaled_matches_jax(version, params, rung):
    ref = j_engine.simulate_scaled(
        jnp.asarray(W_NP[0]), jnp.asarray(S_NP[0]), jnp.asarray(SCALES_NP),
        JConfig(yuma_params=JParams(**params)), j_variant(version),
        epoch_impl=JAX_RUNG.get(rung, rung),
    )
    got = simulate_scaled(
        torch.tensor(W_NP[0]), torch.tensor(S_NP[0]), torch.tensor(SCALES_NP),
        YumaConfig(yuma_params=YumaParams(**params)), variant_for_version(version),
        epoch_impl=rung, x64=True,
    )
    _assert_totals(got, ref, rung, f"{version} {rung}")


@pytest.mark.parametrize("rung", ["eager", "fused_scan", "fused_scan_mxu"])
@pytest.mark.parametrize("version,params", [VERSIONS[2], VERSIONS[4]], ids=[IDS[2], IDS[4]])
def test_simulate_scaled_batch_matches_jax(version, params, rung):
    ref = j_engine.simulate_scaled_batch(
        jnp.asarray(W_NP), jnp.asarray(S_NP), jnp.asarray(SCALES_NP),
        JConfig(yuma_params=JParams(**params)), j_variant(version),
        epoch_impl=JAX_RUNG.get(rung, rung),
    )
    got = simulate_scaled_batch(
        torch.tensor(W_NP), torch.tensor(S_NP), torch.tensor(SCALES_NP),
        YumaConfig(yuma_params=YumaParams(**params)), variant_for_version(version),
        epoch_impl=rung, x64=True,
    )
    _assert_totals(got, ref, rung, f"batch {version} {rung}")


@pytest.mark.parametrize("hoist", [False, True], ids=["scan", "hoisted"])
@pytest.mark.parametrize(
    "version,params", [VERSIONS[0], VERSIONS[2], VERSIONS[4]], ids=[IDS[0], IDS[2], IDS[4]]
)
def test_simulate_constant_matches_jax(version, params, hoist):
    ref = j_engine.simulate_constant(
        jnp.asarray(W_NP[0]), jnp.asarray(S_NP[0]), E,
        JConfig(yuma_params=JParams(**params)), j_variant(version), hoist_invariant=hoist,
    )
    got = simulate_constant(
        torch.tensor(W_NP[0]), torch.tensor(S_NP[0]), E,
        YumaConfig(yuma_params=YumaParams(**params)), variant_for_version(version),
        hoist_invariant=hoist, x64=True,
    )
    _assert_totals(got, ref, "eager", f"constant {version} hoist={hoist}")


def test_scaled_rungs_agree_and_auto_is_eager_on_cpu():
    """On CPU tensors `auto` is the eager rung exactly; the fused rungs'
    mxu twins are bitwise their VPU rungs; scales of 1 reproduce
    simulate_constant's scan bitwise; zero epochs give zeros."""
    W, S = torch.tensor(W_NP[0]), torch.tensor(S_NP[0])
    scales = torch.tensor(SCALES_NP)
    spec = variant_for_version("Yuma 2 (Adrian-Fish)")
    auto = simulate_scaled(W, S, scales, None, spec)
    eager = simulate_scaled(W, S, scales, None, spec, epoch_impl="eager")
    for a, b in zip(auto, eager):
        _equal(a, b, "auto vs eager")
    for rung in ("fused", "fused_scan"):
        vpu = simulate_scaled(W, S, scales, None, spec, epoch_impl=rung)
        mxu = simulate_scaled(W, S, scales, None, spec, epoch_impl=rung + "_mxu")
        for a, b in zip(vpu, mxu):
            _equal(a, b, rung)
    ones = simulate_scaled(W, S, torch.ones(E), None, spec, epoch_impl="eager")
    const = simulate_constant(W, S, E, None, spec)
    for a, b in zip(ones, const):
        _equal(a, b, "scales of one vs constant")
    t0, b0 = simulate_scaled(W, S, torch.zeros(0), None, spec)
    assert not t0.any() and not b0.any()


def test_plan_scaled_engine():
    """The scaled path's rung, now the planner's `resolve_scaled_engine`:
    the cases of the engine's former `plan_scaled_engine`, one for one;
    "xla", JAX's name of the bottom rung, now runs "eager"."""
    f32, cpu, cuda = torch.float32, torch.device("cpu"), torch.device("cuda")
    mode = variant_for_version("Yuma 1 (paper)").bonds_mode

    def plan(impl, shape=(256, 4096), dev=cuda, epochs=16, precision=100_000, **kw):
        cfg = YumaConfig(simulation=SimulationHyperparameters(consensus_precision=precision))
        return resolve_scaled_engine(shape, mode, cfg, kw.pop("dtype", f32), epochs,
                                     device=dev, epoch_impl=impl, **kw)

    assert plan("auto", dev=cpu) == "eager"
    assert plan("auto") == "fused_scan"
    assert plan("auto", (4, 256, 4096), batched=True) == "fused_scan"
    assert plan("auto", (2**14 + 1, 8)) == "fused_scan"
    assert plan("auto", (8, 16384)) == "eager"  # M * 2^17 >= 2^31
    assert plan("auto", (8, 64), precision=2**26) == "eager"
    assert plan("auto", epochs=0) == "eager"
    assert plan("auto", dtype=torch.float64) == "eager"
    assert plan("fused_mxu", dev=cpu) == "fused_mxu"
    assert plan("xla") == "eager"
    with pytest.raises(ValueError, match="unknown epoch_impl 'nope'"):
        plan("nope")
    with pytest.raises(ValueError, match="simulate_scaled_batch"):
        plan("fused", (2, 8, 16), batched=True)
    with pytest.raises(ValueError, match="unknown consensus_impl"):
        plan("auto", (8, 16), dev=cpu, epochs=4, consensus_impl="atuo")


# ---------------------------------------------------------------------------
# K4's plain version: the exact limb-split support


def _grid_case(rng, lead, V_, M_):
    """Weights on the 2^-17 dyadic grid, so midpoints hit them exactly
    (knife-edge ties for the strict `>`), and heavy-tailed stakes."""
    W = (rng.integers(0, 2**17 + 1, size=lead + (V_, M_)) * 2.0**-17).astype(np.float32)
    S = rng.lognormal(0.0, 2.0, lead + (V_,)).astype(np.float32)
    S = (S / S.sum(-1, keepdims=True)).astype(np.float32)
    return torch.tensor(W), torch.tensor(S)


@pytest.mark.parametrize("seed", range(4))
def test_limb_support_bitwise_integer_support_fuzzed(seed):
    rng = np.random.default_rng(100 + seed)
    W, S = _grid_case(rng, (3,), 37, 50)
    S_int = support_fixed_stakes(S)
    limbs = stake_limb_split(S_int)
    assert torch.equal((limbs << torch.tensor([0, 8, 16, 24]).reshape(4, 1)).sum(-2), S_int)
    for _ in range(8):
        # Midpoints drawn from the weights themselves: every comparison
        # column holds exact ties.
        mid = W[..., rng.integers(0, 37), :].unsqueeze(-2)
        mask = W > mid
        exact = torch.where(mask, S_int.unsqueeze(-1), 0).sum(-2, dtype=torch.int64)
        torch.testing.assert_close(support_limbs(limbs, mask), exact.to(torch.int32),
                                   rtol=0, atol=0)
    torch.testing.assert_close(stake_weighted_median(W, S, 0.5, mxu=True),
                               stake_weighted_median(W, S, 0.5), rtol=0, atol=0)


@pytest.mark.parametrize("V_", [512, 513, 2**14])
def test_limb_support_at_split_boundaries(V_):
    """At JAX's limb-count boundary (V = 512 / 513) and at the V = 2^14
    gate: the port's u8-limb support equals the integer support and JAX's
    bf16-limb support (`_support_limbs_mxu`), and the bisection with it
    equals the plain one."""
    rng = np.random.default_rng(V_)
    W, S = _grid_case(rng, (), V_, 4)
    mask = W > torch.tensor(0.5)
    S_int = support_fixed_stakes(S)
    got = support_limbs(stake_limb_split(S_int), mask)
    exact = torch.where(mask, S_int.unsqueeze(-1), 0).sum(-2, dtype=torch.int64)
    torch.testing.assert_close(got, exact.to(torch.int32), rtol=0, atol=0)
    j_int = j_fixed_stakes(jnp.asarray(S.numpy()))[:, None]
    rows, bits = j_limb_split(j_int, V_, jnp.float32)
    j_sup = j_support_limbs(rows, bits, jnp.asarray(mask.numpy(), jnp.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_sup)[0])
    torch.testing.assert_close(stake_weighted_median(W, S, 0.5, mxu=True),
                               stake_weighted_median(W, S, 0.5), rtol=0, atol=0)


def test_limb_split_refuses_beyond_gate():
    S_int = torch.zeros(2**14 + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="no exact MXU stake split for V=16385"):
        stake_limb_split(S_int)


# ---------------------------------------------------------------------------
# the refusals, as JAX raises them


def test_scaled_path_refusals():
    W, S_n = torch.tensor(W_NP[0]), torch.tensor(SN_NP[0])
    scales = torch.tensor(SCALES_NP)
    with pytest.raises(ValueError, match="at least one epoch"):
        fused_ema_scan(W, S_n, torch.zeros(0))
    with pytest.raises(ValueError, match="V <= 2\\^14"):
        fused_ema_scan(torch.zeros(2**14 + 1, 2), torch.zeros(2**14 + 1), scales, mxu=True)
    with pytest.raises(ValueError, match="M \\* 2\\^iters < 2\\^31"):
        fused_ema_scan(torch.zeros(2, 2**14), torch.ones(2) / 2, scales,
                       mode=BondsMode.EMA_RUST, x64=True)
    B0 = torch.zeros_like(W)
    with pytest.raises(ValueError, match="EMA family"):
        fused_ema_epoch(W, S_n, B0, mode=BondsMode.CAPACITY)
    with pytest.raises(ValueError, match="EMA_PREV"):
        fused_ema_epoch(W, S_n, B0, clip_base=normalize_weight_rows(W), mode=BondsMode.EMA)
    for m_real in (0, M + 1):
        with pytest.raises(ValueError, match="m_real must be in"):
            fused_ema_epoch(W, S_n, B0, m_real=m_real)
    with pytest.raises(ValueError, match="V <= 2\\^14"):
        fused_ema_epoch(torch.zeros(2**14 + 1, 2), torch.zeros(2**14 + 1),
                        torch.zeros(2**14 + 1, 2), mxu=True)
    S = torch.tensor(S_NP[0])
    capacity = variant_for_version("Yuma 3 (Rhef)")
    with pytest.raises(ValueError, match="EMA family only"):
        simulate_scaled(W, S, scales, None, capacity, epoch_impl="fused")
    liquid = YumaConfig(yuma_params=YumaParams(liquid_alpha=True))
    with pytest.raises(ValueError, match="liquid alpha"):
        simulate_scaled(W, S, scales, liquid, None, epoch_impl="fused_mxu")
    with pytest.raises(ValueError, match="unknown epoch_impl"):
        simulate_scaled(W, S, scales, epoch_impl="nope")
    # "xla", the JAX package's name of the bottom rung, runs the eager rung.
    for a, b in zip(simulate_scaled(W, S, scales, epoch_impl="xla"),
                    simulate_scaled(W, S, scales, epoch_impl="eager")):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown consensus_impl"):
        simulate_scaled(W, S, scales, consensus_impl="atuo", epoch_impl="fused_scan")
    with pytest.raises(ValueError, match="unknown epoch_impl"):
        simulate_scaled_batch(W[None], S[None], scales, epoch_impl="fused")
    # A config_grid grid runs through the batched entry point, one value
    # per scenario; a single scenario takes a scalar config.
    lanes = W_NP.shape[0]
    grid = YumaConfig(yuma_params=YumaParams(bond_alpha=torch.tensor([0.1] * (lanes + 1))))
    with pytest.raises(ValueError, match="one value per scenario"):
        simulate_scaled_batch(torch.tensor(W_NP), torch.tensor(S_NP), scales, grid)
    with pytest.raises(ValueError, match="scalar config"):
        simulate_scaled(W, S, scales, grid)
    with pytest.raises(ValueError, match="num_epochs >= 1"):
        simulate_constant(W, S, 0, hoist_invariant=True)

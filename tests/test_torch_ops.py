"""The port's ops against the JAX package's, on identical numpy inputs.

Tolerances: the consensus outputs (bisection `c_high`, quantized `C`, the
fixed-point stakes and dyadic denominators) must be EXACTLY equal — they
are integer-exact by construction on both sides. Float outputs (normalized
weights, liquid-alpha rates) agree within atol 2e-6 and rtol 1e-5, the
JAX package's own fused-vs-XLA tolerance: the two frameworks may sum and
round transcendental functions in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yuma_simulation_tpu.ops import consensus as jc
from yuma_simulation_tpu.ops import liquid as jl
from yuma_simulation_tpu.ops import normalize as jn
from yuma_simulation_tpu.ops.pallas_consensus import stake_weighted_median_pallas
from yuma_simulation_tpu_torch.ops import consensus as tc
from yuma_simulation_tpu_torch.ops import liquid as tl
from yuma_simulation_tpu_torch.ops import normalize as tn
from yuma_simulation_tpu_torch.ops.cuda_consensus import stake_weighted_median_cuda

ATOL, RTOL = 2e-6, 1e-5


def _normalized(seed, V=8, M=32, batch=()):
    """Row-normalized sparse weights and normalized stakes, in numpy f32."""
    rng = np.random.default_rng(seed)
    W = rng.random(batch + (V, M)).astype(np.float32)
    W[W < 0.4] = 0.0
    W = (W / (W.sum(-1, keepdims=True) + np.float32(1e-6))).astype(np.float32)
    S = (rng.random(batch + (V,)) + 0.01).astype(np.float32)
    S = (S / S.sum(-1, keepdims=True)).astype(np.float32)
    return W, S


def _t(x):
    return torch.tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(x, jnp.float32)


@pytest.mark.parametrize("M", [18, 32])
def test_normalize_matches_jax(M):
    rng = np.random.default_rng(M)
    W = rng.random((3, 8, M)).astype(np.float32)
    S = (rng.random((3, 8)) + 0.01).astype(np.float32)
    np.testing.assert_allclose(
        tn.miner_sum(_t(W)).numpy(), np.asarray(jn.miner_sum(_j(W))), atol=ATOL, rtol=RTOL
    )
    np.testing.assert_allclose(
        tn.normalize_weight_rows(_t(W)).numpy(),
        np.asarray(jn.normalize_weight_rows(_j(W))),
        atol=ATOL,
        rtol=RTOL,
    )
    np.testing.assert_allclose(
        tn.normalize_stake(_t(S)).numpy(),
        np.asarray(jn.normalize_stake(_j(S))),
        atol=ATOL,
        rtol=RTOL,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consensus_matches_jax_exactly(seed):
    W, S = _normalized(seed)
    kappa = 0.5
    ref = np.asarray(jc.stake_weighted_median(_j(W), _j(S), kappa))
    np.testing.assert_array_equal(tc.stake_weighted_median(_t(W), _t(S), kappa).numpy(), ref)
    np.testing.assert_array_equal(
        tc.stake_weighted_median_sorted(_t(W), _t(S), kappa).numpy(),
        np.asarray(jc.stake_weighted_median_sorted(_j(W), _j(S), kappa)),
    )
    np.testing.assert_array_equal(
        tc.stake_weighted_median_sorted(_t(W), _t(S), kappa).numpy(), ref
    )
    np.testing.assert_array_equal(
        tc.support_fixed_stakes(_t(S)).numpy(), np.asarray(jc.support_fixed_stakes(_j(S)))
    )
    grid = ref[None, :]
    np.testing.assert_array_equal(
        tc.dyadic_grid_denom(_t(grid), 17).numpy(),
        np.asarray(jc.dyadic_grid_denom(_j(grid), 17)),
    )


@pytest.mark.parametrize("sum_dtype", [None, "float64"], ids=["f32", "f64"])
def test_quantize_u16_matches_jax_exactly(sum_dtype):
    W, S = _normalized(5, V=6, M=24)
    C = np.asarray(jc.stake_weighted_median(_j(W), _j(S), 0.5))
    # jitted, as the JAX engines run it (see the U16_INV test below)
    quantize = jax.jit(
        lambda c: jc.quantize_u16(
            c, sum_dtype=None if sum_dtype is None else jnp.float64, grid_bits=17
        )
    )
    ref = np.asarray(quantize(_j(C)))
    got = tc.quantize_u16(
        _t(C),
        sum_dtype=None if sum_dtype is None else torch.float64,
        grid_bits=17,
    ).numpy()
    np.testing.assert_array_equal(got, ref)
    # the full C stage, as consensus_weights composes it
    np.testing.assert_array_equal(
        tc.consensus_weights(_t(W), _t(S), 0.5).numpy(),
        np.asarray(jax.jit(jc.consensus_weights)(_j(W), _j(S), 0.5)),
    )


def _knife_edge(seed, V, M):
    """Weights on the 2^-17 grid (every bisection midpoint is a grid point,
    so midpoints hit weights exactly and the strict `>` decides), half of
    them zero, a row of zeros, a zero-stake validator; normalized stakes."""
    rng = np.random.default_rng(seed)
    W = (rng.integers(0, 2**17 + 1, size=(V, M)) * 2.0**-17).astype(np.float32)
    W[rng.random(W.shape) < 0.5] = 0.0
    W[0] = 0.0
    S = rng.lognormal(0.0, 2.0, V).astype(np.float32)
    S[1] = 0.0
    return W, (S / S.sum()).astype(np.float32)


@pytest.mark.parametrize(
    "seed,V,M,grid,mxu",
    [
        pytest.param(3, 8, 32, False, False, id="3"),
        pytest.param(4, 8, 32, False, False, id="4"),
        pytest.param(5, 33, 256, True, False, id="grid-33x256"),
        pytest.param(6, 33, 256, True, True, id="grid-33x256-mxu"),
        pytest.param(7, 63, 129, True, False, id="grid-63x129"),
        pytest.param(8, 63, 129, True, True, id="grid-63x129-mxu"),
    ],
)
def test_k1_plain_matches_pallas_and_bisect_exactly(seed, V, M, grid, mxu):
    """K1's plain version (what its wrapper runs on CPU tensors; with mxu,
    K4's) against the Pallas kernel in interpret mode and the XLA
    bisection: bitwise. The card tests hold the kernels to this plain
    version, so it is held to JAX on the same knife-edge inputs: weights
    on the 2^-17 grid, V not a multiple of 32."""
    W, S = _knife_edge(seed, V, M) if grid else _normalized(seed, V=V, M=M)
    got = stake_weighted_median_cuda(_t(W), _t(S), 0.5, mma=mxu).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(stake_weighted_median_pallas(_j(W), _j(S), 0.5, interpret=True))
    )
    np.testing.assert_array_equal(got, np.asarray(jc.stake_weighted_median(_j(W), _j(S), 0.5)))


def test_k1_plain_takes_leading_batch_dims():
    W, S = _normalized(6, V=5, M=20, batch=(3,))
    got = stake_weighted_median_cuda(_t(W), _t(S), 0.5).numpy()
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], np.asarray(jc.stake_weighted_median(_j(W[i]), _j(S[i]), 0.5))
        )


@pytest.mark.parametrize(
    "overrides",
    [
        {},
        dict(override_consensus_high=0.05),
        dict(override_consensus_low=0.001),
        dict(override_consensus_high=0.05, override_consensus_low=0.001),
        dict(override_consensus_high=0.02, override_consensus_low=0.02),
    ],
    ids=["none", "high", "low", "both", "degenerate"],
)
@pytest.mark.parametrize("bounds", ["python", "tensor"])
def test_liquid_alpha_rate_matches_jax(overrides, bounds):
    W, S = _normalized(9, V=8, M=32)
    C = tc.consensus_weights(_t(W), _t(S), 0.5).numpy()
    if bounds == "python":
        args_j, args_t = (0.7, 0.9), (0.7, 0.9)
    else:
        args_j = (jnp.asarray(0.7, jnp.float32), jnp.asarray(0.9, jnp.float32))
        args_t = (torch.tensor(0.7), torch.tensor(0.9))
    ref, a_ref, b_ref = jl.liquid_alpha_rate(_j(C), *args_j, **overrides)
    got, a, b = tl.liquid_alpha_rate(_t(C), *args_t, **overrides)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), atol=ATOL, rtol=RTOL)


def test_resolve_consensus_impl():
    assert tc.resolve_consensus_impl("auto", 8, 32) == jc.resolve_consensus_impl("auto", 8, 32)
    assert tc.resolve_consensus_impl("auto", 512, 8192) == "bisect"
    assert tc.resolve_consensus_impl("kernel", 8, 32) == "kernel"
    with pytest.raises(ValueError, match="unknown consensus_impl"):
        tc.resolve_consensus_impl("atuo", 8, 32)
    assert tc.dyadic_grid_fits_int32(16383, 17) and not tc.dyadic_grid_fits_int32(16384, 17)


def test_u16_grid_divide_rounds_as_compiled_jax():
    """XLA compiles `k / 65535.0` into `k * float32(1/65535)`, which rounds
    one ulp off the true quotient for some k; the port's U16_INV multiply
    reproduces the compiled JAX engines for every u16 value."""
    k = np.arange(0, 65536, dtype=np.float32)
    compiled = np.asarray(jax.jit(lambda x: x / 65535.0)(jnp.asarray(k, jnp.float32)))
    np.testing.assert_array_equal((torch.tensor(k) * tc.U16_INV).numpy(), compiled)


@pytest.mark.parametrize("B,V,M", [(3, 3, 2), (14, 3, 2), (2, 8, 2), (3, 7, 2), (1, 5, 2),
                                   (3, 2, 2), (3, 6, 5), (14, 4, 8), (3, 9, 2), (14, 9, 2),
                                   (2, 12, 2), (3, 16, 2), (1, 12, 2)])
def test_rank_sum_bitwise_jax_batched_dot(B, V, M):
    """The rank's sum over validators bitwise XLA:CPU's batched dot (the
    JAX package's `einsum("v,vm->m")` under vmap, jitted) on random rows:
    an FMA chain, except at M = 2 with 3 <= V <= 16 over two or more lanes,
    where the dot adds its first miner column's first 8 products plainly
    and chains the rest (ROADMAP §C, C2)."""
    from yuma_simulation_tpu_torch.ops.normalize import rank_sum

    rng = np.random.default_rng(B * 100 + V * 10 + M)
    dot = jax.jit(jax.vmap(lambda s, w: jnp.einsum("v,vm->m", s, w, precision="highest")))
    for _ in range(8):
        S = rng.random((B, V)).astype(np.float32)
        S /= S.sum(1, keepdims=True)
        W = (rng.random((B, V, M)) * (rng.random((B, V, M)) > 0.3)).astype(np.float32)
        got = rank_sum(_t(S).unsqueeze(-1), _t(W), lanes=B)[:, 0].numpy()
        np.testing.assert_array_equal(got, np.asarray(dot(_j(S), _j(W))))


def test_fold_sum_is_a_register_fold():
    """`fold_sum` adds the upper half onto the lower, lane by lane: for 8
    lanes `((x0 + x4) + (x2 + x6)) + ((x1 + x5) + (x3 + x7))`."""
    from yuma_simulation_tpu_torch.ops.normalize import fold_sum

    x = torch.tensor([[1e8, 1.0, -1e8, 3.0, 0.5, 7.0, 2.0, 1e-3]])
    a = [x[0, i] for i in range(8)]
    want = ((a[0] + a[4]) + (a[2] + a[6])) + ((a[1] + a[5]) + (a[3] + a[7]))
    assert torch.equal(fold_sum(x), want.reshape(1, 1))
    assert torch.equal(fold_sum(x[:, :4]), ((a[0] + a[2]) + (a[1] + a[3])).reshape(1, 1))

"""The port's threefry (`yuma_simulation_tpu_torch/random.py`) against JAX
0.9's `jax.random` on the CPU, bit for bit: keys, splits, fold-ins, raw
bits, uniforms and normals (`erf_inv` over XLA:CPU's own `log1p` and `log`
expansions, each multiply-add one FMA where the compiled object has one);
the Monte-Carlo weight slab (kernel K7's plain version) against the JAX
package's `_montecarlo_weight_slab`; `weight_perturbation_batch` (over
XLA:CPU's `exp`) against the JAX package's. JAX runs jitted, as its
programs do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yuma_simulation_tpu.parallel.sharded import _montecarlo_weight_slab
from yuma_simulation_tpu.scenarios.synthetic import weight_perturbation_batch as j_wpb
from yuma_simulation_tpu_torch import random as R
from yuma_simulation_tpu_torch.ops.cuda_random import LAUNCHES, key_words, mc_weights
from yuma_simulation_tpu_torch.scenarios.synthetic import weight_perturbation_batch

SEEDS = [0, 5, 2**31 + 7]
SHAPES = [(7,), (3, 4, 9), (2, 3, 5, 8)]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32).view(np.int32)


def test_prng_key_is_jax_key():
    for seed in SEEDS + [1, 2**32 + 9, 2**63 - 1]:
        np.testing.assert_array_equal(_u32(R.PRNGKey(seed)), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_are_jax(seed):
    jk, pk = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    for num in (1, 2, 3, (2, 3)):
        np.testing.assert_array_equal(_u32(R.split(pk, num)), np.asarray(jax.random.split(jk, num)))
    for data in (0, 1, 17, 2**16 + 3, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(_u32(R.fold_in(pk, data)),
                                      np.asarray(jax.random.fold_in(jk, data)))
    # batched: keys [n, 2] with data [n], as the Monte-Carlo folds epochs in
    keys = R.split(pk, 4)
    got = R.fold_in(keys, torch.arange(10, 14))
    for i in range(4):
        want = jax.random.fold_in(jax.random.split(jk, 4)[i], 10 + i)
        np.testing.assert_array_equal(_u32(got[i]), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_are_jax(seed, shape):
    jk, pk = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    ranges = ((0.0, 1.0), (-0.3, 2.7), (R.NORMAL_LO, 1.0))

    @jax.jit
    def draws(k):
        return (jax.random.bits(k, shape, jnp.uint32),
                *(jax.random.uniform(k, shape, jnp.float32, lo, hi) for lo, hi in ranges),
                jax.random.normal(k, shape, jnp.float32))

    bits, *uniforms, normal = draws(jk)
    np.testing.assert_array_equal(_u32(R.random_bits(pk, shape)), np.asarray(bits))
    for (lo, hi), want in zip(ranges, uniforms):
        np.testing.assert_array_equal(_bits(R.uniform(pk, shape, lo, hi).numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(R.normal(pk, shape).numpy()), _bits(normal))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_2e16_draws_bitwise_jax(seed):
    """2^16 normal draws: every bit of JAX's (no ulp bound needed)."""
    want = jax.jit(lambda k: jax.random.normal(k, (1 << 16,), jnp.float32))(
        jax.random.PRNGKey(seed))
    np.testing.assert_array_equal(_bits(R.normal(R.PRNGKey(seed), (1 << 16,)).numpy()),
                                  _bits(want))


def test_erf_inv_bitwise_jax_with_edges():
    """`erf_inv` on 2^16 uniforms of `normal`'s range plus the edges +-1,
    `nextafter(-1, 1)`, zeros and the last float below 1."""
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(11), (1 << 16,), jnp.float32,
                                      R.NORMAL_LO, 1.0))
    edges = np.array([1.0, -1.0, R.NORMAL_LO, 0.0, -0.0, np.nextafter(np.float32(1), 0),
                      0.5, -0.5, 2.0**-30], np.float32)
    x = np.concatenate([u, edges])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(R.erf_inv(torch.from_numpy(x)).numpy()), _bits(want))


def test_xla_log1p_and_exp_bitwise_jax():
    """The `log1p` and `exp` expansions against jitted `jnp.log1p` /
    `jnp.exp` over their whole useful range, inputs and results below the
    smallest normal flushed as XLA:CPU flushes them."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        -rng.random(1 << 15, dtype=np.float32), rng.standard_normal(1 << 15).astype(np.float32),
        np.exp(rng.uniform(-80, 80, 1 << 14)).astype(np.float32),
        np.array([0.0, -0.0, -1.0, np.inf, 1e-40, -1e-40, 0.41421354, -0.41421354], np.float32),
    ])
    got = R.xla_log1p(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)  # NaN == NaN here
    np.testing.assert_array_equal(_bits(got)[~np.isnan(want)], _bits(want)[~np.isnan(want)])
    y = np.concatenate([rng.standard_normal(1 << 15).astype(np.float32) * 0.3,
                        rng.uniform(-100, 100, 1 << 14).astype(np.float32),
                        np.array([0.0, 88.7, 88.9, -87.7, -88.0, np.inf, -np.inf], np.float32)])
    np.testing.assert_array_equal(_bits(R.xla_exp(torch.from_numpy(y)).numpy()),
                                  _bits(jax.jit(jnp.exp)(jnp.asarray(y))))


@pytest.mark.parametrize("B,CH,V,M,lo,p", [(3, 6, 4, 8, 0, 0.05), (2, 5, 7, 33, 70000, 0.3),
                                           (4, 16, 16, 64, 3, 0.05)])
def test_perturbed_weights_bitwise_jax_slab(B, CH, V, M, lo, p):
    """K7's plain version is the JAX package's `_montecarlo_weight_slab`
    bit for bit (`relu(fma(erf_inv(u), p * sqrt(2), base))`, as XLA:CPU
    reassociates and contracts it), epochs past 2^16 included; on CPU
    tensors the wrapper runs it and counts no launch."""
    base = np.random.default_rng(B * CH).random((V, M)).astype(np.float32)
    jkeys = jax.random.split(jax.random.split(jax.random.PRNGKey(5), 1)[0], B)
    want = _montecarlo_weight_slab(jkeys, lo, jnp.asarray(base), jnp.asarray(p, jnp.float32),
                                   chunk_epochs=CH)
    keys = R.split(R.split(R.PRNGKey(5), 1)[0], B)
    np.testing.assert_array_equal(_u32(keys), np.asarray(jkeys))
    before = LAUNCHES.count
    got = mc_weights(keys, lo, CH, torch.from_numpy(base), p)
    assert LAUNCHES.count == before
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    out = torch.empty_like(got)
    assert mc_weights(keys, lo, CH, torch.from_numpy(base), p, out=out) is out
    assert torch.equal(out, got)


def test_key_words_are_the_uint32_words():
    keys = R.split(R.PRNGKey(2**31 + 7), 5)
    np.testing.assert_array_equal(key_words(keys).numpy().view(np.uint32), _u32(keys))


@pytest.mark.parametrize("seed,B,sigma", [(3, 4, 0.05), (0, 7, 0.3)])
def test_weight_perturbation_batch_bitwise_jax(seed, B, sigma):
    base = np.random.default_rng(seed).random((5, 9)).astype(np.float32)
    want = j_wpb(jax.random.PRNGKey(seed), jnp.asarray(base), B, sigma)
    got = weight_perturbation_batch(R.PRNGKey(seed), torch.from_numpy(base), B, sigma)
    assert got.shape == (B, 5, 9)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))

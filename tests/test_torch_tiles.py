"""K2, the port's case scan, at epoch tiles that do not divide E, against
the JAX package's Pallas `fused_case_scan` (interpret mode on the CPU), on
identical numpy inputs; and the case scan's tile choice.

The port's case scan runs its bond-independent phases over tiles of up to
16 epochs and lets the last tile take what is left; the JAX kernel steps
one epoch at a time. The plain version on CPU tensors takes the same tiles
as the kernel, so these tests pin the ragged boundary: the carried
consensus (a CONDITIONAL reset firing at a tile's first epoch), EMA_PREV's
clip base, the liquid rate and the per-epoch outputs.

Tolerances as tests/test_torch_case_scan.py: quantized consensus EXACTLY
equal; dividends, bonds and incentives within atol 2e-6 and rtol 1e-5 (the
JAX package's fused-vs-XLA tolerance). Against the port's own one-epoch
tiles: consensus and incentives bitwise, dividends and bonds within 1e-6
(the varying scan's contract).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yuma_simulation_tpu.models.variants import variant_for_version as j_variant
from yuma_simulation_tpu.ops.pallas_epoch import fused_case_scan as j_case_scan
from yuma_simulation_tpu_torch.models.variants import variant_for_version
from yuma_simulation_tpu_torch.ops import cuda_epoch
from yuma_simulation_tpu_torch.ops.cuda_epoch import (
    VARYING_EPOCH_TILE_MAX,
    case_scan_epoch_tile,
    fused_case_scan,
    varying_scan_epoch_tile,
)

ATOL, RTOL = 2e-6, 1e-5
LIQUID = dict(liquid_alpha=True)


def _suite(E, reset_epoch, seed=0, B=3, V=6, M=18):
    """A batch of 3: scenario 0 resets (ALWAYS rule) at `reset_epoch`;
    scenario 1's miner 3 loses all weight from epoch 3, so a CONDITIONAL
    reset fires at its `reset_epoch`; scenario 2 never resets."""
    rng = np.random.default_rng(seed)
    W = rng.random((B, E, V, M)).astype(np.float32)
    W[1, 3:, :, 3] = 0.0
    S = (rng.random((B, E, V)) + 0.01).astype(np.float32)
    return W, S, np.array([2, 3, -1], np.int32), np.array(reset_epoch + [-1], np.int32)


def _port_scan(W, S, ri, re_, tile, version, params):
    spec = variant_for_version(version)
    kw = cuda_epoch._scan_kwargs(
        reset_index=torch.tensor(ri), reset_epoch=torch.tensor(re_),
        reset_mode=spec.reset_mode, mode=spec.bonds_mode, save_bonds=True,
        save_incentives=True, save_consensus=True, return_carry=True, x64=True, **params,
    )
    return cuda_epoch._scan(torch.tensor(W), torch.tensor(S), varying=False, plain=False,
                            epoch_tile=tile, **kw)


@pytest.mark.parametrize(
    "version,params,E,tile,reset_epoch",
    [
        ("Yuma 3.2 (Rhef+conditional)", {}, 7, 4, [4, 5]),
        ("Yuma 2 (Adrian-Fish)", {}, 7, 4, [4, 5]),
        ("Yuma 1 (paper) - liquid alpha on", LIQUID, 7, 4, [4, 5]),
        ("Yuma 3.2 (Rhef+conditional)", {}, 17, 16, [16, 16]),
        ("Yuma 2 (Adrian-Fish)", {}, 17, 16, [4, 5]),
    ],
    ids=["conditional-7by4", "ema-prev-7by4", "liquid-7by4", "conditional-17by16",
         "ema-prev-17by16"],
)
def test_ragged_case_scan_matches_jax(version, params, E, tile, reset_epoch):
    """The plain K2 over tiles of `tile` epochs (E = 7: 4 + 3; E = 17:
    16 + 1; the resets fire at a tile's first epoch or inside one) against
    JAX's one-epoch-per-step kernel, carry included; and bitwise its own
    one-epoch tiles on consensus and incentives."""
    W, S, ri, re_ = _suite(E, reset_epoch)
    jspec = j_variant(version)
    ref = j_case_scan(
        jnp.asarray(W, jnp.float32), jnp.asarray(S, jnp.float32),
        reset_index=jnp.asarray(ri, jnp.int32), reset_epoch=jnp.asarray(re_, jnp.int32),
        reset_mode=jspec.reset_mode, mode=jspec.bonds_mode, save_bonds=True,
        save_incentives=True, save_consensus=True, return_carry=True, interpret=True,
        **params,
    )
    got = _port_scan(W, S, ri, re_, tile, version, params)
    assert set(got) == set(ref)
    for key in ref:
        g, r = got[key].numpy(), np.asarray(ref[key])
        assert g.shape == r.shape, (key, g.shape, r.shape)
        if key in ("consensus", "final_consensus"):
            np.testing.assert_array_equal(g, r, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL, err_msg=key)
    one = _port_scan(W, S, ri, re_, 1, version, params)
    for key in ("consensus", "incentives", "final_consensus"):
        torch.testing.assert_close(got[key], one[key], rtol=0, atol=0)
    for key in ("dividends_normalized", "bonds", "final_bonds"):
        torch.testing.assert_close(got[key], one[key], rtol=0, atol=1e-6)


def test_case_scan_tile_choice():
    """K2's tile: the largest up to 16 whose scratch fits half the free
    memory, dividing E or not; never 0 for E >= 1 while one epoch fits.
    K3's keeps dividing E."""
    for E in (1, 2, 7, 16, 17, 64, 1000):
        assert case_scan_epoch_tile((E, 8, 32)) == min(E, VARYING_EPOCH_TILE_MAX)
        assert case_scan_epoch_tile((3, E, 8, 32)) == min(E, VARYING_EPOCH_TILE_MAX)
    assert varying_scan_epoch_tile((17, 8, 32)) == 1
    assert varying_scan_epoch_tile((64, 8, 32)) == 16
    per_epoch = 1000
    for E in (1, 5, 17, 64):
        for fit in (1, 3, 16, 40):  # epochs whose scratch fits half the free memory
            free = 2 * fit * per_epoch + 1
            T = cuda_epoch._largest_tile(E, per_epoch, free, divides=False)
            assert T == min(E, fit, VARYING_EPOCH_TILE_MAX)
            assert T >= 1 and T * per_epoch <= free // 2
    assert cuda_epoch._largest_tile(17, per_epoch, 2 * per_epoch - 1, divides=False) == 0
    assert cuda_epoch._largest_tile(17, per_epoch, 2 * 5 * per_epoch, divides=True) == 1


def test_case_scan_takes_any_tile_and_refuses_none():
    """The case scan's entry takes a tile that does not divide E; the
    varying scan's does not."""
    W, S, _, _ = _suite(7, [4, 5])
    W, S = torch.tensor(W), torch.tensor(S)
    kw = cuda_epoch._scan_kwargs()
    got = cuda_epoch._scan(W, S, varying=False, plain=False, epoch_tile=3, **kw)
    auto = fused_case_scan(W, S)
    torch.testing.assert_close(got["dividends_normalized"], auto["dividends_normalized"],
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="epoch_tile"):
        cuda_epoch._scan(W, S, varying=True, plain=False, epoch_tile=3, **kw)
    with pytest.raises(ValueError, match="epoch_tile"):
        cuda_epoch._scan(W, S, varying=False, plain=False, epoch_tile=0, **kw)

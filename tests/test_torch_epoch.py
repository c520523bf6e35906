"""The port's `yuma_epoch` against the JAX package's, in all five bonds
modes, on identical numpy inputs.

Tolerances: quantized consensus `C` EXACTLY equal; every other output
within atol 2e-6 and rtol 1e-5 (the JAX package's fused-vs-XLA
tolerance; the frameworks sum in different orders). The JAX test session
runs with x64 on (tests/conftest.py), so JAX's Yuma 0 quantizes in
float64: the port is called with `x64=True` to match. JAX's epoch runs
jitted, as its engines run it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yuma_simulation_tpu.models import epoch as je
from yuma_simulation_tpu.models.config import YumaConfig as JConfig
from yuma_simulation_tpu.models.config import YumaParams as JParams
from yuma_simulation_tpu_torch.models import epoch as te
from yuma_simulation_tpu_torch.models import variants as tv
from yuma_simulation_tpu_torch.models.config import YumaConfig, YumaParams

ATOL, RTOL = 2e-6, 1e-5

_j_epoch = jax.jit(je.yuma_epoch, static_argnames=("bonds_mode", "first_epoch"))

CASES = [
    ("EMA_RUST", False),
    ("EMA", False),
    ("EMA", True),
    ("EMA_PREV", False),
    ("CAPACITY", False),
    ("RELATIVE", False),
    ("RELATIVE", True),
]


def _inputs(seed, V=8, M=32):
    rng = np.random.default_rng(seed)
    W = rng.random((2, V, M)).astype(np.float32)
    W[W < 0.3] = 0.0
    S = (rng.random((2, V)) + 0.01).astype(np.float32)
    return W, S


def _assert_outputs_match(got: dict, ref: dict, label: str):
    assert set(got) == set(ref), (label, sorted(set(got) ^ set(ref)))
    for key in ref:
        g, r = got[key].numpy(), np.asarray(ref[key])
        if key == "server_consensus_weight":
            np.testing.assert_array_equal(g, r, err_msg=f"{label}: {key}")
        else:
            np.testing.assert_allclose(
                g, r, atol=ATOL, rtol=RTOL, equal_nan=True, err_msg=f"{label}: {key}"
            )


@pytest.mark.parametrize("mode,liquid", CASES, ids=[f"{m}-{int(l)}" for m, l in CASES])
def test_yuma_epoch_matches_jax(mode, liquid):
    W, S = _inputs(CASES.index((mode, liquid)))
    params = dict(liquid_alpha=liquid)
    jcfg, tcfg = JConfig(yuma_params=JParams(**params)), YumaConfig(yuma_params=YumaParams(**params))
    jmode, tmode = je.BondsMode[mode], te.BondsMode[mode]
    # Epoch 0 (no carried bonds), then epoch 1 carrying JAX's epoch-0 state.
    ref0 = _j_epoch(jnp.asarray(W[0], jnp.float32), jnp.asarray(S[0], jnp.float32),
                         None, jcfg, bonds_mode=jmode)
    got0 = te.yuma_epoch(torch.tensor(W[0]), torch.tensor(S[0]), None, tcfg,
                         bonds_mode=tmode, x64=True)
    _assert_outputs_match(got0, ref0, f"{mode} epoch 0")
    key = "validator_ema_bond" if mode.startswith("EMA") else "validator_bonds"
    B_old = np.asarray(ref0[key])
    W_prev = np.asarray(ref0["weight"])
    ref1 = _j_epoch(
        jnp.asarray(W[1], jnp.float32), jnp.asarray(S[1], jnp.float32),
        jnp.asarray(B_old, jnp.float32), jcfg, bonds_mode=jmode,
        W_prev=jnp.asarray(W_prev, jnp.float32) if mode == "EMA_PREV" else None,
        first_epoch=False,
    )
    got1 = te.yuma_epoch(
        torch.tensor(W[1]), torch.tensor(S[1]), torch.tensor(B_old), tcfg,
        bonds_mode=tmode,
        W_prev=torch.tensor(W_prev) if mode == "EMA_PREV" else None,
        first_epoch=False, x64=True,
    )
    _assert_outputs_match(got1, ref1, f"{mode} epoch 1")


def test_yuma_epoch_consensus_impls_agree_bitwise():
    W, S = _inputs(11)
    outs = [
        te.yuma_epoch(torch.tensor(W[0]), torch.tensor(S[0]), consensus_impl=impl)
        for impl in ("bisect", "sorted", "kernel")
    ]
    for other in outs[1:]:
        for key in outs[0]:
            torch.testing.assert_close(other[key], outs[0][key], rtol=0, atol=0, equal_nan=True)


def test_yuma_epoch_batched_equals_per_scenario():
    """Leading batch dims (the eager rung's scenario suite) change nothing
    per scenario."""
    W, S = _inputs(12)
    cfg = YumaConfig(yuma_params=YumaParams(liquid_alpha=True))
    batch = te.yuma_epoch(torch.tensor(W), torch.tensor(S), None, cfg)
    for i in range(2):
        one = te.yuma_epoch(torch.tensor(W[i]), torch.tensor(S[i]), None, cfg)
        for key in one:
            torch.testing.assert_close(batch[key][i], one[key], rtol=0, atol=2e-7, equal_nan=True)


def test_reference_signature_wrappers_match_yuma_epoch():
    W, S = _inputs(13)
    Wt, St = torch.tensor(W[0]), torch.tensor(S[0])
    pairs = [
        (tv.YumaRust(Wt, St), te.BondsMode.EMA_RUST),
        (tv.Yuma(Wt, St), te.BondsMode.EMA),
        (tv.Yuma2(Wt, None, St), te.BondsMode.EMA_PREV),
        (tv.Yuma3(Wt, St), te.BondsMode.CAPACITY),
        (tv.Yuma4(Wt, St), te.BondsMode.RELATIVE),
    ]
    for out, mode in pairs:
        ref = te.yuma_epoch(Wt, St, bonds_mode=mode)
        for key in ref:
            torch.testing.assert_close(out[key], ref[key], rtol=0, atol=0, equal_nan=True)


def test_variants_table_matches_jax():
    from yuma_simulation_tpu.models import variants as jv

    assert list(tv.YUMA_VERSIONS) == list(jv.YUMA_VERSIONS)
    for name, spec in tv.YUMA_VERSIONS.items():
        jspec = jv.YUMA_VERSIONS[name]
        assert spec.bonds_mode.value == jspec.bonds_mode.value
        assert spec.reset_mode.value == jspec.reset_mode.value
        assert spec.bond_state_key == jspec.bond_state_key
        assert spec.carries_prev_weights == jspec.carries_prev_weights
    assert [(n, p.__dict__) for n, p in tv.canonical_versions()] == [
        (n, p.__dict__) for n, p in jv.canonical_versions()
    ]
    with pytest.raises(ValueError, match="Invalid Yuma function"):
        tv.variant_for_version("Yuma 9")

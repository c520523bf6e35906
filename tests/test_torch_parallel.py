"""Meshes, scenario-batch sharding and the Monte-Carlo drivers of the port
(`parallel/mesh.py`, `parallel/sharded.py`) against the JAX package's, on
the CPU, x64 as the other port tests.

Contracts: a mesh has JAX's shapes, errors and elastic survivor rules; a
sharded suite's lanes are bitwise the unsharded `simulate_batch`'s and
within the JAX package's reduction-order class of its XLA rung (atol
2e-6) of JAX's over its 8-device CPU mesh;
the per-epoch Monte-Carlo on the eager rung is bitwise JAX's XLA rung run
on JAX's own weight slabs (`simulate_batch` over `_montecarlo_weight_slab`,
epoch totals summed in order: the composition JAX's batched driver
streams), within the class of JAX's in-scan program, chunk-invariant
bitwise; the varying scan's plain version within the class of the eager
rung; `montecarlo_total_dividends` in both weight modes within the class
of JAX's over `mesh8`, padded and trimmed alike.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yuma_simulation_tpu.models.config import YumaConfig as JConfig
from yuma_simulation_tpu.models.variants import variant_for_version as j_variant
from yuma_simulation_tpu.parallel import mesh as jmesh
from yuma_simulation_tpu.parallel import sharded as jsharded
from yuma_simulation_tpu.scenarios import get_cases as j_get_cases
from yuma_simulation_tpu.simulation.sweep import simulate_batch as j_simulate_batch
from yuma_simulation_tpu_torch import random as R
from yuma_simulation_tpu_torch.models.config import YumaConfig
from yuma_simulation_tpu_torch.models.variants import canonical_versions, variant_for_version
from yuma_simulation_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    DistributedInitError,
    MeshDevice,
    initialize_distributed,
    make_hybrid_mesh,
    make_mesh,
    montecarlo_per_epoch_batched,
    montecarlo_total_dividends,
    simulate_batch_sharded,
    surviving_members,
    surviving_mesh,
)
from yuma_simulation_tpu_torch.scenarios import get_cases
from yuma_simulation_tpu_torch.simulation.sweep import simulate_batch, stack_scenarios
from yuma_simulation_tpu_torch.telemetry.numerics import SKETCH_FIELDS, to_host

IDS = [v for v, _ in canonical_versions()]
ATOL = 2e-6  # the JAX package's reduction-order class against its XLA rung
B, E, V, M = 3, 6, 4, 8


def _cpu_mesh(n, model=1):
    return make_mesh(devices=["cpu"] * n, model=model)


def _base(seed=9):
    rng = np.random.default_rng(seed)
    return rng.random((V, M)).astype(np.float32), (rng.random(V) + 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest provides 8 CPU devices"
    return jmesh.make_mesh()


# ---------------------------------------------------------------------------
# meshes


def test_make_mesh_shapes_and_errors():
    mesh = _cpu_mesh(8, model=2)
    assert mesh.shape == {DATA_AXIS: 4, MODEL_AXIS: 2} and mesh.size == 8
    assert mesh.devices.shape == (4, 2)
    assert [d.id for d in mesh.devices.flat] == list(range(8))
    assert mesh.data_devices() == [torch.device("cpu")] * 4
    assert _cpu_mesh(6, model=3).shape == {DATA_AXIS: 2, MODEL_AXIS: 3}
    assert make_mesh(2, 2, devices=["cpu"] * 4).shape == {DATA_AXIS: 2, MODEL_AXIS: 2}
    with pytest.raises(ValueError, match="not divisible by model=3"):
        _cpu_mesh(8, model=3)
    with pytest.raises(ValueError, match=r"mesh 3x1 != 4 devices"):
        make_mesh(3, 1, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="ids must be unique"):
        make_mesh(devices=[MeshDevice(0, torch.device("cpu"))] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_hybrid_mesh()


@pytest.mark.parametrize("lost,model", [((3,), 1), ((0, 5), 2), ((1, 2, 3, 4, 5, 6), 2),
                                        (tuple(range(7)), 1), ((2,), 4)])
def test_surviving_mesh_matches_jax(mesh8, lost, model):
    """The survivors, the shrunken shape (model width kept when it still
    divides) and the collapse to None at one survivor, as JAX's."""
    jm = jmesh.make_mesh(data=-1, model=model)
    pm = _cpu_mesh(8, model=model)
    assert [d.id for d in surviving_members(list(pm.devices.flat), lost)] == [
        d.id for d in jmesh.surviving_members(list(jm.devices.flat), lost)]
    assert surviving_members([1, 2, 3], [2]) == jmesh.surviving_members([1, 2, 3], [2])
    jout, pout = jmesh.surviving_mesh(jm, lost), surviving_mesh(pm, lost)
    if jout is None:
        assert pout is None
    else:
        assert dict(jout.shape) == pout.shape
        assert [d.id for d in jout.devices.flat] == [d.id for d in pout.devices.flat]


def test_initialize_distributed_failure_semantics(monkeypatch):
    """No arguments and no rendezvous in the environment: a single-process
    run. An explicit coordinator whose peer never joins: a typed error
    within the timeout, never a silent 1/N run."""
    import torch.distributed as dist

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    initialize_distributed()
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with pytest.raises(DistributedInitError, match="refusing to degrade"):
        initialize_distributed(f"localhost:{port}", 2, 0, initialization_timeout=2)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# simulate_batch_sharded


@pytest.mark.parametrize("version", ["Yuma 2 (Adrian-Fish)", "Yuma 3.1 (Rhef+reset)"])
def test_sharded_batch_lanes_bitwise_unsharded(mesh8, version):
    """5 built-in cases over a 4-entry CPU mesh (padded to 8, trimmed):
    every lane bitwise the unsharded `simulate_batch`, and within the
    reduction-order class of JAX's `simulate_batch_sharded` over its 8-device mesh."""
    cases = get_cases()[:5]
    out = simulate_batch_sharded(cases, version, mesh=_cpu_mesh(4), save_bonds=True, x64=True)
    W, S, ri, re_ = stack_scenarios(cases, device="cpu")
    ref = simulate_batch(W, S, ri, re_, YumaConfig(), variant_for_version(version),
                         save_bonds=True, x64=True)
    assert set(out) == {"dividends", "bonds", "numerics"}
    # The per-epoch numerics sketches, trimmed to the 5 lanes: bitwise the
    # unsharded run's.
    ref_sketches = to_host(ref.pop("numerics"))
    for stream, sk in out.pop("numerics").items():
        for f in SKETCH_FIELDS:
            assert getattr(sk, f).shape[0] == 5
            np.testing.assert_array_equal(getattr(sk, f), getattr(ref_sketches[stream], f))
    for key in out:
        assert out[key].shape[0] == 5
        np.testing.assert_array_equal(out[key], ref[key].numpy(), err_msg=key)
    want = jsharded.simulate_batch_sharded(j_get_cases()[:5], version, mesh=mesh8,
                                           save_bonds=True)
    for key in out:
        np.testing.assert_allclose(out[key], want[key], rtol=0, atol=ATOL, err_msg=key)


def test_sharded_batch_refuses_slice7_arguments():
    """The resilience tier's arguments (ported in slice 7) no longer raise:
    on a healthy run `elastic=True` walks nothing, `quarantine=True`
    reports no lane, `deadline=` only supervises, and every lane stays
    bitwise the plain sharded run's. (tests/test_torch_resilience.py drives
    the device loss and the NaN lanes.)"""
    from yuma_simulation_tpu_torch.resilience import Deadline

    cases = get_cases()[:3]
    version = "Yuma 1 (paper)"
    ref = simulate_batch_sharded(cases, version, mesh=_cpu_mesh(2))
    for kw in ({"elastic": True}, {"quarantine": True}, {"deadline": Deadline(60.0)}):
        out = simulate_batch_sharded(cases, version, mesh=_cpu_mesh(2), **kw)
        if "elastic" in kw:
            assert out.pop("mesh_degradations") == ()
        if "quarantine" in kw:
            report = out.pop("quarantine")
            assert not report and report.num_cases == 3
        np.testing.assert_array_equal(out["dividends"], ref["dividends"])


# ---------------------------------------------------------------------------
# the Monte-Carlo drivers


def _jax_slab_reference(version, bw, bs, key=3):
    """JAX's XLA rung over JAX's own weight slab of the run, the epoch
    totals summed in epoch order: what JAX's batched driver streams."""
    keys = jax.random.split(jax.random.split(jax.random.PRNGKey(key), 1)[0], B)
    W = jsharded._montecarlo_weight_slab(keys, 0, jnp.asarray(bw), jnp.asarray(0.05, jnp.float32),
                                         chunk_epochs=E)
    S = jnp.asarray(np.broadcast_to(bs, (B, E, V)).copy())
    ri = jnp.full((B,), -1, jnp.int32)
    D = np.asarray(j_simulate_batch(W, S, ri, ri, JConfig(), j_variant(version),
                                    save_bonds=False, save_incentives=False,
                                    epoch_impl="xla", consensus_impl="bisect")["dividends"])
    tot = np.zeros((B, V), np.float32)
    for e in range(E):
        tot = tot + D[:, e]
    return tot


@pytest.mark.parametrize("index", range(9), ids=IDS)
def test_montecarlo_per_epoch_matches_jax(index):
    """[B=3, E=6, V=4, M=8], every version, on the eager rung: bitwise JAX's
    XLA rung over JAX's slabs, within the class of JAX's in-scan program
    (ROADMAP §C: the two JAX programs differ by an ulp), and bitwise the
    same for any chunk length."""
    version = IDS[index]
    bw, bs = _base()
    kw = dict(base_weights=bw, base_stakes=bs, perturbation=0.05, consensus_impl="bisect",
              device="cpu", x64=True)
    got = montecarlo_per_epoch_batched(R.PRNGKey(3), B, E, V, M, version, **kw)
    assert got.shape == (B, V) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, _jax_slab_reference(version, bw, bs))
    want = jsharded.montecarlo_per_epoch_batched(
        jax.random.PRNGKey(3), B, E, V, M, version, base_weights=jnp.asarray(bw),
        base_stakes=jnp.asarray(bs), perturbation=0.05, consensus_impl="bisect")
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    for chunk in (1, 4):
        np.testing.assert_array_equal(
            montecarlo_per_epoch_batched(R.PRNGKey(3), B, E, V, M, version, chunk_epochs=chunk,
                                         **kw), got)


@pytest.mark.parametrize("version", ["Yuma 0 (subtensor)", "Yuma 2 (Adrian-Fish)",
                                     "Yuma 4 (Rhef+relative bonds) - liquid alpha on"])
def test_montecarlo_fused_plain_within_class_of_eager(version):
    """The fused rungs' path (K7's and K3's / K2's plain versions on CPU
    tensors, the carry threaded over chunks of 4 epochs) within the
    reduction-order class of the eager rung."""
    bw, bs = _base()
    kw = dict(base_weights=bw, base_stakes=bs, consensus_impl="bisect", device="cpu", x64=True)
    eager = montecarlo_per_epoch_batched(R.PRNGKey(3), B, E, V, M, version, **kw)
    for impl in ("fused_varying", "fused_scan"):
        got = montecarlo_per_epoch_batched(R.PRNGKey(3), B, E, V, M, version, epoch_impl=impl,
                                           chunk_epochs=4, **kw)
        np.testing.assert_allclose(got, eager, rtol=0, atol=ATOL, err_msg=impl)


@pytest.mark.parametrize("mode", ["constant", "per_epoch"])
def test_montecarlo_total_dividends_matches_jax(mesh8, mode):
    """Both weight modes over 8 CPU mesh entries against JAX's over
    `mesh8`: 13 scenarios padded to 16 and trimmed, the first 13 of a
    16-scenario run bitwise (`test_montecarlo_batch_pads_and_trims`'
    shape)."""
    bw, bs = _base()
    kw = dict(weights_mode=mode, base_weights=bw, base_stakes=bs, x64=True)
    got13 = montecarlo_total_dividends(R.PRNGKey(0), 13, 4, V, M, "Yuma 1 (paper)",
                                       mesh=_cpu_mesh(8), **kw)
    got16 = montecarlo_total_dividends(R.PRNGKey(0), 16, 4, V, M, "Yuma 1 (paper)",
                                       mesh=_cpu_mesh(8), **kw)
    assert got13.shape == (13, V) and np.isfinite(got13).all()
    np.testing.assert_array_equal(got13, got16[:13])
    want = jsharded.montecarlo_total_dividends(
        jax.random.key(0), 13, 4, V, M, "Yuma 1 (paper)", mesh=mesh8, weights_mode=mode,
        base_weights=jnp.asarray(bw), base_stakes=jnp.asarray(bs))
    np.testing.assert_allclose(got13, np.asarray(want), rtol=0, atol=ATOL)


def test_montecarlo_one_device_per_epoch_is_the_batched_driver():
    """On a one-device mesh, per-epoch "auto" is the batched driver with
    the same scenario keys; the full per-epoch run of "eager" on the
    constant weights agrees with the hoisted recurrence to the class."""
    bw, bs = _base()
    kw = dict(base_weights=bw, base_stakes=bs, consensus_impl="bisect", x64=True)
    got = montecarlo_total_dividends(R.PRNGKey(4), 5, E, V, M, "Yuma 2 (Adrian-Fish)",
                                     mesh=_cpu_mesh(1), weights_mode="per_epoch", **kw)
    np.testing.assert_array_equal(got, montecarlo_per_epoch_batched(
        R.PRNGKey(4), 5, E, V, M, "Yuma 2 (Adrian-Fish)", device="cpu", **kw))
    hoisted = montecarlo_total_dividends(R.PRNGKey(4), 5, E, V, M, "Yuma 1 (paper)",
                                         mesh=_cpu_mesh(1), **kw)
    full = montecarlo_total_dividends(R.PRNGKey(4), 5, E, V, M, "Yuma 1 (paper)",
                                      mesh=_cpu_mesh(1), epoch_impl="eager", **kw)
    np.testing.assert_allclose(hoisted, full, rtol=0, atol=ATOL)


def test_montecarlo_refusals():
    mesh = _cpu_mesh(2)
    with pytest.raises(ValueError, match="hoistable"):
        montecarlo_total_dividends(R.PRNGKey(0), 4, 4, V, M, "Yuma 1 (paper)", mesh=mesh,
                                   weights_mode="per_epoch", epoch_impl="hoisted")
    with pytest.raises(ValueError, match="weights_mode"):
        montecarlo_total_dividends(R.PRNGKey(0), 4, 4, V, M, "Yuma 1 (paper)", mesh=mesh,
                                   weights_mode="sometimes")
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            montecarlo_per_epoch_batched(R.PRNGKey(0), 2, 2, V, M, "Yuma 1 (paper)")

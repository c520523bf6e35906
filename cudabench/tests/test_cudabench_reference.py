"""The plain reference against the program's eager rung at a tiny shape on
the CPU, and the control (the reference in bfloat16) failing the limits."""

import numpy as np
import pytest
import torch

from cudabench.core import registry
from cudabench.core.program import yuma_config
from cudabench.core.snapshot import synthetic_snapshot
from cudabench.reference import bonds, threefry
from cudabench.reference import yuma as reference

CONFIGS = ("sn4096-yuma1", "sn4096-yuma4-liquid")


def _config(name):
    return registry._json(registry.ROOT / "configs" / f"{name}.json")


def test_threefry_bits_are_the_programs():
    from yuma_simulation_tpu_torch import random as program

    key = torch.tensor([12345, 2**32 - 7])
    assert torch.equal(threefry.split(key, 5), program.split(key, 5))
    keys = threefry.split(key, 3)
    assert torch.equal(threefry.fold_in(keys, 70_000), program.fold_in(keys, 70_000))
    assert torch.equal(threefry.random_bits(keys, (4, 6)), program.random_bits(keys, (4, 6)))
    ours = threefry.normal(keys, (64, 64))
    theirs = program.normal(keys, (64, 64))
    assert torch.allclose(ours, theirs, rtol=1e-5, atol=1e-6)  # erfinv, not XLA's polynomial


@pytest.mark.parametrize("name", CONFIGS)
def test_montecarlo_against_the_eager_rung(name):
    from yuma_simulation_tpu_torch.parallel.sharded import montecarlo_per_epoch_batched

    cfg = _config(name)
    W, S = synthetic_snapshot(5, num_validators=16, num_miners=64, nnz_per_row=8,
                              stake_tail=1.2, consensus_sharpness=8.0)
    key = np.array([9, 2**31 + 3], np.int64)
    port = montecarlo_per_epoch_batched(key, 4, 12, 16, 64, cfg["yuma_version"],
                                        yuma_config(cfg), base_weights=W, base_stakes=S,
                                        device="cpu")
    params = reference.params_of(cfg)
    keys = torch.tensor(np.stack([key] * 4))
    want = reference.montecarlo_totals(keys, 4, [0, 1, 2, 3], 12, torch.tensor(W),
                                       torch.tensor(S), 0.05, params, torch.float32).numpy()
    gap = np.abs(port - want).max(axis=1) / np.abs(want).max(axis=1)
    assert gap.max() < 1e-5
    control = reference.montecarlo_totals(keys, 4, [0, 1, 2, 3], 12, torch.tensor(W),
                                          torch.tensor(S), 0.05, params,
                                          torch.bfloat16).float().numpy()
    assert (np.abs(control - want).max(axis=1) / np.abs(want).max(axis=1)).max() > 1e-3


def test_scaled_run_against_the_eager_rung():
    from yuma_simulation_tpu_torch.models.variants import variant_for_version
    from yuma_simulation_tpu_torch.simulation.engine import simulate_scaled

    cfg = _config("sn4096-yuma1")
    W, S = synthetic_snapshot(6, num_validators=16, num_miners=64, nnz_per_row=8,
                              stake_tail=1.2, consensus_sharpness=8.0)
    scales = 1 + 1e-7 * torch.arange(40, dtype=torch.float32)
    total, bonds = simulate_scaled(torch.tensor(W), torch.tensor(S), scales, yuma_config(cfg),
                                   variant_for_version(cfg["yuma_version"]))
    want_total, want_bonds = reference.scaled_run(torch.tensor(W), torch.tensor(S), scales,
                                                  reference.params_of(cfg), torch.float32)
    assert torch.allclose(total.double(), want_total, rtol=1e-5, atol=0)
    assert torch.allclose(bonds, want_bonds, rtol=0, atol=1e-6)


@pytest.mark.parametrize("workload", ["mc.sn4096-yuma1", "horizon.sn4096-yuma1",
                                      "mc.sn4096-yuma4-liquid"])
def test_the_control_fails_the_limits(tiny_bench, workload):
    """The reference in bfloat16, put in the program's place, reads over
    at least one limit of the cell, at the tiny shape."""

    from cudabench.core import cell as cells

    cell = registry.cell(workload, tiny_bench)
    ctx = cells.Context(torch=torch, device=torch.device("cpu"), seed=11, config=cell.config,
                        params=cell.traffic["params"])
    state = cell.driver.setup(ctx)
    outputs = [cell.driver.call(state, i) for i in range(2)]
    gaps = cell.driver.check(state, outputs, control=torch.bfloat16)
    rows, failed, correct = cells.checks(gaps, cell.traffic["limits"])
    assert correct is False and failed
    assert any(row["value"] > row["limit"] for row in rows.values())


@pytest.mark.parametrize("name", CONFIGS)
def test_each_configuration_names_a_bonds_model(name):
    model = bonds.model(_config(name)["bonds_model"])
    assert callable(model.step) and model.OPS_PER_CELL > 0


def test_a_dropped_in_bonds_model_is_found(tmp_path, monkeypatch):
    """A bonds model added as a file is found by the name a configuration
    gives it, with no code edit."""
    for path in bonds.FOLDER.glob("*.py"):
        (tmp_path / path.name).write_text(path.read_text())
    (tmp_path / "ema_again.py").write_text((bonds.FOLDER / "ema.py").read_text())
    monkeypatch.setattr(bonds, "FOLDER", tmp_path)
    cfg = _config("sn4096-yuma1")
    W, S = synthetic_snapshot(3, num_validators=16, num_miners=64, nnz_per_row=8,
                              stake_tail=1.2, consensus_sharpness=8.0)
    scales = 1 + 1e-7 * torch.arange(6, dtype=torch.float32)
    runs = [reference.scaled_run(torch.tensor(W), torch.tensor(S), scales,
                                 reference.params_of(dict(cfg, bonds_model=m)), torch.float32)
            for m in ("ema", "ema_again")]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    with pytest.raises(KeyError):
        bonds.model("no_such_model")

"""A whole run of each cell on the CPU: the result line's shape, a run
that finds no card, the import check, and faults planted under the timed
path that `correct` must catch."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cudabench.core import registry

REPO = registry.ROOT.parent
WORKLOADS = ("mc.sn4096-yuma1", "horizon.sn4096-yuma1", "mc.sn4096-yuma4-liquid")
FORBIDDEN = {"jax", "jaxlib", "flax", "yuma_simulation_tpu", "yuma_simulation", "tools"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line(tiny_bench, run_on_cpu, workload):
    line = run_on_cpu(tiny_bench, workload)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    cell = registry.cell(workload, tiny_bench)
    assert set(line["metrics"]) == set(cell.end_to_end)
    for name, metric in line["metrics"].items():
        assert metric["unit"] == cell.end_to_end[name][0]["unit"] and metric["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for name, row in line["checks"].items():
        assert 0 <= row["value"] <= row["limit"] == cell.traffic["limits"][name]
    json.dumps(line)


def test_traced_line(tiny_bench, run_on_cpu):
    """On the CPU the trace holds no device operation: the per-layer
    metrics read nothing and report nothing, and the line keeps its shape."""
    line = run_on_cpu(tiny_bench, "mc.sn4096-yuma1", trace=True)
    assert line["metrics"] == {}
    assert line["correct"] is True and line["attempted"] == 6
    assert line["device"]["busy_s"] == 0 and line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checks"


def test_no_card_exits_without_a_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(REPO / "cudabench" / "run.py"), "--workload", "mc.sn4096-yuma1",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "metrics" not in proc.stdout and "needs 1 CUDA device" in proc.stderr


def test_harness_loads_no_jax():
    """The harness's modules, its drivers and metrics and the program paths
    they import load no module whose top-level name is JAX's or the JAX
    package's (compared whole: `yuma_simulation_tpu_torch` passes)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run; run._environment()\n"
        "from cudabench.core import registry, cell, trace, cost, snapshot\n"
        "from cudabench.reference import yuma, threefry, bonds\n"
        "bonds.model('ema'); bonds.model('relative')\n"
        "for w in ('mc.sn4096-yuma1', 'horizon.sn4096-yuma1', 'mc.sn4096-yuma4-liquid'):\n"
        "    registry.cell(w)\n"
        "from yuma_simulation_tpu_torch.parallel import sharded\n"
        "from yuma_simulation_tpu_torch.simulation import engine, sweep\n"
        "from yuma_simulation_tpu_torch.models import variants\n"
        "from yuma_simulation_tpu_torch.scenarios import base\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(REPO / "cudabench"), str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={k: v for k, v in os.environ.items()
                                            if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr
    tops = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "yuma_simulation_tpu_torch" in tops and "cudabench" in tops
    assert not tops & FORBIDDEN


def _state_unchanged(monkeypatch):
    """Every epoch step hands its bond state on unchanged."""
    from yuma_simulation_tpu_torch.parallel import sharded
    from yuma_simulation_tpu_torch.simulation import engine

    step = sharded._mc_varying_step

    def stuck_step(carry, *args, **kwargs):
        return dataclasses.replace(step(carry, *args, **kwargs), bonds=carry.bonds)

    epoch = engine.yuma_epoch

    def stuck_epoch(W, S, B_old=None, *args, **kwargs):
        res = epoch(W, S, B_old, *args, **kwargs)
        res["validator_ema_bond"] = res["validator_bonds"] = B_old
        return res

    monkeypatch.setattr(sharded, "_mc_varying_step", stuck_step)
    monkeypatch.setattr(engine, "yuma_epoch", stuck_epoch)


def _half_batch(monkeypatch):
    """The Monte-Carlo computes the first half of its scenarios and gives
    the rest their mean."""
    from yuma_simulation_tpu_torch.parallel import sharded

    run = sharded.montecarlo_per_epoch_batched

    def half(key, num_scenarios, *args, **kwargs):
        out = run(key, num_scenarios, *args, **kwargs)
        h = num_scenarios // 2
        out[h:] = out[:h].mean(axis=0)
        return out

    monkeypatch.setattr(sharded, "montecarlo_per_epoch_batched", half)


def _answer_altered(monkeypatch):
    """One validator's total dividend moved by 1% of the largest, where
    the entry point produces it."""
    from yuma_simulation_tpu_torch.parallel import sharded
    from yuma_simulation_tpu_torch.simulation import engine

    run_mc, run_scaled = sharded.montecarlo_per_epoch_batched, engine.simulate_scaled

    def mc(*args, **kwargs):
        out = run_mc(*args, **kwargs)
        out[:, 0] += 0.01 * np.abs(out).max(axis=1)
        return out

    def scaled(*args, **kwargs):
        total, bonds = run_scaled(*args, **kwargs)
        moved = total.clone()
        moved[0] += 0.01 * total.abs().max()
        return moved, bonds

    monkeypatch.setattr(sharded, "montecarlo_per_epoch_batched", mc)
    monkeypatch.setattr(engine, "simulate_scaled", scaled)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}
#: The faults each cell can have: one scenario a call in the horizon cell,
#: so no batch to halve; one chip, so no exchange between chips.
CASES = [(w, f) for w in WORKLOADS for f in FAULTS
         if not (w.startswith("horizon.") and f == "half_batch")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_planted_fault_is_not_correct(tiny_bench, run_on_cpu, monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch)
    line = run_on_cpu(tiny_bench, workload)
    assert line["correct"] is False and line["failed"] >= 1


#: Mixes for the drivers no cell uses yet (PERF.md, Open questions): each
#: runs here as a later cell would, from data alone.
LATER_MIXES = {
    "replay": {"driver": "simulate", "params": {"epochs": 12, "check_calls": 2},
               "limits": {"div_gap": 1e-4, "bond_gap": 1e-4}},
    "grid": {"driver": "sweep_scaled_fused",
             "params": {"epochs": 24, "check_points": 2,
                        "grid": {"bond_alpha": [0.05, 0.1], "kappa": [0.5, 0.6]}},
             "limits": {"div_gap": 1e-4, "bond_gap": 1e-4}},
}


@pytest.mark.parametrize("mix", sorted(LATER_MIXES))
def test_drivers_of_later_cells(tiny_bench, run_on_cpu, mix):
    (tiny_bench / "traffic" / f"{mix}.json").write_text(json.dumps(LATER_MIXES[mix]))
    bench_path = tiny_bench.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["workloads"].append({"name": f"{mix}.sn4096-yuma1", "config": "sn4096-yuma1",
                               "traffic": mix, "chips": 1, "why": "test"})
    bench_path.write_text(json.dumps(bench))
    line = run_on_cpu(tiny_bench, f"{mix}.sn4096-yuma1")
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"div_gap", "bond_gap"}

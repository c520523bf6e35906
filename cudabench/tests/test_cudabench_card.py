"""Each cell run once on the card, briefly, through `BENCHMARK.json`'s
`command`, and a fault planted in the timed path at a cell's own size.
Skips where there is no CUDA card."""

import json
import subprocess
import sys
import time

import pytest

from cudabench.core import registry

REPO = registry.ROOT.parent
MC_WORKLOADS = ("mc.sn4096-yuma1", "mc.sn4096-yuma4-liquid")
FAULT_SEEDS = (2147470001, 2147470002, 2147470003)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mc.sn4096-yuma1", "horizon.sn4096-yuma1",
                                      "mc.sn4096-yuma4-liquid"])
def test_cell_on_the_card(card, workload):
    proc = subprocess.run(
        [sys.executable, "cudabench/run.py", "--workload", workload, "--seed", "2147483659",
         "--seconds", "2", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def _carry_dropped(monkeypatch):
    """Each chunk of the Monte-Carlo's fused scan (K3 over K7's slab) hands
    on the carry it was given: the bond state never passes from one chunk
    to the next."""
    from yuma_simulation_tpu_torch.parallel import sharded

    dispatch = sharded._dispatch_case

    def dropped(*args, carry=None, return_carry=False, **kwargs):
        if not return_carry:
            return dispatch(*args, carry=carry, **kwargs)
        given = {name: value.clone() for name, value in carry.items()}
        ys, _ = dispatch(*args, carry=carry, return_carry=True, **kwargs)
        return ys, given

    monkeypatch.setattr(sharded, "_dispatch_case", dropped)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", MC_WORKLOADS)
def test_a_dropped_chunk_carry_is_not_correct_on_the_card(card, monkeypatch, workload):
    """At the cell's own size, through the fused path the window times, a
    run whose chunks drop the bond carry reads `correct: false` on each of
    three seeds (its readings are printed)."""
    import torch

    from cudabench.core import cell as cells

    monkeypatch.setenv("YUMA_TORCH_BUILD_DIR", str(registry.ROOT / ".cache" / "kernels"))
    _carry_dropped(monkeypatch)
    cell = registry.cell(workload)
    for seed in FAULT_SEEDS:
        line = cells.run(cell, seed, 2.0, False, torch, torch.device("cuda", 0),
                         time.perf_counter())
        print(f"carry dropped {workload} {seed} {json.dumps(line['checks'])}", flush=True)
        assert line["correct"] is False and line["failed"] >= 1
        torch.cuda.empty_cache()

"""Every part of the benchmark is found by its name; one dropped into the
folder with an entry in BENCHMARK.json is found with no code edit."""

import json

from cudabench.core import registry

WORKLOADS = ("mc.sn4096-yuma1", "horizon.sn4096-yuma1", "mc.sn4096-yuma4-liquid")


def test_every_cell_of_the_benchmark_resolves():
    bench = json.loads((registry.ROOT.parent / "BENCHMARK.json").read_text())
    assert [w["name"] for w in bench["workloads"]] == list(WORKLOADS)
    for name in WORKLOADS:
        cell = registry.cell(name)
        assert cell.chips == 1
        assert {"epochs_per_s", "setup_s"} <= set(cell.end_to_end)
        assert ("call_p90_ms" in cell.end_to_end) == name.startswith("horizon.")
        assert {"device_idle_pct", "kernels_per_kepoch"} <= set(cell.per_layer)
        rooflines = {m for m in cell.per_layer if m.endswith("_roofline_pct")}
        assert rooflines == ({"k5_roofline_pct"} if name.startswith("horizon.")
                             else {"k3_roofline_pct", "k7_roofline_pct"})
        for _, reader in list(cell.end_to_end.values()) + list(cell.per_layer.values()):
            assert callable(reader.read)


def test_a_dropped_in_config_traffic_and_metric_are_found(tiny_bench, run_on_cpu):
    root = tiny_bench
    cfg = json.loads((root / "configs" / "sn4096-yuma1.json").read_text())
    cfg.update(name="tiny-yuma1-kappa6")
    cfg["simulation"]["kappa"] = 0.6
    (root / "configs" / "tiny-yuma1-kappa6.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "mc.json").read_text())
    mix["params"]["epochs"] = 8
    (root / "traffic" / "mc8.json").write_text(json.dumps(mix))
    (root / "metrics" / "calls_done.py").write_text(
        "def read(window):\n    return len(window.spans) or None\n")
    bench_path = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "tiny-yuma1-kappa6", "source": "test",
                             "file": "cudabench/configs/tiny-yuma1-kappa6.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "mc8.tiny", "config": "tiny-yuma1-kappa6",
                               "traffic": "mc8", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "calls_done", "unit": "calls", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["mc8.tiny"]})
    bench_path.write_text(json.dumps(bench))
    line = run_on_cpu(root, "mc8.tiny")
    assert line["correct"] is True
    assert line["metrics"]["calls_done"]["value"] == line["attempted"] >= 1
    assert "calls_done" not in run_on_cpu(root, "mc.sn4096-yuma1")["metrics"]

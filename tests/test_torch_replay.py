"""What-if replay through the port (`replay/`: archive, state cache,
what-ifs, trailing-window sweep, and the serve tier's mount) on the CPU,
against the JAX package's.

The contracts of the JAX package's `tests/unit/test_replay.py`, each on
the port: the archive (monotone blocks, content addressing, idempotent
re-publish, no history rewrite, corruption detected), the state cache
(LRU bound, idempotent builds, nearest checkpoint, a corrupt state
degrading to a full run), what-if specs (JSON round trip, typed
rejections), the cached what-if bitwise the uncached run on every rung
the CPU runs, miss-then-hit counters, suffix-sized admission, the HTTP
endpoints and their bundle. Held against JAX: archive bytes and
fingerprints, `config_fingerprint` / `baseline_key` / `spec_key`, the
window scenario, and what-if trajectories and deltas (bitwise at the
[10, 3, 4] shape C2's pin list covers). Then `sweep_trailing_window`'s
fleet store through `tools.driftreport --check --require`.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from yuma_simulation_tpu.models.config import (
    SimulationHyperparameters as JSimulationHyperparameters,
)
from yuma_simulation_tpu.models.config import YumaConfig as JYumaConfig
from yuma_simulation_tpu.models.config import YumaParams as JYumaParams
from yuma_simulation_tpu.replay import SnapshotArchive as JSnapshotArchive
from yuma_simulation_tpu.replay import StateCache as JStateCache
from yuma_simulation_tpu.replay import WhatIfSpec as JWhatIfSpec
from yuma_simulation_tpu.replay import run_whatif as j_run_whatif
from yuma_simulation_tpu.replay import synthetic_timeline as j_synthetic_timeline
from yuma_simulation_tpu.replay.statecache import baseline_key as j_baseline_key
from yuma_simulation_tpu.replay.statecache import config_fingerprint as j_config_fingerprint
from yuma_simulation_tpu.scenarios.base import Scenario as JScenario
from yuma_simulation_tpu_torch.foundry.metagraph import synthetic_snapshot
from yuma_simulation_tpu_torch.models.config import (
    SimulationHyperparameters,
    YumaConfig,
    YumaParams,
)
from yuma_simulation_tpu_torch.replay import (
    ArchiveError,
    ReplayService,
    SnapshotArchive,
    StateCache,
    WhatIfError,
    WhatIfSpec,
    baseline_key,
    run_whatif,
    sweep_trailing_window,
    synthetic_timeline,
)
from yuma_simulation_tpu_torch.replay.statecache import config_fingerprint
from yuma_simulation_tpu_torch.scenarios.base import Scenario

NETUID = 9
VERSION = "Yuma 2 (Adrian-Fish)"
REPO = pathlib.Path(__file__).resolve().parents[1]
E, V, M = 10, 3, 4


@pytest.fixture(autouse=True)
def _fresh_slo_engine():
    from yuma_simulation_tpu_torch.telemetry import slo

    slo.set_slo_engine(None)
    yield
    slo.set_slo_engine(None)


def _archive(root, cls=SnapshotArchive, make=synthetic_timeline, snapshots=3, seed=1):
    arch = cls(root)
    make(arch, NETUID, snapshots=snapshots, seed=seed, num_validators=3, num_miners=4)
    return arch


def _arrays(seed: int):
    """The JAX package's `tests/unit/test_suffix_resume.py::_scenario`
    arrays: [10, 3, 4] random rows, normalized."""
    rng = np.random.default_rng(seed)
    W = rng.random((E, V, M)).astype(np.float32)
    W /= W.sum(axis=2, keepdims=True)
    S = (rng.random((E, V)) + 0.1).astype(np.float32)
    return W, S


def _scenario(seed: int, cls=Scenario):
    W, S = _arrays(seed)
    validators = [f"v{i}" for i in range(V)]
    return cls(name=f"suffix_resume_{seed}", validators=validators,
               base_validator=validators[0], weights=W, stakes=S, num_epochs=E)


def _cache(root, **kw):
    return StateCache(root, **kw)


def _build(cache, scenario, fingerprint, *, stride=4, engine="eager", version=VERSION):
    return cache.build_baseline(scenario, version, scenario_fingerprint=fingerprint,
                                stride=stride, engine=engine, device="cpu")


# ------------------------------------------------------------------ archive


@pytest.mark.parametrize("shape", [(3, 4), (8, 64)])
def test_archive_bytes_and_fingerprints_equal_jax(tmp_path, shape):
    """The same `synthetic_timeline` writes the same blobs, the same
    `timeline.json` and the same fingerprints in both packages, and
    compiles the same window scenario."""
    nv, nm = shape
    mine = SnapshotArchive(tmp_path / "port")
    ref = JSnapshotArchive(tmp_path / "jax")
    a = synthetic_timeline(mine, NETUID, snapshots=3, seed=4, num_validators=nv, num_miners=nm)
    b = j_synthetic_timeline(ref, NETUID, snapshots=3, seed=4, num_validators=nv, num_miners=nm)
    assert [e.to_json() for e in a] == [e.to_json() for e in b]
    port_files = sorted(p.relative_to(mine.root) for p in mine.root.rglob("*") if p.is_file())
    jax_files = sorted(p.relative_to(ref.root) for p in ref.root.rglob("*") if p.is_file())
    assert port_files == jax_files
    for rel in port_files:
        assert (mine.root / rel).read_bytes() == (ref.root / rel).read_bytes(), rel
    for window in (None, 2):
        assert (mine.timeline_fingerprint(NETUID, window=window)
                == ref.timeline_fingerprint(NETUID, window=window))
        s = mine.window_scenario(NETUID, window=window, epochs_per_snapshot=3)
        j = ref.window_scenario(NETUID, window=window, epochs_per_snapshot=3)
        np.testing.assert_array_equal(s.weights, np.asarray(j.weights))
        np.testing.assert_array_equal(s.stakes, np.asarray(j.stakes))
        assert (s.name, s.base_validator) == (j.name, j.base_validator)


def test_archive_contract(tmp_path):
    arch = _archive(tmp_path / "archive")
    entries = arch.timeline(NETUID)
    assert [e.block for e in entries] == [1000, 1100, 1200]
    assert arch.load(NETUID, 1100).num_miners == 4
    same = synthetic_snapshot(1, num_validators=3, num_miners=4, netuid=NETUID, block=1000)
    assert arch.append(same).block == 1000 and len(arch.timeline(NETUID)) == 3
    for snap, match in (
        (synthetic_snapshot(99, num_validators=3, num_miners=4, netuid=NETUID, block=1000),
         "does not rewrite"),
        (synthetic_snapshot(5, num_validators=3, num_miners=4, netuid=NETUID, block=1150),
         "append-only"),
        (synthetic_snapshot(5, num_validators=4, num_miners=4, netuid=NETUID, block=1300),
         "drifts"),
    ):
        with pytest.raises(ArchiveError, match=match):
            arch.append(snap)
    with pytest.raises(ArchiveError, match="no timeline"):
        arch.timeline(4242)
    blob = arch._blob_path(NETUID, entries[0].key)
    blob.write_bytes(b"torn" + blob.read_bytes()[4:])
    with pytest.raises(ArchiveError, match="content address"):
        arch.load(NETUID, entries[0].block)


# ------------------------------------------------------------- state cache


def test_keys_equal_jax_for_equal_fields():
    """`config_fingerprint`, `baseline_key` (the dtype spelled as numpy
    names it) and `spec_key` give JAX's digests for equal fields."""
    for sim, par in (({}, {}), ({"kappa": 0.6}, {"bond_alpha": 0.2})):
        cfg = YumaConfig(simulation=SimulationHyperparameters(**sim),
                         yuma_params=YumaParams(**par))
        jcfg = JYumaConfig(simulation=JSimulationHyperparameters(**sim),
                           yuma_params=JYumaParams(**par))
        assert config_fingerprint(cfg) == j_config_fingerprint(jcfg)
        import jax.numpy as jnp
        import torch

        from yuma_simulation_tpu_torch.replay.statecache import dtype_name

        assert dtype_name(torch.float32) == jnp.dtype(jnp.float32).name == "float32"
        fields = dict(scenario_fingerprint="fp", version=VERSION, dtype="float32",
                      epochs=20, stride=4, engine="fused_scan")
        assert baseline_key(config=cfg, **fields) == j_baseline_key(config=jcfg, **fields)
    spec = dict(netuid=3, version=VERSION, from_epoch=5, hparams=(("bond_alpha", 0.2),),
                weight_rows=((1, (0.25, 0.75, 0.0, 0.0)),), stake_scale=((0, 1.5),))
    assert WhatIfSpec(**spec).spec_key() == JWhatIfSpec(**spec).spec_key()


def test_lru_bound_idempotent_build_and_nearest_checkpoint(tmp_path):
    cache = _cache(tmp_path / "cache", max_baselines=2)
    keys = [_build(cache, _scenario(i), f"lru-{i}", version="Yuma 1 (paper)").key
            for i in range(3)]
    assert len(cache.keys()) == 2 and keys[0] not in cache.keys()
    again = _build(cache, _scenario(2), "lru-2", version="Yuma 1 (paper)")
    assert again.key == keys[2] and len(cache.keys()) == 2
    meta = _build(cache, _scenario(2), "near", stride=3)
    assert meta.checkpoints == (3, 6, 9) and meta.engine == "eager"
    assert [cache.resume_epoch(meta.key, k) for k in (2, 3, 8, 9)] == [0, 3, 6, 9]


@pytest.mark.parametrize("engine", ["eager", "fused_scan"])
def test_extend_baseline_bitwise_a_full_build(tmp_path, engine):
    """Extending a baseline by its window's new epochs publishes what a
    from-scratch build of the whole window publishes: the trajectory, the
    checkpoints and their states, bitwise (the global stride grid)."""
    scenario = _scenario(3)
    prefix = dataclasses.replace(scenario, weights=scenario.weights[:6],
                                 stakes=scenario.stakes[:6], num_epochs=6)
    suffix = dataclasses.replace(scenario, weights=scenario.weights[6:],
                                 stakes=scenario.stakes[6:], num_epochs=4)
    cache = _cache(tmp_path / "cache")
    prior = _build(cache, prefix, "window", engine=engine)
    grown = cache.extend_baseline(prior.key, suffix, scenario_fingerprint="grown",
                                  device="cpu")
    whole = _build(_cache(tmp_path / "whole"), scenario, "grown", engine=engine)
    assert grown.key == whole.key and grown.checkpoints == whole.checkpoints == (4, 8)
    full = StateCache(tmp_path / "whole")
    for key in ("dividends", "incentives"):
        np.testing.assert_array_equal(cache.load_baseline(grown.key)[key],
                                      full.load_baseline(whole.key)[key])
    for epoch in (4, 8, 10):
        a, b = cache.load_state(grown.key, epoch), full.load_state(whole.key, epoch)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_corrupt_state_degrades_to_a_full_run(tmp_path):
    scenario = _scenario(4)
    cache = _cache(tmp_path / "cache")
    meta = _build(cache, scenario, "corrupt")
    spec = WhatIfSpec(netuid=NETUID, version=VERSION, from_epoch=9, stake_scale=((0, 2.0),))
    clean = run_whatif(cache, meta, scenario, None, spec, device="cpu")
    assert clean.cache_hit and clean.resume_epoch == 8
    cache._state_path(meta.key, 8).write_bytes(b"rot")
    degraded = run_whatif(cache, meta, scenario, None, spec, device="cpu")
    assert not degraded.cache_hit and degraded.epochs_simulated == 10
    np.testing.assert_array_equal(degraded.dividends, clean.dividends)


# ------------------------------------------------------------------ what-ifs


@pytest.mark.parametrize("payload,match", [
    ({"netuid": 1, "version": VERSION}, "must perturb"),
    ({"netuid": 1, "version": VERSION, "from_epoch": -1, "stake_scale": [[0, 2.0]]},
     "from_epoch"),
    ({"netuid": 1, "version": VERSION, "hparams": [["liquid_alpha", 1.0]]},
     "not what-if-settable"),
    ({"netuid": 1, "version": VERSION, "stake_scale": [[0, -2.0]]}, "finite number"),
    ({"netuid": 1, "version": VERSION, "bogus": 1, "stake_scale": [[0, 2.0]]},
     "unknown what-if fields"),
    ({"netuid": 1, "version": VERSION, "stake_scale": [[1, "x"]]}, "stake_scale entry"),
    ({"netuid": 1, "version": VERSION, "weight_rows": [[0, 7]]}, "weight_rows entry"),
])
def test_invalid_specs_are_typed(payload, match):
    with pytest.raises(WhatIfError, match=match):
        WhatIfSpec.from_json(payload)


def test_spec_round_trip_and_apply_bounds(tmp_path):
    spec = WhatIfSpec(netuid=3, version=VERSION, from_epoch=5,
                      hparams=(("bond_alpha", 0.2),),
                      weight_rows=((1, (0.25, 0.75, 0.0, 0.0)),), stake_scale=((0, 1.5),))
    again = WhatIfSpec.from_json(json.loads(json.dumps(spec.to_json())))
    assert again == spec and again.spec_key() == spec.spec_key()
    assert dataclasses.replace(spec, from_epoch=6).spec_key() != spec.spec_key()
    scenario = _scenario(5)
    cache = _cache(tmp_path / "cache")
    meta = _build(cache, scenario, "oob")
    for bad, match in (
        (WhatIfSpec(netuid=1, version=VERSION, stake_scale=((99, 2.0),)), "out of range"),
        (WhatIfSpec(netuid=1, version=VERSION, from_epoch=10, stake_scale=((0, 2.0),)),
         "beyond"),
        (WhatIfSpec(netuid=1, version=VERSION, weight_rows=((0, (1.0, 0.0)),)), "miners"),
    ):
        with pytest.raises(WhatIfError, match=match):
            run_whatif(cache, meta, scenario, None, bad, device="cpu")


WHATIF = dict(netuid=1, version=VERSION, from_epoch=9, stake_scale=((1, 2.0),),
              hparams=(("bond_alpha", 0.15),))


@pytest.mark.parametrize("rung", ["eager", "xla", "fused_scan", "fused_scan_mxu"])
def test_whatif_cached_equals_uncached_on_every_cpu_rung(tmp_path, rung):
    """The acceptance pin: the cached suffix resume is bitwise the
    uncached end-to-end run of the same perturbed world, with an array
    perturbation and a piecewise hparam delta in play — on the eager rung
    (and its JAX name) and on the kernels' plain versions."""
    scenario = _scenario(6)
    cache = _cache(tmp_path / "cache")
    meta = _build(cache, scenario, f"rung-{rung}", engine=rung)
    spec = WhatIfSpec(**WHATIF)
    cached = run_whatif(cache, meta, scenario, YumaConfig(), spec, device="cpu")
    uncached = run_whatif(cache, meta, scenario, YumaConfig(), spec, use_cache=False,
                          device="cpu")
    assert cached.cache_hit and cached.resume_epoch == 8
    assert cached.epochs_simulated == 2 and uncached.epochs_simulated == 10
    np.testing.assert_array_equal(cached.dividends, uncached.dividends)
    np.testing.assert_array_equal(cached.incentives, uncached.incentives)


@pytest.mark.parametrize("version", ["Yuma 1 (paper)", VERSION, "Yuma 3.1 (Rhef+reset)"])
def test_whatif_matches_jax(tmp_path, version):
    """The port's cached what-if on the eager rung against JAX's on its
    XLA rung, same baseline and spec: the baselines, trajectories and
    deltas bitwise (the [10, 3, 4] shape is in C2's pin list); the
    suffix accounting the same."""
    spec_kw = dict(WHATIF, version=version)
    scenario = _scenario(8)
    cache = _cache(tmp_path / "port")
    meta = _build(cache, scenario, "vs-jax", version=version)
    mine = run_whatif(cache, meta, scenario, YumaConfig(), WhatIfSpec(**spec_kw),
                      device="cpu")
    jcache = JStateCache(tmp_path / "jax")
    jmeta = jcache.build_baseline(_scenario(8, JScenario), version,
                                  scenario_fingerprint="vs-jax", stride=4, engine="xla")
    ref = j_run_whatif(jcache, jmeta, _scenario(8, JScenario), JYumaConfig(),
                       JWhatIfSpec(**spec_kw))
    np.testing.assert_array_equal(cache.load_baseline(meta.key)["dividends"],
                                  jcache.load_baseline(jmeta.key)["dividends"])
    for key in ("dividends", "incentives", "dividend_delta", "incentive_delta"):
        np.testing.assert_array_equal(getattr(mine, key), np.asarray(getattr(ref, key)), key)
    assert (mine.cache_hit, mine.resume_epoch, mine.epochs_simulated) == (
        ref.cache_hit, ref.resume_epoch, ref.epochs_simulated)
    assert meta.checkpoints == jmeta.checkpoints


# ------------------------------------------------------------ replay service


def test_replay_service_miss_then_hit(tmp_path):
    from yuma_simulation_tpu_torch.telemetry.metrics import get_registry

    _archive(tmp_path / "archive")
    svc = ReplayService(tmp_path / "archive", tmp_path / "cache",
                        epochs_per_snapshot=4, stride=4, device="cpu")
    spec = WhatIfSpec(netuid=NETUID, version=VERSION, from_epoch=9,
                      weight_rows=((0, (1.0, 0.0, 0.0, 0.0)),))
    before = svc.describe(spec)
    assert before["cached"] is False and before["suffix_epochs"] == 12
    assert before["engine"] == "eager"
    reg = get_registry()
    counts0 = [reg.counter(n).value for n in (
        "state_cache_hits", "state_cache_misses", "replay_suffix_epochs_saved")]
    first = svc.whatif(spec)
    assert not first.cache_hit and first.epochs_simulated == 12
    second = svc.whatif(spec)
    assert second.cache_hit and second.resume_epoch == 8
    assert (second.epochs_simulated, second.epochs_saved) == (4, 8)
    np.testing.assert_array_equal(first.dividends, second.dividends)
    np.testing.assert_array_equal(first.dividend_delta, second.dividend_delta)
    assert np.abs(second.dividend_delta[:9]).max() == 0
    assert np.abs(second.dividend_delta[9:]).max() > 0
    counts1 = [reg.counter(n).value for n in (
        "state_cache_hits", "state_cache_misses", "replay_suffix_epochs_saved")]
    assert [b - a for a, b in zip(counts0, counts1)] == [1, 1, 8]
    after = svc.describe(spec)
    assert after["cached"] and (after["resume_epoch"], after["suffix_epochs"]) == (8, 4)


def test_replay_service_plans_the_pinned_rung_and_never_falls_back(monkeypatch, tmp_path):
    """Planned for the card, a what-if's baseline is keyed on K2 (the
    varying rung's pinned twin), not K3; without CUDA the default device
    raises."""
    import torch

    from yuma_simulation_tpu_torch.replay.statecache import pinned_engine

    assert [pinned_engine(e) for e in ("fused_varying", "fused_varying_mxu", "fused_scan",
                                       "eager")] == ["fused_scan", "fused_scan_mxu",
                                                     "fused_scan", "eager"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReplayService(tmp_path / "a", tmp_path / "c")


def test_admission_and_the_build_resolve_one_key(tmp_path):
    """`StateCache.resolve` decides a baseline's rung and key for admission
    (`describe`) and for the build alike: the key a miss prices is the key
    it builds, and planned for the card the same fields pin K2."""
    import torch

    _archive(tmp_path / "archive")
    svc = ReplayService(tmp_path / "archive", tmp_path / "cache",
                        epochs_per_snapshot=4, stride=4, device="cpu")
    spec = WhatIfSpec(netuid=NETUID, version=VERSION, from_epoch=5,
                      stake_scale=((1, 2.0),))
    priced = svc.describe(spec)
    shape = (priced["epochs"], priced["validators"], priced["miners"])
    config, dtype, engine, key = svc.cache.resolve(
        priced["fingerprint"], VERSION, None, None, shape, 4, torch.device("cpu"))
    assert (engine, key) == (priced["engine"], priced["key"]) == ("eager", key)
    assert config == YumaConfig() and dtype == torch.float32
    assert svc.whatif(spec).baseline_key == key
    assert svc.cache.meta(key).engine == "eager"
    _c, _d, card_engine, card_key = svc.cache.resolve(
        priced["fingerprint"], VERSION, None, None, shape, 4, "cuda")
    assert card_engine == "fused_scan" and card_key == baseline_key(
        scenario_fingerprint=priced["fingerprint"], version=VERSION, config=YumaConfig(),
        dtype="float32", epochs=shape[0], stride=4, engine="fused_scan")


@pytest.fixture
def replay_server(tmp_path):
    from yuma_simulation_tpu_torch.serve import ServeConfig, SimulationServer, wait_until_ready

    _archive(tmp_path / "archive")
    server = SimulationServer(ServeConfig(
        device="cpu", bundle_dir=str(tmp_path / "serve"),
        replay_archive_dir=str(tmp_path / "archive"),
        replay_cache_dir=str(tmp_path / "cache"),
        replay_epochs_per_snapshot=4, replay_stride=4,
    )).start()
    assert wait_until_ready(server.url)
    try:
        yield server, tmp_path
    finally:
        server.close()


def test_served_whatifs_end_to_end(replay_server):
    from yuma_simulation_tpu_torch.serve import SimulationClient

    server, tmp_path = replay_server
    client = SimulationClient(server.url, tenant="render-me", timeout=60)
    idx = client.replay()
    assert idx.status == 200 and [s["netuid"] for s in idx.body["subnets"]] == [NETUID]
    assert client.replay(NETUID).body["epochs"] == 12
    assert client.replay(777).status == 404
    spec = {"netuid": NETUID, "version": VERSION, "from_epoch": 9,
            "stake_scale": [[1, 2.0]]}
    first = client.whatif(spec)
    assert first.status == 200 and first.body["cache_hit"] is False
    second = client.whatif(spec)
    assert second.body["cache_hit"] is True and second.body["epochs_simulated"] == 4
    assert second.body["total_dividend_delta"] == first.body["total_dividend_delta"]
    for bad, reason in (
        ({"netuid": 404, "version": VERSION, "stake_scale": [[0, 2.0]]}, "unknown_subnet"),
        ({"netuid": NETUID, "version": VERSION}, "invalid_request"),
        ({"netuid": NETUID, "version": "Yuma nonesuch", "stake_scale": [[0, 2.0]]},
         "invalid_request"),
    ):
        r = client.whatif(bad)
        assert r.status == 400 and r.body["reason"] == reason
    server.close()

    from tools.obsreport import render_replay
    from yuma_simulation_tpu.telemetry.flight import check_bundle, load_bundle

    bundle = load_bundle(tmp_path / "serve")
    assert check_bundle(bundle) == []
    served = [r for r in bundle.ledger if r.get("event") == "whatif_served"]
    assert [(r["cache_hit"], r["suffix_epochs"], r["full_epochs"]) for r in served] == [
        (False, 12, 12), (True, 4, 12)]
    lines = "\n".join(render_replay(bundle))
    assert "tenant render-me" in lines and "suffix resume" in lines


def test_unconfigured_replay_rejects():
    from yuma_simulation_tpu_torch.serve import ServeConfig, SimulationService

    svc = SimulationService(ServeConfig(device="cpu", start_dispatcher=False))
    try:
        status, body, _ = svc.handle("whatif", {"whatif": {
            "netuid": 1, "version": VERSION, "stake_scale": [[0, 2.0]]}})
        assert status == 400 and body["reason"] == "replay_unconfigured"
        assert svc.replay_get("/v1/replay")[0] == 404
    finally:
        svc.close()


# --------------------------------------------------------------- the sweep


def test_sweep_trailing_window_gates_and_warms_the_cache(tmp_path):
    arch = _archive(tmp_path / "archive", seed=9)
    cache = StateCache(tmp_path / "state")
    summary = sweep_trailing_window(
        arch, cache, store_root=tmp_path / "sweeps",
        versions=["Yuma 1 (paper)", VERSION], epochs_per_snapshot=4, stride=4,
        unit_size=1, device="cpu")
    assert summary["units_completed"] == 2 and summary["drift_events"] == 0
    assert summary["canaries_run"] >= 2
    assert json.loads((tmp_path / "sweeps" / "sweep_summary.json").read_text()) == summary
    svc = ReplayService(tmp_path / "archive", tmp_path / "state", epochs_per_snapshot=4,
                        stride=4, device="cpu")
    hit = svc.whatif(WhatIfSpec(netuid=NETUID, version=VERSION, from_epoch=10,
                                stake_scale=((1, 2.0),)))
    assert (hit.cache_hit, hit.resume_epoch, hit.epochs_simulated) == (True, 8, 4)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for store in summary["stores"]:
        gate = subprocess.run(
            [sys.executable, "-m", "tools.driftreport", store, "--check", "--require"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert gate.returncode == 0, gate.stdout[-3000:] + gate.stderr[-3000:]

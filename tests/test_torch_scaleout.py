"""The horizontal serving tier of the port (`serve/{router,worker,
autoscaler,drill}.py`) on the CPU, against the JAX package's.

Held against JAX on the same inputs: the claim scoring
(`canonical_key`, `suffix_epochs_saved`, `claim_score`, `rank_claims`,
`stable_host_hash`) over a table of advertisements that includes dead,
retired, torn and imposter ads; the pool's scan verdicts on one lease
directory; and the autoscaler's decisions over one fake clock, burn and
in-flight sequence. The port's own: the pool's stale-lease and
`mark_lost` contract (JAX's `tests/unit/test_serve_scaleout.py`), the
router resolving the same baseline key as the worker that builds it (for
the CPU, and planned for the card, where both name K2), and one run of a
router with two ``--device cpu`` worker processes: a what-if affinity hit
on the worker holding the baseline, then a worker SIGKILLed mid-request
with the survivor's answer bitwise the in-process one. A closing service
leaves its process's launch counts beside its bundle, and the drill
refuses a size it does not know.
"""

import json
import threading
import time

import numpy as np
import pytest

from yuma_simulation_tpu.fabric.lease import LeaseStore as JLeaseStore
from yuma_simulation_tpu.serve import Autoscaler as JAutoscaler
from yuma_simulation_tpu.serve import WorkerPool as JWorkerPool
from yuma_simulation_tpu.serve import claim_score as j_claim_score
from yuma_simulation_tpu.serve import rank_claims as j_rank_claims
from yuma_simulation_tpu.serve.router import canonical_key as j_canonical_key
from yuma_simulation_tpu.serve.router import stable_host_hash as j_stable_host_hash
from yuma_simulation_tpu.serve.router import suffix_epochs_saved as j_suffix_epochs_saved
from yuma_simulation_tpu_torch.fabric.lease import LeaseStore
from yuma_simulation_tpu_torch.serve import (
    Autoscaler,
    RouterConfig,
    RouterService,
    ServeConfig,
    SimulationClient,
    SimulationServer,
    SimulationService,
    WorkerPool,
    claim_score,
    rank_claims,
    wait_until_ready,
)
from yuma_simulation_tpu_torch.serve.router import (
    canonical_key,
    stable_host_hash,
    suffix_epochs_saved,
)

VERSION = "Yuma 2 (Adrian-Fish)"
BASELINE = ["netuid-1", VERSION, ["hp", 0.5], "fp-abc"]


@pytest.fixture(autouse=True)
def _fresh_slo_engine():
    from yuma_simulation_tpu_torch.telemetry import slo

    slo.set_slo_engine(None)
    yield
    slo.set_slo_engine(None)


def _ad(worker_id, **over):
    ad = {
        "worker_id": worker_id,
        "alive": True,
        "retired": False,
        "inflight": 0,
        "held_prefixes": [],
        "warm_buckets": [],
        "url": f"http://127.0.0.1:0/{worker_id}",
    }
    ad.update(over)
    return ad


def _held(key=None, checkpoints=(4, 8)):
    return {"key": BASELINE if key is None else key, "checkpoints": list(checkpoints)}


#: The advertisements every scoring case ranks: live, busy, warm, holding
#: the baseline (and a wrong one, and checkpoints past the perturbation),
#: dead, retired, torn (no fields past the id), and one with a string key.
ADS = [
    _ad("w0"),
    _ad("w1", inflight=3),
    _ad("w2", warm_buckets=["12x3x4"], inflight=1),
    _ad("holder", held_prefixes=[_held()], inflight=5),
    _ad("deep", held_prefixes=[_held(checkpoints=[4, 8, 16])]),
    _ad("wrong", held_prefixes=[_held(key=["other", "key"])]),
    _ad("dead", alive=False, held_prefixes=[_held()]),
    _ad("retired", retired=True, warm_buckets=["12x3x4"]),
    {"worker_id": "torn"},
    {"worker_id": "torn-alive", "alive": True},
    _ad("strkey", held_prefixes=[{"key": "abc123", "checkpoints": [2, 6]}]),
]

QUERIES = [
    dict(),
    dict(bucket="12x3x4"),
    dict(baseline_key=BASELINE, perturb_epoch=10),
    dict(baseline_key=BASELINE, perturb_epoch=10, bucket="12x3x4"),
    dict(baseline_key=BASELINE, perturb_epoch=3),
    dict(baseline_key=BASELINE, perturb_epoch=None),
    dict(baseline_key=tuple(BASELINE), perturb_epoch=20),
    dict(baseline_key="abc123", perturb_epoch=6),
    dict(baseline_key=["other", "key"], perturb_epoch=100, bucket="9x9x9"),
]


@pytest.mark.parametrize("query", QUERIES, ids=[json.dumps(q, default=str) for q in QUERIES])
def test_scoring_equals_jax(query):
    """Every ad's score, savings and the ranking equal JAX's; a dead,
    retired or torn ad never wins (None) in either package."""
    for ad in ADS:
        assert claim_score(ad, **query) == j_claim_score(ad, **query), ad["worker_id"]
        saved = suffix_epochs_saved(ad, query.get("baseline_key"), query.get("perturb_epoch"))
        assert saved == j_suffix_epochs_saved(ad, query.get("baseline_key"),
                                              query.get("perturb_epoch"))
    ranked = [a["worker_id"] for a in rank_claims(ADS, **query)]
    assert ranked == [a["worker_id"] for a in j_rank_claims(ADS, **query)]
    assert not {"dead", "retired", "torn"} & set(ranked)


def test_keys_and_tiebreak_equal_jax():
    native = ("netuid-1", ("hp", 0.5), "fp")
    wired = json.loads(json.dumps(native))
    assert canonical_key(native) == canonical_key(wired) == j_canonical_key(wired)
    for worker_id in ("w0", "w1-abc123", "", "worker-4242"):
        assert stable_host_hash(worker_id) == j_stable_host_hash(worker_id)
    saved, warm, neg_inflight, tiebreak = claim_score(
        _ad("w0", held_prefixes=[_held()], warm_buckets=["2x3x4"], inflight=2),
        baseline_key=BASELINE, perturb_epoch=10, bucket="2x3x4")
    assert (saved, warm, neg_inflight, tiebreak) == (8, 1, -2, stable_host_hash("w0"))


# ---------------------------------------------------------------- the pool


def _claim(cls, root, host, slot, ttl=60.0, **ad):
    store = cls(root / "leases", host, ttl_seconds=ttl)
    assert store.try_claim(slot) is not None
    store.annotate(slot, _ad(host, **ad))
    return store


def test_pool_scan_verdicts_equal_jax(tmp_path):
    """One lease directory read by both pools: the same alive verdict for
    a live worker, an ad left by another holder of the slot, a retired ad
    and a slot whose lease went stale."""
    mine = WorkerPool(tmp_path, max_slots=4, ttl_seconds=0.3)
    ref = JWorkerPool(tmp_path, max_slots=4, ttl_seconds=0.3)
    assert mine.scan() == ref.scan() == []
    w0 = _claim(LeaseStore, tmp_path, "w0-abc", 0, ttl=0.3)
    _claim(JLeaseStore, tmp_path, "w1-def", 1, ttl=60.0, retired=True)
    w2 = _claim(LeaseStore, tmp_path, "w2-ghi", 2, ttl=60.0)
    w2.annotate(2, _ad("w2-imposter"))

    def verdicts(pool):
        return [(ad["slot"], ad["worker_id"], ad["alive"]) for ad in pool.scan()]

    assert verdicts(mine) == verdicts(ref) == [
        (0, "w0-abc", True), (1, "w1-def", False), (2, "w2-imposter", False)]
    assert [a["worker_id"] for a in mine.live()] == ["w0-abc"]
    time.sleep(0.5)  # past the TTL with no heartbeat: SIGKILL semantics
    assert verdicts(mine) == verdicts(ref)
    assert mine.live() == [] == ref.live()
    w0.renew(0)
    assert [a["worker_id"] for a in mine.live()] == ["w0-abc"]


def test_mark_lost_reports_first_time_only(tmp_path):
    pool = WorkerPool(tmp_path, max_slots=2, ttl_seconds=60.0)
    _claim(LeaseStore, tmp_path, "w0-x", 0)
    assert pool.live()
    assert pool.mark_lost("w0-x") is True
    assert pool.mark_lost("w0-x") is False  # ledger worker_lost ONCE
    assert pool.live() == []  # routing stops before the lease expires


def test_pool_spawns_workers_on_its_device(tmp_path, monkeypatch):
    """Every worker is exec'd with the pool's device, never forked."""
    import subprocess

    seen = []

    class _Proc:
        pid = 1

        def poll(self):
            return 0

        returncode = 3

    def fake_popen(argv, **kw):
        seen.append(argv)
        return _Proc()

    monkeypatch.setattr(subprocess, "Popen", fake_popen)
    pool = WorkerPool(tmp_path, max_slots=2, device="cpu", spawn_wait_seconds=1.0)
    with pytest.raises(RuntimeError, match="exited rc=3"):
        pool.spawn()
    argv = seen[0]
    assert argv[1:4] == ["-m", "yuma_simulation_tpu_torch.serve", "--device"]
    assert argv[4] == "cpu" and "--worker-pool" in argv


# ---------------------------------------------------------------- autoscaler


class _FakeBurn:
    def __init__(self):
        self.burning = ()

    def degraded(self):
        return self.burning


class _FakeRouter:
    def __init__(self, *ads):
        self.ads = [dict(a) for a in ads]
        self.log = []
        self.pool = self

    def live(self):
        return [dict(a) for a in self.ads]

    def spawn_worker(self, *, reason="startup"):
        ad = _ad(f"w{len(self.ads)}-auto", started_t=100.0 + len(self.ads))
        self.ads.append(ad)
        self.log.append(("spawn", reason))
        return ad

    def retire_worker(self, worker_id, *, reason="idle"):
        self.log.append(("retire", worker_id, reason))
        self.ads = [a for a in self.ads if a["worker_id"] != worker_id]
        return True


#: (clock, burning SLOs, {worker: inflight}) per tick.
SCRIPT = [
    (0.0, (), {}),
    (1.0, ("serve_request_seconds",), {}),
    (2.0, ("serve_request_seconds",), {}),
    (6.5, ("serve_request_seconds", "serve_request_ok"), {}),
    (7.0, ("serve_request_seconds",), {}),
    (8.0, (), {"w-old": 1}),
    (12.0, (), {"w1-auto": 2}),
    (19.0, (), {}),
    (25.0, (), {}),
    (29.5, (), {}),
    (40.0, (), {}),
    (41.0, ("serve_request_ok",), {}),
    (60.0, (), {}),
    (80.0, (), {}),
]


@pytest.mark.parametrize("knobs", [
    dict(min_workers=1, max_workers=3, idle_retire_seconds=10.0, cooldown_seconds=5.0),
    dict(min_workers=2, max_workers=4, idle_retire_seconds=3.0, cooldown_seconds=0.0),
    dict(min_workers=0, max_workers=1, idle_retire_seconds=0.5, cooldown_seconds=1.0),
])
def test_autoscaler_decisions_equal_jax(knobs):
    """Both autoscalers over one fake clock, burn and in-flight sequence
    make the same decision at every tick, with the same spawn reasons and
    the same retire order (youngest first, never below the floor)."""
    runs = []
    for cls in (Autoscaler, JAutoscaler):
        router = _FakeRouter(_ad("w-old", started_t=1.0), _ad("w-young", started_t=50.0))
        burn, t = _FakeBurn(), [0.0]
        scaler = cls(router, burn, clock=lambda: t[0], **knobs)
        decisions = []
        for clock, burning, inflight in SCRIPT:
            t[0] = clock
            burn.burning = burning
            for ad in router.ads:
                ad["inflight"] = inflight.get(ad["worker_id"], 0)
            decisions.append(scaler.tick())
        runs.append((decisions, router.log, [a["worker_id"] for a in router.ads]))
    assert runs[0] == runs[1]
    assert {"spawn", "retire"} & set(runs[0][0])


def test_autoscaler_refuses_inverted_bounds():
    with pytest.raises(ValueError):
        Autoscaler(_FakeRouter(), _FakeBurn(), min_workers=3, max_workers=2)


# ------------------------------------------------- router and worker keys


def _archive(root, width=(3, 4), snapshots=3):
    from yuma_simulation_tpu_torch.replay import SnapshotArchive, synthetic_timeline

    arch = SnapshotArchive(root)
    synthetic_timeline(arch, 1, snapshots=snapshots, seed=0, num_validators=width[0],
                       num_miners=width[1])
    return arch


def test_router_resolves_the_workers_baseline_key(tmp_path):
    """The router's admission-time key for a what-if is the key the
    worker that serves it publishes in its held prefixes (the eager rung
    on the CPU), and, resolved for the card, both sides name the same K2
    key. The port's keys name "eager" where JAX's name "xla"
    (`replay/statecache.py::baseline_key`): the fields are otherwise
    JAX's."""
    import torch

    _archive(tmp_path / "archive")
    geometry = dict(replay_archive_dir=str(tmp_path / "archive"),
                    replay_epochs_per_snapshot=4, replay_stride=4)
    router = RouterService(RouterConfig(pool_dir=str(tmp_path / "pool"), device="cpu",
                                        replay_cache_dir=str(tmp_path / "router-cache"),
                                        **geometry))
    worker = SimulationService(ServeConfig(device="cpu", coalesce_window_seconds=0.0,
                                           replay_cache_dir=str(tmp_path / "worker-cache"),
                                           **geometry))
    try:
        assert router.device == torch.device("cpu") == router.replay.device
        spec = {"netuid": 1, "version": VERSION, "from_epoch": 9, "stake_scale": [[1, 2.0]]}
        from yuma_simulation_tpu_torch.replay import WhatIfSpec

        desc = router.replay.describe(WhatIfSpec.from_json(spec))
        status, body, _ = worker.handle("whatif", {"whatif": spec, "tenant": "t"})
        assert status == 200 and body["baseline_key"] == desc["key"]
        held = worker.replay.cache.held_prefixes()
        assert [h["key"] for h in held] == [desc["key"]] and held[0]["engine"] == "eager"
        ad = {"worker_id": "w", "alive": True, "held_prefixes": held}
        assert suffix_epochs_saved(ad, desc["key"], 9) == 8
        shape = (desc["epochs"], desc["validators"], desc["miners"])
        on_card = [svc.replay.cache.resolve(desc["fingerprint"], VERSION, None, None, shape, 4,
                                            "cuda")[2:] for svc in (router, worker)]
        assert on_card[0] == on_card[1] and on_card[0][0] == "fused_scan"
        assert worker.warm_buckets() == []
    finally:
        worker.close()
        router.close()


# ------------------------------------------------ router + two CPU workers


def test_router_with_two_cpu_workers_affinity_and_kill(tmp_path):
    """A router and two ``--device cpu`` worker processes: a repeated
    what-if lands on the worker holding its baseline (a cache hit with
    epochs saved), then a slow simulate's worker is SIGKILLed mid-request
    and the survivor answers, bitwise the in-process service, with
    `worker_lost` and `request_rerouted` ledgered."""
    _archive(tmp_path / "archive")
    geometry = dict(replay_archive_dir=str(tmp_path / "archive"),
                    replay_epochs_per_snapshot=4, replay_stride=4)
    worker_args = ("--replay-archive", str(tmp_path / "archive"),
                   "--replay-cache", str(tmp_path / "caches" / "{worker_id}"),
                   "--replay-epochs-per-snapshot", "4", "--replay-stride", "4",
                   "--coalesce-window", "0.0", "--tenant-rate", "1000",
                   "--tenant-burst", "1000")
    router = RouterService(RouterConfig(
        pool_dir=str(tmp_path / "pool"), workers=2, max_workers=2, worker_args=worker_args,
        lease_ttl_seconds=1.5, bundle_dir=str(tmp_path / "router-bundle"), device="cpu",
        replay_cache_dir=str(tmp_path / "router-cache"), forward_timeout=60.0,
        spawn_wait_seconds=60.0, **geometry))
    front = SimulationServer(service=router)
    solo = SimulationService(ServeConfig(device="cpu", coalesce_window_seconds=0.0,
                                         replay_cache_dir=str(tmp_path / "solo-cache"),
                                         **geometry))
    try:
        ads = router.start_workers()
        assert len(ads) == 2 and all(a["aot_builds"] == 0 for a in ads)
        front.start()
        assert wait_until_ready(front.url)
        client = SimulationClient(front.url, tenant="t", timeout=60)
        spec = {"netuid": 1, "version": VERSION, "from_epoch": 9, "stake_scale": [[1, 2.0]]}
        first = client.whatif(spec)
        assert first.status == 200 and first.body["cache_hit"] is False, first.body
        holder = first.headers["X-Worker"]
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not any(
                a["worker_id"] == holder and a.get("held_prefixes")
                for a in router.pool.live()):
            time.sleep(0.1)
        second = client.whatif(dict(spec, stake_scale=[[1, 3.0]]))
        assert second.headers["X-Worker"] == holder
        assert second.body["cache_hit"] is True and second.body["epochs_saved"] == 8
        _st, ref, _ = solo.handle("whatif", {"whatif": dict(spec, stake_scale=[[1, 3.0]]),
                                             "tenant": "t"})
        assert ref["total_dividend_delta"] == second.body["total_dividend_delta"]
        assert router.registry.counter("affinity_hits_total").value >= 1

        # A simulate slow enough to be in flight when its worker dies.
        rng = np.random.default_rng(7)
        W = rng.random((800, 8, 64)).astype(np.float32)
        S = (rng.random((800, 8)) + 0.1).astype(np.float32)
        payload = {"weights": W.tolist(), "stakes": S.tolist()}
        target = rank_claims(router.pool.live())[0]["worker_id"]
        survivor = next(a["worker_id"] for a in router.pool.live()
                        if a["worker_id"] != target)
        reply = {}
        thread = threading.Thread(target=lambda: reply.update(r=client.simulate(**payload)))
        thread.start()
        time.sleep(1.0)
        assert router.pool.kill(target)
        thread.join(timeout=120)
        r = reply["r"]
        assert r.status == 200 and r.headers["X-Worker"] == survivor, (r.status, r.headers)
        _st, solo_body, _ = solo.handle("simulate", dict(payload, tenant="t"))
        assert r.body["dividends"] == solo_body["dividends"]
        events = [(e["event"], e.get("worker"), e.get("request"))
                  for e in router.ledger.entries()]
        assert ("worker_lost", target, r.request_id) in events
        assert ("request_rerouted", target, r.request_id) in events
    finally:
        front.close()
        solo.close()


def test_closing_service_leaves_its_launch_counts(tmp_path):
    """A service with a bundle publishes its process's pid and launch
    counts beside the bundle when it closes (how a worker's counts are
    read after it exits); without a bundle it writes nothing."""
    import os

    from yuma_simulation_tpu_torch.ops.launches import launch_counts, read_launch_counts

    assert read_launch_counts(tmp_path / "bundle") is None
    SimulationService(ServeConfig(device="cpu", bundle_dir=str(tmp_path / "bundle"))).close()
    assert read_launch_counts(tmp_path / "bundle") == {
        "pid": os.getpid(), "launches": launch_counts()}
    SimulationService(ServeConfig(device="cpu")).close()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["bundle"]


def test_drill_refuses_unknown_sizes(tmp_path):
    import argparse

    from yuma_simulation_tpu_torch.serve.drill import run_scaleout_drill

    args = argparse.Namespace(device="cpu", bundle_dir=str(tmp_path / "b"))
    with pytest.raises(ValueError, match="unknown drill sizes"):
        run_scaleout_drill(args, sizes={"validators": 8, "minors": 64})
    assert not (tmp_path / "b").exists()

"""The serving tier of the port (`serve/`: admission, quotas, coalescer,
breaker, service, HTTP server, CLI) on the CPU, against the JAX package's.

The contracts of the JAX package's `tests/unit/test_serve.py`, each on the
port: token buckets and the bounded tenant table, the breaker's
trip / half-open / close walk (its last rung never filtered), typed
admission rejections, 429 + Retry-After from the tenant quota and the
queue bound, a typed 504 for a deadline spent in the queue, a graceful
typed shutdown, coalesced lanes bitwise their solo runs, the sweep and
table endpoints, the HTTP front with its flight bundle, and the `--smoke`
CLI. Held against JAX on the same payloads: the status and typed reason
of a table of malformed payloads, the response bodies of a built-in case
and of a random-array request, the table's CSV. The port's own: a
default request lands on the eager rung quarantined and donor-packed,
and a ``quarantine: false`` request is planned on K3 for the card, where
it coalesces by exact shape; the service never falls back to the CPU.
"""

import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from yuma_simulation_tpu.serve import ServeConfig as JServeConfig
from yuma_simulation_tpu.serve import SimulationService as JSimulationService
from yuma_simulation_tpu_torch.resilience.errors import AdmissionRejected
from yuma_simulation_tpu_torch.scenarios.synthetic import random_subnet_scenario
from yuma_simulation_tpu_torch.serve import (
    CircuitBreaker,
    ServeConfig,
    SimulationClient,
    SimulationServer,
    SimulationService,
    TenantQuotas,
    TokenBucket,
    wait_until_ready,
)
from yuma_simulation_tpu_torch.serve.admission import admit

VERSION = "Yuma 1 (paper)"
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_slo_engines():
    """The SLO engine is process-wide in both packages: start each test
    from a fresh one, so that an earlier test's burn cannot shed here."""
    from yuma_simulation_tpu.telemetry import slo as jslo
    from yuma_simulation_tpu_torch.telemetry import slo

    slo.set_slo_engine(None)
    jslo.set_slo_engine(None)
    yield
    slo.set_slo_engine(None)
    jslo.set_slo_engine(None)


def _service(**knobs) -> SimulationService:
    knobs.setdefault("coalesce_window_seconds", 0.0)
    knobs.setdefault("device", "cpu")
    return SimulationService(ServeConfig(**knobs))


def _jax_service(**knobs):
    knobs.setdefault("coalesce_window_seconds", 0.0)
    return JSimulationService(JServeConfig(**knobs))


def _payload(scenario, **extra) -> dict:
    return {
        "weights": np.asarray(scenario.weights).tolist(),
        "stakes": np.asarray(scenario.stakes).tolist(),
        **extra,
    }


# ------------------------------------------------------- quotas / breaker


def test_token_bucket_refills_on_the_clock():
    t = [0.0]
    bucket = TokenBucket(rate=2.0, burst=2, clock=lambda: t[0])
    assert bucket.try_acquire() == 0.0
    assert bucket.try_acquire() == 0.0
    assert bucket.try_acquire() == pytest.approx(0.5)
    t[0] += 0.5
    assert bucket.try_acquire() == 0.0
    assert bucket.try_acquire() > 0.0
    never = TokenBucket(rate=0.0, burst=1, clock=lambda: 0.0)
    assert never.try_acquire() == 0.0 and never.try_acquire() >= 60.0


def test_tenant_quota_table_is_bounded():
    q = TenantQuotas(rate=1.0, burst=1, overrides={"vip": (5.0, 5)},
                     clock=lambda: 0.0, max_tenants=8)
    q.bucket("vip")
    for i in range(100):
        q.bucket(f"hostile-{i}")
    assert len(q._buckets) <= 8 and "vip" in q._buckets


@pytest.mark.parametrize("low", ["fused_scan", "eager"])
def test_breaker_trips_half_opens_closes_and_keeps_the_last_rung(low):
    """The walk of JAX's breaker test on a card ladder (its last rung a
    kernel) and on a CPU ladder (its last rung eager)."""
    t = [0.0]
    b = CircuitBreaker(threshold=2, cooldown_seconds=10.0, clock=lambda: t[0])
    ladder = ("fused_varying", low)
    assert b.filter_ladder(ladder) == ladder
    b.record_failure("fused_varying")
    assert b.filter_ladder(ladder) == ladder
    b.record_failure("fused_varying")
    assert b.filter_ladder(ladder) == (low,)
    assert b.snapshot()["fused_varying"]["state"] == "open"
    t[0] = 10.0
    assert b.filter_ladder(ladder) == ladder  # the one half-open probe
    assert b.snapshot()["fused_varying"]["state"] == "half_open"
    assert b.filter_ladder(ladder) == (low,)
    b.abort_probe("fused_varying")  # a probe dying on a caller error
    assert b.filter_ladder(ladder) == ladder  # a fresh probe, not dead
    b.record_success("fused_varying")
    assert b.snapshot()["fused_varying"]["state"] == "closed"
    for _ in range(3):
        b.record_failure(low)
    assert b.filter_ladder((low,)) == (low,)  # the last rung never filtered


# ----------------------------------------------------------------- admission

#: Malformed payloads, each answered 400 with a typed reason.
MALFORMED = {
    "not_an_object": [],
    "wrong_rank": {"weights": [[1.0]]},
    "unknown_case": {"case": "No Such Case"},
    "unknown_version": {"case": "Case 1", "version": "Yuma 99"},
    "unknown_engine": {"case": "Case 1", "engine": "warp_drive"},
    "negative_deadline": {"case": "Case 1", "deadline_seconds": -5},
    "static_config": {"case": "Case 1", "config": {"liquid_alpha": 1.0}},
    "fused_quarantine": {"case": "Case 1", "engine": "fused_scan", "quarantine": True},
    "mismatched_stakes": {"weights": np.zeros((2, 3, 4)).tolist(),
                          "stakes": np.zeros((2, 2)).tolist()},
    "bad_reset": {"weights": np.zeros((2, 2, 3)).tolist(),
                  "stakes": np.ones((2, 2)).tolist(), "reset_bonds_index": "one"},
    "bool_priority": {"case": "Case 1", "priority": True},
    "empty_tenant": {"case": "Case 1", "tenant": ""},
}


@pytest.fixture(scope="module")
def both_services():
    svc, jsvc = _service(start_dispatcher=False), _jax_service(start_dispatcher=False)
    yield svc, jsvc
    svc.close()
    jsvc.close()


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_payloads_rejected_as_jax_rejects_them(both_services, name):
    svc, jsvc = both_services
    status, body, headers = svc.handle("simulate", MALFORMED[name])
    jstatus, jbody, _ = jsvc.handle("simulate", MALFORMED[name])
    assert (status, body["error"], body["reason"]) == (
        jstatus, jbody["error"], jbody["reason"]) == (400, "AdmissionRejected",
                                                      "invalid_request")
    assert body["status"] == "rejected" and headers["X-Request-Id"]


def test_admission_knobs_and_priority_ceiling():
    kw = dict(request_id="r1", kind="simulate", default_deadline_seconds=30.0,
              device="cpu")
    ticket = admit({"weights": np.zeros((2, 2, 3)).tolist(),
                    "stakes": np.ones((2, 2)).tolist(),
                    "reset_bonds_index": 1, "reset_bonds_epoch": 1}, **kw)
    assert (ticket.scenario.reset_bonds_index, ticket.scenario.reset_bonds_epoch) == (1, 1)
    assert admit({"case": "Case 1", "priority": 7}, **kw).priority == 7
    assert admit({"case": "Case 1", "priority": 7}, tenant_priority={}, **kw).priority == 0
    assert admit({"case": "Case 1", "tenant": "vip", "priority": 7},
                 tenant_priority={"vip": 2}, **kw).priority == 2
    with pytest.raises(AdmissionRejected, match="split the axes"):
        admit({"case": "Case 1", "axes": {f"a{i}": [0.1] * 8 for i in range(5)}},
              request_id="r2", kind="sweep", default_deadline_seconds=30.0, device="cpu")


def test_admission_preflight_rejects_with_suggestion(monkeypatch):
    """Priced on the service's device: under a nano device spec the
    shape is refused with the planner's suggestion, before any launch."""
    from yuma_simulation_tpu_torch.telemetry import cost

    monkeypatch.setenv("YUMA_TPU_DEVICE_SPEC",
                       json.dumps({"name": "nano-serve", "memory_bytes": 16384}))
    monkeypatch.setattr(cost, "_RESOLVED_SPECS", {})
    svc = _service(start_dispatcher=False)
    try:
        scenario = random_subnet_scenario(0, num_validators=8, num_miners=16, num_epochs=40)
        status, body, _ = svc.handle("simulate", _payload(scenario, tenant="big"))
        assert status == 400 and body["reason"] == "preflight_rejected"
        assert body["suggestion"]
    finally:
        svc.close()


@pytest.mark.parametrize("engine", ["auto", "xla", "eager"])
def test_default_request_lands_on_the_eager_rung_quarantined_and_packed(engine):
    """As in JAX: a default request (and one naming JAX's "xla") is
    quarantined and donor-packed by shape bucket on the eager rung, on
    the CPU and when planned for the card."""
    scenario = random_subnet_scenario(1, num_validators=5, num_miners=8, num_epochs=12)
    for device in ("cpu", "cuda"):
        t = admit(_payload(scenario, engine=engine), request_id="r", kind="simulate",
                  default_deadline_seconds=30.0, device=device)
        assert t.engine == ("auto" if engine == "auto" else "eager")
        assert t.quarantine and t.plan.engine == "eager"
        assert t.coalesce_key == ("simulate", VERSION, (), True, 12, 8, 128)


def test_unquarantined_request_is_planned_on_k3_for_the_card():
    """`quarantine: false` on the card plans K3 ("fused_varying"), whose
    coalesce key holds the exact shape (a kernel takes no miner mask);
    on the CPU it stays on the eager rung, packed."""
    scenario = random_subnet_scenario(2, num_validators=5, num_miners=8, num_epochs=12)
    card = admit(_payload(scenario, quarantine=False), request_id="r", kind="simulate",
                 default_deadline_seconds=30.0, device="cuda")
    assert card.plan.engine == "fused_varying" and card.plan.on_card
    assert "eager" not in card.plan.ladder
    assert card.coalesce_key == ("simulate", VERSION, (), False, "fused_varying", 12, 5, 8)
    cpu = admit(_payload(scenario, quarantine=False), request_id="r", kind="simulate",
                default_deadline_seconds=30.0, device="cpu")
    assert cpu.plan.engine == "eager" and cpu.coalesce_key[3] is False


def test_service_never_falls_back_to_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SimulationService(ServeConfig())
    from yuma_simulation_tpu_torch.v1 import api

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.serve(port=0, background=True)


def test_signed_api_keys_resolve_the_tenant(tmp_path):
    """With a keyfile, a request without a valid key is a typed 401; a
    minted key's verified tenant replaces the payload's claim."""
    from yuma_simulation_tpu_torch.serve import ApiKeyring, mint_api_key

    keys = tmp_path / "keys.json"
    keys.write_text(json.dumps({"alice": "s3cret"}))
    ring = ApiKeyring.load(keys)
    good = mint_api_key("alice", "s3cret")
    assert ring.resolve(good) == "alice"
    assert ring.resolve(mint_api_key("alice", "wrong")) is None
    assert ring.resolve("garbage") is None and ring.resolve(None) is None
    svc = _service(api_keys_path=str(keys))
    try:
        status, body, headers = svc.handle("simulate", {"case": "Case 1"})
        assert status == 401 and body["error"] == "Unauthenticated" and headers["X-Request-Id"]
        status, body, _ = svc.handle("simulate", {"case": "Case 1", "tenant": "mallory"},
                                     api_key=good)
        assert status == 200 and body["tenant"] == "alice"
    finally:
        svc.close()


# ------------------------------------------------------ backpressure / life


def _fill(svc, payloads):
    results = {}
    threads = [threading.Thread(target=lambda i=i, p=p: results.__setitem__(
        i, svc.handle("simulate", dict(p)))) for i, p in enumerate(payloads)]
    for th in threads:
        th.start()
    for _ in range(200):
        if len(svc.queue) == len(payloads):
            break
        time.sleep(0.02)
    assert len(svc.queue) == len(payloads)
    return results, threads


@pytest.mark.parametrize("bound", ["tenant_quota", "queue_limit"])
def test_shed_with_retry_after(bound):
    knobs = ({"tenant_overrides": {"greedy": (0.0, 2)}} if bound == "tenant_quota"
             else {"queue_limit": 2})
    svc = _service(start_dispatcher=False, **knobs)
    try:
        results, threads = _fill(svc, [{"tenant": "greedy", "case": "Case 1"}] * 2)
        status, body, headers = svc.handle("simulate", {"tenant": "greedy", "case": "Case 1"})
        assert status == 429 and body["error"] == "QueueOverflow"
        assert body["retry_after"] > 0 and headers["Retry-After"]
        assert svc.registry.counter("serve_requests_shed").value >= 1
        svc.start_dispatcher()
        for th in threads:
            th.join(timeout=60)
        assert [results[i][0] for i in range(2)] == [200, 200]
    finally:
        svc.close()


def test_deadline_spent_in_the_queue_and_shutdown_are_typed():
    svc = _service(start_dispatcher=False, default_deadline_seconds=0.2)
    results, threads = _fill(svc, [{"tenant": "late", "case": "Case 1"}])
    time.sleep(0.3)
    svc.start_dispatcher()
    threads[0].join(timeout=60)
    status, body, _ = results[0]
    assert status == 504 and body["error"] == "DeadlineExhausted" and body["retryable"]
    svc.close()
    svc.close()  # idempotent
    status, body, _ = svc.handle("simulate", {"tenant": "x", "case": "Case 1"})
    assert status == 503 and body["status"] == "shutting_down"


# ------------------------------------------------ results against JAX


@pytest.fixture(scope="module")
def both_dispatching():
    svc, jsvc = _service(), _jax_service()
    yield svc, jsvc
    svc.close()
    jsvc.close()


def test_case_3_body_bitwise_jax(both_dispatching):
    """A built-in case is bitwise JAX's XLA rung on the eager rung, donor-
    packed into the same (8, 128) bucket: the response bodies' floats are
    the same."""
    svc, jsvc = both_dispatching
    status, body, headers = svc.handle("simulate", {"tenant": "a", "case": "Case 3"})
    jstatus, jbody, _ = jsvc.handle("simulate", {"tenant": "a", "case": "Case 3"})
    assert status == jstatus == 200 and body["status"] == "ok"
    assert body["dividends"] == jbody["dividends"]
    assert body["total_dividends"] == jbody["total_dividends"]
    assert body["engine"] == "eager" and jbody["engine"] == "xla"
    assert "execute" in headers["Server-Timing"]


@pytest.mark.parametrize("version", ["Yuma 1 (paper)", "Yuma 2 (Adrian-Fish)"])
def test_random_request_matches_jax(both_dispatching, version):
    """A random [12, 5, 8] request, donor-packed into the [8, 128] bucket
    on both sides. That bucket is C2's open "V = 8 past M = 8" class of
    ROADMAP §C, not in its pin list: the dividends are within 2e-6 (they
    differ from epoch 0 by up to 2 ulp for Yuma 1 and 4 ulp for Yuma 2,
    recorded there); the built-in Case 3 above is bitwise."""
    svc, jsvc = both_dispatching
    scenario = random_subnet_scenario(7, num_validators=5, num_miners=8, num_epochs=12)
    payload = _payload(scenario, tenant="r", version=version)
    status, body, _ = svc.handle("simulate", dict(payload))
    jstatus, jbody, _ = jsvc.handle("simulate", dict(payload))
    assert status == jstatus == 200
    np.testing.assert_allclose(body["dividends"], jbody["dividends"], atol=2e-6, rtol=0)
    np.testing.assert_allclose(body["total_dividends"], jbody["total_dividends"],
                               atol=2e-6, rtol=0)


def test_table_csv_equals_jax(both_dispatching):
    svc, jsvc = both_dispatching
    payload = {"tenant": "csv", "versions": [VERSION, "Yuma 2 (Adrian-Fish)"]}
    status, body, _ = svc.handle("table", dict(payload))
    jstatus, jbody, _ = jsvc.handle("table", dict(payload))
    assert status == jstatus == 200 and body["csv"].startswith("Case,")
    assert body["csv"] == jbody["csv"]


def test_sweep_endpoint_matches_direct_grid(both_dispatching):
    from yuma_simulation_tpu_torch.resilience import SweepSupervisor
    from yuma_simulation_tpu_torch.scenarios import create_case
    from yuma_simulation_tpu_torch.simulation.sweep import config_grid

    svc, _ = both_dispatching
    status, body, _ = svc.handle("sweep", {"tenant": "grid", "case": "Case 1",
                                           "axes": {"bond_penalty": [0.0, 0.5, 1.0]}})
    assert status == 200 and body["status"] == "ok", body
    configs, _ = config_grid(bond_penalty=[0.0, 0.5, 1.0])
    ref = SweepSupervisor(directory=None, unit_size=8).run_grid(
        create_case("Case 1"), VERSION, configs, device="cpu")
    np.testing.assert_array_equal(np.asarray(body["total_dividends"]),
                                  np.asarray(ref["dividends"]).sum(axis=1))


def test_coalesced_lanes_bitwise_their_solo_runs():
    """Mixed shapes queued before the dispatcher starts: same-bucket
    requests ride shared dispatches, each lane the solo dispatch's
    floats exactly."""
    payloads = [{"tenant": f"t{i}", "case": c} for i, c in enumerate(
        ["Case 1", "Case 2", "Case 3"])]
    for i, (V, M) in enumerate([(4, 6), (5, 8), (4, 6)]):
        payloads.append(_payload(random_subnet_scenario(20 + i, num_validators=V,
                                                        num_miners=M, num_epochs=10),
                                 tenant=f"r{i}"))
    solo_svc = _service()
    try:
        solo = [solo_svc.handle("simulate", dict(p)) for p in payloads]
    finally:
        solo_svc.close()
    svc = _service(coalesce_window_seconds=0.05, max_batch=8, start_dispatcher=False)
    try:
        results, threads = _fill(svc, payloads)
        svc.start_dispatcher()
        for th in threads:
            th.join(timeout=120)
        coalesced = []
        for i in range(len(payloads)):
            status, body, _ = results[i]
            assert status == 200 and body["status"] == "ok", body
            assert body["dividends"] == solo[i][1]["dividends"], i
            coalesced.append(body["coalesced"])
        assert coalesced == [3, 3, 3, 3, 3, 3]
        assert svc.registry.counter("serve_coalesced_lanes").value >= 6
    finally:
        svc.close()


# ------------------------------------------------------------------- HTTP


@pytest.fixture
def server(tmp_path):
    srv = SimulationServer(ServeConfig(device="cpu", coalesce_window_seconds=0.0,
                                       bundle_dir=str(tmp_path / "bundle"))).start()
    try:
        assert wait_until_ready(srv.url)
        yield srv
    finally:
        srv.close()


def test_http_server_end_to_end(server, tmp_path):
    import urllib.error
    import urllib.request

    client = SimulationClient(server.url, tenant="alice", timeout=60)
    r = client.simulate(case="Case 1")
    assert r.status == 200 and r.ok and r.request_id and "queue" in r.server_timing
    bad = client.simulate(weights=[[1.0]])
    assert bad.status == 400 and bad.body["error"] == "AdmissionRejected"
    health = client.healthz()
    assert health.body["status"] == "ok" and health.body["requests_total"] >= 2
    metrics = client.metrics()
    for series in ("serve_queue_depth", "serve_requests_shed", "serve_breaker_open",
                   "serve_requests_total", "serve_request_seconds"):
        assert series in metrics, series
    assert client._request("POST", "/v1/nope", {}).status == 404
    assert client.replay().status == 404  # no replay tier mounted
    v = client.debug_vars()
    assert v.status == 200 and v.body["metrics"]["counters"]["serve_requests_total"] >= 1
    assert client.debug_spans().body["run_id"]
    req = urllib.request.Request(server.url + "/v1/simulate", data=b"{not json",
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == 400
    assert json.loads(err.value.read().decode())["error"] == "InvalidJSON"
    server.close()

    from tools.obsreport import render_serve
    from yuma_simulation_tpu.telemetry.flight import check_bundle, load_bundle

    bundle = load_bundle(tmp_path / "bundle")
    assert check_bundle(bundle) == []
    assert "tenant alice" in "\n".join(render_serve(bundle, bundle.latest_run_id()))
    last = bundle.metrics[-1]
    assert "serve_queue_depth" in last["gauges"]
    assert "serve_breaker_trips" in last["counters"]


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=kw.pop("timeout", 120), **kw)


def test_smoke_cli_on_the_cpu_and_its_bundle_gates(tmp_path):
    bundle = tmp_path / "smoke"
    done = _run(["-m", "yuma_simulation_tpu_torch.serve", "--smoke", "--device", "cpu",
                 "--bundle-dir", str(bundle), "--queue-limit", "16",
                 "--tenant-burst", "4", "--coalesce-window", "0.3"])
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    assert "serve smoke passed" in done.stdout and "FAIL" not in done.stdout
    for tool in (["tools.obsreport", str(bundle), "--check"],
                 ["tools.sloreport", str(bundle), "--check", "--require"]):
        gate = _run(["-m", *tool])
        assert gate.returncode == 0, gate.stdout[-3000:]


@pytest.mark.parametrize("flags", [["--smoke"], ["--device", "cpu", "--router"],
                                   ["--device", "cpu", "--replay-controller", "store"],
                                   ["--device", "cpu", "--worker-pool", "pool"],
                                   ["replay"]])
def test_cli_refuses_what_it_cannot_do(flags, tmp_path, capsys):
    """Without CUDA the default smoke raises instead of running on the
    CPU. JAX's refusals of the multi-process tier: `--router` without
    `--worker-pool` and `--replay-controller` without `--replay-archive`
    / `--replay-cache` are usage errors, a worker on a slot a live lease
    holds raises, and the replay CLI without a mode prints its help and
    returns 2."""
    from yuma_simulation_tpu_torch.serve.__main__ import main

    if flags == ["--smoke"]:
        import torch

        if torch.cuda.is_available():
            pytest.skip("this machine has CUDA: the default smoke runs on it")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(flags)
        return
    if flags == ["replay"]:
        from yuma_simulation_tpu_torch.replay.__main__ import main as replay_main

        assert replay_main([]) == 2
        assert "--controller" in capsys.readouterr().out
        return
    if "--worker-pool" in flags:
        from yuma_simulation_tpu_torch.fabric.lease import LeaseStore

        pool = tmp_path / "pool"
        assert LeaseStore(pool / "leases", "someone-else", ttl_seconds=60.0).try_claim(0)
        with pytest.raises(RuntimeError, match="already held by a live worker"):
            main([*flags[:-1], str(pool), "--bundle-dir", str(tmp_path / "b")])
        return
    with pytest.raises(SystemExit) as exc:
        main(flags)
    assert exc.value.code == 2
    assert ("requires --worker-pool" if "--router" in flags
            else "requires --replay-archive") in capsys.readouterr().err


def test_v1_serve_in_the_background():
    from yuma_simulation_tpu_torch.v1 import api

    srv = api.serve(port=0, background=True, device="cpu", coalesce_window_seconds=0.0)
    try:
        assert wait_until_ready(srv.url)
        r = SimulationClient(srv.url, tenant="v1", timeout=60).simulate(case="Case 2")
        assert r.ok and r.body["engine"] == "eager"
    finally:
        srv.close()

"""The scenario foundry of the port (`foundry/`) against the JAX package's,
on the CPU.

Contracts: every generator is numpy on explicit seeds, so the port's is
bitwise JAX's: `compile_spec`'s arrays and metadata, the JSON form's bytes
and `spec_key`, `synthetic_snapshot` at the full 256 x 4096, the snapshot
files both ways (JSON, CSR and dense npz), the four adversarial families,
`sample_params` / `derived_seed` / `montecarlo_specs` / the config batch,
and the drill population; the same bad inputs raise the same typed errors.
What simulates is held to JAX's XLA rung: bitwise on the shapes ROADMAP §C
pins, and on the drill population's donor-packed [8, 16, 8, 128] bucket
(C2's open "V = 8 past M = 8") bitwise for Yuma 1 and 2 and within atol
2e-6 for the rest, the lanes that are not bitwise listed in ROADMAP §C.
Every route of `run_montecarlo` lands on the eager rung here, so the
routes agree bitwise.
"""

import json

import jax  # noqa: F401  (the JAX package's conftest configures it)
import numpy as np
import pytest

import yuma_simulation_tpu.foundry as J
from yuma_simulation_tpu.foundry import __main__ as jdrill
from yuma_simulation_tpu.foundry import metagraph as jmeta
from yuma_simulation_tpu_torch import foundry as T
from yuma_simulation_tpu_torch.foundry import __main__ as tdrill
from yuma_simulation_tpu_torch.foundry import metagraph as tmeta
from yuma_simulation_tpu_torch.models.variants import canonical_versions
from yuma_simulation_tpu_torch.parallel import make_mesh
from yuma_simulation_tpu_torch.telemetry import check_bundle, load_bundle
from yuma_simulation_tpu_torch.telemetry.metrics import get_registry

VERSIONS = [v for v, _ in canonical_versions()]
ATOL = 2e-6  # the JAX package's reduction-order class against its XLA rung
#: Versions whose dividends on the drill population's packed bucket are
#: bitwise JAX's (the others: ROADMAP §C).
DRILL_BITWISE = {"Yuma 1 (paper)", "Yuma 1 (paper) - liquid alpha on", "Yuma 2 (Adrian-Fish)"}


def _same_scenario(a, b):
    """Two Scenarios (JAX's, the port's) equal field for field, arrays
    bitwise."""
    assert a.name == b.name and list(a.validators) == list(b.validators)
    assert a.base_validator == b.base_validator and a.num_epochs == b.num_epochs
    assert (a.reset_bonds, a.reset_bonds_index, a.reset_bonds_epoch) == (
        b.reset_bonds, b.reset_bonds_index, b.reset_bonds_epoch)
    assert list(a.servers) == list(b.servers) and a.plot_incentives == b.plot_incentives
    for x, y in ((a.weights, b.weights), (a.stakes, b.stakes)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------------- DSL


@pytest.mark.parametrize("case", ["Case 1", "Case 2", "Case 3", "Case 4", "Case 9", "Case 14"])
def test_builtin_specs_compile_json_and_key_equal_jax(case):
    jspec, tspec = J.builtin_case_specs()[case], T.builtin_case_specs()[case]
    _same_scenario(J.compile_spec(jspec), T.compile_spec(tspec))
    assert T.spec_to_json(tspec) == J.spec_to_json(jspec)
    assert T.spec_key(tspec) == J.spec_key(jspec)
    back = T.spec_from_json(J.spec_to_json(jspec))
    assert back == tspec
    _same_scenario(J.compile_spec(jspec), T.compile_spec(back))


def _dsl_program(m):
    """One spec using every primitive and combinator of module `m`."""
    return m.ScenarioSpec(
        name="every primitive", validators=("a", "b", "c", "d"), base_validator="a",
        num_miners=5, num_epochs=12,
        stakes=m.overlay(
            m.sequence(m.Stakes((0.4, 0.3, 0.2, 0.1))),
            m.sequence(m.at_epochs(m.StakeDrift((0.4, 0.3, 0.2, 0.1), (0.1, 0.2, 0.3, 0.4)), 4, 9)),
        ),
        weights=m.sequence(
            m.OneHot((0, 1, 2, 3)),
            m.at_epochs(m.Rows(((0.5, 0.5, 0, 0, 0), (0, 0.25, 0.75, 0, 0),
                                (0.2, 0.2, 0.2, 0.2, 0.2), (0, 0, 0, 0, 1.0))), 3, 7),
            m.CopyWithLag(dst=3, src=0, lag=2),
            m.NoisyConsensusFollower(validator=2, sigma=0.1, seed=7),
        ),
        events=(m.Takeover(validator=1, epoch=8, stake_fraction=0.5), m.BondReset(index=1, epoch=8)),
    )


def test_every_primitive_compiles_bitwise_jax():
    jspec, tspec = _dsl_program(J), _dsl_program(T)
    _same_scenario(J.compile_spec(jspec), T.compile_spec(tspec))
    assert T.spec_to_json(tspec) == J.spec_to_json(jspec)
    assert T.spec_key(tspec) == J.spec_key(jspec)
    assert T.spec_from_dict(json.loads(J.spec_to_json(jspec))) == tspec
    before = get_registry().counter("scenarios_generated").value
    T.compile_spec(tspec)
    assert get_registry().counter("scenarios_generated").value == before + 1


BAD_SPECS = {
    "onehot_length": lambda m: m.compile_spec(m.ScenarioSpec(
        "x", ("a", "b"), "a", 2, 3, weights=m.sequence(m.OneHot((0,))))),
    "onehot_miner": lambda m: m.compile_spec(m.ScenarioSpec(
        "x", ("a", "b"), "a", 2, 3, weights=m.sequence(m.OneHot((0, 5))))),
    "negative_lag": lambda m: m.compile_spec(m.ScenarioSpec(
        "x", ("a", "b"), "a", 2, 3, weights=m.sequence(m.CopyWithLag(1, 0, lag=-1)))),
    "copy_index": lambda m: m.compile_spec(m.ScenarioSpec(
        "x", ("a", "b"), "a", 2, 3, weights=m.sequence(m.CopyWithLag(-1, 0)))),
    "two_resets": lambda m: m.compile_spec(m.ScenarioSpec(
        "x", ("a", "b"), "a", 2, 3, stakes=m.sequence(m.Stakes((0.5, 0.5))),
        weights=m.sequence(m.OneHot((0, 1))),
        events=(m.BondReset(0, 1), m.BondReset(1, 2)))),
    "takeover_fraction": lambda m: m.compile_spec(m.ScenarioSpec(
        "x", ("a", "b"), "a", 2, 3, stakes=m.sequence(m.Stakes((0.5, 0.5))),
        weights=m.sequence(m.OneHot((0, 1))), events=(m.Takeover(0, 1, 1.5),))),
    "rows_shape": lambda m: m.compile_spec(m.ScenarioSpec(
        "x", ("a", "b"), "a", 2, 3, weights=m.sequence(m.Rows(((1.0,),))))),
    "base_validator": lambda m: m.ScenarioSpec("x", ("a",), "b", 2),
    "format": lambda m: m.spec_from_dict({"format": "other"}),
    "missing_key": lambda m: m.spec_from_dict({"format": "yuma-scenario-spec-v1"}),
    "unknown_primitive": lambda m: m.spec_from_dict({
        "format": "yuma-scenario-spec-v1", "name": "x", "validators": ["a"],
        "base_validator": "a", "num_miners": 1, "num_epochs": 1,
        "weights": [{"prim": {"type": "Nope"}, "start": 0, "stop": None}]}),
    "at_epochs_clause": lambda m: m.at_epochs(m.at_epochs(m.OneHot((0,)), 0), 1),
}


@pytest.mark.parametrize("name", sorted(BAD_SPECS))
def test_bad_specs_raise_jax_spec_error(name):
    with pytest.raises(J.SpecError) as jerr:
        BAD_SPECS[name](J)
    with pytest.raises(T.SpecError) as terr:
        BAD_SPECS[name](T)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------- metagraph


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_snapshot_full_size_bitwise_jax(seed):
    j, t = J.synthetic_snapshot(seed), T.synthetic_snapshot(seed)
    assert t.weights.shape == (256, 4096) and (t.netuid, t.block) == (j.netuid, j.block)
    np.testing.assert_array_equal(t.weights, j.weights)
    np.testing.assert_array_equal(t.stakes, j.stakes)
    _same_scenario(J.scenario_from_snapshot(j, num_epochs=2),
                   T.scenario_from_snapshot(t, num_epochs=2))


@pytest.mark.parametrize("name,sparse", [("s.json", True), ("s.npz", True), ("d.npz", False)])
def test_snapshot_files_cross_load_bitwise(tmp_path, name, sparse):
    """A JAX-written file loads in the port and a port-written one in JAX,
    bitwise; the port's bytes are JAX's."""
    snap = J.synthetic_snapshot(3, num_validators=8, num_miners=64, nnz_per_row=5,
                                netuid=21, block=4_200_000)
    jpath = J.save_metagraph_snapshot(snap, tmp_path / f"j{name}", sparse=sparse)
    got = T.load_metagraph_snapshot(jpath)
    tpath = T.save_metagraph_snapshot(got, tmp_path / f"t{name}", sparse=sparse)
    back = J.load_metagraph_snapshot(tpath)
    for s in (got, back):
        assert (s.netuid, s.block) == (21, 4_200_000)
        np.testing.assert_array_equal(s.weights, snap.weights)
        np.testing.assert_array_equal(s.stakes, snap.stakes)
    if name.endswith(".json"):
        assert tpath.read_bytes() == jpath.read_bytes()
        assert tmeta.snapshot_to_dict(got) == jmeta.snapshot_to_dict(snap)


def test_bad_snapshots_raise_jax_errors(tmp_path):
    cases = {
        "ext.txt": b"",
        "fmt.json": json.dumps({"format": "x"}).encode(),
        "key.json": json.dumps({"format": jmeta.FORMAT, "netuid": 1}).encode(),
        "neg.json": json.dumps({"format": jmeta.FORMAT, "netuid": 1, "block": 2,
                                "stakes": [1.0], "weights": [[-1.0]]}).encode(),
        "zero.json": json.dumps({"format": jmeta.FORMAT, "netuid": 1, "block": 2,
                                 "stakes": [0.0], "weights": [[1.0]]}).encode(),
        "bad.json": b"{",
    }
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
    np.savez(tmp_path / "csr.npz", stakes=np.ones(2, np.float32),
             weights_indptr=np.array([0, 1, 2], np.int64),
             weights_indices=np.array([0, -1], np.int64),
             weights_values=np.ones(2, np.float32))
    np.savez(tmp_path / "none.npz", stakes=np.ones(2, np.float32))
    for name in [*cases, "csr.npz", "none.npz"]:
        with pytest.raises(J.SnapshotError) as jerr:
            J.load_metagraph_snapshot(tmp_path / name)
        with pytest.raises(T.SnapshotError) as terr:
            T.load_metagraph_snapshot(tmp_path / name)
        assert str(terr.value) == str(jerr.value), name


# ------------------------------------------------------------- adversarial

FAMILIES = {
    "weight_copier_scenario": dict(num_miners=4, num_epochs=16, lag=2),
    "cartel_scenario": dict(cartel_size=2, cartel_stake_fraction=0.3),
    "stake_churn_scenario": dict(num_validators=5),
    "takeover_scenario": dict(attacker_fraction=0.7),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_adversarial_families_bitwise_jax(family):
    for seed in range(3):
        for kwargs in ({}, FAMILIES[family]):
            j = getattr(J, family)(seed, **kwargs)
            t = getattr(T, family)(seed, **kwargs)
            _same_scenario(j.scenario, t.scenario)
            assert T.spec_to_json(t.spec) == J.spec_to_json(j.spec) and t.roles == j.roles


def test_property_helpers_equal_jax():
    """The dividend totals and the two properties the helpers compute, on
    the CPU, bitwise JAX's (V = 3-4, M = 4)."""
    for seed in (0, 3):
        j, t = J.weight_copier_scenario(seed), T.weight_copier_scenario(seed)
        for version in ("Yuma 1 (paper)", "Yuma 4 (Rhef+relative bonds)"):
            gap = T.copier_dividend_gap(t, version, device="cpu")
            assert gap == J.copier_dividend_gap(j, version) and gap > 0
        np.testing.assert_array_equal(
            T.total_dividends(t.scenario, "Yuma 2 (Adrian-Fish)", device="cpu"),
            J.total_dividends(j.scenario, "Yuma 2 (Adrian-Fish)"))
    j, t = J.cartel_scenario(1), T.cartel_scenario(1)
    inc = T.cartel_miner_incentive(t, "Yuma 1 (paper)", device="cpu")
    assert inc == J.cartel_miner_incentive(j, "Yuma 1 (paper)")
    assert inc <= t.scenario.num_epochs * T.CARTEL_INCENTIVE_FLOOR_PER_EPOCH
    assert T.LIQUID_ALPHA_VERSIONS == J.LIQUID_ALPHA_VERSIONS


# -------------------------------------------------------------- Monte-Carlo


def test_sampling_and_specs_bitwise_jax():
    def dists(m):
        return {"stake": m.Uniform(0.4, 0.7), "shift": m.IntRange(2, 7),
                "family": m.Choice(("copier", "cartel")), "sigma": m.LogUniform(0.01, 0.1),
                "constant": 3}

    assert T.sample_params(dists(T), 6, 11) == J.sample_params(dists(J), 6, 11)
    assert T.sample_params(dists(T), 3, 11) == T.sample_params(dists(T), 6, 11)[:3]
    assert [T.derived_seed(5, i) for i in range(4)] == [J.derived_seed(5, i) for i in range(4)]

    def builder(m):
        return lambda seed, lag: m.weight_copier_scenario(seed, lag=lag).spec

    jspecs, jpts = J.montecarlo_specs(builder(J), {"lag": J.IntRange(1, 3)}, 4, 2)
    tspecs, tpts = T.montecarlo_specs(builder(T), {"lag": T.IntRange(1, 3)}, 4, 2)
    assert tpts == jpts and [T.spec_to_json(s) for s in tspecs] == [J.spec_to_json(s)
                                                                    for s in jspecs]
    jsc, _ = J.montecarlo_suite(lambda seed, shock: J.stake_churn_scenario(
        seed, shock_epoch=shock), {"shock": J.IntRange(5, 9)}, 3, 4)
    tsc, _ = T.montecarlo_suite(lambda seed, shock: T.stake_churn_scenario(
        seed, shock_epoch=shock), {"shock": T.IntRange(5, 9)}, 3, 4)
    for a, b in zip(jsc, tsc):
        _same_scenario(a, b)
    with pytest.raises(TypeError, match="montecarlo builder"):
        T.montecarlo_suite(lambda seed: 3, {}, 1, 0)
    jcfg, jp = J.montecarlo_config_batch({"kappa": J.Uniform(0.4, 0.6)}, 5, 9)
    tcfg, tp = T.montecarlo_config_batch({"kappa": T.Uniform(0.4, 0.6)}, 5, 9)
    assert tp == jp
    np.testing.assert_array_equal(tcfg.kappa.numpy(), np.asarray(jcfg.kappa))
    with pytest.raises(ValueError, match="unknown base config fields"):
        T.montecarlo_config_batch({}, 1, 0, nope=1)


def test_drill_population_bitwise_jax():
    for a, b in zip(jdrill.build_drill_suite(0, 8), tdrill.build_drill_suite(0, 8)):
        _same_scenario(a, b)


@pytest.mark.parametrize("version", VERSIONS)
def test_run_montecarlo_matches_jax(version):
    """The batch route against JAX's: the stacked [4, 16, 3, 4] copier
    population bitwise (a shape C2 closes), the donor-packed drill
    population within atol 2e-6, bitwise for DRILL_BITWISE."""
    jc = [J.weight_copier_scenario(s, num_miners=4, num_epochs=16).scenario for s in range(4)]
    tc = [T.weight_copier_scenario(s, num_miners=4, num_epochs=16).scenario for s in range(4)]
    np.testing.assert_array_equal(T.run_montecarlo(tc, version, device="cpu")["dividends"],
                                  np.asarray(J.run_montecarlo(jc, version)["dividends"]))
    jd = np.asarray(J.run_montecarlo(jdrill.build_drill_suite(0, 8), version)["dividends"])
    td = T.run_montecarlo(tdrill.build_drill_suite(0, 8), version, device="cpu")["dividends"]
    assert td.shape == jd.shape == (8, 16, 8)
    np.testing.assert_allclose(td, jd, atol=ATOL, rtol=0)
    if version in DRILL_BITWISE:
        np.testing.assert_array_equal(td, jd)


def test_routes_agree_on_the_cpu(tmp_path):
    """On the CPU every route lands on the eager rung: batch, supervised,
    sharded (a two-device CPU mesh) and fleet (a store under `tmp_path`)
    bitwise; the fleet route without a store and unknown routes raise."""
    suite = tdrill.build_drill_suite(1, 8)
    batch = T.run_montecarlo(suite, "Yuma 1 (paper)", pack=True, device="cpu")
    sup = T.run_montecarlo(suite, "Yuma 1 (paper)", route="supervised", pack=True, device="cpu")
    np.testing.assert_array_equal(sup["dividends"], batch["dividends"])
    same = [T.weight_copier_scenario(s, num_epochs=16).scenario for s in range(4)]
    stacked = T.run_montecarlo(same, "Yuma 3 (Rhef)", device="cpu")
    sharded = T.run_montecarlo(same, "Yuma 3 (Rhef)", route="sharded",
                               mesh=make_mesh(devices=["cpu"] * 2))
    np.testing.assert_array_equal(sharded["dividends"], stacked["dividends"])
    with pytest.raises(ValueError, match="needs mesh"):
        T.run_montecarlo(same, "Yuma 1 (paper)", route="sharded")
    fleet = T.run_montecarlo(same, "Yuma 3 (Rhef)", route="fleet", fleet=tmp_path / "store",
                             device="cpu")
    np.testing.assert_array_equal(fleet["dividends"], stacked["dividends"])
    with pytest.raises(ValueError, match="needs fleet"):
        T.run_montecarlo(same, "Yuma 1 (paper)", route="fleet", device="cpu")
    with pytest.raises(ValueError, match="unknown route"):
        T.run_montecarlo(same, "Yuma 1 (paper)", route="pod")


def test_drill_cli_on_the_cpu(tmp_path, capsys):
    """The drill exits 0 on the CPU with a bundle that passes the bundle
    checks; a non-empty bundle directory and a missing --drill exit 2."""
    from yuma_simulation_tpu_torch.telemetry.slo import set_slo_engine

    set_slo_engine(None)
    target = tmp_path / "bundle"
    assert tdrill.main(["--drill", "--bundle-dir", str(target), "--device", "cpu"]) == 0
    assert "foundry drill complete: 8 generated scenarios" in capsys.readouterr().out
    assert check_bundle(load_bundle(target)) == []
    assert tdrill.main(["--drill", "--bundle-dir", str(target), "--device", "cpu"]) == 2
    assert tdrill.main([]) == 2

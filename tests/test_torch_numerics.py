"""The port's per-epoch numerics sketches against the JAX package's, on the
CPU: `ops/fingerprint.py`, `telemetry/numerics.py`, and the ``numerics``
every result carries (`simulate`, streamed runs, `simulate_batch`,
`sweep_hyperparams`).

Contracts: the fingerprint and the sketches are bitwise JAX's on float32
and float64, NaN, +-inf and +-0.0 included; the sketch functions are held
to JAX's as its engines run them, inside `jit` (where XLA turns the finite
fraction's divide by the size into a multiply by its reciprocal); the eager
rung's numerics are bitwise JAX's XLA rung (the rung whose outputs it
matches bitwise), with JAX's stream sets on every rung; ``YUMA_NUMERICS=0``
gives None in both packages; the records the port serializes pass JAX's own
checks. Shapes are small: the port's files are collected first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yuma_simulation_tpu.models.config import SimulationHyperparameters as JSim
from yuma_simulation_tpu.models.config import YumaConfig as JConfig
from yuma_simulation_tpu.models.variants import canonical_versions as j_versions
from yuma_simulation_tpu.models.variants import variant_for_version as j_variant
from yuma_simulation_tpu.ops import fingerprint as jfp
from yuma_simulation_tpu.scenarios import create_case as j_create_case
from yuma_simulation_tpu.simulation.engine import simulate as j_simulate
from yuma_simulation_tpu.simulation.sweep import config_grid as j_config_grid
from yuma_simulation_tpu.simulation.sweep import pad_scenarios as j_pad_scenarios
from yuma_simulation_tpu.simulation.sweep import simulate_batch as j_simulate_batch
from yuma_simulation_tpu.simulation.sweep import sweep_hyperparams as j_sweep_hyperparams
from yuma_simulation_tpu.telemetry import numerics as jnum
from yuma_simulation_tpu_torch.models.config import SimulationHyperparameters, YumaConfig
from yuma_simulation_tpu_torch.models.variants import canonical_versions, variant_for_version
from yuma_simulation_tpu_torch.ops import fingerprint as tfp
from yuma_simulation_tpu_torch.scenarios import create_case, get_cases
from yuma_simulation_tpu_torch.simulation.carry import NumericsSketch
from yuma_simulation_tpu_torch.simulation.engine import simulate
from yuma_simulation_tpu_torch.simulation.sweep import (
    config_grid,
    pad_scenarios,
    simulate_batch,
    stack_scenarios,
    sweep_hyperparams,
)
from yuma_simulation_tpu_torch.telemetry import numerics as tnum

IDS = [v for v, _ in canonical_versions()]
FIELDS = tnum.SKETCH_FIELDS
#: The built-in cases the engine tests run (reset rules, zero stakes, ties).
CASES = ("Case 1", "Case 3", "Case 10")


def _specials(dtype, shape=(6, 7), seed=0):
    """Random values with NaN, +-inf and +-0.0 planted, and an all-NaN row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(dtype)
    flat = x.reshape(-1)
    flat[[1, 5, 9]] = np.nan
    flat[[2, 11]] = np.inf
    flat[3] = -np.inf
    flat[[4, 12, 20]] = 0.0
    flat[[6, 13, 21]] = -0.0
    x[-1] = np.nan
    return x


def _bytes_equal(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)), (what, a, b)


def _sketches_equal(got: dict, ref: dict, what=""):
    """Host sketch sets bitwise equal (the JAX side fetched to numpy)."""
    assert set(got) == set(ref), (what, sorted(got), sorted(ref))
    for stream in ref:
        for f in FIELDS:
            _bytes_equal(getattr(got[stream], f), np.asarray(getattr(ref[stream], f)),
                         f"{what} {stream}.{f}")


# ---------------------------------------------------------------------------
# ops/fingerprint.py


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bits_and_fingerprint_bitwise_jax(dtype):
    """`bits_u32` and the whole-tensor fingerprint: JAX's u32 values, on
    values with NaN, +-inf and +-0.0 (float64 folds its halves)."""
    x = _specials(dtype)
    got = tfp.bits_u32(torch.from_numpy(x))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(jfp.bits_u32(jnp.asarray(x))))
    want = int(jfp.fingerprint_u32(jnp.asarray(x)))
    assert int(tfp.fingerprint_u32(torch.from_numpy(x))) == want


@pytest.mark.parametrize("axes", [None, 0, (1,), (0, 2), (1, 2), ()], ids=str)
def test_fingerprint_axes_bitwise_jax(axes):
    """Fingerprints over an int, tuples and None of a `[4, 5, 6]` tensor."""
    x = _specials(np.float32, shape=(4, 5, 6), seed=3)
    got = tfp.fingerprint_u32(torch.from_numpy(x), axes=axes).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jfp.fingerprint_u32(jnp.asarray(x), axes=axes)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fingerprint_chunked_sum_equals_whole(dtype):
    """The wrapping sum is chunk-invariant: the fingerprints of slabs of
    rows, added mod 2^32, are the whole tensor's."""
    x = torch.from_numpy(_specials(dtype, shape=(11, 9), seed=4))
    whole = int(tfp.fingerprint_u32(x))
    parts = sum(int(tfp.fingerprint_u32(x[lo:lo + 3])) for lo in range(0, 11, 3))
    assert parts % (1 << 32) == whole
    per_row = tfp.fingerprint_u32(x, axes=1)
    assert int(per_row.sum()) % (1 << 32) == whole


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_flip_ulp_and_ulp_delta_bitwise_jax(dtype):
    """`flip_ulp` is JAX's bit-pattern increment (the wrap at the top of
    the positive patterns included), and one flipped cell moves the
    fingerprint by exactly one ulp; `ulp_delta` is JAX's."""
    x = _specials(dtype)
    if dtype == np.float32:
        x.reshape(-1)[7] = np.uint32(0x7FFFFFFF).view(np.float32)  # a NaN pattern
    got = tfp.flip_ulp(torch.from_numpy(x)).numpy()
    _bytes_equal(got, np.asarray(jfp.flip_ulp(jnp.asarray(x))))
    pos = np.abs(x[0]).astype(dtype) + 1
    flipped = pos.copy()
    flipped[2] = tfp.flip_ulp(torch.from_numpy(pos[2:3])).numpy()[0]
    a = int(tfp.fingerprint_u32(torch.from_numpy(pos)))
    b = int(tfp.fingerprint_u32(torch.from_numpy(flipped)))
    assert tfp.ulp_delta(a, b) == 1 and tfp.ulp_delta(b, a) == -1
    rng = np.random.default_rng(1)
    for a, b in rng.integers(0, 1 << 32, size=(50, 2), dtype=np.uint64).tolist():
        assert tfp.ulp_delta(a, b) == jfp.ulp_delta(a, b)


# ---------------------------------------------------------------------------
# telemetry/numerics.py: the sketch functions


def _jax_sketch(x, epoch_axis):
    """JAX's sketch as its engines take it: inside `jit`."""
    fn = jax.jit(jnum.sketch_over_epochs, static_argnums=1)
    return jax.tree.map(np.asarray, fn(jnp.asarray(x), epoch_axis))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,axis", [((6, 7), 0), ((3, 6, 7), 1), ((6, 4, 5), 0)],
                         ids=["EV", "BEV", "EVM"])
def test_sketch_over_epochs_bitwise_jax(shape, axis, dtype):
    """`[E, V]`, `[B, E, V]` and `[E, V, M]` streams with NaN, +-inf, +-0.0
    and an all-NaN epoch: every field bitwise JAX's jitted sketch (an
    all-NaN epoch reads lo=+inf, hi=-inf, absmax=0, finite_frac 0)."""
    x = _specials(dtype, shape=shape, seed=len(shape) + axis)
    x[(slice(None),) * axis + (-1,)] = np.nan  # the last epoch, every lane
    got = tnum.to_host({"s": tnum.sketch_over_epochs(torch.from_numpy(x), axis)})["s"]
    want = _jax_sketch(x, axis)
    for f in FIELDS:
        _bytes_equal(getattr(got, f), getattr(want, f), f)
    assert np.all(got.lo[..., -1] == np.inf) and np.all(got.hi[..., -1] == -np.inf)
    assert np.all(got.absmax[..., -1] == 0) and np.all(got.finite_frac[..., -1] == 0)
    assert got.fingerprint.shape == x.shape[: axis + 1]


@pytest.mark.parametrize("values", [[-0.0, 0.0], [0.0, -0.0], [-0.0, -0.0], [0.0, 0.0],
                                    [0.0, -0.0, 1.0], [-1.0, -0.0, 0.0], [np.nan, -0.0]],
                         ids=str)
def test_sketch_signed_zeros_bitwise_jax(values):
    """lo / hi of signed zeros: XLA orders -0.0 below +0.0, in whatever
    order the zeros come."""
    x = np.array([values, values[::-1]], np.float32)
    got = tnum.to_host({"s": tnum.sketch_over_epochs(torch.from_numpy(x), 0)})["s"]
    want = _jax_sketch(x, 0)
    for f in FIELDS:
        _bytes_equal(getattr(got, f), getattr(want, f), f)


def test_epoch_sketch_and_capture_streams_bitwise_jax():
    """`epoch_sketch` (one epoch, all axes) and `capture_streams` in both
    spellings are JAX's, and an in-scan sketch is the stacked one's row."""
    x = _specials(np.float32, shape=(5, 6, 4), seed=9)
    one = tnum.to_host({"s": tnum.epoch_sketch(torch.from_numpy(x[2]))})["s"]
    want = jax.tree.map(np.asarray, jax.jit(jnum.epoch_sketch)(jnp.asarray(x[2])))
    for f in FIELDS:
        _bytes_equal(getattr(one, f), getattr(want, f), f)
        _bytes_equal(getattr(one, f), getattr(_jax_sketch(x, 0), f)[2], f)
    streams = {"dividends": x[:, :, 0], "consensus": x[:, 0, :], "bonds": None}
    got = tnum.to_host(tnum.capture_streams({k: None if v is None else torch.from_numpy(v)
                                             for k, v in streams.items()}, epoch_axis=0))
    want = jax.tree.map(np.asarray, jax.jit(lambda s: jnum.capture_streams(s, 0))(
        {k: jnp.asarray(v) for k, v in streams.items() if v is not None}))
    _sketches_equal(got, want, "capture_streams")


def test_pack_unpack_round_trip_and_concat():
    """The packed host fetch gives the leaves back bit for bit (u32
    fingerprints past 2^31 included), and slab captures concatenate along
    the epoch axis into the whole run's, as JAX's `concat_sketches`."""
    x = torch.from_numpy(_specials(np.float32, shape=(3, 8, 5), seed=2) * 1e30)
    sk = {"a": tnum.sketch_over_epochs(x, 1), "b": tnum.sketch_over_epochs(x[0].double(), 0)}
    assert int(sk["a"].fingerprint.max()) > 0x7FFFFFFF
    host = tnum.to_host(sk)
    for stream, s in sk.items():
        for f in FIELDS:
            ref = getattr(s, f).numpy()
            _bytes_equal(getattr(host[stream], f),
                         ref.astype(np.uint32) if f == "fingerprint" else ref, f)
    parts = [tnum.to_host({"a": tnum.sketch_over_epochs(x[:, lo:lo + 3], 1)}) for lo in (0, 3, 6)]
    _sketches_equal(tnum.concat_sketches(parts), {"a": host["a"]}, "concat")
    jparts = [{"a": jax.tree.map(np.asarray, jnum.sketch_over_epochs(jnp.asarray(p.numpy()), 1))}
              for p in (x[:, :4], x[:, 4:])]
    want = jnum.concat_sketches(jparts)
    got = tnum.concat_sketches([{"a": tnum.to_host({"a": tnum.sketch_over_epochs(p, 1)})["a"]}
                                for p in (x[:, :4], x[:, 4:])])
    assert got["a"].fingerprint.shape == want["a"].fingerprint.shape == (3, 8)
    _bytes_equal(got["a"].fingerprint, want["a"].fingerprint)


def test_host_sketches_and_sketch_mismatches():
    """`host_sketches` of numpy streams is the CPU capture of the same
    tensors; `sketch_mismatches` is empty on equal sets and names the
    stream set, the leaf whose dtype or shape differs, and a one-ulp flip."""
    x = _specials(np.float32, shape=(6, 5), seed=4)
    ref = tnum.to_host(tnum.capture_streams({"dividends": torch.from_numpy(x)}, epoch_axis=0))
    got = tnum.host_sketches({"dividends": x})
    assert tnum.sketch_mismatches(got, ref) == []
    flipped = x.copy()
    flipped.view(np.uint32)[2, 1] += 1
    bad = tnum.sketch_mismatches(tnum.host_sketches({"dividends": flipped}), ref)
    assert "dividends.fingerprint: bits differ" in bad
    assert tnum.sketch_mismatches({}, ref) == ["streams [] != ['dividends']"]
    wide = tnum.host_sketches({"dividends": x.astype(np.float64)})
    assert any(m.startswith("dividends.lo: float64") for m in tnum.sketch_mismatches(wide, ref))


# ---------------------------------------------------------------------------
# the engines' numerics


def _jax_numerics(result_numerics):
    return {k: jax.tree.map(np.asarray, v) for k, v in result_numerics.items()}


@pytest.mark.parametrize("index", range(9), ids=IDS)
def test_simulate_numerics_bitwise_jax_xla_rung(index):
    """`SimulationResult.numerics` of the eager rung (auto on the CPU) is
    bitwise JAX's XLA rung's on Cases 1, 3 and 10: the dividends and the
    per-epoch consensus (sketched though not saved), `[E]` leaves."""
    version, params = canonical_versions()[index]
    cfg = YumaConfig(yuma_params=params)
    jcfg = JConfig(yuma_params=j_versions()[index][1])
    for case in CASES:
        got = simulate(create_case(case), version, cfg, device="cpu", x64=True)
        want = j_simulate(j_create_case(case), version, jcfg)
        assert got.engine == "eager"
        assert sorted(got.numerics) == ["consensus", "dividends"]
        _sketches_equal(got.numerics, _jax_numerics(want.numerics), f"{case} {version}")
        E = got.dividends.shape[0]
        assert all(getattr(sk, f).shape == (E,) for sk in got.numerics.values() for f in FIELDS)


@pytest.mark.parametrize("epoch_impl", ["fused_scan", "fused_varying", "fused_varying_mxu"])
def test_fused_plain_rungs_stream_sets(epoch_impl):
    """The fused rungs (their plain versions here) sketch the dividends,
    and the consensus only when it is saved, as JAX's fused rungs do; each
    sketch is bitwise the CPU sketch of the outputs the run returned."""
    case = create_case("Case 3")
    for save_consensus, streams in ((False, ["dividends"]), (True, ["consensus", "dividends"])):
        r = simulate(case, "Yuma 1 (paper)", epoch_impl=epoch_impl, save_consensus=save_consensus,
                     device="cpu", x64=True)
        assert r.engine == epoch_impl and sorted(r.numerics) == streams
        outs = {k: torch.from_numpy(getattr(r, k)) for k in streams}
        _sketches_equal(r.numerics, tnum.to_host(tnum.capture_streams(outs, epoch_axis=0)),
                        epoch_impl)


def test_numerics_off_gives_none_in_both(monkeypatch):
    """``YUMA_NUMERICS=0`` (and ``off``): no numerics anywhere, in both
    packages; the outputs are unchanged."""
    on = simulate(create_case("Case 2"), "Yuma 1 (paper)", device="cpu")
    for flag in ("0", "off"):
        monkeypatch.setenv("YUMA_NUMERICS", flag)
        assert not tnum.numerics_enabled() and not jnum.numerics_enabled()
        off = simulate(create_case("Case 2"), "Yuma 1 (paper)", device="cpu")
        assert off.numerics is None
        np.testing.assert_array_equal(off.dividends, on.dividends)
        assert j_simulate(j_create_case("Case 2"), "Yuma 1 (paper)").numerics is None
        streamed = simulate(create_case("Case 2"), "Yuma 1 (paper)", max_resident_epochs=7,
                            device="cpu")
        assert streamed.numerics is None
        W, S, ri, re_ = stack_scenarios(get_cases()[:2], device="cpu")
        ys = simulate_batch(W, S, ri, re_, YumaConfig(), variant_for_version("Yuma 1 (paper)"))
        assert "numerics" not in ys


@pytest.mark.parametrize("epoch_impl", ["eager", "fused_varying"])
def test_streamed_numerics_bitwise_monolithic_and_jax(epoch_impl):
    """Slabs of 7 (ragged), through `max_resident_epochs`: the numerics
    are bitwise the monolithic run's on the same rung, and on the eager
    rung JAX's streamed `simulate`'s."""
    for case, version in (("Case 3", "Yuma 1 (paper)"), ("Case 10", "Yuma 3.1 (Rhef+reset)")):
        mono = simulate(create_case(case), version, epoch_impl=epoch_impl, device="cpu", x64=True)
        stream = simulate(create_case(case), version, epoch_impl=epoch_impl,
                          max_resident_epochs=7, device="cpu", x64=True)
        _sketches_equal(stream.numerics, mono.numerics, f"{case} {epoch_impl}")
        if epoch_impl == "eager":
            want = j_simulate(j_create_case(case), version, max_resident_epochs=7)
            _sketches_equal(stream.numerics, _jax_numerics(want.numerics), f"{case} JAX")


@pytest.mark.parametrize("index", [0, 2, 5, 8], ids=[IDS[i] for i in (0, 2, 5, 8)])
def test_simulate_batch_numerics_bitwise_jax(index):
    """`simulate_batch`'s `[B, E]` numerics on the 14 built-in cases and on
    a padded mixed-shape suite with miner masks (Case 1 and a [30, 5, 4]
    random subnet, sketched over the padded width as emitted): bitwise
    JAX's XLA rung."""
    version, params = canonical_versions()[index]
    cfg = YumaConfig(simulation=SimulationHyperparameters(bond_penalty=0.5), yuma_params=params)
    jcfg = JConfig(simulation=JSim(bond_penalty=0.5), yuma_params=j_versions()[index][1])
    W, S, ri, re_ = stack_scenarios(get_cases(), device="cpu")
    got = simulate_batch(W, S, ri, re_, cfg, variant_for_version(version), x64=True)
    jW, jS, jri, jre = (jnp.asarray(t.numpy()) for t in (W, S, ri, re_))
    want = j_simulate_batch(jW, jS, jri, jre, jcfg, j_variant(version), epoch_impl="xla")
    host = tnum.to_host(got["numerics"])
    assert host["dividends"].fingerprint.shape == (14, W.shape[1])
    _sketches_equal(host, _jax_numerics(want["numerics"]), version)

    from yuma_simulation_tpu_torch.scenarios.synthetic import random_subnet_scenario
    from yuma_simulation_tpu.scenarios.synthetic import random_subnet_scenario as j_random

    suite = [create_case("Case 1"), random_subnet_scenario(3, 5, 4, 30)]
    jsuite = [j_create_case("Case 1"), j_random(3, 5, 4, 30)]
    *arrays, mask = pad_scenarios(suite, device="cpu")
    got = simulate_batch(*arrays, cfg, variant_for_version(version), miner_mask=mask, x64=True)
    *jarrays, jmask = j_pad_scenarios(jsuite)
    want = j_simulate_batch(*jarrays, jcfg, j_variant(version), miner_mask=jmask,
                            epoch_impl="xla")
    _sketches_equal(tnum.to_host(got["numerics"]), _jax_numerics(want["numerics"]),
                    f"padded {version}")


def test_sweep_hyperparams_numerics_bitwise_jax():
    """A 4-point grid over Case 3: each lane's numerics bitwise JAX's
    `sweep_hyperparams` lane."""
    axes = dict(bond_alpha=[0.05, 0.2], kappa=[0.5, 0.6])
    grid, _ = config_grid(**axes)
    jgrid, _ = j_config_grid(**axes)
    for version in ("Yuma 1 (paper)", "Yuma 2 (Adrian-Fish)"):
        got = sweep_hyperparams(create_case("Case 3"), version, grid, device="cpu", x64=True)
        want = j_sweep_hyperparams(j_create_case("Case 3"), version, jgrid)
        host = tnum.to_host(got["numerics"])
        assert host["dividends"].fingerprint.shape[0] == 4
        _sketches_equal(host, _jax_numerics(want["numerics"]), version)


# ---------------------------------------------------------------------------
# host side: records and comparisons


def test_records_equal_jax_and_pass_jax_checks():
    """`sketch_records` of the port's numerics equal JAX's records of its
    own run, field for field, and JAX's `check_numerics_records` /
    `diff_records` accept them; a one-ulp flip is located by both
    packages' `first_divergence`, `compare_sketches` and `diff_records`."""
    got = simulate(create_case("Case 3"), "Yuma 1 (paper)", device="cpu", x64=True)
    want = j_simulate(j_create_case("Case 3"), "Yuma 1 (paper)")
    kw = dict(unit=3, lanes=(0, 1), engine="xla", label="Case 3")
    records = tnum.sketch_records(got.numerics, **kw)
    assert records == jnum.sketch_records(_jax_numerics(want.numerics), **kw)
    assert jnum.check_numerics_records(records) == []
    assert tnum.check_numerics_records(records) == []
    assert [jnum.numerics_identity(r) for r in records] == [tnum.numerics_identity(r)
                                                            for r in records]
    for rec in records:
        assert jnum.diff_records(rec, rec) == [] == tnum.diff_records(rec, rec)
    D = torch.from_numpy(got.dividends)
    flipped = D.clone()
    flipped[7, 1] = tfp.flip_ulp(flipped[7, 1])
    drift = tnum.to_host({"dividends": tnum.sketch_over_epochs(flipped, 0)})
    canary = tnum.sketch_records(drift, **dict(kw, role="canary"))
    expect = [{"lane": 0, "first_divergent_epoch": 7, "ulp_distance": 1}]
    assert tnum.diff_records(records[1], canary[0]) == expect
    assert jnum.diff_records(records[1], canary[0]) == expect
    assert tnum.compare_sketches(got.numerics, drift) == {"dividends": expect}
    assert jnum.compare_sketches(got.numerics, drift) == {"dividends": expect}
    short = records[1]["fingerprint"][0][:5]
    assert tnum.first_divergence(short, records[1]["fingerprint"][0]) == (5, 0)
    bad = [dict(records[0], role="other", fingerprint=[])]
    assert tnum.check_numerics_records(bad) == jnum.check_numerics_records(bad)


def test_numerics_sketch_is_the_carry_dataclass():
    """The port's sketch has JAX's five fields, in JAX's order."""
    from yuma_simulation_tpu.simulation.carry import NumericsSketch as JSketch
    import dataclasses

    assert [f.name for f in dataclasses.fields(NumericsSketch)] == [
        f.name for f in dataclasses.fields(JSketch)]
    assert FIELDS == tuple(f.name for f in dataclasses.fields(JSketch))

"""The port's total-dividends artifact — `reporting/tables.py`, its CSV
writer and the CLI — against the JAX package and the reference goldens,
on the CPU.

Gates: for every bond_penalty, a rendered `%.6f` cell differs from
`tests/golden/total_dividends_b{beta}.csv` only where
`tests/golden/csv_diff_cells.json` pins it (the pin_key of
tools/csv_byte_parity.py), on the eager rung (the CLI's `--device cpu`)
and on the varying scan's plain version; full-precision totals within
1.5e-6 of the `*_full.csv` goldens (the reference CSV's own precision);
the CSV bytes' form (header, quoting, line endings) that of pandas'
`to_csv(index=False, float_format="%.6f")`; the eager table equal to the
JAX package's, value for value.
"""

import csv
import json
import math
import os

import numpy as np
import pytest
import torch

from tests.conftest import GOLDEN_DIR
from tools.csv_byte_parity import BETAS, pin_key
from yuma_simulation_tpu.reporting.tables import (
    calculate_total_dividends as j_calculate_total_dividends,
)
from yuma_simulation_tpu_torch.cli.total_dividends_sheet_generator import main
from yuma_simulation_tpu_torch.models.config import SimulationHyperparameters
from yuma_simulation_tpu_torch.models.variants import canonical_versions
from yuma_simulation_tpu_torch.reporting.tables import (
    Table,
    calculate_total_dividends,
    generate_total_dividends_table,
)
from yuma_simulation_tpu_torch.scenarios import get_cases

with open(os.path.join(GOLDEN_DIR, "csv_diff_cells.json")) as _f:
    PINS = json.load(_f)


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name), newline="") as f:
        return f.read()


def _tables(epoch_impl):
    return {
        beta: generate_total_dividends_table(
            get_cases(), canonical_versions(),
            SimulationHyperparameters(bond_penalty=float(beta)),
            epoch_impl=epoch_impl, device="cpu",
        )
        for beta in BETAS
    }


@pytest.fixture(scope="module")
def surfaces():
    """The 4-beta surface on the eager rung ("auto" on the CPU) and on the
    varying scan's plain version, 36 batched calls each."""
    return {"auto": _tables("auto"), "fused_varying": _tables("fused_varying")}


@pytest.fixture(scope="module")
def sheets(tmp_path_factory):
    out = tmp_path_factory.mktemp("sheets")
    seconds = main(["--device", "cpu", "--out-dir", str(out)])
    return out, seconds


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("epoch_impl", ["auto", "fused_varying"])
def test_rendered_cells_within_pin(surfaces, epoch_impl, beta):
    """Every rendered cell that differs from the reference's golden is one
    the pin lists, and the header and case column are the golden's."""
    mine = list(csv.reader(surfaces[epoch_impl][beta].to_csv().splitlines()))
    golden = list(csv.reader(_golden(f"total_dividends_b{beta}.csv").splitlines()))
    assert mine[0] == golden[0]
    assert [r[0] for r in mine] == [r[0] for r in golden]
    outside = []
    for r in range(1, len(mine)):
        for c in range(1, len(mine[0])):
            if mine[r][c] != golden[r][c]:
                key = pin_key(dict(case=mine[r][0], column=mine[0][c],
                                   rendered_mine=mine[r][c], rendered_reference=golden[r][c]))
                if key not in PINS[beta]:
                    outside.append(key)
    assert not outside, outside


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("epoch_impl", ["auto", "fused_varying"])
def test_full_precision_within_golden(surfaces, epoch_impl, beta):
    table = surfaces[epoch_impl][beta]
    full = list(csv.reader(_golden(f"total_dividends_b{beta}_full.csv").splitlines()))
    assert full[0] == table.columns
    worst = max(
        abs(row[c] - float(ref[c]))
        for row, ref in zip(table.rows, full[1:]) for c in range(1, len(full[0]))
    )
    assert worst < 1.5e-6, worst


@pytest.mark.parametrize("beta", BETAS)
def test_cli_writes_the_sheets(sheets, surfaces, beta):
    """`--device cpu` writes `total_dividends_b{beta}.csv` for the default
    betas: the eager table's CSV, in the golden's form (the same header
    bytes, the same quoted case names, "\\n" line endings, the same
    length)."""
    out, seconds = sheets
    assert list(seconds) == list(BETAS)
    data = (out / f"total_dividends_b{beta}.csv").read_bytes()
    golden = _golden(f"total_dividends_b{beta}.csv").encode()
    assert data.decode() == surfaces["auto"][beta].to_csv()
    assert b"\r" not in data and data.endswith(b"\n")
    assert data.split(b"\n")[0] == golden.split(b"\n")[0]
    assert [line.split(b",")[0] for line in data.split(b"\n")] == [
        line.split(b",")[0] for line in golden.split(b"\n")
    ]
    assert len(data) == len(golden)


def test_csv_writer_matches_pandas():
    """Table.to_csv is byte for byte pandas' `to_csv(index=False,
    float_format="%.6f")`: commas and quotes in names, NaN, infinities,
    negatives and an integer column."""
    pd = pytest.importorskip("pandas")
    table = Table(
        columns=["Case", "a, b", 'say "x"', "n"],
        rows=[
            ["Case 12 - one, two", 1.0000005, -2.5e-7, 3],
            ['q "quoted"', float("nan"), float("inf"), -4],
            ["plain", 123456.7890123, -float("inf"), 0],
        ],
    )
    frame = pd.DataFrame(table.rows, columns=table.columns)
    assert table.to_csv() == frame.to_csv(index=False, float_format="%.6f")
    assert table.has_nan() and not Table(["x"], [[1.0]]).has_nan()


def test_table_matches_jax(surfaces):
    """The eager table equals the JAX package's, column for column and
    value for value (the per-epoch dividends are bitwise its XLA rung's
    and both sum them in float64 with numpy)."""
    from yuma_simulation_tpu.models.config import SimulationHyperparameters as JSim
    from yuma_simulation_tpu.models.variants import canonical_versions as j_versions
    from yuma_simulation_tpu.reporting.tables import generate_total_dividends_table as j_table
    from yuma_simulation_tpu.scenarios import get_cases as j_get_cases

    frame = j_table(j_get_cases(), j_versions(), JSim(bond_penalty=0.5))
    table = surfaces["auto"]["0.5"]
    assert list(frame.columns) == table.columns
    assert frame["Case"].tolist() == [row[0] for row in table.rows]
    for c, name in enumerate(table.columns[1:], start=1):
        np.testing.assert_array_equal(np.asarray([row[c] for row in table.rows]),
                                      frame[name].to_numpy())


def test_calculate_total_dividends_matches_jax(caplog):
    """Totals and percentages as the JAX package's, including the zero or
    missing base validator's 1e-6 fallback and its warning."""
    validators = ["A", "B", "C"]
    divs = {"A": [1.0, 2.0, 0.5], "B": [0.25, 0.0, 3.0], "C": [1.5]}
    for base, per in (("A", divs), ("B", {"A": [1.0], "B": [0.0, 0.0]}), ("Z", divs)):
        caplog.clear()
        got = calculate_total_dividends(validators, per, base, 2)
        warned = "zero or missing" in caplog.text
        assert got == j_calculate_total_dividends(validators, per, base, 2)
        assert warned == (base != "A"), (base, caplog.text)
    totals, pct = calculate_total_dividends(validators, divs, "B", 3)
    assert totals == {"A": 3.5, "B": 3.25, "C": 1.5}
    assert pct["B"] == 0.0 and math.isclose(pct["A"], (3.5 - 3.25) / 3.25 * 100.0)


def test_cli_nan_warning(monkeypatch, tmp_path, capsys):
    """A table with NaN is written all the same, after the warning."""
    import yuma_simulation_tpu_torch.cli.total_dividends_sheet_generator as cli

    def fake(*args, **kwargs):
        return Table(columns=["Case", "x"], rows=[["c", float("nan")]])

    monkeypatch.setattr(cli, "generate_total_dividends_table", fake)
    cli.main(["--device", "cpu", "--out-dir", str(tmp_path), "--bond-penalty", "0.5"])
    assert "Warning: NaN values detected" in capsys.readouterr().out
    assert (tmp_path / "total_dividends_b0.5.csv").read_text() == "Case,x\nc,\n"


def test_cli_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA; the refusal is what a CPU-only box shows")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--out-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())

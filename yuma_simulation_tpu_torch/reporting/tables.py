"""Dividend aggregation, the total-dividends table and the chart grid's HTML.

The port's counterparts of the JAX package's `reporting/tables.py`
(`calculate_total_dividends`, `generate_total_dividends_table`, and the
HTML functions `generate_draggable_html_table` / `generate_ipynb_table`),
which follow the reference's `_calculate_total_dividends`
(charts_utils.py:15-45), `generate_total_dividends_table`
(simulation_utils.py:319-381) and its two HTML tables
(simulation_utils.py:115-316). The
table is a plain :class:`Table` of columns and rows instead of a pandas
DataFrame, and :meth:`Table.to_csv` writes the bytes pandas'
`to_csv(index=False, float_format="%.6f")` writes, with the stdlib `csv`
module. Each version's 14-case suite runs as one batched
:func:`..simulation.sweep.simulate_batch`, on the card unless the caller
asks for the CPU.
"""

from __future__ import annotations

import csv
import io
import logging
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from yuma_simulation_tpu_torch.models.config import (
    SimulationHyperparameters,
    YumaConfig,
    YumaParams,
)
from yuma_simulation_tpu_torch.models.variants import variant_for_version
from yuma_simulation_tpu_torch.scenarios.base import Scenario
from yuma_simulation_tpu_torch.simulation.sweep import simulate_batch, stack_scenarios

logger = logging.getLogger(__name__)

_STANDARD_VALIDATORS = ["Validator A", "Validator B", "Validator C"]


@dataclass
class Table:
    """Named columns and rows of values, in column order."""

    columns: list[str]
    rows: list[list]

    def has_nan(self) -> bool:
        return any(isinstance(x, float) and math.isnan(x) for row in self.rows for x in row)

    def to_csv(self, float_format: str = "%.6f") -> str:
        """The table as CSV text, as pandas' `to_csv(index=False,
        float_format=...)` writes it: a header line, minimal quoting
        (a case name with a comma is quoted), `"\\n"` line endings, floats
        through `float_format` and NaN as an empty field."""

        def cell(x):
            if isinstance(x, float):
                return "" if math.isnan(x) else float_format % x
            return x

        buf = io.StringIO()
        writer = csv.writer(buf, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        writer.writerow(self.columns)
        writer.writerows([cell(x) for x in row] for row in self.rows)
        return buf.getvalue()


def calculate_total_dividends(
    validators: list[str],
    dividends_per_validator: dict[str, list[float]],
    base_validator: str,
    num_epochs: int,
) -> tuple[dict[str, float], dict[str, float]]:
    """Totals and the percentage difference from the base validator
    (reference charts_utils.py:15-45), with its fallback: a zero or
    missing base total is logged as a warning and taken as 1e-6."""
    totals = {
        v: float(sum(dividends_per_validator.get(v, [])[:num_epochs]))
        for v in validators
    }
    base = totals.get(base_validator)
    if base is None or base == 0.0:
        logger.warning(
            "Base validator '%s' has zero or missing total dividends.",
            base_validator,
        )
        base = 1e-6
    pct = {
        v: 0.0 if v == base_validator else (t - base) / base * 100.0
        for v, t in totals.items()
    }
    return totals, pct


def generate_total_dividends_table(
    cases: Sequence[Scenario],
    yuma_versions: list[tuple[str, YumaParams]],
    simulation_hyperparameters: SimulationHyperparameters,
    *,
    epoch_impl: str = "auto",
    device="cuda",
) -> Table:
    """Per-case total dividends across versions, with the columns `"Case"`
    then `"Validator A/B/C - {version}"` per version (reference
    simulation_utils.py:319-381). The cases share one `[E, V, M]` shape,
    so each version is one batched :func:`simulate_batch` (`epoch_impl`
    as there: on the card "auto" runs the varying scan, K3). Yuma 0's
    quantization divide runs in float64, as the reference's does (the JAX
    package's x64 parity mode). The totals are float64 sums over epochs
    on the host."""
    for case in cases:
        if len(case.validators) != 3:
            raise ValueError(f"Case '{case.name}' does not have exactly 3 validators.")
    W, S, ri, re_ = stack_scenarios(cases, device=device)
    columns = ["Case"]
    rows: list[list] = [[case.name] for case in cases]
    for yuma_version, yuma_params in yuma_versions:
        config = YumaConfig(simulation=simulation_hyperparameters, yuma_params=yuma_params)
        spec = variant_for_version(yuma_version)
        ys = simulate_batch(W, S, ri, re_, config, spec, epoch_impl=epoch_impl, x64=True)
        totals = np.asarray(ys["dividends"].cpu().numpy(), np.float64).sum(axis=1)  # [B, V]
        columns.extend(f"{std} - {yuma_version}" for std in _STANDARD_VALIDATORS)
        for i, row in enumerate(rows):
            row.extend(float(totals[i, j]) for j in range(len(_STANDARD_VALIDATORS)))
    return Table(columns=columns, rows=rows)


# --- HTML assembly -----------------------------------------------------------


_SCROLL_TABLE_CSS = """
<style>
  body { margin: 0; padding: 0; overflow: hidden; }
  .yuma-table-scroll {
    background: #fff;
    width: 100%;
    height: 100vh;
    overflow: auto;
    border: 1px solid #ccc;
    position: relative;
    user-select: none;
    cursor: grab;
  }
  .yuma-table-scroll:active { cursor: grabbing; }
  .yuma-case-even td { background: #ffffff !important; }
  .yuma-case-odd td { background: #f0f0f0 !important; }
  .yuma-table-scroll img {
    user-select: none;
    -webkit-user-drag: none;
    pointer-events: none;
  }
  table { border-collapse: collapse; margin: 0; width: auto; }
  td, th { padding: 10px; vertical-align: top; text-align: center; }
</style>
"""

_DRAG_SCROLL_JS = """
<script>
  document.addEventListener('DOMContentLoaded', () => {
    const pane = document.querySelector('.yuma-table-scroll');
    let drag = null;
    pane.addEventListener('dragstart', e => e.preventDefault());
    pane.addEventListener('mousedown', e => {
      e.preventDefault();
      drag = {x: e.clientX, y: e.clientY,
              left: pane.scrollLeft, top: pane.scrollTop};
    });
    document.addEventListener('mouseup', () => { drag = null; });
    document.addEventListener('mousemove', e => {
      if (!drag) return;
      e.preventDefault();
      pane.scrollLeft = drag.left - (e.clientX - drag.x);
      pane.scrollTop = drag.top - (e.clientY - drag.y);
    });
  });
</script>
"""

_NOTEBOOK_CSS = """
<style>
  .yuma-table-scroll {
    background: #fff;
    width: 100%;
    overflow-x: auto;
    overflow-y: hidden;
    white-space: nowrap;
    border: 1px solid #ccc;
  }
  table { border-collapse: collapse; table-layout: auto; width: auto; }
  td, th { padding: 10px; vertical-align: top; text-align: center; }
  .yuma-case-even td { background: #ffffff !important; }
  .yuma-case-odd td { background: #f8f8f8 !important; }
</style>
"""


def _table_body(
    summary_table: Table,
    case_row_ranges: list[tuple[int, int, int]],
) -> str:
    def case_index(row: int) -> int:
        for start, end, idx in case_row_ranges:
            if start <= row <= end:
                return idx
        return 0

    head = "".join(f"<th>{col}</th>" for col in summary_table.columns)
    body = []
    for row, values in enumerate(summary_table.rows):
        parity = "even" if case_index(row) % 2 == 0 else "odd"
        cells = "".join(f"<td>{value}</td>" for value in values)
        body.append(f"<tr class='yuma-case-{parity}'>{cells}</tr>")
    return (
        "<div class='yuma-table-scroll'><table>"
        f"<thead><tr>{head}</tr></thead>"
        f"<tbody>{''.join(body)}</tbody>"
        "</table></div>"
    )


def generate_draggable_html_table(
    table_data: dict[str, list[str]],
    summary_table: Table,
    case_row_ranges: list[tuple[int, int, int]],
) -> str:
    """Standalone HTML chart grid with drag-to-scroll
    (reference simulation_utils.py:115-248). `summary_table` is the
    :class:`Table` of chart cells (one column per version, one row per
    chart); `case_row_ranges` holds `(first_row, last_row, case_index)`."""
    del table_data  # kept for signature parity; summary_table carries the cells
    return _SCROLL_TABLE_CSS + _DRAG_SCROLL_JS + _table_body(
        summary_table, case_row_ranges
    )


def generate_ipynb_table(
    table_data: dict[str, list[str]],
    summary_table: Table,
    case_row_ranges: list[tuple[int, int, int]],
) -> str:
    """Notebook-friendly chart grid (reference simulation_utils.py:250-316)."""
    del table_data
    return _NOTEBOOK_CSS + _table_body(summary_table, case_row_ranges)

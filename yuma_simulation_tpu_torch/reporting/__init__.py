"""Dividend aggregation and the reference's tables (no pandas)."""

from yuma_simulation_tpu_torch.reporting.tables import (  # noqa: F401
    Table,
    calculate_total_dividends,
    generate_total_dividends_table,
)
